"""Training: hyperparameters, schedules, losses, Adam, the train step and
its checkpoint (counterpart of ``deblurgs_tpu/train``; the host loop
``loop.py`` is not ported yet)."""
