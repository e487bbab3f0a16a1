"""Training: hyperparameters, schedules, losses, Adam, the train step, its
checkpoint and the host loop that drives it through a run (``loop.py``)
(counterpart of ``deblurgs_tpu/train``)."""
