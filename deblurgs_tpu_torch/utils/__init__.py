"""Training observability: the step timer and profiler trace
(``profiling.py``) and the overview / trajectory visualizer
(``visualizer.py``) (counterpart of ``deblurgs_tpu/utils``)."""
