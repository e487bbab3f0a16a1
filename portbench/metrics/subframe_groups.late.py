"""Sub-frame groups a training step: the program's counter
``step.subframe_groups`` (each ``train/step.py::train_step`` call adds its
statics' groups) over ``step.calls`` (one a call), read from
``deblurgs_tpu_torch/utils/profiling.py::counters``. The counters are the
run's process's: set-up's steps, the profiled chunk and the sync-counted
chunk. A program without them reads nothing."""


def read(t: dict):
    try:
        from deblurgs_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("step.calls") or "step.subframe_groups" not in c:
        return None
    return c["step.subframe_groups"] / c["step.calls"]
