"""The staging's useful share of its slots: 100 × the pairs the training
steps emitted (the program's counter ``staging.pairs_emitted``, each drained
``num_pairs``) over the slots its staging sorted (``staging.slots``, the
pair budget at each ``sort_stage`` call), read from
``deblurgs_tpu_torch/utils/profiling.py::counters``. The counters are the
run's process's: set-up's steps, the profiled chunks and the sync-counted
chunk, one batched sort a step. A program without them reads nothing."""


def read(t: dict):
    try:
        from deblurgs_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("staging.slots"):
        return None
    return 100.0 * c.get("staging.pairs_emitted", 0) / c["staging.slots"]
