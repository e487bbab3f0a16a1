"""The share of the staged pairs that the backward staged again: 100 ×
the program's counter ``staging.pairs_recomputed`` (each grouped step's
pairs staged again in its backward, ``train/step.py::_GroupRender``) over
``staging.pairs_emitted`` (the pairs of every staging, the backward's
included), read from ``deblurgs_tpu_torch/utils/profiling.py::counters``
over the run's process. A program without them reads nothing."""


def read(t: dict):
    try:
        from deblurgs_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("staging.pairs_emitted") or "staging.pairs_recomputed" not in c:
        return None
    return 100.0 * c["staging.pairs_recomputed"] / c["staging.pairs_emitted"]
