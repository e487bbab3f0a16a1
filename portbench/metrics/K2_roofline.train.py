"""K2 (``ops/cuda_blend_mixed.py::backward_mixed``): the least time the
chip could take for its work in the profiled iterations (the larger of the
gate evaluations' operations over the float32 peak and its bytes over the
memory peak) over its device time in the trace."""

from portbench.counts import formulas


def read(t: dict):
    seconds = formulas.matching_seconds(t["device_ops"], t["kernels"]["K2"])
    c = t["counts"]
    if seconds <= 0 or not c["evaluations"]:
        return None
    bound = formulas.roofline_s(formulas.EVAL_OPS * c["evaluations"],
                                formulas.k2_bytes(c["kept_pairs"], c["tiles"], c["pixels"]),
                                t["peaks"])
    return 100.0 * bound / seconds
