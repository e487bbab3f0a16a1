"""Device milliseconds an iteration in the radix-sort passes of the
staging's (tile, depth) sort: the kernels whose names hold a pattern of
``portbench/kernels.json``'s ``sort`` (cub's ``DeviceRadixSort`` passes
that ``torch.sort`` launches inside ``ops/cuda_blend.py::sort_slots``).
The rest of ``sort_slots`` (per-slot tile ids, the exact tile cull, the
inverse scatter, the gathers over every slot) is not in it: no span marks
that stage yet."""

from portbench.counts import formulas


def read(t: dict):
    seconds = formulas.matching_seconds(t["device_ops"], t["kernels"]["sort"])
    if seconds <= 0 or not t["iterations"]:
        return None
    return seconds / t["iterations"] * 1e3
