"""The whole train step's share of the chip's float32 peak: the compositing
operations the profiled iterations' inputs need (forward and backward gate
evaluations, 12 operations each, counted by the benchmark's own walk) over
their wall time. Preprocess and Adam are left out: 100k Gaussians × 21
projections × a few hundred operations is about 1e9 an iteration against
about 2e11 of compositing, under 1%."""

from portbench.counts import formulas


def read(t: dict):
    evaluations = t["counts"]["evaluations"]
    if not evaluations or t["wall_s"] <= 0:
        return None
    ops = 2 * formulas.EVAL_OPS * evaluations
    return 100.0 * ops / (t["wall_s"] * t["peaks"]["f32_flops_per_s"])
