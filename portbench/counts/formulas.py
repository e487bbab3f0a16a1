"""Operation, byte, busy-share and sync arithmetic of the per-layer metrics.

Copied from ``chip_smoke.py`` so that the yardstick stays with the
benchmark:

- ``EVAL_OPS`` (line 186): 12 float32 operations a gate evaluation
  (dx, dy, the 9-operation power, the compare);
- ``k1_bytes`` (line 1386): K1 reads each kept pair's 40 bytes of
  fields once and each tile's 8 bytes of range, and writes 12 + 4 + 4
  bytes a pixel (C, D, final T; no n_contrib in training);
- ``k2_bytes`` (line 1374): K2 reads the kept pairs' fields and the tile
  ranges, 20 bytes a pixel (the cotangents, final T, C and D), and writes
  the 40 bytes of each kept pair's ten sums;
- ``roofline_s``: the larger of operations over the float32 peak and
  bytes over the memory peak (lines 1377, 1387);
- ``sync_count`` (lines 2236-2239): the warnings of
  ``torch.cuda.set_sync_debug_mode("warn")`` that name a synchronising call.

``busy_union`` replaces ``chip_smoke.py::device_profile``'s sum of self
times (lines 588-598) by the union of the device intervals, which is exact
where operations overlap.
"""

from __future__ import annotations

EVAL_OPS = 12


def k1_bytes(kept: int, tiles: int, pixels: int) -> int:
    return 40 * kept + 8 * tiles + pixels * (12 + 4 + 4)


def k2_bytes(kept: int, tiles: int, pixels: int) -> int:
    return 40 * kept + 8 * tiles + 20 * pixels + 40 * kept


def roofline_s(ops: float, nbytes: float, peaks: dict) -> float:
    return max(ops / peaks["f32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])


def busy_union(intervals, lo: float, hi: float) -> tuple:
    """(busy µs, merged intervals) of device intervals (start, end) µs,
    clipped to [lo, hi]."""
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def sync_count(caught) -> int:
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def matching_seconds(device_ops, patterns) -> float:
    """Seconds of the device operations whose name holds any pattern."""
    return sum(e - s for name, s, e in device_ops if any(p in name for p in patterns)) / 1e6
