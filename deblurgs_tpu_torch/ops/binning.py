"""Tile binning: pair expansion, depth sort, per-tile ranges.

Counterpart of ``deblurgs_tpu/ops/binning.py``: ``expand_slots`` and
``bin_gaussians`` (the xla backend's binning), ``expand_compact`` (the
kernel path's staging) and ``searchsorted_right``. The JAX package
recovers each slot's owner with a unique scatter at every run start
followed by a running maximum
(``lax.cummax``); both of its maps are monotone step functions, so here
each is one binary search (``torch.searchsorted``) over a cumulative sum.
That is the cheap form on the card: ``torch.cummax`` over the slot axis
took 38 ms of a 64 ms 21-view blurry render at 1920×1080 (~5M slots) on an
H100 80GB HBM3 at 700 W, measured by ``chip_smoke.py``'s profile.

Parity with the JAX package, slot for slot:

- its scatters drop run starts at or past ``max_pairs``; a slot below
  ``max_pairs`` only ever sees runs that start before it, so the search
  returns the same owner;
- padding rows and slots past ``total`` repeat the last emitting Gaussian,
  as the running maximum carries it;
- indices are int64 for torch indexing;
- overflow keeps JAX's truncation: ``valid = slot < min(total, max_pairs)``,
  and ``total`` is returned uncapped so callers can detect overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Binning(NamedTuple):
    pair_gauss: torch.Tensor    # [max_pairs] Gaussian index (sorted); P for invalid
    pair_tile: torch.Tensor     # [max_pairs] tile id (sorted); num_tiles for invalid
    tile_start: torch.Tensor    # [num_tiles] first slot of each tile
    tile_stop: torch.Tensor     # [num_tiles] one past its last slot
    num_pairs: torch.Tensor     # [] pairs emitted (pre-capacity-clip)
    max_per_tile: torch.Tensor  # [] longest tile list (k_max adequacy)


def expand_slots(area: torch.Tensor, max_pairs: int):
    """Slot → owning-Gaussian map in ORIGINAL id space.

    Returns (gauss [max_pairs] in [0, P-1], valid [max_pairs] bool, local
    [max_pairs] offset within the owner's rect, total [] emitted count). A
    slot past the total belongs to the last emitting Gaussian (0 when none
    emits), as JAX's running maximum carries it.
    """
    P = area.shape[0]
    dev = area.device
    area = area.to(torch.int64)
    offsets_incl = torch.cumsum(area, 0)
    total = offsets_incl[-1] if P > 0 else torch.zeros((), dtype=torch.int64, device=dev)
    starts = offsets_incl - area
    slots = torch.arange(max_pairs, dtype=torch.int64, device=dev)
    # the owner of slot s < total is the first Gaussian whose run ends past
    # s; later slots ask for the last emitted slot's owner
    last = torch.clamp(total - 1, min=0)
    owner = torch.searchsorted(offsets_incl, torch.minimum(slots, last), right=True)
    gauss = torch.clamp(owner, 0, max(P - 1, 0))
    gauss = torch.where(total > 0, gauss, 0)
    valid = slots < torch.clamp(total, max=max_pairs)
    local = slots - starts[gauss] if P > 0 else slots
    return gauss, valid, local, total


def depth_order_bits(depth: torch.Tensor) -> torch.Tensor:
    """f32 → int64 in [0, 2^32) with the same order (-0.0 and +0.0 equal)."""
    bits = (depth + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, -bits - 1, bits + (1 << 31))


def bin_gaussians(pre, *, tiles_x: int, tiles_y: int, max_pairs: int) -> Binning:
    """Expand (Gaussian × touched-tile) pairs and sort them by (tile, depth).

    Within a Gaussian the emitted order is row-major over its rect, and the
    sort is one stable ``torch.sort`` on a packed key (tile id in the high
    32 bits, the depth's order-preserving bits in the low 32), so equal
    depths keep slot order as in JAX's stable ``lax.sort``.
    """
    num_tiles = tiles_x * tiles_y
    P = pre.depth.shape[0]
    gauss, valid, local, total = expand_slots(pre.tiles_touched, max_pairs)
    # rect coords as exact f32 VALUES (< 2^24), never bitcast: small-int bit
    # patterns are f32 denormals, which flush-to-zero hardware zeroes
    f32 = torch.float32
    x0f = pre.rect[:, 0].to(f32)[gauss]
    y0f = pre.rect[:, 1].to(f32)[gauss]
    wf = torch.clamp(pre.rect[:, 2] - pre.rect[:, 0], min=1).to(f32)[gauss]
    # f32 arithmetic is exact here: local < rect area ≤ num_tiles < 2^24
    localf = local.to(f32)
    dy = torch.floor(localf / wf)
    dx = localf - dy * wf
    tile = ((y0f + dy) * tiles_x + (x0f + dx)).to(torch.int64)
    tile = torch.where(valid, tile, num_tiles)
    depth_key = torch.where(valid, pre.depth[gauss], torch.inf)
    gid = torch.where(valid, gauss, P)

    order = torch.sort((tile << 32) | depth_order_bits(depth_key), stable=True).indices
    sorted_tile = tile[order]
    tq = torch.arange(num_tiles, dtype=torch.int64, device=tile.device)
    tile_start = searchsorted_right(sorted_tile, tq - 1)
    tile_stop = searchsorted_right(sorted_tile, tq)
    return Binning(pair_gauss=gid[order], pair_tile=sorted_tile, tile_start=tile_start,
                   tile_stop=tile_stop, num_pairs=total,
                   max_per_tile=torch.max(tile_stop - tile_start))


def expand_compact(area: torch.Tensor, max_pairs: int):
    """Slot → owner expansion in COMPACT id space.

    The owner of each slot is the *rank* of its Gaussian among those with
    ``area > 0``; ranks increase by exactly +1 across runs, which is what
    lets the segmented broadcast expand a compacted per-Gaussian table.

    Returns (gauss_c [max_pairs] compact rank per slot, ids [P] compact →
    original id (padding rows repeat the last id), valid [max_pairs] bool,
    local [max_pairs] offset within the owner's rect, total [] int64).
    """
    P = area.shape[0]
    dev = area.device
    area = area.to(torch.int64)
    offsets_incl = torch.cumsum(area, 0)
    total = offsets_incl[-1] if P > 0 else torch.zeros((), dtype=torch.int64, device=dev)
    starts = offsets_incl - area
    emitted = torch.cumsum((area > 0).to(torch.int64), 0)     # emitters in [0, i]
    n_emit = emitted[-1] if P > 0 else total

    # compact rank r → the (r+1)-th emitter: the first i with emitted[i] ≥ r+1
    r1 = torch.arange(1, P + 1, dtype=torch.int64, device=dev)
    ids = torch.clamp(torch.searchsorted(emitted, torch.minimum(r1, n_emit)), 0, P - 1)

    # slot s → the first Gaussian whose run ends past s (always an emitter);
    # past the total it is P, whose rank carries the last emitter's
    slots = torch.arange(max_pairs, dtype=torch.int64, device=dev)
    owner = torch.clamp(torch.searchsorted(offsets_incl, slots, right=True), max=P - 1)
    gauss_c = torch.clamp(emitted[owner] - 1, 0, P - 1)
    valid = slots < torch.clamp(total, max=max_pairs)
    local = slots - starts[ids[gauss_c]]
    return gauss_c, ids, valid, local, total


def searchsorted_right(sorted_arr: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """First index i with ``sorted_arr[i] > q`` per query."""
    return torch.searchsorted(sorted_arr, queries.to(sorted_arr.dtype), right=True)
