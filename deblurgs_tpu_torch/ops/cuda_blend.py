"""Pair staging, the segmented-broadcast kernel (K3) and the gradient
reduce (K4).

Counterpart of ``deblurgs_tpu/ops/pallas_blend.py``: ``broadcast_fields``
(K3, ``pallas_blend.py:179-233``), ``_tile_visible`` (``:236-275``),
``_sort_stage`` (``:278-369``), and ``_reduce_sorted`` (K4, ``:858-926``)
with ``reduce_pair_grads`` (``:929-948``). :func:`sort_stage` yields what
every compositing kernel reads, K5/K6 (``layout="lockstep"``) as K1/K2:
the sorted ``fields``, ``tile_start``/``tile_stop``, ``s_gc``, ``ids`` and
``n_emit``, and for K4 the sort's inverse and the rank runs (``inv``,
``seg``). The TPU grid bookkeeping of that module has no counterpart:
``prepare_mixed``'s step maps, and lockstep's ``_step_maps`` with its
``step_*``, ``chunk_first`` and ``owner`` arrays (``:116-176, 397-409``),
parity-interleaved buffers, one-hot routing. The kernels walk each tile's
pair range directly.

The JAX package reduces the pair gradients with ``jax.ops.segment_sum``
unless ``DEBLURGS_REDUCE=window`` selects ``_reduce_sorted``. The port
always takes K4: on the card the plain counterpart of ``segment_sum`` is
an atomic ``index_add_``, whose summation order changes from run to run,
and K4 makes a step's gradients bitwise the same on every run.

Where parity with the JAX package is fragile:

- **The sort.** It must be a stable lexicographic sort on (tile,
  depth_key) with ties kept in slot order, so the pair list matches JAX's
  slot for slot. It is one stable ``torch.sort`` on a packed int64 key:
  the tile id in the high 32 bits, and in the low 32 bits the depth's
  f32 bit pattern mapped to an order-preserving unsigned int (positive
  floats and the 3e37 sentinel already order like their bit patterns; the
  map also orders negatives). Culled and overflow slots get tile =
  ``total_tiles`` and sort last.
- **Exact f32 integers.** Tile ids and rect origins ride f32 rows as exact
  values below 2^24, never as int bit patterns (small ints bitcast to f32
  are denormals, which flush-to-zero hardware zeroes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deblurgs_tpu_torch.ops import binning as binning_lib
from deblurgs_tpu_torch.ops.kernels import load_library, stream_ptr
from deblurgs_tpu_torch.utils import profiling

NFIELD = 16
# field rows: 0 x, 1 y, 2 conic_a, 3 conic_b, 4 conic_c, 5 opacity,
#             6 r, 7 g, 8 b, 9 depth, 10 tile id, 11 tile x0, 12 tile y0
_DEPTH_SENTINEL = 3e37


# ---------------------------------------------------------------------------
# K3: segmented broadcast
# ---------------------------------------------------------------------------


def broadcast_fields_ref(ctable: torch.Tensor, gauss_c: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ``ctable[gauss_c].T`` as a contiguous
    [16, max_pairs] tensor, with 0 in the column of a rank outside
    [0, n_rows), as the kernel writes and as JAX's one-hot matmul over
    zero-padded rows gives."""
    rank = gauss_c.long()
    n_rows = ctable.shape[0]
    if n_rows == 0:
        return ctable.new_zeros((ctable.shape[1], rank.shape[0]))
    ok = (rank >= 0) & (rank < n_rows)
    rows = ctable[torch.where(ok, rank, 0)]
    return torch.where(ok[:, None], rows, 0.0).T.contiguous()


def broadcast_fields(ctable: torch.Tensor, gauss_c: torch.Tensor) -> torch.Tensor:
    """[P, 16] compact table + [max_pairs] non-decreasing compact ranks →
    [16, max_pairs] slot-space field rows, ``out[:, s] = ctable[gauss_c[s]]``
    (0 where a rank is outside [0, P)).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``csrc/broadcast_fields.cu``) or raise.
    """
    if ctable.device.type == "cpu":
        return broadcast_fields_ref(ctable, gauss_c)
    if ctable.device.type != "cuda" or gauss_c.device != ctable.device:
        raise ValueError(f"broadcast_fields: tensors must share one CUDA device "
                         f"(got {ctable.device} and {gauss_c.device})")
    if ctable.dtype != torch.float32 or ctable.dim() != 2 or ctable.shape[1] != NFIELD:
        raise ValueError(f"broadcast_fields: ctable must be [P, {NFIELD}] float32, "
                         f"got {tuple(ctable.shape)} {ctable.dtype}")
    if gauss_c.dim() != 1:
        raise ValueError("broadcast_fields: gauss_c must be 1-D")
    ctable = ctable.contiguous()
    if ctable.data_ptr() % 16:         # the kernel reads 16 B vectors of it
        ctable = ctable.clone()
    gauss_c = gauss_c.to(torch.int32).contiguous()
    max_pairs = gauss_c.shape[0]
    out = torch.empty((NFIELD, max_pairs), dtype=torch.float32, device=ctable.device)
    load_library().launch(
        "deblurgs_broadcast_fields", ctable.data_ptr(), gauss_c.data_ptr(),
        out.data_ptr(), ctable.shape[0], max_pairs, stream_ptr(ctable.device))
    profiling.count("kernel.K3")
    return out


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------


class Staged(NamedTuple):
    """Depth-sorted pair list of all stacked tiles (same order of fields as
    the JAX package's ``_sort_stage`` return tuple)."""

    fields: torch.Tensor        # [16, max_pairs] f32; rows 10-12 = tile, tx0, ty0
    s_tile: torch.Tensor        # [max_pairs] sorted tile id (total_tiles = unused)
    s_gc: torch.Tensor          # [max_pairs] compact rank per sorted slot (P = unused)
    ids: torch.Tensor           # [P] compact → original id
    n_emit: torch.Tensor        # [] emitting-Gaussian count
    tile_start: torch.Tensor    # [total_tiles] first slot of each tile
    tile_stop: torch.Tensor     # [total_tiles] one past its last slot
    total: torch.Tensor         # [] pairs emitted (> max_pairs on overflow)
    max_per_tile: torch.Tensor  # [] longest tile list
    # appended by the port (JAX's tuple ends above): K4's runs
    inv: torch.Tensor | None = None  # [max_pairs] i32 sorted position of each pre-sort slot
    seg: torch.Tensor | None = None  # [P + 1] i32 rank r's pre-sort slots: [seg[r], seg[r+1])


def _tile_visible(cfg, fslot: torch.Tensor, tcx: torch.Tensor,
                  tcy: torch.Tensor) -> torch.Tensor:
    """Per-pair visibility over its tile box: max alpha ≥ 1/255 anywhere.

    ``power`` is concave (the conic is PSD: the +0.3 px dilation keeps
    det > 0), so its max over the box is 0 when the mean lies inside, else
    the max of the four clamped edge maxima. Exact up to the
    continuous-box relaxation, plus the JAX package's safety margin.
    """
    mx, my = fslot[0], fslot[1]
    a, b, c = fslot[2], fslot[3], fslot[4]
    opac = fslot[5]
    x0 = tcx * cfg.tile_w
    x1 = x0 + (cfg.tile_w - 1)
    y0 = tcy * cfg.tile_h
    y1 = y0 + (cfg.tile_h - 1)
    inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)

    def q(dx, dy):
        return -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy

    def edge_x(xe):
        dx = mx - xe
        py = torch.minimum(torch.maximum(my + b * dx / torch.clamp(c, min=1e-12), y0), y1)
        return q(dx, my - py)

    def edge_y(ye):
        dy = my - ye
        px = torch.minimum(torch.maximum(mx + b * dy / torch.clamp(a, min=1e-12), x0), x1)
        return q(mx - px, dy)

    pmax = torch.maximum(torch.maximum(edge_x(x0), edge_x(x1)),
                         torch.maximum(edge_y(y0), edge_y(y1)))
    pmax = torch.where(inside, torch.zeros_like(pmax), pmax)
    # visible ⟺ opac · exp(pmax) ≥ 1/255 ⟺ pmax ≥ -log(255 · opac); the
    # margin keeps boundary pairs whose in-kernel power rounds across the
    # gate (pallas_blend.py:270-275)
    thresh = -torch.log(torch.clamp(255.0 * opac, min=1e-12))
    return pmax >= thresh - (0.05 + 0.01 * torch.abs(thresh))


def tile_culled(cfg) -> bool:
    """Whether :func:`sort_slots` culls each tile's list exactly
    (:func:`_tile_visible`): on unless n_contrib is requested, whose
    position-in-list the cull would shift. Uncut lists carry every pair of
    each tile's rect, and the compositing kernels cull them warp by warp
    (``cuda_blend_mixed.cull_box``)."""
    return cfg.tile_cull and not cfg.need_n_contrib


class Compact(NamedTuple):
    """The compact per-Gaussian table and the slot → owner expansion."""

    ctable: torch.Tensor   # [P, 16] f32 table rows in compact (emitting) order
    gauss_c: torch.Tensor  # [max_pairs] compact rank per slot (non-decreasing)
    ids: torch.Tensor      # [P] compact → original id
    valid: torch.Tensor    # [max_pairs] bool, slot < min(total, max_pairs)
    local: torch.Tensor    # [max_pairs] offset within the owner's rect
    total: torch.Tensor    # [] pairs emitted (> max_pairs on overflow)
    n_emit: torch.Tensor   # [] emitting-Gaussian count
    seg: torch.Tensor      # [P + 1] i32 run bounds of each rank's slots (Staged.seg)


def compact_table(cfg, means2d, conic, opacity, color, depth, rect, area,
                  max_pairs: int) -> Compact:
    """Staging, first half (``pallas_blend.py:286-310``): the expansion and
    the compact table with col 13 holding the row's stacked-tile offset.

    Inputs are the preprocess outputs flattened over the stacked views
    ([n_images · P, ...]); ``cfg`` is a :class:`~deblurgs_tpu_torch.ops.
    tile_blend.BlendConfig`.
    """
    dev = means2d.device
    P = means2d.shape[0]
    p_img = P // cfg.n_images
    gauss_c, ids, valid, local, total = binning_lib.expand_compact(area, max_pairs)
    n_emit = torch.sum((area > 0).to(torch.int64))
    # rank r owns the pre-sort slots from its Gaussian's run start to the
    # next rank's, cut at min(total, max_pairs); the padding ranks past the
    # emitters (which repeat the last id) get empty runs
    area64 = area.to(torch.int64)
    cap = torch.clamp(total, max=max_pairs)
    rank = torch.arange(P, device=dev)
    run0 = torch.minimum((torch.cumsum(area64, 0) - area64)[ids], cap)
    seg = torch.cat([torch.where(rank < n_emit, run0, cap), cap.reshape(1)]).to(torch.int32)

    f32 = torch.float32
    x0f = rect[:, 0].to(f32)
    y0f = rect[:, 1].to(f32)
    wf = torch.clamp(rect[:, 2] - rect[:, 0], min=1).to(f32)
    # col 13: stacked-tile offset of the row's image (view s owns tiles
    # [s·num_tiles, (s+1)·num_tiles))
    toff = ((torch.arange(P, device=dev) // p_img) * cfg.num_tiles).to(f32)
    table = torch.cat(
        [means2d, conic, opacity[:, None], color, depth[:, None],
         x0f[:, None], y0f[:, None], wf[:, None], toff[:, None],
         torch.zeros((P, NFIELD - 14), dtype=f32, device=dev)],
        dim=-1,
    )
    return Compact(ctable=table[ids], gauss_c=gauss_c, ids=ids, valid=valid,
                   local=local, total=total, n_emit=n_emit, seg=seg)


def sort_slots(cfg, fslot: torch.Tensor, c: Compact) -> Staged:
    """Staging, second half (``pallas_blend.py:314-369``): per-slot tile id
    → exact tile cull → stable (tile, depth) sort → per-tile ranges, from
    the slot-space rows ``fslot`` that K3 broadcast. The sort's inverse
    (``inv``) and ``c.seg`` go with the result for K4."""
    dev = fslot.device
    num_tiles = cfg.num_tiles
    total_tiles = cfg.total_tiles
    P = c.ctable.shape[0]
    max_pairs = fslot.shape[1]
    gauss_c, valid = c.gauss_c, c.valid
    f32 = torch.float32

    # per-slot tile id (f32 arithmetic exact: values < 2^24)
    localf = c.local.to(f32)
    dy = torch.floor(localf / fslot[12])
    dx = localf - dy * fslot[12]
    tcx = fslot[10] + dx
    tcy = fslot[11] + dy
    tile = (fslot[13] + tcy * cfg.tiles_x + tcx).to(torch.int64)
    tile = torch.where(valid, tile, total_tiles)

    if tile_culled(cfg):
        # exact per-pair tile cull: a pair whose alpha stays below 1/255 over
        # its whole tile box can never pass the compositor's gate; it retires
        # to the sort tail. Off when n_contrib is requested (the cull shifts
        # that diagnostic's position-in-list).
        keep = _tile_visible(cfg, fslot, tcx, tcy)
        tile = torch.where(keep, tile, total_tiles)
        valid = valid & keep
    # large FINITE sentinel (pallas_blend.py:338-342): the sorted depth row
    # doubles as field row 9
    depth_key = torch.where(valid, fslot[9], torch.full_like(fslot[9], _DEPTH_SENTINEL))
    gc_sent = torch.where(valid, gauss_c, P)

    order = torch.sort((tile << 32) | binning_lib.depth_order_bits(depth_key), stable=True).indices
    inv = torch.empty(max_pairs, dtype=torch.int32, device=dev)
    inv[order] = torch.arange(max_pairs, dtype=torch.int32, device=dev)
    s_tile = tile[order]
    s_depth = depth_key[order]
    s_gc = gc_sent[order]
    # rows 11-12 come from the per-image tile id (the JAX package takes the
    # modulo only for stacked views; the sentinel rows follow it exactly)
    s_img_tile = s_tile % num_tiles if cfg.n_images > 1 else s_tile
    tyi = s_img_tile // cfg.tiles_x
    tx0 = ((s_img_tile - tyi * cfg.tiles_x) * cfg.tile_w).to(f32)
    ty0 = (tyi * cfg.tile_h).to(f32)
    fields = torch.cat(
        [fslot[:9, order], s_depth[None], s_tile.to(f32)[None], tx0[None], ty0[None],
         torch.zeros((NFIELD - 13, max_pairs), dtype=f32, device=dev)], dim=0)

    tq = torch.arange(total_tiles, dtype=torch.int64, device=dev)
    tile_start = binning_lib.searchsorted_right(s_tile, tq - 1)
    tile_stop = binning_lib.searchsorted_right(s_tile, tq)
    max_per_tile = torch.max(tile_stop - tile_start)
    return Staged(fields=fields, s_tile=s_tile, s_gc=s_gc, ids=c.ids, n_emit=c.n_emit,
                  tile_start=tile_start, tile_stop=tile_stop, total=c.total,
                  max_per_tile=max_per_tile, inv=inv, seg=c.seg)


def sort_stage(cfg, means2d, conic, opacity, color, depth, rect, area,
               max_pairs: int) -> Staged:
    """Expansion → segmented broadcast (K3) → tile cull → stable (tile,
    depth) sort → per-tile ranges (``pallas_blend.py:278-369``). Lockstep
    composites one view: stacked views are refused as in JAX
    (``pallas_blend.py:393-395``)."""
    if cfg.layout == "lockstep" and cfg.n_images > 1:
        raise NotImplementedError("batched multi-view rendering requires layout='mixed'")
    with profiling.span("render.staging"):
        with profiling.span("staging.compact"):
            c = compact_table(cfg, means2d, conic, opacity, color, depth, rect, area, max_pairs)
        with profiling.span("staging.broadcast"):
            fslot = broadcast_fields(c.ctable, c.gauss_c)
        with profiling.span("staging.sort"):
            profiling.count("staging.slots", max_pairs)
            return sort_slots(cfg, fslot, c)


# ---------------------------------------------------------------------------
# K4: segmented reduce of the per-pair gradients
# ---------------------------------------------------------------------------


def reduce_sorted_ref(pair_grads: torch.Tensor, s_gc: torch.Tensor, P: int) -> torch.Tensor:
    """Plain version of K4 by rank array: the segment sum of rows 0-9 of
    ``pair_grads`` [16, max_pairs] by compact rank ``s_gc`` (rank ``P`` is
    dropped), into [P, 16] with columns 10-15 zero. Sums in float64."""
    seg = torch.clamp(s_gc.to(torch.int64), max=P)
    sums = torch.zeros((P + 1, 10), dtype=torch.float64, device=pair_grads.device)
    sums.index_add_(0, seg, pair_grads[:10].T.to(torch.float64))
    out = torch.zeros((P, NFIELD), dtype=pair_grads.dtype, device=pair_grads.device)
    out[:, :10] = sums[:P].to(pair_grads.dtype)
    return out


def _slot_rows(name: str, pair_grads: torch.Tensor) -> torch.Tensor:
    """[16, max_pairs] float32 on a CUDA device → its slot-major rows
    [max_pairs, 16], 16 B aligned: a view for K2's and K6's output (the
    ``.T`` of slot-major rows), a copy for a contiguous [16, N] tensor."""
    if pair_grads.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {pair_grads.device}")
    if (pair_grads.dtype != torch.float32 or pair_grads.dim() != 2
            or pair_grads.shape[0] != NFIELD):
        raise ValueError(f"{name}: pair_grads must be [{NFIELD}, max_pairs] float32, "
                         f"got {tuple(pair_grads.shape)} {pair_grads.dtype}")
    if pair_grads.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: the kernel indexes slots with int32")
    rows = pair_grads.T.contiguous()
    return rows if rows.data_ptr() % 16 == 0 else rows.clone()


def _launch_reduce(rows, idx, seg, ids, n_ranks: int, out) -> None:
    load_library().launch(
        "deblurgs_reduce_sorted", rows.data_ptr(), idx.data_ptr(), seg.data_ptr(),
        None if ids is None else ids.data_ptr(), n_ranks, out.data_ptr(),
        stream_ptr(rows.device))
    profiling.count("kernel.K4")


def reduce_sorted(pair_grads: torch.Tensor, s_gc: torch.Tensor, P: int) -> torch.Tensor:
    """[16, max_pairs] per-slot gradients + [max_pairs] compact ranks (``P``
    = no owner) → [P, 16] per-rank sums of rows 0-9 (columns 10-15 zero),
    with no atomics: two calls give bitwise-equal sums.

    For ranks in any slot order: a stable sort of the ranks gives each
    rank's slots as one run in slot order, and the kernel
    (``csrc/reduce_sorted.cu``) sums each run with one warp. The main path
    needs no sort: :func:`reduce_pair_grads`. CPU tensors take
    :func:`reduce_sorted_ref`; CUDA tensors launch the kernel or raise.
    """
    if pair_grads.device.type == "cpu":
        return reduce_sorted_ref(pair_grads, s_gc, P)
    rows = _slot_rows("reduce_sorted", pair_grads)
    dev = rows.device
    if s_gc.device != dev or s_gc.shape != (rows.shape[0],):
        raise ValueError(f"reduce_sorted: s_gc must be [{rows.shape[0]}] on {dev}")
    if P >= 2 ** 31:
        raise ValueError("reduce_sorted: the kernel indexes ranks with int32")
    key, perm = torch.sort(torch.clamp(s_gc, max=P).to(torch.int32), stable=True)
    seg = torch.searchsorted(key, torch.arange(P + 1, dtype=torch.int32, device=dev),
                             out_int32=True)
    out = torch.zeros((P, NFIELD), dtype=torch.float32, device=dev)
    _launch_reduce(rows, perm.to(torch.int32), seg, None, P, out)
    return out


def reduce_pair_grads_ref(staged: Staged, pair_grads: torch.Tensor, P: int) -> torch.Tensor:
    """Plain version of K4 on the main path: rank r's sum over the pre-sort
    slots [seg[r], seg[r+1]) read at their sorted positions ``inv``, in
    float64, written to original row ``ids[r]``; rows no rank writes are
    zero."""
    seg = staged.seg.to(torch.int64)
    counts = seg[1:] - seg[:-1]
    rank = torch.repeat_interleave(torch.arange(P, device=seg.device), counts)
    slots = staged.inv[int(seg[0]):int(seg[-1])].to(torch.int64)
    sums = torch.zeros((P, 10), dtype=torch.float64, device=pair_grads.device)
    sums.index_add_(0, rank, pair_grads[:10, slots].T.to(torch.float64))
    out = torch.zeros((P, NFIELD), dtype=pair_grads.dtype, device=pair_grads.device)
    hit = counts > 0
    out[staged.ids[hit], :10] = sums[hit].to(pair_grads.dtype)
    return out


def reduce_pair_grads(staged: Staged, pair_grads: torch.Tensor, P: int) -> torch.Tensor:
    """Per-Gaussian sums [P, 16] of the per-slot gradients (columns 10-15
    zero): ``reduce_sorted`` by compact rank and the scatter to original
    rows through ``staged.ids`` (``pallas_blend.py:929-948``), in one pass.

    Before the staging sort the slots lie in runs by rank (``staged.seg``),
    so K4 sums each run through the sort's inverse (``staged.inv``) and
    writes the sum to the rank's original row: no second sort and no
    scatter. Culled slots read as the zeros the compositing kernels leave
    in the tail. CPU tensors take :func:`reduce_pair_grads_ref`; CUDA
    tensors launch the kernel or raise.
    """
    if staged.inv is None or staged.seg is None:
        raise ValueError("reduce_pair_grads: the staged list lacks the sort's inverse and "
                         "the rank runs (stage it with sort_slots)")
    if staged.seg.shape != (P + 1,):
        raise ValueError(f"reduce_pair_grads: {staged.seg.shape[0] - 1} ranks staged, "
                         f"P = {P}")
    if pair_grads.device.type == "cpu":
        return reduce_pair_grads_ref(staged, pair_grads, P)
    rows = _slot_rows("reduce_pair_grads", pair_grads)
    dev = rows.device
    inv, seg = staged.inv, staged.seg
    if (inv.device != dev or seg.device != dev or inv.dtype != torch.int32
            or seg.dtype != torch.int32 or inv.shape != (rows.shape[0],)):
        raise ValueError(f"reduce_pair_grads: inv [{rows.shape[0]}] and seg must be int32 on {dev}")
    out = torch.zeros((P, NFIELD), dtype=torch.float32, device=dev)
    _launch_reduce(rows, inv, seg, staged.ids.to(device=dev, dtype=torch.int32), P, out)
    return out
