"""Single-view compositing for ``layout="lockstep"`` (K5) and its per-pair
gradients (K6).

Counterpart of ``deblurgs_tpu/ops/pallas_blend.py``'s ``forward``
(``pallas_blend.py:765-821``) and ``backward`` (``:951-1038``). They compute
what K1 and K2 compute, on the tiles of one view: the JAX package refuses
lockstep with stacked views (``:393-395``), and so does
:func:`~deblurgs_tpu_torch.ops.cuda_blend.sort_stage`. Each kernel
(``csrc/forward_lockstep.cu``, ``csrc/backward_lockstep.cu``) walks each
tile's range of the depth-sorted pairs with one thread per pixel of a 16×16
tile. Their plain PyTorch versions run K1's and K2's walk
(``cuda_blend_mixed.forward_ref``, ``backward_walk``): K5's is K1's, and
K6's sums each pair's pixel terms in K6's own order
(``cuda_blend_mixed._pixel_sum``, pixel rows a warp, not K2's patches), so
on the card each kernel agrees with its plain version bit for bit. K6
writes the slot-major [max_pairs, 16] rows K2 writes, the layout K4 reads.

Outputs are tiled as the JAX function returns them: ``C [T, PX, 3]``,
``D [T, PX]``, ``final_T [T, PX]`` and ``n_con [T, PX]`` int32 (zeros unless
``cfg.need_n_contrib``); an empty tile gives C = D = 0, final_T = 1,
n_con = 0. ``window`` only shaped the TPU grid and has no effect here.
"""

from __future__ import annotations

import torch

from deblurgs_tpu_torch.ops.cuda_blend import NFIELD, Staged
from deblurgs_tpu_torch.ops.cuda_blend_mixed import (_check_kernel_inputs, _row_pair_sums,
                                                     backward_total, backward_walk, forward_ref)
from deblurgs_tpu_torch.ops.kernels import load_library, stream_ptr

# K5 computes K1's function on one view's tiles, so K1's plain version is
# its own (lockstep refuses ``fast``).
forward_lockstep_ref = forward_ref


def backward_lockstep_ref(cfg, fields: torch.Tensor, tile_start: torch.Tensor,
                          tile_stop: torch.Tensor, dl_pix: torch.Tensor,
                          dl_depth: torch.Tensor, total: torch.Tensor,
                          tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K6: K2's walk (``cuda_blend_mixed.backward_walk``)
    with K6's terms and pixel-sum order (``_row_pair_sums``: ``_pixel_sum``,
    whose zero padding leaves each thread's running sum as K6 builds it at
    one, two or four pixels a thread); [16, max_pairs], zero outside the
    tiles' ranges."""
    return backward_walk(cfg, fields, tile_start, tile_stop, dl_pix, dl_depth, total, tiles,
                         _row_pair_sums)


def _check_inputs(name: str, cfg, staged: Staged) -> None:
    if cfg.n_images != 1:
        raise ValueError(f"{name}: the lockstep kernels composite one view")
    _check_kernel_inputs(name, cfg, staged)


def _ranges(staged: Staged, dev):
    return (staged.tile_start.to(device=dev, dtype=torch.int32).contiguous(),
            staged.tile_stop.to(device=dev, dtype=torch.int32).contiguous())


def forward_lockstep(cfg, staged: Staged):
    """Composite one view's staged pairs: (C, D, final_T, n_con) tiled
    (module docstring). CPU tensors take :func:`forward_lockstep_ref`; CUDA
    tensors launch the kernel (``csrc/forward_lockstep.cu``) or raise."""
    fields = staged.fields
    if fields.device.type == "cpu":
        return forward_lockstep_ref(cfg, fields, staged.tile_start, staged.tile_stop)
    _check_inputs("forward_lockstep", cfg, staged)
    dev = fields.device
    nt, px_n = cfg.num_tiles, cfg.tile_px
    fields = fields.contiguous()
    start, stop = _ranges(staged, dev)
    C = torch.empty((nt, px_n, 3), dtype=torch.float32, device=dev)
    D = torch.empty((nt, px_n), dtype=torch.float32, device=dev)
    T = torch.empty((nt, px_n), dtype=torch.float32, device=dev)
    if cfg.need_n_contrib:
        n_con = torch.empty((nt, px_n), dtype=torch.int32, device=dev)
        n_ptr = n_con.data_ptr()
    else:   # a broadcast zero: JAX's shape and values without a memset
        n_con = torch.zeros((), dtype=torch.int32, device=dev).expand(nt, px_n)
        n_ptr = None
    load_library().launch(
        "deblurgs_forward_lockstep", fields.data_ptr(), fields.shape[1], start.data_ptr(),
        stop.data_ptr(), nt, cfg.tiles_x, cfg.tile_w, cfg.tile_h, C.data_ptr(), D.data_ptr(),
        T.data_ptr(), n_ptr, stream_ptr(dev))
    forward_lockstep.launches += 1
    return C, D, T, n_con


forward_lockstep.launches = 0


def backward_lockstep(cfg, staged: Staged, bg, final_T, dl_pix, dl_depth, C, D) -> torch.Tensor:
    """Per-pair gradients of one view's composite: [16, max_pairs] in slot
    order, rows 0-1 d mean2d (pixel space), 2-4 d conic a/b/c (b's full
    gradient), 5 d opacity, 6-8 d rgb, 9 d depth; rows 10-15 and every slot
    outside the tile ranges are zero. From the kernel it is the ``.T`` view
    of a slot-major [max_pairs, 16] tensor. Inputs are tiled as
    :func:`forward_lockstep` returns them (``final_T``, ``C``, ``D``
    pre-background), ``dl_pix`` [T, PX, 3], ``dl_depth`` [T, PX], ``bg``
    [3]. CPU tensors take :func:`backward_lockstep_ref`; CUDA tensors
    launch the kernel (``csrc/backward_lockstep.cu``) or raise."""
    total = backward_total(cfg, bg, final_T, dl_pix, dl_depth, C, D)
    fields = staged.fields
    if fields.device.type == "cpu":
        return backward_lockstep_ref(cfg, fields, staged.tile_start, staged.tile_stop, dl_pix,
                                     dl_depth, total)
    _check_inputs("backward_lockstep", cfg, staged)
    dev = fields.device
    nt, px_n = cfg.num_tiles, cfg.tile_px
    cot = (dl_pix, dl_depth, total)
    if any(t.device != dev or t.dtype != torch.float32 for t in cot):
        raise ValueError("backward_lockstep: cotangents must be float32 on the fields' device")
    if dl_pix.shape != (nt, px_n, 3) or dl_depth.shape != (nt, px_n):
        raise ValueError(f"backward_lockstep: cotangents must be [{nt}, {px_n}(, 3)], got "
                         f"{tuple(dl_pix.shape)} and {tuple(dl_depth.shape)}")
    fields = fields.contiguous()
    dl_pix, dl_depth, total = (t.contiguous() for t in cot)
    start, stop = _ranges(staged, dev)
    out = torch.empty((fields.shape[1], NFIELD), dtype=torch.float32, device=dev)
    load_library().launch(
        "deblurgs_backward_lockstep", fields.data_ptr(), fields.shape[1], start.data_ptr(),
        stop.data_ptr(), nt, cfg.tiles_x, cfg.tile_w, cfg.tile_h, dl_pix.data_ptr(),
        dl_depth.data_ptr(), total.data_ptr(), out.data_ptr(), stream_ptr(dev))
    backward_lockstep.launches += 1
    return out.T


backward_lockstep.launches = 0
