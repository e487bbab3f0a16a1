"""Single-view compositing for ``layout="lockstep"`` (K5) and its per-pair
gradients (K6).

Counterpart of ``deblurgs_tpu/ops/pallas_blend.py``'s ``forward``
(``pallas_blend.py:765-821``) and ``backward`` (``:951-1038``). They compute
what K1 and K2 compute, on the tiles of one view: the JAX package refuses
lockstep with stacked views (``:393-395``), and so does
:func:`~deblurgs_tpu_torch.ops.cuda_blend.sort_stage`. So K5 launches K1's
kernel and K6 K2's (``csrc/forward_mixed.cu``, ``csrc/backward_mixed.cu``)
on the view's tiles, in their pixel layouts, with the warp cull on the
uncut lists that evaluation stages (``need_n_contrib`` on). Their plain
versions are K1's and K2's (``cuda_blend_mixed.forward_ref``,
``backward_ref``), and each kernel agrees with its plain version bit for
bit on the card. The launch counters stay their own, so a run can tell the
lockstep launches from the mixed ones. K6 writes the slot-major
[max_pairs, 16] rows K2 writes, the layout K4 reads.

Outputs are tiled as the JAX function returns them: ``C [T, PX, 3]``,
``D [T, PX]``, ``final_T [T, PX]`` and ``n_con [T, PX]`` int32 (zeros unless
``cfg.need_n_contrib``); an empty tile gives C = D = 0, final_T = 1,
n_con = 0. ``window`` only shaped the TPU grid and has no effect here.
"""

from __future__ import annotations

import torch

from deblurgs_tpu_torch.ops.cuda_blend import Staged
from deblurgs_tpu_torch.ops.cuda_blend_mixed import (backward_ref, backward_total, forward_ref,
                                                     launch_backward, launch_forward)

# K5 and K6 compute K1's and K2's functions on one view's tiles, so K1's and
# K2's plain versions are theirs (lockstep refuses ``fast``).
forward_lockstep_ref = forward_ref
backward_lockstep_ref = backward_ref


def _check_one_view(name: str, cfg) -> None:
    if cfg.n_images != 1:
        raise ValueError(f"{name}: the lockstep kernels composite one view")


def forward_lockstep(cfg, staged: Staged):
    """Composite one view's staged pairs: (C, D, final_T, n_con) tiled
    (module docstring). CPU tensors take :func:`forward_lockstep_ref`; CUDA
    tensors launch K1's kernel (``csrc/forward_mixed.cu``) or raise."""
    fields = staged.fields
    if fields.device.type == "cpu":
        return forward_lockstep_ref(cfg, fields, staged.tile_start, staged.tile_stop)
    _check_one_view("forward_lockstep", cfg)
    out = launch_forward("forward_lockstep", cfg, staged)
    forward_lockstep.launches += 1
    return out


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
    launch K2's kernel (``csrc/backward_mixed.cu``) or raise."""
    fields = staged.fields
    if fields.device.type == "cpu":
        total = backward_total(cfg, bg, final_T, dl_pix, dl_depth, C, D)
        return backward_lockstep_ref(cfg, fields, staged.tile_start, staged.tile_stop, dl_pix,
                                     dl_depth, total)
    _check_one_view("backward_lockstep", cfg)
    out = launch_backward("backward_lockstep", cfg, staged, bg, final_T, dl_pix, dl_depth, C, D)
    backward_lockstep.launches += 1
    return out


backward_lockstep.launches = 0
