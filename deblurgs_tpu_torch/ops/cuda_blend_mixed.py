"""Front-to-back compositing of the staged pair list (K1) and its
per-pair gradients (K2).

Counterpart of ``deblurgs_tpu/ops/pallas_blend_mixed.py``'s
``forward_mixed`` (``pallas_blend_mixed.py:510-589``) and
``backward_mixed`` (``:728-799``). Each kernel (``csrc/forward_mixed.cu``,
``csrc/backward_mixed.cu``) walks each stacked tile's contiguous range of
the depth-sorted pairs; its plain PyTorch version (:func:`forward_ref`,
:func:`backward_ref`) runs the same gates, vectorised over tiles and
pixels and looping over the position in the tile's list.

Outputs are tiled exactly as the JAX function returns them:
``C [T, PX, 3]``, ``D [T, PX]``, ``final_T [T, PX]`` and ``n_con [T, PX]``
int32 (zeros unless ``cfg.need_n_contrib``), with T = stacked tiles and PX
= tile pixels; an empty tile gives C = D = 0, final_T = 1, n_con = 0
(``pallas_blend_mixed.py:578-580``).
"""

from __future__ import annotations

import torch

from deblurgs_tpu_torch.ops.cuda_blend import Staged
from deblurgs_tpu_torch.ops.kernels import load_library, stream_ptr

_ALPHA_MIN = 1.0 / 255.0
_T_EPS = 1e-4
_MAX_TILE_PX = 1024   # 256 threads × 4 pixels per block in the kernels
_LANES, _WARPS = 32, 8  # K2's pixel-sum layout: pixel p = lane + 32·warp + 256·k


def _pixel_coords(cfg, tiles: torch.Tensor, dtype=torch.float32):
    """Pixel centres (integer coordinates) of the given stacked tiles:
    two [n, PX] tensors."""
    img_tile = tiles % cfg.num_tiles
    p = torch.arange(cfg.tile_px, device=tiles.device)
    tx0 = ((img_tile % cfg.tiles_x) * cfg.tile_w).to(dtype)
    ty0 = ((img_tile // cfg.tiles_x) * cfg.tile_h).to(dtype)
    pix_x = tx0[:, None] + (p % cfg.tile_w).to(dtype)[None, :]
    pix_y = ty0[:, None] + (p // cfg.tile_w).to(dtype)[None, :]
    return pix_x, pix_y


def forward_ref(cfg, fields: torch.Tensor, tile_start: torch.Tensor,
                tile_stop: torch.Tensor, tiles: torch.Tensor | None = None,
                count_evals: bool = False):
    """Plain version of K1, on the stacked tiles ``tiles`` (default: all).

    Same arithmetic, in the same order, as the kernel, in the dtype of
    ``fields`` (float32 on the main path; float64 gives an exact yardstick).
    Tiles are walked in lockstep by position in their lists, longest list
    first, so step k only touches the tiles that still have a k-th pair.

    With ``count_evals`` it also returns the number of (pixel, pair) gate
    evaluations that front-to-back compositing of these lists needs: each
    pixel evaluates its tile's pairs in order until it freezes.
    """
    dev, dtype = fields.device, fields.dtype
    if tiles is None:
        tiles = torch.arange(tile_start.shape[0], device=dev)
    tiles = tiles.to(torch.int64)
    start = tile_start[tiles].to(torch.int64)
    count = tile_stop[tiles].to(torch.int64) - start
    n, px_n = tiles.shape[0], cfg.tile_px
    order = torch.argsort(count, descending=True, stable=True)
    start_s = start[order]
    pix_x, pix_y = _pixel_coords(cfg, tiles[order], dtype)

    T = torch.ones((n, px_n), dtype=dtype, device=dev)
    C = torch.zeros((n, px_n, 3), dtype=dtype, device=dev)
    D = torch.zeros((n, px_n), dtype=dtype, device=dev)
    done = torch.zeros((n, px_n), dtype=torch.bool, device=dev)
    n_con = torch.zeros((n, px_n), dtype=torch.int32, device=dev)
    counts = count[order].tolist()
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    m = n
    for k in range(counts[0] if n else 0):
        while counts[m - 1] <= k:
            m -= 1
        f = fields[:10, start_s[:m] + k]
        col = lambda i: f[i][:, None]   # noqa: E731
        dx = col(0) - pix_x[:m]
        dy = col(1) - pix_y[:m]
        power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
        alpha = torch.clamp(col(5) * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
        Tm = T[:m]
        if count_evals:
            evals += torch.sum(~done[:m])
        elig = ~done[:m] & (power <= 0.0) & (alpha >= _ALPHA_MIN)
        test_T = Tm * (1.0 - alpha)
        if cfg.fast:
            contrib = elig
        else:
            stop = elig & (test_T < _T_EPS)
            contrib = elig & ~stop
            done[:m] |= stop
        w = torch.where(contrib, alpha * Tm, 0.0)
        C[:m] += w[..., None] * f[6:9].T[:, None, :]
        D[:m] += w * col(9)
        T[:m] = torch.where(contrib, test_T, Tm)
        if cfg.need_n_contrib:
            n_con[:m] = torch.where(contrib, k + 1, n_con[:m])

    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    out = (C[inv], D[inv], T[inv], n_con[inv])
    return out + (evals,) if count_evals else out


def forward_mixed(cfg, staged: Staged):
    """Composite the staged pairs of all stacked tiles: (C, D, final_T,
    n_con) tiled (see module docstring).

    CPU tensors take :func:`forward_ref`; CUDA tensors launch the kernel
    (``csrc/forward_mixed.cu``) or raise.
    """
    fields = staged.fields
    if fields.device.type == "cpu":
        return forward_ref(cfg, fields, staged.tile_start, staged.tile_stop)
    _check_kernel_inputs("forward_mixed", cfg, staged)
    dev = fields.device
    nt, px_n = cfg.total_tiles, cfg.tile_px
    fields = fields.contiguous()
    start = staged.tile_start.to(device=dev, dtype=torch.int32).contiguous()
    stop = staged.tile_stop.to(device=dev, dtype=torch.int32).contiguous()
    C = torch.empty((nt, px_n, 3), dtype=torch.float32, device=dev)
    D = torch.empty((nt, px_n), dtype=torch.float32, device=dev)
    T = torch.empty((nt, px_n), dtype=torch.float32, device=dev)
    if cfg.need_n_contrib:
        n_con = torch.empty((nt, px_n), dtype=torch.int32, device=dev)
        n_ptr = n_con.data_ptr()
    else:   # a broadcast zero: JAX's shape and values without a [T, PX] memset
        n_con = torch.zeros((), dtype=torch.int32, device=dev).expand(nt, px_n)
        n_ptr = None
    load_library().launch(
        "deblurgs_forward_mixed", fields.data_ptr(), fields.shape[1],
        start.data_ptr(), stop.data_ptr(), nt, cfg.num_tiles, cfg.tiles_x,
        cfg.tile_w, cfg.tile_h, int(cfg.fast), C.data_ptr(), D.data_ptr(),
        T.data_ptr(), n_ptr, stream_ptr(dev))
    forward_mixed.launches += 1
    return C, D, T, n_con


forward_mixed.launches = 0


def _check_kernel_inputs(name, cfg, staged) -> None:
    fields = staged.fields
    nt = cfg.total_tiles
    if fields.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {fields.device}")
    if fields.dtype != torch.float32 or fields.dim() != 2 or fields.shape[0] < 10:
        raise ValueError(f"{name}: fields must be [16, max_pairs] float32, "
                         f"got {tuple(fields.shape)} {fields.dtype}")
    if staged.tile_start.shape != (nt,) or staged.tile_stop.shape != (nt,):
        raise ValueError(f"{name}: tile ranges must have {nt} entries")
    if fields.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: the kernel indexes pairs with int32 tile ranges "
                         f"(max_pairs {fields.shape[1]} >= 2^31)")
    if cfg.tile_px > _MAX_TILE_PX:
        raise ValueError(f"{name}: tiles of {cfg.tile_px} px exceed the kernel's "
                         f"{_MAX_TILE_PX}")


def _pixel_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum [n, PX] over pixels in K2's order: each thread adds its four
    pixels in turn, the warp adds its lanes by a shuffle tree, then the
    eight warp partials are added in warp order."""
    n, px_n = x.shape
    x = torch.nn.functional.pad(x, (0, _MAX_TILE_PX - px_n))
    x = x.reshape(n, _MAX_TILE_PX // (_LANES * _WARPS), _WARPS, _LANES)
    a = x[:, 0]
    for k in range(1, x.shape[1]):
        a = a + x[:, k]                           # [n, WARPS, LANES]
    off = _LANES // 2
    while off:
        a = a[..., :off] + a[..., off:2 * off]
        off //= 2
    s = a[:, 0, 0]
    for w in range(1, _WARPS):
        s = s + a[:, w, 0]
    return s


def backward_total(cfg, bg, final_T, dl_pix, dl_depth, C, D) -> torch.Tensor:
    """Per-pixel ``total = dl·C + final_T·(dl·bg + z_far·dL/dd)`` (with the
    pre-background C and D), the S_0 of every pixel's suffix sums; computed
    outside K2 as the JAX package does (``pallas_blend_mixed.py:737-739``)."""
    sigma_dot = torch.sum(C * dl_pix, dim=-1) + D * dl_depth
    bg_dot = dl_pix @ bg + cfg.z_far * dl_depth
    return sigma_dot + final_T * bg_dot


def backward_ref(cfg, fields: torch.Tensor, tile_start: torch.Tensor,
                 tile_stop: torch.Tensor, dl_pix: torch.Tensor, dl_depth: torch.Tensor,
                 total: torch.Tensor, tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K2 on the stacked tiles ``tiles`` (default: all):
    per-slot gradients [16, max_pairs] (see :func:`backward_mixed`), zero
    in every slot outside these tiles' ranges.

    Replays K1's transmittance front to back with its exact arithmetic, and
    adds each pair's pixel terms in the kernel's order (:func:`_pixel_sum`),
    so on the card it matches the kernel bit for bit. Tiles are walked in
    lockstep by position in their lists, longest list first.
    """
    dev, dtype = fields.device, fields.dtype
    out = torch.zeros((16, fields.shape[1]), dtype=dtype, device=dev)
    if tiles is None:
        tiles = torch.arange(tile_start.shape[0], device=dev)
    tiles = tiles.to(torch.int64)
    start = tile_start[tiles].to(torch.int64)
    count = tile_stop[tiles].to(torch.int64) - start
    n = tiles.shape[0]
    order = torch.argsort(count, descending=True, stable=True)
    start_s = start[order]
    ts = tiles[order]
    pix_x, pix_y = _pixel_coords(cfg, ts, dtype)
    dlr, dlg, dlb = dl_pix[ts].unbind(-1)
    dld = dl_depth[ts]
    tot = total[ts]

    T = torch.ones_like(pix_x)
    prefix = torch.zeros_like(pix_x)
    done = torch.zeros(pix_x.shape, dtype=torch.bool, device=dev)
    counts = count[order].tolist()
    m = n
    for k in range(counts[0] if n else 0):
        while counts[m - 1] <= k:
            m -= 1
        slots = start_s[:m] + k
        f = fields[:10, slots]
        col = lambda i: f[i][:, None]   # noqa: E731
        dx = col(0) - pix_x[:m]
        dy = col(1) - pix_y[:m]
        ca, cbq, cc = col(2), col(3), col(4)
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cbq * dx * dy
        G = torch.exp(torch.clamp(power, max=0.0))
        araw = col(5) * G
        alpha = torch.clamp(araw, max=0.99)
        Tm = T[:m]
        elig = ~done[:m] & (power <= 0.0) & (alpha >= _ALPHA_MIN)
        test_T = Tm * (1.0 - alpha)
        if cfg.fast:
            contrib = elig
        else:
            stop = elig & (test_T < _T_EPS)
            contrib = elig & ~stop
            done[:m] |= stop
        w = torch.where(contrib, alpha * Tm, 0.0)
        r_, g_, b_ = dlr[:m], dlg[:m], dlb[:m]
        d_ = dld[:m]
        dlc = r_ * col(6) + g_ * col(7) + b_ * col(8) + d_ * col(9)
        prefix[:m] = torch.where(contrib, prefix[:m] + w * dlc, prefix[:m])
        S = tot[:m] - prefix[:m]
        dla = torch.where(contrib, dlc * Tm - S / (1.0 - alpha), 0.0)
        N = araw * dla
        gx = ca * dx + cbq * dy
        gy = cc * dy + cbq * dx
        terms = (-N * gx, -N * gy, -0.5 * N * dx * dx, -N * dx * dy, -0.5 * N * dy * dy,
                 G * dla, w * r_, w * g_, w * b_, w * d_)
        for row, term in enumerate(terms):
            out[row, slots] = _pixel_sum(torch.where(contrib, term, 0.0))
        T[:m] = torch.where(contrib, test_T, Tm)
    return out


def backward_mixed(cfg, staged: Staged, bg, final_T, dl_pix, dl_depth, C, D) -> torch.Tensor:
    """Per-pair gradients of the composite: [16, max_pairs] in slot order,
    rows 0-1 d mean2d (pixel space), 2-4 d conic a/b/c (b's full
    gradient), 5 d opacity, 6-8 d rgb, 9 d depth; rows 10-15 and every slot
    outside the tile ranges are zero.

    Inputs are tiled as :func:`forward_mixed` returns them: ``final_T``,
    ``C`` and ``D`` its outputs (pre-background), ``dl_pix`` [T, PX, 3] and
    ``dl_depth`` [T, PX] the cotangents of image and depth; ``bg`` [3].
    CPU tensors take :func:`backward_ref`; CUDA tensors launch the kernel
    (``csrc/backward_mixed.cu``) or raise.
    """
    total = backward_total(cfg, bg, final_T, dl_pix, dl_depth, C, D)
    fields = staged.fields
    if fields.device.type == "cpu":
        return backward_ref(cfg, fields, staged.tile_start, staged.tile_stop, dl_pix,
                            dl_depth, total)
    _check_kernel_inputs("backward_mixed", cfg, staged)
    dev = fields.device
    nt, px_n = cfg.total_tiles, cfg.tile_px
    cot = (dl_pix, dl_depth, total)
    if any(t.device != dev or t.dtype != torch.float32 for t in cot):
        raise ValueError("backward_mixed: cotangents must be float32 on the fields' device")
    if dl_pix.shape != (nt, px_n, 3) or dl_depth.shape != (nt, px_n):
        raise ValueError(f"backward_mixed: cotangents must be [{nt}, {px_n}(, 3)], got "
                         f"{tuple(dl_pix.shape)} and {tuple(dl_depth.shape)}")
    fields = fields.contiguous()
    dl_pix, dl_depth, total = (t.contiguous() for t in cot)
    start = staged.tile_start.to(device=dev, dtype=torch.int32).contiguous()
    stop = staged.tile_stop.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((16, fields.shape[1]), dtype=torch.float32, device=dev)
    load_library().launch(
        "deblurgs_backward_mixed", fields.data_ptr(), fields.shape[1],
        start.data_ptr(), stop.data_ptr(), nt, cfg.num_tiles, cfg.tiles_x,
        cfg.tile_w, cfg.tile_h, int(cfg.fast), dl_pix.data_ptr(), dl_depth.data_ptr(),
        total.data_ptr(), out.data_ptr(), stream_ptr(dev))
    backward_mixed.launches += 1
    return out


backward_mixed.launches = 0
