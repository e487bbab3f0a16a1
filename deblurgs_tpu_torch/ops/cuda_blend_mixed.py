"""Front-to-back compositing of the staged pair list (K1) and its
per-pair gradients (K2).

Counterpart of ``deblurgs_tpu/ops/pallas_blend_mixed.py``'s
``forward_mixed`` (``pallas_blend_mixed.py:510-589``) and
``backward_mixed`` (``:728-799``). Each kernel (``csrc/forward_mixed.cu``,
``csrc/backward_mixed.cu``) walks each stacked tile's contiguous range of
the depth-sorted pairs; its plain PyTorch version (:func:`forward_ref`,
:func:`backward_ref`) runs the same gates, vectorised over tiles and
pixels and looping over the position in the tile's list. Both kernels
give each warp a compact pixel patch (K1 at 1, 2 or 4 pixels a thread by
tile size, :func:`forward_layout`; K2 at four, :func:`backward_layout`;
row strips where no eight patches fit). K2 sums each pair's pixel terms
over the patches, and its plain version adds them in that order
(:func:`_patch_pair_sums`).
:func:`forward_schedule` walks K1's schedule, warp by warp, and counts the
(warp, pair) visits it makes. The lockstep layout's K5 and K6
(``cuda_blend_lockstep``) launch these two kernels on one view's tiles.

On uncut lists (the staging's tile cull off, :func:`cuda_blend.tile_culled`)
both kernels cull warp by warp: a warp skips a pair whose cull box
(:func:`cull_box`) misses its pixels. No pixel of the warp could have
composited the pair, so the outputs stay bitwise the plain versions'.

Outputs are tiled exactly as the JAX function returns them:
``C [T, PX, 3]``, ``D [T, PX]``, ``final_T [T, PX]`` and ``n_con [T, PX]``
int32 (zeros unless ``cfg.need_n_contrib``), with T = stacked tiles and PX
= tile pixels; an empty tile gives C = D = 0, final_T = 1, n_con = 0
(``pallas_blend_mixed.py:578-580``).
"""

from __future__ import annotations

import functools

import torch

from deblurgs_tpu_torch.ops.cuda_blend import Staged, tile_culled
from deblurgs_tpu_torch.ops.kernels import load_library, stream_ptr

_ALPHA_MIN = 1.0 / 255.0
_T_EPS = 1e-4
_MAX_TILE_PX = 1024   # 256 threads × 4 pixels per block in the kernels
_LANES, _WARPS, _PPT = 32, 8, 4   # a block's warps, lanes and pixels a thread


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
                tile_stop: torch.Tensor, tiles: torch.Tensor | None = None):
    """Plain version of K1, on the stacked tiles ``tiles`` (default: all).

    Same arithmetic, in the same order, as the kernel, in the dtype of
    ``fields`` (float32 on the main path; float64 gives an exact yardstick).
    Tiles are walked in lockstep by position in their lists, longest list
    first, so step k only touches the tiles that still have a k-th pair.
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
    return C[inv], D[inv], T[inv], n_con[inv]


def forward_schedule(cfg, fields: torch.Tensor, tile_start: torch.Tensor,
                     tile_stop: torch.Tensor, tiles: torch.Tensor | None = None):
    """K1's schedule walked in its pixel layout: (C, D, final_T, n_con,
    visits), the outputs bitwise :func:`forward_ref`'s.

    Each warp holds its pixels of :func:`forward_layout` and walks its
    tile's pairs until every one of them has frozen (the per-warp exit,
    checked before every second pair, on uncut lists before every 32: a
    warp live there walks the pairs up to the next check); a warp with no
    pixels walks none. ``visits`` counts
    (warp, pair) visits
    as int64 tensors: ``warp_exit`` of this schedule, ``block_exit`` of the
    schedule K1 had before (row strips p = thread + 256·k, all eight warps
    walking every pair until the whole tile has frozen, checked once a
    256-pair batch), ``composite`` the warp-exit visits in which some pixel
    of the warp composites the pair, and the (pixel, pair) gate
    ``evaluations`` that front-to-back compositing of these lists needs
    (each pixel evaluates its tile's pairs in order until it freezes).
    On uncut lists (the kernels' warp cull on) ``culled`` counts the
    warp-exit visits that the cull skips (the pair's :func:`cull_box`
    misses the warp's pixels, :func:`warp_rects`) and ``culled_composite``
    those of them in which some pixel composites the pair: the cull is
    conservative where that is 0. Both are 0 on tile-culled lists.
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
    pix = forward_pixels(cfg.tile_w, cfg.tile_h).to(dev)     # [warps, LANES, ppt]
    shape = (n,) + pix.shape

    def gather(x):   # [n, PX] → [n, warps, LANES, ppt]
        return torch.cat([x, x.new_zeros((n, 1))], dim=1)[:, pix]

    pix_x, pix_y = (gather(c) for c in _pixel_coords(cfg, tiles[order], dtype))
    T = torch.ones(shape, dtype=dtype, device=dev)
    C = torch.zeros(shape + (3,), dtype=dtype, device=dev)
    D = torch.zeros(shape, dtype=dtype, device=dev)
    n_con = torch.zeros(shape, dtype=torch.int32, device=dev)
    done = (pix == px_n).expand(shape).clone()
    block_live = torch.ones(n, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    visits = {"warp_exit": zero, "block_exit": zero, "composite": zero, "evaluations": zero,
              "culled": zero, "culled_composite": zero}
    cull = not tile_culled(cfg)
    if cull:   # each warp's pixel rectangle in the image, [n, warps]
        rect = warp_rects(cfg.tile_w, cfg.tile_h, pix.cpu()).to(device=dev, dtype=dtype)
        img_tile = tiles[order] % cfg.num_tiles
        org = [((img_tile % cfg.tiles_x) * cfg.tile_w).to(dtype),
               ((img_tile // cfg.tiles_x) * cfg.tile_h).to(dtype)]
        rect = [org[i // 2][:, None] + rect[:, i] for i in range(4)]
    counts = count[order].tolist()
    m = n
    for k in range(counts[0] if n else 0):
        while counts[m - 1] <= k:
            m -= 1
        live = ~done[:m]
        if k % (32 if cull else 2) == 0:
            warp_live = live.flatten(2).any(-1)              # [m, warps]
        else:
            warp_live = warp_live[:m]
        if k % (_LANES * _WARPS) == 0:
            block_live[:m] &= live.flatten(1).any(-1)
        visits["warp_exit"] = visits["warp_exit"] + warp_live.sum()
        visits["block_exit"] = visits["block_exit"] + _WARPS * block_live[:m].sum()
        visits["evaluations"] = visits["evaluations"] + live.sum()
        f = fields[:10, start_s[:m] + k]
        col = lambda i: f[i][:, None, None, None]   # noqa: E731
        dx = col(0) - pix_x[:m]
        dy = col(1) - pix_y[:m]
        power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
        alpha = torch.clamp(col(5) * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
        Tm = T[:m]
        # a stopped warp walks no pair: its pixels take no part
        elig = live & warp_live[..., None, None] & (power <= 0.0) & (alpha >= _ALPHA_MIN)
        test_T = Tm * (1.0 - alpha)
        if cfg.fast:
            contrib = elig
        else:
            stop = elig & (test_T < _T_EPS)
            contrib = elig & ~stop
            done[:m] |= stop
        composite = contrib.flatten(2).any(-1)                  # [m, warps]
        visits["composite"] = visits["composite"] + composite.sum()
        if cull:
            box = cull_box(f)[:, :, None]                      # [4, m, 1]
            culled = warp_live & ((box[1] < rect[0][:m]) | (box[0] > rect[1][:m])
                                  | (box[3] < rect[2][:m]) | (box[2] > rect[3][:m]))
            visits["culled"] = visits["culled"] + culled.sum()
            visits["culled_composite"] = visits["culled_composite"] + (culled & composite).sum()
        w = torch.where(contrib, alpha * Tm, 0.0)
        C[:m] += w[..., None] * f[6:9].T[:, None, None, None, :]
        D[:m] += w * col(9)
        T[:m] = torch.where(contrib, test_T, Tm)
        if cfg.need_n_contrib:
            n_con[:m] = torch.where(contrib, k + 1, n_con[:m])

    # back to [n, PX] in the tiles' order (the dummy column PX takes the
    # layout's empty places)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    flat = pix.flatten()

    def scatter(x, init):
        out = torch.full((n, px_n + 1) + x.shape[4:], init, dtype=x.dtype, device=dev)
        out[:, flat] = x.flatten(1, 3)
        return out[inv, :px_n]

    return (scatter(C, 0.0), scatter(D, 0.0), scatter(T, 1.0), scatter(n_con, 0), visits)


def forward_mixed(cfg, staged: Staged):
    """Composite the staged pairs of all stacked tiles: (C, D, final_T,
    n_con) tiled (see module docstring).

    CPU tensors take :func:`forward_ref`; CUDA tensors launch the kernel
    (``csrc/forward_mixed.cu``) or raise.
    """
    fields = staged.fields
    if fields.device.type == "cpu":
        return forward_ref(cfg, fields, staged.tile_start, staged.tile_stop)
    out = launch_forward("forward_mixed", cfg, staged)
    forward_mixed.launches += 1
    return out


forward_mixed.launches = 0


def launch_forward(name: str, cfg, staged: Staged, cull: bool | None = None):
    """Launch K1's kernel on CUDA tensors (no launch count): the work of
    :func:`forward_mixed` and of K5 (``cuda_blend_lockstep``). ``cull``
    defaults to the lists' own (uncut lists: on)."""
    _check_kernel_inputs(name, cfg, staged)
    cull = not tile_culled(cfg) if cull is None else cull
    fields = staged.fields
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
    ppt, patch_w, nx, _ = forward_layout(cfg.tile_w, cfg.tile_h)
    load_library().launch(
        "deblurgs_forward_mixed", fields.data_ptr(), fields.shape[1],
        start.data_ptr(), stop.data_ptr(), nt, cfg.num_tiles, cfg.tiles_x,
        cfg.tile_w, cfg.tile_h, ppt, patch_w, nx, int(cfg.fast), int(cull), C.data_ptr(),
        D.data_ptr(), T.data_ptr(), n_ptr, stream_ptr(dev))
    return C, D, T, n_con


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


def cull_box(f: torch.Tensor) -> torch.Tensor:
    """The warp cull's pixel box of each pair, [4, n] (x0, x1, y0, y1), from
    its rows 0-9 ``f`` [>=10, n], in the kernels' float32 sequence
    (``csrc/common.cuh::cull_box``, which gives the reckoning): every pixel
    at which the pair can pass the alpha gate lies in the box. A pair with a
    non-finite field, or a conic not clearly positive definite, gets the
    whole plane; one whose opacity cannot reach 1/255 an empty box."""
    finite = torch.isfinite(f[:10]).all(0)
    mx, my, a, b, c, op = (f[i] for i in range(6))
    thr = -torch.log(255.0 * op)
    k = (0.05 + 0.01 * torch.abs(thr)) - thr
    e = 1e-6 * (torch.maximum(torch.abs(a), torch.abs(c)) + torch.abs(b))
    a2, c2 = a - e, c - e
    det = a2 * c2 - b * b
    k2 = 2.0 * k
    hx = torch.sqrt(k2 * c2 / det) * 1.001 + (0.01 + 1e-6 * torch.abs(mx))
    hy = torch.sqrt(k2 * a2 / det) * 1.001 + (0.01 + 1e-6 * torch.abs(my))
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy])
    inf = float("inf")
    empty = torch.tensor([inf, -inf, inf, -inf], dtype=f.dtype, device=f.device)[:, None]
    box = torch.where(k >= 0.0, box, empty)
    ok = finite & (a2 > 0.0) & (c2 > 0.0) & (det > 1e-3 * (a2 * c2))
    return torch.where(ok, box, -empty)


def warp_rects(tile_w: int, tile_h: int, pix: torch.Tensor) -> torch.Tensor:
    """Each warp's pixel rectangle in the tile, [warps, 4] (x0, x1, y0, y1)
    float, from a layout's pixels ``pix`` [warps, LANES, ppt] (tile_px
    where there is none); (inf, -inf, inf, -inf) for a warp without
    pixels (``csrc/common.cuh::warp_rect``)."""
    px = tile_w * tile_h
    flat = pix.flatten(1)
    ok = flat < px
    x, y = (flat % tile_w).double(), (flat // tile_w).double()
    inf = float("inf")
    lo = lambda v: torch.where(ok, v, inf).amin(1)     # noqa: E731
    hi = lambda v: torch.where(ok, v, -inf).amax(1)    # noqa: E731
    return torch.stack([lo(x), hi(x), lo(y), hi(y)], 1)


def _warp_sums(a: torch.Tensor) -> torch.Tensor:
    """[n, warps, LANES] per-lane sums → [n]: each warp adds its lanes by the
    shuffle tree (lanes paired by bit 4, then 3, 2, 1, 0; K2's reduce-scatter
    pairs them the same way), then the warp partials are added in warp order."""
    off = _LANES // 2
    while off:
        a = a[..., :off] + a[..., off:2 * off]
        off //= 2
    s = a[:, 0, 0]
    for w in range(1, a.shape[1]):
        s = s + a[:, w, 0]
    return s


@functools.lru_cache(maxsize=None)
def patch_layout(tile_w: int, tile_h: int, ppt: int = _PPT) -> tuple[int, int, int, int]:
    """Warp patches of a tile_w × tile_h tile at ``ppt`` pixels a thread
    (K2's at 4): (patch_w, patch_h, nx, n).

    A warp owns patch_w × patch_h pixels (patch_h = 32 / patch_w · ppt):
    lane l takes column l % patch_w and rows l / patch_w + k·(32 / patch_w),
    k < ppt. Patches tile the tile nx across, n in all; warp w takes patch
    (w % nx, w // nx). 16-wide patches where the tile is 16 px wide or more
    (32×32 at four pixels → 2×4 patches of 16×8), else the widest power of
    two that fits. The kernels need n <= 8; K2 refuses a tile no width fits
    (a very wide, flat tile), whose sums only the plain version takes in
    this order.
    """
    first = 16 if tile_w >= 16 else 1 << (tile_w.bit_length() - 1)
    shapes = []
    for pw in dict.fromkeys((first, 32, 8, 4, 2, 1)):
        ph = _LANES // pw * ppt
        nx = -(-tile_w // pw)
        shapes.append((pw, ph, nx, nx * -(-tile_h // ph)))
    return next((sh for sh in shapes if sh[3] <= _WARPS), shapes[0])


@functools.lru_cache(maxsize=None)
def forward_layout(tile_w: int, tile_h: int) -> tuple[int, int, int, int]:
    """K1's pixel layout of a tile_w × tile_h tile (at most 1024 pixels):
    (ppt, patch_w, nx, n).

    ``ppt`` pixels a thread, the fewest of 1, 2, 4 whose 256 threads cover
    the tile, in :func:`patch_layout`'s warp patches (a larger ppt where the
    patches of the smaller need more than 8 warps): 16×2 patches for a
    16×16 tile, 16×8 for 32×32. A tile no patches fit takes row strips,
    pixel p = thread + 256·k at four pixels a thread: patch_w = nx = n = 0.
    """
    px = tile_w * tile_h
    if not 0 < px <= _MAX_TILE_PX:
        raise ValueError(f"K1 takes tiles of 1 to {_MAX_TILE_PX} pixels, got {tile_w}x{tile_h}")
    for ppt in (1, 2, 4):
        if px <= _LANES * _WARPS * ppt:
            pw, _, nx, n = patch_layout(tile_w, tile_h, ppt)
            if n <= _WARPS:
                return ppt, pw, nx, n
    return _PPT, 0, 0, 0


def _patch_xy(tile_w: int, tile_h: int, ppt: int = _PPT):
    """Column [warps, LANES, 1] and rows [warps, LANES, ppt] in the tile of
    each (warp, lane, k) of the patch layout (:func:`patch_layout`)."""
    pw, ph, nx, n = patch_layout(tile_w, tile_h, ppt)
    w = torch.arange(n)[:, None, None]
    lane = torch.arange(_LANES)[None, :, None]
    k = torch.arange(ppt)[None, None, :]
    return (w % nx) * pw + lane % pw, (w // nx) * ph + lane // pw + k * (_LANES // pw)


def _layout_xy(tile_w: int, tile_h: int, layout: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Column and row in the tile of each (warp, lane, k) of a pixel
    layout (:func:`forward_layout`'s tuple), [warps, LANES, ppt] each, past
    the tile where the kernels' thread has no pixel: warp patches, or the
    row strips p = thread + 256·k (row tile_h past the last pixel)."""
    ppt, pw = layout[:2]
    if pw:
        x, y = _patch_xy(tile_w, tile_h, ppt)
        return x.expand(y.shape), y
    p = torch.arange(_WARPS * _LANES).reshape(_WARPS, _LANES, 1) + \
        _WARPS * _LANES * torch.arange(ppt)
    px = tile_w * tile_h
    return p % tile_w, torch.where(p < px, p // tile_w, tile_h)


@functools.lru_cache(maxsize=None)
def layout_pixels(tile_w: int, tile_h: int, layout: tuple) -> torch.Tensor:
    """[warps, LANES, ppt] tile pixel of each (warp, lane, k) of a pixel
    layout (:func:`forward_layout`'s tuple), or tile_px where there is
    none."""
    x, y = _layout_xy(tile_w, tile_h, layout)
    return torch.where((x < tile_w) & (y < tile_h), y * tile_w + x, tile_w * tile_h)


def forward_pixels(tile_w: int, tile_h: int) -> torch.Tensor:
    """[warps, LANES, ppt] tile pixel of each (warp, lane, k) of K1's layout
    (:func:`forward_layout`), or tile_px where there is none."""
    return layout_pixels(tile_w, tile_h, forward_layout(tile_w, tile_h))


@functools.lru_cache(maxsize=None)
def backward_layout(tile_w: int, tile_h: int) -> tuple[int, int, int, int]:
    """K2's pixel layout of a tile_w × tile_h tile (at most 1024 pixels),
    (ppt, patch_w, nx, n): four pixels a thread in :func:`patch_layout`'s
    warp patches, one warp a patch (16×8 patches: eight in a 32×32 tile, two
    in a 16×16 tile), or K1's row strips in eight warps where more than
    eight patches would be needed (patch_w = nx = n = 0). Four pixels a
    thread share the warp's reduction among 128 evaluations, which beat
    K1's one pixel a thread on the evaluation lists (PERF.md)."""
    px = tile_w * tile_h
    if not 0 < px <= _MAX_TILE_PX:
        raise ValueError(f"K2 takes tiles of 1 to {_MAX_TILE_PX} pixels, got {tile_w}x{tile_h}")
    pw, _, nx, n = patch_layout(tile_w, tile_h, _PPT)
    return (_PPT, pw, nx, n) if n <= _WARPS else (_PPT, 0, 0, 0)


def backward_pixels(tile_w: int, tile_h: int) -> torch.Tensor:
    """[warps, LANES, 4] tile pixel of each (warp, lane, k) of K2's layout
    (:func:`backward_layout`), or tile_px where there is none."""
    return layout_pixels(tile_w, tile_h, backward_layout(tile_w, tile_h))


def _layout_gather(x: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """[n, PX] → [n, warps, LANES, ppt] by a layout's pixels, zero where a
    (warp, lane, k) has no pixel."""
    return torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)[:, pix.to(x.device)]


def _lane_sum(g: torch.Tensor) -> torch.Tensor:
    """[n, warps, LANES, ppt] → [n, warps, LANES]: each thread adds its
    pixels to +0.0 in turn."""
    a = torch.zeros_like(g[..., 0])
    for k in range(g.shape[-1]):
        a = a + g[..., k]
    return a


def _patch_pixel_sum(cfg, x: torch.Tensor) -> torch.Tensor:
    """Sum [n, PX] over pixels in K2's order (:func:`backward_layout`): each
    thread adds its pixels to +0.0 in turn, the warp adds its lanes by the
    shuffle tree, the warp partials are added in warp order."""
    return _warp_sums(_lane_sum(_layout_gather(x, backward_pixels(cfg.tile_w, cfg.tile_h))))


def _patch_pair_sums(cfg, tiles, f, contrib, N, GD, w, dls, dx, dy):
    """K2's per-pair sums of one walk step in its pixel layout
    (:func:`backward_layout`), in its order: the pixels of a thread that
    share a column share dx, so rows 0-4 come from each column's moments
    ΣN, ΣN·dy and Σ(N·dy)·dy (added over its pixels to +0.0 in turn) and a
    few products by its dx, the columns' terms added in turn (one column in
    warp patches, one a pixel in the row strips); rows 5-9 from the pixels'
    terms; then the shuffle tree and the warp order."""
    dev, dtype = f.device, f.dtype
    layout = backward_layout(cfg.tile_w, cfg.tile_h)
    ppt, pw = layout[:2]
    pix = backward_pixels(cfg.tile_w, cfg.tile_h)
    Nz = _layout_gather(torch.where(contrib, N, 0.0), pix)
    dyg = _layout_gather(dy, pix)
    img_tile = tiles % cfg.num_tiles
    tx0 = ((img_tile % cfg.tiles_x) * cfg.tile_w).to(dtype)[:, None, None, None]
    xs = _layout_xy(cfg.tile_w, cfg.tile_h, layout)[0].to(device=dev, dtype=dtype)
    dxs = f[0][:, None, None, None] - (tx0 + xs)          # [n, warps, LANES, ppt]
    ca, cbq, cc = (f[i][:, None, None] for i in (2, 3, 4))
    lanes = None
    for ks in ([range(ppt)] if pw else [[k] for k in range(ppt)]):
        sN, sNdy, sNdy2 = (torch.zeros_like(Nz[..., 0]) for _ in range(3))
        for k in ks:
            nd = Nz[..., k] * dyg[..., k]
            sN = sN + Nz[..., k]
            sNdy = sNdy + nd
            sNdy2 = sNdy2 + nd * dyg[..., k]
        dxl = dxs[..., ks[0]]
        cadx, cbdx = ca * dxl, cbq * dxl
        terms = [-(cadx * sN + cbq * sNdy), -(cc * sNdy + cbdx * sN), -0.5 * dxl * dxl * sN,
                 -(dxl * sNdy), -0.5 * sNdy2]
        lanes = terms if lanes is None else [a + t for a, t in zip(lanes, terms)]
    lanes += [_lane_sum(_layout_gather(torch.where(contrib, t, 0.0), pix))
              for t in (GD,) + tuple(w * d for d in dls)]
    return [_warp_sums(a) for a in lanes]


def backward_total(cfg, bg, final_T, dl_pix, dl_depth, C, D) -> torch.Tensor:
    """Per-pixel ``total = dl·C + final_T·(dl·bg + z_far·dL/dd)`` (with the
    pre-background C and D), the S_0 of every pixel's suffix sums
    (``pallas_blend_mixed.py:737-739``). Each product and sum is written out
    in the order K2 computes it in its prologue."""
    d0, d1, d2 = dl_pix.unbind(-1)
    c0, c1, c2 = C.unbind(-1)
    sigma_dot = ((c0 * d0 + c1 * d1) + c2 * d2) + D * dl_depth
    bg_dot = ((d0 * bg[0] + d1 * bg[1]) + d2 * bg[2]) + cfg.z_far * dl_depth
    return sigma_dot + final_T * bg_dot


def backward_ref(cfg, fields: torch.Tensor, tile_start: torch.Tensor,
                 tile_stop: torch.Tensor, dl_pix: torch.Tensor, dl_depth: torch.Tensor,
                 total: torch.Tensor, tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K2 on the stacked tiles ``tiles`` (default: all):
    per-slot gradients [16, max_pairs] (see :func:`backward_mixed`), zero
    in every slot outside these tiles' ranges.

    Replays K1's transmittance front to back with its exact arithmetic, and
    adds each pair's pixel terms in the kernel's order
    (:func:`_patch_pair_sums`), so on the card it matches the kernel bit for
    bit.
    """
    return backward_walk(cfg, fields, tile_start, tile_stop, dl_pix, dl_depth, total, tiles,
                         _patch_pair_sums)


def backward_walk(cfg, fields, tile_start, tile_stop, dl_pix, dl_depth, total, tiles,
                  pair_sums) -> torch.Tensor:
    """The backward compositing walk of K2: each step's per-pixel
    quantities go to ``pair_sums`` (the kernel's terms and summation order,
    :func:`_patch_pair_sums`), which returns the ten per-pair sums. Tiles
    are walked in lockstep by position in their lists, longest list
    first."""
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
        sums = pair_sums(cfg, ts[:m], f, contrib, araw * dla, G * dla, w, (r_, g_, b_, d_),
                         dx, dy)
        for row, v in enumerate(sums):
            out[row, slots] = v
        T[:m] = torch.where(contrib, test_T, Tm)
    return out


def backward_mixed(cfg, staged: Staged, bg, final_T, dl_pix, dl_depth, C, D) -> torch.Tensor:
    """Per-pair gradients of the composite: [16, max_pairs] in slot order,
    rows 0-1 d mean2d (pixel space), 2-4 d conic a/b/c (b's full
    gradient), 5 d opacity, 6-8 d rgb, 9 d depth; rows 10-15 and every slot
    outside the tile ranges are zero. From the kernel it is the ``.T`` view
    of a slot-major [max_pairs, 16] tensor, the layout K4 reads.

    Inputs are tiled as :func:`forward_mixed` returns them: ``final_T``,
    ``C`` and ``D`` its outputs (pre-background), ``dl_pix`` [T, PX, 3] and
    ``dl_depth`` [T, PX] the cotangents of image and depth; ``bg`` [3].
    CPU tensors take :func:`backward_ref`; CUDA tensors launch the kernel
    (``csrc/backward_mixed.cu``) or raise.
    """
    fields = staged.fields
    if fields.device.type == "cpu":
        total = backward_total(cfg, bg, final_T, dl_pix, dl_depth, C, D)
        return backward_ref(cfg, fields, staged.tile_start, staged.tile_stop, dl_pix,
                            dl_depth, total)
    out = launch_backward("backward_mixed", cfg, staged, bg, final_T, dl_pix, dl_depth, C, D)
    backward_mixed.launches += 1
    return out


backward_mixed.launches = 0


def launch_backward(name: str, cfg, staged: Staged, bg, final_T, dl_pix, dl_depth, C, D,
                    cull: bool | None = None) -> torch.Tensor:
    """Launch K2's kernel on CUDA tensors (no launch count): the work of
    :func:`backward_mixed` and of K6 (``cuda_blend_lockstep``). ``cull``
    defaults to the lists' own (uncut lists: on)."""
    _check_kernel_inputs(name, cfg, staged)
    cull = not tile_culled(cfg) if cull is None else cull
    fields = staged.fields
    dev = fields.device
    nt, px_n = cfg.total_tiles, cfg.tile_px
    per_px = (dl_pix, dl_depth, C, D, final_T, bg)
    if any(t.device != dev or t.dtype != torch.float32 for t in per_px):
        raise ValueError(f"{name}: cotangents, C, D, final_T and bg must be float32 "
                         "on the fields' device")
    shapes = (dl_pix.shape, C.shape, dl_depth.shape, D.shape, final_T.shape, bg.shape)
    if shapes != ((nt, px_n, 3),) * 2 + ((nt, px_n),) * 3 + ((3,),):
        raise ValueError(f"{name}: expected [{nt}, {px_n}(, 3)] per-pixel inputs "
                         f"and bg [3], got {shapes}")
    _, patch_w, nx, _ = backward_layout(cfg.tile_w, cfg.tile_h)
    fields = fields.contiguous()
    dl_pix, dl_depth, C, D, final_T, bg = (t.contiguous() for t in per_px)
    start = staged.tile_start.to(device=dev, dtype=torch.int32).contiguous()
    stop = staged.tile_stop.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((fields.shape[1], 16), dtype=torch.float32, device=dev)
    load_library().launch(
        "deblurgs_backward_mixed", fields.data_ptr(), fields.shape[1],
        start.data_ptr(), stop.data_ptr(), nt, cfg.num_tiles, cfg.tiles_x,
        cfg.tile_w, cfg.tile_h, patch_w, nx, int(cfg.fast), int(cull), dl_pix.data_ptr(),
        dl_depth.data_ptr(), C.data_ptr(), D.data_ptr(), final_T.data_ptr(), bg.data_ptr(),
        cfg.z_far, out.data_ptr(), stream_ptr(dev))
    return out.T
