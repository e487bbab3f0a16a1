"""Tile-binned alpha compositing: configuration, tiling, ``blend`` and
``blend_fused``.

Counterpart of ``deblurgs_tpu/ops/tile_blend.py``. Two paths with the
same semantics:

- ``blend_fused`` (``backend="pallas"``, ``tile_blend.py:432-497``):
  staging (K3 plus the sort) → compositing → ``image = C + T·bg`` and
  ``depth = D + T·z_far``; backward: per-pair gradients → their reduce by
  compact rank (K4) → the scatter to original rows. ``cfg.layout`` picks
  the compositing kernels: ``"mixed"`` K1/K2 (stacked views),
  ``"lockstep"`` K5/K6 (one view).
- ``blend`` (``backend="xla"``, ``tile_blend.py:188-431``): a walk over
  pair slots with every tile in lockstep ([num_tiles, tile_px] tensor
  ops), front to back in the forward and back to front in the hand-written
  backward. JAX runs it as ``lax.scan`` outside any Pallas kernel, so here
  it is plain PyTorch, a Python loop of tensor ops.
"""

from __future__ import annotations

import dataclasses

import torch

from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_lockstep, cuda_blend_mixed

_ALPHA_MIN = 1.0 / 255.0
_T_EPS = 1e-4


def _kernels(layout: str):
    """(forward, backward) compositing kernels of a layout, looked up when
    called so that a replaced module attribute takes effect."""
    if layout == "mixed":
        return cuda_blend_mixed.forward_mixed, cuda_blend_mixed.backward_mixed
    return cuda_blend_lockstep.forward_lockstep, cuda_blend_lockstep.backward_lockstep


@dataclasses.dataclass(frozen=True)
class BlendConfig:
    """Static blend parameters (same fields and validation as the JAX
    package's ``BlendConfig``; ``interpret`` has no counterpart here).

    ``window`` and ``chunk`` only shaped the TPU grid: they are validated
    as in JAX and have no effect, on either layout. ``k_max`` caps the
    pairs the xla walk composites a tile, as in JAX.
    """

    width: int
    height: int
    tile_w: int = 16
    tile_h: int = 16
    k_max: int = 1024
    max_pairs: int = 1 << 18
    z_far: float = 100.0
    backend: str = "pallas"
    need_n_contrib: bool = True
    window: int = 1
    layout: str = "mixed"
    tile_cull: bool = True
    fast: bool = False
    n_images: int = 1
    chunk: int = 0

    def __post_init__(self):
        if self.fast and (self.layout != "mixed"
                          or self.backend != "pallas"
                          or self.need_n_contrib):
            raise ValueError(
                "fast blend requires backend='pallas', layout='mixed' and "
                "need_n_contrib=False (its T-freeze diagnostic is the one "
                "thing fast mode drops)")
        if self.chunk:
            if self.layout != "mixed":
                raise ValueError("chunk override requires layout='mixed'")
            if self.chunk % 128 or self.max_pairs % self.chunk:
                raise ValueError(
                    "chunk must be a multiple of 128 dividing max_pairs")

    @property
    def total_tiles(self) -> int:
        return self.num_tiles * self.n_images

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def tile_px(self) -> int:
        return self.tile_w * self.tile_h


def _pixel_coords(cfg: BlendConfig, device):
    """Per-tile flattened pixel coordinates: two [num_tiles, tile_px] f32."""
    t = torch.arange(cfg.num_tiles, device=device)
    p = torch.arange(cfg.tile_px, device=device)
    pix_x = ((t % cfg.tiles_x) * cfg.tile_w)[:, None] + (p % cfg.tile_w)[None, :]
    pix_y = ((t // cfg.tiles_x) * cfg.tile_h)[:, None] + (p // cfg.tile_w)[None, :]
    return pix_x.to(torch.float32), pix_y.to(torch.float32)


def tiles_to_image(cfg: BlendConfig, tiled: torch.Tensor) -> torch.Tensor:
    """[num_tiles, tile_px, ...] -> [H, W, ...] (crop padded borders)."""
    trailing = tiled.shape[2:]
    img = tiled.reshape((cfg.tiles_y, cfg.tiles_x, cfg.tile_h, cfg.tile_w) + trailing)
    img = torch.movedim(img, 2, 1).reshape(
        (cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w) + trailing)
    return img[: cfg.height, : cfg.width]


def image_to_tiles(cfg: BlendConfig, img: torch.Tensor) -> torch.Tensor:
    """[H, W, ...] -> [num_tiles, tile_px, ...] (zero-pad borders)."""
    trailing = img.shape[2:]
    pad_h = cfg.tiles_y * cfg.tile_h - cfg.height
    pad_w = cfg.tiles_x * cfg.tile_w - cfg.width
    padded = img.new_zeros((cfg.height + pad_h, cfg.width + pad_w) + trailing)
    padded[: cfg.height, : cfg.width] = img
    padded = padded.reshape((cfg.tiles_y, cfg.tile_h, cfg.tiles_x, cfg.tile_w) + trailing)
    return torch.movedim(padded, 1, 2).reshape((cfg.num_tiles, cfg.tile_px) + trailing)


def _tiles_to_images(cfg: BlendConfig, tiled: torch.Tensor) -> torch.Tensor:
    """Per-image assembly of a stacked tile axis ([total_tiles, ...] ->
    [n_images, H, W, ...], or [H, W, ...] when unbatched)."""
    if cfg.n_images == 1:
        return tiles_to_image(cfg, tiled)
    per = tiled.reshape((cfg.n_images, cfg.num_tiles) + tiled.shape[1:])
    return torch.stack([tiles_to_image(cfg, t) for t in per])


def _images_to_tiles(cfg: BlendConfig, img: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_tiles_to_images` ([n_images, H, W, ...] or
    [H, W, ...] -> [total_tiles, tile_px, ...])."""
    if cfg.n_images == 1:
        return image_to_tiles(cfg, img)
    return torch.cat([image_to_tiles(cfg, i) for i in img])


class _BlendFused(torch.autograd.Function):
    """Counterpart of the JAX package's ``custom_vjp`` pair
    ``_blend_fused_fwd`` / ``_blend_fused_bwd`` (``tile_blend.py:462-497``).

    Residuals: the staged pair list, final_T and the pre-background C and D.
    The backward runs K2 or K6 (per-slot gradients), K4 (their reduce by
    compact rank) and the scatter to original rows. As in JAX, the cotangent of
    final_T is dropped (``_dT``); n_contrib, num_pairs and max_per_tile are
    not differentiable.
    """

    @staticmethod
    def forward(ctx, cfg, means2d, conic, opacity, color, depth, rect, area, bg):
        staged = cuda_blend.sort_stage(cfg, means2d, conic, opacity, color, depth,
                                       rect, area, cfg.max_pairs)
        C, D, T, n_con = _kernels(cfg.layout)[0](cfg, staged)
        image, depth_img, final_T, n_contrib = compose(cfg, C, D, T, n_con, bg)
        ctx.cfg = cfg
        ctx.staged = staged
        ctx.n_rows = means2d.shape[0]
        ctx.save_for_backward(T, C, D, bg)
        ctx.mark_non_differentiable(n_contrib, staged.total, staged.max_per_tile)
        return image, depth_img, final_T, n_contrib, staged.total, staged.max_per_tile

    @staticmethod
    def backward(ctx, d_image, d_depth, _dT, _dn, _dnp, _dmpt):
        cfg = ctx.cfg
        T, C, D, bg = ctx.saved_tensors
        if d_image is None:
            d_image = torch.zeros_like(C)
        else:
            d_image = _images_to_tiles(cfg, d_image)
        d_depth = torch.zeros_like(D) if d_depth is None else _images_to_tiles(cfg, d_depth)
        pair_grads = _kernels(cfg.layout)[1](cfg, ctx.staged, bg, T, d_image, d_depth, C, D)
        sums = cuda_blend.reduce_pair_grads(ctx.staged, pair_grads, ctx.n_rows)
        dbg = torch.einsum("tp,tpc->c", T, d_image)
        return (None, sums[:, 0:2], sums[:, 2:5], sums[:, 5], sums[:, 6:9], sums[:, 9],
                None, None, dbg)


def blend_fused(cfg: BlendConfig, means2d, conic, opacity, color, depth,
                rect, area, bg):
    """Staging + compositing of all stacked views, differentiable in
    means2d, conic, opacity, color, depth and bg.

    Returns (image, depth_img, final_T, n_contrib, num_pairs, max_per_tile)
    as the JAX function does; gradients flow from image and depth_img.
    """
    return _BlendFused.apply(cfg, means2d, conic, opacity, color, depth, rect, area, bg)


def compose(cfg: BlendConfig, C, D, T, n_con, bg):
    """Tiled compositor outputs → (image, depth, final_T, n_contrib) images:
    ``image = C + T·bg`` and ``depth = D + T·z_far`` (``forward.cu:389-390``)."""
    return (
        _tiles_to_images(cfg, C + T[..., None] * bg),
        _tiles_to_images(cfg, D + T * cfg.z_far),
        _tiles_to_images(cfg, T),
        _tiles_to_images(cfg, n_con),
    )


# ---------------------------------------------------------------------------
# xla backend: a walk over pair slots, all tiles in lockstep
# ---------------------------------------------------------------------------


def _pair_table(means2d, conic, opacity, color, depth) -> torch.Tensor:
    """[P, 10] rows: 0-1 mean, 2-4 conic, 5 opacity, 6-8 colour, 9 depth
    (one gather a step instead of five)."""
    return torch.cat([means2d, conic, opacity[:, None], color, depth[:, None]], dim=-1)


def _step_pairs(pair_gauss, tile_start, tile_stop, table, k: int):
    """Slot k of every tile's list: (valid [nt], Gaussian [nt], rows [nt, 10])."""
    idx = tile_start + k
    pvalid = idx < tile_stop
    g = pair_gauss[torch.clamp(idx, 0, pair_gauss.shape[0] - 1)]
    g = torch.clamp(g, 0, table.shape[0] - 1)
    return pvalid, g, table[g]


def _power(r, pix_x, pix_y):
    dx = r[:, 0:1] - pix_x                      # [nt, px]
    dy = r[:, 1:2] - pix_y
    power = (-0.5 * (r[:, 2:3] * dx * dx + r[:, 4:5] * dy * dy)
             - r[:, 3:4] * dx * dy)
    return dx, dy, power


def walk_length(cfg: BlendConfig, tile_start, tile_stop) -> int:
    """Steps the walk takes: ``min(k_max, longest list)`` (one host read).
    Past the longest list no tile has a pair, and JAX's scan changes
    nothing on those steps, forward or backward."""
    if tile_start.numel() == 0:
        return 0
    return min(cfg.k_max, int(torch.max(tile_stop - tile_start)))


def _xla_forward(cfg, pair_gauss, tile_start, tile_stop, means2d, conic, opacity,
                 color, depth, n_steps: int):
    """Front-to-back compositing of slots [0, n_steps) of every tile's list
    (``tile_blend.py:188-235``): tiled (C, D, T, n_contrib)."""
    dev = means2d.device
    pix_x, pix_y = _pixel_coords(cfg, dev)
    table = _pair_table(means2d, conic, opacity, color, depth)
    nt, px = tile_start.shape[0], cfg.tile_px
    T = torch.ones((nt, px), dtype=torch.float32, device=dev)
    C = torch.zeros((nt, px, 3), dtype=torch.float32, device=dev)
    D = torch.zeros((nt, px), dtype=torch.float32, device=dev)
    done = torch.zeros((nt, px), dtype=torch.bool, device=dev)
    n_con = torch.zeros((nt, px), dtype=torch.int32, device=dev)
    for k in range(n_steps):
        pvalid, _, r = _step_pairs(pair_gauss, tile_start, tile_stop, table, k)
        _, _, power = _power(r, pix_x, pix_y)
        alpha = torch.clamp(r[:, 5:6] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
        eligible = pvalid[:, None] & ~done & (power <= 0.0) & (alpha >= _ALPHA_MIN)
        test_T = T * (1.0 - alpha)
        stop = eligible & (test_T < _T_EPS)
        contribute = eligible & ~stop
        w = torch.where(contribute, alpha * T, 0.0)
        C = C + w[..., None] * r[:, None, 6:9]
        D = D + w * r[:, 9:10]
        T = torch.where(contribute, test_T, T)
        done = done | stop
        n_con = n_con.masked_fill(contribute, k + 1)
    return C, D, T, n_con


def _xla_backward(cfg, pair_gauss, tile_start, tile_stop, means2d, conic, opacity,
                  color, depth, bg, final_T_t, n_con_t, dL_dpix_t, dL_dpixd_t,
                  n_steps: int):
    """Back-to-front gradient walk (``tile_blend.py:238-347``, mirroring
    ``backward.cu:463-640``): suffix colour/depth accumulators rebuilt on
    the way, T recovered by dividing out (1 - alpha). Per-Gaussian sums
    go to their rows with ``index_add_``. Returns (d_means2d, d_conic,
    d_opacity, d_color, d_depth, d_bg)."""
    dev = means2d.device
    pix_x, pix_y = _pixel_coords(cfg, dev)
    table = _pair_table(means2d, conic, opacity, color, depth)
    nt, px = tile_start.shape[0], cfg.tile_px
    bg_dot = (dL_dpix_t @ bg) + cfg.z_far * dL_dpixd_t
    acc = torch.zeros((table.shape[0], 10), dtype=torch.float32, device=dev)
    zeros = lambda *s: torch.zeros((nt, px) + s, dtype=torch.float32, device=dev)  # noqa: E731
    T = final_T_t
    accum_rec, accum_d = zeros(3), zeros()
    last_alpha, last_color, last_depth = zeros(), zeros(3), zeros()
    for k in range(n_steps - 1, -1, -1):
        pvalid, g, r = _step_pairs(pair_gauss, tile_start, tile_stop, table, k)
        dx, dy, power = _power(r, pix_x, pix_y)
        con_a, con_b, con_c, opa = r[:, 2:3], r[:, 3:4], r[:, 4:5], r[:, 5:6]
        col, dep = r[:, None, 6:9], r[:, 9:10]
        G = torch.exp(torch.clamp(power, max=0.0))
        alpha = torch.clamp(opa * G, max=0.99)
        # contributed in the forward: a valid pair before this pixel's stop
        # point that passed the power and alpha gates
        process = (pvalid[:, None] & (k < n_con_t) & (power <= 0.0)
                   & (alpha >= _ALPHA_MIN))
        one_m_a = torch.where(process, 1.0 - alpha, 1.0)
        T_new = T / one_m_a
        dcd = alpha * T_new
        la = last_alpha[..., None]
        accum_rec = torch.where(process[..., None], la * last_color + (1 - la) * accum_rec,
                                accum_rec)
        accum_d = torch.where(process, last_alpha * last_depth + (1 - last_alpha) * accum_d,
                              accum_d)
        dL_dalpha = torch.sum((col - accum_rec) * dL_dpix_t, -1)
        dL_dalpha = dL_dalpha + (dep - accum_d) * dL_dpixd_t
        dL_dalpha = dL_dalpha * T_new
        dL_dalpha = dL_dalpha + (-final_T_t / one_m_a) * bg_dot
        dL_dalpha = torch.where(process, dL_dalpha, 0.0)

        dL_dG = opa * dL_dalpha
        gdx = G * dx
        gdy = G * dy
        # pixel-space mean2d grads (true gradient; ndc scaling is upstream)
        dG_ddelx = -gdx * con_a - gdy * con_b
        dG_ddely = -gdy * con_c - gdx * con_b
        dcd = torch.where(process, dcd, 0.0)
        acc.index_add_(0, g, torch.stack([
            torch.sum(dL_dG * dG_ddelx, -1),
            torch.sum(dL_dG * dG_ddely, -1),
            torch.sum(-0.5 * gdx * dx * dL_dG, -1),
            torch.sum(-(gdx * dy) * dL_dG, -1),       # true grad (CUDA stores half)
            torch.sum(-0.5 * gdy * dy * dL_dG, -1),
            torch.sum(G * dL_dalpha, -1),
            *torch.einsum("tp,tpc->ct", dcd, dL_dpix_t),
            torch.sum(dcd * dL_dpixd_t, -1),
        ], dim=-1))

        T = torch.where(process, T_new, T)
        last_alpha = torch.where(process, alpha, last_alpha)
        last_color = torch.where(process[..., None], col, last_color)
        last_depth = torch.where(process, dep, last_depth)

    dL_dbg = torch.einsum("tp,tpc->c", final_T_t, dL_dpix_t)
    return acc[:, 0:2], acc[:, 2:5], acc[:, 5], acc[:, 6:9], acc[:, 9], dL_dbg


class _Blend(torch.autograd.Function):
    """Counterpart of the JAX package's ``custom_vjp`` ``blend``
    (``tile_blend.py:350-431``) on the xla walk. Residuals: the pair list,
    final T and n_contrib only; the backward is the hand-written
    back-to-front walk, never autograd through the forward loop (at 1080p
    that would keep ~10 [num_tiles, tile_px] tensors a step)."""

    @staticmethod
    def forward(ctx, cfg, pair_gauss, pair_tile, tile_start, tile_stop, means2d, conic,
                opacity, color, depth, bg):
        n_steps = walk_length(cfg, tile_start, tile_stop)
        C, D, T, n_con = _xla_forward(cfg, pair_gauss, tile_start, tile_stop, means2d, conic,
                                      opacity, color, depth, n_steps)
        image, depth_img, final_T, n_contrib = compose(cfg, C, D, T, n_con, bg)
        ctx.cfg, ctx.n_steps = cfg, n_steps
        ctx.save_for_backward(pair_gauss, tile_start, tile_stop, means2d, conic, opacity,
                              color, depth, bg, T, n_con)
        ctx.mark_non_differentiable(n_contrib)
        return image, depth_img, final_T, n_contrib

    @staticmethod
    def backward(ctx, d_image, d_depth, _dT, _dn):
        cfg = ctx.cfg
        (pair_gauss, tile_start, tile_stop, means2d, conic, opacity, color, depth, bg,
         T, n_con) = ctx.saved_tensors
        d_image = (torch.zeros(T.shape + (3,), dtype=T.dtype, device=T.device)
                   if d_image is None else image_to_tiles(cfg, d_image))
        d_depth = torch.zeros_like(T) if d_depth is None else image_to_tiles(cfg, d_depth)
        grads = _xla_backward(cfg, pair_gauss, tile_start, tile_stop, means2d, conic,
                              opacity, color, depth, bg, T, n_con, d_image, d_depth,
                              ctx.n_steps)
        return (None, None, None, None, None) + grads


def blend(cfg: BlendConfig, pair_gauss, pair_tile, tile_start, tile_stop,
          means2d, conic, opacity, color, depth, bg):
    """Composite sorted pairs into one image on the xla walk, at most
    ``cfg.k_max`` pairs a tile (JAX truncates longer lists the same way).

    Returns (image [H, W, 3], depth_img [H, W], final_T [H, W], n_contrib
    [H, W] int32); gradients flow to means2d, conic, opacity, color, depth
    and bg. The kernel path (``backend="pallas"``) stages its own pair list
    inside :func:`blend_fused`.
    """
    if cfg.backend == "pallas":
        raise ValueError("blend runs the xla walk; backend='pallas' composites "
                         "through blend_fused")
    return _Blend.apply(cfg, pair_gauss, pair_tile, tile_start, tile_stop, means2d, conic,
                        opacity, color, depth, bg)


def blend_from_binning(cfg: BlendConfig, binning, means2d, conic, opacity, color, depth, bg):
    """:func:`blend` of a :class:`~deblurgs_tpu_torch.ops.binning.Binning`."""
    return blend(cfg, binning.pair_gauss, binning.pair_tile, binning.tile_start,
                 binning.tile_stop, means2d, conic, opacity, color, depth, bg)
