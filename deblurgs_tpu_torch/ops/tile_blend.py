"""Tile-binned alpha compositing: configuration, tiling and ``blend_fused``.

Counterpart of ``deblurgs_tpu/ops/tile_blend.py``'s fused kernel path
(``tile_blend.py:432-497``). Forward: staging (K3 plus the sort) →
compositing → ``image = C + T·bg`` and ``depth = D + T·z_far``.
Backward: per-pair gradients → their reduce by compact rank (K4) → the
scatter to original rows. ``cfg.layout`` picks the compositing kernels:
``"mixed"`` K1/K2 (stacked views), ``"lockstep"`` K5/K6 (one view).
"""

from __future__ import annotations

import dataclasses

import torch

from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_lockstep, cuda_blend_mixed

# layout -> (forward, backward) compositing kernels
_KERNELS = {
    "mixed": (cuda_blend_mixed.forward_mixed, cuda_blend_mixed.backward_mixed),
    "lockstep": (cuda_blend_lockstep.forward_lockstep, cuda_blend_lockstep.backward_lockstep),
}


@dataclasses.dataclass(frozen=True)
class BlendConfig:
    """Static blend parameters (same fields and validation as the JAX
    package's ``BlendConfig``; ``interpret`` has no counterpart here).

    ``window`` and ``chunk`` only shaped the TPU grid: they are validated
    as in JAX and have no effect, on either layout. ``k_max`` belongs to the not yet ported
    ``backend="xla"`` and has no effect until it lands.
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
        C, D, T, n_con = _KERNELS[cfg.layout][0](cfg, staged)
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
        pair_grads = _KERNELS[cfg.layout][1](cfg, ctx.staged, bg, T, d_image, d_depth, C, D)
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
