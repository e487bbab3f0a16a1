"""Dense per-pixel oracle compositor: the correctness anchor.

Counterpart of ``deblurgs_tpu/ops/oracle.py``. An O(P · H · W) plain
front-to-back compositor with exactly the semantics of the reference's
blend (``forward.cu:273-392``):

- Gaussians composite in depth order, each pixel taking those whose tile
  rect covers its tile (the coverage of tile binning);
- ``alpha = min(0.99, opacity * exp(power))`` with a straight-through
  clamp (the reference's backward does not gate on the 0.99 clamp,
  ``backward.cu:574-575,621``);
- skip if ``power > 0`` or ``alpha < 1/255``; a pixel stops *before*
  compositing when ``T * (1 - alpha) < 1e-4``;
- ``out = C + T·bg``; ``out_depth = D + T·z_far``.

Its gradients come from plain autograd, as JAX's come from ``jax.grad``:
they are the truth the hand-written backwards are held to.
"""

from __future__ import annotations

import torch


def _straight_through_alpha(opacity, g):
    """min(0.99, o·g) forward, identity gradient through the clamp."""
    raw = opacity * g
    return raw + (torch.clamp(raw, max=0.99) - raw).detach()


def oracle_render(pre, bg: torch.Tensor, *, width: int, height: int, tile_w: int = 16,
                  tile_h: int = 16, z_far: float = 100.0):
    """Render by dense per-pixel compositing: (image [H, W, 3], depth
    [H, W], final_T [H, W], n_contrib [H, W] int32)."""
    dev = pre.means2d.device
    order = torch.argsort(torch.where(pre.visible, pre.depth, torch.inf), stable=True)
    pix_y, pix_x = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                                  torch.arange(width, dtype=torch.float32, device=dev),
                                  indexing="ij")
    tile_ix = (pix_x / tile_w).to(torch.int32)
    tile_iy = (pix_y / tile_h).to(torch.int32)
    means2d, conic, color = pre.means2d[order], pre.conic[order], pre.color[order]
    depth, rect, visible = pre.depth[order], pre.rect[order], pre.visible[order]
    opacity = pre.opacity[order]

    T = torch.ones((height, width), dtype=torch.float32, device=dev)
    C = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    D = torch.zeros((height, width), dtype=torch.float32, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    n_contrib = torch.zeros((height, width), dtype=torch.int32, device=dev)
    for i in range(order.shape[0]):
        rc, con = rect[i], conic[i]
        covered = ((tile_ix >= rc[0]) & (tile_ix < rc[2]) & (tile_iy >= rc[1])
                   & (tile_iy < rc[3]) & visible[i])
        dx = means2d[i, 0] - pix_x
        dy = means2d[i, 1] - pix_y
        power = -0.5 * (con[0] * dx * dx + con[2] * dy * dy) - con[1] * dx * dy
        alpha = _straight_through_alpha(opacity[i], torch.exp(torch.clamp(power, max=0.0)))
        eligible = covered & ~done & (power <= 0.0) & (alpha >= 1.0 / 255.0)
        test_T = T * (1.0 - alpha)
        stop = eligible & (test_T < 1e-4)
        contribute = eligible & ~stop
        w = torch.where(contribute, alpha * T, 0.0)
        C = C + w[..., None] * color[i]
        D = D + w * depth[i]
        T = torch.where(contribute, test_T, T)
        done = done | stop
        n_contrib = n_contrib.masked_fill(contribute, i + 1)

    bg = bg.detach()
    return C + T[..., None] * bg, D + T * z_far, T, n_contrib
