"""Pixel-axis sharding: each rank renders a horizontal row slab.

Counterpart of ``deblurgs_tpu/parallel/tile_shard.py``. Each rank renders
its slab through the standard one-view pipeline (cull, bin, sort and blend
on the slab's own lists, so its pair budget and sort shrink by about 1/n);
the frame is the slabs gathered in order.

The slab render is exact through a crop camera (JAX's module docstring has
the derivation): the slab offset folds into the projection's y column, the
focal length is kept by ``tanfovy' = tanfovy·h/H``, and the EWA Jacobian's
view-space clamp keeps the full camera's limits
(``CameraStatic.clamp_tanfovy``), so splats centred outside a slab that
reach into it get the covariances of the full render.

Gradients: the scene inputs are replicated over the ranks
(``shard.replicate``: their cotangents are summed over the slabs in
backward, as ``shard_map``'s transpose does in JAX), and the gathered frame
hands each rank the cotangent of its own rows.
"""

from __future__ import annotations

import math

import torch

from deblurgs_tpu_torch.core.camera import CameraStatic, make_camera_arrays
from deblurgs_tpu_torch.ops import rasterize as ras
from deblurgs_tpu_torch.ops.preprocess import ndc2pix, project_points
from deblurgs_tpu_torch.parallel import shard

PIXEL_AXIS = "px"


def make_pixel_mesh(n_devices: int | None = None, **kw) -> shard.Mesh:
    """1-D mesh over the pixel (row-slab) axis (keywords as ``shard.make_mesh``)."""
    return shard.make_mesh(n_devices, axis=PIXEL_AXIS, **kw)


def slab_layout(cs: CameraStatic, n: int, tile_h: int) -> tuple[int, int]:
    """(slab_h, padded_h): the slab height is tile-aligned; the bottom slab
    may render pad rows that the assembled image crops off."""
    slab_h = -(-(-(-cs.height // n)) // tile_h) * tile_h
    return slab_h, slab_h * n


def crop_cameras(cs: CameraStatic, proj: torch.Tensor, n: int, tile_h: int
                 ) -> tuple[CameraStatic, torch.Tensor]:
    """The slab ``CameraStatic`` and the slabs' projections [n, 4, 4];
    ``proj`` is the full image's (transposed) projection and slab d covers
    rows ``[d·slab_h, (d+1)·slab_h)``."""
    slab_h, _ = slab_layout(cs, n, tile_h)
    H = float(cs.height)
    a = H / slab_h
    projs = []
    for d in range(n):
        b = (H - 2.0 * d * slab_h) / slab_h - 1.0
        p = proj.clone()
        p[:, 1] = a * proj[:, 1] + b * proj[:, 3]
        projs.append(p)
    cs_slab = CameraStatic(width=cs.width, height=slab_h, tanfovx=cs.tanfovx,
                           tanfovy=cs.tanfovy * slab_h / H, znear=cs.znear, zfar=cs.zfar,
                           clamp_tanfovx=cs.lim_tanfovx, clamp_tanfovy=cs.lim_tanfovy)
    return cs_slab, torch.stack(projs)


def row_sharded_render(mesh: shard.Mesh, cs: CameraStatic, proj: torch.Tensor,
                       cfg: ras.RasterizeConfig, sh_degree: int = 0):
    """A row-slab render over ``mesh``: ``fn(means3d, scales, rotations,
    opacities, shs, view, bg, active=None, vsp=None) -> RenderOutput`` with
    the full frame on every rank.

    ``cfg.max_pairs`` is a slab's budget; ``num_pairs`` and
    ``max_per_tile`` are the max over slabs, so the overflow check
    (``num_pairs > cfg.max_pairs``) keeps its meaning. ``radii`` is the max
    and ``visible`` the union over slabs, less the splats whose 3σ rect
    starts below the real tile grid (the bottom slab's pad rows), as in
    JAX.
    """
    n = mesh.size
    cs_slab, projs = crop_cameras(cs, proj, n, cfg.tile_h)
    H, W = cs.height, cs.width

    def fn(means3d, scales, rotations, opacities, shs, view, bg, active=None, vsp=None):
        P = means3d.shape[0]
        if active is None:
            active = torch.ones(P, dtype=torch.bool, device=means3d.device)
        if vsp is None:
            vsp = torch.zeros((P, 2), dtype=means3d.dtype, device=means3d.device)
        means3d, scales, rotations, opacities, shs, view, bg, vsp = shard.replicate(
            mesh, means3d, scales, rotations, opacities, shs, view, bg, vsp)
        cam = make_camera_arrays(view, projs[mesh.rank].to(view.device))
        out = ras.render(means3d, scales, rotations, opacities, shs, cam, cs_slab, bg,
                         cfg=cfg, sh_degree=sh_degree, active=active, vsp=vsp)
        # the frame's float maps in one differentiable gather of the slabs
        maps = torch.cat([out.image, out.depth[..., None], out.final_T[..., None]], -1)
        frame = shard.gather_rows(mesh, maps, 0)[:H]
        n_contrib = shard.all_gather(mesh, out.n_contrib, 0)[:H]
        diag = shard.all_reduce(mesh, torch.cat([
            out.radii.to(torch.int64), out.visible.to(torch.int64),
            torch.stack([out.num_pairs, out.max_per_tile]).to(torch.int64)]), "max")
        radii_u, visible_u = diag[:P], diag[P:2 * P].bool()
        # slab-union visibility over-counts in the bottom slab's tile-pad
        # rows: drop splats whose 3σ rect starts below the real tile grid
        with torch.no_grad():
            _, p_ndc = project_points(means3d, make_camera_arrays(view, proj.to(view.device)))
            py = ndc2pix(p_ndc[..., 1], H)
            in_grid = torch.floor((py - radii_u.to(py.dtype)) / cfg.tile_h) < math.ceil(
                H / cfg.tile_h)
        visible_u = visible_u & in_grid
        radii_u = torch.where(visible_u, radii_u, 0).to(out.radii.dtype)
        return ras.RenderOutput(
            image=frame[..., :3], depth=frame[..., 3], final_T=frame[..., 4],
            n_contrib=n_contrib, radii=radii_u, visible=visible_u,
            num_pairs=diag[2 * P], max_per_tile=diag[2 * P + 1])

    return fn
