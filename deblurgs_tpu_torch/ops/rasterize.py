"""Public renderer: ``render`` (one view) and ``render_batch`` (F views).

Counterpart of ``deblurgs_tpu/ops/rasterize.py``:

  preprocess → binning → compositing → image/depth

``render`` takes the three backends of the JAX package:

- ``"pallas"``, the kernel path: staging (K3 + stable sort) and
  compositing with ``layout="mixed"`` (K1/K2) or ``layout="lockstep"``
  (K5/K6; one view, the layout of held-out evaluation);
- ``"xla"``: ``bin_gaussians`` and the lockstep walk of
  ``tile_blend.blend``, at most ``k_max`` pairs a tile;
- ``"oracle"``: the dense per-pixel compositor, the correctness anchor.

The defaults stay ``backend="pallas"`` and ``layout="mixed"`` (JAX's are
"xla" and "lockstep"): the kernel path is what the port is for, and
``RasterizeConfig()`` there would be a walk tens of times slower on the
card. A run's ``cfg_args`` without those keys still means JAX's values
(``eval/session.py``). ``render_batch`` requires pallas and the mixed
layout, as in JAX. ``window`` and ``chunk`` are validated as in JAX and
have no effect; ``fast`` and ``need_n_contrib`` change outputs as they do
there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from deblurgs_tpu_torch.core.camera import CameraArrays, CameraStatic
from deblurgs_tpu_torch.core.transforms import build_covariance
from deblurgs_tpu_torch.device import full_f32
from deblurgs_tpu_torch.ops import binning as binning_lib
from deblurgs_tpu_torch.ops import oracle as oracle_lib
from deblurgs_tpu_torch.ops import preprocess as pre_lib
from deblurgs_tpu_torch.ops import tile_blend


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static rasterizer settings (analog of GaussianRasterizationSettings)."""

    tile_w: int = 16
    tile_h: int = 16
    max_pairs: int = 1 << 18
    k_max: int = 1024           # backend="xla": pairs composited a tile (cap)
    backend: str = "pallas"     # "pallas" (kernel path) | "xla" | "oracle"
    cull_z: float = 0.2         # near-cull (auxiliary.h:159)
    z_far: float = 100.0        # depth background (forward.cu:390)
    use_sigmoid: bool = False
    scale_modifier: float = 1.0
    need_n_contrib: bool = True  # n_contrib image is diagnostic-only
    window: int = 1             # TPU grid shape only: no effect here
    layout: str = "mixed"       # "mixed" (K1/K2) | "lockstep" (K5/K6, one view)
    tile_cull: bool = True      # exact per-pair tile cull (only active
                                # when need_n_contrib=False)
    tight_rect: bool = True     # 1/255-ellipse AABB emission rect
    fast: bool = False          # drop the T<1e-4 freeze gate (bounded
                                # error; needs need_n_contrib=False)
    chunk: int = 0              # TPU grid shape only: no effect here

    def __post_init__(self):
        if self.backend not in ("xla", "pallas", "oracle"):
            raise ValueError(
                f"unknown rasterizer backend {self.backend!r} "
                "(expected 'pallas', 'xla' or 'oracle')")
        if self.layout not in ("lockstep", "mixed"):
            raise ValueError(
                f"unknown pallas layout {self.layout!r} "
                "(expected 'lockstep' or 'mixed')")

    def blend_config(self, cs: CameraStatic, n_images: int = 1) -> tile_blend.BlendConfig:
        return tile_blend.BlendConfig(
            width=cs.width, height=cs.height,
            tile_w=self.tile_w, tile_h=self.tile_h,
            k_max=self.k_max, max_pairs=self.max_pairs, z_far=self.z_far,
            backend=self.backend, need_n_contrib=self.need_n_contrib,
            window=self.window, layout=self.layout, tile_cull=self.tile_cull,
            fast=self.fast, n_images=n_images, chunk=self.chunk,
        )


class RenderOutput(NamedTuple):
    image: torch.Tensor         # [(F,) H, W, 3]
    depth: torch.Tensor         # [(F,) H, W]
    final_T: torch.Tensor       # [(F,) H, W] residual transmittance
    n_contrib: torch.Tensor     # [(F,) H, W]
    radii: torch.Tensor         # [(F,) P] int32 (0 = culled)
    visible: torch.Tensor       # [(F,) P] bool
    num_pairs: torch.Tensor     # [] emitted pairs (overflow if > max_pairs)
    max_per_tile: torch.Tensor  # [] longest tile list


def _preprocess(means3d, scales, rotations, opacities, shs, cam, cs, cfg,
                sh_degree, colors_precomp, active, vsp):
    if means3d.is_cuda:
        full_f32()
    cov6 = build_covariance(scales, rotations, cfg.scale_modifier)
    return pre_lib.preprocess(
        means3d, cov6, shs, colors_precomp, opacities, cam, cs,
        sh_degree=sh_degree, use_sigmoid=cfg.use_sigmoid,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, active=active, vsp=vsp,
        cull_z=cfg.cull_z, tight_rect=cfg.tight_rect)


def render(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[torch.Tensor],
    cam: CameraArrays,
    cs: CameraStatic,
    bg: torch.Tensor,
    *,
    cfg: RasterizeConfig = RasterizeConfig(),
    sh_degree: int = 0,
    colors_precomp: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    vsp: Optional[torch.Tensor] = None,
    pre_hook: Optional[Callable] = None,
) -> RenderOutput:
    """Render one view from post-activation Gaussian tensors.

    means3d [P, 3]; scales [P, 3]; rotations [P, 4] (w,x,y,z); opacities
    [P]; shs [P, K, 3] or None with ``colors_precomp`` [P, 3]; active [P]
    bool mask of live slots; vsp optional [P, 2] zeros added to the NDC
    means. The tensors' device decides where it runs. ``pre_hook`` maps the
    preprocessed per-Gaussian fields before binning (the Gaussian-axis
    sharding gathers every rank's rows there).
    """
    pre = _preprocess(means3d, scales, rotations, opacities, shs, cam, cs, cfg,
                      sh_degree, colors_precomp, active, vsp)
    if pre_hook is not None:
        pre = pre_hook(pre)
    if cfg.backend == "oracle":
        image, depth_img, final_T, n_contrib = oracle_lib.oracle_render(
            pre, bg, width=cs.width, height=cs.height, tile_w=cfg.tile_w,
            tile_h=cfg.tile_h, z_far=cfg.z_far)
        num_pairs = torch.sum(pre.tiles_touched.to(torch.int64))
        max_per_tile = torch.zeros((), dtype=torch.int64, device=num_pairs.device)
    elif cfg.backend == "pallas":
        (image, depth_img, final_T, n_contrib,
         num_pairs, max_per_tile) = tile_blend.blend_fused(
            cfg.blend_config(cs), pre.means2d, pre.conic, pre.opacity, pre.color,
            pre.depth, pre.rect, pre.tiles_touched, bg)
    else:
        bcfg = cfg.blend_config(cs)
        bins = binning_lib.bin_gaussians(pre, tiles_x=bcfg.tiles_x, tiles_y=bcfg.tiles_y,
                                         max_pairs=cfg.max_pairs)
        image, depth_img, final_T, n_contrib = tile_blend.blend_from_binning(
            bcfg, bins, pre.means2d, pre.conic, pre.opacity, pre.color, pre.depth, bg)
        num_pairs, max_per_tile = bins.num_pairs, bins.max_per_tile
    return RenderOutput(
        image=image, depth=depth_img, final_T=final_T, n_contrib=n_contrib,
        radii=pre.radius, visible=pre.visible,
        num_pairs=num_pairs, max_per_tile=max_per_tile)


def render_batch(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[torch.Tensor],
    cams: CameraArrays,
    cs: CameraStatic,
    bg: torch.Tensor,
    *,
    cfg: RasterizeConfig = RasterizeConfig(),
    sh_degree: int = 0,
    colors_precomp: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    vsp: Optional[torch.Tensor] = None,
    pre_hook: Optional[Callable] = None,
) -> RenderOutput:
    """Render F views of one scene with ONE staging pass and ONE
    compositing launch: the views stack on the tile axis (view s owns tiles
    [s·nt, (s+1)·nt)).

    cams: CameraArrays batched [F, ...]; vsp optional [F, P, 2].
    ``cfg.max_pairs`` must budget all F views' pairs. Returns image
    [F, H, W, 3], depth/final_T/n_contrib [F, H, W], radii/visible [F, P].
    ``pre_hook`` as in :func:`render`.
    """
    if cfg.backend != "pallas" or cfg.layout != "mixed":
        raise NotImplementedError(
            "render_batch requires backend='pallas', layout='mixed' (got layout="
            f"{cfg.layout!r}, backend={cfg.backend!r})")
    F = cams.view.shape[0]
    pre = _preprocess(means3d, scales, rotations, opacities, shs, cams, cs, cfg,
                      sh_degree, colors_precomp, active, vsp)
    if pre_hook is not None:
        pre = pre_hook(pre)
    P = pre.means2d.shape[-2]
    flat = lambda x: x.reshape((F * P,) + x.shape[2:])  # noqa: E731
    (image, depth_img, final_T, n_contrib,
     num_pairs, max_per_tile) = tile_blend.blend_fused(
        cfg.blend_config(cs, n_images=F), flat(pre.means2d), flat(pre.conic),
        flat(pre.opacity), flat(pre.color), flat(pre.depth), flat(pre.rect),
        flat(pre.tiles_touched), bg)
    # blend_fused drops the view axis when F == 1; this function always
    # returns it
    return RenderOutput(
        image=image.reshape((F,) + image.shape[-3:]),
        depth=depth_img.reshape((F,) + depth_img.shape[-2:]),
        final_T=final_T.reshape((F,) + final_T.shape[-2:]),
        n_contrib=n_contrib.reshape((F,) + n_contrib.shape[-2:]),
        radii=pre.radius, visible=pre.visible,
        num_pairs=num_pairs, max_per_tile=max_per_tile)
