"""Gaussian scene model with static capacity.

Counterpart of ``deblurgs_tpu/models/gaussians.py`` (reference
``scene/gaussian_model.py``). The raw, pre-activation leaves are a
:class:`GaussianParams` tuple in the JAX layout (the training state) or the
``nn.Parameter``s of :class:`GaussianModel` (the render path's module);
the functions below take either. The per-slot bookkeeping is
:class:`GaussianAux`; ``active`` marks the live slots.

Fork-specific activations (``gaussian_model.py:29-51``): opacity =
clamp(0, 1), scaling = exp + lower bound (or the bounded sigmoid),
rotation = L2 normalize, isotropic broadcasts ``scaling[:, :1]``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from deblurgs_tpu_torch.core import sh as sh_lib
from deblurgs_tpu_torch.core import transforms as tf
from deblurgs_tpu_torch.ops.knn import knn3_mean_sq_dist


@dataclasses.dataclass(frozen=True)
class GaussianConfig:
    """Static model hyperparameters (reference ``ModelParams`` subset)."""

    sh_degree: int = 2
    alpha_lower_bound: float = 0.0
    scale_lb: float = 0.0
    scale_ub: float = -1.0     # < 0 → exp activation; else bounded sigmoid
    use_isotropic: bool = False
    use_sigmoid: bool = False  # activation == "sigmoid"
    z_near: float = 0.2
    z_far: float = 100.0

    @property
    def sh_coeffs(self) -> int:
        return (self.sh_degree + 1) ** 2


class GaussianParams(NamedTuple):
    """Learnable leaves, all [capacity, ...] (raw, pre-activation)."""

    xyz: torch.Tensor       # [P, 3]
    f_dc: torch.Tensor      # [P, 1, 3]
    f_rest: torch.Tensor    # [P, K-1, 3]
    scaling: torch.Tensor   # [P, 3]
    rotation: torch.Tensor  # [P, 4] (w, x, y, z)
    opacity: torch.Tensor   # [P, 1]


class GaussianAux(NamedTuple):
    """Non-learnable per-slot state (densification bookkeeping)."""

    active: torch.Tensor          # [P] bool
    max_radii2d: torch.Tensor     # [P] f32
    xyz_grad_accum: torch.Tensor  # [P] f32, accumulated viewspace-gradient norms
    denom: torch.Tensor           # [P] f32


# activations (reference gaussian_model.py:114-146 properties); ``params``
# is a GaussianParams or a GaussianModel


def get_scaling(params, cfg: GaussianConfig) -> torch.Tensor:
    raw = params.scaling
    if cfg.use_isotropic:
        raw = raw[:, :1].expand(raw.shape)
    if cfg.scale_ub < 0.0:
        return tf.lower_bound_exp(raw, cfg.scale_lb)
    return tf.bound_sigmoid(raw, cfg.scale_lb, cfg.scale_ub)


def inverse_scaling(value: torch.Tensor, cfg: GaussianConfig) -> torch.Tensor:
    if cfg.scale_ub < 0.0:
        return tf.lower_bound_log(value, cfg.scale_lb)
    return tf.inverse_bound_sigmoid(value, cfg.scale_lb, cfg.scale_ub)


def get_opacity(params, cfg: GaussianConfig | None = None) -> torch.Tensor:
    return tf.clamp_opacity(params.opacity)


def get_rotation(params) -> torch.Tensor:
    return tf.normalize(params.rotation)


def get_features(params) -> torch.Tensor:
    """[P, K, 3] concat of DC + rest (reference ``get_features``)."""
    return torch.cat([params.f_dc, params.f_rest], dim=1)


def render_inputs(params, cfg: GaussianConfig) -> dict:
    """Activated tensors in the layout ``ops.rasterize.render`` expects."""
    return dict(
        means3d=params.xyz,
        scales=get_scaling(params, cfg),
        rotations=get_rotation(params),
        opacities=get_opacity(params, cfg)[:, 0],
        shs=get_features(params),
    )


def num_active(active: torch.Tensor) -> torch.Tensor:
    """Number of live slots of an ``active`` mask."""
    return torch.sum(active.to(torch.int32))


class GaussianModel(nn.Module):
    """The leaves of :class:`GaussianParams` as ``nn.Parameter``s, for the
    render path: xyz [P, 3], f_dc [P, 1, 3], f_rest [P, K-1, 3], scaling
    [P, 3], rotation [P, 4] (w, x, y, z), opacity [P, 1]."""

    LEAVES = GaussianParams._fields

    def __init__(self, cfg: GaussianConfig, *, xyz, f_dc, f_rest, scaling,
                 rotation, opacity):
        super().__init__()
        self.cfg = cfg
        self.xyz = nn.Parameter(xyz)
        self.f_dc = nn.Parameter(f_dc)
        self.f_rest = nn.Parameter(f_rest)
        self.scaling = nn.Parameter(scaling)
        self.rotation = nn.Parameter(rotation)
        self.opacity = nn.Parameter(opacity)

    def get_scaling(self) -> torch.Tensor:
        return get_scaling(self, self.cfg)

    def get_opacity(self) -> torch.Tensor:
        return get_opacity(self, self.cfg)

    def get_rotation(self) -> torch.Tensor:
        return get_rotation(self)

    def get_features(self) -> torch.Tensor:
        return get_features(self)

    def render_inputs(self) -> dict:
        return render_inputs(self, self.cfg)


# ---------------------------------------------------------------------------
# Initialization (reference create_from_pcd, gaussian_model.py:148-173)
# ---------------------------------------------------------------------------


def create_from_pcd(points: torch.Tensor, colors: torch.Tensor, cfg: GaussianConfig,
                    capacity: int) -> tuple[GaussianParams, GaussianAux]:
    """Seed Gaussians from a point cloud, padded to ``capacity`` slots.

    DC colour = RGB2SH (the fork's inverse-sigmoid variant with
    ``use_sigmoid``); scale = inverse activation of sqrt(mean 3-NN squared
    distance); identity rotation; opacity 0.1 through the inverse
    activation. Padding slots hold safe values and ``active=False``.
    """
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"capacity {capacity} < point count {n}")
    dev = points.device
    f32 = torch.float32
    k = cfg.sh_coeffs
    if cfg.use_sigmoid:
        fused = sh_lib.rgb_to_sh(tf.inverse_sigmoid(torch.clamp(colors, 1e-4, 1 - 1e-4)),
                                 use_sigmoid=True)
    else:
        fused = sh_lib.rgb_to_sh(colors, use_sigmoid=False)
    dist2 = torch.clamp(knn3_mean_sq_dist(points.to(f32)), min=1e-7)
    scales = inverse_scaling(torch.sqrt(dist2), cfg)[:, None].repeat(1, 3)
    lb = cfg.alpha_lower_bound
    opacity = tf.inverse_clamp_opacity(
        torch.full((n, 1), lb + (1.0 - lb) * 0.1, dtype=f32, device=dev))

    def pad(x, fill=0.0):
        x = x.to(f32)
        return torch.cat([x, torch.full((capacity - n,) + x.shape[1:], fill, dtype=f32,
                                        device=dev)])

    rotation = torch.zeros((capacity, 4), dtype=f32, device=dev)
    rotation[:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(points), f_dc=pad(fused[:, None, :]),
        f_rest=torch.zeros((capacity, k - 1, 3), dtype=f32, device=dev),
        scaling=pad(scales), rotation=rotation, opacity=pad(opacity))
    zeros = torch.zeros(capacity, dtype=f32, device=dev)
    aux = GaussianAux(active=torch.arange(capacity, device=dev) < n, max_radii2d=zeros,
                      xyz_grad_accum=zeros.clone(), denom=zeros.clone())
    return params, aux


def reset_opacity(params: GaussianParams, cfg: GaussianConfig,
                  new_opacity: float | None = None) -> GaussianParams:
    """Clamp opacities down to ≈0.1 (reference ``reset_opacity``,
    ``gaussian_model.py:247-253``); the caller zeros the opacity moments."""
    if new_opacity is None:
        lb = cfg.alpha_lower_bound
        new_opacity = lb + (1.0 - lb) * min(1.0, max(0.0, 0.1))
    cur = get_opacity(params, cfg)
    return params._replace(opacity=tf.inverse_clamp_opacity(torch.clamp(cur, max=new_opacity)))


def decay_opacity(params: GaussianParams, cfg: GaussianConfig, r: float) -> GaussianParams:
    """Multiply activated opacity by r (reference ``decay_opacity``,
    ``gaussian_model.py:460-462``)."""
    return params._replace(opacity=tf.inverse_clamp_opacity(get_opacity(params, cfg) * r))


def light_prune(aux: GaussianAux, keep_mask: torch.Tensor) -> GaussianAux:
    """Deactivate slots outside ``keep_mask`` without optimizer surgery
    (reference ``light_prune``, ``gaussian_model.py:346-353``)."""
    return aux._replace(active=aux.active & keep_mask)


def one_up_sh_degree(active_degree: int, cfg: GaussianConfig) -> int:
    """Reference ``oneupSHdegree``: the next active SH degree."""
    return min(active_degree + 1, cfg.sh_degree)
