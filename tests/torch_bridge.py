"""Shared inputs for the parity tests of the PyTorch port.

Scenes and cameras are made with numpy from a seed and handed to both
packages as identical float32 arrays, so no JAX random stream has to be
reproduced in torch.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deblurgs_tpu.core import camera as jcam
from deblurgs_tpu_torch.core import camera as tcam
from deblurgs_tpu_torch.scripts import validate_blur_recovery as vbr


def rodrigues(v: np.ndarray) -> np.ndarray:
    """Axis-angle [..., 3] -> rotation [..., 3, 3] (float64)."""
    v = np.asarray(v, np.float64)
    th = np.linalg.norm(v, axis=-1, keepdims=True)[..., None]
    k = np.where(th > 0, v[..., None, :] / np.maximum(th, 1e-300), 0.0)[..., 0, :]
    K = np.zeros(v.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def projection(znear, zfar, fovx, fovy) -> np.ndarray:
    """Row-vector perspective matrix (as ``get_projection_matrix``)."""
    P = np.zeros((4, 4))
    P[0, 0] = znear / (math.tan(fovx / 2) * znear)
    P[1, 1] = znear / (math.tan(fovy / 2) * znear)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = 1.0
    P[3, 2] = -(zfar * znear) / (zfar - znear)
    return P.astype(np.float32)


def view_from_c2w(rot: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Transposed W2V [..., 4, 4] from c2w rotation and centre (float32)."""
    rot = np.asarray(rot, np.float32)
    center = np.asarray(center, np.float32)
    view = np.zeros(rot.shape[:-2] + (4, 4), np.float32)
    view[..., :3, :3] = rot
    view[..., 3, :3] = -np.einsum("...i,...ij->...j", center, rot)
    view[..., 3, 3] = 1.0
    return view


class NpCamera:
    """One camera (or a batch stacked on axis 0) as float32 numpy arrays
    plus the static fields."""

    def __init__(self, view, proj, width, height, tanfovx, tanfovy):
        self.view = np.asarray(view, np.float32)
        self.proj = np.asarray(proj, np.float32)
        self.full_proj = (self.view @ self.proj).astype(np.float32)
        self.campos = (-np.einsum("...i,...ji->...j", self.view[..., 3, :3],
                                  self.view[..., :3, :3])).astype(np.float32)
        self.static = dict(width=width, height=height, tanfovx=tanfovx,
                           tanfovy=tanfovy, znear=0.01, zfar=100.0)

    def jax(self):
        arrays = jcam.CameraArrays(view=jnp.asarray(self.view),
                                   full_proj=jnp.asarray(self.full_proj),
                                   campos=jnp.asarray(self.campos))
        return arrays, jcam.CameraStatic(**self.static)

    def torch(self):
        arrays = tcam.CameraArrays(view=torch.from_numpy(self.view.copy()),
                                   full_proj=torch.from_numpy(self.full_proj.copy()),
                                   campos=torch.from_numpy(self.campos.copy()))
        return arrays, tcam.CameraStatic(**self.static)


def make_camera(width=48, height=32, fovx=1.1, dist=4.0, angle=0.0, n_views=0,
                seed=15) -> NpCamera:
    """Camera on a circle of radius ``dist`` looking at the origin; with
    ``n_views > 0`` a batch of small pose offsets around it."""
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    rot = rodrigues(np.array([0.0, angle, 0.0]))
    center = rot @ np.array([0.0, 0.0, -dist])
    if n_views:
        rng = np.random.default_rng(seed)
        rot = rodrigues(0.05 * rng.standard_normal((n_views, 3))) @ rot
        center = center[None, :] + 0.1 * rng.standard_normal((n_views, 3))
    return NpCamera(view_from_c2w(rot, center), projection(0.01, 100.0, fovx, fovy),
                    width, height, math.tan(fovx / 2), math.tan(fovy / 2))


def make_gaussians(seed, n=120, spread=1.5, sh_deg=1, opacity_max=0.9,
                   scale_rng=(0.02, 0.3)):
    """(means, scales, rotations, opacities, shs) float32, post-activation."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((n, 3)) * spread
    scales = np.exp(rng.uniform(math.log(scale_rng[0]), math.log(scale_rng[1]), (n, 3)))
    q = rng.standard_normal((n, 4))
    rots = q / np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.05, opacity_max, n)
    shs = rng.standard_normal((n, (sh_deg + 1) ** 2, 3)) * 0.4
    return tuple(np.asarray(x, np.float32) for x in (means, scales, rots, opac, shs))


def gaussian_leaves(seed, n=120, sh_deg=1, **kw) -> dict:
    """Raw (pre-activation) Gaussian leaves in the checkpoint layout
    (``params/<leaf>``) whose default activations give
    :func:`make_gaussians`' scene."""
    means, scales, rots, opac, shs = make_gaussians(seed, n=n, sh_deg=sh_deg, **kw)
    return {"params/xyz": means, "params/f_dc": shs[:, :1].copy(),
            "params/f_rest": shs[:, 1:].copy(), "params/scaling": np.log(scales),
            "params/rotation": rots, "params/opacity": opac[:, None].copy()}


def motion_leaves(n_images=2, order=3, n_subframes=3, dist=4.0, seed=5,
                  curve_type="se3") -> dict:
    """Motion leaves (``motion/<leaf>``) of cameras on a circle looking at
    the origin, with a seeded wobble of the control points so the
    sub-frames differ."""
    import jax

    from deblurgs_tpu.models import motion as jmm

    angles = np.linspace(-0.3, 0.3, n_images)
    rot = rodrigues(np.stack([np.zeros(n_images), angles, np.zeros(n_images)], -1))
    center = np.einsum("nij,j->ni", rot, np.array([0.0, 0.0, -dist]))
    cfg = jmm.MotionConfig(curve_order=order, n_subframes=n_subframes, curve_type=curve_type)
    init = jmm.init_motion(jnp.asarray(rot, jnp.float32), jnp.asarray(center, jnp.float32),
                           cfg, jax.random.PRNGKey(0), init_noise=0.0)
    rng = np.random.default_rng(seed)
    wobble = lambda x: (np.asarray(x) + 0.03 * rng.standard_normal(x.shape)).astype(np.float32)  # noqa: E731
    nu = np.asarray(init.nu) + 0.3 * rng.standard_normal(init.nu.shape)
    return {"motion/rot_ctrl": wobble(init.rot_ctrl), "motion/trans_ctrl": wobble(init.trans_ctrl),
            "motion/nu": nu.astype(np.float32)}


def to_jax(*arrays):
    return tuple(jnp.asarray(np.asarray(a)) for a in arrays)


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def np_of(x) -> np.ndarray:
    """numpy view of a JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_draws(args) -> dict:
    """The draws of JAX's ``scripts/validate_blur_recovery.py`` at ``args``
    (``jax.random.split(PRNGKey(seed), 8)``; the curve noise from the two
    halves of ``ks[6]``, as ``init_motion`` splits it) under the names of
    the port's ``make_draws``."""
    ks = jax.random.split(jax.random.PRNGKey(args.seed), 8)
    k_rot, k_trans = jax.random.split(ks[6])
    n_pts = args.n_gauss + vbr.wall_side(args) ** 2
    ctrl = (args.n_cams, vbr.CURVE_ORDER + 1, 3)
    draws = dict(
        fg=jax.random.normal(ks[0], (args.n_gauss, 3)),
        colors=jax.random.uniform(ks[1], (n_pts, 3), minval=0.05, maxval=0.95),
        sweep_dir=jax.random.normal(ks[3], (args.n_cams, 1, 3)),
        rot_sweep=jax.random.normal(ks[4], (args.n_cams, 1, 3)),
        point_noise=jax.random.normal(ks[5], (n_pts, 3)),
        curve_rot=jax.random.normal(k_rot, ctrl), curve_trans=jax.random.normal(k_trans, ctrl))
    return {k: np.asarray(v, np.float32) for k, v in draws.items()}
