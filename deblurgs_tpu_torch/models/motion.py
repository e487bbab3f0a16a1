"""Camera-motion model: per-image Bézier trajectories + shutter alignment.

Counterpart of ``deblurgs_tpu/models/motion.py`` (reference
``scene/motion.py``, class CameraMotionModule). Per image i:

- ``rot_ctrl[i]``/``trans_ctrl[i]``: order-C Bézier control points over the
  se(3) log coordinates (curve_type "se3", the default) or over a unit
  quaternion + Cartesian centre ("quarternion_cartesian");
- ``nu[i]``: f-2 alignment logits; sub-frame times are
  ``sort(clamp([0, sigmoid(nu), 1]))`` with optional ±1/(2f) jitter
  (``motion.py:209-219``).

The leaves are a :class:`MotionParams` tuple in the JAX layout (the
training state) or the ``nn.Parameter``s of :class:`MotionModel` (the
render path's module, which carries its config). The batched functions
(:func:`sample_nus`, :func:`subframe_cameras_batch`) take either with an
explicit config and a [B] image index, as the JAX train step vmaps them
(``train/step.py:146-180``). Random draws come from an explicit
``torch.Generator`` or are passed in as uniforms.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from deblurgs_tpu_torch.core import bezier, lie
from deblurgs_tpu_torch.core import camera as cam_lib
from deblurgs_tpu_torch.core import transforms as tf


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    curve_order: int = 9
    n_subframes: int = 21
    curve_type: str = "se3"    # "se3" | "quarternion_cartesian"
    curve_random_sample: bool = False


class MotionParams(NamedTuple):
    """Learnable curve parameters, stacked over n images."""

    rot_ctrl: torch.Tensor    # [n, C+1, 3] (se3 log-rot) or [n, C+1, 4] (quat)
    trans_ctrl: torch.Tensor  # [n, C+1, 3]
    nu: torch.Tensor          # [n, f-2] alignment logits


class MotionModel(nn.Module):
    """The leaves of :class:`MotionParams` as ``nn.Parameter``s plus the
    config: rot_ctrl [n, C+1, 3] (se3 log-rot) or [n, C+1, 4]
    (quaternion), trans_ctrl [n, C+1, 3], nu [n, f-2]."""

    LEAVES = MotionParams._fields

    def __init__(self, cfg: MotionConfig, *, rot_ctrl, trans_ctrl, nu):
        super().__init__()
        self.cfg = cfg
        self.rot_ctrl = nn.Parameter(rot_ctrl)
        self.trans_ctrl = nn.Parameter(trans_ctrl)
        self.nu = nn.Parameter(nu)

    def params(self) -> MotionParams:
        """The leaves as a (detached) :class:`MotionParams`."""
        return MotionParams(*(getattr(self, k).detach() for k in self.LEAVES))


def init_motion(rotations: torch.Tensor, centers: torch.Tensor, cfg: MotionConfig,
                generator: torch.Generator, init_noise: float = 0.001) -> MotionModel:
    """Curves at the given poses + tiny noise (reference ``motion.py:196-205``).

    rotations [n, 3, 3] c2w (column convention), centers [n, 3]; the noise
    is drawn from ``generator`` (rotation curves first, then translation).
    """
    n = rotations.shape[0]
    if cfg.curve_type == "se3":
        c2w = torch.zeros((n, 4, 4), dtype=torch.float32, device=rotations.device)
        c2w[:, :3, :3] = torch.swapaxes(rotations, -1, -2)
        c2w[:, 3, :3] = centers
        c2w[:, 3, 3] = 1.0
        params6 = lie.se3_log_map(c2w)
        rot_ctrl = bezier.init_control_points(params6[:, 3:], cfg.curve_order,
                                              init_noise, generator)
        trans_ctrl = bezier.init_control_points(params6[:, :3], cfg.curve_order,
                                                init_noise, generator)
    elif cfg.curve_type == "quarternion_cartesian":
        quat = _rotmat_to_quat(rotations)
        rot_ctrl = bezier.init_control_points(quat, cfg.curve_order,
                                              init_noise, generator)
        trans_ctrl = bezier.init_control_points(centers, cfg.curve_order,
                                                10 * init_noise, generator)
    else:
        raise NotImplementedError(cfg.curve_type)

    f = cfg.n_subframes
    nu0 = torch.linspace(1.0 / (f - 1), 1.0 - 1.0 / (f - 1), f - 2,
                         device=rotations.device)
    nu = tf.inverse_sigmoid(nu0)[None, :].expand(n, f - 2).contiguous()
    return MotionModel(cfg, rot_ctrl=rot_ctrl, trans_ctrl=trans_ctrl,
                       nu=nu.to(torch.float32))


def _rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion (w, x, y, z), w >= 0
    (branchless Shepperd, as in the JAX package)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) / 2
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) / 2
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) / 2
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) / 2
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _as_index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=device).reshape(-1)


def sample_nus(motion, cam_idx, cfg: MotionConfig,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Sub-frame times of images ``cam_idx`` [B]: [B, f] in [0, 1], sorted
    (reference ``_sample_nu_from_alignment``, ``motion.py:209-219``). With
    ``cfg.curve_random_sample`` and uniforms ``u`` [B, f-2] in [0, 1), adds
    the jitter ``u/f - 1/(2f)``."""
    nu_mid = torch.sigmoid(motion.nu[_as_index(cam_idx, motion.nu.device)])
    if cfg.curve_random_sample and u is not None:
        f = cfg.n_subframes
        nu_mid = nu_mid + (u / f - 1.0 / (2 * f))
    one = torch.ones((nu_mid.shape[0], 1), dtype=nu_mid.dtype, device=nu_mid.device)
    nu = torch.cat([torch.zeros_like(one), nu_mid, one], dim=-1)
    return torch.sort(torch.clamp(nu, 0.0, 1.0), dim=-1).values


def sample_nu(motion: MotionModel, idx: int,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """:func:`sample_nus` of one image: [f]. With ``cfg.curve_random_sample``
    and a generator, the jitter's uniforms are drawn from it."""
    cfg = motion.cfg
    u = None
    if cfg.curve_random_sample and generator is not None:
        u = torch.rand((1, motion.nu.shape[1]), generator=generator,
                       dtype=motion.nu.dtype, device=motion.nu.device)
    return sample_nus(motion, idx, cfg, u)[0]


def _sample_c2w(motion, cam_idx: torch.Tensor, nu: torch.Tensor, cfg: MotionConfig):
    """Trajectory samples of images ``cam_idx`` [B] at ``nu`` [B, f]:
    (c2w rotations [B, f, 3, 3], centres [B, f, 3]) (reference
    ``_sample_c2w_from_nu``, ``motion.py:221-256``)."""
    rot_ctrl, trans_ctrl = motion.rot_ctrl[cam_idx], motion.trans_ctrl[cam_idx]
    if cfg.curve_type == "se3":
        trans = bezier.bezier_eval(trans_ctrl, nu)
        rot = bezier.bezier_eval(rot_ctrl, nu)
        c2w = lie.se3_exp_map(torch.cat([trans, rot], dim=-1))
        return torch.swapaxes(c2w[..., :3, :3], -1, -2), c2w[..., 3, :3]
    if cfg.curve_type == "quarternion_cartesian":
        q = bezier.bezier_eval(rot_ctrl, nu)
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        return tf.quat_to_rotmat(q, normalize=False), bezier.bezier_eval(trans_ctrl, nu)
    raise NotImplementedError(cfg.curve_type)


def sample_c2w(motion: MotionModel, idx: int, nu: torch.Tensor):
    """Sample image ``idx``'s trajectory at ``nu`` [f]: (c2w rotations
    [f, 3, 3], centres [f, 3])."""
    rot, centers = _sample_c2w(motion, _as_index(idx, nu.device), nu[None], motion.cfg)
    return rot[0], centers[0]


def subframe_cameras_batch(motion, cam_idx, nu: torch.Tensor, proj: torch.Tensor,
                           cfg: MotionConfig) -> cam_lib.CameraArrays:
    """CameraArrays of the sub-frames of images ``cam_idx`` [B] at ``nu``
    [B, f], flattened image-major to [B·f, ...] (``_c2w_to_minicam``,
    ``motion.py:258-294``)."""
    rotations, centers = _sample_c2w(motion, _as_index(cam_idx, nu.device), nu, cfg)
    n = rotations.shape[0] * rotations.shape[1]
    view = cam_lib.c2w_to_view(rotations.reshape(n, 3, 3), centers.reshape(n, 3))
    return cam_lib.make_camera_arrays(view, proj)


def subframe_cameras(motion: MotionModel, idx: int, nu: torch.Tensor,
                     proj: torch.Tensor) -> cam_lib.CameraArrays:
    """CameraArrays batched over the sub-frames of image ``idx``."""
    return subframe_cameras_batch(motion, idx, nu[None], proj, motion.cfg)


def middle_cameras(motion: MotionModel, proj: torch.Tensor) -> cam_lib.CameraArrays:
    """Mid-trajectory sharp camera of every image (reference
    ``get_middle_cams``, ``motion.py:322-334``), batched over images."""
    views = []
    for idx in range(motion.nu.shape[0]):
        nu = sample_nu(motion, idx)
        mid = nu.shape[0] // 2
        rotations, centers = sample_c2w(motion, idx, nu[mid:mid + 1])
        views.append(cam_lib.c2w_to_view(rotations, centers)[0])
    return cam_lib.make_camera_arrays(torch.stack(views), proj)
