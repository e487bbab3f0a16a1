"""Camera math (row-vector convention, matching the reference).

Counterpart of ``deblurgs_tpu/core/camera.py``. The rasterizer consumes a
camera as three tensors:

- ``view``      [..., 4, 4]: transposed world-to-view; ``p_view = p_hom @ view``
                (reference ``cameras.py:56``)
- ``full_proj`` [..., 4, 4]: ``view @ proj`` (reference ``cameras.py:58``)
- ``campos``    [..., 3]:    camera centre = ``inverse(view)[3, :3]``

Batches stack on axis 0. Static per-camera metadata (image size, fov
tangents, near/far) lives in :class:`CameraStatic`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from deblurgs_tpu_torch.device import resolve_device


class CameraArrays(NamedTuple):
    """Per-camera tensors. Batches stack on axis 0."""

    view: torch.Tensor       # [..., 4, 4] transposed W2V
    full_proj: torch.Tensor  # [..., 4, 4] view @ proj
    campos: torch.Tensor     # [..., 3]


@dataclasses.dataclass(frozen=True)
class CameraStatic:
    """Static camera metadata.

    ``clamp_tanfovx``/``clamp_tanfovy`` override the view-space clamp limits
    of the EWA Jacobian (``compute_cov2d``'s 1.3×tan(fov) guard, reference
    ``forward.cu:92-99``): a crop camera keeps the full image's limits here;
    plain cameras leave them None (= tanfov).
    """

    width: int
    height: int
    tanfovx: float
    tanfovy: float
    znear: float = 0.01
    zfar: float = 100.0
    clamp_tanfovx: float | None = None
    clamp_tanfovy: float | None = None

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tanfovy)

    @property
    def lim_tanfovx(self) -> float:
        return self.tanfovx if self.clamp_tanfovx is None else self.clamp_tanfovx

    @property
    def lim_tanfovy(self) -> float:
        return self.tanfovy if self.clamp_tanfovy is None else self.clamp_tanfovy


def get_projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                          dtype=torch.float32, device="cuda") -> torch.Tensor:
    """OpenGL-style perspective matrix, already transposed to row-vector
    form (reference ``getProjectionMatrix(...).transpose(0,1)``,
    ``graphics_utils.py:51-71`` + ``cameras.py:57``)."""
    t = math.tan(fovy / 2) * znear
    r = math.tan(fovx / 2) * znear
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = znear / r
    P[1, 1] = znear / t
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = 1.0
    P[3, 2] = -(zfar * znear) / (zfar - znear)
    return torch.as_tensor(P, dtype=dtype, device=resolve_device(device))


def world2view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """COLMAP-style (c2w rotation ``R`` as a CameraInfo stores it, w2c
    translation ``t``) -> transposed W2V [4, 4] float32 (reference
    ``getWorld2View2(R, t).transpose(0, 1)``)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return np.ascontiguousarray(Rt.T).astype(np.float32)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def c2w_to_view(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """c2w (rotation [..., 3, 3], centre [..., 3]) -> view [..., 4, 4]:
    ``view[:3, :3] = rot``, ``view[3, :3] = -trans @ rot`` (reference
    ``motion.py:277-279``)."""
    batch = rot.shape[:-2]
    top = torch.cat([rot, torch.zeros(batch + (3, 1), dtype=rot.dtype, device=rot.device)], -1)
    bottom = torch.cat(
        [-torch.einsum("...i,...ij->...j", trans, rot),
         torch.ones(batch + (1,), dtype=rot.dtype, device=rot.device)], -1)
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def make_camera_arrays(view: torch.Tensor, proj: torch.Tensor) -> CameraArrays:
    """Camera tensors from a view matrix and the projection. For a rigid
    view in this convention the centre is ``-view[3,:3] @ view[:3,:3]ᵀ``."""
    campos = -torch.einsum("...i,...ji->...j", view[..., 3, :3], view[..., :3, :3])
    return CameraArrays(view=view, full_proj=view @ proj, campos=campos)
