"""Spherical-harmonics colour evaluation (degrees 0-4).

Counterpart of ``deblurgs_tpu/core/sh.py``: the CUDA kernel's SH→RGB path
(reference ``forward.cu:20-82``) with the fork's two output activations —
``max(sh_poly + 0.5, 0)`` by default, ``sigmoid(sh_poly)`` when
``use_sigmoid``.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH polynomial at unit directions: sh [..., C, (deg+1)²], dirs [..., 3]
    -> [..., C] (reference ``utils/sh_utils.py:57-112`` basis order/signs)."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {deg}")
    result = C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2] - C1 * x * sh[..., 3]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + C2[0] * xy * sh[..., 4]
                      + C2[1] * yz * sh[..., 5]
                      + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                      + C2[3] * xz * sh[..., 7]
                      + C2[4] * (xx - yy) * sh[..., 8])
            if deg > 2:
                result = (result
                          + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                          + C3[1] * xy * z * sh[..., 10]
                          + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                          + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                          + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                          + C3[5] * z * (xx - yy) * sh[..., 14]
                          + C3[6] * x * (xx - 3 * yy) * sh[..., 15])
                if deg > 3:
                    result = (result
                              + C4[0] * xy * (xx - yy) * sh[..., 16]
                              + C4[1] * yz * (3 * xx - yy) * sh[..., 17]
                              + C4[2] * xy * (7 * zz - 1) * sh[..., 18]
                              + C4[3] * yz * (7 * zz - 3) * sh[..., 19]
                              + C4[4] * (zz * (35 * zz - 30) + 3) * sh[..., 20]
                              + C4[5] * xz * (7 * zz - 3) * sh[..., 21]
                              + C4[6] * (xx - yy) * (7 * zz - 1) * sh[..., 22]
                              + C4[7] * xz * (xx - 3 * yy) * sh[..., 23]
                              + C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)) * sh[..., 24])
    return result


def sh_to_color(sh: torch.Tensor, means: torch.Tensor, campos: torch.Tensor,
                deg: int, use_sigmoid: bool = False) -> torch.Tensor:
    """Per-Gaussian view-dependent colour (``computeColorFromSH``,
    ``forward.cu:20-82``).

    sh [P, K, 3]; means [P, 3]; campos [..., 3] (a leading camera batch
    broadcasts: campos [F, 3] gives [F, P, 3]). Returns [..., P, 3].
    """
    dirs = means - campos[..., None, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    # degree 0 reads no direction: broadcast over the camera batch
    rgb = torch.broadcast_to(eval_sh(deg, torch.swapaxes(sh, -1, -2), dirs), dirs.shape)
    if use_sigmoid:
        return torch.sigmoid(rgb)
    return torch.clamp(rgb + 0.5, min=0.0)


def rgb_to_sh(rgb: torch.Tensor, use_sigmoid: bool = False) -> torch.Tensor:
    """DC init (reference ``sh_utils.py:114-115``)."""
    return rgb / C0 if use_sigmoid else (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor, use_sigmoid: bool = False) -> torch.Tensor:
    """Inverse of :func:`rgb_to_sh` (reference ``sh_utils.py:117-118``)."""
    return sh * C0 if use_sigmoid else sh * C0 + 0.5
