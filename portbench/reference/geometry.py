"""Plain cameras, sub-frame trajectories and view-dependent colour.

The reference's own code, in plain PyTorch, for what DeblurGS derives
before rasterising (taekkii/deblurgs ``scene/motion.py``,
``utils/pytorch3d_functions.py``, ``utils/graphics_utils.py``,
``utils/sh_utils.py``): row-vector view matrices, the se(3) Bézier curve
of each blurry image and its sub-frame cameras, and spherical-harmonics
colour. It imports nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)


def projection(znear: float, zfar: float, fovx: float, fovy: float, dtype, device):
    """The row-vector perspective matrix (``getProjectionMatrix`` transposed)."""
    t = math.tan(fovy / 2) * znear
    r = math.tan(fovx / 2) * znear
    P = torch.zeros((4, 4), dtype=torch.float64)
    P[0, 0] = znear / r
    P[1, 1] = znear / t
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = 1.0
    P[3, 2] = -(zfar * znear) / (zfar - znear)
    return P.to(dtype=dtype, device=device)


def view_matrix(rot: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """c2w rotation [..., 3, 3] and centre [..., 3] → the transposed
    world-to-view matrix [..., 4, 4] (``p_view = [p, 1] @ view``)."""
    top =torch.cat([rot, torch.zeros_like(rot[..., :1])], -1)
    bottom = torch.cat([-(center[..., None, :] @ rot)[..., 0, :],
                        torch.ones_like(center[..., :1])], -1)
    return torch.cat([top, bottom[..., None, :]], -2)


def camera_center(view: torch.Tensor) -> torch.Tensor:
    """Centre of a rigid row-vector view: ``-view[3, :3] @ view[:3, :3]ᵀ``."""
    return -(view[..., 3:4, :3] @ view[..., :3, :3].transpose(-1, -2))[..., 0, :]


def _hat(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _acos_lin(x: torch.Tensor, bound: float) -> torch.Tensor:
    """arccos, continued linearly outside [-bound, bound] (pytorch3d)."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)   # noqa: E731
    slope = -1.0 / torch.sqrt(c(max(1.0 - bound * bound, 1e-12)))
    upper = (x - bound) * slope + torch.arccos(c(bound))
    lower = (x + bound) * slope + torch.arccos(c(-bound))
    return torch.where(x >= bound, upper,
                       torch.where(x <= -bound, lower, torch.arccos(x.clamp(-bound, bound))))


def _v_matrix(skew, skew2, angle):
    eye = torch.eye(3, dtype=skew.dtype, device=skew.device)
    t1 = ((1.0 - torch.cos(angle)) / (angle * angle))[..., None, None]
    t2 = ((angle - torch.sin(angle)) / (angle ** 3))[..., None, None]
    return eye + skew * t1 + skew2 * t2


def se3_exp(log6: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """``[log_T | log_R]`` → row-vector SE(3) [..., 4, 4] (pytorch3d
    ``se3_exp_map``: ``M[:3, :3] = Rᵀ``, ``M[3, :3] = V log_T``)."""
    log_t, log_r = log6[..., :3], log6[..., 3:]
    angle = torch.sqrt(torch.clamp((log_r * log_r).sum(-1), min=eps))
    skew = _hat(log_r)
    skew2 = skew @ skew
    inv = 1.0 / angle
    R = ((inv * torch.sin(angle))[..., None, None] * skew
         + (inv * inv * (1.0 - torch.cos(angle)))[..., None, None] * skew2
         + torch.eye(3, dtype=log6.dtype, device=log6.device))
    T = (_v_matrix(skew, skew2, angle) @ log_t[..., None])[..., 0]
    top = torch.cat([R.transpose(-1, -2), torch.zeros_like(R[..., :1])], -1)
    bottom = torch.cat([T, torch.ones_like(T[..., :1])], -1)
    return torch.cat([top, bottom[..., None, :]], -2)


def se3_log(M: torch.Tensor, eps: float = 1e-4, cos_bound: float = 1e-4) -> torch.Tensor:
    """Row-vector SE(3) [..., 4, 4] → ``[log_T | log_R]`` (pytorch3d
    ``se3_log_map`` with its ``so3_log_map``)."""
    R = M[..., :3, :3].transpose(-1, -2)
    phi = _acos_lin(((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]) - 1.0) * 0.5,
                    1.0 - cos_bound)
    s = torch.sin(phi)
    ok = s.abs() > 0.5 * eps
    factor = torch.where(ok, phi / (2.0 * torch.where(ok, s, torch.ones_like(s))),
                         0.5 + phi * phi / 12.0)
    h = factor[..., None, None] * (R - R.transpose(-1, -2))
    log_r = torch.stack([h[..., 2, 1], h[..., 0, 2], h[..., 1, 0]], -1)
    angle = torch.sqrt(torch.clamp((log_r * log_r).sum(-1), min=eps))
    skew = _hat(log_r)
    V = _v_matrix(skew, skew @ skew, angle)
    log_t = torch.linalg.solve(V, M[..., 3, :3][..., None])[..., 0]
    return torch.cat([log_t, log_r], -1)


def bezier(ctrl: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Order-C Bézier curve with the reference's descending powers
    (``ctrl[0]`` is the t = 1 end): ctrl [..., C+1, d], t [..., f] →
    [..., f, d]."""
    order = ctrl.shape[-2] - 1
    k = torch.arange(order + 1, device=t.device)
    binom = torch.tensor([math.comb(order, int(i)) for i in k], dtype=t.dtype,
                         device=t.device)
    desc = (order - k).to(t.dtype)
    asc = k.to(t.dtype)
    tb = t[..., None]
    # 0**0 and its derivative stay finite at the ends
    a = torch.where(desc == 0, torch.ones_like(tb), tb) ** desc
    b = torch.where(asc == 0, torch.ones_like(tb), 1.0 - tb) ** asc
    return (a * b * binom) @ ctrl


def subframe_times(nu_logits: torch.Tensor) -> torch.Tensor:
    """[f-2] alignment logits → the f sorted sub-frame times in [0, 1]."""
    mid = torch.sigmoid(nu_logits)
    t = torch.cat([torch.zeros_like(mid[:1]), mid, torch.ones_like(mid[:1])])
    return torch.sort(torch.clamp(t, 0.0, 1.0)).values


def subframe_views(rot_ctrl: torch.Tensor, trans_ctrl: torch.Tensor,
                   nu_logits: torch.Tensor) -> torch.Tensor:
    """One image's curves → the [f, 4, 4] views of its sub-frames."""
    t = subframe_times(nu_logits)
    M = se3_exp(torch.cat([bezier(trans_ctrl, t), bezier(rot_ctrl, t)], -1))
    return view_matrix(M[..., :3, :3].transpose(-1, -2), M[..., 3, :3])


def sh_color(shs: torch.Tensor, means: torch.Tensor, campos: torch.Tensor,
             degree: int) -> torch.Tensor:
    """Degree ≤ 2 SH colour with the fork's ``max(x + 0.5, 0)``: shs
    [P, K, 3], means [P, 3], campos [F, 3] → [F, P, 3]."""
    if degree > 2:
        raise ValueError(f"the reference evaluates SH degree <= 2, got {degree}")
    d = means[None] - campos[:, None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    sh = lambda i: shs[None, :, i, :]   # noqa: E731
    rgb = SH_C0 * sh(0)
    if degree > 0:
        x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
        rgb = rgb - SH_C1 * y * sh(1) + SH_C1 * z * sh(2) - SH_C1 * x * sh(3)
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            rgb = (rgb + SH_C2[0] * (x * y) * sh(4) + SH_C2[1] * (y * z) * sh(5)
                   + SH_C2[2] * (2.0 * zz - xx - yy) * sh(6) + SH_C2[3] * (x * z) * sh(7)
                   + SH_C2[4] * (xx - yy) * sh(8))
    rgb = torch.broadcast_to(rgb, d.shape)
    return torch.clamp(rgb + 0.5, min=0.0)
