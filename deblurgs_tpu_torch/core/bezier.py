"""Bézier curve evaluation.

Counterpart of ``deblurgs_tpu/core/bezier.py``: Bernstein basis with the
reference's descending-power ordering (``bezier.py:54-64``), so ``ctrl[0]``
is the t=1 endpoint and ``ctrl[-1]`` the t=0 endpoint.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def binom_coefficients(order: int) -> np.ndarray:
    """[C(order, 0), ..., C(order, order)] as float64 numpy."""
    return np.array([math.comb(order, k) for k in range(order + 1)], dtype=np.float64)


def bernstein_basis(t: torch.Tensor, order: int) -> torch.Tensor:
    """t [...] in [0,1] -> basis [..., order+1] with
    ``basis[..., k] = C(order,k) · t^(order-k) · (1-t)^k``."""
    binom = torch.as_tensor(binom_coefficients(order), dtype=t.dtype, device=t.device)
    desc = torch.arange(order, -1, -1, dtype=t.dtype, device=t.device)
    asc = torch.arange(0, order + 1, dtype=t.dtype, device=t.device)
    tb = t[..., None]
    # exponent-0 columns get base 1 so 0**0 and its derivative stay finite
    # at the endpoints (same guard as the JAX package)
    tb_d = torch.where(desc == 0, torch.ones_like(tb), tb)
    om_a = torch.where(asc == 0, torch.ones_like(tb), 1.0 - tb)
    return (tb_d ** desc) * (om_a ** asc) * binom


def bezier_eval(control_points: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """control_points [..., order+1, d], t [..., f] -> [..., f, d]
    (reference ``BezierModel.forward``, ``bezier.py:66-83``); leading axes
    of ``t`` pair with those of ``control_points``."""
    order = control_points.shape[-2] - 1
    coeff = bernstein_basis(t, order)
    return torch.einsum("...fk,...kd->...fd", coeff, control_points)


def init_control_points(initial_points: torch.Tensor, order: int, noise: float,
                        generator: torch.Generator) -> torch.Tensor:
    """Repeat each pose into order+1 control points plus N(0, noise) jitter
    drawn from ``generator`` (reference ``bezier.py:40-46``)."""
    pts = initial_points[:, None, :].repeat(1, order + 1, 1)
    draw = torch.randn(pts.shape, generator=generator, dtype=pts.dtype,
                       device=pts.device)
    return pts + noise * draw
