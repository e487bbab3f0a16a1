"""Loss functions — counterpart of ``deblurgs_tpu/train/losses.py``
(reference ``utils/loss_utils.py``). Images are channel-last
[..., H, W, C], as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (reference ``loss_utils.py:17-18``)."""
    return torch.mean(torch.abs(x - y))


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """SSIM with an 11×11 σ=1.5 Gaussian window (reference ``:23-63``):
    img [H, W, C] in [0, 1], depthwise 'same' convolution per channel."""
    c = img1.shape[-1]
    w = torch.as_tensor(_gaussian_window(window_size), device=img1.device)
    kernel = w[None, None].expand(c, 1, window_size, window_size).to(img1.dtype)

    def filt(x):
        y = torch.nn.functional.conv2d(torch.movedim(x, -1, 0)[None], kernel,
                                       padding=window_size // 2, groups=c)
        return torch.movedim(y[0], 0, -1)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    C1, C2 = 0.01**2, 0.03**2
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return torch.mean(m)


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total variation of [..., H, W] maps (reference ``:66-78``)."""
    return l2_loss(x[..., :-1, :], x[..., 1:, :]) + l2_loss(x[..., :, :-1], x[..., :, 1:])


def batchwise_smoothness_loss(x: torch.Tensor) -> torch.Tensor:
    """L1 between consecutive sub-frames [f, ...] (reference ``:80-93``)."""
    if x.shape[0] == 1:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return l1_loss(x[1:], x[:-1])


def hinge_l2(x: torch.Tensor) -> torch.Tensor:
    """Quadratic penalty outside [0, 1] (reference ``:96-104``)."""
    lo = torch.where(x <= 0.0, x, 0.0)
    hi = torch.where(x >= 1.0, x - 1.0, 0.0)
    return torch.mean(lo**2 + hi**2)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR (reference ``utils/image_utils.py:17-19``)."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
