"""Image-quality metrics: PSNR / SSIM / LPIPS (reference ``metrics.py``,
``utils/image_utils.py``, ``lpipsPyTorch/``).

Counterpart of ``deblurgs_tpu/eval/metrics.py``. LPIPS is a VGG16 or
AlexNet feature distance whose weights load from a local ``.npz`` (an
explicit path, the ``LPIPS_WEIGHTS`` variable, or ``lpips_weights.npz``
beside this module), written by ``scripts/convert_lpips_weights.py`` in the
JAX package's layout. The reference downloads its weights at run time;
nothing here fetches anything, and without weights LPIPS is ``None`` and
the aggregates report ``None``. The backbones are plain
``torch.nn.functional`` convolutions, in full float32 on the card (TF32
off, ``device.full_f32``).

Semantics pinned to the reference's vendored ``lpipsPyTorch``:

- inputs stay in [0, 1] and are normalised as ``(x − shift) / scale``
  (``modules/networks.py:50-51``; no rescale to [−1, 1] first);
- activations are unit-normalised as ``x / (‖x‖₂ + 1e-10)``
  (``modules/utils.py:6-8``);
- per tap: squared difference → 1×1 non-negative linear head → spatial
  mean; the taps are summed (``modules/lpips.py:30-37``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from deblurgs_tpu_torch.device import resolve_device
from deblurgs_tpu_torch.train.losses import psnr as _psnr
from deblurgs_tpu_torch.train.losses import ssim as _ssim


def psnr(img: torch.Tensor, gt: torch.Tensor) -> float:
    return float(_psnr(img, gt))


def ssim(img: torch.Tensor, gt: torch.Tensor) -> float:
    return float(_ssim(img, gt))


_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# layer specs: ("conv", k, stride, pad, c_out) | ("max", k, stride);
# taps = conv indices (0-based) whose post-relu activation feeds a lin head
LPIPS_ARCHS = {
    "vgg": dict(
        layers=(
            [("conv", 3, 1, 1, 64), ("conv", 3, 1, 1, 64), ("max", 2, 2),
             ("conv", 3, 1, 1, 128), ("conv", 3, 1, 1, 128), ("max", 2, 2),
             ("conv", 3, 1, 1, 256), ("conv", 3, 1, 1, 256),
             ("conv", 3, 1, 1, 256), ("max", 2, 2),
             ("conv", 3, 1, 1, 512), ("conv", 3, 1, 1, 512),
             ("conv", 3, 1, 1, 512), ("max", 2, 2),
             ("conv", 3, 1, 1, 512), ("conv", 3, 1, 1, 512),
             ("conv", 3, 1, 1, 512)]
        ),
        taps=(1, 3, 6, 9, 12),
        channels=(64, 128, 256, 512, 512),
    ),
    "alex": dict(
        layers=(
            [("conv", 11, 4, 2, 64), ("max", 3, 2),
             ("conv", 5, 1, 2, 192), ("max", 3, 2),
             ("conv", 3, 1, 1, 384), ("conv", 3, 1, 1, 256),
             ("conv", 3, 1, 1, 256)]
        ),
        taps=(0, 1, 2, 3, 4),
        channels=(64, 192, 384, 256, 256),
    ),
}


class LPIPS:
    """LPIPS distance. ``weights``: conv kernels ``conv{i}/w`` [kh, kw, cin,
    cout] (HWIO, the JAX package's layout), biases ``conv{i}/b`` [cout] and
    linear heads ``lin{j}/w`` [1, 1, c, 1]; ``net_type`` 'vgg' | 'alex'.
    The weights are held as OIHW tensors on ``device``."""

    #: the packaged default path: drop the converter's output here and
    #: evaluation picks it up with no flag or variable
    DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "lpips_weights.npz")

    def __init__(self, weights: dict, net_type: str = "vgg", device="cuda"):
        dev = resolve_device(device)
        self.weights = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                        .permute(3, 2, 0, 1).contiguous() if k.endswith("/w")
                        else torch.as_tensor(np.asarray(v, np.float32), device=dev)
                        for k, v in weights.items() if not k.startswith("meta")}
        self.arch = LPIPS_ARCHS[net_type]
        self.net_type = net_type
        self.device = dev
        self._shift = torch.as_tensor(_SHIFT, device=dev)
        self._scale = torch.as_tensor(_SCALE, device=dev)

    @classmethod
    def from_file(cls, path: str | None = None, net_type: str | None = None, device="cuda"):
        path = (path or os.environ.get("LPIPS_WEIGHTS", "")
                or (cls.DEFAULT_WEIGHTS if os.path.exists(cls.DEFAULT_WEIGHTS) else ""))
        if not path or not os.path.exists(path):
            return None
        with np.load(path) as d:
            weights = dict(d)
        if net_type is None:
            net_type = str(weights["meta_arch"]) if "meta_arch" in weights else "vgg"
        return cls(weights, net_type=net_type, device=device)

    def _features(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = torch.movedim((x - self._shift) / self._scale, -1, 0)[None]   # NCHW
        outs = []
        conv_i = 0
        for spec in self.arch["layers"]:
            if spec[0] == "max":
                _, k, s = spec
                x = F.max_pool2d(x, k, stride=s)
                continue
            _, k, s, p, _c = spec
            x = F.relu(F.conv2d(x, self.weights[f"conv{conv_i}/w"],
                                self.weights[f"conv{conv_i}/b"], stride=s, padding=p))
            if conv_i in self.arch["taps"]:
                outs.append(x)
            conv_i += 1
        return outs

    def __call__(self, img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """img, gt: [H, W, 3] in [0, 1] → [] distance."""
        with torch.no_grad():
            img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
            gt = torch.as_tensor(gt, dtype=torch.float32, device=self.device)
            total = torch.zeros((), device=self.device)
            for j, (a, b) in enumerate(zip(self._features(img), self._features(gt))):
                a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-10)
                b = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-10)
                d = F.conv2d((a - b) ** 2, self.weights[f"lin{j}/w"])
                total = total + torch.mean(d)
            return total


def evaluate_pairs(renders: list, gts: list, lpips: LPIPS | None = None):
    """Aggregate metrics over (render, gt) image pairs → (dict, per view).
    Images are [H, W, 3] arrays or tensors in [0, 1]; each pair is scored
    on the render's device (the CPU for arrays)."""
    per_view = {"psnr": [], "ssim": [], "lpips": []}
    for img, gt in zip(renders, gts):
        dev = img.device if isinstance(img, torch.Tensor) else "cpu"
        img = torch.as_tensor(img, dtype=torch.float32, device=dev)
        gt = torch.as_tensor(gt, dtype=torch.float32, device=dev)
        with torch.no_grad():
            per_view["psnr"].append(psnr(img, gt))
            per_view["ssim"].append(ssim(img, gt))
        per_view["lpips"].append(float(lpips(img, gt)) if lpips else None)
    agg = {
        "PSNR": float(np.mean(per_view["psnr"])),
        "SSIM": float(np.mean(per_view["ssim"])),
        "LPIPS": float(np.mean(per_view["lpips"])) if lpips else None,
    }
    return agg, per_view


def write_results(out_dir: str, method: str, agg: dict, per_view: dict, image_names: list):
    """``results.json`` / ``per_view.json`` (reference ``metrics.py:88-91``)."""

    def update(path, key, value):
        data = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        data[key] = value
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    update(os.path.join(out_dir, "results.json"), method, agg)
    update(os.path.join(out_dir, "per_view.json"), method,
           {metric: dict(zip(image_names, vals)) for metric, vals in per_view.items()})
