"""Directory-based metrics (reference ``metrics.py``): PSNR / SSIM / LPIPS
over ``<model>/test/<method>/{renders,gt}``, written to ``results.json`` and
``per_view.json``.

Counterpart of ``deblurgs_tpu/cli/metrics.py``, with the same flags plus
``--device`` (default ``cuda``)::

    python -m deblurgs_tpu_torch.cli.metrics -m MODEL [MODEL ...]
        [--lpips_weights W.npz] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def read_images_dir(path, device="cpu"):
    """Every image of ``path`` in name order as [H, W, 3] float32 tensors in
    [0, 1] on ``device``, and the names."""
    from PIL import Image

    names = sorted(os.listdir(path))
    imgs = [torch.as_tensor(np.asarray(Image.open(os.path.join(path, n)),
                                       dtype=np.float32)[..., :3] / 255.0, device=device)
            for n in names]
    return imgs, names


def evaluate_model_dir(model_path: str, lpips_weights: str | None = None, device="cuda"):
    from deblurgs_tpu_torch.device import resolve_device
    from deblurgs_tpu_torch.eval import metrics as m

    dev = resolve_device(device)
    lpips = m.LPIPS.from_file(lpips_weights, device=dev)
    if lpips is None:
        print("[metrics] no LPIPS weights available — reporting PSNR/SSIM only")
    test_dir = os.path.join(model_path, "test")
    full = {}
    for method in sorted(os.listdir(test_dir)):
        mdir = os.path.join(test_dir, method)
        renders, names = read_images_dir(os.path.join(mdir, "renders"), dev)
        gts, _ = read_images_dir(os.path.join(mdir, "gt"), dev)
        agg, per_view = m.evaluate_pairs(renders, gts, lpips)
        m.write_results(model_path, method, agg, per_view, names)
        print(f"{method}: PSNR={agg['PSNR']:.4f} SSIM={agg['SSIM']:.4f} LPIPS={agg['LPIPS']}")
        full[method] = agg
    return full


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    return {path: evaluate_model_dir(path, args.lpips_weights, args.device)
            for path in args.model_paths}


if __name__ == "__main__":
    main()
