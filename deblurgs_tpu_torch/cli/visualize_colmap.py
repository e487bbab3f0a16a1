"""Sparse-model visualization — reference ``scripts/colmap_visualization.py``.

Counterpart of ``deblurgs_tpu/cli/visualize_colmap.py``::

    python -m deblurgs_tpu_torch.cli.visualize_colmap --path WORKSPACE [--out PNG]

The reference renders the reconstruction with open3d; the JAX package
draws a matplotlib 3-D scatter. The port draws with PIL (no matplotlib
needed): three orthographic views (x-y, x-z, z-y) of the point cloud in
its colours with the camera centres as red squares, side by side, and
writes the points as a PLY (``sparse_viz.ply``) as JAX's does.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np


def _draw_views(path: str, xyz: np.ndarray, rgb: np.ndarray, centers: np.ndarray,
                size: int = 400) -> None:
    """Three orthographic scatters (x-y, x-z, z-y) side by side, in a
    shared box around the points and cameras."""
    from PIL import Image, ImageDraw

    step = max(len(xyz) // 20000, 1)
    pts, cols = xyz[::step], rgb[::step]
    both = np.concatenate([pts, centers]) if len(centers) else pts
    lo, hi = both.min(axis=0), both.max(axis=0)
    scale = (size - 20) / max(float(np.max(hi - lo)), 1e-9)
    img = Image.new("RGB", (3 * size, size), "white")
    draw = ImageDraw.Draw(img)
    for panel, (a, b) in enumerate(((0, 1), (0, 2), (2, 1))):
        to_px = lambda p: (panel * size + 10 + (p[:, a] - lo[a]) * scale,  # noqa: E731
                           size - 10 - (p[:, b] - lo[b]) * scale)
        for x, y, c in zip(*to_px(pts), cols):
            draw.point((float(x), float(y)), fill=tuple(int(v) for v in c))
        if len(centers):
            for x, y in zip(*to_px(centers)):
                draw.rectangle((x - 3, y - 3, x + 3, y + 3), outline=(255, 0, 0))
    img.save(path)


def visualize(workspace: str, out_path: str | None = None):
    from deblurgs_tpu_torch.data import colmap, ply

    sparse = colmap.detect_sparse_dir(workspace) or workspace
    try:
        xyz, rgb, _ = colmap.read_points3d_binary(
            os.path.join(sparse, "points3D.bin"))
    except FileNotFoundError:
        xyz, rgb, _ = colmap.read_points3d_text(
            os.path.join(sparse, "points3D.txt"))
    try:
        images = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        images = colmap.read_images_text(os.path.join(sparse, "images.txt"))

    centers = []
    for img in images.values():
        R = colmap.qvec2rotmat(img.qvec)
        centers.append(-R.T @ np.asarray(img.tvec))
    centers = np.stack(centers) if centers else np.zeros((0, 3))

    out_path = out_path or os.path.join(workspace, "sparse_viz.png")
    _draw_views(out_path, xyz, rgb, centers)
    ply.store_point_cloud(os.path.join(workspace, "sparse_viz.ply"), xyz, rgb)
    print(f"wrote {out_path}")
    return out_path


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--path", type=str, required=True)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    return visualize(args.path, args.out)


if __name__ == "__main__":
    main()
