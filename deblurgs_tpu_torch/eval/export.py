"""Render-path construction and image/video export (reference
``utils/export_utils.py``, ``utils/mvg_utils.py``).

Counterpart of ``deblurgs_tpu/eval/export.py``: the spiral camera path
around the mean trained pose with its look-at from the rendered centre
depth, depth colourisation, video writing and ``to_uint8``. The colour
maps are matplotlib's "jet" and "jet_r" rebuilt from their segment data
(:func:`colormap`), so exporting needs no matplotlib; ``make_video``
writes through ``imageio`` where it is installed and through PIL where it
is not.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from deblurgs_tpu_torch.core.camera import c2w_to_view, make_camera_arrays
from deblurgs_tpu_torch.models import motion as motion_lib

# matplotlib's _cm._jet_data: per channel, (x, value below x, value above x)
_JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
_LUT_N = 256


def _segment_lut(data) -> np.ndarray:
    """matplotlib's ``_create_lookup_table`` (N = 256, gamma 1)."""
    adata = np.asarray(data, np.float64)
    x, y0, y1 = adata[:, 0] * (_LUT_N - 1), adata[:, 1], adata[:, 2]
    xind = (_LUT_N - 1) * np.linspace(0, 1, _LUT_N)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def colormap(name: str, x: np.ndarray) -> np.ndarray:
    """RGB in [0, 1] of matplotlib's ``colormaps[name](x)[..., :3]`` for
    ``name`` "jet" or "jet_r" and ``x`` in [0, 1]: the same table (jet_r
    from the reversed segments, as matplotlib builds it) and the same
    float-to-index rounding."""
    if name not in ("jet", "jet_r"):
        raise ValueError(f"unknown colour map {name!r} (expected 'jet' or 'jet_r')")
    segments = {c: _JET[c] if name == "jet" else
                [(1.0 - xs, y1, y0) for xs, y0, y1 in reversed(_JET[c])] for c in _JET}
    lut = np.stack([_segment_lut(segments[c]) for c in ("red", "green", "blue")], -1)
    xa = np.array(x, copy=True)
    xa *= _LUT_N
    xa[xa == _LUT_N] = _LUT_N - 1
    return lut[np.clip(xa, 0, _LUT_N - 1).astype(int)]


def mean_camera_pose(c2ws: np.ndarray) -> np.ndarray:
    """Mean SE(3) pose: mean translation + chordal-mean rotation
    (reference ``mvg_utils.mean_camera_pose``)."""
    from scipy.spatial.transform import Rotation

    mean = np.eye(4)
    mean[:3, 3] = c2ws[:, :3, 3].mean(axis=0)
    mean[:3, :3] = Rotation.from_matrix(c2ws[:, :3, :3]).mean().as_matrix()
    return mean


def c2w_from_eye(eye, lookat, up) -> np.ndarray:
    """The c2w matrix of a camera at ``eye`` looking at ``lookat`` (reference
    ``mvg_utils.get_c2w_from_eye``)."""
    z = lookat - eye
    x = np.cross(up, z)
    y = np.cross(z, x)
    x, y, z = (v / np.linalg.norm(v) for v in (x, y, z))
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([x, y, z], axis=0).T
    c2w[:3, 3] = eye
    return c2w


def middle_c2ws(session) -> np.ndarray:
    """c2w matrices of the per-image mid-trajectory sharp cameras."""
    model = motion_lib.MotionModel(session.mcfg, **session.motion._asdict())
    proj = torch.as_tensor(session.scene.proj, device=session.device)
    with torch.no_grad():
        cams = motion_lib.middle_cameras(model, proj)
    view = cams.view.cpu().numpy()            # [n, 4, 4] row-vector convention
    c2ws = np.tile(np.eye(4), (view.shape[0], 1, 1))
    c2ws[:, :3, :3] = view[:, :3, :3]         # c2w rotation (column convention)
    c2ws[:, :3, 3] = cams.campos.cpu().numpy()
    return c2ws


def _camera(session, rot: np.ndarray, center: np.ndarray):
    dev = session.device
    view = c2w_to_view(torch.as_tensor(rot, dtype=torch.float32, device=dev),
                       torch.as_tensor(center, dtype=torch.float32, device=dev))
    return make_camera_arrays(view, torch.as_tensor(session.scene.proj, device=dev))


def spiral_path(session, spin_angle=5.0, n_frames=50, spin_for=2) -> list:
    """Spiral render path (reference ``export_utils.get_render_path``):
    pivot = mean mid-trajectory pose; look-at from the mean centre-crop
    depth of the pivot render; a growing-radius circle about the view
    vector. Returns a list of CameraArrays."""
    from deblurgs_tpu_torch.eval.session import render_view

    spin_angle = spin_angle * np.pi / 180.0
    pivot = mean_camera_pose(middle_c2ws(session))
    up = pivot[:3, 1]
    eye = pivot[:3, 3]
    _, depth = render_view(session, _camera(session, pivot[:3, :3], eye), tone_map=False)
    H, W = depth.shape
    lookat_z = float(torch.mean(depth[H // 4:H * 3 // 4, W // 4:W * 3 // 4]))
    lookat = eye + lookat_z * pivot[:3, 2]

    r_max = math.tan(spin_angle) * np.linalg.norm(eye - lookat)
    total = n_frames * spin_for
    radius = np.linspace(r_max / spin_for, r_max, total)
    theta = np.tile(np.linspace(0.0, 2 * np.pi, n_frames), spin_for)
    coords = np.stack([np.cos(theta) * radius, np.sin(theta) * radius,
                       np.zeros(total), np.ones(total)], axis=0)
    eyes = (pivot @ coords).T[:, :3]
    cams = []
    for e in eyes:
        c2w = c2w_from_eye(e, lookat, up)
        cams.append(_camera(session, c2w[:3, :3], c2w[:3, 3]))
    return cams


def depth_colorize(depths: np.ndarray, z_near=0.01, z_far=100.0,
                   clip_percentage=1.0) -> np.ndarray:
    """jet_r depth colour map (reference ``export_utils.depth_colorize``)."""
    z_near = max(z_near, float(depths.min()))
    flat = np.sort(depths.reshape(-1))
    z_far = min(z_far, float(depths.max()), float(flat[int((flat.size - 1) * clip_percentage)]))
    d = np.clip((depths - z_near) / max(z_far - z_near, 1e-9), 0.0, 1.0)
    return (colormap("jet_r", d) * 255).astype(np.uint8)


def _gif_frame(frame: np.ndarray):
    """A PIL palette image of an RGB uint8 frame: its own colours exactly
    when it has at most 256 of them, else a fast octree quantization (PIL's
    default median cut takes seconds a 1080p frame)."""
    from PIL import Image

    im = Image.fromarray(frame)
    colors = im.getcolors(256)
    if colors is None:
        return im.quantize(method=Image.Quantize.FASTOCTREE)
    flat = [c for _, rgb in colors for c in rgb]
    palette = Image.new("P", (1, 1))
    palette.putpalette(flat + flat[:3] * (256 - len(colors)))
    return im.quantize(palette=palette, dither=Image.Dither.NONE)


def make_video(imgs, path, fps=32) -> str:
    """mp4 through imageio when it and ffmpeg are available, else an animated
    gif at the same stem (reference ``export_utils.make_video``), written
    with PIL. Returns the path written."""
    frames = [np.asarray(img) for img in imgs]
    try:
        import imageio

        writer = imageio.get_writer(path, fps=fps)
        for frame in frames:
            writer.append_data(frame)
        writer.close()
        return path
    except (ImportError, RuntimeError, ValueError, OSError):
        pass
    alt = os.path.splitext(path)[0] + ".gif"
    pil = [_gif_frame(frame) for frame in frames]
    pil[0].save(alt, save_all=True, append_images=pil[1:], duration=1000.0 / fps, loop=0)
    print(f"[video] no mp4 writer; wrote {alt}")
    return alt


def to_uint8(img) -> np.ndarray:
    """[H, W, 3] in [0, 1] (array or tensor) → uint8 (truncating, as the
    JAX package does)."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)
