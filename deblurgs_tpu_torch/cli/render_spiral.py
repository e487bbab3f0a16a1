"""Spiral novel-view video export (reference ``render_spiral.py``).

Counterpart of ``deblurgs_tpu/cli/render_spiral.py``, with the same flags
plus ``--device`` (default ``cuda``)::

    python -m deblurgs_tpu_torch.cli.render_spiral -m MODEL [-s SOURCE]
        [--iteration I] [--n_frames 50] [-r R] [--backend pallas]
        [--device cuda|cpu]

Writes ``spiral/iteration_<it>/spiral_{rgb,depth}.mp4`` (``.gif`` where no
mp4 writer exists).
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser


def render_sets(model_path: str, source_path: str | None = None, load_iteration: int = -1,
                n_frames: int = 50, resolution: int | None = None, backend: str | None = None,
                device="cuda"):
    from deblurgs_tpu_torch.eval import export
    from deblurgs_tpu_torch.eval.session import load_session, render_view

    session = load_session(model_path, source_path, load_iteration=load_iteration,
                           resolution=resolution, backend=backend, device=device)
    cams = export.spiral_path(session, n_frames=n_frames)
    frames, depth_frames = [], []
    for i, cam in enumerate(cams):
        img, depth = render_view(session, cam)
        frames.append(export.to_uint8(img))
        depth_frames.append(export.depth_colorize(depth.cpu().numpy()[None])[0])
        if i % 10 == 0:
            print(f"spiral {i + 1}/{len(cams)}")

    out_dir = os.path.join(model_path, "spiral", f"iteration_{session.iteration}")
    os.makedirs(out_dir, exist_ok=True)
    export.make_video(frames, os.path.join(out_dir, "spiral_rgb.mp4"))
    export.make_video(depth_frames, os.path.join(out_dir, "spiral_depth.mp4"))
    print(f"wrote {out_dir}")
    return out_dir


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--source_path", "-s", type=str, default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--n_frames", type=int, default=50)
    parser.add_argument("--resolution", "-r", type=int, default=None)
    parser.add_argument("--backend", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    return render_sets(args.model_path, args.source_path, args.iteration, args.n_frames,
                       args.resolution, args.backend, args.device)


if __name__ == "__main__":
    main()
