"""Sharp train-view vs ground-truth side-by-side export (reference
``render_trainview.py``): each image's mid-trajectory (deblurred) camera
rendered next to its blurry ground truth.

Counterpart of ``deblurgs_tpu/cli/render_trainview.py``, with the same
flags plus ``--device`` (default ``cuda``)::

    python -m deblurgs_tpu_torch.cli.render_trainview -m MODEL [-s SOURCE]
        [--iteration I] [-r R] [--backend pallas] [--device cuda|cpu]

Writes ``trainview/iteration_<it>/NNN.png`` (through PIL) and
``trainview.mp4`` (``.gif`` where no mp4 writer exists).
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def render_sets(model_path: str, source_path: str | None = None, load_iteration: int = -1,
                resolution: int | None = None, backend: str | None = None, device="cuda"):
    from PIL import Image

    from deblurgs_tpu_torch.eval import export
    from deblurgs_tpu_torch.eval.session import load_session, render_view
    from deblurgs_tpu_torch.models import motion as motion_lib

    session = load_session(model_path, source_path, load_iteration=load_iteration,
                           resolution=resolution, backend=backend, device=device)
    model = motion_lib.MotionModel(session.mcfg, **session.motion._asdict())
    with torch.no_grad():
        cams = motion_lib.middle_cameras(
            model, torch.as_tensor(session.scene.proj, device=session.device))
    out_dir = os.path.join(model_path, "trainview", f"iteration_{session.iteration}")
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for i in range(session.scene.num_train):
        img, _ = render_view(session, type(cams)(*(leaf[i] for leaf in cams)))
        side = np.concatenate([export.to_uint8(img),
                               export.to_uint8(session.scene.train_images[i])], axis=1)
        frames.append(side)
        Image.fromarray(side).save(os.path.join(out_dir, f"{i:03d}.png"))
    export.make_video(frames, os.path.join(out_dir, "trainview.mp4"), fps=8)
    print(f"wrote {out_dir}")
    return out_dir


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--source_path", "-s", type=str, default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--resolution", "-r", type=int, default=None)
    parser.add_argument("--backend", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    return render_sets(args.model_path, args.source_path, args.iteration, args.resolution,
                       args.backend, args.device)


if __name__ == "__main__":
    main()
