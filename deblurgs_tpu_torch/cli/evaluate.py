"""Held-out evaluation (reference ``test.py:401-439``).

Counterpart of ``deblurgs_tpu/cli/evaluate.py``, with the same flags plus
``--device`` (default ``cuda``)::

    python -m deblurgs_tpu_torch.cli.evaluate -m MODEL [-s SOURCE] [-r 1]
        [--backend pallas] [--num_iter_per_view N] [--skip_pose_opt]
        [--lpips_weights W.npz] [--iteration I] [--device cuda|cpu]

Load the trained session → score the held-out views at their raw poses
("unfit") → iNeRF pose refinement (``eval/pose_opt.py``) → score again
("fit") → ``eval.txt``. Writes ``test/{unfit,fit}/{renders,gt,error}/NNN.png``
(PNG through PIL; the error map is the mean absolute error ×4 through the
"jet" colour map). The ground truth loads at ``-r`` (default -1: images
wider than 1,600 px are downscaled), the session's renders at the run's
``cfg_args`` resolution unless ``-r`` is given, as in the JAX package. A
run without a held-out split registers ``<source>/test_images`` with
COLMAP against sharp renders of the training views
(``tools/colmap_pipeline.py::initialize_test_pose``); where that cannot
be done (no ``colmap`` binary, no test images, nothing registered) it
prints why and returns None, as JAX's does.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def _write_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def evaluate_session(session, pose_params, gts: torch.Tensor, proj: torch.Tensor,
                     out_dir: str | None = None, lpips=None):
    """Render every held-out view at ``pose_params``, write its PNGs under
    ``out_dir`` and score it: (aggregate, per view)."""
    from deblurgs_tpu_torch.eval import export
    from deblurgs_tpu_torch.eval import metrics as m
    from deblurgs_tpu_torch.eval.pose_opt import pose_to_camera
    from deblurgs_tpu_torch.eval.session import render_view

    renders = []
    for i in range(pose_params.quat.shape[0]):
        img, _ = render_view(session, pose_to_camera(pose_params, i, proj))
        renders.append(img)
        if out_dir:
            _write_png(os.path.join(out_dir, "renders", f"{i:03d}.png"), export.to_uint8(img))
            _write_png(os.path.join(out_dir, "gt", f"{i:03d}.png"), export.to_uint8(gts[i]))
            err = torch.abs(img - gts[i]).mean(-1).cpu().numpy()
            _write_png(os.path.join(out_dir, "error", f"{i:03d}.png"),
                       (export.colormap("jet", np.clip(err * 4, 0, 1)) * 255).astype(np.uint8))
    return m.evaluate_pairs(renders, list(gts), lpips)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--source_path", "-s", type=str, default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--num_iter_per_view", type=int, default=2000)
    parser.add_argument("--skip_pose_opt", action="store_true")
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--backend", type=str, default=None)
    parser.add_argument("--resolution", "-r", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    from deblurgs_tpu_torch.data.scene import load_image
    from deblurgs_tpu_torch.eval import metrics as m
    from deblurgs_tpu_torch.eval.pose_opt import init_pose_params, optimize_test_poses
    from deblurgs_tpu_torch.eval.session import load_session

    session = load_session(args.model_path, args.source_path, load_iteration=args.iteration,
                           resolution=args.resolution, backend=args.backend,
                           device=args.device)
    dev = session.device
    test_infos = session.scene.info.test_cameras
    if not test_infos:
        # no held-out split: try COLMAP registration of test_images/
        from deblurgs_tpu_torch.tools.colmap_pipeline import initialize_test_pose

        try:
            test_infos = initialize_test_pose(session, args.model_path, args.source_path)
        except RuntimeError as e:
            print(f"cannot register test poses: {e}")
            test_infos = []
        if not test_infos:
            print("no test cameras available — nothing to evaluate")
            return None

    gts = torch.as_tensor(np.stack([
        load_image(c, args.resolution if args.resolution is not None else -1)
        for c in test_infos]), device=dev)
    rotations = torch.as_tensor(np.stack([c.R for c in test_infos]), dtype=torch.float32,
                                device=dev)
    translations = torch.as_tensor(np.stack([c.T for c in test_infos]), dtype=torch.float32,
                                   device=dev)
    proj = torch.as_tensor(session.scene.proj, device=dev)
    lpips = m.LPIPS.from_file(args.lpips_weights, device=dev)

    pose = init_pose_params(rotations, translations)
    agg_unfit, _ = evaluate_session(session, pose, gts, proj,
                                    out_dir=os.path.join(args.model_path, "test", "unfit"),
                                    lpips=lpips)
    print(f"[unfit] {agg_unfit}")
    results = {"unfit": agg_unfit}
    if not args.skip_pose_opt:
        pose = optimize_test_poses(session, gts, rotations, translations, proj,
                                   num_iter_per_view=args.num_iter_per_view)
        agg_fit, _ = evaluate_session(session, pose, gts, proj,
                                      out_dir=os.path.join(args.model_path, "test", "fit"),
                                      lpips=lpips)
        print(f"[fit]   {agg_fit}")
        results["fit"] = agg_fit

    with open(os.path.join(args.model_path, "eval.txt"), "w") as f:
        for k, v in results.items():
            print(f"{k}: PSNR={v['PSNR']:.4f} SSIM={v['SSIM']:.4f} LPIPS={v['LPIPS']}", file=f)
    return results


if __name__ == "__main__":
    main()
