"""Training CLI (reference ``train.py`` entry point).

Counterpart of ``deblurgs_tpu/cli/train.py``, with the same flags plus
``--device`` (default ``cuda``; ``cpu`` runs every kernel's plain PyTorch
version)::

    python -m deblurgs_tpu_torch.cli.train -s DATASET -m OUTPUT [flags]
        [--device cuda|cpu]

At the end of a run it spawns ``render_spiral`` and ``render_trainview`` of
this package on the same device (``--skip_final_render`` skips them); a
child's non-zero exit raises.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
from argparse import ArgumentParser


def do_system(cmd: str):
    """Run a shell command; raise if it exits non-zero (reference
    ``utils/system_utils.py:31-36``, raising instead of exiting)."""
    print(f"==== running: {cmd}")
    err = subprocess.call(cmd, shell=True)
    if err:
        raise RuntimeError(f"command failed with code {err}: {cmd}")


def build_configs(lp, op):
    """CLI namespaces → the port's config dataclasses."""
    from deblurgs_tpu_torch.models.gaussians import GaussianConfig
    from deblurgs_tpu_torch.models.motion import MotionConfig
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
    from deblurgs_tpu_torch.train.config import OptimizationConfig

    gcfg = GaussianConfig(
        sh_degree=lp.sh_degree, alpha_lower_bound=lp.alpha_lower_bound,
        scale_lb=lp.scale_lb, scale_ub=lp.scale_ub, use_isotropic=lp.use_isotrophic,
        use_sigmoid=lp.activation == "sigmoid", z_near=lp.z_near, z_far=lp.z_far)
    mcfg = MotionConfig(curve_order=lp.curve_order, n_subframes=lp.num_subframes,
                        curve_type=lp.curve_type, curve_random_sample=lp.curve_random_sample)
    ocfg = OptimizationConfig(**{k: getattr(op, k) for k in vars(OptimizationConfig())})
    rcfg = RasterizeConfig(
        tile_w=lp.tile, tile_h=lp.tile, max_pairs=lp.max_pairs, backend=lp.backend,
        cull_z=lp.z_near, z_far=lp.z_far, use_sigmoid=lp.activation == "sigmoid",
        need_n_contrib=False,  # diagnostic-only output; skip in training
        window=lp.window, layout=lp.kernel_layout, tile_cull=lp.tile_cull,
        tight_rect=lp.tight_rect,
        fast=(lp.fast and lp.backend == "pallas" and lp.kernel_layout == "mixed"
              and not getattr(lp, "need_n_contrib", False)))
    return gcfg, mcfg, ocfg, rcfg


def main(argv=None):
    from deblurgs_tpu_torch.cli.args import ModelParams, OptimizationParams, write_run_config
    from deblurgs_tpu_torch.device import resolve_device

    parser = ArgumentParser(description="DeblurGS training (PyTorch/CUDA)")
    lp = ModelParams(parser)
    op = OptimizationParams(parser)
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[50_000, 100_000, 150_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--render_iterations", nargs="+", type=int,
                        default=[25_000, 50_000, 75_000, 100_000, 125_000, 150_000])
    parser.add_argument("--disable_curve_visualize", action="store_true",
                        help="skip the overview-shot visualizer (training.mp4)")
    parser.add_argument("--vis_cam_idx", type=int, default=None,
                        help="focus the overview on this camera's pose instead of the "
                             "auto zoom-out search")
    parser.add_argument("--load_camera_motion_path", type=str, default=None)
    parser.add_argument("--load_path", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--debug", action="store_true",
                        help="NaN guard: dump a full state snapshot and abort on a "
                             "non-finite loss")
    parser.add_argument("--skip_final_render", action="store_true",
                        help="skip the post-training spiral/trainview render processes")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda, or cpu for the plain "
                             "PyTorch versions of the kernels)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    args.save_iterations.append(args.iterations)
    dev = resolve_device(args.device)

    print("Optimizing " + args.model_path)
    write_run_config(args, args.model_path)

    lpe = lp.extract(args)
    ope = op.extract(args)
    gcfg, mcfg, ocfg, rcfg = build_configs(lpe, ope)

    from deblurgs_tpu_torch.data.scene import Scene
    from deblurgs_tpu_torch.train.loop import Trainer

    scene = Scene(
        lpe.source_path, lpe.model_path, images=lpe.images, resolution=lpe.resolution,
        eval_split=lpe.eval, llffhold=lpe.llffhold, num_initial_pcd=lpe.num_initial_pcd,
        random_init=lpe.random_init, white_background=lpe.white_background,
        z_near=lpe.z_near, z_far=lpe.z_far, use_sigmoid=lpe.activation == "sigmoid",
        seed=args.seed)
    trainer = Trainer(
        scene=scene, gcfg=gcfg, mcfg=mcfg, ocfg=ocfg, rcfg=rcfg,
        tone_mapping=lpe.tone_mapping_type, model_path=lpe.model_path,
        save_iterations=tuple(args.save_iterations),
        checkpoint_iterations=tuple(args.checkpoint_iterations),
        render_iterations=tuple(args.render_iterations),
        visualize=not args.disable_curve_visualize, vis_cam_idx=args.vis_cam_idx,
        debug=args.debug, batched_render=lpe.batched_render,
        cams_per_step=lpe.cams_per_step, device=dev, seed=args.seed)
    state, first_iter = trainer.init_state(
        load_path=args.load_path, load_motion_path=args.load_camera_motion_path,
        start_checkpoint=args.start_checkpoint)
    state = trainer.train(state, first_iter)
    trainer.save_snapshot(state, ocfg.iterations)
    print("\nTraining complete.")

    # post-training novel-view + sharp-trainview exports (reference
    # train.py:230-233 spawns both render scripts at the end of every run),
    # on this run's device
    if not args.skip_final_render:
        # the child resolves `-m deblurgs_tpu_torch.cli.*` through sys.path,
        # which lacks this package's root when the caller started elsewhere
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        prev_pp = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = pkg_root if not prev_pp else pkg_root + os.pathsep + prev_pp
        for rendercode in ("render_spiral", "render_trainview"):
            # tone mapping / SH degree / activation come back through the
            # persisted cfg_args, so only the paths and the device are passed
            do_system(f"{shlex.quote(sys.executable)} -m deblurgs_tpu_torch.cli.{rendercode} "
                      f"--model_path {shlex.quote(lpe.model_path)} "
                      f"--source_path {shlex.quote(lpe.source_path)} "
                      f"--resolution {lpe.resolution} --device {dev}")
    return state


if __name__ == "__main__":
    main()
