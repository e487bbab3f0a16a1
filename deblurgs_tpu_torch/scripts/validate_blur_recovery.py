"""Motion-recovery validation on the port (the ``freeze_scene`` arm of
``scripts/validate_blur_recovery.py``).

Synthesises motion-blurred observations of a known Gaussian scene along
known per-image SE(3) camera sweeps, then trains only the camera curves
(the scene frozen at the truth; curves start at the nominal poses) with the
port's ``train_step`` and measures:

- curve recovery: the symmetric Chamfer distance between the learned and
  true trajectories' camera centres, each centred (and once more after a
  global Kabsch alignment); PASS needs it below 0.6× its value at the
  initial curves;
- sharp PSNR at the true mid-trajectory poses and at the learned curves'
  mid-exposure cameras, against the sharp truth, beside the blur floor
  (blurry observations against the sharp truth).

Only the flags that the recorded JAX run (``runs/r5_motion_recovery.json``)
sets are ported; only ``--freeze_scene`` is ported, and leaving it out
raises. Run (the recorded JAX run's settings)::

    python -m deblurgs_tpu_torch.scripts.validate_blur_recovery --freeze_scene \\
        --iters 3000 --size 128 --n_cams 8 --n_sub 21 --blur_scale 0.8 \\
        --curve_start 1 --batched --layout mixed --tile 32 --max_pairs 2097152 \\
        --true_scale 0.1 --gt_oversample 3 [--report out.json] [--device cuda]

The scene, the sweeps and every draw come from ``--seed`` (numpy and a
``torch.Generator``), so the scene is not the JAX run's own draw.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

N_GAUSS = 800        # foreground splats; a backdrop wall of ~N_GAUSS/2 more


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--n_cams", type=int, default=6)
    ap.add_argument("--n_sub", type=int, default=9)
    ap.add_argument("--blur_scale", type=float, default=0.12,
                    help="trajectory length (world units)")
    ap.add_argument("--freeze_scene", action="store_true",
                    help="train only the camera curves against the true scene")
    ap.add_argument("--curve_start", type=int, default=100)
    ap.add_argument("--report", type=str, default=None,
                    help="write a JSON result to this path")
    ap.add_argument("--batched", action="store_true",
                    help="render all sub-frames in one render_batch (mixed layout)")
    ap.add_argument("--layout", type=str, default="lockstep", choices=["lockstep", "mixed"])
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--max_pairs", type=int, default=1 << 17)
    ap.add_argument("--true_scale", type=float, default=0.035,
                    help="true-scene Gaussian scale (world units)")
    ap.add_argument("--gt_oversample", type=int, default=1,
                    help="synthesise the blurry GT from n_sub*K uniform trajectory samples")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if not args.freeze_scene:
        raise NotImplementedError("only the --freeze_scene arm of the validation is ported")
    return args


def _chamfer(a: np.ndarray, b: np.ndarray) -> float:
    d = np.linalg.norm(a[:, None] - b[None, :], axis=-1)
    return 0.5 * (float(np.mean(np.min(d, 1))) + float(np.mean(np.min(d, 0))))


def traj_error(motion, true_motion, mcfg, align_gauge=False) -> float:
    """Mean symmetric Chamfer distance between learned and true camera-centre
    sets (16 samples a curve), each centred; with ``align_gauge``, after one
    global Kabsch alignment of all learned centres onto the true ones. NaN
    for a non-finite curve."""
    from deblurgs_tpu_torch.models import motion as motion_lib

    n = motion.nu.shape[0]
    idx = torch.arange(n, device=motion.nu.device)
    ts = torch.linspace(0.0, 1.0, 16, device=motion.nu.device)[None].expand(n, 16)
    with torch.no_grad():
        c_l = motion_lib._sample_c2w(motion, idx, ts, mcfg)[1].double().cpu().numpy()
        c_t = motion_lib._sample_c2w(true_motion, idx, ts, mcfg)[1].double().cpu().numpy()
    if not np.isfinite(c_l).all():
        return float("nan")
    if align_gauge:
        A, B = c_l.reshape(-1, 3), c_t.reshape(-1, 3)
        mu_a, mu_b = A.mean(0), B.mean(0)
        U, _, Vt = np.linalg.svd((A - mu_a).T @ (B - mu_b))
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        c_l = c_l @ R.T + (mu_b - R @ mu_a)
    return float(np.mean([_chamfer(a - a.mean(0), b - b.mean(0)) for a, b in zip(c_l, c_t)]))


def main(argv=None) -> int:
    args = parse_args(argv)
    from deblurgs_tpu_torch.core import camera as cam_lib
    from deblurgs_tpu_torch.core import lie
    from deblurgs_tpu_torch.device import resolve_device
    from deblurgs_tpu_torch.models import gaussians as gm
    from deblurgs_tpu_torch.models import motion as motion_lib
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig, render
    from deblurgs_tpu_torch.train import step as step_lib
    from deblurgs_tpu_torch.train.config import OptimizationConfig
    from deblurgs_tpu_torch.train.losses import psnr

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)  # noqa: E731

    W = H = args.size
    fovx = 1.1
    cs = cam_lib.CameraStatic(width=W, height=H, tanfovx=math.tan(fovx / 2),
                              tanfovy=math.tan(fovx / 2))
    proj = cam_lib.get_projection_matrix(0.01, 100.0, fovx, fovx, device=dev)

    # ---- true scene: foreground splats + an opaque backdrop wall (the
    # random training backgrounds need every pixel covered)
    fg = rng.standard_normal((N_GAUSS, 3)) * 0.9
    side = int(math.ceil(math.sqrt(N_GAUSS // 2)))
    gx, gy = np.meshgrid(np.linspace(-4, 4, side), np.linspace(-4, 4, side))
    wall = np.stack([gx.ravel(), gy.ravel(), np.full(side * side, 2.5)], -1)
    pts = t(np.concatenate([fg, wall]))
    cols = t(rng.uniform(0.05, 0.95, (pts.shape[0], 3)))
    gcfg = gm.GaussianConfig(sh_degree=2)
    params, aux = gm.create_from_pcd(pts, cols, gcfg, pts.shape[0])
    # small hard splats: blur must be observable
    params = params._replace(
        opacity=torch.full_like(params.opacity, 0.9),
        scaling=torch.full_like(params.scaling,
                                float(gm.inverse_scaling(torch.tensor(args.true_scale), gcfg))))

    # ---- true per-image trajectories: nominal ring pose + an SE(3) sweep
    mcfg = motion_lib.MotionConfig(curve_order=9, n_subframes=args.n_sub)
    angs = [2 * math.pi * i / args.n_cams * 0.25 for i in range(args.n_cams)]
    rots = lie.so3_exp_map(t([[0.15 * math.sin(a), a, 0.0] for a in angs]))
    centers = rots @ t([0.0, 0.0, -4.0])
    true_motion = motion_lib.init_motion(rots, centers, mcfg, gen, init_noise=0.0).params()
    n_ctrl = mcfg.curve_order + 1
    sweep_dir = rng.standard_normal((args.n_cams, 1, 3))
    sweep_dir /= np.linalg.norm(sweep_dir, axis=-1, keepdims=True)
    tline = np.linspace(-0.5, 0.5, n_ctrl)[None, :, None]
    true_motion = true_motion._replace(
        trans_ctrl=true_motion.trans_ctrl + t(args.blur_scale * sweep_dir * tline),
        rot_ctrl=true_motion.rot_ctrl + t(0.04 * rng.standard_normal((args.n_cams, 1, 3))
                                          * tline))

    train_layout = "mixed" if args.batched else args.layout
    rcfg = RasterizeConfig(max_pairs=args.max_pairs, tile_w=args.tile, tile_h=args.tile,
                           layout=train_layout,
                           need_n_contrib=not (args.batched or args.layout == "mixed"))
    rcfg_eval = RasterizeConfig(max_pairs=min(args.max_pairs, 1 << 17), tile_w=args.tile,
                                tile_h=args.tile, layout=args.layout, need_n_contrib=False)
    eval_pairs = [0]

    def render_with(p, active, cam):
        rin = gm.render_inputs(p, gcfg)
        out = render(rin["means3d"], rin["scales"], rin["rotations"], rin["opacities"],
                     rin["shs"], cam, cs, torch.zeros(3, device=dev), cfg=rcfg_eval,
                     sh_degree=2, active=active)
        eval_pairs[0] = max(eval_pairs[0], int(out.num_pairs))
        return out.image

    def one(cams, i):
        return type(cams)(*(x[i] for x in cams))

    # ---- blurry GT (mean of uniform sub-frame renders) + sharp mid-pose GT
    print("synthesizing ground truth...")
    n_gt = args.n_sub * args.gt_oversample
    nu = torch.linspace(0.0, 1.0, n_gt, device=dev)
    blur_gts, sharp_gts, mid_cams = [], [], []
    with torch.no_grad():
        for i in range(args.n_cams):
            cams = motion_lib.subframe_cameras_batch(true_motion, [i], nu[None], proj, mcfg)
            blur_gts.append(torch.stack([render_with(params, aux.active, one(cams, s))
                                         for s in range(n_gt)]).mean(0))
            mid_cams.append(one(cams, n_gt // 2))
            sharp_gts.append(render_with(params, aux.active, mid_cams[-1]))
    blur_gts, sharp_gts = torch.stack(blur_gts), torch.stack(sharp_gts)
    clip = lambda x: torch.clamp(x, 0, 1)   # noqa: E731
    blur_floor = float(np.mean([float(psnr(clip(b), clip(s)))
                                for b, s in zip(blur_gts, sharp_gts)]))
    print(f"  synthesis done; blur-vs-sharp floor {blur_floor:.2f} dB", flush=True)

    # ---- model init: the true (frozen) scene, curves at the nominal poses
    motion0 = motion_lib.init_motion(rots, centers, mcfg, gen, init_noise=0.001).params()
    zero_lr = dict(position_lr_init=0.0, position_lr_final=0.0, feature_lr=0.0,
                   opacity_lr=0.0, scaling_lr=0.0, rotation_lr=0.0, lambda_hinge=0.0)
    ocfg = OptimizationConfig(
        iterations=args.iters, curve_start_iter=args.curve_start,
        curve_end_iter=args.iters + 1, densify_from_iter=10**9,
        densification_interval=200, densify_until_iter=int(args.iters * 0.7),
        opacity_reset_interval=10_000_000, curve_controlpoints_lr=1e-2,
        curve_rotation_lr=1e-3, curve_lr_half_iter=max(int(args.iters * 0.1), 1),
        curve_alignment_lr=0.0, curve_alignment_start=0, clip_grad=-1.0, **zero_lr)
    state = step_lib.init_state(params, motion0, aux)

    def sharp_psnr(st) -> float:
        with torch.no_grad():
            return float(np.mean([float(psnr(clip(render_with(st.params, st.aux.active,
                                                              mid_cams[i])), clip(sharp_gts[i])))
                                  for i in range(args.n_cams)]))

    def sharp_mid_psnr(st) -> float:
        """Mid-exposure (ν = 0.5) camera of the learned curve against the
        sharp truth (the reference's render_trainview protocol)."""
        vals = []
        with torch.no_grad():
            for i in range(args.n_cams):
                cams = motion_lib.subframe_cameras_batch(
                    st.motion, [i], torch.full((1, 1), 0.5, device=dev), proj, mcfg)
                img = render_with(st.params, st.aux.active, one(cams, 0))
                vals.append(float(psnr(clip(img), clip(sharp_gts[i]))))
        return float(np.mean(vals))

    print(f"sharp PSNR at init: {sharp_psnr(state):.2f} dB")
    step_cache = {}

    def get_statics(sh_degree, n_sub):
        if (sh_degree, n_sub) not in step_cache:
            step_cache[sh_degree, n_sub] = step_lib.TrainStatics(
                gcfg=gcfg, mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, cs=cs, sh_degree=sh_degree,
                n_sub=n_sub, tone_mapping="identity", spatial_lr_scale=2.0,
                batched_render=args.batched)
        return step_cache[sh_degree, n_sub]

    nan_at = None
    t0 = time.time()
    for it in range(1, args.iters + 1):
        st = get_statics(min(it // 1000, gcfg.sh_degree),
                         args.n_sub if it >= ocfg.curve_start_iter else 1)
        idx = (it - 1) % args.n_cams
        state, metrics = step_lib.train_step(state, blur_gts[idx], idx, proj, st,
                                             generator=gen)
        if it % 200 == 0 or it == args.iters:
            finite = all(bool(torch.isfinite(x).all())
                         for x in tuple(state.params) + tuple(state.motion))
            if not math.isfinite(float(metrics.loss)) or not finite:
                nan_at = it
                print(f"!! non-finite loss/params at the it={it} check; aborting", flush=True)
                break
            print(f"it {it}: blur-l1={float(metrics.l1):.4f} "
                  f"psnr(blur)={float(metrics.psnr):.2f} sharp-psnr={sharp_psnr(state):.2f} "
                  f"sharp-mid={sharp_mid_psnr(state):.2f} "
                  f"curve-trans-err={traj_error(state.motion, true_motion, mcfg):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    train_s = time.time() - t0

    final_sharp, final_mid = sharp_psnr(state), sharp_mid_psnr(state)
    tr_err = traj_error(state.motion, true_motion, mcfg)
    tr_err_al = traj_error(state.motion, true_motion, mcfg, align_gauge=True)
    init_err = traj_error(motion0, true_motion, mcfg)
    init_err_al = traj_error(motion0, true_motion, mcfg, align_gauge=True)
    n_overflow = int(state.overflow_count)
    print(f"\nFINAL: sharp PSNR {final_sharp:.2f} dB (learned-mid-cam {final_mid:.2f} dB); "
          f"curve translation error {tr_err:.4f} (init {init_err:.4f}); gauge-aligned "
          f"{tr_err_al:.4f} (init {init_err_al:.4f}); overflowed steps {n_overflow}")
    ok = nan_at is None and tr_err < 0.6 * init_err
    result = {
        "sharp_psnr": final_sharp, "sharp_psnr_midcam": final_mid, "traj_err": tr_err,
        "traj_err_init": init_err, "traj_err_aligned": tr_err_al,
        "traj_err_aligned_init": init_err_al, "overflow_steps": n_overflow,
        "eval_max_num_pairs": eval_pairs[0], "eval_max_pairs": rcfg_eval.max_pairs,
        "blur_floor_psnr": blur_floor, "final_points": int(state.aux.active.sum()),
        "nan_at": nan_at, "train_s": train_s, "passed": ok, "args": vars(args)}
    if args.report:
        with open(args.report, "w") as fp:
            json.dump({k: (None if isinstance(v, float) and not math.isfinite(v) else v)
                       for k, v in result.items()}, fp)
    print("VALIDATION", "PASSED" if ok else "FAILED")
    print(json.dumps({k: v for k, v in result.items() if k != "args"}), flush=True)
    return 0 if ok else (2 if nan_at is not None else 1)


if __name__ == "__main__":
    sys.exit(main())
