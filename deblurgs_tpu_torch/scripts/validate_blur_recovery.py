"""End-to-end DeblurGS validation on the port (counterpart of
``scripts/validate_blur_recovery.py``, every arm and flag).

Synthesises motion-blurred observations of a known Gaussian scene along
known per-image SE(3) camera sweeps, then trains with the port's
``train_step`` and measures:

- sharp PSNR at the true mid-trajectory poses, at the learned curves'
  mid-exposure cameras and (``--pose_refine_iters``) after refining each
  view's pose photometrically from its learned mid-exposure camera, against
  the sharp truth, beside the blur floor (blurry observations against the
  sharp truth);
- curve recovery: the symmetric Chamfer distance between the learned and
  true trajectories' camera centres, each centred (and once more after a
  global Kabsch alignment of all learned centres onto the true ones).

Arms: the joint problem (the default: noisy points at ``--capacity_mult``
× capacity with densification, curves from the nominal poses);
``--freeze_scene`` (only the curves train, against the true scene; PASS
needs the trajectory error below 0.6× its initial value); ``--no_curve``
(a sharp 3DGS fit to the blurry photos, the baseline); ``--init_true_curves
--curve_lr_mult 0`` (curves frozen at the truth, the ceiling). The joint
arms PASS on the best of the three sharp PSNRs: against
``--baseline_sharp`` + 3 dB with the aligned trajectory error at most its
initial value, else against 24 dB. Exit code 0 on PASS, 1 on FAIL, 2 when
the state turned non-finite (the state is dumped beside the report).

The flags are JAX's, except ``--device`` (default ``cuda``) where JAX has
``--platform``; ``--window`` and ``--chunk`` are accepted and do nothing.
Every random draw comes from ``--seed`` through :func:`make_draws` (numpy),
so the scene is not the JAX run's own draw; a caller may pass JAX's draws
to :func:`main`. The r5 calibration arms::

    python -m deblurgs_tpu_torch.scripts.validate_blur_recovery --no_curve \\
        --size 256 --n_cams 12 --n_sub 21 --iters 12000 --blur_scale 0.8 \\
        --true_scale 0.05 --texture checker --checker_cell 0.5 \\
        --max_pairs 2097152 --tile 32 --layout mixed --capacity_mult 8 \\
        --pose_refine_iters 300 --report nocurve.json

(``scripts/recovery_protocol.py`` runs all three arms and their checks.)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from deblurgs_tpu_torch.core import camera as cam_lib
from deblurgs_tpu_torch.core import lie
from deblurgs_tpu_torch.core import transforms as tfm
from deblurgs_tpu_torch.device import resolve_device
from deblurgs_tpu_torch.models import gaussians as gm
from deblurgs_tpu_torch.models import motion as motion_lib
from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig, render
from deblurgs_tpu_torch.train import checkpoint as ckpt_lib
from deblurgs_tpu_torch.train import optim as optim_lib
from deblurgs_tpu_torch.train import step as step_lib
from deblurgs_tpu_torch.train.config import OptimizationConfig
from deblurgs_tpu_torch.train.losses import psnr


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--backend", type=str, default="pallas",
                    choices=["pallas", "xla", "oracle"])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--n_gauss", type=int, default=800)
    ap.add_argument("--n_cams", type=int, default=6)
    ap.add_argument("--n_sub", type=int, default=9)
    ap.add_argument("--blur_scale", type=float, default=0.12,
                    help="trajectory length (world units)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--freeze_scene", action="store_true",
                    help="train only the camera curves against the true scene")
    ap.add_argument("--no_densify", action="store_true")
    ap.add_argument("--no_curve", action="store_true",
                    help="blurry-fit baseline: never enable the camera curve")
    ap.add_argument("--curve_start", type=int, default=100)
    ap.add_argument("--curve_end_frac", type=float, default=1.0,
                    help="freeze the curves at this fraction of iters")
    ap.add_argument("--opacity_reset", type=int, default=10_000_000)
    ap.add_argument("--densify_from", type=int, default=500)
    ap.add_argument("--densify_interval", type=int, default=200)
    ap.add_argument("--capacity_mult", type=int, default=4)
    ap.add_argument("--report", type=str, default=None,
                    help="write a JSON result to this path")
    ap.add_argument("--random_sample", action="store_true",
                    help="jitter the sub-frame times each step")
    ap.add_argument("--batched", action="store_true",
                    help="render all sub-frames in one render_batch (mixed layout)")
    ap.add_argument("--layout", type=str, default="lockstep", choices=["lockstep", "mixed"])
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--cams_per_step", type=int, default=1,
                    help="B training cameras per step")
    ap.add_argument("--window", type=int, default=1, help="accepted; no effect")
    ap.add_argument("--chunk", type=int, default=0, help="accepted; no effect")
    ap.add_argument("--fast", action="store_true",
                    help="fast blend mode on the training config (mixed layout only)")
    ap.add_argument("--pos_lr", type=float, default=0.00016, help="xyz LR init")
    ap.add_argument("--curve_lr_mult", type=float, default=1.0)
    ap.add_argument("--curve_half_frac", type=float, default=0.1,
                    help="curve LR half-life as a fraction of iters")
    ap.add_argument("--init_noise", type=float, default=0.001)
    ap.add_argument("--clip_grad", type=float, default=-1.0,
                    help="gradient value clipping (<= 0: off)")
    ap.add_argument("--max_pairs", type=int, default=1 << 17)
    ap.add_argument("--true_scale", type=float, default=0.035,
                    help="true-scene Gaussian scale (world units)")
    ap.add_argument("--texture", type=str, default="random", choices=["random", "checker"],
                    help="true-scene colouring: per-splat noise or a 3D checkerboard")
    ap.add_argument("--checker_cell", type=float, default=0.5,
                    help="checker texture cell size (world units)")
    ap.add_argument("--save_state", type=str, default=None,
                    help="write the final TrainState checkpoint here")
    ap.add_argument("--pose_refine_iters", type=int, default=0,
                    help="per-view pose refinement before the final sharp eval (0: off)")
    ap.add_argument("--init_true_curves", action="store_true",
                    help="start the learned curves at the true trajectories (+init_noise)")
    ap.add_argument("--baseline_sharp", type=float, default=None,
                    help="no-curve baseline sharp PSNR (dB): PASS needs it + 3 dB")
    ap.add_argument("--gt_oversample", type=int, default=1,
                    help="synthesise the blurry GT from n_sub*K uniform trajectory samples")
    ap.add_argument("--ckpt_every", type=int, default=0,
                    help="rolling checkpoint cadence, the newest two kept (0: off)")
    ap.add_argument("--curve_alignment_lr", type=float, default=0.0,
                    help="alignment (nu) LR")
    ap.add_argument("--curve_align_start", type=int, default=0,
                    help="alignment LR warmup start iteration")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


CURVE_ORDER = 9
FOVX = 1.1
PALETTE = ((0.92, 0.88, 0.15), (0.10, 0.12, 0.85), (0.88, 0.10, 0.12))


def wall_side(args) -> int:
    return int(math.ceil(math.sqrt(args.n_gauss // 2)))


DRAW_KEYS = ("fg", "colors", "sweep_dir", "rot_sweep", "point_noise", "curve_rot",
             "curve_trans")


def make_draws(args) -> dict:
    """Every random draw of a run, as float32 numpy arrays named by their
    use (JAX's key in ``jax.random.split(PRNGKey(seed), 8)``)."""
    rng = np.random.default_rng(args.seed)
    n_pts = args.n_gauss + wall_side(args) ** 2
    ctrl = (args.n_cams, CURVE_ORDER + 1, 3)
    draws = {
        "fg": rng.standard_normal((args.n_gauss, 3)),                # ks[0]
        "colors": rng.uniform(0.05, 0.95, (n_pts, 3)),               # ks[1], --texture random
        "sweep_dir": rng.standard_normal((args.n_cams, 1, 3)),       # ks[3]
        "rot_sweep": rng.standard_normal((args.n_cams, 1, 3)),       # ks[4]
        "point_noise": rng.standard_normal((n_pts, 3)),              # ks[5], the joint arms
        "curve_rot": rng.standard_normal(ctrl),                      # ks[6] (its first half)
        "curve_trans": rng.standard_normal(ctrl),                    # ks[6] (its second half)
    }
    return {k: v.astype(np.float32) for k, v in draws.items()}


def load_draws(path: str) -> dict:
    """A run's draws from an ``.npz`` with :data:`DRAW_KEYS` (float32), to
    pass to :func:`main` in place of :func:`make_draws`'s: JAX's r5 draws
    are committed as ``runs/r5_jax_draws.npz``."""
    with np.load(path) as d:
        missing = sorted(set(DRAW_KEYS) - set(d.files))
        if missing:
            raise KeyError(f"{path}: no draws {missing}")
        return {k: np.asarray(d[k], np.float32) for k in DRAW_KEYS}


def check_draws(args, draws: dict) -> None:
    """Raise ValueError unless ``draws`` has the shapes ``args`` draws."""
    want = {k: v.shape for k, v in make_draws(args).items()}
    got = {k: np.shape(draws.get(k)) for k in DRAW_KEYS}
    if got != want:
        raise ValueError(f"draws of shapes {got} do not fit the arguments' {want}")


class Truth(NamedTuple):
    """The synthetic problem: the true scene and curves, the configs, and
    (after :func:`synthesize`) the blurry and sharp ground truth."""

    dev: torch.device
    cs: cam_lib.CameraStatic
    proj: torch.Tensor
    gcfg: gm.GaussianConfig
    mcfg: motion_lib.MotionConfig
    rcfg: RasterizeConfig          # the training renders
    rcfg_eval: RasterizeConfig     # the synthesis, sharp and refinement renders
    pts: torch.Tensor
    cols: torch.Tensor
    params: gm.GaussianParams
    aux: gm.GaussianAux
    rots: torch.Tensor
    centers: torch.Tensor
    motion: motion_lib.MotionParams
    blur_gts: torch.Tensor | None = None
    sharp_gts: torch.Tensor | None = None
    mid_cams: list | None = None
    blur_floor: float | None = None


def build_truth(args, draws: dict, dev: torch.device) -> Truth:
    """The true scene (foreground points plus an opaque backdrop wall, small
    hard splats), the true per-image curves (a ring of nominal poses plus a
    linear SE(3) sweep) and the render configs."""
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)  # noqa: E731
    W = H = args.size
    cs = cam_lib.CameraStatic(width=W, height=H, tanfovx=math.tan(FOVX / 2),
                              tanfovy=math.tan(FOVX / 2))
    proj = cam_lib.get_projection_matrix(0.01, 100.0, FOVX, FOVX, device=dev)

    # ---- true scene; the wall covers every pixel (random training backgrounds)
    side = wall_side(args)
    gx, gy = torch.meshgrid(torch.linspace(-4, 4, side, device=dev),
                            torch.linspace(-4, 4, side, device=dev), indexing="xy")
    wall = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.full((side * side,), 2.5, device=dev)], -1)
    pts = torch.cat([t(draws["fg"]) * 0.9, wall])
    if args.texture == "checker":
        # 3-colour 3D checkerboard: piecewise-constant colour over
        # checker_cell-sized cells with sharp (splat-limited) boundaries
        cell = torch.floor(pts / args.checker_cell).to(torch.int32)
        parity = (cell[:, 0] + 2 * cell[:, 1] + 3 * cell[:, 2]) % 3
        cols = t(PALETTE)[parity.long()]
    else:
        cols = t(draws["colors"])
    gcfg = gm.GaussianConfig(sh_degree=2)
    params, aux = gm.create_from_pcd(pts, cols, gcfg, pts.shape[0])
    # small hard splats: blur must be observable
    params = params._replace(
        opacity=torch.full_like(params.opacity, 0.9),
        scaling=torch.full_like(params.scaling, float(gm.inverse_scaling(
            torch.tensor(args.true_scale, dtype=torch.float32), gcfg))))

    # ---- true per-image trajectories: nominal ring pose + an SE(3) sweep
    mcfg = motion_lib.MotionConfig(curve_order=CURVE_ORDER, n_subframes=args.n_sub,
                                   curve_random_sample=args.random_sample)
    angs = [2 * math.pi * i / args.n_cams * 0.25 for i in range(args.n_cams)]
    rots = lie.so3_exp_map(t([[0.15 * math.sin(a), a, 0.0] for a in angs]))
    centers = rots @ t([0.0, 0.0, -4.0])
    motion = nominal_motion(rots, centers, mcfg)
    sweep_dir = t(draws["sweep_dir"])
    sweep_dir = sweep_dir / torch.linalg.norm(sweep_dir, dim=-1, keepdim=True)
    tline = torch.linspace(-0.5, 0.5, CURVE_ORDER + 1, device=dev)[None, :, None]
    motion = motion._replace(
        trans_ctrl=motion.trans_ctrl + args.blur_scale * sweep_dir * tline,
        rot_ctrl=motion.rot_ctrl + 0.04 * t(draws["rot_sweep"]) * tline)

    # with --batched, max_pairs budgets all n_sub views of a render; the
    # single-view synthesis, eval and refinement renders get a smaller one
    train_layout = "mixed" if args.batched else args.layout
    train_ncon = not (args.batched or args.layout == "mixed")
    rcfg = RasterizeConfig(backend=args.backend, max_pairs=args.max_pairs, k_max=1024,
                           tile_w=args.tile, tile_h=args.tile, layout=train_layout,
                           window=args.window, need_n_contrib=train_ncon,
                           chunk=args.chunk if train_layout == "mixed" else 0,
                           fast=(args.fast and args.backend == "pallas"
                                 and train_layout == "mixed" and not train_ncon))
    rcfg_eval = RasterizeConfig(backend=args.backend, max_pairs=min(args.max_pairs, 1 << 17),
                                k_max=1024, tile_w=args.tile, tile_h=args.tile,
                                layout=args.layout, window=args.window, need_n_contrib=False)
    return Truth(dev=dev, cs=cs, proj=proj, gcfg=gcfg, mcfg=mcfg, rcfg=rcfg,
                 rcfg_eval=rcfg_eval, pts=pts, cols=cols, params=params, aux=aux, rots=rots,
                 centers=centers, motion=motion)


def nominal_motion(rots, centers, mcfg):
    """Curves resting at the nominal poses (no noise)."""
    gen = torch.Generator(device=rots.device).manual_seed(0)   # its draws are scaled by 0
    return motion_lib.init_motion(rots, centers, mcfg, gen, init_noise=0.0).params()


def one(cams, i):
    return type(cams)(*(x[i] for x in cams))


class EvalRenderer:
    """Single-view renders at ``truth.rcfg_eval`` (sh degree 2, black
    background), recording the largest pair list any of them emitted."""

    def __init__(self, truth: Truth):
        self.truth = truth
        self.max_num_pairs = 0

    def __call__(self, params, active, cam):
        return self.render_inputs(gm.render_inputs(params, self.truth.gcfg), active, cam)

    def render_inputs(self, rin, active, cam):
        tr = self.truth
        out = render(rin["means3d"], rin["scales"], rin["rotations"], rin["opacities"],
                     rin["shs"], cam, tr.cs, torch.zeros(3, device=tr.dev), cfg=tr.rcfg_eval,
                     sh_degree=2, active=active)
        self.max_num_pairs = max(self.max_num_pairs, int(out.num_pairs))
        return out.image


def synthesize(args, truth: Truth, render_with: EvalRenderer) -> Truth:
    """The blurry GT (the mean of n_sub·gt_oversample uniform sub-frame
    renders), the sharp GT at the mid-trajectory poses, and the blur floor."""
    n_gt = args.n_sub * args.gt_oversample
    nu = torch.linspace(0.0, 1.0, n_gt, device=truth.dev)
    blur_gts, sharp_gts, mid_cams = [], [], []
    with torch.no_grad():
        for i in range(args.n_cams):
            cams = motion_lib.subframe_cameras_batch(truth.motion, [i], nu[None], truth.proj,
                                                     truth.mcfg)
            blur_gts.append(torch.stack([render_with(truth.params, truth.aux.active,
                                                     one(cams, s))
                                         for s in range(n_gt)]).mean(0))
            mid_cams.append(one(cams, n_gt // 2))
            sharp_gts.append(render_with(truth.params, truth.aux.active, mid_cams[-1]))
            print(f"  cam {i} synthesized", flush=True)
    blur_gts, sharp_gts = torch.stack(blur_gts), torch.stack(sharp_gts)
    # the no-deblur floor: how far the blurry observations already sit from
    # the sharp truth (a fit of the blur alone scores about this)
    blur_floor = float(np.mean([float(psnr(torch.clamp(b, 0, 1), torch.clamp(s, 0, 1)))
                                for b, s in zip(blur_gts, sharp_gts)]))
    return truth._replace(blur_gts=blur_gts, sharp_gts=sharp_gts, mid_cams=mid_cams,
                          blur_floor=blur_floor)


def init_arm(args, draws: dict, truth: Truth):
    """The arm's starting (params, aux, motion): the true scene
    (``--freeze_scene``) or noisy points at ``capacity_mult`` × capacity;
    the true curves plus ``init_noise`` (``--init_true_curves``) or the
    nominal poses plus ``init_noise``."""
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=truth.dev)  # noqa: E731
    if args.freeze_scene:
        params, aux = truth.params, truth.aux
    else:
        params, aux = gm.create_from_pcd(truth.pts + 0.03 * t(draws["point_noise"]), truth.cols,
                                         truth.gcfg,
                                         capacity=truth.pts.shape[0] * args.capacity_mult)
    base = (truth.motion if args.init_true_curves
            else nominal_motion(truth.rots, truth.centers, truth.mcfg))
    motion0 = base._replace(rot_ctrl=base.rot_ctrl + args.init_noise * t(draws["curve_rot"]),
                            trans_ctrl=base.trans_ctrl
                            + args.init_noise * t(draws["curve_trans"]))
    return params, aux, motion0


def optimization_config(args):
    zero_lr = (dict(position_lr_init=0.0, position_lr_final=0.0, feature_lr=0.0,
                    opacity_lr=0.0, scaling_lr=0.0, rotation_lr=0.0, lambda_hinge=0.0)
               if args.freeze_scene else {})
    return OptimizationConfig(
        iterations=args.iters, curve_start_iter=10**9 if args.no_curve else args.curve_start,
        curve_end_iter=int(args.iters * args.curve_end_frac) + 1,
        densify_from_iter=10**9 if (args.freeze_scene or args.no_densify) else args.densify_from,
        densification_interval=args.densify_interval,
        densify_until_iter=int(args.iters * 0.7),
        opacity_reset_interval=args.opacity_reset,
        curve_controlpoints_lr=1e-2 * args.curve_lr_mult,
        curve_rotation_lr=1e-3 * args.curve_lr_mult,
        curve_lr_half_iter=max(int(args.iters * args.curve_half_frac), 1),
        curve_alignment_lr=args.curve_alignment_lr,
        curve_alignment_start=args.curve_align_start, clip_grad=args.clip_grad,
        **{"position_lr_init": args.pos_lr, "position_lr_final": args.pos_lr / 100.0,
           **zero_lr})


def statics_key(args, truth: Truth, ocfg, it: int) -> tuple:
    """(SH degree, sub-frames) of iteration ``it``: degree min(it // 1000,
    2), all sub-frames from ``curve_start_iter`` on, one before."""
    return (min(it // 1000, truth.gcfg.sh_degree),
            args.n_sub if it >= ocfg.curve_start_iter else 1)


def train_statics(args, truth: Truth, ocfg, sh_degree: int, n_sub: int):
    return step_lib.TrainStatics(
        gcfg=truth.gcfg, mcfg=truth.mcfg, ocfg=ocfg, rcfg=truth.rcfg, cs=truth.cs,
        sh_degree=sh_degree, n_sub=n_sub, tone_mapping="identity", spatial_lr_scale=2.0,
        random_sample=args.random_sample, batched_render=args.batched,
        cams_per_step=args.cams_per_step)


def step_cameras(args, it: int):
    """The step's training cameras: one, cycling, or ``cams_per_step``."""
    B = args.cams_per_step
    if B == 1:
        return (it - 1) % args.n_cams
    return (np.arange(B) + (it - 1) * B) % args.n_cams


def _chamfer(a: np.ndarray, b: np.ndarray) -> float:
    d = np.linalg.norm(a[:, None] - b[None, :], axis=-1)
    return 0.5 * (float(np.mean(np.min(d, 1))) + float(np.mean(np.min(d, 0))))


def traj_error(motion, true_motion, mcfg, align_gauge=False) -> float:
    """Mean symmetric Chamfer distance between learned and true camera-centre
    sets (16 samples a curve), each centred: a mean blur constrains the set
    of poses visited, not their order. With ``align_gauge``, after one
    global Kabsch alignment of all learned centres onto the true ones (the
    joint solution is defined up to a world-frame motion). In float32, as
    JAX's. NaN for a non-finite curve (never a failed SVD)."""
    n = motion.nu.shape[0]
    idx = torch.arange(n, device=motion.nu.device)
    ts = torch.linspace(0.0, 1.0, 16, device=motion.nu.device)[None].expand(n, 16)
    with torch.no_grad():
        c_l = motion_lib._sample_c2w(motion, idx, ts, mcfg)[1].cpu().numpy()
        c_t = motion_lib._sample_c2w(true_motion, idx, ts, mcfg)[1].cpu().numpy()
    if not np.isfinite(c_l).all():
        return float("nan")
    if align_gauge:
        A, B = c_l.reshape(-1, 3), c_t.reshape(-1, 3)
        mu_a, mu_b = A.mean(0), B.mean(0)
        U, _, Vt = np.linalg.svd((A - mu_a).T @ (B - mu_b))
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T                    # maps learned -> true
        c_l = c_l @ R.T + (mu_b - R @ mu_a)
    f32 = lambda c: (c - c.mean(0)).astype(np.float32)   # noqa: E731
    return float(np.mean([_chamfer(f32(a), f32(b)) for a, b in zip(c_l, c_t)]))


def state_finite(params, motion) -> bool:
    """Every Gaussian and curve leaf finite (one sync)."""
    leaves = tuple(params) + tuple(motion)
    return bool(torch.stack([torch.isfinite(x).all() for x in leaves]).all())


class Pose(NamedTuple):
    quat: torch.Tensor    # [4] (w, x, y, z) of the view matrix's rotation block
    trans: torch.Tensor   # [3] the view matrix's translation row


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """w-first quaternion from the trace (small-angle safe enough here)."""
    w = torch.sqrt(torch.clamp(1 + R[0, 0] + R[1, 1] + R[2, 2], min=1e-8)) / 2
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return torch.stack([w, x, y, z])


def pose_camera(pose: Pose, proj: torch.Tensor):
    """The camera of a pose: ``view[:3, :3]`` the normalised rotation of
    ``quat + 1e-8``, ``view[3, :3]`` the translation (row-vector form)."""
    R = tfm.quat_to_rotmat(pose.quat + 1e-8, normalize=True)
    view = torch.zeros((4, 4), dtype=torch.float32, device=R.device)
    view[:3, :3] = R
    view[3, :3] = pose.trans
    view[3, 3] = 1.0
    return cam_lib.make_camera_arrays(view, proj)


def pose_of(cam) -> Pose:
    return Pose(rotmat_to_quat(cam.view[:3, :3]), cam.view[3, :3])


def refine_pose(render_pose, cam0, gt: torch.Tensor, iters: int) -> float:
    """Refine one view's pose from ``cam0`` by Adam on the L1 error (lr
    5e-5 rotation, 5e-4 translation, × 0.9 twenty times over the run;
    reference ``test.py:131-186``); returns the PSNR of the refined view."""
    pose = pose_of(cam0)
    st_o = optim_lib.init(pose)
    for e in range(iters):
        lr_scale = torch.tensor(0.9 ** (e * 20 // max(iters, 1)), dtype=torch.float32)
        leaves = Pose(*(x.detach().requires_grad_(True) for x in pose))
        loss = torch.abs(render_pose(leaves) - gt).mean()
        grads = Pose(*torch.autograd.grad(loss, tuple(leaves)))
        with torch.no_grad():
            pose, st_o = optim_lib.update(pose, grads, st_o,
                                          Pose(5e-5 * lr_scale, 5e-4 * lr_scale))
    with torch.no_grad():
        return float(psnr(torch.clamp(render_pose(pose), 0, 1), torch.clamp(gt, 0, 1)))


def learned_mid_cam(truth: Truth, motion, i: int):
    """The learned curve's mid-exposure (ν = 0.5) camera of view ``i``: the
    reference's render_trainview protocol, gauge-invariant."""
    return one(motion_lib.subframe_cameras_batch(
        motion, [i], torch.full((1, 1), 0.5, device=truth.dev), truth.proj, truth.mcfg), 0)


def sharp_psnr(truth: Truth, render_with, params, active, motion,
               learned_mid: bool = False) -> float:
    """Mean PSNR of the views against the sharp truth (each clipped to [0,
    1]), rendered at the true mid-trajectory poses or (``learned_mid``) at
    the learned curves' mid-exposure cameras; NaN for a non-finite state."""
    if not state_finite(params, motion):
        return float("nan")
    clip = lambda x: torch.clamp(x, 0, 1)   # noqa: E731
    with torch.no_grad():
        cams = ([learned_mid_cam(truth, motion, i) for i in range(len(truth.mid_cams))]
                if learned_mid else truth.mid_cams)
        return float(np.mean([float(psnr(clip(render_with(params, active, cam)),
                                         clip(truth.sharp_gts[i])))
                              for i, cam in enumerate(cams)]))


def evaluate_state(args, truth: Truth, render_with, params, active, motion, motion0,
                   refine: bool = True) -> dict:
    """The final evaluation of a state (Gaussian ``params``, ``active``
    mask, learned curves ``motion``; ``motion0`` the arm's initial curves):
    the sharp PSNRs at the true and the learned mid-exposure cameras, the
    pose-refined PSNR (``--pose_refine_iters`` > 0 and ``refine``, else
    None) and the trajectory errors with and without gauge alignment, at
    the end and at ``motion0``, under the report's keys."""
    sharp = sharp_psnr(truth, render_with, params, active, motion)
    mid = sharp_psnr(truth, render_with, params, active, motion, learned_mid=True)
    refined = None
    if args.pose_refine_iters > 0 and refine:
        # the reference's eval protocol: refine each pose photometrically from
        # the learned mid-exposure camera (already in the learned gauge)
        with torch.no_grad():
            rin = gm.render_inputs(params, truth.gcfg)
            cams0 = [learned_mid_cam(truth, motion, i) for i in range(args.n_cams)]

        def render_pose(pose):
            return render_with.render_inputs(rin, active, pose_camera(pose, truth.proj))

        refined = float(np.mean([refine_pose(render_pose, cams0[i], truth.sharp_gts[i],
                                             args.pose_refine_iters)
                                 for i in range(args.n_cams)]))
        print(f"pose-refined sharp PSNR: {refined:.2f} dB")
    mcfg = truth.mcfg
    return {"sharp_psnr": sharp, "sharp_psnr_midcam": mid, "sharp_psnr_pose_refined": refined,
            "traj_err": traj_error(motion, truth.motion, mcfg),
            "traj_err_aligned": traj_error(motion, truth.motion, mcfg, align_gauge=True),
            "traj_err_init": traj_error(motion0, truth.motion, mcfg),
            "traj_err_aligned_init": traj_error(motion0, truth.motion, mcfg, align_gauge=True)}


def _json_value(x):
    """NaN is not valid JSON: written as null."""
    return None if isinstance(x, float) and not math.isfinite(x) else x


def main(argv=None, draws: dict | None = None) -> int:
    """Run one arm; ``draws`` replaces :func:`make_draws` (same keys)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if draws is None:
        draws = make_draws(args)
    else:
        check_draws(args, draws)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    truth = build_truth(args, draws, dev)
    render_with = EvalRenderer(truth)
    mcfg, proj = truth.mcfg, truth.proj

    print("synthesizing ground truth...")
    truth = synthesize(args, truth, render_with)
    blur_gts = truth.blur_gts
    print(f"  synthesis done; blur-vs-sharp floor {truth.blur_floor:.2f} dB", flush=True)

    params, aux, motion0 = init_arm(args, draws, truth)
    ocfg = optimization_config(args)
    state = step_lib.init_state(params, motion0, aux)

    def progress_psnr(st, learned_mid=False) -> float:
        return sharp_psnr(truth, render_with, st.params, st.aux.active, st.motion, learned_mid)

    print(f"sharp PSNR at init: {progress_psnr(state):.2f} dB")
    statics = {}
    base = args.save_state or args.report or "runs/validate"
    ckpt_stem = os.path.splitext(base)[0] + "_ckpt" if args.ckpt_every > 0 else None
    ckpts_kept = []
    nan_at = None
    t0 = time.time()
    for it in range(1, args.iters + 1):
        key = statics_key(args, truth, ocfg, it)
        if key not in statics:
            statics[key] = train_statics(args, truth, ocfg, *key)
        st = statics[key]
        idx = step_cameras(args, it)
        state, metrics = step_lib.train_step(state, blur_gts[idx], idx, proj, st, generator=gen)
        if ckpt_stem and it % args.ckpt_every == 0:
            path = f"{ckpt_stem}_{it}.npz"
            ckpt_lib.save_checkpoint(path, state)
            ckpts_kept.append(path)
            while len(ckpts_kept) > 2:
                old = ckpts_kept.pop(0)
                if os.path.exists(old):
                    os.remove(old)
        if it % 200 == 0 or it == args.iters:
            # a poisoned state aborts with a dump, not hours of training garbage
            if (not math.isfinite(float(metrics.loss))
                    or not state_finite(state.params, state.motion)):
                nan_at = it
                dump = os.path.splitext(base)[0] + f"_nanstate_it{it}.npz"
                ckpt_lib.save_checkpoint(dump, state)
                print(f"!! non-finite loss/params detected at the it={it} sync (onset "
                      f"within the last 200 steps) — state dumped to {dump}; aborting",
                      flush=True)
                break
            print(f"it {it}: blur-l1={float(metrics.l1):.4f} "
                  f"psnr(blur)={float(metrics.psnr):.2f} sharp-psnr={progress_psnr(state):.2f} "
                  f"sharp-mid={progress_psnr(state, learned_mid=True):.2f} "
                  f"curve-trans-err={traj_error(state.motion, truth.motion, mcfg):.4f} "
                  f"#pts={int(metrics.num_active)} ({time.time() - t0:.0f}s)", flush=True)
    train_s = time.time() - t0

    ev = evaluate_state(args, truth, render_with, state.params, state.aux.active, state.motion,
                        motion0, refine=nan_at is None)
    if args.save_state:
        ckpt_lib.save_checkpoint(args.save_state, state)
    final_sharp, final_mid, refined_sharp = (ev["sharp_psnr"], ev["sharp_psnr_midcam"],
                                             ev["sharp_psnr_pose_refined"])
    tr_err, tr_err_al = ev["traj_err"], ev["traj_err_aligned"]
    init_err, init_err_al = ev["traj_err_init"], ev["traj_err_aligned_init"]
    n_overflow = int(state.overflow_count)
    print(f"train {train_s:.1f} s; eval renders: largest pair list "
          f"{render_with.max_num_pairs} of a budget of {truth.rcfg_eval.max_pairs}")
    print(f"\nFINAL: sharp PSNR {final_sharp:.2f} dB (learned-mid-cam {final_mid:.2f} dB); "
          f"curve translation error {tr_err:.4f} (init {init_err:.4f}); gauge-aligned "
          f"{tr_err_al:.4f} (init {init_err_al:.4f}); overflowed steps {n_overflow}")
    if args.report:
        result = {
            "sharp_psnr": final_sharp, "traj_err": tr_err, "traj_err_init": init_err,
            "traj_err_aligned": tr_err_al, "traj_err_aligned_init": init_err_al,
            "overflow_steps": n_overflow, "blur_floor_psnr": truth.blur_floor,
            "final_points": int(state.aux.active.sum()), "sharp_psnr_midcam": final_mid,
            "sharp_psnr_pose_refined": refined_sharp, "nan_at": nan_at, "iters": args.iters,
            "n_cams": args.n_cams, "n_sub": args.n_sub, "size": args.size,
            "no_curve": args.no_curve, "no_densify": args.no_densify, "args": vars(args)}
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as fp:
            json.dump({k: _json_value(v) for k, v in result.items()}, fp)
    if nan_at is not None:
        print(f"VALIDATION ABORTED (non-finite state at it {nan_at})")
        return 2
    if args.freeze_scene:
        ok = tr_err < 0.6 * init_err
    else:
        # the joint solution is gauge-free: the best of the true-pose, the
        # learned-mid-camera and the pose-refined evals
        best_sharp = max(final_sharp, final_mid, refined_sharp or final_sharp)
        if args.baseline_sharp is not None:
            ok = best_sharp >= args.baseline_sharp + 3.0 and tr_err_al <= init_err_al
            print(f"criteria: gauge-fair sharp {best_sharp:.2f} vs baseline+3 = "
                  f"{args.baseline_sharp + 3.0:.2f}; gauge-aligned traj_err {tr_err_al:.4f} "
                  f"vs aligned init {init_err_al:.4f}")
        else:
            ok = best_sharp > 24.0
    print("VALIDATION", "PASSED" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
