"""JAX's r5 scene as data for the port (``runs/r5_jax_draws.npz``).

The r5 protocol's arms (``scripts/r5_cal3b.sh``, ``scripts/r5_jointb.sh``)
draw their scene from ``jax.random.split(PRNGKey(0), 8)`` at 800 points
and 12 cameras. The port cannot reproduce JAX's random streams, so the
draws are committed as an ``.npz`` that the port loads with numpy alone
(``validate_blur_recovery.load_draws``). Rewrite it (with JAX) by running
this file as a module from the repository's root::

    JAX_PLATFORMS=cpu python -m tests.test_torch_r5_scene

The tests, none of which renders:

- the committed draws equal JAX's, bit for bit;
- ``build_truth`` on them gives the points, colours, true Gaussians and
  true curves of JAX's script at the r5 arguments;
- the initial trajectory errors of the r5 arms' start are
  ``runs/r5_jointb.json``'s within rtol 1e-5 + ``TRAJ_ATOL``;
- ``evaluate_state`` returns what ``main`` reported, at 32 px.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.core import lie as jlie
from deblurgs_tpu.models import gaussians as jgm
from deblurgs_tpu.models import motion as jmm
from deblurgs_tpu_torch.scripts import recovery_protocol as rp
from deblurgs_tpu_torch.scripts import validate_blur_recovery as vbr
from deblurgs_tpu_torch.train import checkpoint as ckpt_lib
from tests.test_torch_recovery import GOLDEN, TRAJ_ATOL
from tests.torch_bridge import jax_draws, np_of

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAWS = os.path.join(REPO, "runs", "r5_jax_draws.npz")
CPU = torch.device("cpu")


def r5_args():
    """The r5 arguments: the protocol's scene (its ``CAL`` flags), seed 0."""
    return vbr.parse_args(rp.CAL + ["--device", "cpu"])


def write(path: str = DRAWS) -> dict:
    draws = jax_draws(r5_args())
    np.savez(path, **draws)
    return draws


def _jax_run(name):
    with open(os.path.join(REPO, "runs", name)) as f:
        return json.load(f)


def test_r5_args_are_jax_runs():
    """The arguments the draws depend on are those of JAX's r5 reports."""
    args = vars(r5_args())
    for name in ("r5_cal3b_nocurve.json", "r5_cal3b_oracle.json", "r5_jointb.json"):
        want = _jax_run(name)["args"]
        for key in ("seed", "n_gauss", "n_cams", "n_sub", "size", "texture", "checker_cell",
                    "blur_scale", "true_scale", "capacity_mult", "gt_oversample"):
            assert args[key] == want[key], (name, key)


def test_committed_draws_are_jax_draws():
    got = vbr.load_draws(DRAWS)
    with np.load(DRAWS) as d:
        assert sorted(d.files) == sorted(vbr.DRAW_KEYS)
    want = jax_draws(r5_args())
    vbr.check_draws(r5_args(), got)
    for key in vbr.DRAW_KEYS:
        assert got[key].dtype == want[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_check_draws_refuses_other_shapes():
    args = r5_args()
    draws = vbr.load_draws(DRAWS)
    with pytest.raises(ValueError):
        vbr.check_draws(vbr.parse_args(rp.CAL + ["--n_cams", "6"]), draws)
    with pytest.raises(ValueError):
        vbr.check_draws(args, {k: v for k, v in draws.items() if k != "fg"})


def jax_truth(args):
    """JAX's script's true scene and curves at ``args``
    (``scripts/validate_blur_recovery.py:177-241``), without rendering;
    call it under ``jax.jit`` (one compile, not one an operation)."""
    ks = jax.random.split(jax.random.PRNGKey(args.seed), 8)
    fg = jax.random.normal(ks[0], (args.n_gauss, 3)) * 0.9
    side = int(math.ceil(math.sqrt(args.n_gauss // 2)))
    gx, gy = jnp.meshgrid(jnp.linspace(-4, 4, side), jnp.linspace(-4, 4, side))
    wall = jnp.stack([gx.ravel(), gy.ravel(), jnp.full(side * side, 2.5)], axis=-1)
    pts = jnp.concatenate([fg, wall])
    cell_idx = jnp.floor(pts / args.checker_cell).astype(jnp.int32)
    parity = (cell_idx[:, 0] + 2 * cell_idx[:, 1] + 3 * cell_idx[:, 2]) % 3
    cols = jnp.array(vbr.PALETTE)[parity]
    gcfg = jgm.GaussianConfig(sh_degree=2)
    params, _ = jgm.create_from_pcd(pts, cols, gcfg, pts.shape[0])
    params = params._replace(
        opacity=jnp.full_like(params.opacity, 0.9),
        scaling=jnp.full_like(params.scaling,
                              jgm.inverse_scaling(jnp.float32(args.true_scale), gcfg)))
    mcfg = jmm.MotionConfig(curve_order=9, n_subframes=args.n_sub)
    rots, centers = [], []
    for i in range(args.n_cams):
        ang = 2 * math.pi * i / args.n_cams * 0.25
        rot = jlie.so3_exp_map(jnp.array([[0.15 * math.sin(ang), ang, 0.0]]))[0]
        rots.append(rot)
        centers.append(rot @ jnp.array([0.0, 0.0, -4.0]))
    motion = jmm.init_motion(jnp.stack(rots), jnp.stack(centers), mcfg, ks[2], init_noise=0.0)
    sweep_dir = jax.random.normal(ks[3], (args.n_cams, 1, 3))
    sweep_dir = sweep_dir / jnp.linalg.norm(sweep_dir, axis=-1, keepdims=True)
    tline = jnp.linspace(-0.5, 0.5, mcfg.curve_order + 1)[None, :, None]
    motion = motion._replace(
        trans_ctrl=motion.trans_ctrl + args.blur_scale * sweep_dir * tline,
        rot_ctrl=motion.rot_ctrl + 0.04 * jax.random.normal(ks[4], (args.n_cams, 1, 3)) * tline)
    return pts, cols, params, motion


def test_truth_is_jax_construction():
    """The true points, colours, Gaussians and curves of ``build_truth`` on
    the committed draws against JAX's script's construction: the points,
    colours and checker parities exactly; the Gaussian leaves and the
    curves' control points to float32 rounding."""
    args = r5_args()
    truth = vbr.build_truth(args, vbr.load_draws(DRAWS), CPU)
    pts, cols, params, motion = jax.jit(lambda: jax_truth(args))()
    np.testing.assert_allclose(np_of(truth.pts), np.asarray(pts), rtol=0, atol=5e-7)
    np.testing.assert_array_equal(np_of(truth.cols), np.asarray(cols))
    for key in jgm.GaussianParams._fields:
        np.testing.assert_allclose(np_of(getattr(truth.params, key)),
                                   np.asarray(getattr(params, key)), rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    assert bool(truth.aux.active.all()) and truth.pts.shape == (1200, 3)
    for key in jmm.MotionParams._fields:
        np.testing.assert_allclose(np_of(getattr(truth.motion, key)),
                                   np.asarray(getattr(motion, key)), rtol=0, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("arm", ["joint", "nocurve"])
def test_initial_trajectory_errors_are_jax_reports(arm):
    """The arms' starting curves (the nominal poses + 0.001 × JAX's noise)
    against the true ones, as JAX's r5 reports give them."""
    args = vbr.parse_args(rp.ARMS[arm][1] + ["--device", "cpu"])
    draws = vbr.load_draws(DRAWS)
    truth = vbr.build_truth(args, draws, CPU)
    _, _, motion0 = vbr.init_arm(args, draws, truth)
    want = _jax_run("r5_jointb.json" if arm == "joint" else "r5_cal3b_nocurve.json")
    got = {"traj_err_init": vbr.traj_error(motion0, truth.motion, truth.mcfg),
           "traj_err_aligned_init": vbr.traj_error(motion0, truth.motion, truth.mcfg,
                                                   align_gauge=True)}
    for key, value in got.items():
        np.testing.assert_allclose(value, want[key], rtol=1e-5, atol=TRAJ_ATOL, err_msg=key)


def test_evaluate_state_is_main_report(tmp_path):
    """``evaluate_state`` on the state ``main`` saved gives ``main``'s
    report bit for bit (the 32 px case of ``test_torch_recovery``, three
    iterations, two pose-refinement iterations a view)."""
    flags = GOLDEN + ["--iters", "3", "--pose_refine_iters", "2", "--texture", "checker",
                      "--device", "cpu"]
    args = vbr.parse_args(flags)
    draws = jax_draws(args)
    report, state_path = str(tmp_path / "r.json"), str(tmp_path / "s.npz")
    vbr.main(flags + ["--report", report, "--save_state", state_path], draws=draws)
    with open(report) as f:
        want = json.load(f)
    truth = vbr.build_truth(args, draws, CPU)
    render_with = vbr.EvalRenderer(truth)
    truth = vbr.synthesize(args, truth, render_with)
    _, _, motion0 = vbr.init_arm(args, draws, truth)
    state = ckpt_lib.load_checkpoint(state_path, device="cpu")
    got = vbr.evaluate_state(args, truth, render_with, state.params, state.aux.active,
                             state.motion, motion0)
    assert got["sharp_psnr_pose_refined"] is not None
    assert got == {k: want[k] for k in got}


def test_protocol_passes_the_draws_to_every_arm(tmp_path, monkeypatch):
    """``recovery_protocol.main(draws=)`` hands the same draws to each arm's
    ``main`` (a stand-in that writes a report and runs nothing)."""
    seen = []

    def arm(argv, draws=None):
        args = vbr.parse_args(argv)
        seen.append((args.report, draws))
        with open(args.report, "w") as f:
            json.dump({"sharp_psnr": 16.0 + len(seen), "blur_floor_psnr": 16.0, "nan_at": None,
                       "traj_err_aligned": 0.05, "traj_err_aligned_init": 0.1}, f)
        return 1

    monkeypatch.setattr(vbr, "main", arm)
    draws = vbr.load_draws(DRAWS)
    rp.main(["--out_dir", str(tmp_path), "--device", "cpu"], draws=draws)
    assert [os.path.basename(r) for r, _ in seen] == [
        f"{rp.ARMS[n][0]}.json" for n in ("nocurve", "oracle", "joint")]
    assert all(d is draws for _, d in seen)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    path = sys.argv[1] if len(sys.argv) > 1 else DRAWS
    print(path, {k: v.shape for k, v in write(path).items()})
