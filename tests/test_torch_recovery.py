"""The port's validation harness (``deblurgs_tpu_torch/scripts/
validate_blur_recovery.py``) against JAX's ``scripts/validate_blur_recovery.py``
and the r5 protocol's checks (``scripts/recovery_protocol.py``).

- JAX's script at iteration 0 (32 px, 2 cameras, F = 3, 60 points, the xla
  backend, 3 pose-refinement iterations, no curve noise) in a subprocess,
  and the port's ``main`` on JAX's own draws, for the freeze and joint arms
  and both textures: floor, sharp and mid-camera PSNR within 1e-3 dB, the
  initial trajectory errors within rtol 1e-5, the pose-refined PSNR within
  2e-2 dB, points and overflowed steps equal, the report's keys JAX's;
- the port's own arms: a densifying joint run with checkpoint rotation and
  two cameras a step, the NaN guard, the no-curve and oracle arms;
- the protocol: its command at 32 px, its arms' flags against the shell
  scripts', its verdicts and lines on JAX's committed r5 reports.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deblurgs_tpu_torch.scripts import recovery_protocol as rp
from deblurgs_tpu_torch.scripts import validate_blur_recovery as vbr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--size", "32", "--n_cams", "2", "--n_sub", "3", "--n_gauss", "60"]
GOLDEN = ["--backend", "xla", "--iters", "0", "--pose_refine_iters", "3",
          "--init_noise", "0"] + SMALL
CASES = [(arm, texture) for arm in ("freeze", "joint") for texture in ("random", "checker")]
JAX_KEYS = ["sharp_psnr", "traj_err", "traj_err_init", "traj_err_aligned",
            "traj_err_aligned_init", "overflow_steps", "blur_floor_psnr", "final_points",
            "sharp_psnr_midcam", "sharp_psnr_pose_refined", "nan_at", "iters", "n_cams",
            "n_sub", "size", "no_curve", "no_densify", "args"]
# The pose-refined PSNR after 3 Adam steps through the render: within 1e-3
# dB (measured 1e-6 on the joint arms). The freeze arm starts at the
# truth's own pose, where the gradient is rounding noise and Adam's first
# step, lr·sign(g) whatever |g|, takes its direction from that noise: both
# refined views stay within an MSE of 1e-6 of the truth (60 dB) there.
REFINED_DB = 1e-3
REFINED_AT_TRUTH_MSE = 1e-6
# The Chamfer distance moves at most as far as the centres it is taken of,
# and the packages' float32 camera centres (|c| = 4, spacing 4.8e-7) differ
# by up to 9.5e-7 (the curves' se3 maps round differently): 2e-6 absolute
# beside rtol 1e-5.
TRAJ_ATOL = 2e-6


def _flags(arm, texture):
    return GOLDEN + ["--texture", texture] + (["--freeze_scene"] if arm == "freeze" else [])


def jax_draws(args) -> dict:
    """JAX's script's draws, ``jax.random.split(PRNGKey(seed), 8)``, under
    the port's names."""
    ks = jax.random.split(jax.random.PRNGKey(args.seed), 8)
    k_rot, k_trans = jax.random.split(ks[6])
    n_pts = args.n_gauss + vbr.wall_side(args) ** 2
    ctrl = (args.n_cams, vbr.CURVE_ORDER + 1, 3)
    draws = dict(
        fg=jax.random.normal(ks[0], (args.n_gauss, 3)),
        colors=jax.random.uniform(ks[1], (n_pts, 3), minval=0.05, maxval=0.95),
        sweep_dir=jax.random.normal(ks[3], (args.n_cams, 1, 3)),
        rot_sweep=jax.random.normal(ks[4], (args.n_cams, 1, 3)),
        point_noise=jax.random.normal(ks[5], (n_pts, 3)),
        curve_rot=jax.random.normal(k_rot, ctrl), curve_trans=jax.random.normal(k_trans, ctrl))
    return {k: np.asarray(v, np.float32) for k, v in draws.items()}


@pytest.fixture(scope="module")
def jax_reports(tmp_path_factory):
    """JAX's reports of the four cases, its four processes run at once."""
    root = tmp_path_factory.mktemp("jax_vbr")
    procs = {}
    for case in CASES:
        path = str(root / f"{'_'.join(case)}.json")
        procs[case] = path, subprocess.Popen(
            [sys.executable, "scripts/validate_blur_recovery.py", "--platform", "cpu",
             *_flags(*case), "--report", path], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for case, (path, proc) in procs.items():
        log = proc.communicate(timeout=600)[0]
        assert os.path.exists(path), log[-3000:]
        with open(path) as f:
            out[case] = json.load(f)
    return out


@pytest.mark.parametrize("arm,texture", CASES)
def test_iteration0_matches_jax(arm, texture, jax_reports, tmp_path):
    flags = _flags(arm, texture)
    report = str(tmp_path / "port.json")
    rc = vbr.main(flags + ["--device", "cpu", "--report", report],
                  draws=jax_draws(vbr.parse_args(flags)))
    with open(report) as f:
        got = json.load(f)
    want = jax_reports[arm, texture]
    assert rc == 1          # iteration 0 recovers nothing: both arms FAIL
    assert list(got) == list(want) == JAX_KEYS
    assert set(got["args"]) - {"device"} == set(want["args"]) - {"platform"}
    for key in ("blur_floor_psnr", "sharp_psnr", "sharp_psnr_midcam"):
        if want[key] is None:      # the freeze arm renders the truth exactly: inf dB
            assert arm == "freeze" and key != "blur_floor_psnr" and got[key] is None, key
        else:
            assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    for key in ("traj_err_init", "traj_err_aligned_init", "traj_err", "traj_err_aligned"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=TRAJ_ATOL, err_msg=key)
    refined = got["sharp_psnr_pose_refined"], want["sharp_psnr_pose_refined"]
    if arm == "freeze":
        assert all(10 ** (-x / 10) <= REFINED_AT_TRUTH_MSE for x in refined), refined
    else:
        assert abs(refined[0] - refined[1]) <= REFINED_DB, refined
    for key in ("final_points", "overflow_steps", "nan_at", "iters", "n_cams", "n_sub", "size",
                "no_curve", "no_densify"):
        assert got[key] == want[key], key


def test_joint_run_densifies_and_rotates(tmp_path):
    """Eight joint iterations, two cameras a step: the densification at
    step 4 grows the points, the checkpoints at 2, 4, 6, 8 leave the
    newest two, and the report has JAX's keys."""
    report = str(tmp_path / "joint.json")
    rc = vbr.main(SMALL + ["--iters", "8", "--curve_start", "3", "--densify_from", "2",
                           "--densify_interval", "2", "--ckpt_every", "2",
                           "--cams_per_step", "2", "--backend", "xla", "--blur_scale", "0.5",
                           "--texture", "checker", "--device", "cpu", "--report", report])
    with open(report) as f:
        got = json.load(f)
    assert rc in (0, 1) and list(got) == JAX_KEYS and got["nan_at"] is None
    assert got["final_points"] > 60 + vbr.wall_side(vbr.parse_args(SMALL)) ** 2
    assert got["overflow_steps"] == 0 and got["sharp_psnr_pose_refined"] is None
    assert all(np.isfinite(got[k]) for k in ("sharp_psnr", "sharp_psnr_midcam", "traj_err",
                                              "traj_err_aligned", "blur_floor_psnr"))
    assert sorted(os.listdir(tmp_path)) == ["joint.json", "joint_ckpt_6.npz",
                                            "joint_ckpt_8.npz"]


@pytest.mark.parametrize("arm", [["--no_curve"], ["--init_true_curves", "--curve_lr_mult", "0",
                                                   "--init_noise", "0", "--curve_start", "1"]])
def test_calibration_arms(arm, tmp_path):
    """The no-curve arm leaves the curves at their start; the oracle's stay
    at the truth (aligned error 0 to rounding), through pose refinement."""
    report = str(tmp_path / "cal.json")
    rc = vbr.main(SMALL + arm + ["--iters", "3", "--pose_refine_iters", "2", "--device", "cpu",
                                 "--layout", "mixed", "--batched", "--report", report])
    with open(report) as f:
        got = json.load(f)
    assert rc in (0, 1) and got["nan_at"] is None
    assert got["traj_err"] == got["traj_err_init"]
    if "--init_true_curves" in arm:
        assert got["traj_err_init"] < 1e-6
    assert np.isfinite(got["sharp_psnr_pose_refined"])


def test_nan_guard(tmp_path, monkeypatch, capsys):
    """A state poisoned by the step aborts at the next check with code 2, a
    state dump beside the report and ``nan_at``; the metrics of the
    poisoned state are null, not an exception."""
    from deblurgs_tpu_torch.train import checkpoint as tckpt
    from deblurgs_tpu_torch.train import step as tstep

    real = tstep.train_step

    def poisoned(state, *a, **kw):
        state, metrics = real(state, *a, **kw)
        if state.step == 4:
            xyz = state.params.xyz.clone()
            xyz[0, 0] = float("nan")
            state = state._replace(params=state.params._replace(xyz=xyz))
        return state, metrics

    monkeypatch.setattr(tstep, "train_step", poisoned)
    report = str(tmp_path / "nan.json")
    rc = vbr.main(SMALL + ["--iters", "5", "--backend", "xla", "--device", "cpu",
                           "--pose_refine_iters", "2", "--report", report])
    with open(report) as f:
        got = json.load(f)
    assert rc == 2 and got["nan_at"] == 5 and list(got) == JAX_KEYS
    assert got["sharp_psnr"] is None and got["traj_err"] is not None
    assert got["sharp_psnr_pose_refined"] is None
    dump = tmp_path / "nan_nanstate_it5.npz"
    assert bool(torch.isnan(tckpt.load_checkpoint(str(dump), device="cpu").params.xyz[0, 0]))
    assert "VALIDATION ABORTED" in capsys.readouterr().out


def test_traj_error_nan_curve():
    args = vbr.parse_args(SMALL)
    truth = vbr.build_truth(args, vbr.make_draws(args), torch.device("cpu"))
    bad = truth.motion._replace(trans_ctrl=torch.full_like(truth.motion.trans_ctrl, np.nan))
    for align in (False, True):
        assert np.isnan(vbr.traj_error(bad, truth.motion, truth.mcfg, align_gauge=align))
        assert vbr.traj_error(truth.motion, truth.motion, truth.mcfg, align_gauge=align) < 1e-6


def _jax_run(name):
    with open(os.path.join(REPO, "runs", name)) as f:
        return json.load(f)


def test_protocol_verdicts_on_jax_runs():
    """The shell scripts' lines and verdicts on JAX's committed r5 reports,
    as their logs in ``runs/`` print them."""
    nocurve, oracle = _jax_run("r5_cal3b_nocurve.json"), _jax_run("r5_cal3b_oracle.json")
    joint = _jax_run("r5_jointb.json")
    lines, ok = rp.calibration(nocurve, oracle)
    assert ok and lines == ["floor 16.45 | nocurve 16.20 | oracle 17.22 | separation +1.02 dB",
                            "CAL3 SEPARATES (>= 1 dB): joint arm is justified"]
    lines, ok = rp.joint_verdict(nocurve, oracle, joint)
    assert not ok and lines == [
        "floor 16.45 | nocurve 16.20 | oracle 17.22 | joint 15.17",
        "separation +1.02 dB; joint closed -1.03 dB (-101% of separation)",
        "JOINT DID NOT MEET the 50%-closure criteria"]
    assert rp.best(joint) == joint["sharp_psnr_midcam"]


def test_protocol_runs_its_arms(tmp_path, monkeypatch, capsys):
    """The protocol at 32 px: each arm writes its report and log, the joint
    arm its state and newest two checkpoints, the checks print the shell
    scripts' lines; a second call runs no arm again."""
    own = {"nocurve": ["--no_curve"],
           "oracle": ["--batched", "--init_true_curves", "--curve_lr_mult", "0",
                      "--init_noise", "0", "--curve_start", "1"],
           "joint": ["--batched", "--curve_end_frac", "0.67", "--ckpt_every", "1"]}
    monkeypatch.setattr(rp, "ARMS", {
        name: (stem, SMALL + ["--iters", "3", "--pose_refine_iters", "1", "--texture",
                              "checker"] + own[name]) for name, (stem, _) in rp.ARMS.items()})
    rc = rp.main(["--out_dir", str(tmp_path), "--device", "cpu", "--seed", "1"])
    out = capsys.readouterr().out
    assert rc in (0, 4, 5) and "=== nocurve" in out and "=== joint" in out
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"torch_r5_{s}.{e}" for s in ("cal3b_nocurve", "cal3b_oracle", "jointb")
         for e in ("json", "log")]
        + ["torch_r5_jointb_state.npz", "torch_r5_jointb_state_ckpt_2.npz",
           "torch_r5_jointb_state_ckpt_3.npz"])
    reports = {n: json.load(open(tmp_path / f"{rp.ARMS[n][0]}.json")) for n in rp.ARMS}
    assert all(r["args"]["seed"] == 1 for r in reports.values())
    lines = rp.calibration(reports["nocurve"], reports["oracle"])[0] + rp.joint_verdict(
        reports["nocurve"], reports["oracle"], reports["joint"])[0]
    assert out.endswith("\n".join(lines) + "\n")
    assert rp.main(["--out_dir", str(tmp_path), "--device", "cpu"]) == rc
    assert "===" not in capsys.readouterr().out


def _flag_dict(tokens) -> dict:
    out, i = {}, 0
    while i < len(tokens):
        has_value = i + 1 < len(tokens) and not tokens[i + 1].startswith("--")
        out[tokens[i]] = tokens[i + 1] if has_value else True
        i += 2 if has_value else 1
    return out


def _shell(script, after, until="\n"):
    """The ``CAL`` flags of a shell script and the flags between ``after``
    and ``until``."""
    text = open(os.path.join(REPO, "scripts", script)).read().replace("\\\n", " ")
    cal = text.split('CAL="', 1)[1].split('"', 1)[0].replace("$((1<<21))", str(1 << 21))
    return _flag_dict(cal.split() + text.split(after, 1)[1].split(until, 1)[0].split())


def test_protocol_arms_are_the_shell_scripts():
    """Each arm's flags are the shell script's (its output paths aside)."""
    for name, script, after, until in (
            ("nocurve", "r5_cal3b.sh", "run_arm nocurve", "\n"),
            ("oracle", "r5_cal3b.sh", "run_arm oracle", "\n"),
            ("joint", "r5_jointb.sh", "validate_blur_recovery.py $CAL", "--save_state")):
        assert _flag_dict(rp.ARMS[name][1]) == _shell(script, after, until), name
