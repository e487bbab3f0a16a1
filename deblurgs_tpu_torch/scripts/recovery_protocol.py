"""The r5 deblurring protocol on the port: the calibration arms of
``scripts/r5_cal3b.sh`` and the joint arm of ``scripts/r5_jointb.sh``,
with their checks, in one command.

Scene (the ``CAL`` settings of both scripts): 256², 12 cameras, F = 21,
an edge-rich 3D checkerboard (0.5-world cells), 2.6 px splats, a ~42 px
sweep, the blurry truth from the model's own 21 sub-frames
(``--gt_oversample 1``). Arms:

- ``nocurve`` — a sharp 3DGS fit to the blurry photos (the baseline),
  12k iterations, 300 pose-refinement iterations a view;
- ``oracle`` — curves frozen at the truth (the ceiling), 12k iterations;
- ``joint`` — the paper's problem: curves from the nominal poses, the
  scene from noisy points, 8k iterations, curves frozen at 0.67.

Checks: the calibration separates (oracle − nocurve ≥ 1 dB); the joint arm
closes ≥ 50% of that separation, beats the blur floor, has no NaN abort
and an aligned trajectory error at most its aligned initial value. Each
arm's score is the best of its true-pose, learned-mid-camera and
pose-refined sharp PSNRs.

    python -m deblurgs_tpu_torch.scripts.recovery_protocol [--out_dir runs]
        [--arms nocurve,oracle,joint] [--device cuda] [--seed 0]

An arm whose report already exists in ``--out_dir`` is not run again, as
in the shell scripts. On JAX's own r5 scene (its draws committed as
``runs/r5_jax_draws.npz``; the arms' per-step draws stay torch's)::

    from deblurgs_tpu_torch.scripts import recovery_protocol, validate_blur_recovery
    draws = validate_blur_recovery.load_draws("runs/r5_jax_draws.npz")
    recovery_protocol.main(["--out_dir", "runs/torch_r5_jaxscene"], draws=draws)

Reports: ``torch_r5_cal3b_{nocurve,oracle}.json`` and
``torch_r5_jointb.json``, each with its log beside it; the joint arm's
final state ``torch_r5_jointb_state.npz`` (and its two newest
checkpoints). Exit code 0 when every check of the arms present passes; 2
on a NaN abort, 3 on a missing report, 4 when the calibration does not
separate, 5 when the joint arm does not meet its criteria.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

from deblurgs_tpu_torch.scripts import validate_blur_recovery as vbr

CAL = ["--size", "256", "--n_cams", "12", "--n_sub", "21", "--blur_scale", "0.8",
       "--true_scale", "0.05", "--gt_oversample", "1", "--texture", "checker",
       "--checker_cell", "0.5", "--max_pairs", str(1 << 21), "--tile", "32",
       "--layout", "mixed", "--capacity_mult", "8"]
CAL3B = CAL + ["--iters", "12000", "--pose_refine_iters", "300"]
ARMS = {
    "nocurve": ("torch_r5_cal3b_nocurve", CAL3B + ["--no_curve"]),
    "oracle": ("torch_r5_cal3b_oracle", CAL3B + ["--batched", "--init_true_curves",
                                                 "--curve_lr_mult", "0", "--init_noise", "0",
                                                 "--curve_start", "1"]),
    "joint": ("torch_r5_jointb", CAL + ["--iters", "8000", "--pose_refine_iters", "0",
                                        "--ckpt_every", "1000", "--batched",
                                        "--curve_end_frac", "0.67"]),
}
LOG_KEYS = ("floor", "FINAL", "criteria", "VALID", "!! non-finite")


def best(report: dict) -> float:
    """The arm's score: the best of its three sharp PSNRs."""
    return max(v for v in (report.get("sharp_psnr"), report.get("sharp_psnr_midcam"),
                           report.get("sharp_psnr_pose_refined")) if v is not None)


def calibration(nocurve: dict, oracle: dict) -> tuple[list, bool]:
    """``r5_cal3b.sh``'s check: (printed lines, separates)."""
    base, orc = best(nocurve), best(oracle)
    sep = orc - base
    ok = sep >= 1.0
    return ([f"floor {nocurve['blur_floor_psnr']:.2f} | nocurve {base:.2f} | oracle {orc:.2f} "
             f"| separation {sep:+.2f} dB",
             "CAL3 SEPARATES (>= 1 dB): joint arm is justified" if ok else
             "CAL3 DOES NOT SEPARATE (rc=4): redesign before the joint arm"], ok)


def joint_verdict(nocurve: dict, oracle: dict, joint: dict) -> tuple[list, bool]:
    """``r5_jointb.sh``'s check: (printed lines, passed)."""
    base, orc, score = best(nocurve), best(oracle), best(joint)
    sep, closed = orc - base, score - base
    floor = joint["blur_floor_psnr"]
    ok = (joint.get("nan_at") is None and closed >= 0.5 * sep and score > floor
          and (joint["traj_err_aligned"] or 9e9) <= (joint["traj_err_aligned_init"] or 0))
    return ([f"floor {floor:.2f} | nocurve {base:.2f} | oracle {orc:.2f} | joint {score:.2f}",
             f"separation {sep:+.2f} dB; joint closed {closed:+.2f} dB "
             f"({100 * closed / max(sep, 1e-9):.0f}% of separation)",
             "JOINT " + ("PASSED" if ok else "DID NOT MEET the 50%-closure criteria")], ok)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not measured (no nvidia-smi)"


def run_arm(name: str, out_dir: str, device: str, seed: int, draws: dict | None = None) -> int:
    """Run one arm into ``out_dir`` (its output into the arm's log) on
    ``draws`` (default: the arm's own from ``seed``); print the log's
    summary lines and the arm's seconds. Returns the arm's exit code, or 3
    when it wrote no report."""
    stem, flags = ARMS[name]
    report = os.path.join(out_dir, stem + ".json")
    flags = flags + ["--report", report, "--device", device, "--seed", str(seed)]
    if name == "joint":
        flags += ["--save_state", os.path.join(out_dir, stem + "_state.npz")]
    log = os.path.join(out_dir, stem + ".log")
    print(f"=== {name}", flush=True)
    t0 = time.time()
    with open(log, "w") as fp, contextlib.redirect_stdout(fp):
        rc = vbr.main(flags, draws=draws)
    seconds = time.time() - t0
    with open(log) as fp:
        for line in [ln.rstrip() for ln in fp if any(k in ln for k in LOG_KEYS)][-4:]:
            print(line)
    print(f"arm {name}: rc {rc}, {seconds:.1f} s", flush=True)
    if not os.path.exists(report):
        print(f"ARM {name} FAILED: no report written (rc={rc})")
        return 3
    if rc == 2:
        print(f"ARM {name} ABORTED on non-finite state (rc=2)")
    return rc


def main(argv=None, draws: dict | None = None) -> int:
    """Run the arms and their checks; ``draws`` (as
    ``validate_blur_recovery.load_draws`` returns them) replaces every arm's
    own scene draws."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", type=str, default="runs")
    ap.add_argument("--arms", type=str, default="nocurve,oracle,joint",
                    help="the arms to run, in this order (comma-separated)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="the scene's and the runs' draws")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    print(card(), flush=True)
    for name in args.arms.split(","):
        if name not in ARMS:
            raise SystemExit(f"unknown arm {name!r} (expected one of {sorted(ARMS)})")
        if os.path.exists(os.path.join(args.out_dir, ARMS[name][0] + ".json")):
            continue
        rc = run_arm(name, args.out_dir, args.device, args.seed, draws)
        if rc in (2, 3):
            return rc
    reports = {}
    for name, (stem, _) in ARMS.items():
        path = os.path.join(args.out_dir, stem + ".json")
        if os.path.exists(path):
            with open(path) as fp:
                reports[name] = json.load(fp)
    if "nocurve" not in reports or "oracle" not in reports:
        print("missing a calibration report: the checks need both")
        return 3
    lines, separates = calibration(reports["nocurve"], reports["oracle"])
    print("\n".join(lines))
    if "joint" not in reports:
        return 0 if separates else 4
    lines, passed = joint_verdict(reports["nocurve"], reports["oracle"], reports["joint"])
    print("\n".join(lines), flush=True)
    return 5 if not passed else (0 if separates else 4)


if __name__ == "__main__":
    sys.exit(main())
