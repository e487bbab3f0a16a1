#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``deblurgs_tpu_torch/csrc``
(nvcc, sm_90a, into ``build/``), then:

1. env        card name and power limit, torch / CUDA / nvcc versions, TF32 off;
2. build      compiles the kernel library and reports each kernel's registers;
3. parity     each kernel against its plain PyTorch version on the card at a
              mid size (256×256, 4k Gaussians, F = 3, tile 32 and 16): K3
              and K1 bit for bit, n_con included, for need_n_contrib on and
              off and for ``fast``;
4. slice      the blurry render at full width (1920×1080, 100k Gaussians,
              SH degree 2, one order-9 se3 curve, F = 21, tile 32): the
              batched composition of the training step (subframe_cameras →
              one render_batch → mean) and the user-facing ``blur.query``
              (21 renders), with every launch counter zeroed just before and
              read just after; a per-stage breakdown by CUDA events; K3
              held bitwise against its plain version, K1 bitwise against
              its plain version on 64 sampled tiles, and the batched blur
              against the query's mean of 21 renders;
5. trained    ``runs/r5_jointb_state.npz`` at 256×256: camera 0's blurry
              observation and its sharp mid-trajectory view, kernel path
              against plain path, and K1 bitwise against its plain version;
6. train_parity  the backward kernels on the parity scene: K2 against its
              plain version bit for bit (default and ``fast``), K4 on the main
              path (the staging's runs, sums to original rows) and by rank
              array against float64 sums, ``blend_fused``'s autograd gradients
              with the kernels against the same gradients through the plain
              versions, and two calls of each compared bitwise;
7. train      one DeblurGS train step at full width (1920×1080, 100k
              Gaussians seeded from ``bench.py``'s point-cloud distribution,
              SH 2, F = 21, order-9 se3 curve, tile 32, batched render, tile
              cull on, curve on from step 1, step 100, densify and reset
              pushed out): two warm-up steps and five timed steps with the
              launch counters zeroed just before and read just after, a
              breakdown (forward stages, losses, K2, K4, the autograd rest,
              Adam and stats), peak memory and the device busy share; K2
              against its plain version bit for bit on 64 sampled tiles and
              K4 over all slots, with the step's own image cotangent;
8. train_trained  ``runs/r5_jointb_state.npz`` loaded whole (Adam moments
              included) at 256×256, F = 21: one step whose step number fires
              densify_and_prune, and K2 (bit for bit, every tile) and K4
              against their plain versions on its deep tile lists;
9. train_lockstep  ``train_step`` with ``layout="lockstep"`` and
              ``batched_render=False`` on the parity scene: two steps through
              K5, K6 and K4 per sub-frame, the first against the plain path;
10. lockstep_parity  K5 and K6 (K1's and K2's kernels on one view's tiles)
              against their plain versions on one view of the parity scene,
              bit for bit (tile 16 and 32, need_n_contrib on and off), K5
              against K1 and K6 against K2 on the same list, two K6 calls
              equal;
11. eval      held-out evaluation at full width (1920×1080, 100k Gaussians,
              SH 2, lockstep, tile 16): a synthetic run written with the
              port's writers, ``cli.evaluate.main`` on it and
              ``optimize_test_poses`` (30 iterations a view) with the launch
              counters zeroed just before and read just after; the pair
              budget, the pose-fit criterion, ``render_view`` times, the
              pose step timed through ``optimize_test_poses`` (and a copy of
              its step timed in parts), and K5/K6 against their plain
              versions on 64 tiles;
12. yardstick each kernel timed beside its plain version, its bound and, for
              K3 and K4, the one PyTorch call that computes the same function;
              K1 also at tile 16 on the slice's scene; at the train step's
              lists K1, K2, K3 and K4, K1 and K2 with ptxas's registers and
              their pair loops' SASS counts, K1's (warp, pair) visits under
              its schedule and the one before it (``forward_schedule``, its
              outputs held bitwise to the kernel's) and the issue rate they
              need at the SM clock sampled meanwhile, each redesigned kernel's
              time before its redesign (and K1's and K2's after each design
              move, as recorded), and beside their times before this
              design's cull (as recorded); K5 and K6 at the
              eval phase's shapes beside their times before the redesign,
              with K1 and K2 on the same lists without the warp cull, K2 in
              its other layout, the (warp, pair) visits the cull skips (and
              a check that none of them composites), the longest list's
              block alone, and K6's registers and SASS pair loop;
13. train_cli the training run as a user starts it, at full width: the eval
              phase's synthetic scene (1920×1080, six training views, two
              held out) with ``bench.py``'s 100k Gaussians as its point
              cloud, ``cli.train.main`` at its defaults (pallas, mixed, tile
              32, batched render, F = 21, order-9 se3 curves, SH 2,
              ``max_pairs`` autosized, the visualizer and the final render's
              child processes on; ``-r 1`` keeps 1920×1080) for 40
              iterations with a densify event, the launch counters zeroed
              just before and read just after; a resume from its
              checkpoint, ``cli.evaluate.main`` and ``cli.metrics.main`` on
              the run (a render past the session's budget must be
              rendered again at one that holds it; the children's budget
              growths are read from their output); then 20 more blur-phase
              iterations of ``Trainer.train`` timed with CUDA events at each
              drain, and 10 more, not timed, with their host syncs counted
              under ``torch.cuda.set_sync_debug_mode("warn")``; the bare
              step on the same state at the loop's budget and at the emitted
              pairs + 10%, each with its forward stages; K1-K4 against their
              plain versions on one step's inputs at the loop's budget (K3
              and K4 in full, K1 and K2 on 64 sampled tiles); launches a
              step, peak memory and each stage's seconds.
14. backends  the xla and oracle backends and the native host library:
              (a) the eval phase's run, whose ``cfg_args`` has no
              ``backend`` key, through ``cli.evaluate.main`` (2 pose
              iterations a view) and ``cli.render_trainview.main`` without
              ``--backend`` (xla: every launch counter must stay 0, a
              render past ``k_max`` must be rendered again), the xla image
              against K5's on one held-out view, ``render_view`` on both,
              the xla pose step, and the walk forward and backward beside
              K5 and K6 on that view's lists; (d) the native library built
              and loaded, its exact 3-NN of the train phase's 100k points
              against the on-card exact search, and ``points3D.bin`` of the
              eval scene's 100k Gaussians parsed bit for bit as the Python
              reader does; (c) at 128×96 with 2,000 Gaussians, xla,
              pallas/mixed and pallas/lockstep against the oracle (images
              atol 1e-5 / rtol 1e-4, gradients 2e-5 scaled), every kernel
              counted; (b) one xla train step at the train phase's point
              (per-view renders, a one-view pair budget, ``k_max`` the next
              power of two over the longest list) against the pallas
              per-view step from the same state and draws (loss 1e-5
              relative; each gradient within max(2e-4, 4× the spread of a
              second xla step) scaled; the updated leaves reported), both
              xla steps timed.
15. parallel  ``parallel/`` at the train phase's operating point (2^17 slots):
              (a) the step on a NCCL group of one rank, bit for bit the
              plain step (loss, gradients, new state), both timed; then four
              spawned ranks sharing the card over gloo (every collective
              staged through host memory and counted; which collectives gloo
              takes on CUDA tensors is probed first): (b) the sub-frames over
              3 ranks of 7 views against the plain step (loss 1e-4 relative,
              gradients within max(2e-5, 4× a rerun's spread) scaled), each
              rank's K1 and K2 bit for bit on 16 sampled tiles of its block,
              its launches, step ms and peak; (c) one view in 4 row slabs
              against the whole render (image 2e-4, radii and visible equal,
              gradients 2e-4 scaled); (d) the Gaussian axis over 2 ranks of
              2^16 slots against the plain step; (e) the eval scene's 8
              cameras, each rank decoding its block and every camera
              broadcast to every rank bit for bit. Bytes each collective
              moves a step.
16. recovery  ``scripts/validate_blur_recovery.main``'s joint arm at the r5
              protocol's width (256², 12 cameras, F = 21, the checker
              scene, 1,200 points in 9,600 slots, batched mixed training,
              lockstep evaluation): 640 iterations (curves from 100, one
              densification at 400), 30 pose-refinement iterations a view,
              checkpoints every 200, with the launch counters zeroed just
              before and read just after; its exit code (0 or 1), JAX's
              report keys, finite numbers, no overflowed step, a
              densification that cloned or split Gaussians and changed the
              point count, the newest two checkpoints kept; then K1-K4 on one train step of the final
              state and K5, K6 on one refinement step against their plain
              versions, every tile, bit for bit.
17. r5_jax_scene  the r5 protocol's scene from JAX's own draws
              (``runs/r5_jax_draws.npz``) at the joint arm's arguments,
              synthesised through ``EvalRenderer``, and JAX's trained joint
              state (``runs/r5_jointb_state.npz``) evaluated by
              ``evaluate_state``, the launch counters zeroed just before and
              read just after: the blur floor within 1e-3 dB, the state's
              sharp PSNRs within 1e-2 dB and the four trajectory errors within
              rtol 1e-5 + atol 2e-6 of JAX's report (``runs/r5_jointb.json``),
              each gap on its own line; K3, K1 and K5 on one view of the state
              against their plain versions, bit for bit.

Each phase prints one JSON line; any failure raises. The line before the
last lists every ported kernel; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA card or without the package beside this script.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
EVAL_OPS = 12                 # f32 ops every (pixel, pair) gate evaluation
                              # needs: dx, dy, the 9-op power, the compare
# (width, height, Gaussians) of each phase's scene
PARITY_SIZE = (256, 256, 4000)
SLICE_SIZE = (1920, 1080, 100_000)
TRAINED_SIZE = 256
TRAIN_SIZE = (1920, 1080, 100_000)
EVAL_SIZE = (1920, 1080, 100_000)
ORACLE_SIZE = (128, 96, 2000)   # the backends phase's oracle anchor
EVAL_CAMERAS, EVAL_HOLD = 8, 4   # views 000 and 004 held out (llffhold 4)
POSE_TIMED_ITERS = 10         # iterations a view in each timed optimize_test_poses
GRAD_ATOL = 2e-5              # |got - want| / max|want| for gradients
# the train step's K2 and K4 (with its sort and scatter) before their
# redesign, on an H100 80GB HBM3 at 700 W (PERF.md's kernel table)
K2_PREVIOUS_MS, K4_PREVIOUS_MS = 49.77, 14.14
# K1 and K3 before their redesign, on the same card (PERF.md's kernel table)
K1_PREVIOUS_MS = {"slice": 6.19, "train_lists": 15.64}
K3_PREVIOUS_MS = 0.718        # slice
# K3 after its redesign (PR 6's run on the same card, PERF.md's kernel
# table): writing 0 rather than NaN for a rank out of range must not move it
K3_PR6_MS = {"slice": 0.232, "train_lists": 1.879}
# K1 on the same card after each design move of its redesign, as a harness
# beside this script's yardstick timed them while the moves were kernel
# variants (since folded into the one design; PERF.md's Findings):
# ms on the train step's lists at step 110 (the yardstick's), at step 100
# (before any step) and on the slice; None where that list was not timed
K1_DESIGN_MOVES_MS = {
    "the kernel before the redesign": (15.63, 30.20, 6.19),
    "warp patches, hoisted dx terms": (None, 28.26, 5.57),
    "+ per-warp exit": (None, 28.10, 5.82),
    "+ pair-major 16 B staging": (None, 27.00, 5.57),
    "+ branch-free pixels": (None, 24.91, 6.25),
    "+ NEED_N template": (12.49, 24.27, 6.09),
    "+ five blocks an SM": (12.00, 23.32, 5.86),
    "+ frozen flags in a bit mask": (11.97, 23.28, 5.85),
    "+ a vote every second pair": (11.67, 22.66, 5.70),
    "+ frozen as an infinite alpha threshold (the design)": (11.36, 22.04, 5.54),
    "dropped: branchy pixels": (13.84, 26.37, 5.51),
    "dropped: skip the accumulation where a warp composites nothing": (13.56, 25.92, 5.65),
    "dropped: branch-free without the exit": (14.82, 28.72, 5.68),
    "dropped: six blocks an SM": (12.77, 24.81, 6.25),
    "dropped: 8 pixels a thread, 128 threads": (11.36, 22.09, 5.51),
}
# <4 px, patches, exact, no n_con, no cull>
K1_MAIN_ENTRY = "forward_mixed_kernelILi4ELb1ELb0ELb0ELb0E"
K1_PAIRS_PER_LOOP = 2         # K1's pair loop walks two pairs an iteration
SM_ISSUE_PER_CLOCK = 4        # warp instructions an SM issues a cycle (four schedulers)
# K2 on the same card after each design move of its redesign, as this
# script's yardstick timed them while the moves were kernel variants (they
# were folded into the one design since; PERF.md's Findings, PR 4)
K2_DESIGN_MOVES_MS = {"patches, moments, fused total, slot-major rows": 35.88,
                      "+ warp cull": 41.57, "+ per-warp exit": 42.03,
                      "+ composited-pair record": 41.33, "+ reduce-scatter": 39.48,
                      "+ three blocks an SM": 33.63, "+ branch-free pixels": 33.31,
                      "without cull and record (the design)": 32.06}
K2_MAIN_ENTRY = "backward_mixed_kernelILb1ELb0ELb0E"   # <patches, exact, no cull>
# K1 and K2 on the train step's lists before the warp cull was added, on the
# same card (PERF.md's kernel table): the main path must not move
K1_NO_CULL_TREE_MS, K2_NO_CULL_TREE_MS = 11.443, 32.52
# K5 and K6 before their redesign, on the eval phase's lists on the same card
# (PERF.md's kernel table)
K5_PREVIOUS_MS, K6_PREVIOUS_MS = 0.269, 1.104
K6_ENTRY = "backward_mixed_kernelILb1ELb0ELb1E"       # <patches, exact, cull>
# K5 and K6 on the eval phase's lists on the same card after each design move
# of their redesign, as this script's yardstick timed them while the moves
# were in the tree (PERF.md's Findings)
K5_DESIGN_MOVES_MS = {"K1's kernel, one pixel a thread in 16×2 patches": 0.2269,
                      "+ warp cull, the box tested before each visit": 0.2067}
K6_DESIGN_MOVES_MS = {"K2's kernel in K1's layout, one pixel a thread, 8 warps": 0.7561,
                      "+ warp cull, the box tested before each visit (8 warps)": 0.5905,
                      "four pixels a thread, one warp a 16×8 patch (2 warps)": 0.5566,
                      "+ warp cull, the box tested before each visit (2 warps)": 0.4926}


def emit(phase: str, **fields) -> None:
    """One JSON line in one write: the parallel phase's ranks share stdout."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (json.dumps({"phase": phase, **fields}) + "\n").encode())


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_err(a, b) -> float:
    """max |a - b|, the difference taken in float64 a slab of ~2^24
    elements at a time along the longest axis: a float64 copy of a whole
    2^27-slot table would not fit beside the training run's tensors."""
    import torch

    a, b = torch.broadcast_tensors(a, b)
    if a.dim() == 0 or a.numel() == 0:
        return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    dim = max(range(a.dim()), key=lambda d: a.shape[d])
    n = a.shape[dim]
    step = max(1, (1 << 24) * n // a.numel())
    return max(float((a.narrow(dim, i, min(step, n - i)).double()
                      - b.narrow(dim, i, min(step, n - i)).double()).abs().max())
               for i in range(0, n, step))


def check_close(name: str, got, want, atol: float, rtol: float = 0.0) -> float:
    import torch

    err = max_err(got, want)
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: max |diff| {err:.3e} exceeds atol {atol} rtol {rtol}")
    return err


def check_k3(torch, where: str, fslot, c) -> float:
    """K3's output against its plain version ``ctable[gauss_c].T``: they
    must be bitwise equal. Returns the max |diff| (0.0)."""
    from deblurgs_tpu_torch.ops import cuda_blend

    want = cuda_blend.broadcast_fields_ref(c.ctable, c.gauss_c)
    err = max_err(fslot, want)
    if not torch.equal(fslot, want):
        raise AssertionError(f"K3 {where}: differs from ctable[gauss_c].T "
                             f"(max |diff| {err:.3e})")
    return err


def check_k1(torch, where: str, bcfg, staged, got, tiles=None) -> float:
    """K1's outputs against its plain version (on ``tiles`` or all): bit
    for bit, n_con included. Returns the max |diff| (0.0)."""
    from deblurgs_tpu_torch.ops import cuda_blend_mixed as cbm

    want = cbm.forward_ref(bcfg, staged.fields, staged.tile_start, staged.tile_stop,
                           tiles=tiles)
    if tiles is not None:
        got = tuple(g[tiles] for g in got)
    for name, g, w in zip(("C", "D", "final_T", "n_con"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"K1 {where}: {name} differs from the plain version "
                                 f"(max |diff| {max_err(g, w):.3e})")
    return max(max_err(g, w) for g, w in zip(got[:3], want[:3]))


def ptxas_report(log: str, kernel: str) -> list:
    """Registers, shared memory and spills ptxas reported for each
    instantiation of ``kernel`` in the build log."""
    import re

    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if kernel in line else None
            spill = {}
        elif entry and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            spill = {kind: int(n) for n, kind in nums}
        elif entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append({"entry": entry, "registers": int(regs.group(1)) if regs else None,
                        "smem_bytes": int(smem.group(1)) if smem else 0,
                        "spill_stores": spill.get("stores"), "spill_loads": spill.get("loads")})
            entry = None
    return out


def sass_pair_loop(source: str, entry: str, load: str = "LDS.128") -> dict:
    """Instruction counts of a kernel's pair loop from ``cuobjdump -sass`` of
    its object in ``build/`` (``source``: the object's stem, e.g.
    ``backward_mixed``; ``entry``: a fragment of the instantiation's
    mangled name)."""
    import glob

    from deblurgs_tpu_torch.ops import kernels

    objs = glob.glob(os.path.join(kernels.BUILD, f"{source}_*.o"))
    if not objs:
        return {"not_measured": "no object"}
    return sass_loop_counts(max(objs, key=os.path.getmtime), entry, load)


def sass_loop_counts(obj: str, entry: str, load: str = "LDS.128") -> dict:
    """The innermost loop around the first ``load`` (the staged pair's
    first shared-memory read) of the function whose mangled name holds
    ``entry`` in the object ``obj``: its instruction count, split at its
    first shuffle (where it has one) into the pixels' part and the
    reduction's, and the most frequent opcodes of the pixels' part."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"not_measured": "no cuobjdump"}
    sass = subprocess.run([tool, "-sass", obj], capture_output=True, text=True,
                          timeout=120).stdout
    funcs = dict(re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S))
    body = next(b for name, b in funcs.items() if entry in name)
    ins = [(int(a, 16), op) for a, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body)]
    lds = next(a for a, op in ins if op.startswith(load))
    back = [(int(t, 16), a) for a, t in
            ((int(a, 16), t) for a, t in re.findall(
                r"/\*([0-9a-f]{4,})\*/[^\n]*?BRA (?:!?U?P\d, )?0x([0-9a-f]+)", body))
            if int(t, 16) <= lds < a]
    top, end = max(back)
    loop = [(a, op) for a, op in ins if top <= a <= end]
    shfl = next((a for a, op in loop if op.startswith("SHFL")), end + 1)
    pixels = [op.split(".")[0] for a, op in loop if a < shfl]
    hist = {}
    for op in pixels:
        hist[op] = hist.get(op, 0) + 1
    return {"function_instructions": len(ins),
            "pair_loop_instructions": len(loop), "pixels_part": len(pixels),
            "reduction_part": len(loop) - len(pixels),
            "pixels_part_ops": dict(sorted(hist.items(), key=lambda kv: -kv[1])[:10])}


def scaled_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return max_err(got, want) / (float(want.abs().max()) or 1.0)


def check_scaled(name: str, got, want, atol: float = GRAD_ATOL) -> float:
    err = scaled_err(got, want)
    if not err <= atol:
        raise AssertionError(f"{name}: max |diff| / max |want| = {err:.3e} exceeds {atol}")
    return err


def tile_slots(torch, staged, tiles):
    """The slot indices of the given stacked tiles' pair ranges."""
    return torch.cat([torch.arange(int(staged.tile_start[t]), int(staged.tile_stop[t]),
                                   device=staged.fields.device) for t in tiles.tolist()])


def check_k2(torch, where: str, bcfg, staged, bg, T, dl_pix, dl_d, C, D, got, tiles=None):
    """K2's per-slot gradients against its plain version (on ``tiles`` or
    all): rows 0-9 bit for bit (the warp cull must change nothing), rows
    10-15 zero. Returns (largest scaled error, largest absolute error)."""
    from deblurgs_tpu_torch.ops import cuda_blend_mixed as cbm

    total = cbm.backward_total(bcfg, bg, T, dl_pix, dl_d, C, D)
    want = cbm.backward_ref(bcfg, staged.fields, staged.tile_start, staged.tile_stop, dl_pix,
                            dl_d, total, tiles=tiles)
    if tiles is not None:
        slots = tile_slots(torch, staged, tiles)
        got, want = got[:, slots], want[:, slots]
    if not bool((got[10:] == 0).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K2 {where}: rows 10-15 not zero or non-finite output")
    if not torch.equal(got[:10], want[:10]):
        raise AssertionError(f"K2 {where}: differs from the plain version "
                             f"(max |diff| {max_err(got, want):.3e})")
    return (max(check_scaled(f"K2 {where} row {r}", got[r], want[r]) for r in range(10)),
            max_err(got, want))


def rows_by_rank_ref(torch, staged, pair_grads, P: int):
    """The per-Gaussian sums without the staging's runs: the float64 segment
    sum by sorted rank ``s_gc`` (K4's plain version by rank array), then
    the scatter to original rows through ``ids`` on the emitting ranks."""
    from deblurgs_tpu_torch.ops import cuda_blend

    sums = cuda_blend.reduce_sorted_ref(pair_grads, staged.s_gc, P)
    ids_u = torch.where(torch.arange(P, device=sums.device) < staged.n_emit, staged.ids, P)
    out = torch.zeros((P + 1, 16), dtype=sums.dtype, device=sums.device)
    out[ids_u] = sums
    return out[:P]


def check_k4(torch, where: str, staged, pair_grads, P: int):
    """K4 on the main path (``reduce_pair_grads``: the staging's runs, sums
    written to original rows) against the float64 sums by rank array
    scattered to rows, and K4 by rank array (``reduce_sorted``) against its
    float64 plain version, column by column; two calls of each bitwise
    equal. Returns (largest scaled error, largest absolute error)."""
    from deblurgs_tpu_torch.ops import cuda_blend

    cases = ((lambda: cuda_blend.reduce_pair_grads(staged, pair_grads, P),
              rows_by_rank_ref(torch, staged, pair_grads, P), "main path"),
             (lambda: cuda_blend.reduce_sorted(pair_grads, staged.s_gc, P),
              cuda_blend.reduce_sorted_ref(pair_grads, staged.s_gc, P), "by rank array"))
    scaled, absolute = 0.0, 0.0
    for run, want, path in cases:
        got = run()
        if not bool((got[:, 10:] == 0).all()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K4 {where} {path}: columns 10-15 not zero or non-finite")
        if not torch.equal(got, run()):
            raise AssertionError(f"K4 {where} {path}: two calls differ")
        scaled = max([scaled] + [check_scaled(f"K4 {where} {path} col {c}", got[:, c],
                                              want[:, c]) for c in range(10)])
        absolute = max(absolute, max_err(got, want))
    return scaled, absolute


def make_scene(n: int, sh_degree: int, rng: np.random.Generator, device):
    """bench.py's synthetic scene as raw Gaussian leaves, seeded with numpy."""
    import torch

    from deblurgs_tpu_torch.models.gaussians import GaussianConfig, GaussianModel

    k = (sh_degree + 1) ** 2
    q = rng.standard_normal((n, 4))
    leaves = dict(
        xyz=rng.standard_normal((n, 3)) * 2.0,
        scaling=rng.uniform(math.log(0.004), math.log(0.04), (n, 3)),
        rotation=q / np.linalg.norm(q, axis=-1, keepdims=True),
        opacity=rng.uniform(0.1, 0.95, (n, 1)),
        f_dc=rng.standard_normal((n, 1, 3)) * 0.3,
        f_rest=rng.standard_normal((n, k - 1, 3)) * 0.3,
    )
    leaves = {key: torch.as_tensor(v, dtype=torch.float32, device=device)
              for key, v in leaves.items()}
    return GaussianModel(GaussianConfig(sh_degree=sh_degree), **leaves)


def camera(width: int, height: int, fovx: float, device):
    """(CameraStatic, row-vector projection) of a camera with horizontal
    field of view ``fovx`` and square pixels, near/far 0.01/100."""
    from deblurgs_tpu_torch.core.camera import CameraStatic, get_projection_matrix

    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    cs = CameraStatic(width=width, height=height, tanfovx=math.tan(fovx / 2),
                      tanfovy=math.tan(fovy / 2))
    return cs, get_projection_matrix(cs.znear, cs.zfar, fovx, fovy, device=device)


def size_max_pairs(gaussians, cams, cs, rcfg, active=None) -> int:
    """Two-pass pair capacity (bench.py): the emitted pairs of all views,
    +10%, rounded up to 1024. ``gaussians``: a GaussianModel, or a
    (render-inputs dict, SH degree) pair."""
    total = int(flat_preprocess(gaussians, cams, cs, rcfg, active)[-1].sum())
    return max((int(total * 1.1) + 1023) & ~1023, 1 << 14)


def flat_preprocess(gaussians, cams, cs, rcfg, active=None):
    """render_batch's first stage: the preprocess outputs of all views,
    flattened onto one Gaussian axis. ``gaussians``: a GaussianModel, or a
    (render-inputs dict, SH degree) pair."""
    from deblurgs_tpu_torch.ops import rasterize

    if isinstance(gaussians, tuple):
        rin, sh_degree = gaussians
    else:
        rin, sh_degree = gaussians.render_inputs(), gaussians.cfg.sh_degree
    pre = rasterize._preprocess(rin["means3d"], rin["scales"], rin["rotations"],
                                rin["opacities"], rin["shs"], cams, cs, rcfg,
                                sh_degree, None, active, None)
    n = cams.view.shape[0] * rin["means3d"].shape[0]
    return [x.reshape((n,) + x.shape[2:]) for x in (
        pre.means2d, pre.conic, pre.opacity, pre.color, pre.depth, pre.rect,
        pre.tiles_touched)]


def plain_blend(bcfg, flat, bg):
    """The compositing path with each kernel replaced by its plain PyTorch
    version, on whatever device ``flat`` lives on."""
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed, tile_blend

    c = cuda_blend.compact_table(bcfg, *flat, bcfg.max_pairs)
    st = cuda_blend.sort_slots(bcfg, cuda_blend.broadcast_fields_ref(c.ctable, c.gauss_c), c)
    out = cuda_blend_mixed.forward_ref(bcfg, st.fields, st.tile_start, st.tile_stop)
    return tile_blend.compose(bcfg, *out, bg)


def kernel_blend(bcfg, flat, bg):
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed, tile_blend

    st = cuda_blend.sort_stage(bcfg, *flat, bcfg.max_pairs)
    return tile_blend.compose(bcfg, *cuda_blend_mixed.forward_mixed(bcfg, st), bg)


def device_profile(torch, fn, top: int = 12, calls: int = 1) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler: the device kernels
    that take the most time, every sort kernel (``sorts``), and the
    device's busy share of the calls' wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:       # operators; keep kernels
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {"wall_us": round(wall_us, 1), "device_busy_us": round(busy_us, 1),
            "busy_share": round(busy_us / wall_us, 4) if wall_us else None,
            "top": [{"kernel": k[:90], "us": round(us, 1), "calls": n}
                    for us, k, n in rows[:top]],
            "sorts": [{"kernel": k[:200], "us": round(us, 1), "calls": n}
                      for us, k, n in rows if "Sort" in k]}


def zero_counts() -> None:
    from deblurgs_tpu_torch.utils import profiling

    profiling.reset_counters()


def read_counts() -> dict:
    from deblurgs_tpu_torch.utils import profiling

    c = profiling.counters()
    return {k: c.get(f"kernel.{k}", 0) for k in ("K3", "K1", "K2", "K4", "K5", "K6")}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from deblurgs_tpu_torch.device import resolve_device
    from deblurgs_tpu_torch.ops.kernels import _nvcc

    dev = resolve_device("cuda")
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], nvcc=nvcc.stdout.strip().splitlines()[-1],
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off")
    return dev, card


def phase_build():
    from deblurgs_tpu_torch.ops import kernels

    lib = kernels.load_library()
    regs = [line.strip() for line in lib.ptxas_log.splitlines()
            if "registers" in line or "Compiling entry" in line]
    emit("build", seconds=round(lib.build_seconds, 3), library=os.path.relpath(lib.path, REPO),
         ptxas=regs)


def phase_parity(torch, dev):
    from deblurgs_tpu_torch.models import motion as motion_lib
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig

    W, H, N = PARITY_SIZE
    rng = np.random.default_rng(SEED + 1)
    gaussians = make_scene(N, 2, rng, dev)
    cs, proj = camera(W, H, 1.2, dev)
    motion = motion_lib.init_motion(
        torch.eye(3, device=dev)[None], torch.tensor([[0.0, 0.0, -6.0]], device=dev),
        motion_lib.MotionConfig(curve_order=9, n_subframes=3),
        torch.Generator(device=dev).manual_seed(SEED), init_noise=0.01)
    cams = motion_lib.subframe_cameras(motion, 0, motion_lib.sample_nu(motion, 0), proj)
    errs, k3_err = {}, 0.0
    for name, tile, kw in (("n_contrib", 32, dict(need_n_contrib=True)),
                           ("plain", 32, dict(need_n_contrib=False)),
                           ("fast", 32, dict(need_n_contrib=False, fast=True)),
                           ("t16_n_contrib", 16, dict(need_n_contrib=True)),
                           ("t16", 16, dict(need_n_contrib=False))):
        rcfg = RasterizeConfig(tile_w=tile, tile_h=tile, max_pairs=1 << 17, **kw)
        bcfg = rcfg.blend_config(cs, n_images=3)
        flat = flat_preprocess(gaussians, cams, cs, rcfg)
        c = cuda_blend.compact_table(bcfg, *flat, bcfg.max_pairs)
        fslot = cuda_blend.broadcast_fields(c.ctable, c.gauss_c)
        k3_err = max(k3_err, check_k3(torch, f"parity {name}", fslot, c))
        st = cuda_blend.sort_slots(bcfg, fslot, c)
        if int(st.total) > bcfg.max_pairs:
            raise AssertionError("parity scene overflows its pair budget")
        got = cuda_blend_mixed.forward_mixed(bcfg, st)
        torch.cuda.synchronize()
        errs[name] = {"K1": check_k1(torch, f"parity {name}", bcfg, st, got),
                      "pairs": int(st.total)}
    emit("parity", K3=k3_err, K1=errs)
    return errs, k3_err


def phase_slice(torch, dev):
    from deblurgs_tpu_torch.models import blur
    from deblurgs_tpu_torch.models import motion as motion_lib
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed, rasterize, tile_blend
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig

    (W, H, N), F = SLICE_SIZE, 21
    rng = np.random.default_rng(SEED)
    gaussians = make_scene(N, 2, rng, dev)
    cs, proj = camera(W, H, 1.2, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    motion = motion_lib.init_motion(
        torch.eye(3, device=dev)[None], torch.tensor([[0.0, 0.0, -6.0]], device=dev),
        motion_lib.MotionConfig(curve_order=9, n_subframes=F), gen)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    probe = RasterizeConfig(tile_w=32, tile_h=32, need_n_contrib=False)
    nu = motion_lib.sample_nu(motion, 0)
    cams = motion_lib.subframe_cameras(motion, 0, nu, proj)
    max_pairs = size_max_pairs(gaussians, cams, cs, probe)
    rcfg = RasterizeConfig(tile_w=32, tile_h=32, need_n_contrib=False, max_pairs=max_pairs)
    # one view's budget for the per-sub-frame renders of blur.query
    view_pairs = max(size_max_pairs(gaussians, motion_lib.subframe_cameras(
        motion, 0, nu[s:s + 1], proj), cs, probe) for s in (0, F // 2, F - 1))
    qcfg = RasterizeConfig(tile_w=32, tile_h=32, need_n_contrib=False,
                           max_pairs=2 * view_pairs)

    def batched_blur():
        """The training step's forward half: render_inputs → sample_nu →
        subframe_cameras → one render_batch → mean over sub-frames."""
        rin = gaussians.render_inputs()
        cams = motion_lib.subframe_cameras(motion, 0, motion_lib.sample_nu(motion, 0), proj)
        out = rasterize.render_batch(rin["means3d"], rin["scales"], rin["rotations"],
                                     rin["opacities"], rin["shs"], cams, cs, bg, cfg=rcfg,
                                     sh_degree=2)
        return out.image.mean(0), out

    with torch.no_grad():
        # ---- the main path, counted ----
        torch.cuda.synchronize()
        zero_counts()
        blurred, out = batched_blur()                              # warm-up
        torch.cuda.synchronize()
        host_ms, ev_ms = [], []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            blurred, out = batched_blur()
            stop.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            ev_ms.append(start.elapsed_time(stop))
        q = blur.query(gaussians, torch.ones(N, dtype=torch.bool, device=dev), motion, 0,
                       proj, cs, rcfg=qcfg, background=bg, nu=nu)
        torch.cuda.synchronize()
        launches = read_counts()
        if launches["K2"] or launches["K4"] or launches["K5"] or launches["K6"]:
            raise AssertionError(f"the mixed forward path launched another kernel: {launches}")
        for name in ("K3", "K1"):
            n = launches[name]
            if n != 4 + F:
                raise AssertionError(f"{name} launched {n} times on the main path, "
                                     f"expected {4 + F}")

        num_pairs, max_per_tile = int(out.num_pairs), int(out.max_per_tile)
        if num_pairs > max_pairs:
            raise AssertionError(f"pair overflow: {num_pairs} > {max_pairs}")
        if not bool(torch.isfinite(blurred).all()) or blurred.shape != (H, W, 3):
            raise AssertionError("batched blur is not a finite [H, W, 3] image")
        err_loop = check_close("batched blur vs mean of 21 renders", blurred, q.blurred, 2e-5)

        # ---- per-stage breakdown, by CUDA events ----
        bcfg = rcfg.blend_config(cs, n_images=F)
        stages = ("preprocess", "compact", "K3", "sort", "K1", "compose")
        acc = {k: 0.0 for k in stages}
        for it in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            ev[0].record()
            cams = motion_lib.subframe_cameras(motion, 0, motion_lib.sample_nu(motion, 0), proj)
            flat = flat_preprocess(gaussians, cams, cs, rcfg)
            ev[1].record()
            c = cuda_blend.compact_table(bcfg, *flat, bcfg.max_pairs)
            ev[2].record()
            fslot = cuda_blend.broadcast_fields(c.ctable, c.gauss_c)
            ev[3].record()
            st = cuda_blend.sort_slots(bcfg, fslot, c)
            ev[4].record()
            k1 = cuda_blend_mixed.forward_mixed(bcfg, st)
            ev[5].record()
            tile_blend.compose(bcfg, *k1, bg)[0].mean(0)
            ev[6].record()
            torch.cuda.synchronize()
            if it:                                                  # first is warm-up
                for i, k in enumerate(stages):
                    acc[k] += ev[i].elapsed_time(ev[i + 1]) / 3
        breakdown = {k: round(v, 4) for k, v in acc.items()}
        breakdown["staging_total"] = round(acc["compact"] + acc["K3"] + acc["sort"], 4)
        err_k3 = check_k3(torch, "full width", fslot, c)
        profile = device_profile(torch, batched_blur)

        # ---- K1 against its plain version on 64 sampled tiles ----
        tiles = torch.from_numpy(np.random.default_rng(SEED + 2).choice(
            bcfg.total_tiles, 64, replace=False)).to(dev)
        err_k1 = check_k1(torch, "full width (64 tiles)", bcfg, st, k1, tiles=tiles)

    emit("slice", width=W, height=H, gaussians=N, sh_degree=2, subframes=F, tile=32,
         max_pairs=max_pairs, num_pairs=num_pairs, max_per_tile=max_per_tile,
         blur_ms_events=[round(x, 4) for x in ev_ms],
         blur_ms_host=[round(x, 4) for x in host_ms], breakdown_ms=breakdown,
         launches=launches, launches_per_batched_blur=1, launches_per_query=F,
         err_batched_vs_query=err_loop, err_k3=err_k3, err_k1_sampled_tiles=err_k1,
         profile=profile)

    def stage_at(tile: int):
        """The slice's lists staged at tile × tile tiles (its own budget)."""
        probe_t = RasterizeConfig(tile_w=tile, tile_h=tile, need_n_contrib=False)
        cfg_t = RasterizeConfig(tile_w=tile, tile_h=tile, need_n_contrib=False,
                                max_pairs=size_max_pairs(gaussians, cams, cs, probe_t))
        b = cfg_t.blend_config(cs, n_images=F)
        with torch.no_grad():
            return b, cuda_blend.sort_stage(b, *flat_preprocess(gaussians, cams, cs, cfg_t),
                                            b.max_pairs)

    return dict(bcfg=bcfg, staged=st, compact=c, launches=launches, err_k1=err_k1,
                err_k3=err_k3, stage_at=stage_at)


def phase_trained(torch, dev):
    from deblurgs_tpu_torch import weights
    from deblurgs_tpu_torch.models import motion as motion_lib
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed, rasterize
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig

    path = os.path.join(REPO, "runs", "r5_jointb_state.npz")
    with np.load(path) as d:
        flat_state = {k: np.array(d[k]) for k in d.files
                      if k.startswith(("params/", "motion/", "aux/active"))}
    gaussians, motion, active = weights.from_jax_arrays(flat_state, device=dev)
    W = H = TRAINED_SIZE
    cs, proj = camera(W, H, 1.1, dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    F = motion.cfg.n_subframes
    probe = RasterizeConfig(tile_w=32, tile_h=32, need_n_contrib=False)
    errs, stats = {}, {}
    with torch.no_grad():
        mid = motion_lib.middle_cameras(motion, proj)
        views = {
            "blurry": motion_lib.subframe_cameras(motion, 0, motion_lib.sample_nu(motion, 0),
                                                  proj),
            "sharp": type(mid)(*(x[:1] for x in mid)),
        }
        for name, cams in views.items():
            rcfg = RasterizeConfig(tile_w=32, tile_h=32, need_n_contrib=False,
                                   max_pairs=size_max_pairs(gaussians, cams, cs, probe, active))
            rin = gaussians.render_inputs()
            out = rasterize.render_batch(rin["means3d"], rin["scales"], rin["rotations"],
                                         rin["opacities"], rin["shs"], cams, cs, bg, cfg=rcfg,
                                         sh_degree=gaussians.cfg.sh_degree, active=active)
            image = out.image.mean(0)
            if not bool(torch.isfinite(image).all()):
                raise AssertionError(f"trained {name} view is not finite")
            bcfg = rcfg.blend_config(cs, n_images=cams.view.shape[0])
            flat = flat_preprocess(gaussians, cams, cs, rcfg, active)
            kern = kernel_blend(bcfg, flat, bg)
            plain = plain_blend(bcfg, flat, bg)
            errs[name] = max(check_close(f"trained {name} {k}", a, b, 1e-5, rtol)
                             for k, a, b, rtol in zip(("image", "depth", "final_T"),
                                                      kern[:3], plain[:3], (0.0, 1e-4, 0.0)))
            staged = cuda_blend.sort_stage(bcfg, *flat, bcfg.max_pairs)
            errs[name] = max(errs[name], check_k1(torch, f"trained {name}", bcfg, staged,
                                                  cuda_blend_mixed.forward_mixed(bcfg, staged)))
            check_close(f"trained {name}: staged pieces vs render_batch", kern[0], out.image,
                        1e-6)
            stats[name] = dict(views=int(cams.view.shape[0]), pairs=int(out.num_pairs),
                               max_per_tile=int(out.max_per_tile),
                               mean=round(float(image.mean()), 6))
    emit("trained", state=os.path.relpath(path, REPO), size=[W, H], subframes=F,
         gaussians_active=int(active.sum()), views=stats, err_kernel_vs_plain=errs)
    return max(errs.values())



def plain_blend_grads(torch, bcfg, flat, bg, d_img, d_dep):
    """``blend_fused``'s gradients with every kernel replaced by its plain
    PyTorch version, on the device ``flat`` lives on: (d means2d, d conic,
    d opacity, d color, d depth, d bg)."""
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed as cbm, tile_blend

    c = cuda_blend.compact_table(bcfg, *flat, bcfg.max_pairs)
    st = cuda_blend.sort_slots(bcfg, cuda_blend.broadcast_fields_ref(c.ctable, c.gauss_c), c)
    C, D, T, _ = cbm.forward_ref(bcfg, st.fields, st.tile_start, st.tile_stop)
    dl_pix = tile_blend._images_to_tiles(bcfg, d_img)
    dl_d = tile_blend._images_to_tiles(bcfg, d_dep)
    total = cbm.backward_total(bcfg, bg, T, dl_pix, dl_d, C, D)
    pg = cbm.backward_ref(bcfg, st.fields, st.tile_start, st.tile_stop, dl_pix, dl_d, total)
    out = rows_by_rank_ref(torch, st, pg, flat[0].shape[0])
    return (out[:, 0:2], out[:, 2:5], out[:, 5], out[:, 6:9], out[:, 9],
            torch.einsum("tp,tpc->c", T, dl_pix))


def phase_train_parity(torch, dev):
    from deblurgs_tpu_torch.models import motion as motion_lib
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed, tile_blend
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig

    W, H, N = PARITY_SIZE
    F = 3
    gaussians = make_scene(N, 2, np.random.default_rng(SEED + 1), dev)
    cs, proj = camera(W, H, 1.2, dev)
    motion = motion_lib.init_motion(
        torch.eye(3, device=dev)[None], torch.tensor([[0.0, 0.0, -6.0]], device=dev),
        motion_lib.MotionConfig(curve_order=9, n_subframes=F),
        torch.Generator(device=dev).manual_seed(SEED), init_noise=0.01)
    cams = motion_lib.subframe_cameras(motion, 0, motion_lib.sample_nu(motion, 0), proj)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    errs = {}
    for name, fast in (("default", False), ("fast", True)):
        rcfg = RasterizeConfig(tile_w=32, tile_h=32, max_pairs=1 << 16, need_n_contrib=False,
                               fast=fast)
        bcfg = rcfg.blend_config(cs, n_images=F)
        with torch.no_grad():
            flat = flat_preprocess(gaussians, cams, cs, rcfg)
        st = cuda_blend.sort_stage(bcfg, *flat, bcfg.max_pairs)
        C, D, T, _ = cuda_blend_mixed.forward_mixed(bcfg, st)
        dl_pix = torch.randn((bcfg.total_tiles, bcfg.tile_px, 3), generator=gen, device=dev)
        dl_d = 0.05 * torch.randn((bcfg.total_tiles, bcfg.tile_px), generator=gen, device=dev)
        pg = cuda_blend_mixed.backward_mixed(bcfg, st, bg, T, dl_pix, dl_d, C, D)
        err_k2 = check_k2(torch, f"parity {name}", bcfg, st, bg, T, dl_pix, dl_d, C, D, pg)
        P = flat[0].shape[0]
        err_k4 = check_k4(torch, f"parity {name}", st, pg, P)
        if not torch.equal(pg, cuda_blend_mixed.backward_mixed(bcfg, st, bg, T, dl_pix, dl_d,
                                                               C, D)):
            raise AssertionError(f"K2 {name}: two calls differ")
        # blend_fused's autograd gradients (kernels) against the plain path
        d_img = torch.randn((F, H, W, 3), generator=gen, device=dev)
        d_dep = 0.05 * torch.randn((F, H, W), generator=gen, device=dev)

        def kernel_grads():
            diff = [t.clone().requires_grad_(True) for t in flat[:5] + [bg]]
            img, dep, *_ = tile_blend.blend_fused(bcfg, *diff[:5], flat[5], flat[6], diff[5])
            return torch.autograd.grad((img * d_img).sum() + (dep * d_dep).sum(), diff)

        got, again = kernel_grads(), kernel_grads()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"blend_fused {name}: two backward calls differ")
        with torch.no_grad():
            want = plain_blend_grads(torch, bcfg, flat, bg, d_img, d_dep)
        err_grad = {k: check_scaled(f"blend_fused grads {name} {k}", a, b)
                    for k, a, b in zip(("means2d", "conic", "opacity", "color", "depth", "bg"),
                                       got, want)}
        errs[name] = dict(pairs=int(st.total), K2=err_k2, K4=err_k4, blend_grads=err_grad,
                          bitwise_repeat=True)
    emit("train_parity", size=[W, H], gaussians=N, subframes=F, **errs)
    return (max(e["K2"][1] for e in errs.values()), max(e["K4"][1] for e in errs.values()))


def image_cotangent(torch, images, gt, lam_t):
    """d loss / d images of the step's loss (L1 of the blur + lam_t ·
    temporal smoothness; depth-TV off), for the kernel checks."""
    from deblurgs_tpu_torch.train import losses

    img = images.detach().requires_grad_(True)
    total = losses.l1_loss(img.mean(0)[None], gt[None]) + lam_t * \
        losses.batchwise_smoothness_loss(img)
    return torch.autograd.grad(total, img)[0]


def step_kernel_inputs(torch, st, state, gt, bg, cam_idx, proj, views=slice(None)):
    """The staged pairs, compositor outputs and image cotangent of the
    step's render at ``state`` (no grad): what K2 and K4 see in the step
    (on a sub-frame mesh, a rank's block ``views``)."""
    from deblurgs_tpu_torch.core.camera import CameraArrays
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed, tile_blend
    from deblurgs_tpu_torch.train import schedules

    with torch.no_grad():
        nu = motion_lib.sample_nus(state.motion, [cam_idx], st.mcfg)
        cams = motion_lib.subframe_cameras_batch(state.motion, [cam_idx], nu, proj, st.mcfg)
        cams = CameraArrays(*(x[views] for x in cams))
        bcfg = st.rcfg.blend_config(st.cs, n_images=cams.view.shape[0])
        flat = flat_preprocess((gm.render_inputs(state.params, st.gcfg), st.sh_degree), cams,
                               st.cs, st.rcfg, state.aux.active)
        compact = cuda_blend.compact_table(bcfg, *flat, bcfg.max_pairs)    # = sort_stage
        staged = cuda_blend.sort_slots(
            bcfg, cuda_blend.broadcast_fields(compact.ctable, compact.gauss_c), compact)
        C, D, T, n_con = cuda_blend_mixed.forward_mixed(bcfg, staged)
        images = tile_blend.compose(bcfg, C, D, T, n_con, bg)[0]
    lam_t = float(schedules.expon_lr(state.step, st.ocfg.lambda_t_smooth_init,
                                     st.ocfg.lambda_t_smooth_final,
                                     max_steps=st.ocfg.iterations))
    from deblurgs_tpu_torch.models import tonemap

    gt_linear = tonemap.tone_map(gt, tonemap.inverse_kind(st.tone_mapping))
    d_img = image_cotangent(torch, images, gt_linear, lam_t)
    dl_pix = tile_blend._images_to_tiles(bcfg, d_img)
    dl_d = torch.zeros_like(D)
    return dict(bcfg=bcfg, flat=flat, compact=compact, staged=staged, C=C, D=D, T=T,
                n_con=n_con, dl_pix=dl_pix, dl_d=dl_d, P=flat[0].shape[0])


def train_setup(torch, dev, capacity=None):
    """The full-width train step's state and statics (``bench.py``'s
    ``_train_step_bench`` settings, batched render on); ``capacity`` slots
    (default: the Gaussians)."""
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
    from deblurgs_tpu_torch.train import step as step_lib
    from deblurgs_tpu_torch.train.config import OptimizationConfig

    (W, H, N), F = TRAIN_SIZE, 21
    rng = np.random.default_rng(SEED + 3)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)   # noqa: E731
    gcfg = gm.GaussianConfig(sh_degree=2)
    params, aux = gm.create_from_pcd(t(rng.standard_normal((N, 3)) * 2.0),
                                     t(rng.uniform(0.0, 1.0, (N, 3))), gcfg,
                                     capacity=capacity or N)
    cs, proj = camera(W, H, 1.2, dev)
    mcfg = motion_lib.MotionConfig(curve_order=9, n_subframes=F)
    motion = motion_lib.init_motion(
        torch.eye(3, device=dev)[None], torch.tensor([[0.0, 0.0, -6.0]], device=dev), mcfg,
        torch.Generator(device=dev).manual_seed(SEED)).params()
    ocfg = OptimizationConfig(iterations=10_000, curve_start_iter=1,
                              densify_from_iter=10**9, opacity_reset_interval=10**9)
    probe = RasterizeConfig(tile_w=32, tile_h=32, need_n_contrib=False)
    with torch.no_grad():
        nu = motion_lib.sample_nus(motion, [0], mcfg)
        cams = motion_lib.subframe_cameras_batch(motion, [0], nu, proj, mcfg)
        max_pairs = size_max_pairs((gm.render_inputs(params, gcfg), 2), cams, cs, probe)
    rcfg = RasterizeConfig(tile_w=32, tile_h=32, need_n_contrib=False, max_pairs=max_pairs)
    st = step_lib.TrainStatics(gcfg=gcfg, mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, cs=cs, sh_degree=2,
                               n_sub=F, tone_mapping="identity", batched_render=True)
    state = step_lib.init_state(params, motion, aux)._replace(step=100)
    gt = torch.rand((H, W, 3), generator=torch.Generator(device=dev).manual_seed(SEED + 5),
                    device=dev)
    return st, state, gt, proj


def phase_train(torch, dev):
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed
    from deblurgs_tpu_torch.train import step as step_lib

    st, state0, gt, proj = train_setup(torch, dev)
    (W, H, N), F = TRAIN_SIZE, st.n_sub
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    # ---- the main path, counted: 2 warm-up steps, then 5 timed ----
    state = state0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step_ms, host_ms, losses_seen = [], [], []
    for it in range(7):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, metrics = step_lib.train_step(state, gt, 0, proj, st, generator=gen)
        stop.record()
        torch.cuda.synchronize()
        losses_seen.append(float(metrics.loss))
        if it >= 2:
            host_ms.append((time.perf_counter() - t0) * 1e3)
            step_ms.append(start.elapsed_time(stop))
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, n in launches.items():
        if n != (0 if name in ("K5", "K6") else 7):
            raise AssertionError(f"{name} launched {n} times in 7 train steps")
    if not all(math.isfinite(x) for x in losses_seen):
        raise AssertionError(f"non-finite loss: {losses_seen}")
    if int(state.overflow_count) != 0:
        raise AssertionError("the pair list overflowed")
    act = state0.aux.active
    changed = {k: bool((getattr(state.params, k)[act] != getattr(state0.params, k)[act]).any())
               for k in state0.params._fields}
    changed.update({k: bool((getattr(state.motion, k) != getattr(state0.motion, k)).any())
                    for k in ("rot_ctrl", "trans_ctrl")})
    if not all(changed.values()):
        raise AssertionError(f"leaves left unchanged by 7 steps: {changed}")

    # ---- breakdown of one more step, by CUDA events ----
    acc = dict(forward=0.0, backward=0.0, apply=0.0)
    for it in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        draws = step_lib.draw_step(state, st, gt.shape, gen)
        ev[0].record()
        fwd = step_lib.forward_loss(state, gt, 0, proj, st, draws)
        ev[1].record()
        grads = step_lib.backward(fwd)
        ev[2].record()
        state, _ = step_lib.apply(state, fwd, grads, st, draws)
        ev[3].record()
        torch.cuda.synchronize()
        if it:
            for i, k in enumerate(acc):
                acc[k] += ev[i].elapsed_time(ev[i + 1]) / 2
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    k = step_kernel_inputs(torch, st, state, gt, bg, 0, proj)
    bcfg, staged = k["bcfg"], k["staged"]
    kargs = (bg, k["T"], k["dl_pix"], k["dl_d"], k["C"], k["D"])
    k2_ms = cuda_ms(lambda: cuda_blend_mixed.backward_mixed(bcfg, staged, *kargs), 5)
    pg = cuda_blend_mixed.backward_mixed(bcfg, staged, *kargs)
    k4_ms = cuda_ms(lambda: cuda_blend.reduce_pair_grads(staged, pg, k["P"]), 5)
    def make_flat():
        from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib

        nu = motion_lib.sample_nus(state.motion, [0], st.mcfg)
        cams = motion_lib.subframe_cameras_batch(state.motion, [0], nu, proj, st.mcfg)
        return flat_preprocess((gm.render_inputs(state.params, st.gcfg), st.sh_degree), cams,
                               st.cs, st.rcfg, state.aux.active)

    stages = forward_stages(torch, bcfg, make_flat, bg, st.n_sub)
    breakdown = {"forward_loss": round(acc["forward"], 4),
                 "forward_stages_no_grad": stages,
                 "losses_and_rest": round(acc["forward"] - sum(stages.values()), 4),
                 "backward": round(acc["backward"], 4), "K2": round(k2_ms, 4),
                 "K4": round(k4_ms, 4),
                 "autograd_rest": round(acc["backward"] - k2_ms - k4_ms, 4),
                 "adam_and_stats": round(acc["apply"], 4)}

    # ---- the kernels against their plain versions at these shapes ----
    tiles = torch.from_numpy(np.random.default_rng(SEED + 7).choice(
        bcfg.total_tiles, 64, replace=False)).to(dev)
    err_k2 = check_k2(torch, "train (64 tiles)", bcfg, staged, *kargs, pg, tiles=tiles)
    err_k4 = check_k4(torch, "train", staged, pg, k["P"])
    profile = device_profile(torch, lambda: step_lib.train_step(state, gt, 0, proj, st,
                                                                generator=gen))
    emit("train", width=W, height=H, gaussians=N, sh_degree=2, subframes=F, tile=32,
         state_step=100, max_pairs=st.rcfg.max_pairs, num_pairs=int(metrics.num_pairs),
         max_per_tile=int(metrics.max_per_tile), step_ms_events=[round(x, 4) for x in step_ms],
         step_ms_host=[round(x, 4) for x in host_ms], breakdown_ms=breakdown,
         peak_memory_gb=round(peak_gb, 3), launches=launches, launches_per_step=1,
         loss=losses_seen, changed=changed, err_k2_sampled_tiles=err_k2, err_k4=err_k4,
         profile=profile)
    return dict(k=k, pg=pg, launches=launches, err_k2=err_k2[1], err_k4=err_k4[1], k2_ms=k2_ms,
                step_ms=step_ms)


def forward_stages(torch, bcfg, make_flat, bg, n_views: int, reps: int = 3,
                   composite=None) -> dict:
    """CUDA-event breakdown of the forward path (no grad): ``make_flat()``
    (cameras + preprocess), compact, K3, sort, the compositing kernel
    (``composite``, default K1), compose."""
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed, tile_blend

    composite = composite or cuda_blend_mixed.forward_mixed
    kernel = "K1" if composite is cuda_blend_mixed.forward_mixed else "K5"
    names = ("preprocess", "compact", "K3", "sort", kernel, "compose")
    acc = {k: 0.0 for k in names}
    with torch.no_grad():
        for it in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            ev[0].record()
            flat = make_flat()
            ev[1].record()
            c = cuda_blend.compact_table(bcfg, *flat, bcfg.max_pairs)
            ev[2].record()
            fslot = cuda_blend.broadcast_fields(c.ctable, c.gauss_c)
            ev[3].record()
            st = cuda_blend.sort_slots(bcfg, fslot, c)
            ev[4].record()
            out = composite(bcfg, st)
            ev[5].record()
            tile_blend.compose(bcfg, *out, bg)[0].mean(0)
            ev[6].record()
            torch.cuda.synchronize()
            if it:
                for i, k in enumerate(names):
                    acc[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    return {k: round(v, 4) for k, v in acc.items()}


def phase_train_trained(torch, dev):
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib
    from deblurgs_tpu_torch.ops import cuda_blend_mixed
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
    from deblurgs_tpu_torch.train import checkpoint, step as step_lib
    from deblurgs_tpu_torch.train.config import OptimizationConfig

    path = os.path.join(REPO, "runs", "r5_jointb_state.npz")
    state = checkpoint.load_checkpoint(path, device=dev)
    W = H = TRAINED_SIZE
    cs, proj = camera(W, H, 1.1, dev)
    F = state.motion.nu.shape[1] + 2
    gcfg = gm.GaussianConfig(sh_degree=2)
    mcfg = motion_lib.MotionConfig(curve_order=state.motion.rot_ctrl.shape[1] - 1, n_subframes=F)
    ocfg = OptimizationConfig()
    step = 8200          # > densify_from_iter, a multiple of 200, not of 3000
    probe = RasterizeConfig(tile_w=32, tile_h=32, need_n_contrib=False)
    with torch.no_grad():
        cams = motion_lib.subframe_cameras_batch(
            state.motion, [0], motion_lib.sample_nus(state.motion, [0], mcfg), proj, mcfg)
        max_pairs = size_max_pairs((gm.render_inputs(state.params, gcfg), 2), cams, cs, probe,
                                   state.aux.active)
    rcfg = RasterizeConfig(tile_w=32, tile_h=32, need_n_contrib=False, max_pairs=max_pairs)
    st = step_lib.TrainStatics(gcfg=gcfg, mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, cs=cs, sh_degree=2,
                               n_sub=F, batched_render=True)
    state = state._replace(step=step)
    gt = torch.rand((H, W, 3), generator=torch.Generator(device=dev).manual_seed(SEED + 8),
                    device=dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    active_before = int(state.aux.active.sum())
    zero_counts()
    new_state, metrics = step_lib.train_step(state, gt, 0, proj, st,
                                             draws=step_lib.draw_step(
                                                 state, st, gt.shape,
                                                 torch.Generator(device=dev).manual_seed(SEED)))
    torch.cuda.synchronize()
    launches = read_counts()
    if any(n != (0 if name in ("K5", "K6") else 1) for name, n in launches.items()):
        raise AssertionError(f"trained step launches: {launches}")
    if not math.isfinite(float(metrics.loss)) or int(metrics.overflow_count):
        raise AssertionError("trained step: non-finite loss or overflow")
    report = {k: int(v) for k, v in metrics.densify._asdict().items()}
    if report["n_cloned"] + report["n_split"] + report["n_pruned"] == 0:
        raise AssertionError(f"densify_and_prune did nothing: {report}")
    k = step_kernel_inputs(torch, st, state, gt, bg, 0, proj)
    kargs = (bg, k["T"], k["dl_pix"], k["dl_d"], k["C"], k["D"])
    pg = cuda_blend_mixed.backward_mixed(k["bcfg"], k["staged"], *kargs)
    err_k2 = check_k2(torch, "trained", k["bcfg"], k["staged"], *kargs, pg)
    err_k4 = check_k4(torch, "trained", k["staged"], pg, k["P"])
    emit("train_trained", state=os.path.relpath(path, REPO), size=[W, H], subframes=F,
         step=step, loss=float(metrics.loss), pairs=int(metrics.num_pairs),
         max_per_tile=int(metrics.max_per_tile), active_before=active_before,
         active_after=int(new_state.aux.active.sum()), densify=report, launches=launches,
         err_k2=err_k2, err_k4=err_k4)
    return err_k2[1], err_k4[1]


def k3_yardstick(torch, c, iters: int) -> dict:
    """K3 on a compact table ``c``: timed beside its plain version and
    ``index_select`` (the one PyTorch call for the same function), held
    bitwise to the plain version, with its byte bound (4 B of rank and 64 B
    out a slot, a 64 B table row an emitting Gaussian)."""
    from deblurgs_tpu_torch.ops import cuda_blend

    gauss_c = c.gauss_c.to(torch.int32)
    ctable = c.ctable.contiguous()
    max_pairs = gauss_c.shape[0]
    got = cuda_blend.broadcast_fields(ctable, gauss_c)
    if not torch.equal(got, cuda_blend.broadcast_fields_ref(ctable, gauss_c)):
        raise AssertionError("K3 yardstick: differs from ctable[gauss_c].T")
    lib_err = max_err(got, torch.index_select(ctable.t(), 1, gauss_c))
    del got
    ms = cuda_ms(lambda: cuda_blend.broadcast_fields(ctable, gauss_c), iters)
    plain = cuda_ms(lambda: cuda_blend.broadcast_fields_ref(ctable, gauss_c), iters)
    lib = cuda_ms(lambda: torch.index_select(ctable.t(), 1, gauss_c), iters)
    n_emit = int(c.n_emit)
    nbytes = 4 * max_pairs + 64 * n_emit + 64 * max_pairs
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain, library_ms=lib,
                library_call="torch.index_select(ctable.t(), 1, gauss_c)",
                library_max_abs_err=lib_err, max_pairs=max_pairs, n_emit=n_emit, bytes=nbytes,
                bound_ms=bound, share_of_bound=bound / ms)


def k1_schedule(torch, bcfg, staged, where: str) -> dict:
    """K1's schedule walked on these lists (``forward_schedule``): its
    outputs held bitwise to the kernel's, the (warp, pair) visits of the
    per-warp exit and of the block exit of the row strips K1 walked before,
    the visits the evaluations need at 128 pixels a warp, and the
    evaluations."""
    from deblurgs_tpu_torch.ops import cuda_blend_mixed as cbm

    *want, visits = cbm.forward_schedule(bcfg, staged.fields, staged.tile_start,
                                         staged.tile_stop)
    got = cbm.forward_mixed(bcfg, staged)
    for name, g, w in zip(("C", "D", "final_T", "n_con"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"K1 {where}: {name} differs from its schedule's walk")
    v = {k: int(x) for k, x in visits.items()}
    evals = v.pop("evaluations")
    v["evaluations_over_128"] = evals / 128
    return dict(evaluations=evals, visits=v)


def sm_clock_during(torch, fn, iters: int):
    """``fn``'s mean device time over ``iters`` calls (``cuda_ms``) and the
    SM clock in MHz that nvidia-smi reported meanwhile, sampled every
    100 ms."""
    import threading

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, timeout=30).stdout.split()
            if out:
                samples.append(float(out[0]))
            stop.wait(0.1)

    thread = threading.Thread(target=sample)
    thread.start()
    try:
        ms = cuda_ms(fn, iters)
    finally:
        stop.set()
        thread.join()
    return ms, samples


def phase_yardstick(torch, sl, k3_err: float, k1_err: float, tr=None, k2_err=0.0,
                    k4_err=0.0):
    """Each kernel timed beside its plain version and its bound, K3 and K1
    at the slice's shapes, K2 and K4 at the train step's (``tr``); returns
    the kernels line (``*_err``: each kernel's largest absolute error
    against its plain version over the earlier phases)."""
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed, kernels

    bcfg, st, c = sl["bcfg"], sl["staged"], sl["compact"]
    k3 = k3_yardstick(torch, c, 20)
    k3["previous_ms"] = K3_PREVIOUS_MS
    k3["pr6_ms"] = K3_PR6_MS["slice"]

    # K1: ranges as int32 so the timed call is the launch alone
    st32 = st._replace(tile_start=st.tile_start.to(torch.int32),
                       tile_stop=st.tile_stop.to(torch.int32))
    k1_ms = cuda_ms(lambda: cuda_blend_mixed.forward_mixed(bcfg, st32), 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cuda_blend_mixed.forward_ref(bcfg, st.fields, st.tile_start, st.tile_stop)
    torch.cuda.synchronize()
    k1_plain = (time.perf_counter() - t0) * 1e3
    k1 = k1_schedule(torch, bcfg, st32, "slice")
    evals = k1["evaluations"]
    staged_pairs = int((st.tile_stop - st.tile_start).sum())
    px = bcfg.total_tiles * bcfg.tile_px
    out_bytes = px * (12 + 4 + 4 + (4 if bcfg.need_n_contrib else 0))
    k1_bytes = 40 * staged_pairs + 8 * bcfg.total_tiles + out_bytes
    k1_byte_ms = k1_bytes / HBM_BYTES_PER_S * 1e3
    k1_op_ms = EVAL_OPS * evals / F32_OPS_PER_S * 1e3
    # K1 on the slice's scene staged at 16×16 tiles (one pixel a thread)
    b16, st16 = sl["stage_at"](16)
    st16 = st16._replace(tile_start=st16.tile_start.to(torch.int32),
                         tile_stop=st16.tile_stop.to(torch.int32))
    k1_t16 = k1_schedule(torch, b16, st16, "slice, tile 16")
    k1_t16["ms"] = cuda_ms(lambda: cuda_blend_mixed.forward_mixed(b16, st16), 10)
    k1_t16["layout"] = cuda_blend_mixed.forward_layout(16, 16)
    emit("yardstick", K3=k3,
         K1=dict(ms=k1_ms, previous_ms=K1_PREVIOUS_MS["slice"], plain_ms=k1_plain,
                 staged_pairs=staged_pairs, bytes=k1_bytes, bytes_ms=k1_byte_ms,
                 ops=EVAL_OPS * evals, ops_ms=k1_op_ms, **k1),
         K1_tile16=k1_t16)
    # K2 and K4 at the train step's shapes and image cotangent
    k = tr["k"]
    bcfg2, st2, P = k["bcfg"], k["staged"], k["P"]
    kargs = (torch.tensor([0.1, 0.2, 0.3], device=st2.fields.device), k["T"], k["dl_pix"],
             k["dl_d"], k["C"], k["D"])
    st2 = st2._replace(tile_start=st2.tile_start.to(torch.int32),
                       tile_stop=st2.tile_stop.to(torch.int32))
    k2_ms = cuda_ms(lambda: cuda_blend_mixed.backward_mixed(bcfg2, st2, *kargs), 10)
    pg = cuda_blend_mixed.backward_mixed(bcfg2, st2, *kargs)
    # the pass K2 does in its prologue, timed as a wrapper would run it apart
    total_ms = cuda_ms(lambda: cuda_blend_mixed.backward_total(bcfg2, *kargs), 5)
    total = cuda_blend_mixed.backward_total(bcfg2, *kargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cuda_blend_mixed.backward_ref(bcfg2, st2.fields, st2.tile_start, st2.tile_stop, kargs[2],
                                  kargs[3], total)
    torch.cuda.synchronize()
    k2_plain = (time.perf_counter() - t0) * 1e3
    k1_train = k1_schedule(torch, bcfg2, st2, "train lists")
    evals2 = k1_train["evaluations"]
    kept2 = int((st2.tile_stop - st2.tile_start).sum())
    max_pairs2 = st2.fields.shape[1]
    px2 = bcfg2.total_tiles * bcfg2.tile_px
    # out: rows 0-9 of each staged slot, what K4 reads; the zero fill of
    # columns 10-15 and of the unstaged tail is a cost of the [max_pairs, 16]
    # layout
    k2_bytes = 40 * kept2 + 8 * bcfg2.total_tiles + 20 * px2 + 40 * kept2
    k2_fill = 64 * max_pairs2 - 40 * kept2
    k2_byte_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    k2_op_ms = EVAL_OPS * evals2 / F32_OPS_PER_S * 1e3
    k2_ptxas = ptxas_report(kernels.load_library().ptxas_log, K2_MAIN_ENTRY)
    k2_sass = sass_pair_loop("backward_mixed", K2_MAIN_ENTRY)

    # K1 on the same lists: its bound, and the issue rate its SASS pair loop
    # needs over the (warp, pair) visits its schedule walks, at the SM clock
    # sampled while it runs
    k1_train_ms, clock = sm_clock_during(
        torch, lambda: cuda_blend_mixed.forward_mixed(bcfg2, st2), 60)
    k1_train_bytes = 40 * kept2 + 8 * bcfg2.total_tiles + px2 * (12 + 4 + 4)
    k1_train_bound = max(k1_train_bytes / HBM_BYTES_PER_S * 1e3, k2_op_ms)
    k1_sass = sass_pair_loop("forward_mixed", K1_MAIN_ENTRY)
    k1_train["sass"] = k1_sass
    k1_train["ptxas"] = ptxas_report(kernels.load_library().ptxas_log, K1_MAIN_ENTRY)
    if clock and "pair_loop_instructions" in k1_sass:
        mhz = float(np.median(clock))
        sms = torch.cuda.get_device_properties(st2.fields.device).multi_processor_count
        per_visit = k1_sass["pair_loop_instructions"] / K1_PAIRS_PER_LOOP
        issue_ms = (k1_train["visits"]["warp_exit"] * per_visit
                    / (sms * SM_ISSUE_PER_CLOCK * mhz * 1e6) * 1e3)
        k1_train["issue_bound"] = dict(sm_clock_mhz=mhz, sm_clock_samples=clock, sms=sms,
                                       instructions_per_visit=per_visit, ms=issue_ms,
                                       share=issue_ms / k1_train_ms)
    # K3 on the same lists
    k3_train = k3_yardstick(torch, k["compact"], 10)
    k3_train["pr6_ms"] = K3_PR6_MS["train_lists"]

    # K4 on the main path (the staging's runs, sums to original rows) and by
    # rank array (the wrapper's sort), the plain version and index_add_
    s_gc = st2.s_gc
    k4_ms = cuda_ms(lambda: cuda_blend.reduce_pair_grads(st2, pg, P), 10)
    k4_rank_ms = cuda_ms(lambda: cuda_blend.reduce_sorted(pg, s_gc, P), 10)
    k4_plain = cuda_ms(lambda: cuda_blend.reduce_pair_grads_ref(st2, pg, P), 3)
    seg = torch.clamp(s_gc.to(torch.int64), max=P)
    rows = pg[:10].T.contiguous()

    def library():
        return torch.zeros((P + 1, 10), device=pg.device).index_add_(0, seg, rows)

    k4_lib = cuda_ms(library, 10)
    # what each K4 path launches over five calls: the main path no sort, the
    # rank-array path (the sort-based reduce, without a scatter) the
    # wrapper's sort (a profile of one ~4 ms call can come back with no
    # device activity recorded)
    k4_profile = device_profile(torch, lambda: cuda_blend.reduce_pair_grads(st2, pg, P), top=6,
                                calls=5)
    k4_rank_profile = device_profile(torch, lambda: cuda_blend.reduce_sorted(pg, s_gc, P),
                                     top=6, calls=5)
    k4_lib_err = max_err(library()[:P], cuda_blend.reduce_sorted(pg, s_gc, P)[:, :10])
    # run slots: 4 B of sorted position + the 40 B of gradients K4 sums;
    # ranks: 8 B of run bounds, 4 B of id, a 64 B output row (zeroed, then
    # written)
    run_slots = int(st2.seg[-1] - st2.seg[0])
    k4_bytes = (4 + 40) * run_slots + (8 + 4 + 64) * P
    k4_bound = k4_bytes / HBM_BYTES_PER_S * 1e3
    emit("yardstick_backward",
         K2=dict(ms=k2_ms, previous_ms=K2_PREVIOUS_MS, before_cull_ms=K2_NO_CULL_TREE_MS,
                 plain_ms=k2_plain,
                 design_moves_recorded_ms=K2_DESIGN_MOVES_MS, total_pass_ms=total_ms, staged_pairs=kept2,
                 evaluations=evals2, bytes=k2_bytes, bytes_ms=k2_byte_ms, ops=EVAL_OPS * evals2, ops_ms=k2_op_ms,
                 layout_fill_bytes=k2_fill, ptxas=k2_ptxas, sass=k2_sass),
         K1_train_lists=dict(ms=k1_train_ms, previous_ms=K1_PREVIOUS_MS["train_lists"],
                             before_cull_ms=K1_NO_CULL_TREE_MS,
                             design_moves_recorded_ms=K1_DESIGN_MOVES_MS,
                             bytes=k1_train_bytes, bound_ms=k1_train_bound,
                             bound_by="operations" if k2_op_ms >= k1_train_bytes
                             / HBM_BYTES_PER_S * 1e3 else "bytes", **k1_train),
         K3_train_lists=k3_train,
         K4=dict(ms=k4_ms, previous_ms=K4_PREVIOUS_MS, by_rank_array_ms=k4_rank_ms,
                 plain_ms=k4_plain, library_ms=k4_lib,
                 library_call="torch.zeros((P+1, 10)).index_add_(0, rank, grads[:10].T)",
                 library_max_abs_err=k4_lib_err, ranks=P, run_slots=run_slots,
                 bytes=k4_bytes, bound_ms=k4_bound, profile=k4_profile,
                 by_rank_array_profile=k4_rank_profile))
    launches = sl["launches"]
    return [
        {"name": "K3 broadcast_fields", "route": "cuda",
         "source": "deblurgs_tpu_torch/csrc/broadcast_fields.cu",
         "replaces": "deblurgs_tpu/ops/pallas_blend.py:199", "launches": launches["K3"],
         "max_abs_err": k3_err, "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": "bytes", "library_ms": k3["library_ms"]},
        {"name": "K1 forward_mixed", "route": "cuda",
         "source": "deblurgs_tpu_torch/csrc/forward_mixed.cu",
         "replaces": "deblurgs_tpu/ops/pallas_blend_mixed.py:510", "launches": launches["K1"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": max(k1_byte_ms, k1_op_ms),
         "bound_by": "bytes" if k1_byte_ms >= k1_op_ms else "operations", "library_ms": None},
        {"name": "K2 backward_mixed", "route": "cuda",
         "source": "deblurgs_tpu_torch/csrc/backward_mixed.cu",
         "replaces": "deblurgs_tpu/ops/pallas_blend_mixed.py:728",
         "launches": tr["launches"]["K2"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": max(k2_byte_ms, k2_op_ms),
         "bound_by": "bytes" if k2_byte_ms >= k2_op_ms else "operations", "library_ms": None},
        {"name": "K4 reduce_sorted", "route": "cuda",
         "source": "deblurgs_tpu_torch/csrc/reduce_sorted.cu",
         "replaces": "deblurgs_tpu/ops/pallas_blend.py:858",
         "launches": tr["launches"]["K4"], "max_abs_err": k4_err, "ms": k4_ms,
         "plain_ms": k4_plain, "bound_ms": k4_bound, "bound_by": "bytes",
         "library_ms": k4_lib},
    ]


# ---------------------------------------------------------------------------
# the lockstep layout (K5, K6) and held-out evaluation
# ---------------------------------------------------------------------------


def rotation(axis_angle) -> np.ndarray:
    """Axis-angle [3] -> rotation matrix [3, 3] (float64, Rodrigues)."""
    v = np.asarray(axis_angle, np.float64)
    th = float(np.linalg.norm(v))
    if th == 0.0:
        return np.eye(3)
    k = v / th
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * (K @ K)


def view_camera(torch, rot: np.ndarray, center: np.ndarray, proj):
    """CameraArrays batched [1, ...] of a camera with c2w rotation ``rot``
    (columns: the camera axes in world) at ``center``."""
    from deblurgs_tpu_torch.core.camera import c2w_to_view, make_camera_arrays

    dev = proj.device
    view = c2w_to_view(torch.as_tensor(rot, dtype=torch.float32, device=dev)[None],
                       torch.as_tensor(center, dtype=torch.float32, device=dev)[None])
    return make_camera_arrays(view, proj)


def check_k5(torch, where: str, bcfg, staged, got, tiles=None) -> float:
    """K5's outputs against its plain version (on ``tiles`` or all): bit
    for bit, n_con included. Returns the max |diff| (0.0)."""
    from deblurgs_tpu_torch.ops import cuda_blend_lockstep as cbl

    want = cbl.forward_lockstep_ref(bcfg, staged.fields, staged.tile_start, staged.tile_stop,
                                    tiles=tiles)
    if tiles is not None:
        got = tuple(g[tiles] for g in got)
    for name, g, w in zip(("C", "D", "final_T", "n_con"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"K5 {where}: {name} differs from the plain version "
                                 f"(max |diff| {max_err(g, w):.3e})")
    return max(max_err(g, w) for g, w in zip(got[:3], want[:3]))


def check_k6(torch, where: str, bcfg, staged, bg, T, dl_pix, dl_d, C, D, got, tiles=None):
    """K6's per-slot gradients against its plain version (on ``tiles`` or
    all): slot for slot, bit for bit; rows 10-15 zero. Returns the max
    |diff| (0.0)."""
    from deblurgs_tpu_torch.ops import cuda_blend_lockstep as cbl
    from deblurgs_tpu_torch.ops import cuda_blend_mixed as cbm

    total = cbm.backward_total(bcfg, bg, T, dl_pix, dl_d, C, D)
    want = cbl.backward_lockstep_ref(bcfg, staged.fields, staged.tile_start, staged.tile_stop,
                                     dl_pix, dl_d, total, tiles=tiles)
    if tiles is not None:
        slots = tile_slots(torch, staged, tiles)
        got, want = got[:, slots], want[:, slots]
    if not bool((got[10:] == 0).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K6 {where}: rows 10-15 not zero or non-finite output")
    if not torch.equal(got, want):
        raise AssertionError(f"K6 {where}: differs from the plain version "
                             f"(max |diff| {max_err(got, want):.3e})")
    return max_err(got, want)


def phase_lockstep_parity(torch, dev):
    """K5 and K6 against their plain versions on one view of the parity
    scene, tile 16 and 32, need_n_contrib on and off (uncut lists with the
    warp cull, tile-culled lists without); K5 against K1 and K6 against K2
    on the same list; two K6 calls bitwise equal."""
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_lockstep as cbl
    from deblurgs_tpu_torch.ops import cuda_blend_mixed
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig

    W, H, N = PARITY_SIZE
    gaussians = make_scene(N, 2, np.random.default_rng(SEED + 1), dev)
    cs, proj = camera(W, H, 1.2, dev)
    cams = view_camera(torch, rotation([0.02, 0.1, 0.0]), np.array([0.3, 0.0, -6.0]), proj)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    errs, k5_err, k6_err = {}, 0.0, 0.0
    for tile in (16, 32):
        for need in (True, False):
            rcfg = RasterizeConfig(tile_w=tile, tile_h=tile, max_pairs=1 << 17,
                                   need_n_contrib=need, layout="lockstep")
            bcfg = rcfg.blend_config(cs)
            flat = flat_preprocess(gaussians, cams, cs, rcfg)
            st = cuda_blend.sort_stage(bcfg, *flat, bcfg.max_pairs)
            if int(st.total) > bcfg.max_pairs:
                raise AssertionError("lockstep parity scene overflows its pair budget")
            got = cbl.forward_lockstep(bcfg, st)
            torch.cuda.synchronize()
            name = f"t{tile}_{'n_contrib' if need else 'cull'}"
            k5_err = max(k5_err, check_k5(torch, f"parity {name}", bcfg, st, got))
            mixed = RasterizeConfig(tile_w=tile, tile_h=tile, max_pairs=1 << 17,
                                    need_n_contrib=need).blend_config(cs)
            k1 = cuda_blend_mixed.forward_mixed(mixed, st)
            if not all(torch.equal(a, b) for a, b in zip(got, k1)):
                raise AssertionError(f"K5 {name}: differs from K1 on the same list")
            C, D, T, _ = got
            dl_pix = torch.randn((bcfg.num_tiles, bcfg.tile_px, 3), generator=gen, device=dev)
            dl_d = 0.05 * torch.randn((bcfg.num_tiles, bcfg.tile_px), generator=gen, device=dev)
            pg = cbl.backward_lockstep(bcfg, st, bg, T, dl_pix, dl_d, C, D)
            k6_err = max(k6_err, check_k6(torch, f"parity {name}", bcfg, st, bg, T, dl_pix,
                                          dl_d, C, D, pg))
            if not torch.equal(pg, cbl.backward_lockstep(bcfg, st, bg, T, dl_pix, dl_d, C, D)):
                raise AssertionError(f"K6 {name}: two calls differ")
            if not torch.equal(pg, cuda_blend_mixed.backward_mixed(mixed, st, bg, T, dl_pix, dl_d,
                                                                   C, D)):
                raise AssertionError(f"K6 {name}: differs from K2 on the same list")
            errs[name] = dict(pairs=int(st.total), max_per_tile=int(st.max_per_tile),
                              n_con_max=int(got[3].max()), K5_equals_K1=True,
                              K6_equals_K2=True, K6_bitwise_repeat=True)
    emit("lockstep_parity", size=[W, H], gaussians=N, K5_max_abs_err=k5_err,
         K6_max_abs_err=k6_err, cases=errs)
    return k5_err, k6_err


def phase_train_lockstep(torch, dev):
    """``train_step`` with ``layout="lockstep"`` and ``batched_render=False``
    on the parity scene: every sub-frame renders through K5 and
    backpropagates through K6 and K4. Two steps; the kernel path's loss and
    pair count against the same step on the plain versions (the state
    copied to the CPU)."""
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
    from deblurgs_tpu_torch.train import checkpoint, step as step_lib
    from deblurgs_tpu_torch.train.config import OptimizationConfig

    W, H, N = PARITY_SIZE
    F = 3
    model = make_scene(N, 2, np.random.default_rng(SEED + 1), dev)
    params = gm.GaussianParams(*(getattr(model, k).detach() for k in gm.GaussianParams._fields))
    aux = gm.GaussianAux(torch.ones(N, dtype=torch.bool, device=dev),
                         *(torch.zeros(N, device=dev) for _ in range(3)))
    mcfg = motion_lib.MotionConfig(curve_order=9, n_subframes=F)
    motion = motion_lib.init_motion(
        torch.eye(3, device=dev)[None], torch.tensor([[0.0, 0.0, -6.0]], device=dev), mcfg,
        torch.Generator(device=dev).manual_seed(SEED), init_noise=0.01).params()
    cs, proj = camera(W, H, 1.2, dev)
    ocfg = OptimizationConfig(iterations=10_000, curve_start_iter=1, densify_from_iter=10**9,
                              opacity_reset_interval=10**9)
    rcfg = RasterizeConfig(tile_w=16, tile_h=16, max_pairs=1 << 17, need_n_contrib=False,
                           layout="lockstep")
    st = step_lib.TrainStatics(gcfg=gm.GaussianConfig(sh_degree=2), mcfg=mcfg, ocfg=ocfg,
                               rcfg=rcfg, cs=cs, sh_degree=2, n_sub=F, batched_render=False)
    state = step_lib.init_state(params, motion, aux)._replace(step=100)
    gt = torch.rand((H, W, 3), generator=torch.Generator(device=dev).manual_seed(SEED + 10),
                    device=dev)
    draws = [step_lib.draw_step(state._replace(step=100 + i), st, gt.shape,
                                torch.Generator(device=dev).manual_seed(SEED + i))
             for i in range(2)]
    zero_counts()
    s, losses_seen, pairs = state, [], []
    for d in draws:
        s, metrics = step_lib.train_step(s, gt, 0, proj, st, draws=d)
        losses_seen.append(float(metrics.loss))
        pairs.append(int(metrics.num_pairs))
    torch.cuda.synchronize()
    launches = read_counts()
    want = {"K3": 2 * F, "K1": 0, "K2": 0, "K4": 2 * F, "K5": 2 * F, "K6": 2 * F}
    if launches != want:
        raise AssertionError(f"lockstep train step launches {launches}, expected {want}")
    if not all(math.isfinite(x) for x in losses_seen) or int(s.overflow_count):
        raise AssertionError("lockstep train step: non-finite loss or overflow")
    # the first step again, on the plain versions
    state_cpu = checkpoint.state_from_arrays(checkpoint.state_to_arrays(state), device="cpu")
    d_cpu = type(draws[0])(*(None if x is None else x.cpu() for x in draws[0]))
    _, m_cpu = step_lib.train_step(state_cpu, gt.cpu(), 0, proj.cpu(), st, draws=d_cpu)
    err_loss = abs(float(m_cpu.loss) - losses_seen[0]) / abs(losses_seen[0])
    if err_loss > 1e-5 or int(m_cpu.num_pairs) != pairs[0]:
        raise AssertionError(f"lockstep train step: card loss {losses_seen[0]} / pairs "
                             f"{pairs[0]}, plain {float(m_cpu.loss)} / {int(m_cpu.num_pairs)}")
    emit("train_lockstep", size=[W, H], gaussians=N, subframes=F, tile=16, loss=losses_seen,
         pairs=pairs, launches=launches, loss_rel_err_vs_plain=err_loss)


def eval_poses(n: int, hold: int, rng: np.random.Generator):
    """The eval phase's cameras: ``n`` c2w rotations and centres on an arc
    of radius 6 around the origin, looking at it, and the held-out views'
    COLMAP poses, perturbed by about 0.5 degrees and 2 cm."""
    true, colmap_pose = [], []
    for i, a in enumerate(np.linspace(-0.35, 0.35, n)):
        rot = rotation([0.05 * math.sin(3 * a), a, 0.0])
        center = rot @ np.array([0.0, 0.0, -6.0])
        true.append((rot, center))
        if i % hold == 0:
            axis = rng.standard_normal(3)
            rot = rotation(math.radians(0.5) * axis / np.linalg.norm(axis)) @ rot
            shift = rng.standard_normal(3)
            center = center + 0.02 * shift / np.linalg.norm(shift)
        colmap_pose.append((rot, center))
    return true, colmap_pose


def write_eval_run(torch, dev, root: str) -> dict:
    """A synthetic trained run at full width, written with the port's own
    writers: the COLMAP scene (text), ground-truth PNGs rendered at the
    true poses, the Gaussian PLY, the curves and a ``cfg_args`` without
    ``kernel_layout`` / ``tile`` / ``window`` (so evaluation takes the
    lockstep layout at tile 16) and with a probed ``max_pairs``."""
    from PIL import Image

    from deblurgs_tpu_torch.data import colmap
    from deblurgs_tpu_torch.data.gaussian_ply import save_gaussian_ply
    from deblurgs_tpu_torch.eval.export import to_uint8
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib, tonemap
    from deblurgs_tpu_torch.ops import rasterize
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
    from deblurgs_tpu_torch.train.checkpoint import save_motion

    (W, H, N), n_cams, hold = EVAL_SIZE, EVAL_CAMERAS, EVAL_HOLD
    source, model_dir = os.path.join(root, "scene"), os.path.join(root, "model")
    sparse = os.path.join(source, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(source, "images"))
    model = make_scene(N, 2, np.random.default_rng(SEED), dev)
    fovx = 1.2
    cs, proj = camera(W, H, fovx, dev)
    true, colmap_pose = eval_poses(n_cams, hold, np.random.default_rng(SEED + 11))

    probe = RasterizeConfig(tile_w=16, tile_h=16)
    cams = [view_camera(torch, r, c, proj) for r, c in true + colmap_pose]
    max_pairs = max(size_max_pairs(model, c, cs, probe) for c in cams)
    rcfg = RasterizeConfig(tile_w=16, tile_h=16, max_pairs=max_pairs, layout="lockstep")
    rin = model.render_inputs()
    bg = torch.zeros(3, device=dev)
    for i, cam in enumerate(cams[:n_cams]):
        one = type(cam)(*(x[0] for x in cam))
        with torch.no_grad():
            out = rasterize.render(rin["means3d"], rin["scales"], rin["rotations"],
                                   rin["opacities"], rin["shs"], one, cs, bg, cfg=rcfg,
                                   sh_degree=2)
        if int(out.num_pairs) > max_pairs:
            raise AssertionError("ground-truth render overflows its pair budget")
        img = torch.clamp(tonemap.tone_map(out.image, "gamma"), 0.0, 1.0)
        Image.fromarray(to_uint8(img)).save(os.path.join(source, "images", f"{i:03d}.png"))

    fx, fy = W / (2 * cs.tanfovx), H / (2 * cs.tanfovy)
    colmap.write_cameras_text({1: colmap.ColmapCamera(1, "PINHOLE", W, H,
                                                      np.array([fx, fy, W / 2, H / 2]))},
                              os.path.join(sparse, "cameras.txt"))
    images = {}
    for i, (rot, center) in enumerate(colmap_pose):
        # CameraInfo.R = c2w rotation = qvec2rotmat(qvec).T; T = -center @ rot
        images[i + 1] = colmap.ColmapImage(i + 1, colmap.rotmat2qvec(rot.T), -center @ rot, 1,
                                           f"{i:03d}.png", np.zeros((0, 2)), np.zeros(0, np.int64))
    colmap.write_images_text(images, os.path.join(sparse, "images.txt"))
    pts = model.xyz.detach()[:1000].cpu().numpy()
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i, p in enumerate(pts):
            f.write(f"{i} {p[0]:.7g} {p[1]:.7g} {p[2]:.7g} 128 128 128 0.5\n")

    params = gm.GaussianParams(*(getattr(model, k).detach() for k in gm.GaussianParams._fields))
    aux = gm.GaussianAux(torch.ones(N, dtype=torch.bool, device=dev),
                         *(torch.zeros(N, device=dev) for _ in range(3)))
    save_gaussian_ply(os.path.join(model_dir, "point_cloud", "iteration_7000",
                                   "point_cloud.ply"), params, aux, gm.GaussianConfig(sh_degree=2))
    train = [t for i, t in enumerate(true) if i % hold]
    motion = motion_lib.init_motion(
        torch.as_tensor(np.stack([r for r, _ in train]), dtype=torch.float32, device=dev),
        torch.as_tensor(np.stack([c for _, c in train]), dtype=torch.float32, device=dev),
        motion_lib.MotionConfig(curve_order=9, n_subframes=21),
        torch.Generator(device=dev).manual_seed(SEED))
    save_motion(os.path.join(model_dir, "cm.npz"), motion.params())
    with open(os.path.join(model_dir, "cfg_args"), "w") as f:
        f.write(f"Namespace(source_path={source!r}, model_path={model_dir!r}, sh_degree=2, "
                f"curve_order=9, num_subframes=21, curve_type='se3', resolution=1, eval=True, "
                f"llffhold={hold}, max_pairs={max_pairs}, images='images')")
    return dict(source=source, model=model_dir, max_pairs=max_pairs, true=true)


class RenderLog:
    """Wraps ``render`` where the eval modules call it (``session.render``,
    which ``render_fitted`` calls): every render's pair count is recorded
    with the budget it ran under and held to ``max_pairs`` unless that is
    None. A render past its budget must be followed by the same view's
    render at a budget that holds it (``render_fitted``); ``regrown``
    counts them."""

    def __init__(self, max_pairs: int | None):
        self.max_pairs, self.pairs, self.longest, self.calls = max_pairs, 0, 0, 0
        self.budget, self.regrown, self.over = None, 0, None
        self.k_max = set()        # the k_max of every render (the xla walk's cap)
        self.k_over, self.k_regrown = None, 0

    def install(self):
        from deblurgs_tpu_torch.eval import session

        real = session.render

        def render(*args, **kwargs):
            out = real(*args, **kwargs)
            n, budget = int(out.num_pairs), kwargs["cfg"].max_pairs
            if self.max_pairs is not None and n > self.max_pairs:
                raise AssertionError(f"pair overflow in evaluation: {n} > {self.max_pairs}")
            if self.over is not None and (n != self.over or n > budget):
                raise AssertionError(f"a render of {self.over} pairs past its budget was not "
                                     f"rendered again at one that holds it ({n}, {budget})")
            self.over = n if n > budget else None
            self.regrown += n > budget
            self.pairs, self.calls = max(self.pairs, n), self.calls + 1
            longest, k_max = int(out.max_per_tile), kwargs["cfg"].k_max
            if self.k_over is not None and (longest != self.k_over or longest > k_max):
                raise AssertionError(f"an xla render whose longest list ({self.k_over}) "
                                     f"passed k_max was not rendered again at one that "
                                     f"holds it ({longest}, {k_max})")
            past = kwargs["cfg"].backend == "xla" and longest > k_max
            self.k_over = longest if past else None
            self.k_regrown += past
            self.longest = max(self.longest, longest)
            self.budget = budget
            self.k_max.add(k_max)
            return out

        session.render = render
        return real

    def check(self):
        if self.over is not None:
            raise AssertionError(f"the last render ({self.over} pairs) was past its budget")
        if self.k_over is not None:
            raise AssertionError(f"the last render's longest list ({self.k_over}) was past "
                                 "its k_max")

    @staticmethod
    def remove(real):
        from deblurgs_tpu_torch.eval import session

        session.render = real


def median(xs):
    return float(np.median(np.asarray(xs)))


def phase_eval(torch, dev):
    """Held-out evaluation at full width through the user's entry points:
    ``cli.evaluate.main`` on a synthetic run, then ``optimize_test_poses``
    with 30 iterations a view; launch counts, pair budget, pose-fit
    criterion, timings, and K5/K6 against their plain versions on sampled
    tiles with the pose loss's own cotangent."""
    import tempfile

    from deblurgs_tpu_torch.cli import evaluate
    from deblurgs_tpu_torch.data.scene import load_image
    from deblurgs_tpu_torch.eval import pose_opt
    from deblurgs_tpu_torch.eval.session import load_session, render_view
    from deblurgs_tpu_torch.models import gaussians as gm, tonemap
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_lockstep as cbl
    from deblurgs_tpu_torch.ops import tile_blend
    from deblurgs_tpu_torch.train.losses import l1_loss

    (W, H, N) = EVAL_SIZE
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        run = write_eval_run(torch, dev, root)
        write_s = time.perf_counter() - t0
        log = RenderLog(run["max_pairs"])
        real = log.install()
        try:
            # ---- the main path, counted ----
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()     # what earlier phases still hold
            zero_counts()
            t0 = time.perf_counter()
            results = evaluate.main(["-m", run["model"], "-r", "1", "--backend", "pallas",
                                     "--num_iter_per_view", "2", "--device", str(dev)])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            session = load_session(run["model"], resolution=1, backend="pallas", device=dev)
            test = session.scene.info.test_cameras
            gts = torch.as_tensor(np.stack([load_image(c, 1) for c in test]), device=dev)
            R = torch.as_tensor(np.stack([c.R for c in test]), dtype=torch.float32, device=dev)
            T = torch.as_tensor(np.stack([c.T for c in test]), dtype=torch.float32, device=dev)
            proj = torch.as_tensor(session.scene.proj, device=dev)

            def l1(pose, i):
                img, _ = render_view(session, pose_opt.pose_to_camera(pose, i, proj))
                return float(l1_loss(img, gts[i]))

            start = pose_opt.init_pose_params(R, T)
            l1_start = [l1(start, i) for i in range(len(test))]
            fit = pose_opt.optimize_test_poses(session, gts, R, T, proj, num_iter_per_view=30,
                                               lr_trans=5e-3, verbose=False)
            l1_fit = [l1(fit, i) for i in range(len(test))]
            torch.cuda.synchronize()
            launches = read_counts()
            peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        finally:
            RenderLog.remove(real)
        with open(os.path.join(run["model"], "eval.txt")) as f:
            eval_txt = f.read().strip().splitlines()
        artifacts = sorted(os.path.relpath(os.path.join(d, x), run["model"])
                           for d, _, files in os.walk(os.path.join(run["model"], "test"))
                           for x in files)
    if [line.split(":")[0] for line in eval_txt] != ["unfit", "fit"]:
        raise AssertionError(f"eval.txt: {eval_txt}")
    want_files = [f"test/{s}/{k}/{i:03d}.png" for s in ("fit", "unfit")
                  for k in ("error", "gt", "renders") for i in range(len(test))]
    if artifacts != sorted(want_files):
        raise AssertionError(f"evaluate wrote {artifacts}")
    for name in ("K3", "K4", "K5", "K6"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by evaluation: {launches}")
    if launches["K1"] or launches["K2"]:
        raise AssertionError(f"evaluation launched the mixed kernels: {launches}")
    for i, (a, b) in enumerate(zip(l1_start, l1_fit)):
        if not b < 0.7 * a:
            raise AssertionError(f"pose refinement of view {i}: L1 {a:.5f} -> {b:.5f}, "
                                 f"not below 0.7x its start")
    for split in ("unfit", "fit"):
        if not all(math.isfinite(results[split][k]) for k in ("PSNR", "SSIM")):
            raise AssertionError(f"non-finite metrics: {results}")

    # ---- timings: render_view, the pose-refinement step as optimize_test_poses
    # runs it (its per-step host sync and StepLR included), and its parts ----
    cam0 = pose_opt.pose_to_camera(fit, 0, proj)
    render_ms = []
    for it in range(9):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        render_view(session, cam0)
        ev[1].record()
        torch.cuda.synchronize()
        if it >= 2:
            render_ms.append(ev[0].elapsed_time(ev[1]))

    def refine(iters):
        return pose_opt.optimize_test_poses(session, gts, R, T, proj, num_iter_per_view=iters,
                                            lr_trans=5e-3, verbose=False)

    refine(1)
    loop_ms = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        refine(POSE_TIMED_ITERS)
        ev[1].record()
        torch.cuda.synchronize()
        loop_ms.append(ev[0].elapsed_time(ev[1]) / (POSE_TIMED_ITERS * len(test)))
    profile = device_profile(torch, lambda: refine(1))

    # a copy of the loop's step, timed in parts (no per-step sync, no StepLR)
    quat = fit.quat.clone().requires_grad_(True)
    trans = fit.trans.clone().requires_grad_(True)
    opt = torch.optim.Adam([{"params": [quat], "lr": 5e-5}, {"params": [trans], "lr": 5e-4}],
                           eps=1e-15)
    rin = gm.render_inputs(session.params, session.gcfg)
    rin = {k: v.detach() for k, v in rin.items()}
    from deblurgs_tpu_torch.ops.rasterize import render

    def pose_step(ev=None):
        if ev:
            ev[0].record()
        cam = pose_opt.pose_to_camera(pose_opt.PoseParams(quat, trans), 0, proj)
        out = render(rin["means3d"], rin["scales"], rin["rotations"], rin["opacities"],
                     rin["shs"], cam, session.scene.camera_static, torch.zeros(3, device=dev),
                     cfg=session.rcfg, sh_degree=2, active=session.aux.active)
        loss = l1_loss(torch.clamp(tonemap.tone_map(out.image, session.tone_mapping), 0, 1),
                       gts[0])
        if ev:
            ev[1].record()
        opt.zero_grad(set_to_none=False)
        loss.backward()
        if ev:
            ev[2].record()
        opt.step()
        if ev:
            ev[3].record()

    parts = {"step": [], "forward": [], "backward": [], "adam": []}
    for it in range(9):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        pose_step(ev)
        torch.cuda.synchronize()
        if it >= 2:
            parts["step"].append(ev[0].elapsed_time(ev[3]))
            parts["forward"].append(ev[0].elapsed_time(ev[1]))
            parts["backward"].append(ev[1].elapsed_time(ev[2]))
            parts["adam"].append(ev[2].elapsed_time(ev[3]))
    bcfg = session.rcfg.blend_config(session.scene.camera_static)

    def make_flat():
        cams = pose_opt.pose_to_camera(fit, 0, proj)
        return flat_preprocess((rin, 2), type(cams)(*(x[None] for x in cams)),
                               session.scene.camera_static, session.rcfg, session.aux.active)

    stages = forward_stages(torch, bcfg, make_flat, torch.zeros(3, device=dev), 1, reps=5,
                            composite=cbl.forward_lockstep)

    # ---- K5 and K6 against their plain versions on 64 sampled tiles ----
    with torch.no_grad():
        staged = cuda_blend.sort_stage(bcfg, *make_flat(), bcfg.max_pairs)
        C, D, T_, n_con = cbl.forward_lockstep(bcfg, staged)
        image = tile_blend.compose(bcfg, C, D, T_, n_con, torch.zeros(3, device=dev))[0]
    img = image.detach().requires_grad_(True)
    loss = l1_loss(torch.clamp(tonemap.tone_map(img, session.tone_mapping), 0, 1), gts[0])
    d_img = torch.autograd.grad(loss, img)[0]
    dl_pix = tile_blend._images_to_tiles(bcfg, d_img)
    dl_d = torch.zeros_like(D)
    bg = torch.zeros(3, device=dev)
    pg = cbl.backward_lockstep(bcfg, staged, bg, T_, dl_pix, dl_d, C, D)
    tiles = torch.from_numpy(np.random.default_rng(SEED + 12).choice(
        bcfg.num_tiles, 64, replace=False)).to(dev)
    err_k5 = check_k5(torch, "eval (64 tiles)", bcfg, staged, (C, D, T_, n_con), tiles=tiles)
    err_k6 = check_k6(torch, "eval (64 tiles)", bcfg, staged, bg, T_, dl_pix, dl_d, C, D, pg,
                      tiles=tiles)
    emit("eval", width=W, height=H, gaussians=N, sh_degree=2, views=EVAL_CAMERAS,
         held_out=len(test), tile=16, layout=session.rcfg.layout,
         need_n_contrib=session.rcfg.need_n_contrib, max_pairs=run["max_pairs"],
         max_num_pairs=log.pairs, max_per_tile=log.longest, renders=log.calls,
         write_run_s=round(write_s, 3), cli_s=round(cli_s, 3),
         unfit=results["unfit"], fit=results["fit"], l1_start=l1_start, l1_fit_30=l1_fit,
         launches=launches, render_view_ms=round(median(render_ms), 4),
         render_view_ms_all=[round(x, 4) for x in render_ms],
         pose_step_ms=round(median(loop_ms), 4),
         pose_step_ms_all=[round(x, 4) for x in loop_ms],
         pose_step_copy_ms=round(median(parts["step"]), 4),
         pose_step_copy_parts_ms={k: round(median(v), 4) for k, v in parts.items()
                                  if k != "step"},
         render_stages_no_grad_ms=stages, peak_memory_gb=round(peak_gb, 3),
         err_k5_sampled_tiles=err_k5, err_k6_sampled_tiles=err_k6, profile=profile)
    return dict(bcfg=bcfg, staged=staged, out=(C, D, T_, n_con), dl_pix=dl_pix, dl_d=dl_d,
                pg=pg, launches=launches, err_k5=err_k5, err_k6=err_k6)


def write_train_scene(torch, dev, root: str) -> dict:
    """The eval phase's synthetic scene (``write_eval_run``: 1920×1080 PNGs
    along the eval arc, views 000 and 004 held out) with ``bench.py``'s
    100k Gaussians as its COLMAP point cloud, each point in its Gaussian's
    DC colour."""
    from deblurgs_tpu_torch.core.sh import sh_to_rgb

    run = write_eval_run(torch, dev, os.path.join(root, "eval_run"))
    model = make_scene(EVAL_SIZE[2], 2, np.random.default_rng(SEED), dev)
    pts = model.xyz.detach().cpu().numpy()
    rgb = np.clip(sh_to_rgb(model.f_dc.detach()[:, 0]).cpu().numpy(), 0, 1)
    rgb = (rgb * 255).round().astype(int)
    with open(os.path.join(run["source"], "sparse", "0", "points3D.txt"), "w") as f:
        for i, (p, c) in enumerate(zip(pts, rgb)):
            f.write(f"{i} {p[0]:.7g} {p[1]:.7g} {p[2]:.7g} {c[0]} {c[1]} {c[2]} 0.5\n")
    return run


class Timed:
    """Wraps a method or function where the training CLI looks it up, and
    adds each call's seconds (the device synchronised before and after)."""

    def __init__(self, torch, owner, name: str):
        self.owner, self.name, self.real = owner, name, getattr(owner, name)
        self.seconds, self.calls = 0.0, 0

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        setattr(owner, name, wrapped)

    def remove(self):
        setattr(self.owner, self.name, self.real)


class ChildLog:
    """Runs the training CLI's child commands as its ``do_system`` does (a
    non-zero exit raises), their output echoed and kept, and reads from it
    the session budget growths ``render_fitted`` prints."""

    GROWTH = re.compile(r"a view emits (\d+) pairs: the session's max_pairs → (\d+)")

    def __init__(self, owner):
        self.owner, self.real, self.children = owner, owner.do_system, []

        def do_system(cmd: str):
            print(f"==== running: {cmd}", flush=True)
            out = subprocess.run(cmd, shell=True, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            sys.stdout.write(out.stdout)
            sys.stdout.flush()
            self.children.append(dict(
                module=cmd.split(" -m ")[1].split()[0], exit=out.returncode,
                budget_growths=[[int(n), int(m)] for n, m in self.GROWTH.findall(out.stdout)]))
            if out.returncode:
                raise RuntimeError(f"command failed with code {out.returncode}: {cmd}")

        owner.do_system = do_system

    def remove(self):
        self.owner.do_system = self.real


def phase_train_cli(torch, dev, train_step_ms):
    """The training run as a user starts it: ``cli.train.main`` at its
    defaults (pallas, mixed, tile 32, batched render, F = 21, order-9 se3
    curves, SH 2, autosized ``max_pairs``, visualizer and final render on)
    on the synthetic 1920×1080 / 100k scene, 40 iterations with a densify
    event, then a resume from its checkpoint, ``cli.evaluate.main`` and
    ``cli.metrics.main`` on the run; 20 more blur-phase iterations of
    ``Trainer.train`` timed with CUDA events at each drain, and 10 more,
    not timed, with their host syncs counted; the bare step on the same
    state at the loop's budget and at the emitted pairs + 10%, with its
    forward stages; and K1-K4 against their plain versions on one step's
    inputs at the loop's budget. Returns K1-K4's largest absolute errors."""
    import tempfile
    import warnings

    from deblurgs_tpu_torch.cli import evaluate, metrics as metrics_cli, train as train_cli
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed
    from deblurgs_tpu_torch.train import loop, step as step_lib
    from deblurgs_tpu_torch.utils import visualizer

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        run = write_train_scene(torch, dev, root)
        write_s = time.perf_counter() - t0
        source, model = run["source"], os.path.join(root, "model")
        seen = {"loss": [], "num_pairs": [], "overflowed": 0}
        trainers = []
        real_train = loop.Trainer.train

        def train(self, state, *args, **kwargs):
            def record(it, m):
                seen["loss"].append(float(m.loss))
                seen["num_pairs"].append(int(m.num_pairs))
                seen["overflowed"] += int(m.overflowed)

            self.on_metrics = record
            trainers.append(self)
            return real_train(self, state, *args, **kwargs)

        grown = []
        real_grow = loop.grow_capacity
        loop.grow_capacity = lambda st, cap: (grown.append(cap), real_grow(st, cap))[1]
        loop.Trainer.train = train
        children = ChildLog(train_cli)
        timers = {name: Timed(torch, loop.Trainer, name) for name in ("autosize_max_pairs",)}
        timers.update({name: Timed(torch, visualizer.Visualizer, name)
                       for name in ("run", "traj_render", "visualize_alignment", "save_video")})
        timers["final_render"] = Timed(torch, train_cli, "do_system")
        flags = ["-s", source, "-m", model, "-r", "1", "--iterations", "40",
                 "--curve_start_iter", "10", "--densify_from_iter", "15",
                 "--densification_interval", "10", "--densify_until_iter", "35",
                 "--save_iterations", "20", "--checkpoint_iterations", "20",
                 "--render_iterations", "30", "--eval", "--llffhold", str(EVAL_HOLD),
                 "--device", str(dev)]
        try:
            # ---- the main path, counted: the training CLI at its defaults ----
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            zero_counts()
            t0 = time.perf_counter()
            state = train_cli.main(flags)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = read_counts()
            peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
            trainer = trainers[0]
            max_pairs = trainer.rcfg.max_pairs
            cli_seen = dict(seen, loss=list(seen["loss"]), num_pairs=list(seen["num_pairs"]))
            # ---- resume from the iteration-20 checkpoint for four iterations ----
            t0 = time.perf_counter()
            resumed = train_cli.main([
                "-s", source, "-m", os.path.join(root, "resumed"), "-r", "1",
                "--start_checkpoint", os.path.join(model, "chkpnt20.npz"), "--iterations", "24",
                "--curve_start_iter", "10", "--densify_from_iter", "15",
                "--densification_interval", "10", "--densify_until_iter", "35",
                "--eval", "--llffhold", str(EVAL_HOLD), "--disable_curve_visualize",
                "--skip_final_render", "--device", str(dev)])
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
        finally:
            loop.Trainer.train = real_train
            loop.grow_capacity = real_grow
            for timer in timers.values():
                timer.remove()
            children.remove()
        # ---- evaluate (a few pose iterations) and the metrics CLI on the run;
        # a render past the session's budget must be rendered again ----
        log = RenderLog(None)
        real = log.install()
        try:
            t0 = time.perf_counter()
            results = evaluate.main(["-m", model, "-r", "1", "--num_iter_per_view", "3",
                                     "--device", str(dev)])
            torch.cuda.synchronize()
            evaluate_s = time.perf_counter() - t0
        finally:
            RenderLog.remove(real)
        log.check()
        t0 = time.perf_counter()
        scores = metrics_cli.main(["-m", model, "--device", str(dev)])
        metrics_s = time.perf_counter() - t0
        with open(os.path.join(model, "eval.txt")) as f:
            eval_txt = f.read().strip().splitlines()
        with open(os.path.join(model, "results.json")) as f:
            results_json = json.load(f)
        with open(os.path.join(model, "time.txt")) as f:
            time_txt = f.read().strip().splitlines()
        files = sorted(os.path.relpath(os.path.join(d, x), model)
                       for d, _, names in os.walk(model) for x in names)

    # ---- the timed window: 20 more blur-phase iterations, no visualizer ----
    timed = loop.Trainer(
        scene=trainer.scene, gcfg=trainer.gcfg, mcfg=trainer.mcfg,
        ocfg=dataclasses.replace(trainer.ocfg, iterations=1000), rcfg=trainer.rcfg,
        tone_mapping=trainer.tone_mapping, batched_render=trainer.batched_render,
        device=dev, seed=SEED + 13)
    first = int(state.step)
    marks, walls = [], []
    real_drain = timed._drain

    def drain(st, rcfg):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        walls.append(time.perf_counter())
        return real_drain(st, rcfg)

    timed._drain = drain
    state = timed.train(state, first, iterations=first + 9)   # warm-up: one drain
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_timed = torch.cuda.memory_allocated()
    marks.clear()
    walls.clear()
    start = torch.cuda.Event(enable_timing=True)
    zero_counts()
    start.record()
    wall0 = time.perf_counter()
    state = timed.train(state, first + 10, iterations=first + 29)
    torch.cuda.synchronize()
    timed_launches = read_counts()
    timed_peak_gb = (torch.cuda.max_memory_allocated() - held_timed) / 1e9
    edges = [start] + marks
    window_ms = [a.elapsed_time(b) / timed.sync_every for a, b in zip(edges, edges[1:])]
    host_ms = [(b - a) * 1e3 / timed.sync_every for a, b in zip([wall0] + walls, walls)]
    timed._drain = real_drain

    # ---- host syncs: 10 more iterations under the sync debug mode, not timed ----
    window_pairs = []              # read after the window: no sync of its own
    timed.on_metrics = lambda it, m: window_pairs.append(m.num_pairs)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state = timed.train(state, first + 30, iterations=first + 39)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync_sites = collections.Counter(
        f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    syncs = sum(sync_sites.values())
    window_pairs = [int(x) for x in window_pairs]

    # ---- the bare step on the same state, the loop's budget against the
    # emitted pairs + 10% (the train phase's sizing), and its forward stages ----
    sh_degree, n_sub, random_sample = timed.phase_statics(int(state.step))
    tight = max((int(max(window_pairs) * 1.1) + 1023) & ~1023, 1 << 14)
    budgets = {"loop": max_pairs, "tight": tight}
    statics = {k: timed.statics(sh_degree, n_sub, random_sample,
                                dataclasses.replace(timed.rcfg, max_pairs=b))
               for k, b in budgets.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    n_views = timed.scene.num_train
    bare = {k: {"ms": [], "num_pairs": [], "overflowed": 0} for k in budgets}
    for rep in range(6):
        for k, st in statics.items():
            cam = rep % n_views
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            _, m = step_lib.train_step(state, timed._gts[cam], cam, timed._proj, st,
                                       generator=gen)
            b.record()
            torch.cuda.synchronize()
            if rep:                                       # the first of each is warm-up
                bare[k]["ms"].append(a.elapsed_time(b))
            bare[k]["num_pairs"].append(int(m.num_pairs))
            bare[k]["overflowed"] += int(m.overflowed)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)

    def make_flat():
        nu = motion_lib.sample_nus(state.motion, [0], timed.mcfg)
        cams = motion_lib.subframe_cameras_batch(state.motion, [0], nu, timed._proj, timed.mcfg)
        return flat_preprocess((gm.render_inputs(state.params, timed.gcfg), sh_degree), cams,
                               timed.scene.camera_static, timed.rcfg, state.aux.active)

    for k, st in statics.items():
        bare[k]["max_pairs"] = budgets[k]
        bare[k]["median_ms"] = round(median(bare[k]["ms"]), 4)
        bare[k]["ms"] = [round(x, 4) for x in bare[k]["ms"]]
        bare[k]["forward_stages_no_grad_ms"] = forward_stages(
            torch, st.rcfg.blend_config(st.cs, n_images=n_sub), make_flat, bg, n_sub)

    # ---- K1-K4 against their plain versions on one step's inputs at the
    # loop's budget: K3 and K4 in full, K1 and K2 on 64 sampled tiles ----
    st = statics["loop"]
    k = step_kernel_inputs(torch, st, state, timed._gts[0], bg, 0, timed._proj)
    bcfg, staged = k["bcfg"], k["staged"]
    fslot = cuda_blend.broadcast_fields(k["compact"].ctable, k["compact"].gauss_c)
    err_k3 = check_k3(torch, "train_cli", fslot, k["compact"])
    del fslot
    tiles = torch.from_numpy(np.random.default_rng(SEED + 15).choice(
        bcfg.total_tiles, 64, replace=False)).to(dev)
    err_k1 = check_k1(torch, "train_cli (64 tiles)", bcfg, staged,
                      (k["C"], k["D"], k["T"], k["n_con"]), tiles=tiles)
    kargs = (bg, k["T"], k["dl_pix"], k["dl_d"], k["C"], k["D"])
    pg = cuda_blend_mixed.backward_mixed(bcfg, staged, *kargs)
    err_k2 = check_k2(torch, "train_cli (64 tiles)", bcfg, staged, *kargs, pg, tiles=tiles)
    err_k4 = check_k4(torch, "train_cli", staged, pg, k["P"])
    kernel_check = dict(max_pairs=staged.fields.shape[1], num_pairs=int(k["flat"][-1].sum()),
                        err_k3=err_k3, err_k1_sampled_tiles=err_k1,
                        err_k2_sampled_tiles=err_k2, err_k4=err_k4)
    del k, staged, pg, kargs

    need = ["args.txt", "cfg_args", "input.ply", "cameras.json", "time.txt", "cm.npz",
            "chkpnt20.npz", "point_cloud/iteration_20/point_cloud.ply",
            "point_cloud/iteration_40/point_cloud.ply"]
    missing = [f for f in need if f not in files]
    for d in ("spiral/iteration_40/", "trainview/iteration_40/"):
        if not any(f.startswith(d) for f in files):
            missing.append(d)
    if not any(f in files for f in ("vis/training.mp4", "vis/training.gif")):
        missing.append("vis/training.{mp4,gif}")
    if missing:
        raise AssertionError(f"the training run did not write {missing}")
    if len(cli_seen["loss"]) != 40 or not all(map(math.isfinite, cli_seen["loss"])):
        raise AssertionError(f"drained losses: {cli_seen['loss']}")
    if cli_seen["overflowed"] or time_txt[-1] != "Overflowed iterations = 0":
        raise AssertionError(f"pair overflow in training: {time_txt}")
    for name in ("K1", "K2", "K3", "K4"):
        if launches[name] < 40:
            raise AssertionError(f"{name} launched {launches[name]} times by the training CLI")
    if resumed.step != 25 or int(state.step) != first + 40 or first % 10 != 1:
        raise AssertionError(f"resume at {resumed.step}, timed windows at {state.step}")
    if int(state.overflow_count) or bare["loop"]["overflowed"]:
        raise AssertionError("pair overflow in the timed windows or the bare step")
    if [c["module"] for c in children.children] != [
            "deblurgs_tpu_torch.cli.render_spiral", "deblurgs_tpu_torch.cli.render_trainview"]:
        raise AssertionError(f"child processes: {children.children}")
    if [line.split(":")[0] for line in eval_txt] != ["unfit", "fit"]:
        raise AssertionError(f"eval.txt: {eval_txt}")
    if sorted(results_json) != ["fit", "unfit"] or not all(
            math.isfinite(results_json[k]["PSNR"]) for k in results_json):
        raise AssertionError(f"results.json: {results_json}")
    if not all(math.isfinite(results[k]["PSNR"]) for k in ("unfit", "fit")):
        raise AssertionError(f"evaluate: {results}")
    for name in ("K1", "K2", "K3", "K4"):
        if timed_launches[name] != 20:
            raise AssertionError(f"{name}: {timed_launches[name]} launches in 20 iterations")
    emit("train_cli", width=EVAL_SIZE[0], height=EVAL_SIZE[1], points=EVAL_SIZE[2],
         train_views=trainer.scene.num_train, subframes=trainer.mcfg.n_subframes,
         tile=trainer.rcfg.tile_w, iterations=40, autosize_s=round(
             timers["autosize_max_pairs"].seconds, 3), max_pairs=max_pairs,
         max_num_pairs=max(cli_seen["num_pairs"]), num_pairs=cli_seen["num_pairs"],
         gaussian_capacity_growths=grown, final_gaussians=int(state.aux.active.sum()),
         capacity=int(state.params.xyz.shape[0]), loss=[round(x, 6) for x in cli_seen["loss"]],
         launches=launches, peak_memory_gb=round(peak_gb, 3),
         loop_ms_per_iter=round(median(window_ms), 4),
         loop_ms_per_iter_windows=[round(x, 4) for x in window_ms],
         loop_host_ms_per_iter=[round(x, 4) for x in host_ms],
         bare_step=bare, train_phase_step_ms=round(median(train_step_ms), 4),
         syncs_per_iter=syncs / 10, sync_window_num_pairs=window_pairs,
         sync_sites_per_iter={k: v / 10 for k, v in sync_sites.most_common(16)},
         launches_per_iter={k: v / 20 for k, v in timed_launches.items()},
         timed_peak_memory_gb=round(timed_peak_gb, 3), kernel_check=kernel_check,
         seconds={"write_scene": round(write_s, 3), "cli": round(cli_s, 3),
                  "visualizer": round(sum(timers[k].seconds for k in (
                      "run", "traj_render", "visualize_alignment", "save_video")), 3),
                  "visualizer_shots": timers["run"].calls,
                  "save_video": round(timers["save_video"].seconds, 3),
                  "final_render": round(timers["final_render"].seconds, 3),
                  "resume": round(resume_s, 3), "evaluate": round(evaluate_s, 3),
                  "metrics": round(metrics_s, 3)},
         children=children.children, session_max_pairs=log.budget,
         eval_max_num_pairs=log.pairs, eval_renders=log.calls,
         eval_renders_past_budget=log.regrown, unfit=results["unfit"], fit=results["fit"],
         metrics=scores[model], time_txt=time_txt)
    return dict(K1=err_k1, K2=err_k2[1], K3=err_k3, K4=err_k4[1])


def phase_yardstick_lockstep(torch, ev, k5_err: float, k6_err: float):
    """K5 and K6 timed at the eval phase's shapes beside their plain
    versions, bounds (reckoned as for K1 and K2), times before the
    redesign and after each design move (as recorded); on the same lists K1
    and K2 without the warp cull (the floor the cull must beat), held
    bitwise to their plain versions; the (warp, pair) visits of K1's
    schedule there, those the cull skips and a check that none of them
    composites; the longest list and one block's time on it alone; K6's
    registers and SASS pair loop. Returns their entries of the kernels
    line."""
    from deblurgs_tpu_torch.ops import cuda_blend_lockstep as cbl
    from deblurgs_tpu_torch.ops import cuda_blend_mixed as cbm
    from deblurgs_tpu_torch.ops import kernels

    bcfg, st = ev["bcfg"], ev["staged"]
    st = st._replace(tile_start=st.tile_start.to(torch.int32),
                     tile_stop=st.tile_stop.to(torch.int32))
    C, D, T, _ = ev["out"]
    bg = torch.zeros(3, device=st.fields.device)
    kargs = (bg, T, ev["dl_pix"], ev["dl_d"], C, D)
    args = (bcfg, st.fields, st.tile_start, st.tile_stop)
    total = cbm.backward_total(bcfg, *kargs)

    def plain_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    k5_ms = cuda_ms(lambda: cbl.forward_lockstep(bcfg, st), 20)
    k6_ms = cuda_ms(lambda: cbl.backward_lockstep(bcfg, st, *kargs), 20)
    k5_plain, want5 = plain_ms(lambda: cbl.forward_lockstep_ref(*args))
    k6_plain, want6 = plain_ms(lambda: cbl.backward_lockstep_ref(*args, kargs[2], kargs[3], total))
    # K1 and K2 on the same lists without the cull, held bitwise to the
    # plain versions, then timed
    got = cbm.launch_forward("K1", bcfg, st, cull=False)
    if not all(torch.equal(a, b) for a, b in zip(got, want5)):
        raise AssertionError("K1 without the cull: differs from the plain version on the eval "
                             "lists")
    if not torch.equal(cbm.launch_backward("K2", bcfg, st, *kargs, cull=False), want6):
        raise AssertionError("K2 without the cull: differs from the plain version on the eval "
                             "lists")
    k1_ms = cuda_ms(lambda: cbm.launch_forward("K1", bcfg, st, cull=False), 20)
    k2_ms = cuda_ms(lambda: cbm.launch_backward("K2", bcfg, st, *kargs, cull=False), 20)
    # visits of K1's schedule (the outputs held bitwise to K5's)
    *sched, visits = cbm.forward_schedule(*args)
    if not all(torch.equal(a, b) for a, b in zip(sched, want5)):
        raise AssertionError("K1's schedule differs from the plain version on the eval lists")
    v = {k: int(x) for k, x in visits.items()}
    if v["culled_composite"]:
        raise AssertionError(f"the warp cull skipped {v['culled_composite']} visits that "
                             "composite")
    v["composite_share"] = v["composite"] / v["warp_exit"]
    v["culled_share"] = v["culled"] / v["warp_exit"]
    # the longest list's block alone: every other range emptied, less the
    # launch with every range emptied
    counts = st.tile_stop - st.tile_start
    longest = int(torch.argmax(counts))
    empty = st._replace(tile_stop=st.tile_start.clone())
    alone = empty._replace(tile_stop=torch.where(
        torch.arange(counts.shape[0], device=counts.device) == longest, st.tile_stop,
        st.tile_start))
    tail = {}
    for name, fn in (("K5", lambda x: cbl.forward_lockstep(bcfg, x)),
                     ("K6", lambda x: cbl.backward_lockstep(bcfg, x, *kargs))):
        t_alone, t_empty = cuda_ms(lambda: fn(alone), 20), cuda_ms(lambda: fn(empty), 20)
        tail[name] = dict(alone_ms=t_alone, empty_ms=t_empty, block_ms=t_alone - t_empty)
    evals = v["evaluations"]
    staged_pairs = int(counts.sum())
    px = bcfg.num_tiles * bcfg.tile_px
    ops_ms = EVAL_OPS * evals / F32_OPS_PER_S * 1e3
    k5_bytes = (40 * staged_pairs + 8 * bcfg.num_tiles
                + px * (12 + 4 + 4 + (4 if bcfg.need_n_contrib else 0)))
    k6_bytes = 40 * staged_pairs + 8 * bcfg.num_tiles + 20 * px + 40 * staged_pairs
    k6_fill = 64 * st.fields.shape[1] - 40 * staged_pairs    # as K2's (phase_yardstick)
    k5_bound = max(k5_bytes / HBM_BYTES_PER_S * 1e3, ops_ms)
    k6_bound = max(k6_bytes / HBM_BYTES_PER_S * 1e3, ops_ms)
    emit("yardstick_lockstep", K1_layout=cbm.forward_layout(bcfg.tile_w, bcfg.tile_h),
         K2_layout=cbm.backward_layout(bcfg.tile_w, bcfg.tile_h),
         staged_pairs=staged_pairs, max_per_tile=int(counts.max()), longest_tile=longest,
         mean_per_tile=staged_pairs / bcfg.num_tiles, visits=v, longest_block=tail,
         K5=dict(ms=k5_ms, previous_ms=K5_PREVIOUS_MS, plain_ms=k5_plain,
                 K1_no_cull_ms=k1_ms, design_moves_recorded_ms=K5_DESIGN_MOVES_MS,
                 evaluations=evals, bytes=k5_bytes,
                 bytes_ms=k5_bytes / HBM_BYTES_PER_S * 1e3, ops=EVAL_OPS * evals,
                 ops_ms=ops_ms, bound_ms=k5_bound),
         K6=dict(ms=k6_ms, previous_ms=K6_PREVIOUS_MS, plain_ms=k6_plain, K2_no_cull_ms=k2_ms,
                 design_moves_recorded_ms=K6_DESIGN_MOVES_MS, evaluations=evals,
                 bytes=k6_bytes, bytes_ms=k6_bytes / HBM_BYTES_PER_S * 1e3,
                 ops=EVAL_OPS * evals, ops_ms=ops_ms, bound_ms=k6_bound,
                 layout_fill_bytes=k6_fill,
                 ptxas=ptxas_report(kernels.load_library().ptxas_log, K6_ENTRY),
                 sass=sass_pair_loop("backward_mixed", K6_ENTRY)))
    by = lambda b: "bytes" if b / HBM_BYTES_PER_S * 1e3 >= ops_ms else "operations"  # noqa: E731
    return [
        {"name": "K5 forward_lockstep", "route": "cuda",
         "source": "deblurgs_tpu_torch/csrc/forward_mixed.cu",
         "replaces": "deblurgs_tpu/ops/pallas_blend.py:765", "launches": ev["launches"]["K5"],
         "max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain, "bound_ms": k5_bound,
         "bound_by": by(k5_bytes), "library_ms": None},
        {"name": "K6 backward_lockstep", "route": "cuda",
         "source": "deblurgs_tpu_torch/csrc/backward_mixed.cu",
         "replaces": "deblurgs_tpu/ops/pallas_blend.py:951", "launches": ev["launches"]["K6"],
         "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain, "bound_ms": k6_bound,
         "bound_by": by(k6_bytes), "library_ms": None},
    ]


# ---------------------------------------------------------------------------
# the xla and oracle backends and the native host library
# ---------------------------------------------------------------------------


def write_points3d_bin(path: str, xyz: np.ndarray, rgb: np.ndarray,
                       rng: np.random.Generator) -> None:
    """A COLMAP ``points3D.bin`` of these points: a reprojection error and a
    track of 2-5 (image, point2D) entries each, drawn from ``rng``."""
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            n = int(rng.integers(2, 6))
            f.write(struct.pack("<QdddBBBd", i, *map(float, p), *map(int, c),
                                float(rng.uniform(0.1, 2.0))))
            f.write(struct.pack("<Q", n))
            f.write(rng.integers(0, 1000, 2 * n).astype("<i4").tobytes())


def median_ms(torch, fn, reps: int = 5, warmup: int = 1) -> tuple:
    """(median, all) of ``reps`` timed calls of ``fn``, each between CUDA
    events and synchronised."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return median(times), [round(x, 4) for x in times]


def backends_eval(torch, dev, run) -> dict:
    """(a) The eval run, whose ``cfg_args`` has no ``backend`` key, through
    ``cli.evaluate.main`` and ``cli.render_trainview.main`` without
    ``--backend`` (xla, 2 pose iterations a view), the launch counters
    zeroed before and read after (the walk launches no kernel); then
    ``render_view`` on xla and on pallas/lockstep (K5) on one held-out view,
    and the xla pose step."""
    from deblurgs_tpu_torch.cli import evaluate, render_trainview
    from deblurgs_tpu_torch.data.scene import load_image
    from deblurgs_tpu_torch.eval import pose_opt
    from deblurgs_tpu_torch.eval.session import load_session, render_view

    log = RenderLog(None)
    real = log.install()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        results = evaluate.main(["-m", run["model"], "-r", "1", "--num_iter_per_view", "2",
                                 "--device", str(dev)])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        t0 = time.perf_counter()
        out_dir = render_trainview.main(["-m", run["model"], "-r", "1", "--device", str(dev)])
        torch.cuda.synchronize()
        trainview_s = time.perf_counter() - t0
        launches = read_counts()
        log.check()
    finally:
        RenderLog.remove(real)
    if any(launches.values()):
        raise AssertionError(f"the xla path launched a compositing kernel: {launches}")
    for split in ("unfit", "fit"):
        if not all(math.isfinite(results[split][k]) for k in ("PSNR", "SSIM")):
            raise AssertionError(f"non-finite metrics on xla: {results}")
    frames = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    if len(frames) != EVAL_CAMERAS - len(range(0, EVAL_CAMERAS, EVAL_HOLD)):
        raise AssertionError(f"render_trainview wrote {frames}")

    sx = load_session(run["model"], resolution=1, device=dev)
    sp = load_session(run["model"], resolution=1, backend="pallas", device=dev)
    if (sx.rcfg.backend, sp.rcfg.layout) != ("xla", "lockstep"):
        raise AssertionError(f"sessions: {sx.rcfg}, {sp.rcfg}")
    test = sx.scene.info.test_cameras
    R = torch.as_tensor(np.stack([c.R for c in test]), dtype=torch.float32, device=dev)
    T = torch.as_tensor(np.stack([c.T for c in test]), dtype=torch.float32, device=dev)
    proj = torch.as_tensor(sx.scene.proj, device=dev)
    cam0 = pose_opt.pose_to_camera(pose_opt.init_pose_params(R, T), 0, proj)
    img_x, dep_x = render_view(sx, cam0, tone_map=False)
    img_p, dep_p = render_view(sp, cam0, tone_map=False)
    err = check_close("xla image against K5's", img_x, img_p, atol=1e-5, rtol=1e-4)
    depth_err = max_err(dep_x, dep_p)
    zero_counts()
    xla_ms, xla_all = median_ms(torch, lambda: render_view(sx, cam0))
    if any(read_counts().values()):
        raise AssertionError("render_view on xla launched a compositing kernel")
    k5_ms, k5_all = median_ms(torch, lambda: render_view(sp, cam0))
    gts = torch.as_tensor(np.stack([load_image(c, 1) for c in test]), device=dev)

    def refine():
        pose_opt.optimize_test_poses(sx, gts, R, T, proj, num_iter_per_view=2,
                                     lr_trans=5e-3, verbose=False)

    pose_ms, pose_all = median_ms(torch, refine, reps=3)
    steps = 2 * len(test)
    walks = walk_times(torch, sp, cam0, gts[0])
    return dict(evaluate_s=round(eval_s, 3), render_trainview_s=round(trainview_s, 3),
                unfit=results["unfit"], fit=results["fit"], launches=launches,
                renders=log.calls, longest_list=log.longest, k_max_seen=sorted(log.k_max),
                k_max_regrown=log.k_regrown, session_k_max=sx.rcfg.k_max,
                max_num_pairs=log.pairs, peak_memory_gb=round(peak_gb, 3),
                xla_vs_k5_image_max_abs=err, xla_vs_k5_depth_max_abs=depth_err,
                render_view_ms={"xla": round(xla_ms, 4), "pallas_lockstep_K5": round(k5_ms, 4)},
                render_view_ms_all={"xla": xla_all, "pallas_lockstep_K5": k5_all},
                xla_pose_step_ms=round(pose_ms / steps, 4),
                xla_pose_step_ms_all=[round(x / steps, 4) for x in pose_all],
                same_view_ms=walks)


def walk_times(torch, session, cam, gt) -> dict:
    """The xla walk forward and backward (``tile_blend._xla_forward`` /
    ``_xla_backward``) beside K5 and K6 on the same view's lists (uncut:
    the walk and the lockstep kernels composite the same pairs), with an
    L1 cotangent; medians of 3 (ms)."""
    from deblurgs_tpu_torch.models import gaussians as gm, tonemap
    from deblurgs_tpu_torch.ops import binning, cuda_blend, cuda_blend_lockstep as cbl
    from deblurgs_tpu_torch.ops import rasterize, tile_blend
    from deblurgs_tpu_torch.train.losses import l1_loss

    rin = {k: v.detach() for k, v in gm.render_inputs(session.params, session.gcfg).items()}
    rcfg, cs = session.rcfg, session.scene.camera_static
    bcfg = rcfg.blend_config(cs)
    bg = torch.zeros(3, device=gt.device)
    with torch.no_grad():
        pre = rasterize._preprocess(rin["means3d"], rin["scales"], rin["rotations"],
                                    rin["opacities"], rin["shs"], cam, cs, rcfg, 2, None,
                                    session.aux.active, None)
        bins = binning.bin_gaussians(pre, tiles_x=bcfg.tiles_x, tiles_y=bcfg.tiles_y,
                                     max_pairs=rcfg.max_pairs)
        fields = (pre.means2d, pre.conic, pre.opacity, pre.color, pre.depth)
        lists = (bins.pair_gauss, bins.tile_start, bins.tile_stop)
        steps = tile_blend.walk_length(bcfg, bins.tile_start, bins.tile_stop)
        C, D, T, n_con = tile_blend._xla_forward(bcfg, *lists, *fields, steps)
        img = tile_blend.compose(bcfg, C, D, T, n_con, bg)[0]
    img = img.requires_grad_(True)
    loss = l1_loss(torch.clamp(tonemap.tone_map(img, session.tone_mapping), 0, 1), gt)
    d_pix = tile_blend.image_to_tiles(bcfg, torch.autograd.grad(loss, img)[0])
    d_dep = torch.zeros_like(D)
    with torch.no_grad():
        fwd, _ = median_ms(torch, lambda: tile_blend._xla_forward(bcfg, *lists, *fields, steps),
                           reps=3)
        bwd, _ = median_ms(torch, lambda: tile_blend._xla_backward(
            bcfg, *lists, *fields, bg, T, n_con, d_pix, d_dep, steps), reps=3)
        flat = [x for x in (pre.means2d, pre.conic, pre.opacity, pre.color, pre.depth,
                            pre.rect, pre.tiles_touched)]
        staged = cuda_blend.sort_stage(bcfg, *flat, bcfg.max_pairs)
        C5, D5, T5, _ = cbl.forward_lockstep(bcfg, staged)
        k5 = cuda_ms(lambda: cbl.forward_lockstep(bcfg, staged), 10)
        k6 = cuda_ms(lambda: cbl.backward_lockstep(bcfg, staged, bg, T5, d_pix, d_dep, C5, D5),
                     10)
    return dict(walk_steps=steps, num_pairs=int(bins.num_pairs), xla_forward_walk=round(fwd, 4),
                xla_backward_walk=round(bwd, 4), K5=round(k5, 4), K6=round(k6, 4))


def backends_train(torch, dev) -> dict:
    """(b) One xla train step at the train phase's operating point
    (1920×1080, 100k Gaussians, F = 21, tile 32, per-view renders, ``k_max``
    the next power of two at or above the step's longest list) against the
    pallas per-view step from the same state with the same draws."""
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib
    from deblurgs_tpu_torch.ops import rasterize
    from deblurgs_tpu_torch.train import step as step_lib

    st, state0, gt, proj = train_setup(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    def probe(state, bg):
        """(longest list, most pairs) of the step's views on xla's binning
        (a walk of one step; the views' sub-frame times are fixed)."""
        nu = motion_lib.sample_nus(state.motion, [0], st.mcfg)
        cams = motion_lib.subframe_cameras_batch(state.motion, [0], nu, proj, st.mcfg)
        rin = gm.render_inputs(state.params, st.gcfg)
        cfg = dataclasses.replace(st.rcfg, backend="xla", k_max=1)
        outs = [rasterize.render(rin["means3d"], rin["scales"], rin["rotations"],
                                 rin["opacities"], rin["shs"], type(cams)(*(x[v] for x in cams)),
                                 st.cs, bg, cfg=cfg, sh_degree=2, active=state.aux.active)
                for v in range(st.n_sub)]
        return (max(int(o.max_per_tile) for o in outs), max(int(o.num_pairs) for o in outs))

    # per-view renders: a budget of one view's pairs (+10%), not the
    # batched render's 21 views'
    with torch.no_grad():
        _, pairs = probe(state0, torch.zeros(3, device=dev))
    st_p = dataclasses.replace(st, batched_render=False, rcfg=dataclasses.replace(
        st.rcfg, max_pairs=(int(pairs * 1.1) + 1023) & ~1023))
    # one pallas step first, so that Adam's moments are not zero: a first
    # Adam step moves each leaf by ±lr whatever the gradient's size
    state, _ = step_lib.train_step(state0, gt, 0, proj, st_p, generator=gen)
    draws = step_lib.draw_step(state, st, gt.shape, gen)
    with torch.no_grad():
        longest, pairs = probe(state, draws.bg)
    if pairs > st_p.rcfg.max_pairs:
        raise AssertionError(f"a view emits {pairs} pairs > {st_p.rcfg.max_pairs}")
    k_max = 1 << math.ceil(math.log2(longest))
    st_x = dataclasses.replace(st_p, rcfg=dataclasses.replace(st_p.rcfg, backend="xla",
                                                                  k_max=k_max))
    def step(st_):
        """The step in its three halves, so the gradients can be compared."""
        torch.cuda.synchronize()
        zero_counts()
        fwd = step_lib.forward_loss(state, gt, 0, proj, st_, draws)
        grads = step_lib.backward(fwd)
        new, metrics = step_lib.apply(state, fwd, grads, st_, draws)
        torch.cuda.synchronize()
        return new, metrics, grads, read_counts()

    want, m_p, g_p, launches_p = step(st_p)
    if any(launches_p[k] != st.n_sub for k in ("K3", "K1", "K2", "K4")):
        raise AssertionError(f"the pallas per-view step's launches: {launches_p}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got, m_x, g_x, launches_x = step(st_x)
    step_s = [time.perf_counter() - t0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(launches_x.values()):
        raise AssertionError(f"the xla step launched a compositing kernel: {launches_x}")
    if bool(m_x.overflowed) or int(m_x.max_per_tile) != longest:
        raise AssertionError(f"xla step: overflowed {bool(m_x.overflowed)}, longest "
                             f"{int(m_x.max_per_tile)} (probe {longest}, k_max {k_max})")
    loss_rel = abs(float(m_x.loss) - float(m_p.loss)) / abs(float(m_p.loss))
    if not loss_rel <= 1e-5:
        raise AssertionError(f"xla step loss {float(m_x.loss)} vs pallas {float(m_p.loss)}")
    # the gradients are what the two backends compute. A second xla step
    # from the same state and draws (timed too) measures its own float32
    # spread (index_add_'s atomic order): each gradient is held within
    # 2e-4 scaled of the pallas step's, or within 4× that spread where the
    # gradient is a sum that cancels (the alignment logits nu: a softmax's
    # derivatives sum to zero, over 21 views of 100k Gaussians' terms)
    t0 = time.perf_counter()
    _, _, g_x2, _ = step(st_x)
    step_s.append(time.perf_counter() - t0)
    names = [f"params/{k}" for k in g_p[0]._fields] + [f"motion/{k}" for k in g_p[1]._fields]
    flat = lambda g: [*g[0], *g[1], g[2]]   # noqa: E731
    grads, spread = {}, {}
    for name, a, a2, b in zip(names + ["vsp"], flat(g_x), flat(g_x2), flat(g_p)):
        spread[name] = scaled_err(a2, a)
        grads[name] = check_scaled(f"xla step d/d{name}", a, b,
                                   atol=max(2e-4, 4 * spread[name]))
    # the updated leaves are reported, with their largest difference in
    # units of the leaf's learning rate: Adam's m/sqrt(v) turns the
    # rounding of a near-zero gradient into a move of up to lr
    oc = st.ocfg
    lrs = {"f_dc": oc.feature_lr, "f_rest": oc.feature_lr / 20.0, "scaling": oc.scaling_lr,
           "rotation": oc.rotation_lr, "opacity": oc.opacity_lr}
    moves_in_lr = {f"params/{k}": max_err(getattr(got.params, k), getattr(want.params, k)) / lr
                   for k, lr in lrs.items()}
    leaves = {name: scaled_err(a, b) for name, a, b in zip(
        names + [f"aux/{k}" for k in ("xyz_grad_accum", "denom", "max_radii2d")],
        [*got.params, *got.motion, got.aux.xyz_grad_accum, got.aux.denom, got.aux.max_radii2d],
        [*want.params, *want.motion, want.aux.xyz_grad_accum, want.aux.denom,
         want.aux.max_radii2d])}
    pallas_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        step_lib.train_step(state, gt, 0, proj, st_p, draws=draws)
        torch.cuda.synchronize()
        pallas_s.append(time.perf_counter() - t0)
    return dict(width=st.cs.width, height=st.cs.height, gaussians=state.params.xyz.shape[0],
                subframes=st.n_sub, tile=st.rcfg.tile_w, max_pairs_a_view=st_p.rcfg.max_pairs,
                longest_list=longest, k_max=k_max, num_pairs=int(m_x.num_pairs),
                loss={"xla": float(m_x.loss), "pallas": float(m_p.loss)},
                loss_rel_diff=loss_rel, grad_scaled_max_diff=grads,
                xla_rerun_grad_scaled_spread=spread,
                leaf_scaled_max_diff=leaves, leaf_max_abs_diff_in_lr=moves_in_lr,
                xla_step_s=[round(x, 3) for x in step_s],
                pallas_per_view_step_s=[round(x, 4) for x in pallas_s],
                launches_pallas_step=launches_p, peak_memory_gb=round(peak_gb, 3))


def backends_oracle(torch, dev) -> dict:
    """(c) The oracle as the anchor on the card: 128×96, 2,000 Gaussians,
    one view's preprocess outputs composited by the oracle, the xla walk,
    pallas/mixed (K3, K1; backward K2, K4) and pallas/lockstep (K3, K5;
    K6, K4); images within atol 1e-5 / rtol 1e-4 and the gradients of
    means, conics, opacities and colours within 2e-5 scaled of the
    oracle's autograd (``tests/test_rasterizer.py``'s tolerances)."""
    from deblurgs_tpu_torch.ops import binning, oracle, rasterize, tile_blend
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig

    W, H, N = ORACLE_SIZE
    model = make_scene(N, 2, np.random.default_rng(SEED + 30), dev)
    with torch.no_grad():
        model.scaling.add_(math.log(4.0))        # wider splats: lists of tens of pairs
    cs, proj = camera(W, H, 1.2, dev)
    cam = view_camera(torch, np.eye(3), np.array([0.0, 0.0, -6.0]), proj)
    cam = type(cam)(*(x[0] for x in cam))
    rcfg = RasterizeConfig(max_pairs=1 << 17, k_max=4096)
    rin = model.render_inputs()
    with torch.no_grad():
        pre = rasterize._preprocess(rin["means3d"], rin["scales"], rin["rotations"],
                                    rin["opacities"], rin["shs"], cam, cs, rcfg, 2, None,
                                    None, None)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    w_img = torch.randn((H, W, 3), generator=gen, device=dev)
    w_dep = 0.01 * torch.randn((H, W), generator=gen, device=dev)
    bcfg = rcfg.blend_config(cs)
    bins = binning.bin_gaussians(pre, tiles_x=bcfg.tiles_x, tiles_y=bcfg.tiles_y,
                                 max_pairs=rcfg.max_pairs)

    def run(kind):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (pre.means2d, pre.conic, pre.opacity, pre.color)]
        if kind == "oracle":
            img, dep, _, _ = oracle.oracle_render(
                pre._replace(means2d=leaves[0], conic=leaves[1], opacity=leaves[2],
                             color=leaves[3]), bg, width=W, height=H, z_far=rcfg.z_far)
        elif kind == "xla":
            img, dep, _, _ = tile_blend.blend_from_binning(
                dataclasses.replace(bcfg, backend="xla"), bins, *leaves, pre.depth, bg)
        else:
            img, dep = tile_blend.blend_fused(
                dataclasses.replace(bcfg, layout=kind), *leaves, pre.depth, pre.rect,
                pre.tiles_touched, bg)[:2]
        grads = torch.autograd.grad(torch.sum(img * w_img) + torch.sum(dep * w_dep), leaves)
        return img.detach(), grads

    t0 = time.perf_counter()
    want, want_g = run("oracle")
    torch.cuda.synchronize()
    seconds = {"oracle": time.perf_counter() - t0}
    zero_counts()
    errs = {}
    for kind in ("xla", "mixed", "lockstep"):
        t0 = time.perf_counter()
        img, grads = run(kind)
        torch.cuda.synchronize()
        seconds[kind] = time.perf_counter() - t0
        errs[kind] = {"image": check_close(f"oracle: {kind} image", img, want, atol=1e-5,
                                           rtol=1e-4)}
        for name, g, w in zip(("means2d", "conic", "opacity", "color"), grads, want_g):
            if not float(torch.max(torch.abs(w))) > 0:
                raise AssertionError(f"oracle: the oracle's {name} gradient is zero")
            errs[kind][name] = check_scaled(f"oracle: {kind} d/d{name}", g, w)
    torch.cuda.synchronize()
    launches = read_counts()
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"oracle: {name} was not launched: {launches}")
    return dict(width=W, height=H, gaussians=N, visible=int(pre.visible.sum()),
                num_pairs=int(bins.num_pairs), longest_list=int(bins.max_per_tile),
                forward_backward_s={k: round(v, 4) for k, v in seconds.items()}, errors=errs,
                launches=launches)


def backends_native(torch, dev, run) -> dict:
    """(d) The native host library on the card's host: its build, exact
    3-NN of the train phase's 100k points against the on-card exact
    search, and ``points3D.bin`` of the eval run's 100k points parsed bit
    for bit as the Python reader does."""
    from deblurgs_tpu_torch import native
    from deblurgs_tpu_torch.core.sh import sh_to_rgb
    from deblurgs_tpu_torch.data import colmap
    from deblurgs_tpu_torch.ops.knn import knn3_mean_sq_dist

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host library did not build or load")
    load_s = time.perf_counter() - t0
    N = TRAIN_SIZE[2]
    pts = (np.random.default_rng(SEED + 3).standard_normal((N, 3)) * 2.0).astype(np.float32)
    t0 = time.perf_counter()
    host = native.knn3_mean_sq(pts)
    host_s = time.perf_counter() - t0
    dpts = torch.as_tensor(pts, device=dev)
    card_ms, card_all = median_ms(torch, lambda: knn3_mean_sq_dist(dpts), reps=3)
    card = knn3_mean_sq_dist(dpts).cpu().numpy()
    rel = float(np.max(np.abs(host.astype(np.float64) - card) / np.abs(card)))
    if not rel <= 1e-5:
        raise AssertionError(f"native 3-NN against the card's: max relative diff {rel:.3e}")

    model = make_scene(EVAL_SIZE[2], 2, np.random.default_rng(SEED), dev)
    rgb = (np.clip(sh_to_rgb(model.f_dc.detach()[:, 0]).cpu().numpy(), 0, 1) * 255).round()
    path = os.path.join(run["source"], "sparse", "0", "points3D.bin")
    write_points3d_bin(path, model.xyz.detach().cpu().numpy().astype(np.float64),
                       rgb.astype(np.uint8), np.random.default_rng(SEED + 32))
    t0 = time.perf_counter()
    parsed = native.parse_points3d_bin(path)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = colmap.read_points3d_binary_python(path)
    py_s = time.perf_counter() - t0
    if parsed is None or not all(a.dtype == b.dtype and np.array_equal(a, b)
                                 for a, b in zip(parsed, py)):
        raise AssertionError("parse_points3d_bin differs from the Python reader")
    return dict(library=os.path.relpath(native.load()._name, REPO),
                first_load_s=None if native.build_seconds is None
                else round(native.build_seconds, 3),
                load_s_here=round(load_s, 3), knn_points=N, knn_host_s=round(host_s, 4),
                knn_card_exact_ms=round(card_ms, 4), knn_card_exact_ms_all=card_all,
                knn_max_rel_diff=rel, points3d=len(parsed[0]),
                parse_native_s=round(parse_s, 4), parse_python_s=round(py_s, 4))


def phase_backends(torch, dev):
    """The backends phase: (a)-(d) above, each line printed as it ends."""
    import tempfile

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        run = write_eval_run(torch, dev, root)
        emit("backends_eval", width=EVAL_SIZE[0], height=EVAL_SIZE[1], gaussians=EVAL_SIZE[2],
             tile=16, write_run_s=round(time.perf_counter() - t0, 3),
             **backends_eval(torch, dev, run))
        emit("backends_native", **backends_native(torch, dev, run))
    torch.cuda.empty_cache()
    emit("backends_oracle", **backends_oracle(torch, dev))
    torch.cuda.empty_cache()
    emit("backends_train", **backends_train(torch, dev))


# ---------------------------------------------------------------------------
# recovery: the validation harness's joint arm at the r5 width
# ---------------------------------------------------------------------------

# the r5 protocol's scene (scripts/r5_cal3b.sh's CAL) with the joint arm's
# batched training renders and lockstep evaluation; 640 iterations: the curves
# from 100, one densification at 400 (densify_until is 0.7 × iters = 448)
RECOVERY_FLAGS = ["--size", "256", "--n_cams", "12", "--n_sub", "21", "--tile", "32",
                  "--max_pairs", str(1 << 21), "--texture", "checker", "--checker_cell", "0.5",
                  "--blur_scale", "0.8", "--true_scale", "0.05", "--capacity_mult", "8",
                  "--batched", "--layout", "lockstep", "--iters", "640", "--densify_from", "300",
                  "--pose_refine_iters", "30", "--ckpt_every", "200"]
# scripts/validate_blur_recovery.py:601-616, in its order
RECOVERY_REPORT_KEYS = ["sharp_psnr", "traj_err", "traj_err_init", "traj_err_aligned",
                        "traj_err_aligned_init", "overflow_steps", "blur_floor_psnr",
                        "final_points", "sharp_psnr_midcam", "sharp_psnr_pose_refined", "nan_at",
                        "iters", "n_cams", "n_sub", "size", "no_curve", "no_densify", "args"]


def recovery_refine_check(torch, truth, state, view: int = 0):
    """K5 and K6 on one pose-refinement step of ``view`` (from its learned
    mid-exposure camera, as the script refines it) against their plain
    versions, every tile, bit for bit."""
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_lockstep as cbl, tile_blend
    from deblurgs_tpu_torch.scripts import validate_blur_recovery as vbr

    dev = truth.dev
    with torch.no_grad():
        cam0 = vbr.one(motion_lib.subframe_cameras_batch(
            state.motion, [view], torch.full((1, 1), 0.5, device=dev), truth.proj,
            truth.mcfg), 0)
        cam = vbr.pose_camera(vbr.pose_of(cam0), truth.proj)
        bcfg = truth.rcfg_eval.blend_config(truth.cs)
        flat = flat_preprocess((gm.render_inputs(state.params, truth.gcfg), 2),
                               type(cam)(*(x[None] for x in cam)), truth.cs, truth.rcfg_eval,
                               state.aux.active)
        staged = cuda_blend.sort_stage(bcfg, *flat, bcfg.max_pairs)
        if int(staged.total) > bcfg.max_pairs:
            raise AssertionError("recovery: the refinement view overflows its pair budget")
        bg = torch.zeros(3, device=dev)
        C, D, T, n_con = cbl.forward_lockstep(bcfg, staged)
        image = tile_blend.compose(bcfg, C, D, T, n_con, bg)[0]
    img = image.detach().requires_grad_(True)
    d_img = torch.autograd.grad(torch.abs(img - truth.sharp_gts[view]).mean(), img)[0]
    dl_pix = tile_blend._images_to_tiles(bcfg, d_img)
    dl_d = torch.zeros_like(D)
    pg = cbl.backward_lockstep(bcfg, staged, bg, T, dl_pix, dl_d, C, D)
    return (check_k5(torch, "recovery refinement", bcfg, staged, (C, D, T, n_con)),
            check_k6(torch, "recovery refinement", bcfg, staged, bg, T, dl_pix, dl_d, C, D, pg),
            int(staged.total))


def phase_recovery(torch, dev) -> dict:
    """``scripts/validate_blur_recovery.main``'s joint arm at the r5 width
    (RECOVERY_FLAGS) with the launch counters zeroed just before and read
    just after: exit code 0 or 1, JAX's report keys, finite numbers, no
    overflowed step, a densification that cloned or split Gaussians and
    changed the point count (its prune may outweigh its growth, as in JAX's
    r5 joint run: 1,200 points to 742 at its first event), the newest two
    checkpoints kept; then K1-K4 on one train step of the final state and
    K5, K6 on one refinement step, against their plain versions, every tile.
    Returns the kernels' largest errors."""
    import contextlib
    import glob
    import io
    import tempfile

    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed
    from deblurgs_tpu_torch.scripts import validate_blur_recovery as vbr
    from deblurgs_tpu_torch.train import checkpoint, step as step_lib

    real_step, events = step_lib.train_step, []

    def observed(state, gt, idx, proj, st, **kw):
        """The step, its densify report read where the event fires."""
        new, metrics = real_step(state, gt, idx, proj, st, **kw)
        if step_lib._events(state.step, st.ocfg, st.white_background)[1]:
            events.append({"step": state.step, "active": int(metrics.num_active),
                           **{k: int(v) for k, v in metrics.densify._asdict().items()}})
        return new, metrics

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        report_path, state_path = os.path.join(root, "joint.json"), os.path.join(root, "state.npz")
        argv = RECOVERY_FLAGS + ["--report", report_path, "--save_state", state_path,
                                 "--device", str(dev)]
        out = io.StringIO()
        step_lib.train_step = observed
        zero_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = vbr.main(argv)
        finally:
            step_lib.train_step = real_step
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        log = out.getvalue()
        sys.stderr.write(log)
        with open(report_path) as fp:
            report = json.load(fp)
        ckpts = sorted(os.path.basename(p) for p in glob.glob(os.path.join(root, "state_ckpt_*")))
        state = checkpoint.load_checkpoint(state_path, device=dev)
    args = vbr.parse_args(argv)
    numbers = {k: v for k, v in report.items() if k not in ("nan_at", "args")}
    n_init = args.n_gauss + vbr.wall_side(args) ** 2
    if rc not in (0, 1) or list(report) != RECOVERY_REPORT_KEYS or report["nan_at"] is not None:
        raise AssertionError(f"recovery: rc {rc}, keys {list(report)}, nan_at {report['nan_at']}")
    if not all(isinstance(v, (bool, int)) or (v is not None and math.isfinite(v))
               for v in numbers.values()):
        raise AssertionError(f"recovery: a non-finite number in {numbers}")
    if report["overflow_steps"] != 0:
        raise AssertionError(f"recovery: {report['overflow_steps']} overflowed steps")
    if not events or sum(e["n_cloned"] + e["n_split"] for e in events) == 0:
        raise AssertionError(f"recovery: no densification grew the scene: {events}")
    if report["final_points"] == n_init:
        raise AssertionError(f"recovery: the scene kept its initial {n_init} points")
    if ckpts != ["state_ckpt_400.npz", "state_ckpt_600.npz"]:
        raise AssertionError(f"recovery: checkpoints kept {ckpts}")
    want = {"K1": 1, "K2": 1, "K3": 1, "K4": 1, "K5": 1, "K6": 1}
    if any(launches[k] < n for k, n in want.items()) or launches["K2"] != args.iters \
            or launches["K6"] != args.pose_refine_iters * args.n_cams:
        raise AssertionError(f"recovery launches: {launches}")
    train_s = float(re.search(r"^train (\S+) s;", log, re.M).group(1))
    pairs, budget = map(int, re.search(r"largest pair list (\d+) of a budget of (\d+)",
                                       log).groups())

    # ---- the kernels on the final state: one train step, one refinement step
    with contextlib.redirect_stdout(io.StringIO()):
        truth = vbr.build_truth(args, vbr.make_draws(args), dev)
        truth = vbr.synthesize(args, truth, vbr.EvalRenderer(truth))
    ocfg = vbr.optimization_config(args)
    st = vbr.train_statics(args, truth, ocfg, *vbr.statics_key(args, truth, ocfg, state.step))
    cam = vbr.step_cameras(args, state.step)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    k = step_kernel_inputs(torch, st, state, truth.blur_gts[cam], bg, cam, truth.proj)
    err_k3 = check_k3(torch, "recovery", cuda_blend.broadcast_fields(
        k["compact"].ctable, k["compact"].gauss_c), k["compact"])
    err_k1 = check_k1(torch, "recovery", k["bcfg"], k["staged"], (k["C"], k["D"], k["T"],
                                                                  k["n_con"]))
    kargs = (bg, k["T"], k["dl_pix"], k["dl_d"], k["C"], k["D"])
    pg = cuda_blend_mixed.backward_mixed(k["bcfg"], k["staged"], *kargs)
    err_k2 = check_k2(torch, "recovery", k["bcfg"], k["staged"], *kargs, pg)
    err_k4 = check_k4(torch, "recovery", k["staged"], pg, k["P"])
    err_k5, err_k6, refine_pairs = recovery_refine_check(torch, truth, state)
    emit("recovery", flags=" ".join(RECOVERY_FLAGS), rc=rc, seconds=round(seconds, 3),
         predicted_seconds_at_most=60, train_s=train_s,
         ms_per_step=round(1000 * train_s / args.iters, 3), launches=launches,
         densify_events=events, checkpoints_kept=ckpts, eval_max_num_pairs=pairs,
         eval_max_pairs=budget, refine_view_pairs=refine_pairs,
         check_step=state.step, check_pairs=int(k["staged"].total),
         report={k: v for k, v in report.items() if k != "args"},
         err_k1=err_k1, err_k2=err_k2, err_k3=err_k3, err_k4=err_k4, err_k5=err_k5,
         err_k6=err_k6)
    return {"K1": err_k1, "K2": err_k2[1], "K3": err_k3, "K4": err_k4[1], "K5": err_k5,
            "K6": err_k6}


# ---------------------------------------------------------------------------
# r5_jax_scene: JAX's r5 scene and JAX's trained r5 state, evaluated
# ---------------------------------------------------------------------------

R5_JAX_DRAWS = os.path.join("runs", "r5_jax_draws.npz")
R5_JAX_STATE = os.path.join("runs", "r5_jointb_state.npz")
R5_JAX_REPORT = os.path.join("runs", "r5_jointb.json")     # JAX's report of that state
R5_PSNR_DB = {"blur_floor_psnr": 1e-3,     # tests/test_torch_recovery.py at 32 px
              # JAX's TPU composite sits up to ~1e-3 a pixel from float64 on
              # deep lists (tests/test_torch_weights.py)
              "sharp_psnr": 1e-2, "sharp_psnr_midcam": 1e-2}
R5_TRAJ_KEYS = ("traj_err_init", "traj_err_aligned_init", "traj_err", "traj_err_aligned")
R5_TRAJ_RTOL, R5_TRAJ_ATOL = 1e-5, 2e-6   # tests/test_torch_recovery.py's TRAJ_ATOL


def phase_r5_jax_scene(torch, dev) -> dict:
    """The r5 protocol's scene built from JAX's own draws
    (``runs/r5_jax_draws.npz``) at the joint arm's arguments (256², 12
    cameras, F = 21, ``--gt_oversample 1``, 2^21 slots, tile 32, mixed) and
    synthesised through ``EvalRenderer``, then JAX's trained joint state
    (``runs/r5_jointb_state.npz``, loaded with ``weights.from_jax_arrays``)
    evaluated by ``evaluate_state``, the launch counters zeroed just before
    the synthesis and read just after the evaluation. Every number is held
    to JAX's report of that state (``runs/r5_jointb.json``): the blur floor
    within 1e-3 dB, the sharp PSNRs within 1e-2 dB, the four trajectory
    errors within rtol 1e-5 + atol 2e-6; each gap printed on its own line.
    Then K3 and K1, the kernels these single-view renders launch (layout
    mixed), and K5 on the same list, against their plain versions on one
    view of the state, every tile, bit for bit (K5 also against K1).
    Returns the kernels' largest errors."""
    import contextlib
    import io

    from deblurgs_tpu_torch import weights
    from deblurgs_tpu_torch.models import gaussians as gm
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_lockstep as cbl, cuda_blend_mixed
    from deblurgs_tpu_torch.scripts import recovery_protocol as rp
    from deblurgs_tpu_torch.scripts import validate_blur_recovery as vbr

    args = vbr.parse_args(rp.ARMS["joint"][1] + ["--device", str(dev)])
    draws = vbr.load_draws(os.path.join(REPO, R5_JAX_DRAWS))
    with open(os.path.join(REPO, R5_JAX_REPORT)) as fp:
        want = json.load(fp)
    with np.load(os.path.join(REPO, R5_JAX_STATE)) as d:
        flat_state = {k: np.array(d[k]) for k in d.files
                      if k.startswith(("params/", "motion/", "aux/active"))}
    gaussians, motion, active = weights.from_jax_arrays(flat_state, device=dev)
    params = gm.GaussianParams(*(getattr(gaussians, k).detach() for k in gm.GaussianParams._fields))
    motion = motion.params()

    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        truth = vbr.build_truth(args, draws, dev)
        render_with = vbr.EvalRenderer(truth)
        truth = vbr.synthesize(args, truth, render_with)
        t_synth = time.perf_counter() - t0
        motion0 = vbr.init_arm(args, draws, truth)[2]
        got = vbr.evaluate_state(args, truth, render_with, params, active, motion, motion0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    got["blur_floor_psnr"] = truth.blur_floor

    gaps, missed = {}, []
    for key in ("blur_floor_psnr", "sharp_psnr", "sharp_psnr_midcam") + R5_TRAJ_KEYS:
        gap = abs(got[key] - want[key])
        bound = (R5_PSNR_DB[key] if key in R5_PSNR_DB
                 else R5_TRAJ_ATOL + R5_TRAJ_RTOL * abs(want[key]))
        gaps[key] = gap
        print(f"r5_jax_scene {key}: port {got[key]!r} jax {want[key]!r} gap {gap:.3e} "
              f"bound {bound:.3e}", flush=True)
        if not gap <= bound:
            missed.append(f"{key} by {gap - bound:.3e}")
    n_renders = args.n_cams * (args.n_sub * args.gt_oversample + 1) + 2 * args.n_cams
    want_launches = {"K3": n_renders, "K1": n_renders, "K2": 0, "K4": 0, "K5": 0, "K6": 0}

    # ---- K3, K1 and K5 on one view of JAX's state: camera 0's learned mid camera
    with torch.no_grad():
        cam = vbr.learned_mid_cam(truth, motion, 0)
        bcfg = truth.rcfg_eval.blend_config(truth.cs)
        flat = flat_preprocess((gm.render_inputs(params, truth.gcfg), 2),
                               type(cam)(*(x[None] for x in cam)), truth.cs, truth.rcfg_eval,
                               active)
        c = cuda_blend.compact_table(bcfg, *flat, bcfg.max_pairs)
        fslot = cuda_blend.broadcast_fields(c.ctable, c.gauss_c)
        err_k3 = check_k3(torch, "r5_jax_scene", fslot, c)
        staged = cuda_blend.sort_slots(bcfg, fslot, c)
        if int(staged.total) > bcfg.max_pairs:
            raise AssertionError("r5_jax_scene: the checked view overflows its pair budget")
        k1 = cuda_blend_mixed.forward_mixed(bcfg, staged)
        err_k1 = check_k1(torch, "r5_jax_scene", bcfg, staged, k1)
        k5 = cbl.forward_lockstep(bcfg, staged)
        err_k5 = check_k5(torch, "r5_jax_scene", bcfg, staged, k5)
        if not all(torch.equal(a, b) for a, b in zip(k1, k5)):
            raise AssertionError("r5_jax_scene: K5 differs from K1 on the same list")
    emit("r5_jax_scene", draws=R5_JAX_DRAWS, state=R5_JAX_STATE, jax_report=R5_JAX_REPORT,
         flags=" ".join(rp.ARMS["joint"][1]), seconds=round(seconds, 3),
         synthesis_s=round(t_synth, 3), launches=launches, predicted_launches=want_launches,
         port={k: got[k] for k in gaps}, jax={k: want[k] for k in gaps}, gaps=gaps,
         eval_max_num_pairs=render_with.max_num_pairs, eval_max_pairs=truth.rcfg_eval.max_pairs,
         checked_view_pairs=int(staged.total), gaussians_active=int(active.sum()),
         err_k1=err_k1, err_k3=err_k3, err_k5=err_k5)
    if missed:
        raise AssertionError(f"r5_jax_scene: JAX's report missed: {', '.join(missed)}")
    if launches["K3"] < 1 or launches["K1"] < 1:
        raise AssertionError(f"r5_jax_scene launches: {launches}")
    return {"K1": err_k1, "K3": err_k3, "K5": err_k5}


# ---------------------------------------------------------------------------
# parallel: the port's parallel/ on one card
# ---------------------------------------------------------------------------

PARALLEL_CAPACITY = 1 << 17    # the train point's 100k Gaussians in 2^17 slots
PARALLEL_RANKS = 4             # (b) on the first 3 ranks, (c) and (e) on 4, (d) on 2
PARALLEL_TIMED_STEPS = 2       # timed steps a rank in (b) and (d), after the checked one
ROWS_SHARE = 1e-4             # (c): pixels, splats past JAX's tolerances (see rank_rows)


def parallel_setup(torch, dev):
    """The train phase's operating point at 2^17 slots and one step's draws
    (the same on every rank: numpy and torch generators seeded alike)."""
    from deblurgs_tpu_torch.train import step as step_lib

    st, state, gt, proj = train_setup(torch, dev, capacity=PARALLEL_CAPACITY)
    draws = step_lib.draw_step(state, st, gt.shape,
                               torch.Generator(device=dev).manual_seed(SEED + 11))
    return st, state, gt, proj, draws


def step_parts(torch, st, state, gt, proj, draws):
    """One train step in its three parts: (forward, gradients, new state,
    metrics)."""
    from deblurgs_tpu_torch.train import step as step_lib

    fwd = step_lib.forward_loss(state, gt, 0, proj, st, draws)
    grads = step_lib.backward(fwd)
    new, metrics = step_lib.apply(state, fwd, grads, st, draws)
    return fwd, grads, new, metrics


def timed_steps(torch, st, state, gt, proj, draws, n: int) -> dict:
    """``n`` train steps from ``state`` with the same draws: CUDA-event and
    host ms each, and the peak memory of this process."""
    from deblurgs_tpu_torch.train import step as step_lib

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev, host = [], []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, _ = step_lib.train_step(state, gt, 0, proj, st, draws=draws)
        b.record()
        torch.cuda.synchronize()
        host.append(round((time.perf_counter() - t0) * 1e3, 3))
        ev.append(round(a.elapsed_time(b), 3))
    return dict(step_ms_events=ev, step_ms_host=host,
                peak_memory_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))


def tree_scaled_err(got, want) -> float:
    return max(scaled_err(g, w) for g, w in zip(got, want))


# The alignment logits' gradient is a sum of terms that nearly cancel (a
# softmax over the sub-frame times; ~1e-3 of the curves'), so two orders of
# the same sum part by ~1e-3 of it (two xla steps of the backends phase:
# 1.4e-3, PERF.md): ``nu`` is held to this bound, which a missing or
# doubled share still fails.
NU_GRAD_BOUND = 1e-2


def grad_errs(torch, grads, ref, dev, rows=slice(None), block=slice(None)) -> dict:
    """Each gradient leaf's max |diff| over the reference leaf's max |.|
    (``rows`` of the Gaussian leaves and of the views' ``block`` for a
    sharded rank)."""
    errs = {}
    for g, (name, w) in zip(grads[0], ref["g_params"].items()):
        errs[name] = max_err(g, w[rows].to(dev)) / (float(w.abs().max()) or 1.0)
    for g, (name, w) in zip(grads[1], ref["g_motion"].items()):
        errs[name] = scaled_err(g, w.to(dev))
    w = ref["g_vsp"]
    errs["vsp"] = max_err(grads[2], w[block][:, rows].to(dev)) / float(w.abs().max())
    return errs


def check_grad_errs(where: str, errs: dict, bound: float) -> None:
    bad = {k: v for k, v in errs.items() if not v <= (NU_GRAD_BOUND if k == "nu" else bound)}
    if bad:
        raise AssertionError(f"{where}: gradients {bad} past {bound:.1e} "
                             f"(nu: {NU_GRAD_BOUND:.0e})")


def parallel_world1(torch, dev, setup, root: str) -> dict:
    """(a) The step on a NCCL group of one rank against the plain step: bit
    for bit (loss, every gradient, every leaf of the new state); both timed.
    Also the plain step twice (its own spread) and the references of (b),
    (c) and (d), saved to ``root``."""
    import torch.distributed as dist

    from deblurgs_tpu_torch.parallel import shard

    st, state, gt, proj, draws = setup
    fwd, grads, new, metrics = step_parts(torch, st, state, gt, proj, draws)
    _, grads2, _, _ = step_parts(torch, st, state, gt, proj, draws)
    spread = max(tree_scaled_err(grads2[0], grads[0]), tree_scaled_err(grads2[1], grads[1]),
                 scaled_err(grads2[2], grads[2]))
    dist.init_process_group("nccl", init_method="file://" + os.path.join(root, "nccl"),
                            world_size=1, rank=0)
    try:
        mesh = shard.make_mesh(device=dev)
        st_m = dataclasses.replace(st, mesh=mesh)
        mesh.reset_traffic()
        fwd_m, grads_m, new_m, metrics_m = step_parts(torch, st_m, state, gt, proj, draws)
        traffic = mesh.traffic_report()
        if not torch.equal(fwd_m.total, fwd.total):
            raise AssertionError(f"(a) loss {float(fwd_m.total)} != {float(fwd.total)}")
        for name, a, b in (("params", grads_m[0], grads[0]), ("motion", grads_m[1], grads[1]),
                           ("vsp", (grads_m[2],), (grads[2],)),
                           ("new params", new_m.params, new.params),
                           ("new motion", new_m.motion, new.motion),
                           ("new aux", new_m.aux, new.aux),
                           ("new adam", tuple(new_m.adam_g.mu) + tuple(new_m.adam_g.nu),
                            tuple(new.adam_g.mu) + tuple(new.adam_g.nu))):
            for x, y in zip(a, b):
                if not torch.equal(x, y):
                    raise AssertionError(f"(a) {name} differs by {max_err(x, y):.3e}")
        ms = {"plain": timed_steps(torch, st, state, gt, proj, draws, 3),
              "nccl_world_1": timed_steps(torch, st_m, state, gt, proj, draws, 3)}
    finally:
        dist.destroy_process_group()
    # the references of (b)-(d): the plain step's loss and gradients, and
    # one sharp view rendered whole, with the gradients of sum(image · w)
    cpu = lambda t: tuple(x.detach().cpu() for x in t)   # noqa: E731
    rows = rows_reference(torch, st, state, proj, draws.bg)
    torch.save(dict(loss=float(fwd.total.detach()), g_params=dict(zip(grads[0]._fields, cpu(grads[0]))),
                    g_motion=dict(zip(grads[1]._fields, cpu(grads[1]))),
                    g_vsp=grads[2].detach().cpu(), spread=spread,
                    num_pairs=int(metrics.num_pairs), rows=rows),
               os.path.join(root, "reference.pt"))
    return dict(bitwise=True, grad_spread_of_a_rerun=spread, step_ms=ms,
                collectives_a_step=traffic, loss=float(fwd.total.detach()),
                num_pairs=int(metrics.num_pairs))


def rows_view(torch, st, state, proj):
    """(c)'s view: the train curve's middle sub-frame, its render inputs,
    a one-view pair budget and loss weights (seeded alike on every rank)."""
    from deblurgs_tpu_torch.core.camera import CameraArrays
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib

    with torch.no_grad():
        nu = motion_lib.sample_nus(state.motion, [0], st.mcfg)
        cams = motion_lib.subframe_cameras_batch(state.motion, [0], nu, proj, st.mcfg)
        mid = slice(st.n_sub // 2, st.n_sub // 2 + 1)
        rin = {k: v.detach() for k, v in gm.render_inputs(state.params, st.gcfg).items()}
        budget = size_max_pairs((rin, st.sh_degree), CameraArrays(*(x[mid] for x in cams)),
                                st.cs, st.rcfg, state.aux.active)
    w = torch.randn((st.cs.height, st.cs.width, 3), device=proj.device,
                    generator=torch.Generator(device=proj.device).manual_seed(SEED + 12))
    return cams.view[mid][0], rin, dataclasses.replace(st.rcfg, max_pairs=budget), w


def rows_reference(torch, st, state, proj, bg) -> dict:
    """(c)'s reference: the view rendered whole (K3, K1) and the gradients
    of ``sum(image · w)`` for means and opacities (K2, K4)."""
    from deblurgs_tpu_torch.core.camera import make_camera_arrays
    from deblurgs_tpu_torch.ops.rasterize import render

    view, rin, rcfg, w = rows_view(torch, st, state, proj)
    means = rin["means3d"].clone().requires_grad_(True)
    opac = rin["opacities"].clone().requires_grad_(True)
    out = render(means, rin["scales"], rin["rotations"], opac, rin["shs"],
                 make_camera_arrays(view, proj), st.cs, bg, cfg=rcfg, sh_degree=st.sh_degree,
                 active=state.aux.active)
    g_means, g_opac = torch.autograd.grad(torch.sum(out.image * w), (means, opac))
    return dict(image=out.image.detach().cpu(), radii=out.radii.cpu(),
                visible=out.visible.cpu(), num_pairs=int(out.num_pairs),
                g_means=g_means.cpu(), g_opac=g_opac.cpu())


def probe_collectives(torch, dev) -> dict:
    """Which collectives gloo runs on CUDA tensors here, each tried on
    every rank of the group (a refusal raises on every rank alike)."""
    import torch.distributed as dist

    n, out = dist.get_world_size(), {}
    x = torch.ones(4 * n, device=dev)
    calls = {"all_reduce": lambda: dist.all_reduce(x.clone()),
             "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x),
             "broadcast": lambda: dist.broadcast(x.clone(), src=0),
             "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                 torch.empty(4 * n * n, device=dev), x),
             "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                 torch.empty(4, device=dev), x),
             "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x)}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"refused: {str(e).splitlines()[0][:120]}"
        dist.barrier()
    return out


def rank_subframe(torch, mesh, setup, ref) -> dict:
    """(b) this rank's block of the 21 views: the checked step against the
    plain one, its launches, K1 and K2 bit for bit on 16 sampled tiles of
    the block, the timed steps and the bytes a step's collectives move."""
    from deblurgs_tpu_torch.parallel import shard

    st, state, gt, proj, draws = setup
    block = shard.local_views(mesh, st.n_sub)
    with torch.no_grad():
        from deblurgs_tpu_torch.core.camera import CameraArrays
        from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib

        nu = motion_lib.sample_nus(state.motion, [0], st.mcfg)
        cams = motion_lib.subframe_cameras_batch(state.motion, [0], nu, proj, st.mcfg)
        budget = size_max_pairs((gm.render_inputs(state.params, st.gcfg), st.sh_degree),
                                CameraArrays(*(x[block] for x in cams)), st.cs, st.rcfg,
                                state.aux.active)
    budget = int(shard.all_reduce(mesh, torch.tensor(budget, device=proj.device), "max"))
    st_b = dataclasses.replace(st, rcfg=dataclasses.replace(st.rcfg, max_pairs=budget),
                               mesh=mesh)
    mesh.reset_traffic()
    zero_counts()
    fwd, grads, _, metrics = step_parts(torch, st_b, state, gt, proj, draws)
    torch.cuda.synchronize()
    launches = read_counts()
    traffic = mesh.traffic_report()
    loss = float(fwd.total.detach())
    if not abs(loss - ref["loss"]) <= 1e-4 * abs(ref["loss"]):
        raise AssertionError(f"(b) rank {mesh.rank}: loss {loss} against {ref['loss']}")
    bound = max(GRAD_ATOL, 4 * ref["spread"])
    dev = proj.device
    errs = grad_errs(torch, grads, ref, dev, block=block)
    check_grad_errs(f"(b) rank {mesh.rank}", errs, bound)
    k = step_kernel_inputs(torch, st_b, state, gt, draws.bg, 0, proj, views=block)
    bcfg, staged = k["bcfg"], k["staged"]
    tiles = torch.from_numpy(np.random.default_rng(SEED + 13 + mesh.rank).choice(
        bcfg.total_tiles, 16, replace=False)).to(dev)
    err_k1 = check_k1(torch, f"(b) rank {mesh.rank}", bcfg, staged,
                      (k["C"], k["D"], k["T"], k["n_con"]), tiles=tiles)
    from deblurgs_tpu_torch.ops import cuda_blend_mixed

    kargs = (draws.bg, k["T"], k["dl_pix"], k["dl_d"], k["C"], k["D"])
    pg = cuda_blend_mixed.backward_mixed(bcfg, staged, *kargs)
    err_k2 = check_k2(torch, f"(b) rank {mesh.rank}", bcfg, staged, *kargs, pg, tiles=tiles)
    return dict(views=[block.start, block.stop], max_pairs=budget,
                num_pairs=int(metrics.num_pairs), loss=loss, grad_err_scaled=errs,
                grad_bound=bound, launches=launches, err_k1_16_tiles=err_k1,
                err_k2_16_tiles=err_k2[1], collectives_a_step=traffic,
                **timed_steps(torch, st_b, state, gt, proj, draws, PARALLEL_TIMED_STEPS))


def rank_rows(torch, mesh, setup, ref) -> dict:
    """(c) this rank's row slab of one 1080p view: the frame and the
    gradients of ``sum(image · w)`` against the whole render."""
    from deblurgs_tpu_torch.parallel import tile_shard

    st, state, gt, proj, draws = setup
    view, rin, rcfg, w = rows_view(torch, st, state, proj)
    fn = tile_shard.row_sharded_render(mesh, st.cs, proj, rcfg, sh_degree=st.sh_degree)

    def run():
        means = rin["means3d"].clone().requires_grad_(True)
        opac = rin["opacities"].clone().requires_grad_(True)
        out = fn(means, rin["scales"], rin["rotations"], opac, rin["shs"], view, draws.bg,
                 active=state.aux.active)
        return out, torch.autograd.grad(torch.sum(out.image * w), (means, opac))

    mesh.reset_traffic()
    zero_counts()
    out, (g_means, g_opac) = run()
    torch.cuda.synchronize()
    launches = read_counts()
    traffic = mesh.traffic_report()
    rows = ref["rows"]
    dev = proj.device
    # A slab's crop camera reaches each splat's pixel position through other
    # float32 roundings than the whole view's, so over 2M pixels and 100k
    # splats a few alpha gates (1/255) and radius ceilings flip: held as
    # shares past JAX's test tolerances (image 2e-4, gradients 2e-4 scaled),
    # with the image within two flipped gates of a colour (8e-3)
    diff = (out.image - rows["image"].to(dev)).abs()
    img = {"max": float(diff.max()), "share_past_2e-4": float((diff > 2e-4).float().mean())}
    radii_flips = int((out.radii.cpu() != rows["radii"]).sum())
    visible_flips = int((out.visible.cpu() != rows["visible"]).sum())
    errs = {}
    for name, g, want in (("means", g_means, rows["g_means"]),
                          ("opacities", g_opac, rows["g_opac"])):
        d = ((g - want.to(dev)).abs().reshape(g.shape[0], -1).amax(-1)
             / float(want.abs().max()))
        errs[name] = {"max_scaled": float(d.max()),
                      "share_past_2e-4": float((d > 2e-4).float().mean())}
    P = out.radii.shape[0]
    if not (img["max"] <= 8e-3 and img["share_past_2e-4"] <= ROWS_SHARE
            and radii_flips <= ROWS_SHARE * P and visible_flips <= ROWS_SHARE * P
            and all(e["share_past_2e-4"] <= ROWS_SHARE for e in errs.values())):
        raise AssertionError(f"(c) rank {mesh.rank}: image {img}, radii flips {radii_flips}, "
                             f"visible flips {visible_flips}, gradients {errs}")
    ms = cuda_ms(lambda: run(), 3)
    slab_h = tile_shard.slab_layout(st.cs, mesh.size, rcfg.tile_h)[0]
    return dict(rows=[mesh.rank * slab_h, (mesh.rank + 1) * slab_h], max_pairs=rcfg.max_pairs,
                image_err=img, radii_flips=radii_flips, visible_flips=visible_flips,
                grad_err=errs, num_pairs_max_slab=int(out.num_pairs),
                num_pairs_whole=rows["num_pairs"], launches=launches,
                forward_backward_ms=round(ms, 3), collectives=traffic)


def rank_gauss(torch, mesh, setup, ref) -> dict:
    """(d) this rank's half of the 2^17 slots: the checked step against the
    plain one (its rows' gradients), launches, timed steps, bytes."""
    from deblurgs_tpu_torch.parallel import gauss_shard

    st, state, gt, proj, draws = setup
    local = gauss_shard.shard_gauss_state(state, mesh)
    rows = gauss_shard.local_rows(mesh, PARALLEL_CAPACITY)
    st_g = dataclasses.replace(st, mesh=mesh)
    mesh.reset_traffic()
    zero_counts()
    fwd, grads, _, metrics = step_parts(torch, st_g, local, gt, proj, draws)
    torch.cuda.synchronize()
    launches = read_counts()
    traffic = mesh.traffic_report()
    loss = float(fwd.total.detach())
    if not abs(loss - ref["loss"]) <= 1e-4 * abs(ref["loss"]):
        raise AssertionError(f"(d) rank {mesh.rank}: loss {loss} against {ref['loss']}")
    dev = proj.device
    errs = grad_errs(torch, grads, ref, dev, rows=rows)
    bound = max(GRAD_ATOL, 4 * ref["spread"])
    check_grad_errs(f"(d) rank {mesh.rank}", errs, bound)
    return dict(rows=[rows.start, rows.stop], loss=loss, grad_err_scaled=errs,
                grad_bound=bound, launches=launches, num_pairs=int(metrics.num_pairs),
                collectives_a_step=traffic,
                **timed_steps(torch, st_g, local, gt, proj, draws, PARALLEL_TIMED_STEPS))


def rank_cameras(torch, mesh, source: str) -> dict:
    """(e) the eval scene's 8 cameras: this rank decodes its block only,
    and every camera is selected on every rank (digests of the bytes)."""
    import hashlib

    from deblurgs_tpu_torch.data.scene import Scene
    from deblurgs_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    n = len(Scene(source, None, resolution=1, load_indices=[]).info.train_cameras)
    mine = multihost.host_local_camera_split(n)
    scene = Scene(source, None, resolution=1, load_indices=mine)
    decode_s = time.perf_counter() - t0
    stack = multihost.assemble_global_images(scene.train_images, mesh)
    mesh.reset_traffic()
    t0 = time.perf_counter()
    digests = [hashlib.sha256(multihost.select_camera(stack, i).cpu().numpy().tobytes())
               .hexdigest() for i in range(n)]
    return dict(mine=mine, decode_s=round(decode_s, 3),
                select_all_s=round(time.perf_counter() - t0, 3),
                zero_rows=[i for i in range(n) if not scene.train_images[i].any()],
                digests=digests, collectives=mesh.traffic_report())


def parallel_rank(rank: int, root: str, source: str) -> dict:
    """One rank of the parallel phase (gloo, the ranks sharing the card):
    the collectives probe, then (b), (c), (d) and (e) on meshes of the
    first 3, 4, 2 and 4 ranks; the others wait for the next mesh."""
    import torch

    from deblurgs_tpu_torch.device import resolve_device
    from deblurgs_tpu_torch.ops import kernels
    from deblurgs_tpu_torch.parallel import gauss_shard, shard, tile_shard

    dev = resolve_device("cuda")
    kernels.load_library()                 # built by the parent
    out = {"collectives_on_cuda_tensors": probe_collectives(torch, dev)}
    setup = parallel_setup(torch, dev)
    ref = torch.load(os.path.join(root, "reference.pt"))
    for key, n, axis, fn in (("b", 3, "sf", rank_subframe), ("c", 4, tile_shard.PIXEL_AXIS,
                                                              rank_rows),
                             ("d", 2, gauss_shard.GAUSS_AXIS, rank_gauss)):
        mesh = shard.make_mesh(n, axis, device="cuda", share_card=True)
        if mesh is not None:
            out[key] = fn(torch, mesh, setup, ref)
            emit(f"parallel_{key}", rank=rank, **out[key])
        torch.cuda.empty_cache()
        torch.distributed.barrier()
    out["e"] = rank_cameras(torch, shard.make_mesh(None, "cam", device="cuda",
                                                   share_card=True), source)
    emit("parallel_e", rank=rank, **{k: v for k, v in out["e"].items() if k != "digests"})
    return out


def phase_parallel(torch, dev, train_step_ms) -> dict:
    """``parallel/`` on one card: (a) the train point's step on a NCCL
    group of one rank, bit for bit the plain step; then four ranks sharing
    the card over gloo (every collective staged through host memory and
    counted): (b) the sub-frames over 3 ranks of 7 views, (c) one view in 4
    row slabs, (d) the Gaussian axis over 2 ranks of 2^16 slots, (e) the
    eval scene's 8 cameras, each rank decoding its own. Returns the largest
    K1 and K2 errors of the ranks' checks (0.0: bit for bit)."""
    import hashlib
    import tempfile

    from deblurgs_tpu_torch.data.scene import Scene
    from deblurgs_tpu_torch.parallel import multihost

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        setup = parallel_setup(torch, dev)
        a = parallel_world1(torch, dev, setup, root)
        del setup
        torch.cuda.empty_cache()
        run = write_eval_run(torch, dev, os.path.join(root, "eval_run"))
        full = Scene(run["source"], None, resolution=1).train_images
        digests = [hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest() for x in full]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = multihost.launch(parallel_rank, PARALLEL_RANKS, root, run["source"],
                                 device="cuda", share_card=True, timeout_s=600)
        launch_s = time.perf_counter() - t0
    for r in ranks:
        if r["e"]["digests"] != digests:
            raise AssertionError("(e) a rank selected a camera unlike the whole decode")
        for key, n in (("b", 3), ("c", 4), ("d", 2)):
            if key in r:
                counts = r[key]["launches"]
                want = 1
                if any(counts[k] != want for k in ("K3", "K1", "K2", "K4")):
                    raise AssertionError(f"({key}) launches {counts}")
    b = [r["b"] for r in ranks if "b" in r]
    per_rank = lambda key, field: [r[key][field] for r in ranks if key in r]   # noqa: E731
    emit("parallel", a=a,
         b_step_ms_events=per_rank("b", "step_ms_events"),
         b_peak_memory_gb=per_rank("b", "peak_memory_gb"),
         c_forward_backward_ms=per_rank("c", "forward_backward_ms"),
         d_step_ms_events=per_rank("d", "step_ms_events"),
         d_peak_memory_gb=per_rank("d", "peak_memory_gb"),
         e_select_all_s=per_rank("e", "select_all_s"),
         collectives_on_cuda_tensors=ranks[0]["collectives_on_cuda_tensors"],
         plain_step_ms_train_phase=[round(x, 3) for x in train_step_ms],
         ranks_share_the_card=True, launch_s=round(launch_s, 3),
         seconds=round(time.perf_counter() - t_phase, 3))
    return {"K1": max(x["err_k1_16_tiles"] for x in b),
            "K2": max(x["err_k2_16_tiles"] for x in b)}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "deblurgs_tpu_torch")):
        fail("the deblurgs_tpu_torch package is not beside this script")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    dev, card = phase_env(torch)
    phase_build()
    with torch.no_grad():
        parity, k3_parity = phase_parity(torch, dev)
    sl = phase_slice(torch, dev)
    trained_err = phase_trained(torch, dev)
    k1_err = max([sl["err_k1"], trained_err] + [
        v for errs in parity.values() for key, v in errs.items() if key != "pairs"])
    k2_parity, k4_parity = phase_train_parity(torch, dev)
    tr = phase_train(torch, dev)
    k2_trained, k4_trained = phase_train_trained(torch, dev)
    phase_train_lockstep(torch, dev)
    with torch.no_grad():
        k5_parity, k6_parity = phase_lockstep_parity(torch, dev)
    ev = phase_eval(torch, dev)
    with torch.no_grad():
        kernels = phase_yardstick(torch, sl, max(k3_parity, sl["err_k3"]), k1_err, tr,
                                  max(k2_parity, tr["err_k2"], k2_trained),
                                  max(k4_parity, tr["err_k4"], k4_trained))
        kernels += phase_yardstick_lockstep(torch, ev, max(k5_parity, ev["err_k5"]),
                                            max(k6_parity, ev["err_k6"]))
    train_step_ms = tr["step_ms"]
    del sl, tr, ev           # the training run below needs the card's memory
    torch.cuda.empty_cache()
    cli_errs = phase_train_cli(torch, dev, train_step_ms)
    torch.cuda.empty_cache()
    phase_backends(torch, dev)
    torch.cuda.empty_cache()
    for key, err in phase_parallel(torch, dev, train_step_ms).items():
        cli_errs[key] = max(cli_errs.get(key, 0.0), err)
    torch.cuda.empty_cache()
    for key, err in phase_recovery(torch, dev).items():
        cli_errs[key] = max(cli_errs.get(key, 0.0), err)
    for key, err in phase_r5_jax_scene(torch, dev).items():
        cli_errs[key] = max(cli_errs.get(key, 0.0), err)
    for entry in kernels:
        key = entry["name"].split()[0]
        if key in cli_errs:
            entry["max_abs_err"] = max(entry["max_abs_err"], cli_errs[key])
    emit("done", seconds=round(time.perf_counter() - t_start, 3), card=card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
