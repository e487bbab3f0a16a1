#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``deblurgs_tpu_torch/csrc``
(nvcc, sm_90a, into ``build/``), then:

1. env        card name and power limit, torch / CUDA / nvcc versions, TF32 off;
2. build      compiles the kernel library and reports each kernel's registers;
3. parity     each kernel against its plain PyTorch version on the card at a
              mid size (256×256, 4k Gaussians, F = 3, tile 32): K3
              bitwise, K1 at atol 1e-5 / rtol 1e-4 with n_con exact, for
              need_n_contrib on and off and for ``fast``;
4. slice      the blurry render at full width (1920×1080, 100k Gaussians,
              SH degree 2, one order-9 se3 curve, F = 21, tile 32): the
              batched composition of the training step (subframe_cameras →
              one render_batch → mean) and the user-facing ``blur.query``
              (21 renders), with every launch counter zeroed just before and
              read just after; a per-stage breakdown by CUDA events; K3
              held bitwise against its plain version, K1 against its plain
              version on 64 sampled tiles, and the batched blur against the
              query's mean of 21 renders;
5. trained    ``runs/r5_jointb_state.npz`` at 256×256: camera 0's blurry
              observation and its sharp mid-trajectory view, kernel path
              against plain path;
6. train_parity  the backward kernels on the parity scene: K2 against its
              plain version slot for slot (default and ``fast``), K4 against
              its plain version, ``blend_fused``'s autograd gradients with the
              kernels against the same gradients through the plain versions,
              and two backward calls compared bitwise;
7. train      one DeblurGS train step at full width (1920×1080, 100k
              Gaussians seeded from ``bench.py``'s point-cloud distribution,
              SH 2, F = 21, order-9 se3 curve, tile 32, batched render, tile
              cull on, curve on from step 1, step 100, densify and reset
              pushed out): two warm-up steps and five timed steps with the
              launch counters zeroed just before and read just after, a
              breakdown (forward stages, losses, K2, K4 + scatter, the autograd
              rest, Adam and stats), peak memory and the device busy share;
              K2 against its plain version on 64 sampled tiles and K4 over all
              slots, with the step's own image cotangent;
8. train_trained  ``runs/r5_jointb_state.npz`` loaded whole (Adam moments
              included) at 256×256, F = 21: one step whose step number fires
              densify_and_prune, and K2/K4 against their plain versions on
              its deep tile lists;
9. yardstick  each kernel timed beside its plain version, its bound and, for
              K3 and K4, the one PyTorch call that computes the same function.

Each phase prints one JSON line; any failure raises. The line before the
last lists every ported kernel; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA card or without the package beside this script.
"""

from __future__ import annotations

import json
import math
import os
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
GRAD_ATOL = 2e-5              # |got - want| / max|want| for gradients


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    return float((a.double() - b.double()).abs().max())


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
    all), row by row, scaled by the row's max; rows 10-15 must be zero.
    Returns (largest scaled error, largest absolute error)."""
    from deblurgs_tpu_torch.ops import cuda_blend_mixed as cbm

    total = cbm.backward_total(bcfg, bg, T, dl_pix, dl_d, C, D)
    want = cbm.backward_ref(bcfg, staged.fields, staged.tile_start, staged.tile_stop, dl_pix,
                            dl_d, total, tiles=tiles)
    if tiles is not None:
        slots = tile_slots(torch, staged, tiles)
        got, want = got[:, slots], want[:, slots]
    if not bool((got[10:] == 0).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K2 {where}: rows 10-15 not zero or non-finite output")
    return (max(check_scaled(f"K2 {where} row {r}", got[r], want[r]) for r in range(10)),
            max_err(got, want))


def check_k4(torch, where: str, pair_grads, s_gc, P: int):
    """K4 against its plain version (float64 segment sum), column by column:
    (largest scaled error, largest absolute error)."""
    from deblurgs_tpu_torch.ops import cuda_blend

    got = cuda_blend.reduce_sorted(pair_grads, s_gc, P)
    want = cuda_blend.reduce_sorted_ref(pair_grads, s_gc, P)
    if not bool((got[:, 10:] == 0).all()):
        raise AssertionError(f"K4 {where}: columns 10-15 not zero")
    return (max(check_scaled(f"K4 {where} col {c}", got[:, c], want[:, c]) for c in range(10)),
            max_err(got, want))


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


def device_profile(torch, fn, top: int = 12) -> dict:
    """One call of ``fn`` under torch.profiler: the device kernels that take
    the most time, and the device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
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
                    for us, k, n in rows[:top]]}


def zero_counts() -> None:
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed

    cuda_blend.broadcast_fields.launches = 0
    cuda_blend_mixed.forward_mixed.launches = 0
    cuda_blend_mixed.backward_mixed.launches = 0
    cuda_blend.reduce_sorted.launches = 0


def read_counts() -> dict:
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed

    return {"K3": cuda_blend.broadcast_fields.launches,
            "K1": cuda_blend_mixed.forward_mixed.launches,
            "K2": cuda_blend_mixed.backward_mixed.launches,
            "K4": cuda_blend.reduce_sorted.launches}


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
    for name, kw in (("n_contrib", dict(need_n_contrib=True)),
                     ("plain", dict(need_n_contrib=False)),
                     ("fast", dict(need_n_contrib=False, fast=True))):
        rcfg = RasterizeConfig(tile_w=32, tile_h=32, max_pairs=1 << 16, **kw)
        bcfg = rcfg.blend_config(cs, n_images=3)
        flat = flat_preprocess(gaussians, cams, cs, rcfg)
        c = cuda_blend.compact_table(bcfg, *flat, bcfg.max_pairs)
        fslot = cuda_blend.broadcast_fields(c.ctable, c.gauss_c)
        k3_err = max(k3_err, check_k3(torch, f"parity {name}", fslot, c))
        st = cuda_blend.sort_slots(bcfg, fslot, c)
        if int(st.total) > bcfg.max_pairs:
            raise AssertionError("parity scene overflows its pair budget")
        got = cuda_blend_mixed.forward_mixed(bcfg, st)
        want = cuda_blend_mixed.forward_ref(bcfg, st.fields, st.tile_start, st.tile_stop)
        torch.cuda.synchronize()
        errs[name] = {k: check_close(f"K1 {name} {k}", g, w, 1e-5, 1e-4)
                      for k, g, w in zip(("C", "D", "final_T"), got[:3], want[:3])}
        if not torch.equal(got[3], want[3]):
            raise AssertionError(f"K1 {name}: n_con differs from the plain version")
        errs[name]["pairs"] = int(st.total)
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
        if launches["K2"] or launches["K4"]:
            raise AssertionError(f"the forward path launched a backward kernel: {launches}")
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
        want = cuda_blend_mixed.forward_ref(bcfg, st.fields, st.tile_start, st.tile_stop,
                                            tiles=tiles)
        err_k1 = max(check_close(f"K1 full width {k}", g[tiles], w, 1e-5, 1e-4)
                     for k, g, w in zip(("C", "D", "final_T"), k1[:3], want[:3]))

    emit("slice", width=W, height=H, gaussians=N, sh_degree=2, subframes=F, tile=32,
         max_pairs=max_pairs, num_pairs=num_pairs, max_per_tile=max_per_tile,
         blur_ms_events=[round(x, 4) for x in ev_ms],
         blur_ms_host=[round(x, 4) for x in host_ms], breakdown_ms=breakdown,
         launches=launches, launches_per_batched_blur=1, launches_per_query=F,
         err_batched_vs_query=err_loop, err_k3=err_k3, err_k1_sampled_tiles=err_k1,
         profile=profile)
    return dict(bcfg=bcfg, staged=st, compact=c, launches=launches, err_k1=err_k1,
                err_k3=err_k3)


def phase_trained(torch, dev):
    from deblurgs_tpu_torch import weights
    from deblurgs_tpu_torch.models import motion as motion_lib
    from deblurgs_tpu_torch.ops import rasterize
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
    P = flat[0].shape[0]
    sums = cuda_blend.reduce_sorted_ref(pg, st.s_gc, P)
    ids_u = torch.where(torch.arange(P, device=pg.device) < st.n_emit, st.ids, P)
    out = torch.zeros((P + 1, 16), dtype=sums.dtype, device=sums.device)
    out[ids_u] = sums
    out = out[:P]
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
        err_k4 = check_k4(torch, f"parity {name}", pg, st.s_gc, P)
        same = (torch.equal(pg, cuda_blend_mixed.backward_mixed(bcfg, st, bg, T, dl_pix, dl_d,
                                                                C, D))
                and torch.equal(cuda_blend.reduce_sorted(pg, st.s_gc, P),
                                cuda_blend.reduce_sorted(pg, st.s_gc, P)))
        if not same:
            raise AssertionError(f"K2/K4 {name}: two calls differ")
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


def step_kernel_inputs(torch, st, state, gt, bg, cam_idx, proj):
    """The staged pairs, compositor outputs and image cotangent of the
    step's render at ``state`` (no grad): what K2 and K4 see in the step."""
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed, tile_blend
    from deblurgs_tpu_torch.train import schedules

    bcfg = st.rcfg.blend_config(st.cs, n_images=st.n_sub)
    with torch.no_grad():
        nu = motion_lib.sample_nus(state.motion, [cam_idx], st.mcfg)
        cams = motion_lib.subframe_cameras_batch(state.motion, [cam_idx], nu, proj, st.mcfg)
        flat = flat_preprocess((gm.render_inputs(state.params, st.gcfg), st.sh_degree), cams,
                               st.cs, st.rcfg, state.aux.active)
        staged = cuda_blend.sort_stage(bcfg, *flat, bcfg.max_pairs)
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
    return dict(bcfg=bcfg, flat=flat, staged=staged, C=C, D=D, T=T, dl_pix=dl_pix, dl_d=dl_d,
                P=flat[0].shape[0])


def train_setup(torch, dev):
    """The full-width train step's state and statics (``bench.py``'s
    ``_train_step_bench`` settings, batched render on)."""
    from deblurgs_tpu_torch.models import gaussians as gm, motion as motion_lib
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
    from deblurgs_tpu_torch.train import step as step_lib
    from deblurgs_tpu_torch.train.config import OptimizationConfig

    (W, H, N), F = TRAIN_SIZE, 21
    rng = np.random.default_rng(SEED + 3)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)   # noqa: E731
    gcfg = gm.GaussianConfig(sh_degree=2)
    params, aux = gm.create_from_pcd(t(rng.standard_normal((N, 3)) * 2.0),
                                     t(rng.uniform(0.0, 1.0, (N, 3))), gcfg, capacity=N)
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
        if n != 7:
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
    k4_scatter_ms = cuda_ms(lambda: cuda_blend.reduce_pair_grads(staged, pg, k["P"]), 5)
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
                 "K4_and_scatter": round(k4_scatter_ms, 4),
                 "autograd_rest": round(acc["backward"] - k2_ms - k4_scatter_ms, 4),
                 "adam_and_stats": round(acc["apply"], 4)}

    # ---- the kernels against their plain versions at these shapes ----
    tiles = torch.from_numpy(np.random.default_rng(SEED + 7).choice(
        bcfg.total_tiles, 64, replace=False)).to(dev)
    err_k2 = check_k2(torch, "train (64 tiles)", bcfg, staged, *kargs, pg, tiles=tiles)
    err_k4 = check_k4(torch, "train", pg, staged.s_gc, k["P"])
    profile = device_profile(torch, lambda: step_lib.train_step(state, gt, 0, proj, st,
                                                                generator=gen))
    emit("train", width=W, height=H, gaussians=N, sh_degree=2, subframes=F, tile=32,
         state_step=100, max_pairs=st.rcfg.max_pairs, num_pairs=int(metrics.num_pairs),
         max_per_tile=int(metrics.max_per_tile), step_ms_events=[round(x, 4) for x in step_ms],
         step_ms_host=[round(x, 4) for x in host_ms], breakdown_ms=breakdown,
         peak_memory_gb=round(peak_gb, 3), launches=launches, launches_per_step=1,
         loss=losses_seen, changed=changed, err_k2_sampled_tiles=err_k2, err_k4=err_k4,
         profile=profile)
    return dict(k=k, pg=pg, launches=launches, err_k2=err_k2[1], err_k4=err_k4[1], k2_ms=k2_ms)


def forward_stages(torch, bcfg, make_flat, bg, n_views: int, reps: int = 3) -> dict:
    """CUDA-event breakdown of the forward path (no grad): ``make_flat()``
    (sub-frame cameras + preprocess), compact, K3, sort, K1, compose."""
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed, tile_blend

    names = ("preprocess", "compact", "K3", "sort", "K1", "compose")
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
            out = cuda_blend_mixed.forward_mixed(bcfg, st)
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
    if any(n != 1 for n in launches.values()):
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
    err_k4 = check_k4(torch, "trained", pg, k["staged"].s_gc, k["P"])
    emit("train_trained", state=os.path.relpath(path, REPO), size=[W, H], subframes=F,
         step=step, loss=float(metrics.loss), pairs=int(metrics.num_pairs),
         max_per_tile=int(metrics.max_per_tile), active_before=active_before,
         active_after=int(new_state.aux.active.sum()), densify=report, launches=launches,
         err_k2=err_k2, err_k4=err_k4)
    return err_k2[1], err_k4[1]


def phase_yardstick(torch, sl, k3_err: float, k1_err: float, tr=None, k2_err=0.0,
                    k4_err=0.0):
    """Each kernel timed beside its plain version and its bound, K3 and K1
    at the slice's shapes, K2 and K4 at the train step's (``tr``); returns
    the kernels line (``*_err``: each kernel's largest absolute error
    against its plain version over the earlier phases)."""
    from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed

    bcfg, st, c = sl["bcfg"], sl["staged"], sl["compact"]
    gauss_c = c.gauss_c.to(torch.int32)
    ctable = c.ctable.contiguous()
    max_pairs = gauss_c.shape[0]

    # K3: the kernel, its plain version, and the one PyTorch call
    k3_ms = cuda_ms(lambda: cuda_blend.broadcast_fields(ctable, gauss_c), 20)
    k3_plain = cuda_ms(lambda: cuda_blend.broadcast_fields_ref(ctable, gauss_c), 20)
    k3_lib = cuda_ms(lambda: torch.index_select(ctable.t(), 1, gauss_c), 20)
    k3_lib_err = max_err(cuda_blend.broadcast_fields(ctable, gauss_c),
                         torch.index_select(ctable.t(), 1, gauss_c))
    n_emit = int(c.n_emit)
    k3_bytes = 4 * max_pairs + 64 * n_emit + 64 * max_pairs
    k3_bound = k3_bytes / HBM_BYTES_PER_S * 1e3

    # K1: ranges as int32 so the timed call is the launch alone
    st32 = st._replace(tile_start=st.tile_start.to(torch.int32),
                       tile_stop=st.tile_stop.to(torch.int32))
    k1_ms = cuda_ms(lambda: cuda_blend_mixed.forward_mixed(bcfg, st32), 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cuda_blend_mixed.forward_ref(bcfg, st.fields, st.tile_start, st.tile_stop)
    torch.cuda.synchronize()
    k1_plain = (time.perf_counter() - t0) * 1e3
    *_, evals = cuda_blend_mixed.forward_ref(bcfg, st.fields, st.tile_start, st.tile_stop,
                                             count_evals=True)
    evals = int(evals)
    staged_pairs = int((st.tile_stop - st.tile_start).sum())
    px = bcfg.total_tiles * bcfg.tile_px
    out_bytes = px * (12 + 4 + 4 + (4 if bcfg.need_n_contrib else 0))
    k1_bytes = 40 * staged_pairs + 8 * bcfg.total_tiles + out_bytes
    k1_byte_ms = k1_bytes / HBM_BYTES_PER_S * 1e3
    k1_op_ms = EVAL_OPS * evals / F32_OPS_PER_S * 1e3
    emit("yardstick", K3=dict(ms=k3_ms, plain_ms=k3_plain, library_ms=k3_lib,
                              library_call="torch.index_select(ctable.t(), 1, gauss_c)",
                              library_max_abs_err=k3_lib_err, bytes=k3_bytes, bound_ms=k3_bound),
         K1=dict(ms=k1_ms, plain_ms=k1_plain, staged_pairs=staged_pairs, evaluations=evals,
                 bytes=k1_bytes, bytes_ms=k1_byte_ms, ops=EVAL_OPS * evals, ops_ms=k1_op_ms))
    # K2 and K4 at the train step's shapes and image cotangent
    k = tr["k"]
    bcfg2, st2, P = k["bcfg"], k["staged"], k["P"]
    kargs = (torch.tensor([0.1, 0.2, 0.3], device=st2.fields.device), k["T"], k["dl_pix"],
             k["dl_d"], k["C"], k["D"])
    st2 = st2._replace(tile_start=st2.tile_start.to(torch.int32),
                       tile_stop=st2.tile_stop.to(torch.int32))
    k2_ms = cuda_ms(lambda: cuda_blend_mixed.backward_mixed(bcfg2, st2, *kargs), 10)
    total = cuda_blend_mixed.backward_total(bcfg2, *kargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cuda_blend_mixed.backward_ref(bcfg2, st2.fields, st2.tile_start, st2.tile_stop, kargs[2],
                                  kargs[3], total)
    torch.cuda.synchronize()
    k2_plain = (time.perf_counter() - t0) * 1e3
    *_, evals2 = cuda_blend_mixed.forward_ref(bcfg2, st2.fields, st2.tile_start, st2.tile_stop,
                                              count_evals=True)
    evals2 = int(evals2)
    kept2 = int((st2.tile_stop - st2.tile_start).sum())
    max_pairs2 = st2.fields.shape[1]
    px2 = bcfg2.total_tiles * bcfg2.tile_px
    k2_bytes = 40 * kept2 + 8 * bcfg2.total_tiles + 20 * px2 + 64 * max_pairs2
    k2_byte_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    k2_op_ms = EVAL_OPS * evals2 / F32_OPS_PER_S * 1e3

    pg = tr["pg"]
    s_gc = st2.s_gc
    k4_ms = cuda_ms(lambda: cuda_blend.reduce_sorted(pg, s_gc, P), 10)
    k4_plain = cuda_ms(lambda: cuda_blend.reduce_sorted_ref(pg, s_gc, P), 3)
    seg = torch.clamp(s_gc.to(torch.int64), max=P)
    rows = pg[:10].T.contiguous()

    def library():
        return torch.zeros((P + 1, 10), device=pg.device).index_add_(0, seg, rows)

    k4_lib = cuda_ms(library, 10)
    k4_lib_err = max_err(library()[:P], cuda_blend.reduce_sorted(pg, s_gc, P)[:, :10])
    k4_bytes = 40 * kept2 + 4 * max_pairs2 + 64 * P
    k4_bound = k4_bytes / HBM_BYTES_PER_S * 1e3
    emit("yardstick_backward",
         K2=dict(ms=k2_ms, plain_ms=k2_plain, staged_pairs=kept2, evaluations=evals2,
                 bytes=k2_bytes, bytes_ms=k2_byte_ms, ops=EVAL_OPS * evals2, ops_ms=k2_op_ms),
         K4=dict(ms=k4_ms, plain_ms=k4_plain, library_ms=k4_lib,
                 library_call="torch.zeros((P+1, 10)).index_add_(0, rank, grads[:10].T)",
                 library_max_abs_err=k4_lib_err, ranks=P, bytes=k4_bytes, bound_ms=k4_bound))
    launches = sl["launches"]
    return [
        {"name": "K3 broadcast_fields", "route": "cuda",
         "source": "deblurgs_tpu_torch/csrc/broadcast_fields.cu",
         "replaces": "deblurgs_tpu/ops/pallas_blend.py:199", "launches": launches["K3"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": "bytes", "library_ms": k3_lib},
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


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "deblurgs_tpu_torch")):
        fail("the deblurgs_tpu_torch package is not beside this script")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    dev, _ = phase_env(torch)
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
    with torch.no_grad():
        kernels = phase_yardstick(torch, sl, max(k3_parity, sl["err_k3"]), k1_err, tr,
                                  max(k2_parity, tr["err_k2"], k2_trained),
                                  max(k4_parity, tr["err_k4"], k4_trained))
    emit("done", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
