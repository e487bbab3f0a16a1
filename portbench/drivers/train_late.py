"""Traffic driver ``train_late``: the program's training loop on a trained
scene, past densification, as a user resumes a run.

Set-up builds the capture's inputs from the seed as ``train_loop`` does
(the point cloud, the cameras, the ground truth), then a trained scene's
snapshot (:func:`trained_columns`: the configuration's ``gaussians``
Gaussians, their sizes under the configuration's ``assumed``), writes it
as ``point_cloud/iteration_<start>/point_cloud.ply`` in a temporary
directory, and starts the ``Trainer`` from it through
``init_state(load_path=...)``, the curves at the nominal poses. It then
runs the checked steps and the measured window as ``train_loop`` does,
through ``Trainer.train`` in the loop's own drain chunks.

The traced run profiles ``trace_chunks`` chunks and counts the host syncs
of one more. It walks no snapshot: no per-layer metric of the cell reads
the compositing counts, which are left empty.

The reference (``reference/late.py``) starts from the same snapshot and
works the checked steps out again after the window.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from portbench import check, scene, trace
from portbench.drivers.train_loop import (Feed, grown_change, leaves_of, program_configs,
                                          sync, window)
from portbench.reference import late
from portbench.reference.geometry import SH_C0
from portbench.reference.train import knn3_mean_sq

TRAINED_SEED_OFFSET = 0x7A1E


def trained_columns(cfg: dict, x, seed: int) -> dict:
    """A trained scene's PLY columns (float32, standard 3DGS layout) from
    the seed: ``gaussians`` Gaussians with positions N(0, cloud_sigma²);
    each scale axis log-normal, its median the capture's cloud's median
    3-NN RMS distance over (gaussians / points)^(1/3), its log-σ 0.5;
    rotations uniform; opacities U(0.05, 0.99); DC colours from byte
    colours as the cloud's; the rest of the SH N(0, 0.05²)."""
    sc, dev = cfg["scene"], x.points.device
    n, k = sc["gaussians"], (cfg["cli"]["sh_degree"] + 1) ** 2
    s_cloud = torch.sqrt(torch.clamp(knn3_mean_sq(x.points.float()), min=1e-7)).median()
    median = s_cloud / (sc["gaussians"] / sc["points"]) ** (1.0 / 3.0)
    gen = torch.Generator(device=dev).manual_seed(seed + TRAINED_SEED_OFFSET)
    draw = lambda *shape: torch.randn(shape, generator=gen, device=dev)   # noqa: E731
    xyz = draw(n, 3) * sc["cloud_sigma"]
    log_scale = torch.log(median) + 0.5 * draw(n, 3)
    q = draw(n, 4)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    opac = 0.05 + 0.94 * torch.rand(n, generator=gen, device=dev)
    colors = torch.randint(0, 256, (n, 3), generator=gen, device=dev).float() / 255.0
    f_dc = (colors - 0.5) / SH_C0
    f_rest = 0.05 * draw(n, 3 * (k - 1))           # channel-major, as the PLY holds it
    cols = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    cols.update({f"n{a}": torch.zeros_like(xyz[:, 0]) for a in "xyz"})
    cols.update({f"f_dc_{i}": f_dc[:, i] for i in range(3)})
    cols.update({f"f_rest_{i}": f_rest[:, i] for i in range(f_rest.shape[1])})
    cols["opacity"] = torch.log(opac / (1.0 - opac))
    cols.update({f"scale_{i}": log_scale[:, i] for i in range(3)})
    cols.update({f"rot_{i}": q[:, i] for i in range(4)})
    return {name: c.to(torch.float32).cpu().numpy() for name, c in cols.items()}


def write_ply(path: str, cols: dict) -> None:
    """A binary little-endian PLY of float32 columns (the vertex element)."""
    n = len(next(iter(cols.values())))
    arr = np.empty(n, dtype=np.dtype([(name, "<f4") for name in cols]))
    for name, c in cols.items():
        arr[name] = c
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in cols] + ["end_header"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(arr.tobytes())


class PairFeed(Feed):
    """``train_loop``'s feed, also keeping each step's staged pairs."""

    def __init__(self, *args):
        super().__init__(*args)
        self.pairs = {}

    def metrics(self, iteration: int, m) -> None:
        super().metrics(iteration, m)
        self.pairs[iteration] = (m.num_pairs, getattr(m, "pairs_staged", m.num_pairs),
                                 getattr(m, "pairs_recomputed", None))


def reference_readings(cfg, inputs, cols, first: int, records: dict, n: int,
                       dtype=torch.float32) -> dict:
    ref = late.ReferenceTrainer(cfg, inputs, cols, dtype)
    s0 = ref.init_state(first)
    state, losses, grad = s0, [], None
    for k in range(n):
        cam, bg, split = records[first + k]
        state, loss, grads, done = ref.step(state, cam, bg, split)
        if done is not None:
            raise ValueError(f"iteration {first + k} densifies: {cfg['name']} checks none")
        losses.append(loss)
        if k == 0:
            grad = check.norms(grads)
    n0 = s0.active.numel()
    change = grown_change(state.leaves, s0.leaves, torch.arange(n0, device=s0.active.device),
                          torch.zeros(n0, dtype=torch.bool, device=s0.active.device))
    return {"losses": losses, "grad": grad, "change": change, "densify": None}


def run(ctx: dict) -> dict:
    """One run of a cell; ``ctx`` as ``train_loop.run``'s."""
    from deblurgs_tpu_torch.train.loop import Trainer

    cfg, tr, dev = ctx["cfg"], ctx["traffic"], torch.device(ctx["device"])
    cli, ocfg_d = cfg["cli"], cfg["optimization"]
    first, n_check, chunk = tr["start_iteration"], tr["check_steps"], tr["chunk"]
    checked = range(first, first + n_check)
    if any(i < ocfg_d["densify_until_iter"] for i in checked):
        raise ValueError(f"{cfg['name']} starts past densification, not at {first}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    phases = {"start_s": time.perf_counter() - ctx["t_start"]}
    inputs = scene.make_inputs(cfg, ctx["seed"], dev)
    cols = trained_columns(cfg, inputs, ctx["seed"])
    sync(dev)
    phases["inputs_s"] = time.perf_counter() - ctx["t_start"]
    gcfg, mcfg, ocfg, rcfg = program_configs(cfg)
    scn = scene.program_scene(cfg, inputs, ctx["seed"])
    feed = PairFeed(scn, tuple(inputs.gt.shape[1:]), ctx["seed"], dev)
    trainer = Trainer(scene=scn, gcfg=gcfg, mcfg=mcfg, ocfg=ocfg, rcfg=rcfg,
                      tone_mapping=cli["tone_mapping_type"], model_path=None,
                      save_iterations=(), visualize=False,
                      batched_render=cli["batched_render"], cams_per_step=cli["cams_per_step"],
                      device=dev, seed=inputs.curve_seed, draws_fn=feed.draws,
                      on_metrics=feed.metrics)
    feed.trainer = trainer
    with tempfile.TemporaryDirectory() as run_dir:
        write_ply(os.path.join(run_dir, "point_cloud", f"iteration_{first}", "point_cloud.ply"),
                  cols)
        phases["ply_s"] = time.perf_counter() - ctx["t_start"]
        state, _ = trainer.init_state(load_path=run_dir)
    state = state._replace(step=first)
    to_host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}  # noqa: E731
    sync(dev)
    phases["trainer_s"] = time.perf_counter() - ctx["t_start"]

    # ---- set-up: the checked steps through the loop's own call, on to a
    # chunk's end
    p0, active0 = to_host(leaves_of(state)), state.aux.active.cpu()
    for i in checked:
        state = trainer.train(state, i, i)
        if i == first:
            mu1 = to_host({**state.adam_g.mu._asdict(), **state.adam_m.mu._asdict()})
    p_n = to_host(leaves_of(state))
    sync(dev)
    phases["checked_s"] = time.perf_counter() - ctx["t_start"]
    it = first + n_check
    end = -(-(it - 1) // chunk) * chunk
    if end >= it:
        state = trainer.train(state, it, end)
        it = end + 1
    prog = {"losses": [float(feed.losses[i]) for i in checked],
            "grad": check.norms({k: v / (1 - 0.9) for k, v in mu1.items()}),
            "change": grown_change(p_n, p0, active0.nonzero()[:, 0],
                                   torch.zeros_like(active0)),
            "densify": None}
    del p0, mu1, p_n
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    phases["warm_s"] = setup_s
    cap0, over0 = state.params.xyz.shape[0], int(state.overflow_count)
    first_timed = it

    def chunks(n_chunks: int):
        nonlocal state, it
        for _ in range(n_chunks):
            state = trainer.train(state, it, it + chunk - 1)
            it += chunk

    out: dict = {}
    if ctx["trace"]:
        seg = trace.profile_segment(lambda: chunks(tr["trace_chunks"]), dev)
        traced_iters = it - first_timed
        syncs = trace.count_syncs(lambda: chunks(1), dev)
        out["trace"] = dict(seg=seg, iterations=traced_iters, syncs=syncs,
                            sync_iterations=chunk, counts={})
    else:
        iterations, wall, ends = window(lambda: chunks(1), chunk, ctx["seconds"], t0,
                                        lambda: sync(dev))
        out["window"] = dict(iterations=iterations, wall_s=wall, setup_s=setup_s,
                             chunk_ends_s=ends)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window_its = range(first_timed, it)
    losses = torch.stack([feed.losses[i] for i in window_its])
    over = torch.stack([feed.overflowed[i] for i in window_its])
    failed = int((~torch.isfinite(losses) | over).sum())
    largest, staged, recomputed = feed.pairs[first]
    out["info"] = dict(
        max_pairs=trainer.rcfg.max_pairs, capacity=[cap0, state.params.xyz.shape[0]],
        overflowed_in_window=int(state.overflow_count) - over0,
        iterations=[first_timed, it - 1], active_after=int(state.aux.active.sum()),
        subframe_groups=getattr(trainer, "subframe_groups", 1),
        pairs_first_step=dict(largest_staging=int(largest), staged=int(staged),
                              recomputed=None if recomputed is None else int(recomputed)),
        setup_phases=phases)
    out.update(attempted=len(window_its), failed=failed, peak_bytes=peak)

    # ---- the program's state goes before the reference runs on the card
    records = feed.records
    del state, trainer, feed, scn, losses, over
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = reference_readings(cfg, inputs, cols, first, records, n_check)
    out["info"]["reference_s"] = time.perf_counter() - t1
    out["numbers"] = check.compare(prog, ref)
    out["readings"] = {"program": prog, "reference": ref}
    out["records"] = [records[first + k] for k in range(n_check)]
    out["info"]["end_s"] = time.perf_counter() - ctx["t_start"]
    return out
