"""Traffic driver ``train_loop``: the program's training loop as a user runs it.

Set-up builds the inputs from the seed, the program's configuration through
its own CLI parsers (``cli/args.py``, ``cli/train.py::build_configs``), a
``Trainer`` over the synthesised scene, and its initial state
(``create_from_pcd``, the curves) moved to ``start_iteration``. It then
drives that one trainer through ``Trainer.train``, one call an iteration,
for the first ``check_steps`` iterations (read for the comparison with the
reference; with the traffic's start they hold a densify event) and on to
the end of a drain chunk. The measured window calls
``Trainer.train`` in whole chunks of ``chunk`` iterations, the loop's own
drain cadence, until ``--seconds`` have passed; the host clock closes it on
``torch.cuda.synchronize()``.

Every step's draws come from the benchmark's generator (``draws_fn``, the
same ``draw_step`` the loop calls otherwise) and every camera from the
scene's shuffled order, both recorded for the reference.

The traced run profiles ``trace_chunks`` chunks instead of the window,
then counts the host syncs of one more chunk.
"""

from __future__ import annotations

import time
from argparse import ArgumentParser

import torch

from portbench import check, scene, trace
from portbench.counts import evaluations
from portbench.reference.train import GAUSS, LEAVES, ReferenceTrainer

DRAW_SEED_OFFSET = 0x5EED


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_configs(cfg: dict):
    """The program's config objects, made as its training CLI makes them."""
    from deblurgs_tpu_torch.cli.args import ModelParams, OptimizationParams
    from deblurgs_tpu_torch.cli.train import build_configs

    parser = ArgumentParser()
    lp, op = ModelParams(parser), OptimizationParams(parser)
    args = parser.parse_args([])
    for key, value in {**cfg["cli"], **cfg["optimization"]}.items():
        if not hasattr(args, key):
            raise KeyError(f"the program's CLI has no setting {key!r}")
        setattr(args, key, value)
    return build_configs(lp.extract(args), op.extract(args))


def leaves_of(state) -> dict:
    return {**state.params._asdict(), **state.motion._asdict()}


class Feed:
    """The loop's camera picks and step draws, recorded; optionally a copy
    of the state before each step (for the traced run's counts)."""

    def __init__(self, scn, gt_shape, seed: int, dev):
        self.trainer = None
        self.gt_shape = gt_shape
        self.gen = torch.Generator(device=dev).manual_seed(seed + DRAW_SEED_OFFSET)
        self.picks, self.records, self.snaps = [], {}, []
        self.losses, self.overflowed = {}, {}
        self.snap = False
        self.keep_split = set()     # iterations whose split samples the reference needs
        real = scn.get_random_cam_idx

        def pick():
            self.picks.append(real())
            return self.picks[-1]

        scn.get_random_cam_idx = pick

    def draws(self, iteration: int, state):
        from deblurgs_tpu_torch.train import step as step_lib

        t = self.trainer
        st = t.statics(*t.phase_statics(iteration), t.rcfg)
        d = step_lib.draw_step(state, st, self.gt_shape, self.gen)
        split = d.split if iteration in self.keep_split else None
        self.records[iteration] = (self.picks[-1], d.bg, split)
        if self.snap:
            snap = {k: v.clone() for k, v in leaves_of(state).items()}
            snap.update(active=state.aux.active.clone(), cam=self.picks[-1],
                        iteration=iteration)
            self.snaps.append(snap)
        return d

    def metrics(self, iteration: int, m) -> None:
        self.losses[iteration] = m.loss
        self.overflowed[iteration] = m.overflowed


def grown_change(p_end: dict, p0: dict, old0, new_end) -> dict:
    """Each leaf's change: the rows that were Gaussians at the start
    (indices ``old0``) by their difference, the rows that densification
    added (mask ``new_end``) by their value."""
    out = {}
    for k in LEAVES:
        if k in GAUSS:
            d = torch.cat([(p_end[k][old0] - p0[k][old0]).reshape(-1),
                           p_end[k][new_end].reshape(-1)])
        else:
            d = p_end[k] - p0[k]
        out[k] = d.float()
    return check.norms(out)


def program_densify(before: dict, after: dict) -> dict:
    """What the program's densify event did, read from its rows before and
    after it (the event's step applies no Adam update to the Gaussians): a
    split moves its row; a clone is a new row equal to its source; a prune
    turns a row off."""
    old = before["active"]
    moved = old & ((after["xyz"] != before["xyz"]).any(-1)
                   | (after["scaling"] != before["scaling"]).any(-1))
    new = after["active"] & ~old
    src = old.nonzero()[:, 0]
    key = lambda rows: [r.tobytes() for r in rows.numpy()]   # noqa: E731
    where = dict(zip(key(before["xyz"][src]), src.tolist()))
    cloned = sorted(where[b] for b in key(after["xyz"][new]) if b in where)
    return {"cloned": cloned, "split": moved.nonzero()[:, 0].tolist(),
            "pruned": (old & ~after["active"]).nonzero()[:, 0].tolist(),
            "n_active": int(after["active"].sum())}


def reference_readings(cfg, inputs, first: int, records: dict, n: int,
                       dtype=torch.float32) -> dict:
    ref = ReferenceTrainer(cfg, inputs, dtype)
    s0 = ref.init_state(first)
    state, losses, grad, dens = s0, [], None, None
    for k in range(n):
        cam, bg, split = records[first + k]
        state, loss, grads, done = ref.step(state, cam, bg, split)
        losses.append(loss)
        if k == 0:
            grad = check.norms(grads)
        if done is not None:
            dens = {"cloned": done.cloned.tolist(), "split": done.split.tolist(),
                    "pruned": done.pruned.tolist(), "n_active": done.n_active}
    n0 = s0.active.numel()
    new = state.active.clone()
    new[:n0] = False
    change = grown_change(state.leaves, s0.leaves, torch.arange(n0, device=new.device), new)
    return {"losses": losses, "grad": grad, "change": change, "densify": dens}


def window(step_chunk, chunk: int, seconds: float, t0: float, synchronize,
           clock=time.perf_counter) -> tuple:
    """Whole chunks from ``t0`` until ``seconds`` have passed: (iterations,
    wall seconds to the synchronise after the last chunk, the host clock at
    each chunk's end, from ``t0``)."""
    n, ends = 0, []
    while True:
        step_chunk()
        n += chunk
        ends.append(clock() - t0)
        if ends[-1] >= seconds:
            break
    synchronize()
    return n, clock() - t0, ends


def run(ctx: dict) -> dict:
    """One run of a cell; ``ctx``: cfg, traffic, seed, seconds, trace,
    device, t_start (the process's start on ``time.perf_counter``)."""
    from deblurgs_tpu_torch.train.loop import Trainer

    cfg, tr, dev = ctx["cfg"], ctx["traffic"], torch.device(ctx["device"])
    cli = cfg["cli"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # set-up's phases, each a time from the process's start
    phases = {"start_s": time.perf_counter() - ctx["t_start"]}
    inputs = scene.make_inputs(cfg, ctx["seed"], dev)
    sync(dev)
    phases["inputs_s"] = time.perf_counter() - ctx["t_start"]
    gcfg, mcfg, ocfg, rcfg = program_configs(cfg)
    scn = scene.program_scene(cfg, inputs, ctx["seed"])
    feed = Feed(scn, tuple(inputs.gt.shape[1:]), ctx["seed"], dev)
    trainer = Trainer(scene=scn, gcfg=gcfg, mcfg=mcfg, ocfg=ocfg, rcfg=rcfg,
                      tone_mapping=cli["tone_mapping_type"], model_path=None,
                      save_iterations=(), visualize=False,
                      batched_render=cli["batched_render"], cams_per_step=cli["cams_per_step"],
                      device=dev, seed=inputs.curve_seed, draws_fn=feed.draws,
                      on_metrics=feed.metrics)
    feed.trainer = trainer
    state, _ = trainer.init_state()
    first, n_check, chunk = tr["start_iteration"], tr["check_steps"], tr["chunk"]
    state = state._replace(step=first)
    to_host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}  # noqa: E731
    rows = lambda s: to_host(dict(xyz=s.params.xyz, scaling=s.params.scaling,  # noqa: E731
                                  active=s.aux.active))
    checked = range(first, first + n_check)
    dens_at = [i for i in checked if ocfg.densify_from_iter < i < ocfg.densify_until_iter
               and i % ocfg.densification_interval == 0]
    feed.keep_split = set(dens_at)
    sync(dev)
    phases["trainer_s"] = time.perf_counter() - ctx["t_start"]

    # ---- set-up: the checked steps through the loop's own call, on to a
    # chunk's end
    p0, active0 = to_host(leaves_of(state)), state.aux.active.cpu()
    around = {}
    for i in checked:
        if i in dens_at:
            around["before"] = rows(state)
        state = trainer.train(state, i, i)
        if i == first:
            mu1 = to_host({**state.adam_g.mu._asdict(), **state.adam_m.mu._asdict()})
        if i in dens_at:
            around["after"] = rows(state)
    p_n, active_n = to_host(leaves_of(state)), state.aux.active.cpu()
    sync(dev)
    phases["checked_s"] = time.perf_counter() - ctx["t_start"]
    it = first + n_check
    end = -(-(it - 1) // chunk) * chunk
    if end >= it:
        state = trainer.train(state, it, end)
        it = end + 1
    prog = {"losses": [float(feed.losses[i]) for i in checked],
            "grad": check.norms({k: v / (1 - 0.9) for k, v in mu1.items()}),
            "change": grown_change(p_n, p0, active0.nonzero()[:, 0], active_n & ~active0),
            "densify": program_densify(around["before"], around["after"]) if around else None}
    del p0, mu1, p_n, around
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
        feed.snap = True
        seg = trace.profile_segment(lambda: chunks(tr["trace_chunks"]), dev)
        feed.snap = False
        traced_iters = it - first_timed
        syncs = trace.count_syncs(lambda: chunks(1), dev)
        out["trace"] = dict(seg=seg, iterations=traced_iters, syncs=syncs,
                            sync_iterations=chunk)
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
    out["info"] = dict(
        max_pairs=trainer.rcfg.max_pairs, capacity=[cap0, state.params.xyz.shape[0]],
        overflowed_in_window=int(state.overflow_count) - over0,
        iterations=[first_timed, it - 1],
        densify_events=[i for i in window_its
                        if ocfg.densify_from_iter < i < ocfg.densify_until_iter
                        and i % ocfg.densification_interval == 0],
        opacity_resets=[i for i in window_its if i < ocfg.densify_until_iter
                        and i % ocfg.opacity_reset_interval == 0],
        active_after=int(state.aux.active.sum()), setup_phases=phases)
    out.update(attempted=len(window_its), failed=failed, peak_bytes=peak)

    # ---- the program's state goes before the reference runs on the card
    snaps, records = feed.snaps, feed.records
    del state, trainer, feed, scn, losses, over
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ctx["trace"]:
        t1 = time.perf_counter()
        counted = [evaluations.count_iteration(s, cfg["scene"], cli) for s in snaps]
        del snaps
        out["trace"]["counts"] = {k: sum(c[k] for c in counted) for k in counted[0]}
        out["info"]["counts_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    ref = reference_readings(cfg, inputs, first, records, n_check)
    out["info"]["reference_s"] = time.perf_counter() - t1
    out["numbers"] = check.compare(prog, ref)
    out["readings"] = {"program": prog, "reference": ref}
    out["records"] = [records[first + k] for k in range(n_check)]
    return out
