"""Sub-frame groups in the port's train step and the planner that picks
them (``train/step.py::_render_groups``, ``train/loop.py::plan_groups``),
and a trained scene entering through its PLY (``Trainer.init_state``).

A step whose sub-frames render in G groups, each staged again in the
backward, holds the one-render step: the same images (so the same loss,
bit for bit) and the same gradients up to float32 summation order, since
each Gaussian's and each curve's gradient is summed per group and then
over the groups. Scenes are small (64×48, 150 Gaussians, tile 16, F = 5)
and made with numpy from a seed; the kernels run their plain versions.
"""

import copy
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from deblurgs_tpu_torch.core import camera as tcam
from deblurgs_tpu_torch.models import gaussians as tgm
from deblurgs_tpu_torch.models import motion as tmm
from deblurgs_tpu_torch.ops import rasterize as tras
from deblurgs_tpu_torch.train import loop as tloop
from deblurgs_tpu_torch.train import step as tstep
from deblurgs_tpu_torch.train.config import OptimizationConfig
from deblurgs_tpu_torch.utils import profiling
from portbench import check, harness, scene
from portbench.drivers import train_late, train_loop
from portbench.reference import late
from tests.torch_bridge import make_gaussians, projection, rodrigues

W, H, F, N, CAPACITY = 64, 48, 5, 150, 256
# curves on, SH 1 on, no densification or reset in reach
OCFG = dict(iterations=10_000, curve_start_iter=1, curve_end_iter=10_000,
            densify_until_iter=2, opacity_reset_interval=100_000, curve_alignment_lr=0.0,
            position_lr_init=1.6e-3, position_lr_final=1.6e-5)
# summation order only: per group, then over the groups (K4's fixed-order
# sums and autograd's accumulation into the shared leaves), relative to
# each leaf's largest gradient; Adam's first step divides by |g|, so a
# change moves by as much only where a gradient is that close to 0
GRAD_RTOL = 2e-5


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _problem(seed=7, B=1):
    """(state, statics, gt [B?, H, W, 3], cam index, projection, draws)."""
    means, scales, rots, opac, shs = make_gaussians(seed, n=N, spread=1.0, sh_deg=1)
    pad = CAPACITY - N

    def t(x, fill=0.0):
        x = torch.from_numpy(x)
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill)])

    rot = t(rots)
    rot[N:, 0] = 1.0
    params = tgm.GaussianParams(xyz=t(means), f_dc=t(shs[:, :1]), f_rest=t(shs[:, 1:]),
                                scaling=t(np.log(scales), math.log(0.01)), rotation=rot,
                                opacity=t(opac[:, None], 0.1))
    zeros = torch.zeros(CAPACITY)
    aux = tgm.GaussianAux(torch.arange(CAPACITY) < N, zeros, zeros.clone(), zeros.clone())
    angles = np.linspace(-0.3, 0.3, 2)
    c2w = rodrigues(np.stack([np.zeros(2), angles, np.zeros(2)], -1))
    centers = np.einsum("nij,j->ni", c2w, np.array([0.0, 0.0, -4.0]))
    mcfg = tmm.MotionConfig(curve_order=3, n_subframes=F)
    motion = tmm.init_motion(torch.tensor(c2w, dtype=torch.float32),
                             torch.tensor(centers, dtype=torch.float32), mcfg,
                             torch.Generator().manual_seed(seed), init_noise=0.02).params()
    state = tstep.init_state(params, motion, aux)._replace(step=500)
    fovx = 1.1
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cs = tcam.CameraStatic(width=W, height=H, tanfovx=math.tan(fovx / 2),
                           tanfovy=math.tan(fovy / 2), znear=0.01, zfar=100.0)
    st = tstep.TrainStatics(
        gcfg=tgm.GaussianConfig(sh_degree=1), mcfg=mcfg, ocfg=OptimizationConfig(**OCFG),
        rcfg=tras.RasterizeConfig(tile_w=16, tile_h=16, max_pairs=1 << 14,
                                  need_n_contrib=False),
        cs=cs, sh_degree=1, n_sub=F, tone_mapping="identity", spatial_lr_scale=2.0,
        batched_render=True, cams_per_step=B)
    rng = np.random.default_rng(seed)
    gt = torch.from_numpy(rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32))
    cam = [0, 1][:B] if B > 1 else 0
    draws = tstep.StepDraws(bg=torch.from_numpy(rng.uniform(0, 1, 3).astype(np.float32)))
    proj = torch.from_numpy(projection(0.01, 100.0, fovx, fovy).astype(np.float32))
    return state, st, gt if B > 1 else gt[0], cam, proj, draws


def _step(groups: int, B: int = 1):
    state, st, gt, cam, proj, draws = _problem(B=B)
    st = dataclasses.replace(st, subframe_groups=groups)
    fwd = tstep.forward_loss(state, gt, cam, proj, st, draws)
    grads = tstep.backward(fwd)
    new, metrics = tstep.apply(state, fwd, grads, st, draws)
    return state, fwd, grads, new, metrics


def test_group_bounds_are_consecutive_and_nearly_equal():
    assert tstep.group_bounds(21, 3) == [(0, 7), (7, 14), (14, 21)]
    assert tstep.group_bounds(5, 2) == [(0, 3), (3, 5)]
    assert tstep.group_bounds(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert tstep.group_bounds(4, 1) == [(0, 4)]


@pytest.mark.parametrize("B", [1, 2], ids=["one_camera", "two_cameras"])
def test_grouped_step_holds_the_one_render_step(B):
    """G = 2 and 3 against G = 1 from the same state and draws: the loss
    and the images bitwise; every gradient and the Adam change within
    summation order; the pairs: the largest staging's for the budget, every
    staging's (the backward's again) for the counters."""
    state, ref, ref_grads, ref_new, ref_m = _step(1, B)
    assert ref.recomputed is None and int(ref_m.pairs_recomputed) == 0
    assert int(ref_m.pairs_staged) == int(ref_m.num_pairs)
    for groups in (2, 3):
        _, fwd, grads, new, m = _step(groups, B)
        assert torch.equal(fwd.total, ref.total), groups
        assert torch.equal(fwd.blurred, ref.blurred), groups
        flat = lambda g: [*g[0], *g[1], g[2]]   # noqa: E731
        for name, a, b in zip(tstep.gm.GaussianParams._fields + tmm.MotionParams._fields
                              + ("vsp",), flat(grads), flat(ref_grads)):
            scale = float(b.abs().max())
            assert scale > 0, name
            torch.testing.assert_close(a, b, rtol=0, atol=GRAD_RTOL * scale, msg=name)
        for a, b, s0 in zip(new.params, ref_new.params, state.params):
            lr_scale = float((b - s0).abs().max()) or 1.0
            torch.testing.assert_close(a - s0, b - s0, rtol=0, atol=0.02 * lr_scale)
        assert int(fwd.num_pairs.numel()) == groups
        assert int(m.num_pairs) < int(ref_m.num_pairs)
        staged = int(fwd.num_pairs.sum())
        assert staged == int(ref_m.num_pairs)
        assert int(m.pairs_recomputed) == staged
        assert int(m.pairs_staged) == 2 * staged


def test_grouped_backward_recomputes_each_group_under_its_spans(monkeypatch):
    """Each group's forward under ``step.group``, its render again under
    ``group.recompute`` in the backward, and the step's counters."""
    opened, real = [], tstep.span
    monkeypatch.setattr(tstep, "span", lambda name: (opened.append(name), real(name))[1])
    state, st, gt, cam, proj, draws = _problem()
    before = profiling.counters()
    tstep.train_step(state, gt, cam, proj, dataclasses.replace(st, subframe_groups=3),
                     draws=draws)
    assert opened.count("step.group") == 3 and opened.count("group.recompute") == 3
    assert {"step.group", "group.recompute"} <= set(profiling.SPANS)
    after = profiling.counters()
    grew = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert grew["step.calls"] == 1 and grew["step.subframe_groups"] == 3


@pytest.mark.parametrize("per_view,ceiling,want", [
    (2_630_000, 1 << 27, (1 << 27, 1)),      # train-field1080: 2.63M × 21 × 1.5 = 83M
    (11_500_000, 1 << 27, (1 << 27, 3)),     # 11.5M × 7 × 1.5 = 121M
    (11_500_000, 1 << 40, (1 << 29, 1)),     # far ceiling: the whole 21-view budget
    (60_000_000, 1 << 27, (1 << 27, 21)),    # one view alone fills the ceiling
    (100_000_000, 1 << 27, (1 << 28, 21)),   # nothing fits: one sub-frame a group
    (10, 1 << 27, (1 << 16, 1)),             # the 2^16 floor
])
def test_plan_groups(per_view, ceiling, want):
    assert tloop.plan_groups(per_view, 21, 1, ceiling) == want


def test_plan_groups_counts_the_cameras():
    assert tloop.plan_groups(2_630_000, 21, 2) == (1 << 27, 2)
    assert tloop.plan_groups(2_630_000, 21, 2, 1 << 40) == (1 << 28, 1)


# ---------------------------------------------------------------------------
# a trained scene through its PLY, and the grouped step against the
# benchmark's plain reference of the trained-scene configuration
# ---------------------------------------------------------------------------

LATE = 80_000


def _late_trainer(tmp_path, seed=11):
    """The configuration ``deblurgs-field1080-late`` at 48×32, F = 5, a
    1,000-row synthesised trained scene written as a run's PLY and loaded
    by ``Trainer.init_state(load_path=...)``; 2^14 slots a staging."""
    cfg = copy.deepcopy(harness.config("deblurgs-field1080-late"))
    cfg["scene"].update(width=48, height=32, points=300, gaussians=1000, views=6, llffhold=3,
                        cloud_sigma=1.0)
    cfg["cli"].update(num_subframes=F, curve_order=3, tile=16, max_pairs=1 << 14)
    dev = torch.device("cpu")
    x = scene.make_inputs(cfg, seed, dev)
    cols = train_late.trained_columns(cfg, x, seed)
    train_late.write_ply(os.path.join(tmp_path, "point_cloud", f"iteration_{LATE}",
                                      "point_cloud.ply"), cols)
    scn = scene.program_scene(cfg, x, seed)
    feed = train_late.PairFeed(scn, tuple(x.gt.shape[1:]), seed, dev)
    gcfg, mcfg, ocfg, rcfg = train_loop.program_configs(cfg)
    trainer = tloop.Trainer(scene=scn, gcfg=gcfg, mcfg=mcfg, ocfg=ocfg, rcfg=rcfg,
                            tone_mapping=cfg["cli"]["tone_mapping_type"], model_path=None,
                            save_iterations=(), batched_render=True, device=dev,
                            seed=x.curve_seed, draws_fn=feed.draws, on_metrics=feed.metrics)
    feed.trainer = trainer
    state, _ = trainer.init_state(load_path=str(tmp_path))
    return cfg, x, cols, trainer, feed, state._replace(step=LATE)


def test_trained_scene_survives_its_ply(tmp_path):
    """The synthesised scene's columns, written as a PLY and loaded by the
    program, are the leaves the reference starts from, bit for bit; the
    slots are sized for the PLY's rows, not the scene's 300-point cloud."""
    cfg, _, cols, _, _, state = _late_trainer(tmp_path)
    want = late.leaves_from_columns(cols, cfg["cli"]["sh_degree"], "cpu")
    n = len(cols["x"])
    assert state.params.xyz.shape[0] == 2048
    assert torch.equal(state.aux.active, torch.arange(2048) < n)
    for k, v in want.items():
        got = getattr(state.params, k)[:n]
        assert got.shape == v.shape and torch.equal(got, v), k


def test_grouped_step_holds_the_blocked_reference(tmp_path):
    """One step of ``Trainer.train`` at 80,000 in two sub-frame groups
    against ``reference/late.py``'s step in blocks of three sub-frames:
    within ``limits.json``, as the cell's ``correct`` compares them."""
    cfg, x, cols, trainer, feed, state = _late_trainer(tmp_path)
    trainer.subframe_groups = 2
    before = {**state.params._asdict(), **state.motion._asdict()}
    state = trainer.train(state, LATE, LATE)
    mu = {**state.adam_g.mu._asdict(), **state.adam_m.mu._asdict()}
    after = {**state.params._asdict(), **state.motion._asdict()}
    _, staged, recomputed = feed.pairs[LATE]
    assert int(recomputed) > 0 and int(staged) == 2 * int(recomputed)
    active = state.aux.active.nonzero()[:, 0]
    prog = {"losses": [float(feed.losses[LATE])],
            "grad": check.norms({k: v / (1 - 0.9) for k, v in mu.items()}),
            "change": train_loop.grown_change(after, before, active,
                                              torch.zeros_like(state.aux.active)),
            "densify": None}
    ref = train_late.reference_readings(cfg, x, cols, LATE, feed.records, 1)
    correct, checks = check.verdict(check.compare(prog, ref), check.load_limits())
    assert correct, checks
