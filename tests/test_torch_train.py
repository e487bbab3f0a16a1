"""The port's training slice against the JAX package: Adam, schedules,
losses, densification, the train step over several steps (JAX's random
draws injected), its gating cases, and the checkpoint layout.

Scenes are small (64×48, 100 Gaussians in 128 slots, tile 16, F ≤ 3) and
made with numpy from a seed. JAX's train step runs its Pallas path in
interpret mode.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.core import camera as jcam
from deblurgs_tpu.models import densify as jdens
from deblurgs_tpu.models import gaussians as jgm
from deblurgs_tpu.models import motion as jmm
from deblurgs_tpu.ops import rasterize as jras
from deblurgs_tpu.train import checkpoint as jckpt
from deblurgs_tpu.train import losses as jloss
from deblurgs_tpu.train import optim as jopt
from deblurgs_tpu.train import schedules as jsch
from deblurgs_tpu.train import step as jstep
from deblurgs_tpu.train.config import OptimizationConfig as JOptimizationConfig
from deblurgs_tpu_torch.core import camera as tcam
from deblurgs_tpu_torch.core import sh as tsh
from deblurgs_tpu_torch.models import densify as tdens
from deblurgs_tpu_torch.models import gaussians as tgm
from deblurgs_tpu_torch.models import motion as tmm
from deblurgs_tpu_torch.ops import rasterize as tras
from deblurgs_tpu_torch.train import checkpoint as tckpt
from deblurgs_tpu_torch.train import losses as tloss
from deblurgs_tpu_torch.train import optim as topt
from deblurgs_tpu_torch.train import schedules as tsch
from deblurgs_tpu_torch.train import step as tstep
from deblurgs_tpu_torch.train.config import OptimizationConfig
from tests.torch_bridge import gaussian_leaves, make_camera, motion_leaves, np_of, projection

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

W, H, N_GAUSS, CAPACITY = 64, 48, 100, 128
RKW = dict(tile_w=16, tile_h=16, max_pairs=1 << 13, need_n_contrib=False, backend="pallas",
           layout="mixed", window=2)


def assert_close(got, want, atol, rtol=0.0, name=""):
    np.testing.assert_allclose(np_of(got).astype(np.float64), np_of(want).astype(np.float64),
                               atol=atol, rtol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# Adam, schedules, losses
# ---------------------------------------------------------------------------


def _leaves(rng, P=40):
    shapes = [(P, 3), (P, 1, 3), (P, 3, 3), (P, 3), (P, 4), (P, 1)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_adam_matches_jax():
    """Three updates with row masks, leaf gates (one leaf gated off in the
    second update) and scalar leaf masks, then a moment surgery."""
    rng = np.random.default_rng(0)
    p = _leaves(rng)
    jp, tp = jgm.GaussianParams(*map(jnp.asarray, p)), tgm.GaussianParams(*map(torch.tensor, p))
    js, ts = jopt.init(jp), topt.init(tp)
    lr = [1e-3, 2.5e-3, 1.25e-4, 5e-3, 1e-3, 5e-2]
    rows = rng.uniform(size=40) > 0.3
    for it, gate in enumerate([[True] * 6, [True] * 5 + [False], [True, False] * 3]):
        g = _leaves(rng)
        jmask = jgm.GaussianParams(jnp.asarray(rows), None, jnp.asarray(rows), True, False,
                                   jnp.asarray(rows))
        tmask = tgm.GaussianParams(torch.from_numpy(rows), None, torch.from_numpy(rows), True,
                                   False, torch.from_numpy(rows))
        jp, js = jopt.update(jp, jgm.GaussianParams(*map(jnp.asarray, g)), js,
                             jgm.GaussianParams(*map(jnp.float32, lr)), update_mask=jmask,
                             leaf_gate=jgm.GaussianParams(*gate))
        tp, ts = topt.update(tp, tgm.GaussianParams(*map(torch.tensor, g)), ts,
                             tgm.GaussianParams(*(torch.tensor(x, dtype=torch.float32)
                                                  for x in lr)),
                             update_mask=tmask, leaf_gate=tgm.GaussianParams(*gate))
    touched = rng.uniform(size=40) > 0.8
    js = jopt.zero_moment_rows(js, jgm.GaussianParams(*([jnp.asarray(touched)] * 6)))
    ts = topt.zero_moment_rows(ts, tgm.GaussianParams(*([torch.from_numpy(touched)] * 6)))
    for name, a, b in zip(jgm.GaussianParams._fields, tp, jp):
        assert_close(a, b, atol=1e-7, rtol=1e-6, name=name)
    for part in ("mu", "nu", "step"):
        for name, a, b in zip(jgm.GaussianParams._fields, getattr(ts, part), getattr(js, part)):
            assert_close(a, b, atol=1e-9, rtol=1e-6, name=f"{part}/{name}")


@pytest.mark.parametrize("step", [0, 1, 999, 1000, 5000, 29_999, 30_001, 90_000, 150_000,
                                  200_000])
def test_schedules_match_jax(step):
    cases = [
        ("expon", lambda m, s: m.expon_lr(s, 1.6e-4, 1.6e-6, max_steps=150_000)),
        ("expon_delay", lambda m, s: m.expon_lr(s, 4e-4, 2e-4, lr_delay_steps=500,
                                                max_steps=25_000)),
        ("expon_flat", lambda m, s: m.expon_lr(s, 1e-3, 1e-3)),
        ("expon_zero", lambda m, s: m.expon_lr(s, 0.0, 0.0)),
        ("warmup", lambda m, s: m.warmup_exp_decay(s, 1e-2, 1e-7, 30_000, 150_000)),
        ("warmup_off", lambda m, s: m.warmup_exp_decay(s, 0.0, 1e-7, 30_000, 150_000)),
        ("curve", lambda m, s: m.curve_half_life_lr(s, 1e-2, 1000, 15_000)),
    ]
    for name, f in cases:
        assert_close(f(tsch, step), f(jsch, jnp.int32(step)), atol=0, rtol=1e-6, name=name)


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (3, 20, 24, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    x = (2 * rng.standard_normal(50)).astype(np.float32)
    ta, tb, tx = map(torch.from_numpy, (a, b, x))
    ja, jb, jx = map(jnp.asarray, (a, b, x))
    pairs = [
        ("l1", tloss.l1_loss(ta, tb), jloss.l1_loss(ja, jb)),
        ("l2", tloss.l2_loss(ta, tb), jloss.l2_loss(ja, jb)),
        ("ssim", tloss.ssim(ta[0], tb[0]), jloss.ssim(ja[0], jb[0])),
        ("tv", tloss.tv_loss(ta[..., 0]), jloss.tv_loss(ja[..., 0])),
        ("smooth", tloss.batchwise_smoothness_loss(ta), jloss.batchwise_smoothness_loss(ja)),
        ("smooth1", tloss.batchwise_smoothness_loss(ta[:1]),
         jloss.batchwise_smoothness_loss(ja[:1])),
        ("hinge", tloss.hinge_l2(tx), jloss.hinge_l2(jx)),
        ("psnr", tloss.psnr(ta, tb), jloss.psnr(ja, jb)),
    ]
    for name, got, want in pairs:
        assert_close(got, want, atol=1e-7, rtol=1e-5, name=name)


# ---------------------------------------------------------------------------
# the scene and the train step on both packages
# ---------------------------------------------------------------------------


def _scene(seed=40):
    """Raw leaves of 100 Gaussians in 128 slots (the rest inactive), two
    images' curves, the cameras' projection and two ground-truth images."""
    leaves = gaussian_leaves(seed, n=N_GAUSS, sh_deg=1, spread=1.2)
    pad = {"params/xyz": 0.0, "params/f_dc": 0.0, "params/f_rest": 0.0,
           "params/scaling": math.log(0.01), "params/rotation": 0.0, "params/opacity": 0.1}
    for key, fill in pad.items():
        x = leaves[key]
        extra = np.full((CAPACITY - N_GAUSS,) + x.shape[1:], fill, np.float32)
        if key == "params/rotation":
            extra[:, 0] = 1.0
        leaves[key] = np.concatenate([x, extra])
    leaves["aux/active"] = np.arange(CAPACITY) < N_GAUSS
    leaves.update(motion_leaves(n_images=2, order=3, n_subframes=3, seed=seed))
    cam = make_camera(W, H)
    proj = projection(0.01, 100.0, 1.1, 2 * math.atan(math.tan(0.55) * H / W))
    gts = np.random.default_rng(seed).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    return leaves, cam.static, proj, gts


def _states(leaves, key):
    P = CAPACITY
    zeros = np.zeros(P, np.float32)
    jp = jgm.GaussianParams(*(jnp.asarray(leaves[f"params/{k}"]) for k in jgm.GaussianParams._fields))
    jm = jmm.MotionParams(*(jnp.asarray(leaves[f"motion/{k}"]) for k in jmm.MotionParams._fields))
    ja = jgm.GaussianAux(jnp.asarray(leaves["aux/active"]), *(jnp.asarray(zeros),) * 3)
    tp = tgm.GaussianParams(*(torch.tensor(leaves[f"params/{k}"]) for k in tgm.GaussianParams._fields))
    tm = tmm.MotionParams(*(torch.tensor(leaves[f"motion/{k}"]) for k in tmm.MotionParams._fields))
    ta = tgm.GaussianAux(torch.from_numpy(leaves["aux/active"]),
                         *(torch.from_numpy(zeros.copy()) for _ in range(3)))
    jkey = jax.random.PRNGKey(key)
    return (jstep.init_state(jp, jm, ja, jkey),
            tstep.init_state(tp, tm, ta, rng=np.asarray(jkey)))


def _statics(ocfg_kw, n_sub, cs, batched=True, B=1, random_sample=False, white=False):
    common = dict(sh_degree=1, n_sub=n_sub, tone_mapping="identity", spatial_lr_scale=2.0,
                  random_sample=random_sample, white_background=white, batched_render=batched,
                  cams_per_step=B)
    js = jstep.TrainStatics(
        gcfg=jgm.GaussianConfig(sh_degree=1),
        mcfg=jmm.MotionConfig(curve_order=3, n_subframes=3, curve_random_sample=random_sample),
        ocfg=JOptimizationConfig(**ocfg_kw), rcfg=jras.RasterizeConfig(interpret=True, **RKW),
        cs=jcam.CameraStatic(**cs), **common)
    ts = tstep.TrainStatics(
        gcfg=tgm.GaussianConfig(sh_degree=1),
        mcfg=tmm.MotionConfig(curve_order=3, n_subframes=3, curve_random_sample=random_sample),
        ocfg=OptimizationConfig(**ocfg_kw), rcfg=tras.RasterizeConfig(**RKW),
        cs=tcam.CameraStatic(**cs), **common)
    return js, ts


def _jax_draws(jstate, st, B):
    """The draws JAX's train_step makes from ``jstate.rng``
    (``train/step.py:136-165``, ``models/densify.py:108-111``)."""
    _, k_nu, k_bg, k_noise, k_densify = jax.random.split(jstate.rng, 5)
    f = st.mcfg.n_subframes
    nu_u = np.stack([np.asarray(jax.random.uniform(k, (f - 2,)))
                     for k in jax.random.split(k_nu, B)])
    k1, k2 = jax.random.split(k_densify)
    P = jstate.params.xyz.shape[0]
    t = lambda x: torch.from_numpy(np.array(x))   # noqa: E731
    return tstep.StepDraws(
        bg=t(jax.random.uniform(k_bg, (3,))), nu_u=t(nu_u),
        noise=t(jax.random.normal(k_noise, (B, H, W, 3))),
        split=(t(jax.random.normal(k1, (P, 3))), t(jax.random.normal(k2, (P, 3)))))


# the events of the N-step run: step 1 before the curve starts, step 3
# densifies, step 4 resets opacity, step 5 is the final one
EVENTS = dict(iterations=5, curve_start_iter=2, curve_end_iter=100, densify_from_iter=1,
              densification_interval=3, densify_until_iter=100, opacity_reset_interval=4,
              densify_grad_threshold_init=2e-5, densify_grad_threshold_final=1e-5,
              densify_annealing_until=100, noise_init=0.02, noise_final=0.002,
              curve_alignment_lr=1e-2, curve_alignment_start=1, position_lr_init=1.6e-3,
              position_lr_final=1.6e-5)


def _run_both(ocfg_kw, n_sub, n_steps, batched=True, B=1, random_sample=True, white=False,
              seed=40):
    leaves, cs, proj, gts = _scene(seed)
    js, ts = _statics(ocfg_kw, n_sub, cs, batched, B, random_sample, white)
    jstate, tstate = _states(leaves, seed)
    fn = jstep.make_train_step(js)
    history = []
    for it in range(n_steps):
        idx = [it % 2, (it + 1) % 2][:B]
        gt = gts[idx] if B > 1 else gts[idx[0]]
        draws = _jax_draws(jstate, js, B)
        jidx = jnp.asarray(idx, jnp.int32) if B > 1 else jnp.int32(idx[0])
        jstate, jmet = fn(jstate, jnp.asarray(gt), jidx, jnp.asarray(proj))
        tstate, tmet = tstep.train_step(tstate, torch.from_numpy(gt), idx if B > 1 else idx[0],
                                        torch.from_numpy(proj), ts, draws=draws)
        history.append((jmet, tmet))
    return jstate, tstate, history


def _assert_states_close(jstate, tstate, atol):
    """Every leaf of the two states, each scaled by the JAX leaf's max."""
    flat_t = tckpt.state_to_arrays(tstate)
    for key, want in jckpt._flatten(jstate).items():
        if key == "rng":
            continue
        got = flat_t[key]
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if want.dtype == bool or want.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(got / scale, want / scale, atol=atol, err_msg=key)


@pytest.mark.parametrize("n_sub,batched", [(1, False), (3, True)], ids=["sharp_loop", "blur_batched"])
def test_train_steps_match_jax(n_sub, batched):
    """Five steps with JAX's draws injected: the curve phase gate, a
    densify step (clone/split with the injected samples, prune, moment
    surgery), an opacity reset and the final step; GT noise and sub-frame
    jitter on. Metrics and every state leaf agree."""
    jstate, tstate, history = _run_both(EVENTS, n_sub, 5, batched=batched)
    for jmet, tmet in history:
        for name in ("loss", "l1", "t_smooth", "hinge", "psnr"):
            assert_close(getattr(tmet, name), getattr(jmet, name), atol=1e-6, rtol=1e-4,
                         name=name)
        for name in ("num_active", "num_pairs", "max_per_tile", "overflowed",
                     "overflow_count"):
            assert int(getattr(tmet, name)) == int(getattr(jmet, name)), name
        for a, b in zip(tmet.densify, jmet.densify):
            assert int(a) == int(b)
    assert int(history[2][1].densify.n_cloned) + int(history[2][1].densify.n_split) > 0
    assert tstate.step == int(jstate.step) == 6
    _assert_states_close(jstate, tstate, atol=2e-4)


def test_cams_per_step_two_matches_jax():
    jstate, tstate, history = _run_both(dict(EVENTS, densify_from_iter=100), 3, 2, B=2)
    for jmet, tmet in history:
        assert_close(tmet.loss, jmet.loss, atol=1e-6, rtol=1e-4, name="loss")
    _assert_states_close(jstate, tstate, atol=2e-4)


# ---------------------------------------------------------------------------
# gating cases (tests/test_train.py:138-400), on the port
# ---------------------------------------------------------------------------


def _port_step(ocfg_kw, n_sub=3, step=None, white=False, n_steps=1, seed=41):
    leaves, cs, proj, gts = _scene(seed)
    _, ts = _statics(ocfg_kw, n_sub, cs, white=white)
    _, state = _states(leaves, seed)
    if step is not None:
        state = state._replace(step=step)
    start = state
    gen = torch.Generator().manual_seed(seed)
    for it in range(n_steps):
        state, metrics = tstep.train_step(state, torch.from_numpy(gts[it % 2]), it % 2,
                                          torch.from_numpy(proj), ts, generator=gen)
    return ts, start, state, metrics


QUIET = dict(densify_from_iter=10_000, opacity_reset_interval=100_000)


def _equal(a_tuple, b_tuple):
    return all(torch.equal(a, b) for a, b in zip(a_tuple, b_tuple))


def test_alignment_receives_gradients():
    _, start, state, metrics = _port_step(dict(QUIET, iterations=1000, curve_start_iter=1,
                                               curve_alignment_lr=1e-2,
                                               curve_alignment_start=1), n_steps=3)
    assert math.isfinite(float(metrics.loss))
    assert float(state.adam_m.mu.nu.abs().max()) > 0, "nu got no gradient"
    assert float((state.motion.nu - start.motion.nu).abs().max()) > 0


@pytest.mark.parametrize("window", [dict(curve_start_iter=1000), dict(curve_start_iter=1,
                                                                      curve_end_iter=1)],
                         ids=["before_start", "after_end"])
def test_curve_frozen_outside_its_window(window):
    _, start, state, _ = _port_step(dict(QUIET, **window), n_steps=2)
    assert _equal(state.motion, start.motion)
    assert float((state.params.xyz - start.params.xyz).abs().max()) > 0


def test_densify_step_skips_gaussian_adam():
    _, start, state, _ = _port_step(dict(
        iterations=10_000, curve_start_iter=1, densify_from_iter=10, densification_interval=100,
        densify_until_iter=9_000, opacity_reset_interval=100_000,
        densify_grad_threshold_init=1e9, densify_grad_threshold_final=1e9), step=200)
    assert _equal(state.params, start.params)
    assert _equal(state.adam_g.step, start.adam_g.step)
    assert float((state.motion.trans_ctrl - start.motion.trans_ctrl).abs().max()) > 0
    assert float(state.aux.denom.abs().max()) == 0.0     # the stats restart


def test_reset_step_skips_opacity_adam():
    ts, start, state, _ = _port_step(dict(
        iterations=10_000, curve_start_iter=10_000, densify_from_iter=10_000,
        densification_interval=97, densify_until_iter=9_000, opacity_reset_interval=300),
        n_sub=1, step=300)
    expect, _ = tdens.reset_opacity(start.params, start.adam_g, ts.gcfg)
    assert torch.equal(state.params.opacity, expect.opacity)
    assert float(state.adam_g.mu.opacity.abs().max()) == 0.0
    assert int(state.adam_g.step.opacity) == int(start.adam_g.step.opacity)
    assert int(state.adam_g.step.xyz) == int(start.adam_g.step.xyz) + 1


def test_final_step_skips_optimizer():
    _, start, state, _ = _port_step(dict(QUIET, iterations=500, curve_start_iter=1), step=500)
    assert _equal(state.params, start.params) and _equal(state.motion, start.motion)
    assert state.step == 501


def test_white_background_extra_reset():
    ts, start, state, _ = _port_step(dict(
        iterations=10_000, curve_start_iter=10_000, densify_from_iter=500,
        densification_interval=97, densify_until_iter=9_000, opacity_reset_interval=100_000),
        n_sub=1, step=500, white=True)
    expect, _ = tdens.reset_opacity(start.params, start.adam_g, ts.gcfg)
    assert torch.equal(state.params.opacity, expect.opacity)


def test_mesh_is_not_ported():
    leaves, cs, proj, gts = _scene()
    _, ts = _statics(QUIET, 3, cs)
    _, state = _states(leaves, 0)
    with pytest.raises(NotImplementedError):
        tstep.train_step(state, torch.from_numpy(gts[0]), 0, torch.from_numpy(proj),
                         ts.__class__(**{**ts.__dict__, "mesh": object()}))


# ---------------------------------------------------------------------------
# densification alone, and the checkpoint
# ---------------------------------------------------------------------------


def test_densify_and_prune_matches_jax():
    """Clone, split and prune on the same state, with the split samples
    that JAX draws from its key injected: the same surviving set, slots,
    parameters and moments."""
    leaves, _, _, _ = _scene(42)
    jstate, tstate = _states(leaves, 42)
    rng = np.random.default_rng(42)
    accum = rng.uniform(0, 2e-3, CAPACITY).astype(np.float32)
    denom = rng.integers(0, 4, CAPACITY).astype(np.float32)
    opac = leaves["params/opacity"].copy()
    opac[:6] = 0.001                       # below the prune threshold
    moments = rng.standard_normal((CAPACITY, 3)).astype(np.float32)
    jaux = jstate.aux._replace(xyz_grad_accum=jnp.asarray(accum), denom=jnp.asarray(denom))
    taux = tstate.aux._replace(xyz_grad_accum=torch.from_numpy(accum),
                               denom=torch.from_numpy(denom))
    jp = jstate.params._replace(opacity=jnp.asarray(opac))
    tp = tstate.params._replace(opacity=torch.from_numpy(opac))
    jad = jstate.adam_g._replace(mu=jstate.adam_g.mu._replace(xyz=jnp.asarray(moments)))
    tad = tstate.adam_g._replace(mu=tstate.adam_g.mu._replace(xyz=torch.from_numpy(moments)))
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    normals = tuple(torch.from_numpy(np.array(jax.random.normal(k, (CAPACITY, 3))))
                    for k in (k1, k2))
    kw = dict(grad_threshold=3e-4, scene_extent=10.0, percent_dense=0.01)
    jout = jdens.densify_and_prune(jp, jaux, jad, key, cfg=jgm.GaussianConfig(sh_degree=1), **kw)
    tout = tdens.densify_and_prune(tp, taux, tad, normals, cfg=tgm.GaussianConfig(sh_degree=1),
                                   **kw)
    report = [int(x) for x in tout[3]]
    assert report == [int(x) for x in jout[3]]
    assert min(report) > 0, report   # clones, splits, prunes and drops all happen
    for a, b in zip(tout[0], jout[0]):
        assert_close(a, b, atol=1e-6, rtol=1e-6)
    for a, b in zip(tout[1], jout[1]):
        np.testing.assert_array_equal(np_of(a), np_of(b))
    for a, b in zip(tout[2].mu + tout[2].nu, jout[2].mu + jout[2].nu):
        np.testing.assert_array_equal(np_of(a), np_of(b))


def test_gaussian_helpers_match_jax():
    """create_from_pcd (exact 3-NN scales, RGB→SH), the opacity reset and
    decay, light_prune, the SH-degree step, sh_to_rgb and update_stats."""
    rng = np.random.default_rng(7)
    pts = (rng.standard_normal((90, 3)) * 1.5).astype(np.float32)
    cols = rng.uniform(0, 1, (90, 3)).astype(np.float32)
    for cfg_kw in (dict(sh_degree=2), dict(sh_degree=1, use_sigmoid=True, scale_lb=0.001,
                                           alpha_lower_bound=0.05)):
        jcfg, tcfg = jgm.GaussianConfig(**cfg_kw), tgm.GaussianConfig(**cfg_kw)
        jp, ja = jgm.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols), jcfg, capacity=128)
        tp, ta = tgm.create_from_pcd(torch.from_numpy(pts), torch.from_numpy(cols), tcfg,
                                     capacity=128)
        for name, a, b in zip(jgm.GaussianParams._fields, tp, jp):
            assert_close(a, b, atol=1e-6, rtol=1e-5, name=name)
        for a, b in zip(ta, ja):
            np.testing.assert_array_equal(np_of(a), np_of(b))
        pairs = [(tgm.reset_opacity(tp, tcfg).opacity, jgm.reset_opacity(jp, jcfg).opacity),
                 (tgm.decay_opacity(tp, tcfg, 0.7).opacity,
                  jgm.decay_opacity(jp, jcfg, 0.7).opacity),
                 (tgm.get_scaling(tp, tcfg), jgm.get_scaling(jp, jcfg))]
        for a, b in pairs:
            assert_close(a, b, atol=1e-7, rtol=1e-6)
        assert tgm.one_up_sh_degree(1, tcfg) == jgm.one_up_sh_degree(1, jcfg)
        assert tgm.one_up_sh_degree(cfg_kw["sh_degree"], tcfg) == cfg_kw["sh_degree"]
    keep = rng.uniform(size=128) > 0.4
    np.testing.assert_array_equal(
        np_of(tgm.light_prune(ta, torch.from_numpy(keep)).active),
        np_of(jgm.light_prune(ja, jnp.asarray(keep)).active))
    assert_close(tsh.sh_to_rgb(tsh.rgb_to_sh(torch.from_numpy(cols))), cols, atol=1e-6)
    vsp = rng.standard_normal((128, 2)).astype(np.float32)
    radii = rng.integers(0, 3, 128).astype(np.int32)
    got = tdens.update_stats(ta, torch.from_numpy(vsp), torch.from_numpy(radii), 1 / 3)
    want = jdens.update_stats(ja, jnp.asarray(vsp), jnp.asarray(radii), 1 / 3)
    for a, b in zip(got[1:], want[1:]):
        assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_checkpoint_roundtrip_through_jax_layout(tmp_path):
    """The whole state (params, motion, aux, both Adam states with their
    step counts, step, rng, overflow_count) goes port → npz → JAX → npz →
    port unchanged, with the JAX package's keys and dtypes."""
    _, _, tstate, _ = _port_step(dict(QUIET, curve_start_iter=1))
    tstate = tstate._replace(overflow_count=torch.tensor(3, dtype=torch.int32))
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, tstate)
    jtemplate = _states(_scene()[0], 0)[0]
    jstate = jckpt.load_checkpoint(path, jtemplate)
    path2 = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path2, jstate)
    with np.load(os.path.join(REPO, "runs", "r5_jointb_state.npz")) as d:
        assert sorted(d.files) == sorted(np.load(path2).files)
    back = tckpt.load_checkpoint(path2, device="cpu")
    a, b = tckpt.state_to_arrays(tstate), tckpt.state_to_arrays(back)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a[key].dtype == b[key].dtype, key
    assert back.step == 2 and int(back.overflow_count) == 3
    assert int(back.adam_g.step.xyz) == 1 and float(back.adam_g.mu.xyz.abs().max()) > 0
