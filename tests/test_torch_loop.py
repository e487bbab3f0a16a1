"""The port's host training loop (``train/loop.py``) against the JAX
package's: phase statics, capacity growth, the EMA log, the pair-budget
autosize, ten iterations of ``Trainer.train`` with JAX's random draws
injected (a phase switch, a pre-grow, a densify event, two drains) from a
state moved off the init's ties and from the raw init, the debug NaN guard, a checkpoint resume and the port's motion-recovery script.

The dataset is ``tests/test_data.py``'s synthetic COLMAP scene (3 cameras,
64×48, 40 points). JAX's train step runs its Pallas path in interpret mode.
"""

import contextlib
import io
import os
from argparse import ArgumentParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.cli import args as jargs
from deblurgs_tpu.cli import train as jcli
from deblurgs_tpu.data.scene import Scene as JScene
from deblurgs_tpu.train import checkpoint as jckpt
from deblurgs_tpu.train import loop as jloop
from deblurgs_tpu_torch.cli import args as targs
from deblurgs_tpu_torch.cli import train as tcli
from deblurgs_tpu_torch.data.scene import Scene as TScene
from deblurgs_tpu_torch.train import checkpoint as tckpt
from deblurgs_tpu_torch.train import loop as tloop
from deblurgs_tpu_torch.train import step as tstep
from tests.test_data import write_colmap_binary, write_images
from tests.test_torch_train import _assert_states_close, _scene, _states, assert_close

torch.set_num_threads(1)

W, H, N_CAMS = 64, 48, 3   # the COLMAP camera's size (images load at it)


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loop") / "scene")
    write_colmap_binary(os.path.join(root, "sparse", "0"), n_cams=N_CAMS, n_pts=40)
    write_images(os.path.join(root, "images"), [f"{i:03d}.png" for i in range(N_CAMS)],
                 w=W, h=H)
    return root


def _configs(flags):
    """(JAX configs, port configs) from the same training-CLI flags."""
    out = []
    for args_mod, cli in ((jargs, jcli), (targs, tcli)):
        parser = ArgumentParser()
        lp, op = args_mod.ModelParams(parser), args_mod.OptimizationParams(parser)
        ns = parser.parse_args(["-s", "scene", "-m", "model"] + flags)
        out.append(cli.build_configs(lp.extract(ns), op.extract(ns)))
    return out


def _trainers(source, flags, jax_kw=None, port_kw=None, **kw):
    (jg, jm, jo, jr), (tg, tm, to, tr) = _configs(flags)
    jt = jloop.Trainer(scene=JScene(source, None, resolution=1), gcfg=jg, mcfg=jm, ocfg=jo,
                       rcfg=jr, tone_mapping="identity", **kw, **(jax_kw or {}))
    tt = tloop.Trainer(scene=TScene(source, None, resolution=1), gcfg=tg, mcfg=tm, ocfg=to,
                       rcfg=tr, tone_mapping="identity", device="cpu", **kw,
                       **(port_kw or {}))
    return jt, tt


def test_phase_statics_match_jax(source):
    jt, tt = _trainers(source, ["--curve_start_iter", "300", "--curve_random_sample",
                                "--random_sample_until", "2500", "--num_subframes", "3",
                                "--curve_order", "2"])
    for it in (1, 299, 300, 999, 1000, 1999, 2000, 2499, 2500, 3000, 10_000):
        assert tt.phase_statics(it) == jt.phase_statics(it), it


def test_grow_capacity_matches_jax():
    """Every leaf bitwise: the pads, the identity rotation of the new slots,
    both Adam moments (filled here) and the carried step counts."""
    jstate, _ = _states(_scene(42)[0], 42)
    rng = np.random.default_rng(3)

    def fill(x):
        return jnp.asarray(rng.standard_normal(x.shape), x.dtype)

    jstate = jstate._replace(adam_g=jstate.adam_g._replace(
        mu=jax.tree.map(fill, jstate.adam_g.mu), nu=jax.tree.map(fill, jstate.adam_g.nu),
        step=jax.tree.map(lambda s: s + 7, jstate.adam_g.step)))
    tstate = tckpt.state_from_arrays(jckpt._flatten(jstate), device="cpu")
    want = jckpt._flatten(jloop.grow_capacity(jstate, 256))
    got = tckpt.state_to_arrays(tloop.grow_capacity(tstate, 256))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert (got["params/rotation"][128:] == [1, 0, 0, 0]).all()
    assert not got["aux/active"][128:].any() and got["aux/active"][:100].all()


def test_ema_logger_prints_jax_lines():
    lines = {"jax": [], "port": []}
    loggers = {"jax": jloop.EmaLogger(print_fn=lines["jax"].append),
               "port": tloop.EmaLogger(print_fn=lines["port"].append)}
    rng = np.random.default_rng(0)
    for step in range(1, 5):
        metrics = {"l1": float(rng.uniform()), "psnr": 20 + float(rng.uniform()),
                   "#pts": int(rng.integers(10, 100))}
        for logger in loggers.values():
            logger.update(metrics)
            logger.show(step)
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 4


def test_autosize_max_pairs_matches_jax(source):
    """The same worst-view probe count and power-of-two budget as JAX's
    XLA probe: 21 sub-frames batched, two cameras a step, tile 4."""
    jt, tt = _trainers(source, ["--num_subframes", "21", "--curve_order", "2", "--tile", "4",
                                "--cams_per_step", "2"], batched_render=True, cams_per_step=2)
    jstate, _ = jt.init_state(key=jax.random.PRNGKey(0))
    tstate = tckpt.state_from_arrays(jckpt._flatten(jstate), device="cpu")
    printed = {}
    for name, trainer, state in (("jax", jt, jstate), ("port", tt, tstate)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            printed[name] = (trainer.autosize_max_pairs(state), buf.getvalue())
    assert printed["port"] == printed["jax"]
    assert printed["port"][0] > 1 << 16, printed


def _jax_draw_chain(key, n: int):
    """The ``state.rng`` of each of ``n`` JAX train steps from the first
    (each step carries the first of its five splits)."""
    keys = [key]
    for _ in range(n - 1):
        keys.append(jax.random.split(keys[-1], 5)[0])
    return keys


def _jax_draws(key, state, n_sub: int):
    """The draws JAX's train step makes from ``key`` (B = 1), for the
    port's state of the same iteration."""
    _, k_nu, k_bg, k_noise, k_densify = jax.random.split(key, 5)
    k1, k2 = jax.random.split(k_densify)
    P = state.params.xyz.shape[0]
    t = lambda x: torch.from_numpy(np.array(x))   # noqa: E731
    return tstep.StepDraws(
        bg=t(jax.random.uniform(k_bg, (3,))),
        nu_u=t(jax.random.uniform(jax.random.split(k_nu, 1)[0], (n_sub - 2,)))[None],
        noise=t(jax.random.normal(k_noise, (1, H, W, 3))),
        split=(t(jax.random.normal(k1, (P, 3))), t(jax.random.normal(k2, (P, 3)))))


LOOP_FLAGS = ["--num_subframes", "3", "--curve_order", "2", "--tile", "16",
              "--max_pairs", str(1 << 13), "--iterations", "10", "--curve_start_iter", "6",
              "--densify_from_iter", "6", "--densification_interval", "4",
              "--densify_until_iter", "10", "--opacity_reset_interval", "1000",
              "--densify_grad_threshold_init", "2e-5", "--densify_grad_threshold_final",
              "1e-5", "--densify_annealing_until", "100", "--noise_init", "0.02",
              "--noise_final", "0.002", "--curve_random_sample", "--curve_alignment_lr",
              "1e-2", "--curve_alignment_start", "1"]


def _generic(state, seed=6):
    """The point-cloud init moved off three near-degenerate spots where JAX
    and the port part at the float32 floor: random rotations and per-axis
    scales for its isotropic, unrotated Gaussians, whose rotation gradient
    is zero in exact arithmetic (each package returns float noise or an
    exact zero, on different rows, and Adam's eps of 1e-15 turns noise into
    a full learning-rate step); DC colours off the colour clamp, where a
    black point sits (test_colour_clamp_gradient_follows_the_reference);
    and curves spread from their near-single-point init, along which the
    alignment logits' gradient is ~1e-6 (three orders below the curves'),
    where the port's batched and per-view renders of one step already
    differ by 1.2e-4 relative."""
    rng = np.random.default_rng(seed)
    p, m = state.params, state.motion
    q = rng.standard_normal(p.rotation.shape)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    noise = lambda x, s: x + jnp.asarray(rng.normal(0, s, x.shape), jnp.float32)  # noqa: E731
    return state._replace(
        params=p._replace(rotation=jnp.asarray(q, jnp.float32), scaling=noise(p.scaling, 0.3),
                          f_dc=noise(p.f_dc, 0.05)),
        motion=m._replace(rot_ctrl=noise(m.rot_ctrl, 0.02), trans_ctrl=noise(m.trans_ctrl, 0.1)))


def test_colour_clamp_gradient_follows_the_reference():
    """A point-cloud colour channel of 0 puts its DC coefficient on the
    colour clamp max(rgb + 0.5, 0). The reference's backward passes the
    gradient unless rgb + 0.5 < 0 (``backward.cu``: ``clamped = result <
    0``); the port does the same, where JAX's ``jnp.maximum`` halves it."""
    from deblurgs_tpu.core import sh as jsh
    from deblurgs_tpu_torch.core import sh as tsh

    c0 = np.float32(0.28209479177387814)
    dc = np.array([-1.7724538, -1.7724539], np.float32)    # rgb + 0.5 = 0 and < 0
    shs = np.zeros((2, 9, 3), np.float32)
    shs[:, 0, 0] = dc
    means, campos = np.zeros((2, 3), np.float32), np.array([0, 0, -5], np.float32)
    assert (c0 * dc + np.float32(0.5)).tolist() == [0.0, np.float32(-5.9604645e-08)]
    t = torch.tensor(shs, requires_grad=True)
    tsh.sh_to_color(t, torch.tensor(means), torch.tensor(campos), 0)[:, 0].sum().backward()
    assert t.grad[:, 0, 0].tolist() == [c0, 0.0]
    jgrad = jax.grad(lambda s: jsh.sh_to_color(s, jnp.asarray(means), jnp.asarray(campos),
                                               0)[:, 0].sum())(jnp.asarray(shs))
    assert np.asarray(jgrad)[:, 0, 0].tolist() == [c0 / 2, 0.0]


def _run_loops(source, init):
    """Ten iterations of JAX's and the port's ``Trainer.train`` from the
    same state (``init`` of JAX's initial one), JAX's draws injected; checks
    the drains, the metrics and integer counts. Returns the final states."""
    seen = {"jax": [], "port": []}
    keys = {}
    jt, tt = _trainers(
        source, LOOP_FLAGS, batched_render=True, sync_every=5,
        jax_kw=dict(on_metrics=lambda it, m: seen["jax"].append((it, m))),
        port_kw=dict(on_metrics=lambda it, m: seen["port"].append((it, m)),
                     draws_fn=lambda it, st: _jax_draws(keys[it], st, 3)))
    jstate, first = jt.init_state(key=jax.random.PRNGKey(5), capacity=41)
    jstate = init(jstate)
    tstate = tckpt.state_from_arrays(jckpt._flatten(jstate), device="cpu")
    keys.update(zip(range(1, 11), _jax_draw_chain(jstate.rng, 10)))
    drains = []
    real_drain = tt._drain
    tt._drain = lambda st, rcfg: (drains.append(st.step - 1), real_drain(st, rcfg))[1]
    jstate = jt.train(jstate, first)
    tstate = tt.train(tstate, first)

    assert drains == [5, 10]
    assert [it for it, _ in seen["port"]] == [it for it, _ in seen["jax"]] == list(range(1, 11))
    for (it, jm), (_, tm) in zip(seen["jax"], seen["port"]):
        for name in ("loss", "l1", "t_smooth", "hinge", "psnr"):
            assert_close(getattr(tm, name), getattr(jm, name), atol=1e-6, rtol=1e-4,
                         name=f"it {it} {name}")
        for name in ("num_active", "num_pairs", "max_per_tile", "overflowed",
                     "overflow_count"):
            assert int(getattr(tm, name)) == int(getattr(jm, name)), (it, name)
        assert [int(x) for x in tm.densify] == [int(x) for x in jm.densify], it
    densified = seen["port"][7][1].densify
    assert int(densified.n_cloned) + int(densified.n_split) > 0
    assert tstate.params.xyz.shape[0] == jstate.params.xyz.shape[0] >= 82
    assert tstate.step == int(jstate.step) == 11
    return jstate, tstate


def test_train_loop_matches_jax(source):
    """Ten iterations of ``Trainer.train`` from one state (40 Gaussians in
    41 slots, moved off the init's ties: ``_generic``): sharp warm-up to iteration
    5, the drain at 5 pre-grows the
    capacity to 82, the blur phase from 6 with sub-frame jitter and GT
    noise, a densify event at 8, the drain at 10. JAX's draws reach the port
    through ``draws_fn``. Metrics, integer counts and every state leaf agree
    (the tolerances of tests/test_torch_train.py)."""
    jstate, tstate = _run_loops(source, _generic)
    _assert_states_close(jstate, tstate, atol=2e-4)


# The leaves the raw init's ties reach (``_generic``'s docstring), each held
# at about twice the largest scaled difference measured from it (JAX's CPU
# backend with one Eigen thread and with several): the colour clamp
# (f_dc 5.8e-4 both ways), the near-point curves (the alignment logits'
# first moment 3.4e-4 both ways) and the isotropic, unrotated Gaussians
# (rotation 1.9e-3 / 5.7e-6, xyz 1.4e-3 / 1.4e-6, the xyz gradient
# accumulator 2.6e-4 / 4.2e-6, Adam's first moments of xyz 2.2e-4 / 6.7e-6
# and of scaling 4.6e-4 / 6.0e-6).
RAW_INIT_TIES = {"params/f_dc": 1.2e-3, "adam_m/mu/nu": 7e-4, "params/rotation": 4e-3,
                 "params/xyz": 3e-3, "aux/xyz_grad_accum": 6e-4, "adam_g/mu/xyz": 5e-4,
                 "adam_g/mu/scaling": 1e-3}


def test_train_loop_from_the_raw_init_matches_jax(source):
    """The same ten iterations from JAX's initial state as the CLI makes it
    (the point cloud's isotropic, unrotated Gaussians, its colours, the
    curves at the nominal poses). Metrics and integer counts agree as
    above; every leaf agrees at 2e-4 scaled but those the init's ties
    reach, each held at its measured reading (``RAW_INIT_TIES``)."""
    jstate, tstate = _run_loops(source, lambda state: state)
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
            np.testing.assert_allclose(got / scale, want / scale,
                                       atol=RAW_INIT_TIES.get(key, 2e-4), err_msg=key)


def test_debug_nan_guard_dumps_snapshot(source, tmp_path):
    """A non-finite loss under ``debug`` writes the state and the step's
    inputs, then raises (tests/test_loop.py::TestNaNGuard)."""
    (_, _, _, _), (g, m, o, r) = _configs(["--num_subframes", "3", "--curve_order", "2",
                                           "--max_pairs", str(1 << 12), "--iterations", "12",
                                           "--curve_start_iter", "4",
                                           "--densify_from_iter", "1000",
                                           "--opacity_reset_interval", "1000"])
    scene = TScene(source, str(tmp_path), resolution=1)
    scene.train_images[1] = np.nan
    trainer = tloop.Trainer(scene=scene, gcfg=g, mcfg=m, ocfg=o, rcfg=r,
                            tone_mapping="identity", model_path=str(tmp_path),
                            save_iterations=(), sync_every=2, debug=True, device="cpu")
    state, first = trainer.init_state()
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.train(state, first, iterations=12)
    snaps = sorted(f for f in os.listdir(tmp_path) if f.startswith("snapshot_nan"))
    assert len(snaps) == 2 and snaps[0].endswith(".npz") and snaps[1].endswith(".txt"), snaps
    assert tckpt.load_checkpoint(os.path.join(tmp_path, snaps[0]), device="cpu").step > 1


def test_checkpoint_resume_continues_from_its_step(source, tmp_path):
    """A checkpoint written after iteration 4 resumes at iteration 5 with
    the whole state (Adam moments, step counts, curves) it held."""
    (_, _, _, _), (g, m, o, r) = _configs(["--num_subframes", "3", "--curve_order", "2",
                                           "--max_pairs", str(1 << 12), "--iterations", "6",
                                           "--curve_start_iter", "3"])

    def trainer():
        return tloop.Trainer(scene=TScene(source, str(tmp_path), resolution=1), gcfg=g,
                             mcfg=m, ocfg=o, rcfg=r, model_path=str(tmp_path),
                             save_iterations=(), checkpoint_iterations=(4,), device="cpu")

    state, first = trainer().init_state()
    trainer().train(state, first, iterations=4)
    path = os.path.join(tmp_path, "chkpnt4.npz")
    saved = tckpt.load_checkpoint(path, device="cpu")
    resumed, first = trainer().init_state(start_checkpoint=path)
    assert first == resumed.step == saved.step == 5
    for key, value in tckpt.state_to_arrays(saved).items():
        np.testing.assert_array_equal(tckpt.state_to_arrays(resumed)[key], value, err_msg=key)
    final = trainer().train(resumed, first, iterations=6)
    assert final.step == 7
    assert int(final.adam_m.step.rot_ctrl) == int(saved.adam_m.step.rot_ctrl) + 1


def test_validate_blur_recovery_runs(tmp_path):
    """The port's motion-recovery check runs end to end at 32 px (a few
    iterations: it runs, it does not recover yet) and writes its report;
    so does its joint arm."""
    import json

    from deblurgs_tpu_torch.scripts import validate_blur_recovery as vbr

    report = str(tmp_path / "report.json")
    rc = vbr.main(["--freeze_scene", "--iters", "3", "--size", "32", "--n_cams", "2",
                   "--n_sub", "3", "--curve_start", "1", "--batched", "--layout", "mixed",
                   "--tile", "16", "--max_pairs", str(1 << 14), "--true_scale", "0.1",
                   "--device", "cpu", "--report", report])
    with open(report) as f:
        result = json.load(f)
    assert rc in (0, 1) and result["nan_at"] is None and result["overflow_steps"] == 0
    assert np.isfinite(result["traj_err"]) and np.isfinite(result["blur_floor_psnr"])
    # the joint arm at the same size: noisy points, curves from the nominal poses
    joint = str(tmp_path / "joint.json")
    rc = vbr.main(["--iters", "3", "--size", "32", "--n_cams", "2", "--n_sub", "3",
                   "--curve_start", "1", "--batched", "--layout", "mixed", "--tile", "16",
                   "--max_pairs", str(1 << 14), "--true_scale", "0.1", "--device", "cpu",
                   "--report", joint])
    with open(joint) as f:
        result = json.load(f)
    assert rc in (0, 1) and result["nan_at"] is None and result["overflow_steps"] == 0
    assert all(np.isfinite(result[k]) for k in ("sharp_psnr", "sharp_psnr_midcam", "traj_err",
                                                 "traj_err_aligned", "blur_floor_psnr"))
