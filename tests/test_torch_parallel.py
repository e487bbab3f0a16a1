"""The port's ``parallel/`` against the JAX package's: sub-frame sharding
of the train step (2 and 4 ranks, per view and batched, a smoothness term
whose consecutive pairs straddle the ranks' blocks), Gaussian-axis sharding
through a densify event, and row slabs (the crop cameras, the slab render
at a height that does not divide, its gradients).

JAX runs its meshes on the 8 virtual CPU devices of ``tests/conftest.py``
and its Pallas path in interpret mode; the port runs its ranks as spawned
processes with gloo on the CPU (``multihost.launch``: one launch of four
ranks takes every case, the 2-rank ones on a sub-mesh). The setups are
those of ``tests/test_sharding.py``, ``tests/test_gauss_shard.py`` and
``tests/test_tile_shard.py``; the states are moved off the init's exact
gradient ties first (``tests/test_torch_loop.py::_generic``), where a
float-noise gradient against an exact zero becomes a whole learning-rate
step through Adam in either package.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.models import gaussians as jgm
from deblurgs_tpu.models import motion as jmm
from deblurgs_tpu.ops import rasterize as jras
from deblurgs_tpu.parallel import gauss_shard as jgs
from deblurgs_tpu.parallel import make_mesh as jmake_mesh
from deblurgs_tpu.parallel import tile_shard as jts
from deblurgs_tpu.train import checkpoint as jckpt
from deblurgs_tpu.train import step as jstep
from deblurgs_tpu.train.config import OptimizationConfig as JOptimizationConfig
from deblurgs_tpu_torch.core import camera as tcam
from deblurgs_tpu_torch.models import gaussians as tgm
from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
from deblurgs_tpu_torch.parallel import gauss_shard, shard, tile_shard
from deblurgs_tpu_torch.train import step as tstep
from deblurgs_tpu_torch.train.config import OptimizationConfig
from tests import torch_parallel_workers as workers
from tests.scene_factory import make_camera, make_gaussians
from tests.test_torch_loop import _generic
from tests.test_train import build_synthetic

torch.set_num_threads(1)

QUIET = dict(curve_start_iter=1, densify_from_iter=10_000, opacity_reset_interval=10_000)
# densify at step 2 (from iteration 1, every 2nd), a low threshold so it clones and splits
DENSIFY = dict(curve_start_iter=1, densify_from_iter=1, densification_interval=2,
               densify_until_iter=100, opacity_reset_interval=10_000,
               densify_grad_threshold_init=1e-7, densify_grad_threshold_final=1e-7,
               densify_annealing_until=100)
BATCHED_RCFG = dict(backend="pallas", layout="mixed", window=2, max_pairs=1 << 13, k_max=256,
                    need_n_contrib=False)
ROW_CFG = dict(backend="xla", max_pairs=1 << 14, k_max=512)


def _port_kw(jax_cfg, port_cls) -> dict:
    """The port's fields of a JAX config dataclass."""
    return {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(port_cls)}


def _jax_draws(key, P: int, gt_shape) -> dict:
    """The draws JAX's train step makes from ``key`` (B = 1, no jitter)."""
    _, _, k_bg, k_noise, k_densify = jax.random.split(key, 5)
    k1, k2 = jax.random.split(k_densify)
    return dict(bg=np.array(jax.random.uniform(k_bg, (3,))),
                noise=np.array(jax.random.normal(k_noise, (1,) + gt_shape)),
                split=[np.array(jax.random.normal(k, (P, 3))) for k in (k1, k2)])


@functools.lru_cache(maxsize=None)
def _setup(key, n_sub):
    """``tests/test_sharding.py``'s (key 42, 8 sub-frames) or
    ``tests/test_gauss_shard.py``'s (key 7, 4) setup: a JAX state (moved
    off the init's ties) and statics without a mesh."""
    data = build_synthetic(jax.random.PRNGKey(key), n_cams=2)
    params, aux = jgm.create_from_pcd(data["pts"], data["cols"], data["gcfg"], capacity=64)
    mcfg = jmm.MotionConfig(curve_order=3, n_subframes=n_sub)
    motion = jmm.init_motion(data["rots"], data["centers"], mcfg, jax.random.PRNGKey(1),
                             init_noise=0.005)
    state = _generic(jstep.init_state(params, motion, aux, jax.random.PRNGKey(9)))
    return data, mcfg, state


def _jax_run(state, statics, gt, proj, n_steps, fn=None):
    fn = fn or jstep.make_train_step(statics)
    metrics = []
    for _ in range(n_steps):
        state, m = fn(state, gt, jnp.int32(0), proj)
        metrics.append(m)
    return state, metrics


def _case(data, mcfg, st, state, n_steps, ranks, **kw) -> dict:
    """A port case (``tests/torch_parallel_workers.py``) of JAX's setup."""
    keys = [state.rng]
    for _ in range(n_steps - 1):
        keys.append(jax.random.split(keys[-1], 5)[0])
    gt = np.asarray(data["gts"][0])
    cfg = dict(gcfg=_port_kw(st.gcfg, tgm.GaussianConfig), mcfg=dataclasses.asdict(mcfg),
               ocfg=_port_kw(st.ocfg, OptimizationConfig),
               rcfg=_port_kw(st.rcfg, RasterizeConfig),
               cs=dataclasses.asdict(st.cs),
               statics=dict(sh_degree=st.sh_degree, n_sub=st.n_sub,
                            tone_mapping=st.tone_mapping,
                            spatial_lr_scale=st.spatial_lr_scale,
                            batched_render=st.batched_render))
    return dict(cfg=cfg, state=jckpt._flatten(state), gt=gt.copy(),
                proj=np.array(data["proj"]),
                cam=0, draws=[_jax_draws(k, state.params.xyz.shape[0], gt.shape) for k in keys],
                ranks=ranks, **kw)


SF_CASES = {  # name: (ranks, batched, JAX mesh size, steps)
    "2_per_view": (2, False, 2, 2), "4_per_view": (4, False, 8, 2),
    "2_batched": (2, True, 2, 1), "4_batched": (4, True, 2, 1)}


@pytest.fixture(scope="module")
def runs():
    """JAX's sharded runs, the port's cases on four ranks (one launch) and
    the same cases in this process."""
    data, mcfg, state = _setup(42, 8)
    jax_out, cases = {}, {}
    for name, (ranks, batched, jmesh, steps) in SF_CASES.items():
        rcfg = (jras.RasterizeConfig(interpret=True, **BATCHED_RCFG) if batched
                else data["rcfg"])
        st = jstep.TrainStatics(gcfg=data["gcfg"], mcfg=mcfg, ocfg=JOptimizationConfig(**QUIET),
                                rcfg=rcfg, cs=data["cs"], sh_degree=1, n_sub=8,
                                tone_mapping="identity", spatial_lr_scale=2.0,
                                batched_render=batched)
        if (jmesh, batched, steps) not in jax_out:
            jax_out[jmesh, batched, steps] = _jax_run(
                state, dataclasses.replace(st, mesh=jmake_mesh(jmesh)), data["gts"][0],
                data["proj"], steps)
        cases[name] = _case(data, mcfg, st, state, steps, ranks)
        cases[name]["jax"] = jax_out[jmesh, batched, steps]
    # the smoothness term at weight 1: seven consecutive pairs, three of
    # them across the four ranks' blocks of two views
    st_t = jstep.TrainStatics(
        gcfg=data["gcfg"], mcfg=mcfg,
        ocfg=JOptimizationConfig(**QUIET, lambda_t_smooth_init=1.0, lambda_t_smooth_final=1.0),
        rcfg=jras.RasterizeConfig(interpret=True, **BATCHED_RCFG), cs=data["cs"], sh_degree=1,
        n_sub=8, tone_mapping="identity", spatial_lr_scale=2.0, batched_render=True)
    cases["straddle"] = _case(data, mcfg, st_t, state, 1, 4, grads=True)
    # the Gaussian axis (tests/test_gauss_shard.py), through a densify event
    gdata, gmcfg, gstate = _setup(7, 4)
    st_g = jstep.TrainStatics(gcfg=gdata["gcfg"], mcfg=gmcfg, ocfg=JOptimizationConfig(**DENSIFY),
                              rcfg=gdata["rcfg"], cs=gdata["cs"], sh_degree=1, n_sub=4,
                              tone_mapping="identity", spatial_lr_scale=2.0)
    gmesh = jgs.make_gauss_mesh(8)
    gfn = jgs.make_gauss_train_step(st_g, gmesh)
    jg = [_jax_run(jgs.shard_gauss_state(gstate, gmesh), st_g, gdata["gts"][0], gdata["proj"],
                   1, gfn)]
    jg.append(_jax_run(jg[0][0], st_g, gdata["gts"][0], gdata["proj"], 1, gfn))
    cases["gauss"] = _case(gdata, gmcfg, st_g, gstate, 2, 2, axis=gauss_shard.GAUSS_AXIS)
    cases["gauss"]["jax"] = (jg[1][0], jg[0][1] + jg[1][1])
    cases.update(_row_cases())
    names = list(cases)
    plain = [{k: v for k, v in cases[n].items() if k != "jax"} for n in names]
    ranked = workers.launch(workers.run_cases, 4, plain)
    single = {n: (workers.row_slabs if cases[n].get("kind") == "row_slabs"
                  else workers.run_case)(c, None) for n, c in zip(names, plain)}
    return {n: dict(case=cases[n], ranks=[r[i] for r in ranked if r[i] is not None],
                    single=single[n]) for i, n in enumerate(names)}


def _row_cases() -> dict:
    """``tests/test_tile_shard.py``'s scene: 2 slabs of 32 rows for a
    48-row frame (the bottom slab renders pad rows), and 4 slabs with the
    loss weights of its gradient test."""
    cam, cs, proj, gauss, bg = _row_scene()
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (48, 64, 3)))
    base = dict(kind="row_slabs", cs=dataclasses.asdict(cs), sh_degree=1,
                gauss=[np.asarray(x) for x in gauss], view=np.asarray(cam.view),
                proj=np.asarray(proj), bg=np.asarray(bg), w=w)
    return {"rows_2": dict(base, ranks=2, rcfg=dict(ROW_CFG, tile_h=32, tile_w=32)),
            "rows_4": dict(base, ranks=4, rcfg=ROW_CFG)}


def _row_scene():
    cam, cs, proj = make_camera(width=64, height=48)
    gauss = make_gaussians(jax.random.PRNGKey(7), n=180, sh_deg=1, opacity_max=0.95)
    return cam, cs, proj, gauss, jnp.array([0.3, 0.1, 0.5])


def _assert_state(flat, jstate_or_flat, atol=1e-5, rtol=1e-4, keys=("params/", "motion/")):
    want = (jstate_or_flat if isinstance(jstate_or_flat, dict)
            else jckpt._flatten(jstate_or_flat))
    for k, v in want.items():
        if k.startswith(keys):
            np.testing.assert_allclose(flat[k], np.asarray(v), atol=atol, rtol=rtol, err_msg=k)


def _ranks_agree(r):
    for other in r["ranks"][1:]:
        assert [m["loss"] for m in other["metrics"]] == [m["loss"] for m in r["ranks"][0]
                                                          ["metrics"]]


@pytest.mark.parametrize("name", list(SF_CASES))
def test_subframe_step_matches_jax(runs, name):
    """The port's sharded step on 2 or 4 ranks against JAX's on
    ``make_mesh(2)`` / ``make_mesh()``: loss rtol 1e-4 each step; params
    and motion atol 1e-5 / rtol 1e-4 (``tests/test_sharding.py``'s); the
    pair count, the max over the blocks, where the blocks are alike."""
    r = runs[name]
    jstate, jmetrics = r["case"]["jax"]
    _ranks_agree(r)
    ranks, batched, jmesh, _ = SF_CASES[name]
    for m, jm in zip(r["ranks"][0]["metrics"], jmetrics):
        np.testing.assert_allclose(m["loss"], float(jm.loss), rtol=1e-4)
        if ranks == jmesh or not batched:   # a batched count is a block's
            assert m["num_pairs"] == int(jm.num_pairs)
    _assert_state(r["ranks"][0]["state"], jstate)


@pytest.mark.parametrize("name", list(SF_CASES))
def test_subframe_step_matches_one_process(runs, name):
    """... and against the port's one-process step: every leaf of the state
    (Adam moments and statistics included) at JAX's tolerances; the
    collectives moved bytes and none went through the host (CPU tensors)."""
    r = runs[name]
    for m, m1 in zip(r["ranks"][0]["metrics"], r["single"]["metrics"]):
        np.testing.assert_allclose(m["loss"], m1["loss"], rtol=1e-4)
        if not SF_CASES[name][1]:   # a batched count is a block's
            assert m["num_pairs"] == m1["num_pairs"]
            assert m["max_per_tile"] == m1["max_per_tile"]
    _assert_state(r["ranks"][0]["state"], r["single"]["state"],
                  keys=("params/", "motion/", "aux/", "adam_g/", "adam_m/"))
    traffic = r["ranks"][0]["traffic"]
    assert traffic["all_gather"]["bytes"] > 0
    assert all(t["host_staged_bytes"] == 0 for t in traffic.values())


def test_straddling_smoothness_gradients(runs):
    """Temporal smoothness at weight 1 on 4 ranks of 2 views: the pairs
    (1, 2), (3, 4) and (5, 6) straddle two blocks. The summed gradients of
    params and curves, and each rank's viewspace gradients, equal the
    one-process step's (1e-6 scaled): each pair counted once, no rank n
    times."""
    r = runs["straddle"]
    g1_params, g1_motion, g1_vsp = r["single"]["grads"]
    assert r["single"]["metrics"][0]["t_smooth"] > 0
    for rank, out in enumerate(r["ranks"]):
        g_params, g_motion, g_vsp = out["grads"]
        for name, got, want in zip(g1_params._fields + g1_motion._fields,
                                   tuple(g_params) + tuple(g_motion),
                                   tuple(g1_params) + tuple(g1_motion)):
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got / scale, want / scale, atol=1e-6,
                                       err_msg=f"rank {rank} {name}")
        scale = float(np.abs(g1_vsp).max())
        np.testing.assert_allclose(g_vsp / scale, g1_vsp[2 * rank:2 * rank + 2] / scale,
                                   atol=1e-6)
    np.testing.assert_allclose(r["ranks"][0]["metrics"][0]["t_smooth"],
                               r["single"]["metrics"][0]["t_smooth"], rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1], ids=["plain", "densify"])
def test_gauss_step_matches_jax(runs, step):
    """Two ranks of 32 rows each against JAX's ``make_gauss_train_step`` on
    ``make_gauss_mesh(8)``; the second step densifies (gathered, run once,
    rows kept). Loss rtol 1e-4, the densify counts equal; after both steps
    params and motion at JAX's tolerances, and every leaf against the
    port's one-process step."""
    r = runs["gauss"]
    jstate, jmetrics = r["case"]["jax"]
    _ranks_agree(r)
    m, jm = r["ranks"][0]["metrics"][step], jmetrics[step]
    np.testing.assert_allclose(m["loss"], float(jm.loss), rtol=1e-4)
    assert m["densify"] == [int(x) for x in jm.densify]
    assert m["num_active"] == int(jm.num_active)
    assert r["ranks"][0]["local_rows"] == 32
    if step == 1:
        assert sum(m["densify"][:2]) > 0
        _assert_state(r["ranks"][0]["state"], jstate)
        _assert_state(r["ranks"][0]["state"], r["single"]["state"],
                      keys=("params/", "motion/", "aux/", "adam_g/", "adam_m/"))


@pytest.mark.parametrize("n,tile_h", [(2, 16), (4, 16), (5, 16), (3, 32)])
def test_crop_cameras_match_jax(n, tile_h):
    cam, cs, proj, _, _ = _row_scene()
    tcs = tcam.CameraStatic(**dataclasses.asdict(cs))
    assert tile_shard.slab_layout(tcs, n, tile_h) == jts.slab_layout(cs, n, tile_h)
    jslab, jprojs = jts.crop_cameras(cs, proj, n, tile_h)
    tslab, tprojs = tile_shard.crop_cameras(tcs, torch.from_numpy(np.asarray(proj)), n, tile_h)
    assert dataclasses.asdict(tslab) == pytest.approx(dataclasses.asdict(jslab), rel=1e-7)
    np.testing.assert_allclose(tprojs.numpy(), np.asarray(jprojs), atol=1e-7, rtol=0)


def test_row_sharded_render_matches_one_process(runs):
    """Two slabs of 32 rows for 48 (tile 32): the frame against the
    one-process render (image atol 2e-4, ``tests/test_tile_shard.py``'s),
    ``visible`` and ``radii`` equal, the pair counts the larger slab's."""
    r = runs["rows_2"]
    got, want = r["ranks"][0], r["single"]
    assert got["image"].shape == want["image"].shape == (48, 64, 3)
    np.testing.assert_allclose(got["image"], want["image"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["depth"], want["depth"], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got["final_T"], want["final_T"], atol=2e-4)
    np.testing.assert_array_equal(got["visible"], want["visible"])
    np.testing.assert_array_equal(got["radii"], want["radii"])
    assert got["max_per_tile"] <= want["max_per_tile"]
    np.testing.assert_array_equal(r["ranks"][1]["image"], got["image"])


def test_row_sharded_gradients_match_jax(runs):
    """Four slabs: the gradients of ``sum(image · w)`` for means and
    opacities against JAX's one-device ``jax.grad`` on
    ``test_row_sharded_gradient_parity``'s scene (2e-4 scaled, its
    tolerance), on every rank."""
    cam, cs, proj, gauss, bg = _row_scene()
    w = jnp.asarray(runs["rows_4"]["case"]["w"])
    cfg = jras.RasterizeConfig(**ROW_CFG)

    def loss(means, opac):
        out = jras.render(means, gauss[1], gauss[2], opac, gauss[4], cam, cs, bg, cfg=cfg,
                          sh_degree=1)
        return jnp.sum(out.image * w)

    want = jax.grad(loss, argnums=(0, 1))(gauss[0], gauss[3])
    for out in runs["rows_4"]["ranks"]:
        for got, ref in zip((out["g_means"], out["g_opac"]), want):
            ref = np.asarray(ref)
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got / scale, ref / scale, atol=2e-4)


def test_mesh_refusals():
    """Without a group a mesh is one process; more ranks raise, as do a
    view count or a capacity that does not divide, a Gaussian-axis step
    asked to nest a sub-frame mesh, and a CUDA mesh without a card."""
    one = shard.make_mesh(device="cpu")
    assert (one.size, one.rank, one.group) == (1, 0, None)
    with pytest.raises(ValueError):
        shard.make_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        shard.local_views(dataclasses.replace(one, size=3), 8)
    with pytest.raises(ValueError):
        gauss_shard.local_rows(dataclasses.replace(one, size=3), 64)
    st = workers.statics(_sf_case()["cfg"], mesh=one)
    with pytest.raises(ValueError):
        gauss_shard.make_gauss_train_step(st, one)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            shard.make_mesh()


def _sf_case(**kw) -> dict:
    """One step of ``tests/test_sharding.py``'s setup on the xla backend."""
    data, mcfg, state = _setup(42, 8)
    st = jstep.TrainStatics(gcfg=data["gcfg"], mcfg=mcfg, ocfg=JOptimizationConfig(**QUIET),
                            rcfg=data["rcfg"], cs=data["cs"], sh_degree=1, n_sub=8,
                            tone_mapping="identity", spatial_lr_scale=2.0)
    return _case(data, mcfg, st, state, 1, 1, **kw)


def test_one_process_mesh_is_the_plain_step():
    """A mesh of one process without a group takes the sub-frame path with
    identity collectives: the step is bit for bit the plain one."""
    case = _sf_case(grads=True)
    plain = workers.run_case(case, None)
    meshed = workers.run_case(case, shard.make_mesh(device="cpu"))
    for k, v in plain["state"].items():
        np.testing.assert_array_equal(meshed["state"][k], v, err_msg=k)
    assert plain["metrics"] == meshed["metrics"]
    assert tstep.TrainStatics.__dataclass_fields__["mesh"].default is None
