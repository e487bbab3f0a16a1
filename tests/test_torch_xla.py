"""The port's xla and oracle backends against the JAX package's.

The xla backend bins the pairs (``ops/binning.py::bin_gaussians``) and
walks every tile's list in lockstep (``ops/tile_blend.py::blend``, a
hand-written backward); the oracle composites every pixel densely and is
differentiated by autograd. Inputs are made with numpy from a seed (48×32
to 64×48 pixels, 120-150 Gaussians, ``k_max`` 64-128) and handed to both
packages; JAX's Pallas path runs in interpret mode.

Where tile ranges are compared with JAX's, ``max_pairs`` is not a power of
two: there JAX's ``searchsorted_right`` runs one round short
(``tests/test_torch_cli.py::test_searchsorted_right_on_power_of_two_lengths``).
Tolerances are ``tests/test_rasterizer.py``'s: images atol 1e-5 and rtol
1e-4, gradients 2e-5 after scaling by the reference's largest entry.
"""

import contextlib
import dataclasses
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.core import camera as jcam
from deblurgs_tpu.core import transforms as jtf
from deblurgs_tpu.eval import pose_opt as jpose
from deblurgs_tpu.eval import session as jsession
from deblurgs_tpu.models import gaussians as jgm
from deblurgs_tpu.models import motion as jmm
from deblurgs_tpu.ops import binning as jbin
from deblurgs_tpu.ops import preprocess as jpre
from deblurgs_tpu.ops import rasterize as jras
from deblurgs_tpu.ops import tile_blend as jtb
from deblurgs_tpu.train import step as jstep
from deblurgs_tpu.train.config import OptimizationConfig as JOptimizationConfig
from deblurgs_tpu_torch.cli import evaluate as tcli
from deblurgs_tpu_torch.core import camera as tcam
from deblurgs_tpu_torch.eval import pose_opt as tpose
from deblurgs_tpu_torch.eval import session as tsession
from deblurgs_tpu_torch.models import gaussians as tgm
from deblurgs_tpu_torch.models import motion as tmm
from deblurgs_tpu_torch.ops import binning as tbin
from deblurgs_tpu_torch.ops import preprocess as tpre
from deblurgs_tpu_torch.ops import rasterize as tras
from deblurgs_tpu_torch.ops import tile_blend as ttb
from deblurgs_tpu_torch.train import step as tstep
from deblurgs_tpu_torch.train.config import OptimizationConfig
from tests.test_torch_eval import _eval_txt, _poses, _write_run
from tests.test_torch_loop import _trainers, source  # noqa: F401  (fixture)
from tests.test_torch_train import (EVENTS, RKW, _assert_states_close, _jax_draws, _scene,
                                    _states, assert_close)
from tests.torch_bridge import make_camera, make_gaussians, np_of, to_jax, to_torch

torch.set_num_threads(1)

W, H = 64, 48
BG = np.array([0.1, 0.2, 0.3], np.float32)
MAX_PAIRS = 3000          # not a power of two (see the module docstring)


def _jax_pre(cam, gauss, tile=16):
    jc, jcs = cam.jax()
    means, scales, rots, opac, shs = to_jax(*gauss)
    cov6 = jtf.build_covariance(scales, rots, 1.0)
    return jpre.preprocess(means, cov6, shs, None, opac, jc, jcs, sh_degree=1,
                           tile_w=tile, tile_h=tile)


def _as_torch(pre):
    """The port's PreprocessOut holding JAX's preprocess outputs."""
    return tpre.PreprocessOut(*(torch.from_numpy(np.array(x)) for x in pre))


@pytest.fixture(scope="module")
def scene():
    cam = make_camera(W, H)
    gauss = make_gaussians(3, n=150)
    jpre_out = _jax_pre(cam, gauss)
    return cam, gauss, jpre_out, _as_torch(jpre_out)


def _bins(pre, jpre_out, max_pairs=MAX_PAIRS, tile=16):
    cfg = ttb.BlendConfig(width=W, height=H, tile_w=tile, tile_h=tile)
    kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, max_pairs=max_pairs)
    return jbin.bin_gaussians(jpre_out, **kw), tbin.bin_gaussians(pre, **kw)


@pytest.mark.parametrize("max_pairs", [MAX_PAIRS, 201], ids=["fits", "overflows"])
def test_bin_gaussians_matches_jax(scene, max_pairs):
    """Pair order, tile ranges, the emitted count and the longest list,
    also when the list overflows ``max_pairs`` and is truncated."""
    _, _, jpre_out, pre = scene
    jb, tb = _bins(pre, jpre_out, max_pairs)
    for name in ("pair_gauss", "pair_tile", "num_pairs"):
        np.testing.assert_array_equal(np_of(getattr(tb, name)), np_of(getattr(jb, name)),
                                      err_msg=name)
    # tile ranges: numpy's search over the sorted ids. JAX's agrees except
    # where a truncated list leaves no sentinel slot: its unrolled search
    # then returns max_pairs + 1 for the last tile, one past the list
    tq = np.arange(tb.tile_start.shape[0])
    want = {"tile_start": np.searchsorted(np_of(tb.pair_tile), tq - 1, side="right"),
            "tile_stop": np.searchsorted(np_of(tb.pair_tile), tq, side="right")}
    for name, w in want.items():
        np.testing.assert_array_equal(np_of(getattr(tb, name)), w, err_msg=name)
        jw = np_of(getattr(jb, name))
        inside = jw <= max_pairs
        np.testing.assert_array_equal(jw[inside], w[inside], err_msg=name)
        assert (jw[~inside] == max_pairs + 1).all() and (w[~inside] == max_pairs).all()
    assert int(tb.max_per_tile) == int(np.max(want["tile_stop"] - want["tile_start"]))
    assert int(tb.num_pairs) > 250 and int(tb.max_per_tile) > 16
    assert (int(tb.num_pairs) > max_pairs) == (max_pairs == 201)


def test_expand_slots_matches_jax():
    """Owner, validity and offset of every slot, the slots past the total
    included, with Gaussians that emit nothing between the runs."""
    rng = np.random.default_rng(2)
    area = np.where(rng.uniform(size=40) < 0.4, 0, rng.integers(1, 9, 40)).astype(np.int32)
    for max_pairs in (int(area.sum()) + 37, int(area.sum()) - 11):
        want = jbin.expand_slots(jnp.asarray(area), max_pairs)
        got = tbin.expand_slots(torch.from_numpy(area), max_pairs)
        for name, g, w in zip(("gauss", "valid", "local", "total"), got, want):
            np.testing.assert_array_equal(np_of(g), np_of(w), err_msg=name)


def _blend_inputs(pre):
    return (pre.means2d, pre.conic, pre.opacity, pre.color, pre.depth)


def _jax_blend(cfg, jb, jpre_out, cot=None):
    args = tuple(jnp.asarray(np.asarray(x)) for x in _blend_inputs(jpre_out)) + (
        jnp.asarray(BG),)
    fn = lambda *a: jtb.blend(cfg, jb.pair_gauss, jb.pair_tile, jb.tile_start,  # noqa: E731
                              jb.tile_stop, *a)
    out, vjp = jax.vjp(fn, *args)
    return out, (vjp(cot) if cot is not None else None)


def _port_blend(cfg, tb, pre, cot=None):
    args = [x.clone().requires_grad_(True) for x in _blend_inputs(pre)]
    bg = torch.from_numpy(BG).requires_grad_(True)
    out = ttb.blend_from_binning(cfg, tb, *args, bg)
    grads = None
    if cot is not None:
        grads = torch.autograd.grad(out[:2], args + [bg],
                                    [torch.from_numpy(np.array(c)) for c in cot[:2]])
    return out, grads


def _cotangents(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((H, W, 3)).astype(np.float32),
            (0.01 * rng.standard_normal((H, W))).astype(np.float32),
            np.zeros((H, W), np.float32), np.zeros((H, W), np.int32))


def _check_scaled(got, want, name):
    want = np_of(want)
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(np_of(got) / scale, want / scale, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("k_max", [128, 16], ids=["full", "truncated"])
def test_xla_blend_matches_jax(scene, k_max):
    """The walk's outputs and its hand-written backward against JAX's
    ``blend`` and ``jax.vjp`` of it. With ``k_max`` below the longest list
    both truncate the same pairs, and the result differs from the full
    walk's."""
    _, _, jpre_out, pre = scene
    jb, tb = _bins(pre, jpre_out)
    cfg_kw = dict(width=W, height=H, k_max=k_max, backend="xla")
    cot = _cotangents()
    want, want_g = _jax_blend(jtb.BlendConfig(**cfg_kw), jb, jpre_out, cot)
    got, got_g = _port_blend(ttb.BlendConfig(**cfg_kw), tb, pre, cot)
    np.testing.assert_allclose(np_of(got[0]), np_of(want[0]), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np_of(got[1]), np_of(want[1]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np_of(got[2]), np_of(want[2]), atol=1e-5)
    np.testing.assert_array_equal(np_of(got[3]), np_of(want[3]))
    for name, g, w in zip(("means2d", "conic", "opacity", "color", "depth", "bg"),
                          got_g, want_g):
        _check_scaled(g, w, name)
        assert np.abs(np_of(w)).max() > 0, name
    if k_max < int(tb.max_per_tile):
        full, _ = _port_blend(ttb.BlendConfig(**dict(cfg_kw, k_max=128)), tb, pre)
        assert float(torch.max(torch.abs(full[0] - got[0]).detach())) > 1e-3


def test_walk_stops_at_the_longest_list(scene):
    """Stopping at the longest list gives, bit for bit, what all ``k_max``
    steps give, forward and backward."""
    _, _, jpre_out, pre = scene
    _, tb = _bins(pre, jpre_out)
    cfg = ttb.BlendConfig(width=W, height=H, k_max=256, backend="xla")
    steps = ttb.walk_length(cfg, tb.tile_start, tb.tile_stop)
    assert steps == int(tb.max_per_tile) < cfg.k_max
    lists = (tb.pair_gauss, tb.tile_start, tb.tile_stop)
    fields = _blend_inputs(pre)
    short = ttb._xla_forward(cfg, *lists, *fields, steps)
    full = ttb._xla_forward(cfg, *lists, *fields, cfg.k_max)
    for a, b in zip(short, full):
        assert torch.equal(a, b)
    d_pix = ttb.image_to_tiles(cfg, torch.from_numpy(_cotangents()[0]))
    d_dep = ttb.image_to_tiles(cfg, torch.from_numpy(_cotangents()[1]))
    T, n_con = short[2], short[3]
    args = (cfg, *lists, *fields, torch.from_numpy(BG), T, n_con, d_pix, d_dep)
    for a, b in zip(ttb._xla_backward(*args, steps), ttb._xla_backward(*args, cfg.k_max)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# render: xla and oracle against JAX, and the port's backends against each other
# ---------------------------------------------------------------------------


def _render_both(backend, cam, gauss, **kw):
    jc, jcs = cam.jax()
    tc, tcs = cam.torch()
    kw = dict(backend=backend, max_pairs=MAX_PAIRS, k_max=128, **kw)
    want = jras.render(*to_jax(*gauss), jc, jcs, jnp.asarray(BG), sh_degree=1,
                       cfg=jras.RasterizeConfig(**kw))
    got = tras.render(*to_torch(*gauss), tc, tcs, torch.from_numpy(BG), sh_degree=1,
                      cfg=tras.RasterizeConfig(**kw))
    return got, want


@pytest.mark.parametrize("backend", ["xla", "oracle"])
def test_render_matches_jax(scene, backend):
    cam, gauss, _, _ = scene
    got, want = _render_both(backend, cam, gauss)
    np.testing.assert_allclose(np_of(got.image), np_of(want.image), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np_of(got.depth), np_of(want.depth), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np_of(got.final_T), np_of(want.final_T), atol=1e-5)
    for name in ("n_contrib", "radii", "visible", "num_pairs", "max_per_tile"):
        np.testing.assert_array_equal(np_of(getattr(got, name)), np_of(getattr(want, name)),
                                      err_msg=name)
    assert float(np_of(got.final_T).mean()) < 0.9


PORT_BACKENDS = [dict(backend="xla"), dict(backend="pallas", layout="mixed"),
                 dict(backend="pallas", layout="lockstep")]


def _port_loss_grads(kw, cam, gauss, w_img, w_dep):
    tc, tcs = cam.torch()
    leaves = [x.clone().requires_grad_(True) for x in to_torch(*gauss)]
    view = tc.view.clone().requires_grad_(True)
    cam_t = tcam.CameraArrays(view=view, full_proj=tc.full_proj, campos=tc.campos)
    vsp = torch.zeros((leaves[0].shape[0], 2), requires_grad=True)
    out = tras.render(*leaves, cam_t, tcs, torch.from_numpy(BG), sh_degree=1, vsp=vsp,
                      cfg=tras.RasterizeConfig(max_pairs=1 << 14, k_max=512, **kw))
    loss = torch.sum(out.image * w_img) + torch.sum(out.depth * w_dep)
    return out, torch.autograd.grad(loss, leaves + [view, vsp])


@pytest.mark.parametrize("kw", PORT_BACKENDS, ids=["xla", "mixed", "lockstep"])
def test_port_backends_match_the_oracle(kw):
    """``tests/test_rasterizer.py`` on the port: each backend's image and
    every gradient (means, scales, rotations, opacities, SH, the view
    matrix, the viewspace points) against the oracle's autograd."""
    cam = make_camera(48, 32)
    gauss = make_gaussians(3, n=120)
    rng = np.random.default_rng(7)
    w_img = torch.from_numpy(rng.standard_normal((32, 48, 3)).astype(np.float32))
    w_dep = torch.from_numpy((0.01 * rng.standard_normal((32, 48))).astype(np.float32))
    got, g_got = _port_loss_grads(kw, cam, gauss, w_img, w_dep)
    want, g_want = _port_loss_grads(dict(backend="oracle"), cam, gauss, w_img, w_dep)
    np.testing.assert_allclose(np_of(got.image), np_of(want.image), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np_of(got.depth), np_of(want.depth), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np_of(got.final_T), np_of(want.final_T), atol=1e-5)
    for name, g, w in zip(("means", "scales", "rots", "opacity", "shs", "view", "vsp"),
                          g_got, g_want):
        _check_scaled(g, w, name)
        assert float(torch.max(torch.abs(w))) > 0, name


# ---------------------------------------------------------------------------
# the train step, the loop, the session
# ---------------------------------------------------------------------------


def _xla_statics(cs, k_max):
    rkw = dict(RKW, backend="xla", k_max=k_max, max_pairs=6000)
    common = dict(sh_degree=1, n_sub=3, tone_mapping="identity", spatial_lr_scale=2.0,
                  random_sample=True, batched_render=True, cams_per_step=1)
    js = jstep.TrainStatics(
        gcfg=jgm.GaussianConfig(sh_degree=1),
        mcfg=jmm.MotionConfig(curve_order=3, n_subframes=3, curve_random_sample=True),
        ocfg=JOptimizationConfig(**EVENTS), rcfg=jras.RasterizeConfig(**rkw),
        cs=jcam.CameraStatic(**cs), **dict(common, batched_render=False))
    ts = tstep.TrainStatics(
        gcfg=tgm.GaussianConfig(sh_degree=1),
        mcfg=tmm.MotionConfig(curve_order=3, n_subframes=3, curve_random_sample=True),
        ocfg=OptimizationConfig(**EVENTS), rcfg=tras.RasterizeConfig(**rkw),
        cs=tcam.CameraStatic(**cs), **common)
    return js, ts


@pytest.mark.parametrize("k_max", [128, 16], ids=["full", "truncated"])
def test_xla_train_step_matches_jax(k_max):
    """Three xla steps (the curve gate, a densify event) with JAX's draws
    injected: metrics, the k_max overflow flag and every state leaf. The
    port's statics ask for a batched render, which xla does not have: it
    renders view by view, as JAX's per-view path."""
    leaves, cs, proj, gts = _scene(40)
    js, ts = _xla_statics(cs, k_max)
    jstate, tstate = _states(leaves, 40)
    fn = jstep.make_train_step(js)
    for it in range(3):
        draws = _jax_draws(jstate, js, 1)
        jstate, jmet = fn(jstate, jnp.asarray(gts[it % 2]), jnp.int32(it % 2),
                          jnp.asarray(proj))
        tstate, tmet = tstep.train_step(tstate, torch.from_numpy(gts[it % 2]), it % 2,
                                        torch.from_numpy(proj), ts, draws=draws)
        for name in ("loss", "l1", "t_smooth", "hinge", "psnr"):
            assert_close(getattr(tmet, name), getattr(jmet, name), atol=1e-6, rtol=1e-4,
                         name=name)
        for name in ("num_active", "num_pairs", "max_per_tile", "overflowed",
                     "overflow_count"):
            assert int(getattr(tmet, name)) == int(getattr(jmet, name)), name
    assert bool(tmet.overflowed) == (k_max < int(tmet.max_per_tile))
    _assert_states_close(jstate, tstate, atol=2e-4)


def test_loop_doubles_k_max(source, capsys):  # noqa: F811
    """On xla the drain doubles ``k_max`` whenever a step's longest list
    passed it (JAX's ``loop.py:362-365``); the steps after it run at the
    new value, and a step that passed it counts as overflowed."""
    flags = ["--backend", "xla", "--iterations", "4", "--curve_start_iter", "2",
             "--num_subframes", "3", "--curve_order", "2", "--max_pairs", "6000",
             "--tile", "16"]
    _, tt = _trainers(source, flags, sync_every=1, log_every=100)
    tt.rcfg = dataclasses.replace(tt.rcfg, k_max=4)
    seen = []
    tt.on_metrics = lambda it, m: seen.append((int(m.max_per_tile), bool(m.overflowed)))
    state, first = tt.init_state()
    assert not tt.batched_render
    tt.train(state, first, iterations=4)
    k, used, growths = 4, set(), 0
    for longest, overflowed in seen:
        used.add(k)
        assert overflowed == (longest > k)
        if longest > k:
            k, growths = 2 * k, growths + 1
    # the cache key is JAX's: (sh_degree, n_sub, random_sample, capacity, rcfg, mesh)
    assert {key[4].k_max for key in tt._step_cache} == used and growths > 0
    assert capsys.readouterr().out.count("[pairs] k_max →") == growths


@pytest.fixture(scope="module")
def xla_run(tmp_path_factory):
    return _write_run(str(tmp_path_factory.mktemp("xla_run")))


def test_session_without_a_backend_key_renders_on_xla(xla_run):
    """A ``cfg_args`` with no ``backend`` means xla in both packages; the
    port renders it and matches JAX's render of the held-out pose."""
    _, model = xla_run
    js = jsession.load_session(model)
    ts = tsession.load_session(model, device="cpu")
    assert ts.rcfg.backend == js.rcfg.backend == "xla"
    R, T = _poses(ts.scene.info.test_cameras, 0.05)
    want, want_d = jsession.render_view(js, jpose.pose_to_camera(
        jpose.init_pose_params(jnp.asarray(R), jnp.asarray(T)), 0, jnp.asarray(js.scene.proj)))
    got, got_d = tsession.render_view(ts, tpose.pose_to_camera(
        tpose.init_pose_params(torch.from_numpy(R), torch.from_numpy(T)), 0,
        torch.from_numpy(ts.scene.proj)))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np_of(got_d), np_of(want_d), atol=1e-3, rtol=1e-4)
    assert float(np_of(got).max()) > 0.05


def test_session_grows_k_max_for_a_long_list(xla_run):
    """A view whose longest tile list passes the session's ``k_max`` renders
    again at the next power of two that holds it (JAX truncates): the image
    is JAX's at that ``k_max``, and later views keep it."""
    _, model = xla_run
    ts = tsession.load_session(model, device="cpu")
    ts.rcfg = dataclasses.replace(ts.rcfg, k_max=2)
    js = jsession.load_session(model)
    R, T = _poses(ts.scene.info.test_cameras)
    cam = tpose.pose_to_camera(tpose.init_pose_params(torch.from_numpy(R), torch.from_numpy(T)),
                               0, torch.from_numpy(ts.scene.proj))
    out = contextlib.redirect_stdout(io.StringIO())
    with out as log:
        got, _ = tsession.render_view(ts, cam)
    rin = tgm.render_inputs(ts.params, ts.gcfg)
    longest = int(tras.render(rin["means3d"], rin["scales"], rin["rotations"],
                              rin["opacities"], rin["shs"], cam, ts.scene.camera_static,
                              torch.zeros(3), cfg=ts.rcfg, sh_degree=ts.gcfg.sh_degree,
                              active=ts.aux.active).max_per_tile)
    assert ts.rcfg.k_max == 1 << math.ceil(math.log2(longest)) and longest > 2
    assert "k_max →" in log.getvalue()
    js.rcfg = dataclasses.replace(js.rcfg, k_max=ts.rcfg.k_max)
    want, _ = jsession.render_view(js, jpose.pose_to_camera(
        jpose.init_pose_params(jnp.asarray(R), jnp.asarray(T)), 0, jnp.asarray(js.scene.proj)))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5, rtol=1e-4)


def test_evaluate_without_a_backend_flag(xla_run):
    """``python -m deblurgs_tpu_torch.cli.evaluate`` with no ``--backend``
    on a run whose ``cfg_args`` has none: xla, two pose iterations a view,
    the same ``eval.txt`` PSNR and SSIM as JAX's evaluate within 1e-3."""
    from deblurgs_tpu.cli import evaluate as jcli

    _, model = xla_run
    argv = ["-m", model, "--num_iter_per_view", "2"]
    want = jcli.main(argv)
    got = tcli.main(argv + ["--device", "cpu"])
    assert set(_eval_txt(model)) == {"unfit", "fit"}
    for k in ("unfit", "fit"):
        for m in ("PSNR", "SSIM"):
            assert abs(float(got[k][m]) - float(want[k][m])) <= 1e-3, (k, m)
