"""Held-out evaluation of the port against the JAX package's: the trained
session, its render, iNeRF test-pose refinement, the metrics (PSNR, SSIM,
LPIPS with the converter's random weights), the export helpers and the
``evaluate`` CLI.

The model dir is written directly: a COLMAP scene from
``tests/test_data.py::write_colmap_binary`` (3 cameras, 64×48, marker
``hold=3``: view 000 is held out), 150 Gaussians in front of the held-out
camera saved with JAX's ``save_gaussian_ply``, curves with JAX's
``save_motion``, and a hand-written ``cfg_args`` without the
``kernel_layout`` / ``tile`` / ``window`` keys, so both packages evaluate
on the lockstep layout at tile 16. The held-out ground truth is JAX's
render at a pose 0.05 off the COLMAP one. JAX's Pallas path runs in
interpret mode.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.cli import evaluate as jcli
from deblurgs_tpu.data import scene as jscene
from deblurgs_tpu.data.gaussian_ply import save_gaussian_ply
from deblurgs_tpu.data.readers import read_colmap_scene
from deblurgs_tpu.eval import export as jexport
from deblurgs_tpu.eval import metrics as jmetrics
from deblurgs_tpu.eval import pose_opt as jpose
from deblurgs_tpu.eval import session as jsession
from deblurgs_tpu.models import gaussians as jgm
from deblurgs_tpu.models import motion as jmm
from deblurgs_tpu.train.checkpoint import save_motion
from deblurgs_tpu_torch.cli import evaluate as tcli
from deblurgs_tpu_torch.data import scene as tscene
from deblurgs_tpu_torch.eval import export as texport
from deblurgs_tpu_torch.eval import metrics as tmetrics
from deblurgs_tpu_torch.eval import pose_opt as tpose
from deblurgs_tpu_torch.eval import session as tsession
from tests.test_data import write_colmap_binary, write_images
from tests.torch_bridge import gaussian_leaves, np_of

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scripts.convert_lpips_weights import random_weights  # noqa: E402

torch.set_num_threads(1)

N_GAUSS = 150
SHIFT = np.array([0.05, -0.03, 0.02])   # ground-truth pose offset (w2c translation)
CFG_ARGS = ("Namespace(source_path={source!r}, model_path={model!r}, sh_degree=1, "
            "curve_order=2, num_subframes=3, curve_type='se3', resolution=1, eval={eval}, "
            "llffhold={hold}, max_pairs=8192, tone_mapping_type='gamma', images='images')")


def _write_run(root, eval_split=True):
    """Source scene and model dir (see the module docstring)."""
    source, model = os.path.join(root, "scene"), os.path.join(root, "model")
    write_colmap_binary(os.path.join(source, "sparse", "0"), n_cams=3, n_pts=30)
    write_images(os.path.join(source, "images"), [f"{i:03d}.png" for i in range(3)])
    open(os.path.join(source, "hold=3"), "w").close()
    held = read_colmap_scene(source, eval_split=True).test_cameras[0]
    center, forward = -held.T @ held.R.T, held.R[:, 2]
    leaves = gaussian_leaves(11, n=N_GAUSS, sh_deg=1, spread=1.0)
    leaves["params/xyz"] = (center + 4.0 * forward + 0.6 * leaves["params/xyz"]).astype(np.float32)
    params = jgm.GaussianParams(*(jnp.asarray(leaves[f"params/{k}"])
                                  for k in jgm.GaussianParams._fields))
    zeros = jnp.zeros(N_GAUSS)
    aux = jgm.GaussianAux(jnp.ones(N_GAUSS, bool), zeros, zeros, zeros)
    save_gaussian_ply(os.path.join(model, "point_cloud", "iteration_7", "point_cloud.ply"),
                      params, aux, jgm.GaussianConfig(sh_degree=1))
    rng = np.random.default_rng(3)
    save_motion(os.path.join(model, "cm.npz"), jmm.MotionParams(
        rot_ctrl=jnp.asarray(0.1 * rng.standard_normal((2, 3, 3)), jnp.float32),
        trans_ctrl=jnp.asarray(rng.standard_normal((2, 3, 3)), jnp.float32),
        nu=jnp.zeros((2, 1), jnp.float32)))
    with open(os.path.join(model, "cfg_args"), "w") as f:
        f.write(CFG_ARGS.format(source=source, model=model, eval=eval_split,
                                hold=3 if eval_split else 0))
    return source, model


def _poses(infos, shift=0.0):
    R = np.stack([c.R for c in infos]).astype(np.float32)
    T = (np.stack([c.T for c in infos]) + shift).astype(np.float32)
    return R, T


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The run, with the held-out image replaced by JAX's render at the
    shifted pose."""
    source, model = _write_run(str(tmp_path_factory.mktemp("eval_run")))
    s = jsession.load_session(model, backend="pallas")
    R, T = _poses(s.scene.info.test_cameras, SHIFT)
    pose = jpose.init_pose_params(jnp.asarray(R), jnp.asarray(T))
    img, _ = jsession.render_view(s, jpose.pose_to_camera(pose, 0, jnp.asarray(s.scene.proj)))
    from PIL import Image

    Image.fromarray(jexport.to_uint8(img)).save(os.path.join(source, "images", "000.png"))
    return source, model


@pytest.fixture(scope="module")
def sessions(run):
    _, model = run
    return (jsession.load_session(model, backend="pallas"),
            tsession.load_session(model, backend="pallas", device="cpu"))


def test_load_session_matches_jax(sessions):
    js, ts = sessions
    assert ts.iteration == js.iteration == 7
    for k in ts.params._fields:
        # scaling is a log taken by torch and by XLA: one ulp apart at most
        np.testing.assert_allclose(np_of(getattr(ts.params, k)),
                                   np.asarray(getattr(js.params, k)), rtol=2.5e-7, err_msg=k)
    np.testing.assert_array_equal(np_of(ts.aux.active), np.asarray(js.aux.active))
    for k in ts.motion._fields:
        np.testing.assert_array_equal(np_of(getattr(ts.motion, k)),
                                      np.asarray(getattr(js.motion, k)), err_msg=k)
    r = ts.rcfg
    assert (r.layout, r.tile_w, r.tile_h, r.window) == ("lockstep", 16, 16, 1)
    for key in ("layout", "tile_w", "window", "max_pairs", "backend", "cull_z", "z_far",
                "need_n_contrib"):
        assert getattr(r, key) == getattr(js.rcfg, key), key
    assert (ts.gcfg, ts.mcfg, ts.tone_mapping) == (
        type(ts.gcfg)(**vars(js.gcfg)), type(ts.mcfg)(**vars(js.mcfg)), js.tone_mapping)
    np.testing.assert_array_equal(ts.scene.proj, np.asarray(js.scene.proj))
    assert [c.image_name for c in ts.scene.info.test_cameras] == ["000"]


def test_unported_backend_is_named(run):
    """A ``cfg_args`` without ``backend`` means "xla" in JAX and in the
    port, which now renders it: the held-out view matches JAX's xla
    render (the name predates the xla backend's port)."""
    _, model = run
    ts = tsession.load_session(model, device="cpu")
    js = jsession.load_session(model)
    assert ts.rcfg.backend == js.rcfg.backend == "xla"
    R, T = _poses(ts.scene.info.test_cameras)
    cam = tpose.pose_to_camera(tpose.init_pose_params(
        *(torch.from_numpy(a) for a in (R, T))), 0, torch.from_numpy(ts.scene.proj))
    got, _ = tsession.render_view(ts, cam)
    want, _ = jsession.render_view(js, jpose.pose_to_camera(
        jpose.init_pose_params(jnp.asarray(R), jnp.asarray(T)), 0, jnp.asarray(js.scene.proj)))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-5, rtol=1e-4)


def _cameras(js, ts, R, T):
    jp = jpose.init_pose_params(jnp.asarray(R), jnp.asarray(T))
    tp = tpose.init_pose_params(torch.from_numpy(R), torch.from_numpy(T))
    return (jpose.pose_to_camera(jp, 0, jnp.asarray(js.scene.proj)),
            tpose.pose_to_camera(tp, 0, torch.from_numpy(ts.scene.proj)))


def test_pose_camera_and_render_view_match_jax(sessions):
    js, ts = sessions
    jc, tc = _cameras(js, ts, *_poses(ts.scene.info.test_cameras))
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(np_of(a), np.asarray(b), atol=1e-6, rtol=1e-6)
    for tone_map in (True, False):
        want = jsession.render_view(js, jc, tone_map=tone_map)
        got = tsession.render_view(ts, tc, tone_map=tone_map)
        assert float(np_of(got[0]).std()) > 0.01
        np.testing.assert_allclose(np_of(got[0]), np.asarray(want[0]), atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(np_of(got[1]), np.asarray(want[1]), atol=5e-3, rtol=1e-4)


def test_optimize_test_poses_matches_jax(run, sessions):
    """Three iterations from the COLMAP pose towards the shifted one. The
    first Adam step moves every component by ±lr whatever its gradient's
    size; after three, the poses agree to 1e-6 and the loss falls."""
    js, ts = sessions
    R, T = _poses(ts.scene.info.test_cameras)
    gt = tscene.load_image(ts.scene.info.test_cameras[0], -1)[None]
    want = jpose.optimize_test_poses(js, jnp.asarray(gt), jnp.asarray(R), jnp.asarray(T),
                                     jnp.asarray(js.scene.proj), num_iter_per_view=3,
                                     lr_trans=5e-3, verbose=False)
    got = tpose.optimize_test_poses(ts, torch.from_numpy(gt), torch.from_numpy(R),
                                    torch.from_numpy(T), torch.from_numpy(ts.scene.proj),
                                    num_iter_per_view=3, lr_trans=5e-3, verbose=False)
    np.testing.assert_allclose(np_of(got.quat), np.asarray(want.quat), atol=1e-6)
    np.testing.assert_allclose(np_of(got.trans), np.asarray(want.trans), atol=1e-6)
    assert float(np.abs(np_of(got.trans) - T).max()) > 1e-3

    def loss(pose):
        img, _ = tsession.render_view(ts, tpose.pose_to_camera(pose, 0,
                                                               torch.from_numpy(ts.scene.proj)))
        return float(torch.abs(img - torch.from_numpy(gt[0])).mean())

    assert loss(got) < loss(tpose.init_pose_params(torch.from_numpy(R), torch.from_numpy(T)))


def test_view_order_comes_from_the_generator_or_orders(sessions):
    """With two held-out views, each epoch visits both in the drawn or the
    injected order; the injected order of JAX's ``PRNGKey(0)`` stream
    reproduces a run that follows it."""
    _, ts = sessions
    R, T = _poses(ts.scene.info.test_cameras * 2)
    T[1] += 0.01
    gt = torch.from_numpy(np.stack([tscene.load_image(ts.scene.info.test_cameras[0], -1)] * 2))
    args = (ts, gt, torch.from_numpy(R), torch.from_numpy(T), torch.from_numpy(ts.scene.proj))
    kw = dict(num_iter_per_view=2, verbose=False)
    a = tpose.optimize_test_poses(*args, orders=[[1, 0], [0, 1]], **kw)
    b = tpose.optimize_test_poses(*args, orders=[[1, 0], [0, 1]], **kw)
    c = tpose.optimize_test_poses(*args, orders=[[0, 1], [0, 1]], **kw)
    assert torch.equal(a.trans, b.trans) and not torch.equal(a.trans, c.trans)
    g1 = tpose.optimize_test_poses(*args, generator=torch.Generator().manual_seed(5), **kw)
    g2 = tpose.optimize_test_poses(*args, generator=torch.Generator().manual_seed(5), **kw)
    assert torch.equal(g1.quat, g2.quat)


def test_evaluate_pairs_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    gts = [rng.rand(24, 32, 3).astype(np.float32) for _ in range(2)]
    renders = [np.clip(g + 0.05 * rng.randn(24, 32, 3), 0, 1).astype(np.float32) for g in gts]
    got, got_pv = tmetrics.evaluate_pairs(renders, gts)
    want, want_pv = jmetrics.evaluate_pairs(renders, gts)
    assert got.keys() == want.keys() and got["LPIPS"] is None
    for k in ("PSNR", "SSIM"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got_pv[k.lower()], want_pv[k.lower()], rtol=1e-4)
    for mod, d in ((tmetrics, "t"), (jmetrics, "j")):
        os.makedirs(tmp_path / d)
        mod.write_results(str(tmp_path / d), "fit", got, got_pv, ["a.png", "b.png"])
    for name in ("results.json", "per_view.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


@pytest.mark.parametrize("net_type", ["vgg", "alex"])
def test_lpips_matches_jax(tmp_path, net_type):
    """The converter's random weights, loaded from an ``.npz`` by both
    packages; three image pairs at rtol 2e-4."""
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **random_weights(net_type, seed=3))
    tl = tmetrics.LPIPS.from_file(path, device="cpu")
    jl = jmetrics.LPIPS.from_file(path)
    assert tl.net_type == jl.net_type == net_type
    rng = np.random.RandomState(11)
    for _ in range(3):
        a = rng.rand(64, 64, 3).astype(np.float32)
        b = np.clip(a + 0.1 * rng.randn(64, 64, 3), 0, 1).astype(np.float32)
        np.testing.assert_allclose(float(tl(torch.from_numpy(a), torch.from_numpy(b))),
                                   float(jl(jnp.asarray(a), jnp.asarray(b))), rtol=2e-4)
    assert float(tl(torch.from_numpy(a), torch.from_numpy(a))) < 1e-9
    agg, _ = tmetrics.evaluate_pairs([a], [b], tl)
    np.testing.assert_allclose(agg["LPIPS"], float(jl(jnp.asarray(a), jnp.asarray(b))), rtol=2e-4)


def test_lpips_without_weights_is_none(monkeypatch):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    assert tmetrics.LPIPS.from_file("/nonexistent/path.npz", device="cpu") is None
    if not os.path.exists(tmetrics.LPIPS.DEFAULT_WEIGHTS):
        assert tmetrics.LPIPS.from_file(device="cpu") is None


def test_export_helpers_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, (8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(texport.to_uint8(torch.from_numpy(img)), jexport.to_uint8(img))
    depth = rng.uniform(0.5, 30.0, (12, 10)).astype(np.float32)
    np.testing.assert_array_equal(texport.depth_colorize(depth), jexport.depth_colorize(depth))
    import matplotlib

    x = np.concatenate([[0.0, 1.0, 0.5], rng.random(10_000)]).astype(np.float32)
    np.testing.assert_array_equal(texport.colormap("jet", x),
                                  matplotlib.colormaps["jet"](x)[..., :3])
    quats = rng.standard_normal((4, 4))
    from scipy.spatial.transform import Rotation

    c2ws = np.tile(np.eye(4), (4, 1, 1))
    c2ws[:, :3, :3] = Rotation.from_quat(quats).as_matrix()
    c2ws[:, :3, 3] = rng.standard_normal((4, 3))
    np.testing.assert_array_equal(texport.mean_camera_pose(c2ws), jexport.mean_camera_pose(c2ws))
    args = (np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, -1.0, 0.0]))
    np.testing.assert_array_equal(texport.c2w_from_eye(*args), jexport.c2w_from_eye(*args))


def test_ground_truth_resolution_follows_jax(run, monkeypatch):
    """Without ``-r`` the ground truth loads at -1 (auto-downscale above
    1,600 px) while the session renders at the run's ``cfg_args``
    resolution: the JAX package's behaviour, kept."""
    source, model = run
    seen = {"jax": [], "port": []}

    class Stop(Exception):
        pass

    def spy(name, real):
        def load_image(cam_info, resolution, resolution_scale=1.0):
            seen[name].append(resolution)
            if cam_info.image_name == "000":      # the held-out view: the CLI's call
                raise Stop
            return real(cam_info, resolution, resolution_scale)

        return load_image

    monkeypatch.setattr(jscene, "load_image", spy("jax", jscene.load_image))
    monkeypatch.setattr(tscene, "load_image", spy("port", tscene.load_image))
    with pytest.raises(Stop):
        jcli.main(["-m", model, "--backend", "pallas"])
    with pytest.raises(Stop):
        tcli.main(["-m", model, "--backend", "pallas", "--device", "cpu"])
    # two training images at the cfg_args resolution, then the ground truth
    assert seen == {"jax": [1, 1, -1], "port": [1, 1, -1]}


def _eval_txt(model):
    out = {}
    with open(os.path.join(model, "eval.txt")) as f:
        for line in f:
            key, rest = line.strip().split(": ", 1)
            out[key] = dict(kv.split("=") for kv in rest.split())
    return out


def test_cli_evaluate_matches_jax(run):
    """Both CLIs on the same model dir, two pose-refinement iterations:
    the same ``eval.txt`` keys, PSNR and SSIM within 1e-3, the same
    artifacts."""
    _, model = run
    argv = ["-m", model, "--backend", "pallas", "--num_iter_per_view", "2"]
    want_res = jcli.main(argv)
    want = _eval_txt(model)
    os.remove(os.path.join(model, "eval.txt"))
    got_res = tcli.main(argv + ["--device", "cpu"])
    got = _eval_txt(model)
    assert got.keys() == want.keys() == {"unfit", "fit"}
    for k in got:
        assert got[k].keys() == want[k].keys() == {"PSNR", "SSIM", "LPIPS"}
        assert got[k]["LPIPS"] == want[k]["LPIPS"] == "None"
        for m in ("PSNR", "SSIM"):
            assert abs(float(got[k][m]) - float(want[k][m])) <= 1e-3, (k, m)
            np.testing.assert_allclose(got_res[k][m], want_res[k][m], rtol=1e-4)
    for split in ("unfit", "fit"):
        for kind in ("renders", "gt", "error"):
            assert os.path.exists(os.path.join(model, "test", split, kind, "000.png"))


def test_cli_without_a_held_out_split_raises(tmp_path, monkeypatch, capsys):
    """Without a held-out split both CLIs try COLMAP registration of
    ``test_images/``; with no ``colmap`` binary that raises inside, and
    both print why and return None (the name predates the port of
    ``initialize_test_pose``)."""
    from deblurgs_tpu.tools import colmap_pipeline as jcp
    from deblurgs_tpu_torch.tools import colmap_pipeline as tcp

    source, model = _write_run(str(tmp_path), eval_split=False)
    os.remove(os.path.join(source, "hold=3"))
    os.makedirs(os.path.join(source, "test_images"))
    for cp in (jcp, tcp):
        monkeypatch.setattr(cp, "colmap_available", lambda: False)
    argv = ["-m", model, "-s", source, "--backend", "pallas"]
    assert jcli.main(argv) is None
    want = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) is None
    got = capsys.readouterr().out
    assert "cannot register test poses" in got and "nothing to evaluate" in got
    assert [line for line in got.splitlines() if "test poses" in line or "nothing" in line] == [
        line for line in want.splitlines() if "test poses" in line or "nothing" in line]
    assert not os.path.exists(os.path.join(model, "eval.txt"))
