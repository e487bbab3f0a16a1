"""The port's training CLI end to end on the CPU, final render included;
runs and checkpoints read across packages in both directions; the render
CLIs' frames and the metrics CLI against JAX's on the same trained run; a
view past the session's pair budget growing it.

The dataset is ``tests/test_data.py``'s synthetic COLMAP scene (3 cameras,
40 points, 64×48) trained with ``tests/test_loop.py``'s flags (the port has
only the pallas backend, so without ``--backend xla``). JAX renders that
run with its exact per-pixel oracle: its XLA and Pallas paths misplace the
pair of a first non-empty tile that holds one pair
(test_searchsorted_right_on_power_of_two_lengths), and view 2 of this run
has one.
"""

import json
import os
import re
import shutil
from argparse import ArgumentParser

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from deblurgs_tpu.cli import args as jargs
from deblurgs_tpu.cli import metrics as jmetrics
from deblurgs_tpu.cli import render_spiral as jspiral
from deblurgs_tpu.cli import render_trainview as jtrainview
from deblurgs_tpu.cli import train as jcli
from deblurgs_tpu.data.scene import Scene as JScene
from deblurgs_tpu.eval import export as jexport
from deblurgs_tpu.eval import session as jsession
from deblurgs_tpu.train import checkpoint as jckpt
from deblurgs_tpu.train import loop as jloop
from deblurgs_tpu_torch.cli import metrics as tmetrics
from deblurgs_tpu_torch.cli import render_spiral as tspiral
from deblurgs_tpu_torch.cli import render_trainview as ttrainview
from deblurgs_tpu_torch.cli import train as tcli
from deblurgs_tpu_torch.data import scene as tscene
from deblurgs_tpu_torch.eval import export as texport
from deblurgs_tpu_torch.eval import pose_opt as tpose
from deblurgs_tpu_torch.eval import session as tsession
from deblurgs_tpu_torch.models import gaussians as tgm
from deblurgs_tpu_torch.train import checkpoint as tckpt
from tests.test_data import write_colmap_binary, write_images

torch.set_num_threads(1)

# tests/test_loop.py::test_cli_end_to_end's flags without --backend xla
FLAGS = ["--iterations", "30", "--curve_start_iter", "10", "--densify_from_iter", "12",
         "--densification_interval", "10", "--densify_until_iter", "25",
         "--opacity_reset_interval", "1000", "--num_subframes", "3", "--curve_order", "2",
         "--max_pairs", str(1 << 12), "--save_iterations", "20", "--checkpoint_iterations",
         "20", "--resolution", "1"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A 30-iteration run of the port's training CLI on the CPU, the final
    render's child processes included (one thread each)."""
    root = tmp_path_factory.mktemp("cli")
    source, model = str(root / "scene"), str(root / "model")
    write_colmap_binary(os.path.join(source, "sparse", "0"), n_cams=3, n_pts=40)
    write_images(os.path.join(source, "images"), [f"{i:03d}.png" for i in range(3)],
                 w=48, h=36)
    env = pytest.MonkeyPatch()
    env.setenv("OMP_NUM_THREADS", "1")
    try:
        state = tcli.main(["-s", source, "-m", model, *FLAGS, "--device", "cpu"])
    finally:
        env.undo()
    return source, model, state


def test_cli_end_to_end(port_run):
    """The artifacts of tests/test_loop.py::test_cli_end_to_end, the
    visualizer's video and the children's outputs."""
    source, model, state = port_run
    assert state.step == 31 and int(state.overflow_count) == 0
    for name in ("args.txt", "cfg_args", "input.ply", "cameras.json", "time.txt", "cm.npz",
                 "chkpnt20.npz", "point_cloud/iteration_20/point_cloud.ply",
                 "point_cloud/iteration_30/point_cloud.ply"):
        assert os.path.exists(os.path.join(model, name)), name
    videos = [f for f in os.listdir(os.path.join(model, "vis")) if f.startswith("training.")]
    assert videos and videos[0] in ("training.mp4", "training.gif")
    spiral = os.listdir(os.path.join(model, "spiral", "iteration_30"))
    assert {os.path.splitext(f)[0] for f in spiral} == {"spiral_rgb", "spiral_depth"}
    trainview = sorted(os.listdir(os.path.join(model, "trainview", "iteration_30")))
    assert trainview[:3] == ["000.png", "001.png", "002.png"]
    assert Image.open(os.path.join(model, "trainview", "iteration_30", "000.png")).size == (128, 48)
    with open(os.path.join(model, "time.txt")) as f:
        assert f.read().splitlines()[1] == "Overflowed iterations = 0"
    with open(os.path.join(model, "cfg_args")) as f:
        cfg = f.read()
    assert "backend='pallas'" in cfg and "device='cpu'" in cfg


def _jax_template(source, capacity: int):
    """A JAX train state of the run's configuration at ``capacity`` slots."""
    parser = ArgumentParser()
    lp, op = jargs.ModelParams(parser), jargs.OptimizationParams(parser)
    ns, _ = parser.parse_known_args(["-s", source, "-m", "unused", *FLAGS])
    gcfg, mcfg, ocfg, rcfg = jcli.build_configs(lp.extract(ns), op.extract(ns))
    trainer = jloop.Trainer(scene=JScene(source, None, resolution=1), gcfg=gcfg, mcfg=mcfg,
                            ocfg=ocfg, rcfg=rcfg)
    return trainer.init_state(capacity=capacity)[0]


def _assert_sessions_equal(t, j):
    assert t.iteration == j.iteration and t.tone_mapping == j.tone_mapping
    for name in t.params._fields:
        np.testing.assert_allclose(getattr(t.params, name).numpy(),
                                   np.asarray(getattr(j.params, name)), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_array_equal(t.aux.active.numpy(), np.asarray(j.aux.active))
    for name in t.motion._fields:
        np.testing.assert_array_equal(getattr(t.motion, name).numpy(),
                                      np.asarray(getattr(j.motion, name)), err_msg=name)


def test_port_run_loads_in_jax(port_run):
    """JAX's ``load_session`` reads the port run's ``cfg_args``, PLY and
    ``cm.npz``, and its ``load_checkpoint`` the port's checkpoint, leaf for
    leaf."""
    source, model, _ = port_run
    j = jsession.load_session(model, source, backend="xla")
    t = tsession.load_session(model, source, device="cpu")
    assert j.rcfg.tile_w == t.rcfg.tile_w == 32 and j.rcfg.layout == t.rcfg.layout == "mixed"
    _assert_sessions_equal(t, j)
    path = os.path.join(model, "chkpnt20.npz")
    want = tckpt.state_to_arrays(tckpt.load_checkpoint(path, device="cpu"))
    got = jckpt._flatten(jckpt.load_checkpoint(
        path, _jax_template(source, want["params/xyz"].shape[0])))
    assert got.keys() == want.keys() and int(got["step"]) == 21
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), value, err_msg=key)


def test_jax_run_loads_in_port(port_run, tmp_path):
    """A run of JAX's training CLI reads back in the port's session and
    checkpoint readers."""
    source = port_run[0]
    model = str(tmp_path / "jax_model")
    jstate = jcli.main(["-s", source, "-m", model, "--iterations", "2", "--curve_start_iter",
                        "1", "--num_subframes", "3", "--curve_order", "2", "--backend", "xla",
                        "--max_pairs", str(1 << 12), "--save_iterations", "2",
                        "--checkpoint_iterations", "2", "--resolution", "1",
                        "--skip_final_render", "--disable_curve_visualize"])
    _assert_sessions_equal(tsession.load_session(model, source, backend="pallas", device="cpu"),
                           jsession.load_session(model, source))
    got = tckpt.state_to_arrays(tckpt.load_checkpoint(os.path.join(model, "chkpnt2.npz"),
                                                      device="cpu"))
    want = jckpt._flatten(jstate)
    assert got.keys() == want.keys() and int(got["step"]) == 3
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)


def _copy_run(model, dst):
    shutil.copytree(model, dst, ignore=shutil.ignore_patterns("spiral", "trainview", "vis"))
    return str(dst)


def _within_one_level(got, want, name):
    assert got.shape == want.shape, name
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


def test_render_trainview_matches_jax(port_run, tmp_path):
    """Each image's mid-trajectory render beside its ground truth: the
    port's PNGs against JAX's, within one 8-bit level."""
    source, model, _ = port_run
    jdir = jtrainview.render_sets(_copy_run(model, tmp_path / "j"), source, backend="oracle")
    tdir = ttrainview.render_sets(_copy_run(model, tmp_path / "t"), source, device="cpu")
    names = sorted(f for f in os.listdir(jdir) if f.endswith(".png"))
    assert names == sorted(f for f in os.listdir(tdir) if f.endswith(".png"))
    assert len(names) == 3
    for name in names:
        _within_one_level(np.asarray(Image.open(os.path.join(tdir, name))),
                          np.asarray(Image.open(os.path.join(jdir, name))), name)


def test_a_view_past_the_budget_grows_it(port_run, tmp_path):
    """A view that emits more pairs than the session's budget renders at a
    budget grown to the next power of two above 1.5× its pairs, exactly as
    at a budget that holds them (JAX's session composites a truncated list
    there): ``render_trainview`` on a copy of the run whose ``cfg_args``
    holds 64 slots writes the run's own PNGs, and two pose-refinement steps
    from a view's nominal pose land on the same pose. The grown budget
    stays for later views."""
    source, model, _ = port_run
    small = _copy_run(model, tmp_path / "small")
    path = os.path.join(small, "cfg_args")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(re.sub(r"max_pairs=\d+", "max_pairs=64", text))
    want_dir = ttrainview.render_sets(_copy_run(model, tmp_path / "full"), source, device="cpu")
    got_dir = ttrainview.render_sets(small, source, device="cpu")
    names = sorted(f for f in os.listdir(want_dir) if f.endswith(".png"))
    assert len(names) == 3 and names == sorted(
        f for f in os.listdir(got_dir) if f.endswith(".png"))
    for name in names:
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(got_dir, name))),
                                      np.asarray(Image.open(os.path.join(want_dir, name))))

    full = tsession.load_session(model, source, device="cpu")
    tight = tsession.load_session(small, source, device="cpu")
    info = full.scene.info.train_cameras[0]
    R, T = (torch.from_numpy(np.asarray(x, np.float32)[None]) for x in (info.R, info.T))
    proj = torch.from_numpy(full.scene.proj)
    cam = tpose.pose_to_camera(tpose.init_pose_params(R, T), 0, proj)
    n = int(tsession.render_fitted(full, tgm.render_inputs(full.params, full.gcfg), cam,
                                   torch.zeros(3)).num_pairs)
    assert 64 < n <= full.rcfg.max_pairs and tight.rcfg.max_pairs == 64
    gt = torch.from_numpy(tscene.load_image(info, -1)[None])
    kw = dict(num_iter_per_view=2, verbose=False, orders=[[0], [0]])
    want = tpose.optimize_test_poses(full, gt, R, T, proj, **kw)
    got = tpose.optimize_test_poses(tight, gt, R, T, proj, **kw)
    assert tight.rcfg.max_pairs == 1 << int(np.ceil(np.log2(1.5 * n)))
    assert torch.equal(got.quat, want.quat) and torch.equal(got.trans, want.trans)
    assert not torch.equal(got.trans, T)


def test_render_spiral_matches_jax(port_run, tmp_path, monkeypatch):
    """The spiral path's RGB frames (pivot, look-at depth, circle) against
    JAX's, within one 8-bit level; three frames a turn, two turns."""
    source, model, _ = port_run
    videos = {"jax": {}, "port": {}}

    def capture(name):
        def make_video(imgs, path, fps=32):
            videos[name][os.path.basename(path)] = [np.asarray(i) for i in imgs]
            return path
        return make_video

    monkeypatch.setattr(jexport, "make_video", capture("jax"))
    monkeypatch.setattr(texport, "make_video", capture("port"))
    jspiral.render_sets(_copy_run(model, tmp_path / "j"), source, n_frames=3,
                        backend="oracle")
    tspiral.render_sets(_copy_run(model, tmp_path / "t"), source, n_frames=3, device="cpu")
    assert videos["port"].keys() == videos["jax"].keys() == {"spiral_rgb.mp4",
                                                             "spiral_depth.mp4"}
    frames = zip(videos["port"]["spiral_rgb.mp4"], videos["jax"]["spiral_rgb.mp4"])
    for i, (got, want) in enumerate(frames):
        _within_one_level(got, want, f"frame {i}")
    assert len(videos["port"]["spiral_rgb.mp4"]) == len(videos["port"]["spiral_depth.mp4"]) == 6


def test_searchsorted_right_on_power_of_two_lengths():
    """Tile ranges come from a search over the sorted tile ids, whose
    length (``max_pairs``) the pair budget makes a power of two. The port
    returns numpy's answer; JAX's unrolled search runs one round short
    there and cannot return 1, so a first non-empty tile with one pair
    comes back empty and its pair lands in the next tile's range."""
    from deblurgs_tpu.ops import binning as jbin
    from deblurgs_tpu_torch.ops import binning as tbin

    tiles = np.array([0, 1, 1, 2, 3, 3, 4, 4], np.int32)          # tile 0 holds one pair
    q = np.arange(-1, 5, dtype=np.int32)
    want = np.searchsorted(tiles, q, side="right")
    got = tbin.searchsorted_right(torch.from_numpy(tiles).long(), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    jgot = np.asarray(jbin.searchsorted_right(jax.numpy.asarray(tiles), jax.numpy.asarray(q)))
    assert want[1] == 1 and jgot[1] == 0 and (jgot[2:] == want[2:]).all()


def test_metrics_cli_matches_jax(tmp_path):
    """``results.json`` and ``per_view.json`` over two methods' render / GT
    directories, against JAX's metrics CLI."""
    rng = np.random.default_rng(4)
    for method in ("fit", "unfit"):
        for kind in ("renders", "gt"):
            os.makedirs(tmp_path / "t" / "test" / method / kind)
            for i in range(2):
                Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(
                    tmp_path / "t" / "test" / method / kind / f"{i:03d}.png")
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    jmetrics.main(["-m", str(tmp_path / "j")])
    out = tmetrics.main(["-m", str(tmp_path / "t"), "--device", "cpu"])
    assert set(out[str(tmp_path / "t")]) == {"fit", "unfit"}
    for name in ("results.json", "per_view.json"):
        with open(tmp_path / "t" / name) as f:
            got = json.load(f)
        with open(tmp_path / "j" / name) as f:
            want = json.load(f)
        flat = lambda d: {k: v for k, v in jax.tree_util.tree_leaves_with_path(d)}  # noqa: E731
        g, w = flat(got), flat(want)
        assert g.keys() == w.keys(), name
        for key, value in w.items():
            if value is None:
                assert g[key] is None, key
            else:
                assert abs(g[key] - value) <= 1e-5, (name, key, g[key], value)
