"""The port's training observability (``utils/visualizer.py``,
``utils/profiling.py``) and ``eval/export.py::make_video`` against the JAX
package's, mirroring tests/test_visualizer.py: the zoom-out camera, the
frustum cones' pixels, the overview shot and its video, the alignment
plot, the trajectory dumps and the profiler trace.

Scene: ``tests/test_data.py``'s synthetic COLMAP scene (3 cameras, 25
points, 64×48), curves of order 2 over 3 sub-frames; both packages start
from JAX's state. JAX renders with its XLA backend (as its own visualizer
test does), the port with the pallas path's plain versions.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from deblurgs_tpu.data.scene import Scene as JScene
from deblurgs_tpu.models import gaussians as jgm
from deblurgs_tpu.models import motion as jmm
from deblurgs_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from deblurgs_tpu.train import checkpoint as jckpt
from deblurgs_tpu.train import step as jstep
from deblurgs_tpu.utils import visualizer as jvis
from deblurgs_tpu_torch.data.scene import Scene as TScene
from deblurgs_tpu_torch.eval import export as texport
from deblurgs_tpu_torch.models import gaussians as tgm
from deblurgs_tpu_torch.models import motion as tmm
from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
from deblurgs_tpu_torch.train import checkpoint as tckpt
from deblurgs_tpu_torch.utils import profiling, visualizer as tvis
from tests.test_data import write_colmap_binary, write_images

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vis")
    source = str(tmp / "scene")
    write_colmap_binary(os.path.join(source, "sparse", "0"), n_cams=3, n_pts=25)
    write_images(os.path.join(source, "images"), [f"{i:03d}.png" for i in range(3)], w=64, h=48)
    jscene, tscene = JScene(source, None, resolution=1), TScene(source, None, resolution=1)
    jg, tg = jgm.GaussianConfig(sh_degree=1), tgm.GaussianConfig(sh_degree=1)
    jm = jmm.MotionConfig(curve_order=2, n_subframes=3)
    tm = tmm.MotionConfig(curve_order=2, n_subframes=3)
    params, aux = jgm.create_from_pcd(jnp.asarray(jscene.info.point_cloud.points),
                                      jnp.asarray(jscene.info.point_cloud.colors), jg, capacity=32)
    motion = jmm.init_motion(jnp.asarray(jscene.rotations, jnp.float32),
                             jnp.asarray(jscene.centers, jnp.float32), jm, jax.random.PRNGKey(0),
                             init_noise=0.05)
    jstate = jstep.init_state(params, motion, aux, jax.random.PRNGKey(1))
    tstate = tckpt.state_from_arrays(jckpt._flatten(jstate), device="cpu")

    def make(model, **kw):
        j = jvis.Visualizer(jscene, jg, jm, JRasterizeConfig(backend="xla", max_pairs=1 << 12,
                                                             k_max=128),
                            str(tmp / model / "jax"), **kw)
        t = tvis.Visualizer(tscene, tg, tm,
                            RasterizeConfig(max_pairs=1 << 12, need_n_contrib=False),
                            str(tmp / model / "port"), device="cpu", **kw)
        return j, t

    return make, jstate, tstate


def test_vis_camera_matches_jax(setup):
    """The zoom-out search's camera, and the focus camera of ``vis_cam_idx``."""
    make, _, _ = setup
    for kw in ({}, {"vis_cam_idx": 1}):
        j, t = make("cam", total_iterations=100, **kw)
        jc, tc = j._get_vis_camera(), t._get_vis_camera()
        for name in ("view", "full_proj", "campos"):
            np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                       atol=1e-5, err_msg=f"{kw} {name}")


def _jax_cones(vis, state, cam):
    """The cone pixels JAX's ``Visualizer.run`` draws (its loop, without
    the drawing)."""
    cs = vis.scene.camera_static
    cone_local = np.array([[0.0, 0.0, 0.0], [cs.tanfovx, cs.tanfovy, 1.0],
                           [cs.tanfovx, -cs.tanfovy, 1.0], [-cs.tanfovx, -cs.tanfovy, 1.0],
                           [-cs.tanfovx, cs.tanfovy, 1.0]]) * vis.camera_scale
    out = []
    for i in range(vis.scene.num_train):
        nu = jmm.sample_nu(state.motion, i, vis.mcfg)
        rots, centers = jmm.sample_c2w(state.motion, i, nu, vis.mcfg)
        for r, c in zip(np.asarray(rots), np.asarray(centers)):
            world = cone_local @ r.T + c
            uv, _ = vis._project(cam, world)
            hom = np.concatenate([world, np.ones((5, 1))], -1)
            if np.any((hom @ np.asarray(cam.view))[:, 2] < 0.1):
                continue
            out.append((i, uv.astype(int)))
    return out


def test_cones_and_overview_shot(setup):
    """Every sub-frame's frustum cone projects to JAX's pixels (from the
    same overview camera); the shot is taken on schedule only and stitched
    into a video."""
    make, jstate, tstate = setup
    j, t = make("shot", total_iterations=100, n_shots=10, sh_degree=1)
    cam = j._get_vis_camera()
    want = _jax_cones(j, jstate, cam)
    got = t.cones(tstate, t._get_vis_camera())
    assert len(got) == len(want) > 0
    for (ti, tp), (ji, jp) in zip(got, want):
        assert ti == ji
        np.testing.assert_array_equal(tp, jp)
    assert t.shot_iters == j.shot_iters
    it = t.shot_iters[1]
    img = t.run(it, tstate)
    assert img is not None and img.shape == (48, 64, 3) and img.dtype == np.uint8
    assert t.run(it + 1, tstate) is None
    path = t.save_video()
    assert path is not None and os.path.exists(path)


def test_alignment_plot_is_written(setup):
    make, _, tstate = setup
    _, t = make("align", total_iterations=100)
    path = t.visualize_alignment(5, tstate)
    assert os.path.basename(path) == "alignment_000005.png"
    assert Image.open(path).size == (720, 720)


def test_traj_render_matches_jax(setup):
    """``blur.png``, ``gt.png`` and the jet ``error.png`` within one 8-bit
    level of JAX's; the sub-frame dumps at the same indices."""
    make, jstate, tstate = setup
    j, t = make("traj", total_iterations=100)
    jdir, tdir = j.traj_render(7, jstate, cam_idx=1), t.traj_render(7, tstate, cam_idx=1)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in sorted(os.listdir(jdir)):
        got = np.asarray(Image.open(os.path.join(tdir, name))).astype(int)
        want = np.asarray(Image.open(os.path.join(jdir, name))).astype(int)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1, name


def test_make_video_without_imageio_writes_a_gif(tmp_path, monkeypatch):
    """On a host without imageio the frames go to an animated GIF at the
    same stem through PIL, each frame exact (at most 256 colours)."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    rng = np.random.default_rng(2)
    palette = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    frames = [palette[rng.integers(0, 200, (36, 48))] for _ in range(4)]
    path = texport.make_video(frames, str(tmp_path / "clip.mp4"), fps=10)
    assert path == str(tmp_path / "clip.gif") and not os.path.exists(tmp_path / "clip.mp4")
    gif = Image.open(path)
    back = [np.asarray(frame.convert("RGB")) for frame in ImageSequence.Iterator(gif)]
    assert len(back) == 4 and gif.info["duration"] == 100
    for got, want in zip(back, frames):
        np.testing.assert_array_equal(got, want)


def test_profiler_trace_is_written(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert any(name.endswith(".pt.trace.json") for name in os.listdir(tmp_path / "trace"))
