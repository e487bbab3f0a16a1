"""The port's host data path against the JAX package's: COLMAP parsers and
writers, PLY I/O, the scene readers (SceneInfo: R, T, FoV, split), the
scene assembly and resolution policy, and the on-disk formats that move
between the two packages in both directions: Gaussian snapshot PLYs and
the motion file ``cm.npz``.

Datasets come from ``tests/test_data.py``'s writers (64×48, seeded).
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.core import camera as jcam
from deblurgs_tpu.data import colmap as jcolmap
from deblurgs_tpu.data import gaussian_ply as jgply
from deblurgs_tpu.data import ply as jply
from deblurgs_tpu.data import readers as jreaders
from deblurgs_tpu.data import scene as jscene
from deblurgs_tpu.models import gaussians as jgm
from deblurgs_tpu.models import motion as jmm
from deblurgs_tpu.train import checkpoint as jckpt
from deblurgs_tpu_torch.core import camera as tcam
from deblurgs_tpu_torch.data import colmap as tcolmap
from deblurgs_tpu_torch.data import gaussian_ply as tgply
from deblurgs_tpu_torch.data import ply as tply
from deblurgs_tpu_torch.data import readers as treaders
from deblurgs_tpu_torch.data import scene as tscene
from deblurgs_tpu_torch.models import gaussians as tgm
from deblurgs_tpu_torch.models import motion as tmm
from deblurgs_tpu_torch.train import checkpoint as tckpt
from tests.test_data import write_colmap_binary, write_images
from tests.torch_bridge import gaussian_leaves, np_of


@pytest.fixture
def dataset(tmp_path):
    root = str(tmp_path / "scene")
    write_colmap_binary(os.path.join(root, "sparse", "0"), n_cams=4, n_pts=50)
    write_images(os.path.join(root, "images"), [f"{i:03d}.png" for i in range(4)])
    return root


def _as_text(root):
    """Rewrite a binary COLMAP scene as text with the port's writers
    (points3D.txt by hand: the packages have no points writer)."""
    sparse = os.path.join(root, "sparse", "0")
    cams = tcolmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    imgs = tcolmap.read_images_binary(os.path.join(sparse, "images.bin"))
    xyz, rgb, err = tcolmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    tcolmap.write_cameras_text(cams, os.path.join(sparse, "cameras.txt"))
    tcolmap.write_images_text(imgs, os.path.join(sparse, "images.txt"))
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n")
        for i, (p, c, e) in enumerate(zip(xyz, rgb, err)):
            f.write(f"{i} {' '.join(repr(float(v)) for v in p)} {c[0]} {c[1]} {c[2]} "
                    f"{float(e[0])!r} 0 0\n")
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        os.remove(os.path.join(sparse, name))


def _same(a, b, name=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), name
        for k in a:
            _same(a[k], b[k], f"{name}/{k}")
    elif isinstance(a, (tuple, list)) and not isinstance(a, str):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{name}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert a == b, name


def test_colmap_binary_parsers_match_jax(dataset):
    sparse = os.path.join(dataset, "sparse", "0")
    for fn in ("read_cameras_binary", "read_images_binary", "read_points3d_binary"):
        path = os.path.join(sparse, {"read_cameras_binary": "cameras.bin",
                                     "read_images_binary": "images.bin",
                                     "read_points3d_binary": "points3D.bin"}[fn])
        _same(getattr(tcolmap, fn)(path), getattr(jcolmap, fn)(path), fn)


def test_colmap_text_writers_and_parsers_match_jax(dataset, tmp_path):
    sparse = os.path.join(dataset, "sparse", "0")
    cams = jcolmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    imgs = jcolmap.read_images_binary(os.path.join(sparse, "images.bin"))
    for mod in (tcolmap, jcolmap):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        mod.write_cameras_text(cams, str(d / "cameras.txt"))
        mod.write_images_text(imgs, str(d / "images.txt"))
    for name in ("cameras.txt", "images.txt"):
        assert (tmp_path / "deblurgs_tpu_torch" / name).read_text() == \
            (tmp_path / "deblurgs_tpu" / name).read_text()
    path = str(tmp_path / "deblurgs_tpu_torch")
    _same(tcolmap.read_cameras_text(path + "/cameras.txt"),
          jcolmap.read_cameras_text(path + "/cameras.txt"))
    _same(tcolmap.read_images_text(path + "/images.txt"),
          jcolmap.read_images_text(path + "/images.txt"))


def test_qvec_rotmat_match_jax():
    rng = np.random.RandomState(3)
    for _ in range(5):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        R = jcolmap.qvec2rotmat(q)
        np.testing.assert_array_equal(tcolmap.qvec2rotmat(q), R)
        np.testing.assert_array_equal(tcolmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R))


def _assert_scene_info_equal(t, j):
    for split in ("train_cameras", "test_cameras"):
        tc, jc = getattr(t, split), getattr(j, split)
        assert [c.image_name for c in tc] == [c.image_name for c in jc], split
        for a, b in zip(tc, jc):
            for key in ("uid", "FovX", "FovY", "image_path", "width", "height"):
                assert getattr(a, key) == getattr(b, key), key
            np.testing.assert_array_equal(a.R, b.R)
            np.testing.assert_array_equal(a.T, b.T)
    for a, b in zip(t.point_cloud, j.point_cloud):
        np.testing.assert_array_equal(a, b)
    assert t.nerf_normalization == j.nerf_normalization
    assert t.ply_path == j.ply_path


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_colmap_scene_info_matches_jax(dataset, fmt):
    """With the ``hold=2`` marker: the ``int(name) % 2`` split, the same
    R, T and FoV, point cloud and radius (``readers.py:194-203``)."""
    if fmt == "text":
        _as_text(dataset)
    open(os.path.join(dataset, "hold=2"), "w").close()
    t = treaders.read_colmap_scene(dataset, eval_split=True)
    j = jreaders.read_colmap_scene(dataset, eval_split=True)
    assert [c.image_name for c in t.test_cameras] == ["000", "002"]
    _assert_scene_info_equal(t, j)


def test_colmap_pruning_and_random_init_match_jax(dataset):
    for kw in (dict(num_initial_pcd=20), dict(random_init=True)):
        _assert_scene_info_equal(treaders.read_colmap_scene(dataset, **kw),
                                 jreaders.read_colmap_scene(dataset, **kw))
    with pytest.raises(ValueError, match="together"):
        treaders.read_colmap_scene(dataset, eval_split=True)


def test_blender_scene_matches_jax(tmp_path):
    root = str(tmp_path / "blender")
    os.makedirs(os.path.join(root, "train"))
    write_images(os.path.join(root, "train"), ["r_0.png", "r_1.png"], w=32, h=32)
    frames = []
    rng = np.random.RandomState(0)
    for i in range(2):
        c2w = np.eye(4)
        c2w[:3, 3] = rng.randn(3) + [0, 0, 4]
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    t = treaders.load_scene_info(root, white_background=True)
    j = jreaders.load_scene_info(root, white_background=True)
    _assert_scene_info_equal(t, j)
    for a, b in zip(t.train_cameras, j.train_cameras):
        np.testing.assert_array_equal(np.asarray(a.image), np.asarray(b.image))


def test_point_cloud_ply_moves_both_ways(tmp_path):
    xyz = np.random.RandomState(0).randn(10, 3).astype(np.float32)
    rgb = np.random.RandomState(1).randint(0, 255, (10, 3))
    for writer, reader in ((tply, jply), (jply, tply)):
        path = str(tmp_path / f"{writer.__name__}.ply")
        writer.store_point_cloud(path, xyz, rgb)
        for a, b in zip(reader.fetch_point_cloud(path), tply.fetch_point_cloud(path)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tply.read_ply(path)["x"], xyz[:, 0])
    assert (tmp_path / "deblurgs_tpu_torch.data.ply.ply").read_bytes() == \
        (tmp_path / "deblurgs_tpu.data.ply.ply").read_bytes()


def _gaussians(n=20, capacity=32, sh_degree=2, seed=7):
    leaves = gaussian_leaves(seed, n=n, sh_deg=sh_degree)
    leaves["params/opacity"] = np.clip(leaves["params/opacity"], 0.05, 0.9)
    pad = capacity - n
    for key, x in leaves.items():
        leaves[key] = np.concatenate([x, np.zeros((pad,) + x.shape[1:], np.float32)])
    leaves["params/rotation"][n:, 0] = 1.0
    return leaves, np.arange(capacity) < n


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_gaussian_ply_moves_both_ways(tmp_path, direction):
    """A snapshot written by one package loads in the other unchanged:
    the same file bytes from both writers, and the same leaves (raw
    opacity and scale pass through the disk's sigmoid/log encoding, so
    they are compared as the loader of either package gives them)."""
    leaves, active = _gaussians()
    jcfg, tcfg = jgm.GaussianConfig(sh_degree=2), tgm.GaussianConfig(sh_degree=2)
    jp = jgm.GaussianParams(*(jnp.asarray(leaves[f"params/{k}"]) for k in jgm.GaussianParams._fields))
    zeros = np.zeros(active.shape[0], np.float32)
    ja = jgm.GaussianAux(jnp.asarray(active), *(jnp.asarray(zeros),) * 3)
    tp = tgm.GaussianParams(*(torch.from_numpy(leaves[f"params/{k}"])
                              for k in tgm.GaussianParams._fields))
    ta = tgm.GaussianAux(torch.from_numpy(active), *(torch.from_numpy(zeros) for _ in range(3)))
    jpath, tpath = str(tmp_path / "j" / "pc.ply"), str(tmp_path / "t" / "pc.ply")
    jgply.save_gaussian_ply(jpath, jp, ja, jcfg)
    tgply.save_gaussian_ply(tpath, tp, ta, tcfg)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    path = jpath if direction == "jax_to_port" else tpath
    got_p, got_a = tgply.load_gaussian_ply(path, tcfg, capacity=40, device="cpu")
    want_p, want_a = jgply.load_gaussian_ply(path, jcfg, capacity=40)
    for k in tgm.GaussianParams._fields:
        # scaling is a log taken by torch and by XLA: one ulp apart at most
        np.testing.assert_allclose(np_of(getattr(got_p, k)), np_of(getattr(want_p, k)),
                                   rtol=2e-7, atol=0, err_msg=k)
    for k in tgm.GaussianAux._fields:
        np.testing.assert_array_equal(np_of(getattr(got_a, k)), np_of(getattr(want_a, k)),
                                      err_msg=k)
    assert int(got_a.active.sum()) == 20
    np.testing.assert_allclose(np_of(tgm.get_opacity(got_p, tcfg))[:20],
                               np.clip(leaves["params/opacity"][:20], 0, 1), atol=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_motion_file_moves_both_ways(tmp_path, direction):
    rng = np.random.default_rng(2)
    arrays = dict(rot_ctrl=rng.standard_normal((3, 10, 3)).astype(np.float32),
                  trans_ctrl=rng.standard_normal((3, 10, 3)).astype(np.float32),
                  nu=rng.standard_normal((3, 19)).astype(np.float32))
    path = str(tmp_path / "cm.npz")
    if direction == "jax_to_port":
        jckpt.save_motion(path, jmm.MotionParams(**{k: jnp.asarray(v) for k, v in arrays.items()}))
        got = tckpt.load_motion(path, device="cpu")
    else:
        tckpt.save_motion(path, tmm.MotionParams(**{k: torch.from_numpy(v)
                                                    for k, v in arrays.items()}))
        got = jckpt.load_motion(path)
    with np.load(path) as d:
        assert sorted(d.files) == sorted(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(np_of(getattr(got, k)), v, err_msg=k)


def test_resolution_policy_matches_jax():
    for w, h in ((1600, 1200), (3200, 2400), (800, 600), (1920, 1080), (1001, 777)):
        for r in (1, 2, 4, 8, -1, 400, 1000):
            assert tscene.resolve_resolution(w, h, r) == jscene.resolve_resolution(w, h, r)
    assert tscene.resolve_resolution(1920, 1080, -1) == (1600, 900)


def test_scene_assembly_matches_jax(dataset, tmp_path):
    kw = dict(resolution=2, eval_split=True, llffhold=2, shuffle=False)
    t = tscene.Scene(dataset, str(tmp_path / "tm"), **kw)
    j = jscene.Scene(dataset, str(tmp_path / "jm"), **kw)
    np.testing.assert_array_equal(t.train_images, j.train_images)
    assert t.train_images.shape == (2, 24, 32, 3)
    assert t.camera_static == tcam.CameraStatic(**vars(j.camera_static))
    np.testing.assert_array_equal(t.proj, np.asarray(j.proj))
    np.testing.assert_array_equal(t.rotations, j.rotations)
    np.testing.assert_array_equal(t.centers, j.centers)
    assert t.cameras_extent == j.cameras_extent
    for name in ("cameras.json", "input.ply"):
        assert (tmp_path / "tm" / name).read_bytes() == (tmp_path / "jm" / name).read_bytes()
    assert [t.get_random_cam_idx() for _ in range(4)] == [j.get_random_cam_idx() for _ in range(4)]
    for c in t.info.test_cameras:
        np.testing.assert_array_equal(tscene.load_image(c, -1), jscene.load_image(c, -1))


def test_search_max_iteration_matches_jax(tmp_path):
    for it in (7, 30000, 500):
        (tmp_path / f"iteration_{it}").mkdir()
    assert tscene.Scene.search_max_iteration(str(tmp_path)) == 30000
    assert jscene.Scene.search_max_iteration(str(tmp_path)) == 30000


def test_camera_helpers_match_jax():
    R = jcolmap.qvec2rotmat(np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3, 0.2]))
    t = np.array([0.3, -1.0, 2.5])
    np.testing.assert_array_equal(tcam.world2view(R, t), jcam.world2view(R, t))
    for fov, px in ((0.8, 64), (1.2, 1920)):
        assert tcam.fov2focal(fov, px) == jcam.fov2focal(fov, px)
        assert tcam.focal2fov(60.0, px) == jcam.focal2fov(60.0, px)
    assert math.isclose(tcam.focal2fov(tcam.fov2focal(0.7, 48), 48), 0.7)
    info = treaders.CameraInfo(uid=0, R=R, T=t, FovY=0.6, FovX=0.8, image=None,
                               image_path="", image_name="000", width=64, height=48)
    assert tscene.camera_to_json(3, info) == jscene.camera_to_json(3, info)
