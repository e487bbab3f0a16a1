"""The port's native host library (``deblurgs_tpu_torch/native``) and its
k-NN paths against the JAX package's: the build, exact 3-NN on a Gaussian
and a clustered cloud, the COLMAP ``points3D.bin`` parser (mirroring
``tests/test_native.py``), and the Morton-window search and Morton codes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.data import colmap as jcolmap
from deblurgs_tpu.ops import knn as jknn
from deblurgs_tpu_torch import native
from deblurgs_tpu_torch.data import colmap as tcolmap
from deblurgs_tpu_torch.ops import knn as tknn
from tests.test_data import write_colmap_binary

torch.set_num_threads(1)


def test_builds():
    """g++ is on this host: the library builds into build/ and loads."""
    assert native.available()
    assert os.path.exists(native._library_path(native.FLAG_SETS[0]))


def _clouds():
    gauss = np.array(jax.random.normal(jax.random.PRNGKey(0), (5000, 3)), np.float32)
    rng = np.random.RandomState(0)
    clustered = np.concatenate([rng.randn(3000, 3) * 0.01,
                                rng.randn(200, 3) * 5.0]).astype(np.float32)
    return {"gaussian": gauss, "clustered": clustered}


@pytest.mark.parametrize("cloud", ["gaussian", "clustered"])
def test_knn3_matches_exact(cloud):
    """Native host search and the port's exact on-device pass against JAX's
    exact pass; the clustered cloud (non-uniform density) is the grid's
    hard case."""
    pts = _clouds()[cloud]
    ref = np.asarray(jknn._exact_knn3_mean_sq(jnp.asarray(pts)))
    np.testing.assert_allclose(native.knn3_mean_sq(pts), ref, rtol=1e-4)
    got = tknn.knn3_mean_sq_dist(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_points3d_parse_parity(tmp_path):
    """The native parser, the port's reader (which tries it first) and the
    per-record Python loop give the same arrays, bit for bit, as JAX's."""
    sparse = str(tmp_path / "sparse")
    write_colmap_binary(sparse, n_cams=2, n_pts=77)
    path = os.path.join(sparse, "points3D.bin")
    out = native.parse_points3d_bin(path)
    assert out is not None and out[0].shape == (77, 3)
    want = jcolmap.read_points3d_binary(path)
    reader = tcolmap.read_points3d_binary(path)
    loop = tcolmap.read_points3d_binary_python(path)
    for got in (out, reader, loop):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_reader_falls_back_without_the_library(tmp_path, monkeypatch):
    """With no library the reader takes the Python loop, same arrays."""
    sparse = str(tmp_path / "sparse")
    write_colmap_binary(sparse, n_cams=2, n_pts=31)
    path = os.path.join(sparse, "points3D.bin")
    monkeypatch.setattr(native, "parse_points3d_bin", lambda p: None)
    for g, w in zip(tcolmap.read_points3d_binary(path), jcolmap.read_points3d_binary(path)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("window", [4, 24])
def test_window_knn_matches_jax(window):
    """The Morton-window search against JAX's ``_window_knn3_mean_sq``
    (rtol 1e-6), and the Morton codes bit for bit, on a clustered cloud
    with repeated points (equal codes)."""
    pts = _clouds()["clustered"][::2].copy()
    pts[100:110] = pts[100]
    got = tknn.knn3_mean_sq_dist(torch.from_numpy(pts), method="approx", window=window)
    want = np.asarray(jknn.knn3_mean_sq_dist(jnp.asarray(pts), method="approx", window=window))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(tknn.morton_codes(torch.from_numpy(pts)).numpy(),
                                  np.asarray(jknn.morton_codes(jnp.asarray(pts))).astype(np.int64))
