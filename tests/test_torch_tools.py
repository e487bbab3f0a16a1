"""The port's COLMAP tools (``tools/colmap_pipeline.py`` and the
``colmap_reorder`` / ``triangulate`` CLIs) against the JAX package's,
mirroring ``tests/test_tools.py``: each test runs both packages on copies
of the same inputs and requires every file they write to be byte for byte
the same. The ``colmap`` binary is simulated where a pipeline needs it;
without it ``_require_colmap`` raises in both.
"""

import os
import shutil
import sqlite3

import numpy as np
import pytest
from PIL import Image

from deblurgs_tpu.cli import colmap_reorder as jreorder
from deblurgs_tpu.cli import triangulate as jtri
from deblurgs_tpu.data.readers import CameraInfo as JCameraInfo
from deblurgs_tpu.tools import colmap_pipeline as jcp
from deblurgs_tpu_torch.cli import colmap_reorder as treorder
from deblurgs_tpu_torch.cli import triangulate as ttri
from deblurgs_tpu_torch.data.colmap import qvec2rotmat, read_images_text
from deblurgs_tpu_torch.data.readers import CameraInfo as TCameraInfo
from deblurgs_tpu_torch.tools import colmap_pipeline as tcp


def _write_images(images_dir, names, w=8, h=6):
    os.makedirs(images_dir, exist_ok=True)
    for n in names:
        Image.fromarray(np.full((h, w, 3), 128, np.uint8)).save(os.path.join(images_dir, n))


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(tmp_path, make_inputs, run):
    """Make the same inputs under jax/ and port/, run each package on its
    copy, and require byte-equal trees; returns the port's root."""
    roots = {}
    for name, mod in (("jax", jcp), ("port", tcp)):
        root = str(tmp_path / name)
        os.makedirs(root)
        make_inputs(root)
        run(mod, root)
        roots[name] = root
    want, got = _tree(roots["jax"]), _tree(roots["port"])
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == want[k], k
    return roots["port"]


def test_black_keeps_features(tmp_path):
    """Reference semantics (run_colmap.py:317-330): user-mask BLACK pixels →
    255 (keep) in the COLMAP mask, everything else → 0."""
    m = np.zeros((6, 8, 3), np.uint8)
    m[:3] = 255

    def make(root):
        _write_images(os.path.join(root, "res", "images"), ["a.png", "b.png"])
        os.makedirs(os.path.join(root, "masks"))
        for n in ("a.png", "b.png"):
            Image.fromarray(m).save(os.path.join(root, "masks", n))

    root = _both(tmp_path, make, lambda cp, r: cp.prepare_masks(
        os.path.join(r, "res"), os.path.join(r, "masks")))
    out = np.asarray(Image.open(os.path.join(root, "res", "colmap_masks", "a.png.png")))
    assert out.shape == (6, 8) and (out[:3] == 0).all() and (out[3:] == 255).all()
    assert sorted(os.listdir(os.path.join(root, "res", "masks"))) == ["a.png", "b.png"]


def test_reverse_and_resize(tmp_path):
    """A mask at another resolution is resized to its image's; ``reverse``
    flips keep and ignore."""
    m = np.zeros((12, 16, 3), np.uint8)
    m[:6] = 200

    def make(root):
        _write_images(os.path.join(root, "res", "images"), ["x.jpg"], w=8, h=6)
        os.makedirs(os.path.join(root, "masks"))
        Image.fromarray(m).save(os.path.join(root, "masks", "x.png"))

    root = _both(tmp_path, make, lambda cp, r: cp.prepare_masks(
        os.path.join(r, "res"), os.path.join(r, "masks"), reverse=True))
    out = np.asarray(Image.open(os.path.join(root, "res", "colmap_masks", "x.jpg.png")))
    assert out.shape == (6, 8) and (out[:3] == 255).all() and (out[3:] == 0).all()


def test_count_mismatch_raises(tmp_path):
    for cp in (jcp, tcp):
        root = str(tmp_path / cp.__name__.split(".")[0])
        _write_images(os.path.join(root, "res", "images"), ["a.png", "b.png"])
        os.makedirs(os.path.join(root, "masks"))
        Image.fromarray(np.zeros((6, 8, 3), np.uint8)).save(
            os.path.join(root, "masks", "a.png"))
        with pytest.raises(ValueError):
            cp.prepare_masks(os.path.join(root, "res"), os.path.join(root, "masks"))


def _db(datadir, rows):
    conn = sqlite3.connect(os.path.join(datadir, "database.db"))
    conn.execute("CREATE TABLE images (image_id INTEGER, name TEXT)")
    conn.executemany("INSERT INTO images VALUES (?, ?)", rows)
    conn.commit()
    conn.close()


def _images_txt(datadir, text):
    sparse = os.path.join(datadir, "sparse_txt")
    os.makedirs(sparse)
    with open(os.path.join(sparse, "images.txt"), "w") as fp:
        fp.write(text)


def test_db_order_rewrite(tmp_path):
    def make(root):
        _db(root, [(7, "c.png"), (2, "a.png"), (5, "b.png")])
        _images_txt(root, "# comment header\n1 0.1 0.2 0.3 0.4 1 2 3 1 a.png\n\n"
                          "2 0.5 0.6 0.7 0.8 4 5 6 1 b.png\n\n3 0.9 1.0 1.1 1.2 7 8 9 1 c.png\n\n")

    # the database is read, not written: its bytes stay as sqlite wrote them
    root = _both(tmp_path, make, lambda cp, r: cp.reorder_images_txt(r))
    lines = [ln for ln in open(os.path.join(root, "sparse_txt", "images.txt")).read().splitlines()
             if ln.strip()]
    assert [ln.split()[0] for ln in lines] == ["7", "2", "5"]
    assert [ln.split()[-1] for ln in lines] == ["c.png", "a.png", "b.png"]
    assert os.path.exists(os.path.join(root, "sparse_txt", "images_sorted.txt"))


def test_nonempty_points2d_round_trips(tmp_path):
    pts_a = "10.5 20.25 3 40.0 50.0 -1"

    def make(root):
        _db(root, [(4, "b.png"), (9, "a.png")])
        _images_txt(root, f"# images.txt\n1 1 0 0 0 0.5 0.25 2.0 1 a.png\n{pts_a}\n"
                          "2 1 0 0 0 1.5 1.25 3.0 1 b.png\n\n")

    root = _both(tmp_path, make, lambda cp, r: cp.reorder_images_txt(r))
    out = os.path.join(root, "sparse_txt", "images.txt")
    raw = open(out).read().splitlines()
    assert raw[0].split()[0] == "4" and raw[1] == "" and raw[3] == pts_a
    images = read_images_text(out)
    assert sorted(images) == [4, 9] and images[9].name == "a.png"
    np.testing.assert_array_equal(images[9].point3D_ids, [3, -1])


def test_reorder_cli(tmp_path):
    def make(root):
        _db(root, [(3, "b.png"), (1, "a.png")])
        _images_txt(root, "10 0 0 0 1 0 0 0 1 a.png\n11 0 0 0 1 0 0 0 1 b.png\n")

    mains = {jcp: jreorder.main, tcp: treorder.main}
    root = _both(tmp_path, make, lambda cp, r: mains[cp](["--datadir", r]))
    first = open(os.path.join(root, "sparse_txt", "images.txt")).read().splitlines()[0]
    assert first.endswith("b.png") and first.split()[0] == "3"


def test_triangulate_builds_workspace(tmp_path, monkeypatch):
    """The triangulation workspace builder with the colmap binary simulated
    (``tests/test_tools.py::TestTriangulateCLI``): images staged,
    extrinsics in DATABASE order in the w2c convention, the result in
    ``sparse/0``; the same commands and files from both packages."""
    rng = np.random.default_rng(0)
    poses = []
    for _ in range(2):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        poses.append((q * np.sign(np.linalg.det(q)), rng.normal(size=3)))
    calls = {}

    def fake_do_system_for(ws, log):
        def fake(cmd):
            log.append(cmd.replace(ws, "WS"))
            if "feature_extractor" in cmd:
                _db(ws, [(1, "c2.png"), (2, "c1.png")])
            elif "point_triangulator" in cmd:
                src = cmd.split("--input_path ")[1].split()[0]
                dst = cmd.split("--output_path ")[1].split()[0]
                for f in os.listdir(src):
                    shutil.copy(os.path.join(src, f), dst)
        return fake

    def run(cp, root):
        src = os.path.join(root, "src")
        _write_images(src, ["c1.png", "c2.png"], w=16, h=12)
        info_cls, tri = (JCameraInfo, jtri) if cp is jcp else (TCameraInfo, ttri)
        infos = [info_cls(uid=i, R=R, T=T, FovY=0.8, FovX=0.9, image=None,
                          image_path=os.path.join(src, n), image_name=n, width=16, height=12)
                 for i, (n, (R, T)) in enumerate(zip(["c1.png", "c2.png"], poses))]
        ws = os.path.join(root, "out")
        fake = fake_do_system_for(ws, calls.setdefault(cp, []))
        monkeypatch.setattr(cp, "colmap_available", lambda: True)
        monkeypatch.setattr(cp, "do_system", fake)
        monkeypatch.setattr(tri, "do_system", fake)
        assert tri.triangulate(infos, ws) == os.path.join(ws, "sparse", "0")
        os.remove(os.path.join(ws, "database.db"))   # sqlite's bytes vary by run

    root = _both(tmp_path, lambda r: None, run)
    assert calls[jcp] == calls[tcp]
    ws = os.path.join(root, "out")
    assert sorted(os.listdir(os.path.join(ws, "images"))) == ["c1.png", "c2.png"]
    lines = [ln for ln in open(os.path.join(ws, "sparse", "0", "images.txt")).read().splitlines()
             if ln.strip() and not ln.startswith("#")]
    assert lines[0].split()[-1] == "c2.png"
    qvec = np.array([float(v) for v in lines[0].split()[1:5]])
    np.testing.assert_allclose(qvec2rotmat(qvec), poses[1][0].T, atol=1e-6)


def test_pipelines_need_the_colmap_binary(tmp_path, monkeypatch):
    """Without ``colmap`` on PATH every pipeline raises, as JAX's does."""
    for cp in (jcp, tcp):
        monkeypatch.setattr(cp, "colmap_available", lambda: False)
        with pytest.raises(RuntimeError, match="colmap"):
            cp.run_colmap(str(tmp_path))
        with pytest.raises(RuntimeError, match="colmap"):
            cp.triangulate_known_poses(str(tmp_path), str(tmp_path), {}, 8, 6, 5.0, 5.0)
