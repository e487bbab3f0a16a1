"""COLMAP sparse-reconstruction parsers (pure numpy).

Counterpart of ``deblurgs_tpu/data/colmap.py`` (reference
``scene/colmap_loader.py:43-294``): ``cameras`` / ``images`` / ``points3D``
in both ``.bin`` and ``.txt`` layouts, the text writers and
``detect_sparse_dir``. Binary parsing decodes one buffer read
incrementally. ``read_points3d_binary`` first tries the native
single-pass parser (``deblurgs_tpu_torch/native``), then the per-record
Python loop, which gives the same arrays.
"""

from __future__ import annotations

import collections
import os
import struct

import numpy as np

CameraModel = collections.namedtuple("CameraModel", ["model_id", "model_name", "num_params"])
ColmapCamera = collections.namedtuple("ColmapCamera", ["id", "model", "width", "height", "params"])
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    """COLMAP (w, x, y, z) quaternion -> rotation matrix (reference ``:43-55``)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R):
    """Rotation matrix -> COLMAP quaternion, w >= 0 (reference ``:57-68``)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


class _Buf:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def unpack(self, fmt: str):
        fmt = "<" + fmt
        out = struct.unpack_from(fmt, self.data, self.off)
        self.off += struct.calcsize(fmt)
        return out

    def array(self, dtype, count):
        arr = np.frombuffer(self.data, dtype=dtype, count=count, offset=self.off)
        self.off += arr.nbytes
        return arr

    def cstring(self) -> str:
        end = self.data.index(b"\x00", self.off)
        s = self.data[self.off:end].decode("utf-8")
        self.off = end + 1
        return s


def _read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _data_lines(path) -> list[str]:
    """The stripped lines of a text file, comments dropped."""
    with open(path) as f:
        return [line.strip() for line in f if not line.strip().startswith("#")]


def read_cameras_binary(path) -> dict:
    buf = _Buf(_read_bytes(path))
    (num,) = buf.unpack("Q")
    out = {}
    for _ in range(num):
        cam_id, model_id, width, height = buf.unpack("iiQQ")
        model = CAMERA_MODEL_IDS[model_id]
        params = buf.array(np.float64, model.num_params).copy()
        out[cam_id] = ColmapCamera(cam_id, model.model_name, width, height, params)
    return out


def read_cameras_text(path) -> dict:
    out = {}
    for line in _data_lines(path):
        if not line:
            continue
        elems = line.split()
        cam_id = int(elems[0])
        out[cam_id] = ColmapCamera(cam_id, elems[1], int(elems[2]), int(elems[3]),
                                   np.array(list(map(float, elems[4:]))))
    return out


def read_images_binary(path) -> dict:
    buf = _Buf(_read_bytes(path))
    (num,) = buf.unpack("Q")
    out = {}
    for _ in range(num):
        img_id = buf.unpack("i")[0]
        qvec = np.array(buf.unpack("dddd"))
        tvec = np.array(buf.unpack("ddd"))
        cam_id = buf.unpack("i")[0]
        name = buf.cstring()
        (n_pts,) = buf.unpack("Q")
        rec = buf.array(np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]), n_pts)
        xys = np.stack([rec["x"], rec["y"]], axis=-1)
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name, xys, rec["id"].copy())
    return out


def read_images_text(path) -> dict:
    """Alternating image/points2D lines; the points line may be empty."""
    out = {}
    lines = _data_lines(path)
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        elems = lines[i].split()
        img_id = int(elems[0])
        qvec = np.array(list(map(float, elems[1:5])))
        tvec = np.array(list(map(float, elems[5:8])))
        cam_id = int(elems[8])
        name = elems[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        if pts:
            xys = np.stack([np.array(list(map(float, pts[0::3]))),
                            np.array(list(map(float, pts[1::3])))], axis=-1)
            ids = np.array(list(map(int, pts[2::3])))
        else:
            xys = np.zeros((0, 2))
            ids = np.zeros(0, np.int64)
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name, xys, ids)
        i += 2
    return out


def read_points3d_binary(path):
    """-> (xyz [N,3] f64, rgb [N,3] u8, error [N,1] f64): the native
    parser when the host library builds, else one record at a time (the
    reference's loop)."""
    from deblurgs_tpu_torch import native

    out = native.parse_points3d_bin(path)
    return out if out is not None else read_points3d_binary_python(path)


def read_points3d_binary_python(path):
    """:func:`read_points3d_binary` by the per-record Python loop."""
    buf = _Buf(_read_bytes(path))
    (num,) = buf.unpack("Q")
    xyz = np.empty((num, 3))
    rgb = np.empty((num, 3), np.uint8)
    err = np.empty((num, 1))
    for i in range(num):
        rec = buf.unpack("QdddBBBd")
        xyz[i] = rec[1:4]
        rgb[i] = rec[4:7]
        err[i] = rec[7]
        (track_len,) = buf.unpack("Q")
        buf.off += 8 * track_len
    return xyz, rgb, err


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    for line in _data_lines(path):
        if not line:
            continue
        elems = line.split()
        xyz.append(list(map(float, elems[1:4])))
        rgb.append(list(map(int, elems[4:7])))
        err.append([float(elems[7])])
    return np.array(xyz), np.array(rgb, np.uint8), np.array(err)


def write_images_text(images: dict, path):
    """images.txt writer (empty points lines)."""
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image\n")
        for img in images.values():
            q = " ".join(f"{v:.9g}" for v in img.qvec)
            t = " ".join(f"{v:.9g}" for v in img.tvec)
            f.write(f"{img.id} {q} {t} {img.camera_id} {img.name}\n\n")


def write_cameras_text(cameras: dict, path):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera\n")
        for cam in cameras.values():
            params = " ".join(f"{v:.9g}" for v in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def detect_sparse_dir(path) -> str | None:
    for cand in ("sparse/0", "sparse"):
        d = os.path.join(path, cand)
        if os.path.isdir(d):
            return d
    return None
