"""Native host library (ctypes; built on demand with g++).

Counterpart of ``deblurgs_tpu/native``: exact 3-NN mean squared distance
(``knn3_mean_sq``, a uniform-grid search on the host) and the COLMAP
``points3D.bin`` single-pass parser (``parse_points3d_bin``). The C++
source ``src/deblurgs_native.cpp`` is the port's own copy of the JAX
package's.

The library is compiled at first use into ``build/`` beside the package
(with OpenMP, else without), keyed by a hash of the source and the flags
as ``ops/kernels.py`` keys the CUDA kernels, and loaded with ``ctypes``.
Every entry point returns None when no C++ compiler is found or the build
fails; callers then take the plain Python or PyTorch path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np

from deblurgs_tpu_torch.ops.kernels import BUILD

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "deblurgs_native.cpp")
FLAG_SETS = (("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp"),
             ("-O3", "-shared", "-fPIC", "-std=c++17"))
_lib = None
_tried = False
build_seconds: float | None = None   # the first load's build (or load) time


def _library_path(flags) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD, f"libdeblurgs_native_{digest.hexdigest()[:16]}.so")


def _build(gxx: str, flags, path: str) -> bool:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD, exist_ok=True)
        res = subprocess.run([gxx, *flags, "-o", tmp, _SRC], capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    if res.returncode != 0:
        return False
    os.replace(tmp, path)
    return True


def load():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried, build_seconds
    if _lib is not None or _tried:
        return _lib
    _tried = True
    gxx = shutil.which("g++") or shutil.which("clang++")
    t0 = time.perf_counter()
    for flags in FLAG_SETS:
        path = _library_path(flags)
        if not os.path.exists(path) and (gxx is None or not _build(gxx, flags, path)):
            continue
        try:
            _lib = _bind(ctypes.CDLL(path))
        except OSError:
            continue
        build_seconds = time.perf_counter() - t0
        return _lib
    return None


def _bind(lib):
    lib.knn3_mean_sq.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_float)]
    lib.knn3_mean_sq.restype = None
    lib.parse_points3d_bin.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.parse_points3d_bin.restype = ctypes.c_int64
    return lib


def available() -> bool:
    return load() is not None


def knn3_mean_sq(points: np.ndarray) -> np.ndarray | None:
    """Exact mean squared 3-NN distance on the host; None if unavailable."""
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    out = np.empty(pts.shape[0], dtype=np.float32)
    lib.knn3_mean_sq(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                     ctypes.c_int64(pts.shape[0]),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def parse_points3d_bin(path: str):
    """COLMAP points3D.bin → (xyz [N, 3] f64, rgb [N, 3] u8, err [N, 1]
    f64), or None if the library is unavailable or the file is malformed."""
    lib = load()
    if lib is None:
        return None
    buf = np.fromfile(path, dtype=np.uint8)
    if buf.size < 8:
        return None
    num = int(np.frombuffer(buf[:8].tobytes(), dtype=np.uint64)[0])
    xyz = np.empty((num, 3), np.float64)
    rgb = np.empty((num, 3), np.uint8)
    err = np.empty((num, 1), np.float64)
    n = lib.parse_points3d_bin(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int64(buf.size),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ctypes.c_int64(num))
    if n < 0:
        return None
    return xyz[:n], rgb[:n], err[:n]
