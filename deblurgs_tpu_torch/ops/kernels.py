"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
sources in parallel, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first
use into ``build/`` beside the package, keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.

Nothing here runs at import time: the CPU tests import every module on a
host with no CUDA toolkit.

Flags: no ``--use_fast_math`` (it flushes denormals to zero and swaps
``expf`` for ``__expf``), and ``-fmad=false`` so the kernels round each
multiply and add as the plain PyTorch versions do — the gates at alpha ≥
1/255 and T ≥ 1e-4 then decide the same way on both.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build")
SOURCES = ("broadcast_fields.cu", "forward_mixed.cu", "backward_mixed.cu", "reduce_sorted.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_i64 = ctypes.c_int64
_i32 = ctypes.c_int
# C entry points: name -> argument types (every pointer and the stream are
# void*); each returns the cudaError_t of its launch
_SIGNATURES = {
    "deblurgs_broadcast_fields": [_vp, _vp, _vp, _i64, _i64, _vp],
    "deblurgs_forward_mixed": [_vp, _i64, _vp, _vp, _i32, _i32, _i32, _i32,
                               _i32, _i32, _vp, _vp, _vp, _vp, _vp],
    "deblurgs_backward_mixed": [_vp, _i64, _vp, _vp, _i32, _i32, _i32, _i32,
                                _i32, _i32, _vp, _vp, _vp, _vp, _vp],
    "deblurgs_reduce_sorted": [_vp, _i64, _vp, _vp, _i64, _vp, _vp],
}


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path: str, build_seconds: float, ptxas_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log
        self._lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib.deblurgs_error_string.argtypes = [ctypes.c_int]
        self._lib.deblurgs_error_string.restype = ctypes.c_char_p

    def launch(self, name: str, *args) -> None:
        """Call a C entry point; raise if its launch reported an error."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            msg = self._lib.deblurgs_error_string(err).decode()
            raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


_LIBRARY: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


def _compile(nvcc: str, src: str, obj: str) -> str:
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + ("common.cuh",):
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    so_path = os.path.join(BUILD, f"libdeblurgs_kernels_{tag}.so")
    log_path = so_path + ".ptxas.txt"
    t0 = time.perf_counter()
    if not os.path.exists(so_path):
        nvcc = _nvcc()
        os.makedirs(BUILD, exist_ok=True)
        objs = [os.path.join(BUILD, f"{os.path.splitext(s)[0]}_{tag}.o") for s in SOURCES]
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            logs = list(pool.map(lambda so: _compile(nvcc, *so), zip(SOURCES, objs)))
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc, "-shared", *objs, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stdout}\n{proc.stderr}")
        with open(log_path, "w") as f:
            f.write("\n".join(logs))
        os.replace(tmp, so_path)
    with open(log_path) as f:
        ptxas_log = f.read()
    _LIBRARY = KernelLibrary(so_path, time.perf_counter() - t0, ptxas_log)
    return _LIBRARY


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
