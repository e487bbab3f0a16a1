"""Minimal PLY reader/writer (pure numpy).

Counterpart of ``deblurgs_tpu/data/ply.py``. Two layouts:

- point clouds: x/y/z, nx/ny/nz, red/green/blue (reference ``storePly`` /
  ``fetchPly``, ``dataset_readers.py:138-162``);
- Gaussian snapshots: x/y/z, f_dc_*, f_rest_*, opacity, scale_*, rot_*
  (reference ``GaussianModel.save_ply`` / ``load_ply``).

Reads binary_little_endian and ascii; writes binary_little_endian.
"""

from __future__ import annotations

import os

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_TYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int"}


def read_ply(path) -> dict[str, np.ndarray]:
    """Read the 'vertex' element into a dict of column arrays."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()

    fmt = None
    count = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties not supported")
            props.append((parts[-1], _TYPES[parts[1]]))

    if fmt == "binary_little_endian":
        dtype = np.dtype([(n, "<" + t) for n, t in props])
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=header_end)
    elif fmt == "ascii":
        flat = np.array(data[header_end:].decode("ascii").split(), dtype=np.float64)
        flat = flat.reshape(count, len(props))
        arr = np.zeros(count, dtype=np.dtype([(n, t) for n, t in props]))
        for i, (n, _) in enumerate(props):
            arr[n] = flat[:, i]
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return {n: np.ascontiguousarray(arr[n]) for n, _ in props}


def vertex_count(path) -> int:
    """The 'vertex' element's count, read from the header alone."""
    with open(path, "rb") as f:
        for raw in f:
            parts = raw.decode("ascii").split()
            if parts[:2] == ["element", "vertex"]:
                return int(parts[2])
            if parts[:1] == ["end_header"]:
                break
    raise ValueError(f"{path}: no vertex element")


def write_ply(path, columns: dict[str, np.ndarray]):
    """Write a vertex element from a dict of equal-length column arrays.
    The file is written beside ``path`` and renamed over it, so a reader
    (another rank loading the same scene, which rewrites its point cloud)
    sees the old file or the new one, never a part."""
    names = list(columns)
    n = len(next(iter(columns.values())))
    kinds = {name: columns[name].dtype.str.lstrip("<>=|") for name in names}
    arr = np.empty(n, dtype=np.dtype([(name, kinds[name]) for name in names]))
    for name in names:
        arr[name] = columns[name]
    lines = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    lines += [f"property {_INV_TYPES[kinds[name]]} {name}" for name in names]
    lines.append("end_header")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(arr.tobytes())
    os.replace(tmp, path)


def store_point_cloud(path, xyz: np.ndarray, rgb: np.ndarray):
    """Reference ``storePly`` layout (normals zeroed, u8 colours)."""
    normals = np.zeros_like(xyz, dtype=np.float32)
    write_ply(path, {
        "x": xyz[:, 0].astype(np.float32),
        "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": normals[:, 0], "ny": normals[:, 1], "nz": normals[:, 2],
        "red": rgb[:, 0].astype(np.uint8),
        "green": rgb[:, 1].astype(np.uint8),
        "blue": rgb[:, 2].astype(np.uint8),
    })


def fetch_point_cloud(path):
    """Reference ``fetchPly``: -> (points [N,3], colours [N,3] in [0,1],
    normals), float32."""
    cols = read_ply(path)
    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1)
    rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=-1) / 255.0
    if "nx" in cols:
        normals = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=-1)
    else:
        normals = np.zeros_like(pts)
    return pts.astype(np.float32), rgb.astype(np.float32), normals.astype(np.float32)
