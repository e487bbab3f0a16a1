"""Gaussian snapshot PLY import/export in the standard 3DGS layout.

Counterpart of ``deblurgs_tpu/data/gaussian_ply.py`` (reference
``GaussianModel.save_ply`` / ``load_ply``, ``scene/gaussian_model.py:226-299``).
The fork trains with clamp-opacity and exp-lower-bound scaling, but
snapshots are written in the standard 3DGS convention, ``opacity =
inverse_sigmoid(activated)`` and ``scale = log(activated)``, so any viewer
opens them; loading maps them back into the fork's parameterisation. The
same files move between the two packages in both directions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deblurgs_tpu_torch.core import transforms as tf
from deblurgs_tpu_torch.data import ply as ply_io
from deblurgs_tpu_torch.device import resolve_device
from deblurgs_tpu_torch.models import gaussians as gm


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_gaussian_ply(path, params: gm.GaussianParams, aux: gm.GaussianAux,
                      cfg: gm.GaussianConfig):
    """Write the active Gaussians in the standard 3DGS PLY layout."""
    active = _np(aux.active).astype(bool)
    xyz = _np(params.xyz)[active]
    f_dc = _np(params.f_dc)[active]        # [n, 1, 3]
    f_rest = _np(params.f_rest)[active]    # [n, K-1, 3]
    opac = _np(gm.get_opacity(params, cfg))[active]
    scale = _np(gm.get_scaling(params, cfg))[active]
    rot = _np(params.rotation)[active]

    eps = 1e-6
    opac_c = np.clip(opac, eps, 1 - eps)
    cols = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros_like(xyz[:, 0]), "ny": np.zeros_like(xyz[:, 0]),
        "nz": np.zeros_like(xyz[:, 0]),
    }
    # channel-major flattening like the reference (transpose(1,2).flatten)
    f_dc_t = np.transpose(f_dc, (0, 2, 1)).reshape(len(xyz), -1)
    f_rest_t = np.transpose(f_rest, (0, 2, 1)).reshape(len(xyz), -1)
    for i in range(f_dc_t.shape[1]):
        cols[f"f_dc_{i}"] = f_dc_t[:, i]
    for i in range(f_rest_t.shape[1]):
        cols[f"f_rest_{i}"] = f_rest_t[:, i]
    cols["opacity"] = np.log(opac_c / (1 - opac_c))[:, 0]
    scale_disk = np.log(np.maximum(scale, eps))
    for i in range(3):
        cols[f"scale_{i}"] = scale_disk[:, i]
    for i in range(4):
        cols[f"rot_{i}"] = rot[:, i]

    os.makedirs(os.path.dirname(path), exist_ok=True)
    ply_io.write_ply(path, {k: np.asarray(v, np.float32) for k, v in cols.items()})


def load_gaussian_ply(path, cfg: gm.GaussianConfig, capacity: int | None = None,
                      device="cuda") -> tuple[gm.GaussianParams, gm.GaussianAux]:
    """Read a standard 3DGS PLY into fork-parameterised (params, aux) on
    ``device``, padded to ``capacity`` slots (default: the file's count)."""
    dev = resolve_device(device)
    cols = ply_io.read_ply(path)
    n = len(cols["x"])
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} Gaussians in {path}")
    k_rest = (cfg.sh_coeffs - 1) * 3
    rest_names = sorted((k for k in cols if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    if len(rest_names) != k_rest:
        raise ValueError(f"{path}: {len(rest_names)} f_rest columns, SH degree "
                         f"{cfg.sh_degree} needs {k_rest}")

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1)
    opac = 1.0 / (1.0 + np.exp(-cols["opacity"][:, None]))    # sigmoid → activated
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :]
    f_rest = np.stack([cols[k] for k in rest_names], -1)
    f_rest = f_rest.reshape(n, 3, cfg.sh_coeffs - 1).transpose(0, 2, 1)
    scale = np.exp(np.stack([cols[f"scale_{i}"] for i in range(3)], -1))
    rot = np.stack([cols[f"rot_{i}"] for i in range(4)], -1)

    def pad(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x.new_zeros((capacity - n,) + x.shape[1:])])

    rotation = pad(t(rot))
    rotation[n:, 0] = 1.0
    params = gm.GaussianParams(
        xyz=pad(t(xyz)), f_dc=pad(t(f_dc)), f_rest=pad(t(f_rest)),
        scaling=pad(gm.inverse_scaling(t(scale), cfg)), rotation=rotation,
        opacity=pad(tf.inverse_clamp_opacity(t(opac))))
    zeros = torch.zeros(capacity, dtype=torch.float32, device=dev)
    aux = gm.GaussianAux(active=torch.arange(capacity, device=dev) < n,
                         max_radii2d=zeros, xyz_grad_accum=zeros.clone(), denom=zeros.clone())
    return params, aux
