"""Checkpoint / resume of the whole train state.

Counterpart of ``deblurgs_tpu/train/checkpoint.py``: one ``.npz`` whose keys
are the '/'-joined field paths of :class:`~deblurgs_tpu_torch.train.step.
TrainState` (``params/xyz``, ``aux/denom``, ``adam_g/mu/xyz``,
``adam_m/step/nu``, ``step``, ``rng``, ``overflow_count``, ...), the same
keys and dtypes the JAX package writes, so a state carries across in both
directions with its Adam moments and step counts. ``rng`` (the JAX key) is
carried as numpy and not used. The motion-only ``cm.npz`` (reference
``cm.pth``, ``motion.py:337-365``) holds ``rot_ctrl``, ``trans_ctrl`` and
``nu``, as JAX's ``save_motion`` writes them.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from deblurgs_tpu_torch.device import resolve_device
from deblurgs_tpu_torch.models import gaussians as gm
from deblurgs_tpu_torch.models import motion as motion_lib
from deblurgs_tpu_torch.train import optim
from deblurgs_tpu_torch.train.step import TrainState

_GROUPS = (("params", gm.GaussianParams), ("motion", motion_lib.MotionParams),
           ("aux", gm.GaussianAux))
_ADAM = (("adam_g", gm.GaussianParams), ("adam_m", motion_lib.MotionParams))


def state_to_arrays(state: TrainState) -> dict:
    """The flat numpy dict of a train state (the npz layout)."""
    def arr(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    flat = {}
    for name, _ in _GROUPS:
        for leaf, value in getattr(state, name)._asdict().items():
            flat[f"{name}/{leaf}"] = arr(value)
    for name, _ in _ADAM:
        for part in ("mu", "nu", "step"):
            for leaf, value in getattr(getattr(state, name), part)._asdict().items():
                flat[f"{name}/{part}/{leaf}"] = arr(value)
    flat["step"] = np.asarray(state.step, np.int32)
    flat["rng"] = np.asarray(state.rng)
    flat["overflow_count"] = arr(state.overflow_count).astype(np.int32)
    return flat


def state_from_arrays(flat: Mapping[str, np.ndarray], device="cuda") -> TrainState:
    """A train state from the flat dict (keys as :func:`state_to_arrays`
    writes them; a missing ``overflow_count`` starts at 0)."""
    dev = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.array(flat[key]), device=dev)

    groups = {name: kind(*(t(f"{name}/{leaf}") for leaf in kind._fields))
              for name, kind in _GROUPS}
    groups["aux"] = groups["aux"]._replace(active=groups["aux"].active.to(torch.bool))
    adams = {name: optim.AdamState(*(kind(*(t(f"{name}/{part}/{leaf}") for leaf in kind._fields))
                                     for part in ("mu", "nu", "step")))
             for name, kind in _ADAM}
    oc = t("overflow_count") if "overflow_count" in flat else torch.zeros((), device=dev)
    return TrainState(params=groups["params"], motion=groups["motion"], aux=groups["aux"],
                      adam_g=adams["adam_g"], adam_m=adams["adam_m"],
                      step=int(np.asarray(flat["step"])),
                      rng=np.asarray(flat.get("rng", np.zeros(2, np.uint32))),
                      overflow_count=oc.to(torch.int32))


def save_checkpoint(path: str, state: TrainState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **state_to_arrays(state))


def load_checkpoint(path: str, device="cuda") -> TrainState:
    with np.load(path) as data:
        return state_from_arrays(dict(data), device=device)


def save_motion(path: str, motion: motion_lib.MotionParams) -> None:
    """Write the curve leaves to ``cm.npz`` (the JAX package's keys)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: getattr(motion, k).detach().cpu().numpy()
                      for k in motion_lib.MotionParams._fields})


def load_motion(path: str, device="cuda") -> motion_lib.MotionParams:
    """Read ``cm.npz`` into a :class:`MotionParams` on ``device``."""
    dev = resolve_device(device)
    with np.load(path) as d:
        return motion_lib.MotionParams(*(torch.as_tensor(np.array(d[k]), device=dev)
                                         for k in motion_lib.MotionParams._fields))
