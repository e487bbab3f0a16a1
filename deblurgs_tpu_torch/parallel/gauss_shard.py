"""Gaussian-axis sharding: each rank owns a block of the capacity's rows.

Counterpart of ``deblurgs_tpu/parallel/gauss_shard.py``. JAX places the
``[P, ...]`` leaves of a train state with a ``NamedSharding`` over a ``gs``
mesh axis and lets GSPMD cut the standard step; the port does the cut by
hand, at the place JAX's module docstring names:

- rank r keeps rows ``[r·P/n, (r+1)·P/n)`` of the params, the aux
  statistics and the Gaussian Adam moments (:func:`shard_gauss_state`); the
  curves, their Adam state and the scalars stay replicated;
- the step activates and preprocesses its own rows only, then gathers the
  compact preprocessed per-Gaussian fields once at the binning boundary
  (:func:`gather_preprocessed`, ``rasterize.render_batch``'s ``pre_hook``);
  staging, K3, K1, K2 and K4 run on the gathered table on every rank, and
  each per-Gaussian gradient comes back to the rank that owns its row (the
  gather's backward is the rank's slice);
- Adam and the densification statistics run on the rows of the rank; the
  curves' gradients, partial per rank, are summed over the ranks;
- densify and prune compact the whole capacity (an argsort and cumsum
  across it), so at an event step every rank gathers the state, runs the
  one-process event with the step's draws and keeps its rows
  (:func:`densify_event`).

The step itself is ``train/step.py``'s, told by the mesh's axis
(:data:`GAUSS_AXIS`) to take this route.
"""

from __future__ import annotations

import dataclasses

import torch

from deblurgs_tpu_torch.models import gaussians as gm
from deblurgs_tpu_torch.ops.preprocess import PreprocessOut
from deblurgs_tpu_torch.parallel import shard
from deblurgs_tpu_torch.train import optim

GAUSS_AXIS = "gs"
_FLOAT_FIELDS = ("means2d", "conic", "opacity", "depth", "color")
_INT_FIELDS = ("radius", "rect", "tiles_touched", "visible")


def make_gauss_mesh(n_devices: int | None = None, **kw) -> shard.Mesh:
    """1-D mesh over the Gaussian axis (keywords as ``shard.make_mesh``)."""
    return shard.make_mesh(n_devices, axis=GAUSS_AXIS, **kw)


def local_rows(mesh: shard.Mesh, capacity: int) -> slice:
    """This rank's rows of a global ``capacity``, which must divide over
    the ranks (as JAX asserts)."""
    if capacity % mesh.size:
        raise ValueError(f"capacity {capacity} must divide the {mesh.size}-rank gs mesh")
    n = capacity // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def _map_gauss(state, fn):
    """``fn`` on every per-Gaussian leaf (params, aux, Gaussian Adam
    moments) of a train state; the rest unchanged."""
    tup = lambda t: type(t)(*(fn(x) for x in t))   # noqa: E731
    return state._replace(params=tup(state.params), aux=tup(state.aux),
                          adam_g=state.adam_g._replace(mu=tup(state.adam_g.mu),
                                                       nu=tup(state.adam_g.nu)))


def shard_gauss_state(state, mesh: shard.Mesh):
    """This rank's rows of a whole train state: params, aux and the
    Gaussian Adam moments; the motion, its Adam state and the scalars as
    they are (replicated)."""
    rows = local_rows(mesh, state.params.xyz.shape[0])
    return _map_gauss(state, lambda x: x[rows].clone())


def gather_gauss_state(state, mesh: shard.Mesh):
    """The whole train state on every rank from each rank's rows (the
    inverse of :func:`shard_gauss_state`)."""
    return _map_gauss(state, lambda x: shard.all_gather(mesh, x, 0))


def gather_preprocessed(mesh: shard.Mesh, pre: PreprocessOut) -> PreprocessOut:
    """Every rank's rows of the preprocessed fields [..., P/n, k], gathered
    along the Gaussian axis: the floats in one differentiable gather (its
    backward is this rank's rows), the integer fields in one plain one."""
    axis = pre.means2d.dim() - 2

    def gather(keys, gather_fn, dtype):
        parts = [getattr(pre, k) for k in keys]
        parts = [(x.unsqueeze(-1) if x.dim() == axis + 1 else x).to(dtype) for x in parts]
        full = gather_fn(mesh, torch.cat(parts, -1), axis)
        out, c = {}, 0
        for k, x in zip(keys, parts):
            y = full[..., c:c + x.shape[-1]]
            c += x.shape[-1]
            orig = getattr(pre, k)
            out[k] = (y[..., 0] if orig.dim() == axis + 1 else y).to(orig.dtype)
        return out

    return PreprocessOut(**gather(_FLOAT_FIELDS, shard.gather_rows, torch.float32),
                         **gather(_INT_FIELDS, shard.all_gather, torch.int32))


def gauss_sharded_render(render_fn, mesh: shard.Mesh):
    """Wrap ``rasterize.render`` or ``render_batch`` so that its
    per-Gaussian inputs (and ``active``) are this rank's rows: the rank
    preprocesses them, the fields are gathered and the image is the whole
    one, as are ``radii`` and ``visible`` (forward path: evaluation or
    export of a sharded scene)."""

    def wrapped(means3d, scales, rotations, opacities, shs, *rest, **kw):
        return render_fn(means3d, scales, rotations, opacities, shs, *rest,
                         pre_hook=lambda pre: gather_preprocessed(mesh, pre), **kw)

    return wrapped


def make_gauss_train_step(st, mesh: shard.Mesh):
    """The train step on a state sharded by :func:`shard_gauss_state`:
    ``fn(state, gt, idx, proj, draws=..., generator=...)`` returns the new
    sharded state and the metrics (every rank the same ones)."""
    from deblurgs_tpu_torch.train import step as step_lib

    if st.mesh is not None:
        raise ValueError("gauss sharding takes a step without a sub-frame mesh")
    st_g = dataclasses.replace(st, mesh=mesh)
    return lambda state, gt, idx, proj, **kw: step_lib.train_step(state, gt, idx, proj,
                                                                  st_g, **kw)


def densify_event(mesh: shard.Mesh, params, aux, adam: optim.AdamState, event):
    """Run ``event(params, aux, adam) -> (params, aux, adam, report)`` on
    the whole state (gathered from every rank) and keep this rank's rows:
    densify and prune compact across the whole capacity."""
    g = lambda t: type(t)(*(shard.all_gather(mesh, x, 0) for x in t))   # noqa: E731
    full = event(g(params), g(aux), adam._replace(mu=g(adam.mu), nu=g(adam.nu)))
    p, a, ad, report = full
    rows = local_rows(mesh, p.xyz.shape[0])
    s = lambda t: type(t)(*(x[rows].clone() for x in t))   # noqa: E731
    return s(p), s(a), ad._replace(mu=s(ad.mu), nu=s(ad.nu)), report


def global_active(mesh: shard.Mesh, active: torch.Tensor) -> torch.Tensor:
    """The number of live slots over every rank's rows."""
    return shard.all_reduce(mesh, gm.num_active(active), "sum")
