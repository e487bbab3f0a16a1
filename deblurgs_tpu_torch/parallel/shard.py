"""Sub-frame sharding over the ranks of a ``torch.distributed`` group.

Counterpart of ``deblurgs_tpu/parallel/shard.py``. JAX is single-controller:
one process holds a ``Mesh`` of devices, ``shard_map`` splits the sub-frame
axis over it and GSPMD inserts the collectives, including the gradient
all-reduce onto the replicated parameters. The port runs one process per
rank instead, with a process group as the mesh and explicit collectives:

- :class:`Mesh` is the group, this rank's index, the number of ranks, the
  rank's device and the axis name;
- rank r renders the contiguous block of views
  ``[r·n/size, (r+1)·n/size)`` (:func:`local_views`), with the Gaussians and
  curves replicated on every rank;
- where a collective sits inside the differentiated graph it is a
  ``torch.autograd.Function`` with its backward stated:
  :func:`gather_rows` (the gathered tensor feeds a loss that every rank
  computes identically, so its backward is this rank's slice of the
  cotangent, not a sum over ranks), :func:`replicate` (identity on
  replicated inputs; its backward sums their cotangents over the ranks, one
  collective for all of them) and :func:`sum_replicated` (a sum over ranks
  whose result every rank consumes identically: identity backward).

``torch.distributed.nn.functional``'s collectives are not used: they reduce
the cotangent over the ranks in backward, which gives every rank n times the
gradient of a loss that each rank computes redundantly.

Backends: NCCL where every rank has a card of its own; gloo on CPU tensors
when the caller asks for the CPU. Ranks share a card only when the caller
asks for it (``share_card=True``); the group is then gloo, whose CUDA
support differs by collective and version, so every collective on such a
mesh is staged through host memory here, explicitly, and the staged bytes
are counted in :attr:`Mesh.traffic`.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Callable

import torch
import torch.distributed as dist

from deblurgs_tpu_torch.core.camera import CameraArrays
from deblurgs_tpu_torch.device import resolve_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of ranks: the port's ``jax.sharding.Mesh``.

    ``group`` is None for one rank without a process group (every
    collective is then the identity). ``staged``: the group is gloo and
    the tensors live on a card, so collectives go through host memory.
    ``traffic`` counts, per collective, the calls, the bytes of the result
    on this rank and the bytes staged through the host (both directions).
    Hashed by identity: it sits in the train step's static settings.
    """

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "sf"
    backend: str | None = None
    traffic: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(lambda: [0, 0, 0]))

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def reset_traffic(self) -> None:
        self.traffic.clear()

    def traffic_report(self) -> dict:
        return {k: {"calls": c, "bytes": b, "host_staged_bytes": s}
                for k, (c, b, s) in sorted(self.traffic.items())}


def rank_device(device, rank: int, world: int, share_card: bool = False) -> torch.device:
    """The device of rank ``rank`` of ``world``: the CPU, or card
    ``LOCAL_RANK`` (else ``rank`` mod the card count) when every rank has a
    card of its own. Fewer cards than ranks raise unless ``share_card``."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", rank))
    if n < world and not share_card:
        raise RuntimeError(
            f"{world} ranks and {n} CUDA card(s): pass share_card=True to let ranks "
            "share a card (gloo, collectives staged through host memory)")
    return torch.device("cuda", local % n)


def make_mesh(n_devices: int | None = None, axis: str = "sf", *, device="cuda",
              share_card: bool = False) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks of the default group
    (all of them when None); JAX's ``make_mesh`` over devices.

    Every rank of the default group must call it (a smaller mesh is a new
    group, which is collective); a rank outside the first ``n_devices``
    gets None. Without a process group the mesh is this one process. The
    group's backend is the one :func:`deblurgs_tpu_torch.parallel.multihost.initialize`
    chose; NCCL with several ranks on one card, or on CPU tensors, raises.
    JAX's fall-back to virtual CPU devices is not carried over: asking for
    ``cuda`` without a card raises.
    """
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"need {n_devices} ranks and no process group is up "
                             "(multihost.initialize starts one)")
        return Mesh(None, 0, 1, resolve_device(device), axis)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"need {n} ranks, the group has {world}")
    backend = dist.get_backend()
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    dev = rank_device(device, rank, n, share_card)
    shared = dev.type == "cuda" and torch.cuda.device_count() < n
    if backend == "nccl" and (dev.type != "cuda" or shared):
        raise RuntimeError(f"NCCL needs a card for each rank (device {dev}, {n} ranks, "
                           f"{torch.cuda.device_count()} cards)")
    mesh = Mesh(group, rank, n, dev, axis, backend)
    if shared and rank == 0:
        print(f"[parallel] {n} ranks share {dev} over {backend}: collectives are staged "
              "through host memory", flush=True)
    return mesh


# ---------------------------------------------------------------------------
# collectives (plain; counted in mesh.traffic)
# ---------------------------------------------------------------------------


def _count(mesh: Mesh, name: str, nbytes: int, staged: int) -> None:
    rec = mesh.traffic[name]
    rec[0] += 1
    rec[1] += nbytes
    rec[2] += staged


def all_reduce(mesh: Mesh, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of ``x`` over the ranks, as a new tensor."""
    if mesh.group is None:
        return x
    buf = x.detach().to("cpu" if mesh.staged else x.device, copy=True).contiguous()
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group)
    _count(mesh, f"all_reduce_{op}", buf.nbytes, 2 * buf.nbytes if mesh.staged else 0)
    return buf.to(x.device)


def all_gather(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    ranks' shapes must agree)."""
    if mesh.group is None:
        return x
    src = x.detach().to("cpu" if mesh.staged else x.device).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts, dim=dim)
    _count(mesh, "all_gather", out.nbytes, src.nbytes + out.nbytes if mesh.staged else 0)
    return out.to(x.device)


def broadcast(mesh: Mesh, x: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (the others pass a tensor of the
    same shape and dtype)."""
    if mesh.group is None:
        return x
    buf = x.detach().to("cpu" if mesh.staged else x.device, copy=True).contiguous()
    dist.broadcast(buf, src=dist.get_global_rank(mesh.group, src), group=mesh.group)
    _count(mesh, "broadcast", buf.nbytes, 2 * buf.nbytes if mesh.staged else 0)
    return buf.to(x.device)


# ---------------------------------------------------------------------------
# collectives in the differentiated graph
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return all_gather(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.n, ctx.n), None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        flat = all_reduce(ctx.mesh, flat, "sum")
        out, i = [], 0
        for shape in ctx.shapes:
            n = shape.numel()
            out.append(flat[i:i + n].view(shape))
            i += n
        return (None, *out)


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(mesh, x, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_rows(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` in the graph. Its consumer must compute the same
    value on every rank: the backward hands this rank its slice of the
    cotangent."""
    if mesh is None or mesh.group is None:
        return x
    return _GatherRows.apply(x, mesh, dim)


def replicate(mesh: Mesh, *xs: torch.Tensor) -> tuple:
    """The replicated inputs ``xs`` unchanged; in backward their cotangents
    are summed over the ranks (one all-reduce for all of them), so each
    rank's gradient is the whole one, as shard_map's transpose gives."""
    if mesh is None or mesh.group is None:
        return xs
    return _Replicate.apply(mesh, *xs)


def sum_replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """:func:`all_reduce` (sum) in the graph, for a result every rank
    consumes identically: the backward is the identity."""
    if mesh is None or mesh.group is None:
        return x
    return _SumReplicated.apply(x, mesh)


# ---------------------------------------------------------------------------
# the sub-frame axis
# ---------------------------------------------------------------------------


def local_views(mesh: Mesh | None, n_views: int) -> slice:
    """This rank's contiguous block of ``n_views`` (all of them without a
    mesh); ``n_views`` must divide over the ranks, as JAX asserts."""
    if mesh is None:
        return slice(0, n_views)
    if n_views % mesh.size:
        raise ValueError(f"n_views={n_views} must divide over {mesh.size} ranks")
    n = n_views // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def _block(cams: CameraArrays, mesh: Mesh) -> CameraArrays:
    sl = local_views(mesh, cams.view.shape[0])
    return CameraArrays(*(x[sl] for x in cams))


def sharded_subframe_render(render_one: Callable, mesh: Mesh | None):
    """Wrap a one-view render into this rank's share of a sharded render.

    ``render_one(replicated, (cam, vsp)) -> tuple`` renders one view from
    the replicated scene state. Returns ``go(replicated, cams, vsp_local)``:
    ``cams`` holds every view (each rank computes them all; they are small),
    ``vsp_local`` this rank's block [n/size, P, 2]; the views of the block
    render one after another (JAX's ``lax.map``) and their outputs stack on
    a leading axis. The block's outputs stay on this rank: a consumer that
    needs every view gathers them (:func:`gather_rows`). Without a mesh
    the block is every view.
    """

    def go(replicated, cams: CameraArrays, vsp_local: torch.Tensor):
        block = _block(cams, mesh)
        outs = [render_one(replicated, (CameraArrays(*(x[s] for x in block)), vsp_local[s]))
                for s in range(block.view.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))

    return go


def sharded_block_render(render_block: Callable, mesh: Mesh | None):
    """Like :func:`sharded_subframe_render`, but this rank renders its whole
    block in ONE call: ``render_block(replicated, cams_local, vsp_local)``
    (one batched render, one launch of each kernel a rank)."""

    def go(replicated, cams: CameraArrays, vsp_local: torch.Tensor):
        return render_block(replicated, _block(cams, mesh), vsp_local)

    return go


def reduce_view_stats(mesh: Mesh | None, accum: torch.Tensor, count: torch.Tensor,
                      radii_max: torch.Tensor):
    """The densification statistics of a step summed (``accum``, ``count``)
    and maxed (``radii_max``) over the ranks' blocks of views. ``count`` is
    a float32 count of views (exact below 2^24)."""
    if mesh is None or mesh.group is None:
        return accum, count, radii_max
    both = all_reduce(mesh, torch.stack([accum, count]), "sum")
    return both[0], both[1], all_reduce(mesh, radii_max, "max")
