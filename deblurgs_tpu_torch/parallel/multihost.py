"""Multi-process initialisation and rank-local training data.

Counterpart of ``deblurgs_tpu/parallel/multihost.py``. JAX starts one
process per host with ``jax.distributed`` and shards a global image array
over every device; the port runs one process per rank in a
``torch.distributed`` group:

- :func:`initialize` joins the group (a no-op for one process);
- :func:`global_mesh` is a mesh over every rank;
- :func:`host_local_camera_split` says which training images this rank
  decodes (``Scene(load_indices=...)``), in the contiguous blocks of JAX;
- :func:`assemble_global_images` keeps this rank's rows on its device;
- :func:`select_camera` broadcasts a camera's image from the rank that owns
  it.

:func:`launch` starts the ranks of one machine as spawned processes (never
forked after CUDA is up), each of which calls :func:`initialize` before its
function runs.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import traceback
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from deblurgs_tpu_torch.parallel import shard


def rank_world() -> tuple[int, int]:
    """(this rank, the number of ranks) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device="cuda", share_card: bool = False, timeout_s: float = 300.0) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` (no-op for one process). ``coordinator_address`` is
    ``host:port`` (TCP) or a ``file://`` path every rank can reach.
    ``backend`` defaults to NCCL when ``device`` is ``cuda`` and this host
    has a card a rank, gloo when it is the CPU; ranks on fewer cards raise
    unless ``share_card`` (gloo). A rank that cannot reach the group within
    ``timeout_s`` fails."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        if torch.device(device).type == "cpu":
            backend = "gloo"
        else:
            shard.rank_device(device, process_id, num_processes, share_card)
            backend = "nccl" if torch.cuda.device_count() >= num_processes else "gloo"
    addr = coordinator_address or ""
    dist.init_process_group(
        backend, init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(axis: str = "sf", *, device="cuda", share_card: bool = False) -> shard.Mesh:
    """A 1-D mesh over every rank of every host (sub-frame axis)."""
    return shard.make_mesh(None, axis, device=device, share_card=share_card)


def host_local_camera_split(n_cameras: int) -> list[int]:
    """Camera indices this rank loads and decodes: contiguous blocks by
    rank, as JAX's by process."""
    pid, n = rank_world()
    return list(range(pid * n_cameras // n, (pid + 1) * n_cameras // n))


class RankImages(NamedTuple):
    """The training images of a multi-process run: this rank's rows from
    ``lo`` on its device, the others on the ranks that decoded them."""

    local: torch.Tensor     # [rows, H, W, 3]
    lo: int
    n: int
    mesh: shard.Mesh


def assemble_global_images(images: np.ndarray, mesh: shard.Mesh | None = None,
                           axis: str = "cam", *, device="cuda"):
    """This rank's share of the training images.

    ``images``: the full [N, H, W, 3] stack of which only this rank's
    :func:`host_local_camera_split` rows need real data. One process: the
    whole stack as a tensor on ``device``. Several: a :class:`RankImages`
    with only this rank's rows on its device (JAX's camera-sharded global
    array; the blocks are those of :func:`host_local_camera_split`, where
    JAX pads N to its device count first).
    """
    mesh = mesh or global_mesh(axis, device=device)
    if mesh.size == 1:
        return torch.as_tensor(images, device=mesh.device)
    mine = host_local_camera_split(images.shape[0])
    return RankImages(torch.as_tensor(images[mine[0]:mine[-1] + 1], device=mesh.device),
                      mine[0], images.shape[0], mesh)


def select_camera(gts, idx) -> torch.Tensor:
    """[H, W, 3] of camera ``idx`` on every rank: indexed where the stack is
    whole, else broadcast from the rank whose rows hold it."""
    if not isinstance(gts, RankImages):
        return gts[idx]
    idx = int(idx)
    mesh = gts.mesh
    owner = next(r for r in range(mesh.size)
                 if r * gts.n // mesh.size <= idx < (r + 1) * gts.n // mesh.size)
    buf = (gts.local[idx - gts.lo] if owner == mesh.rank
           else torch.empty_like(gts.local[0]))
    return shard.broadcast(mesh, buf, owner)


# ---------------------------------------------------------------------------
# starting the ranks of one machine
# ---------------------------------------------------------------------------


def _rank_main(rank: int, fn: Callable, nprocs: int, address: str, backend: str | None,
               device, share_card: bool, timeout_s: float, results, args) -> None:
    try:
        initialize(address, nprocs, rank, backend=backend, device=device,
                   share_card=share_card, timeout_s=timeout_s)
        out = fn(rank, *args)
        results.put((rank, out, None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, *args, backend: str | None = None, device="cuda",
           share_card: bool = False, timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, *args)`` on ``nprocs`` spawned ranks of a new group
    (rendezvous through a file in a fresh temporary directory) and return
    their results in rank order. ``fn`` must be importable by name and its
    result picklable. A rank that raises, or a run past ``timeout_s``,
    fails the launch; every rank is stopped before this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        address = "file://" + os.path.join(tmp, "rendezvous")
        procs = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, nprocs, address, backend, device, share_card, timeout_s,
                              results, args),
            nprocs=nprocs, join=False, start_method="spawn")
        out, errors = {}, []
        try:
            deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
            while len(out) + len(errors) < nprocs:
                try:
                    rank, value, err = results.get(timeout=1.0)
                except queue.Empty:
                    if datetime.datetime.now() > deadline:
                        raise TimeoutError(f"ranks still running after {timeout_s} s")
                    if not any(p.is_alive() for p in procs.processes):
                        break
                    continue
                if err is None:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{err}")
            if errors or len(out) < nprocs:
                raise RuntimeError("a rank failed:\n" + ("\n".join(errors) or
                                   f"exit codes {[p.exitcode for p in procs.processes]}"))
            procs.join(timeout=timeout_s)
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
    return [out[r] for r in range(nprocs)]
