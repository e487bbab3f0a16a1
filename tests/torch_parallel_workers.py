"""Rank functions of the port's multi-process tests.

``tests/test_torch_parallel.py`` and ``tests/test_torch_multihost.py`` start
these through ``deblurgs_tpu_torch.parallel.multihost.launch`` (spawned
processes, gloo on the CPU). They import the port only: the inputs arrive
as numpy arrays and plain keyword dicts, made by the tests (from the JAX
package's setups), and the results go back as numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deblurgs_tpu_torch.core.camera import CameraStatic
from deblurgs_tpu_torch.models import gaussians as gm
from deblurgs_tpu_torch.models import motion as motion_lib
from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
from deblurgs_tpu_torch.parallel import gauss_shard, shard
from deblurgs_tpu_torch.train import checkpoint as ckpt
from deblurgs_tpu_torch.train import step as step_lib
from deblurgs_tpu_torch.train.config import OptimizationConfig


def launch(fn, nprocs: int, *args) -> list:
    """``multihost.launch`` on the CPU with one thread a rank (the test
    suite runs beside other workers)."""
    from deblurgs_tpu_torch.parallel import multihost

    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return multihost.launch(fn, nprocs, *args, device="cpu", timeout_s=600)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


def statics(cfg: dict, mesh=None) -> step_lib.TrainStatics:
    """A port ``TrainStatics`` from plain keyword dicts."""
    return step_lib.TrainStatics(
        gcfg=gm.GaussianConfig(**cfg["gcfg"]), mcfg=motion_lib.MotionConfig(**cfg["mcfg"]),
        ocfg=OptimizationConfig(**cfg["ocfg"]), rcfg=RasterizeConfig(**cfg["rcfg"]),
        cs=CameraStatic(**cfg["cs"]), mesh=mesh, **cfg["statics"])


def draws_of(d: dict) -> step_lib.StepDraws:
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))   # noqa: E731
    return step_lib.StepDraws(bg=t(d["bg"]), nu_u=t(d.get("nu_u")), noise=t(d.get("noise")),
                              split=None if d.get("split") is None else
                              tuple(t(x) for x in d["split"]))


def _np(tree):
    return type(tree)(*(x.detach().numpy().copy() for x in tree))


def run_case(case: dict, mesh) -> dict:
    """``case["steps"]`` train steps (JAX's draws, one dict a step) from
    ``case["state"]`` (the flat checkpoint layout), on ``mesh`` (None: one
    process), and, when ``case["grads"]``, the first step's gradients."""
    st = statics(case["cfg"], mesh)
    state = ckpt.state_from_arrays(case["state"], device="cpu")
    gauss = mesh is not None and mesh.axis == gauss_shard.GAUSS_AXIS
    if gauss:
        state = gauss_shard.shard_gauss_state(state, mesh)
    gt, proj = torch.tensor(case["gt"]), torch.tensor(case["proj"])
    out = {"metrics": []}
    for i, d in enumerate(case["draws"]):
        draws = draws_of(d)
        if case.get("grads") and i == 0:
            fwd = step_lib.forward_loss(state, gt, case["cam"], proj, st, draws)
            g_params, g_motion, g_vsp = step_lib.backward(fwd)
            out["grads"] = (_np(g_params), _np(g_motion), g_vsp.detach().numpy().copy())
            state, m = step_lib.apply(state, fwd, (g_params, g_motion, g_vsp), st, draws)
        else:
            state, m = step_lib.train_step(state, gt, case["cam"], proj, st, draws=draws)
        out["metrics"].append({k: float(getattr(m, k)) for k in
                               ("loss", "l1", "t_smooth", "hinge", "psnr", "num_active",
                                "num_pairs", "max_per_tile")}
                              | {"densify": [int(x) for x in m.densify]})
    if gauss:
        out["local_rows"] = state.params.xyz.shape[0]
        state = gauss_shard.gather_gauss_state(state, mesh)
    out["state"] = ckpt.state_to_arrays(state)
    if mesh is not None:
        out["traffic"] = mesh.traffic_report()
    return out


def row_slabs(case: dict, mesh) -> dict:
    """The row-slab render of ``case`` on ``mesh`` (None: the one-process
    render) and the gradients of ``sum(image · w)`` for means and
    opacities."""
    from deblurgs_tpu_torch.core.camera import make_camera_arrays
    from deblurgs_tpu_torch.ops.rasterize import render
    from deblurgs_tpu_torch.parallel import tile_shard

    cs = CameraStatic(**case["cs"])
    cfg = RasterizeConfig(**case["rcfg"])
    g = [torch.tensor(x) for x in case["gauss"]]
    view, proj, bg = (torch.tensor(case[k]) for k in ("view", "proj", "bg"))
    means, opac = g[0].clone().requires_grad_(True), g[3].clone().requires_grad_(True)
    if mesh is None:
        out = render(means, g[1], g[2], opac, g[4], make_camera_arrays(view, proj), cs, bg,
                     cfg=cfg, sh_degree=case["sh_degree"])
    else:
        fn = tile_shard.row_sharded_render(mesh, cs, proj, cfg, sh_degree=case["sh_degree"])
        out = fn(means, g[1], g[2], opac, g[4], view, bg)
    loss = torch.sum(out.image * torch.from_numpy(case["w"]))
    gm_, go = torch.autograd.grad(loss, (means, opac))
    res = {k: getattr(out, k).detach().numpy().copy() for k in
           ("image", "depth", "final_T", "radii", "visible")}
    res.update(num_pairs=int(out.num_pairs), max_per_tile=int(out.max_per_tile),
               g_means=gm_.numpy().copy(), g_opac=go.numpy().copy())
    return res


def run_cases(rank: int, cases: list) -> list:
    """Each case on a mesh of its first ``case["ranks"]`` ranks (every rank
    makes every mesh, as a new group needs; ranks outside it idle)."""
    torch.set_num_threads(1)
    results = []
    for case in cases:
        axis = case.get("axis", "sf")
        mesh = shard.make_mesh(case["ranks"], axis, device="cpu")
        if mesh is None:
            results.append(None)
            continue
        run = row_slabs if case.get("kind") == "row_slabs" else run_case
        results.append(run(case, mesh))
    return results


def two_process_steps(rank: int, case: dict) -> dict:
    """``tests/test_multihost.py``'s worker on the port: the group is up
    (``multihost.launch``), each rank keeps its block of the four training
    images, a step's image is broadcast from its owner, and two steps shard
    their sub-frames over both ranks."""
    from deblurgs_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    assert multihost.rank_world() == (rank, 2)
    gts = case["gts"]
    mine = multihost.host_local_camera_split(gts.shape[0])
    masked = np.zeros_like(gts)
    masked[mine] = gts[mine]
    stack = multihost.assemble_global_images(masked, device="cpu")
    mesh = multihost.global_mesh(device="cpu")
    st = statics(case["cfg"], mesh)
    state = ckpt.state_from_arrays(case["state"], device="cpu")
    proj = torch.tensor(case["proj"])
    out = {"split": mine, "local_rows": int(stack.local.shape[0]), "losses": [], "gts": []}
    for it, d in enumerate(case["draws"]):
        gt = multihost.select_camera(stack, it)
        out["gts"].append(gt.numpy().copy())
        state, m = step_lib.train_step(state, gt, it, proj, st, draws=draws_of(d))
        out["losses"].append(float(m.loss))
    out["traffic"] = mesh.traffic_report() | stack.mesh.traffic_report()
    return out


def scene_ranks(rank: int, source: str) -> dict:
    """Each rank decodes its own training images (``Scene(load_indices=)``),
    and every camera is selected on every rank."""
    from deblurgs_tpu_torch.data.scene import Scene
    from deblurgs_tpu_torch.parallel import multihost

    n = len(Scene(source, None, resolution=1, load_indices=[]).info.train_cameras)
    mine = multihost.host_local_camera_split(n)
    scene = Scene(source, None, resolution=1, load_indices=mine)
    zero = [i for i in range(n) if i not in mine and not scene.train_images[i].any()]
    stack = multihost.assemble_global_images(scene.train_images, device="cpu")
    return {"mine": mine, "zero_rows": zero,
            "selected": np.stack([multihost.select_camera(stack, i).numpy() for i in range(n)])}


def trainer_ranks(rank: int, source: str, configs: tuple, state: dict, draws: list,
                  kw: dict) -> dict:
    """``Trainer.train(mesh=)`` on every rank of the group, each rank with
    its own training images; JAX's draws through ``draws_fn``."""
    from deblurgs_tpu_torch.data.scene import Scene
    from deblurgs_tpu_torch.parallel import multihost
    from deblurgs_tpu_torch.train import loop

    torch.set_num_threads(1)
    gcfg, mcfg, ocfg, rcfg = configs
    n = len(Scene(source, None, resolution=1, load_indices=[]).info.train_cameras)
    scene = Scene(source, None, resolution=1,
                  load_indices=multihost.host_local_camera_split(n))
    seen = []
    trainer = loop.Trainer(scene=scene, gcfg=gcfg, mcfg=mcfg, ocfg=ocfg, rcfg=rcfg,
                           tone_mapping="identity", device="cpu",
                           on_metrics=lambda it, m: seen.append(
                               (it, float(m.loss), int(m.num_pairs))),
                           draws_fn=lambda it, st: draws_of(draws[it - 1]), **kw)
    mesh = shard.make_mesh(device="cpu")
    final = trainer.train(ckpt.state_from_arrays(state, device="cpu"), 1, mesh=mesh)
    return {"state": ckpt.state_to_arrays(final), "seen": seen,
            "gts_type": type(trainer._gts).__name__, "traffic": mesh.traffic_report()}
