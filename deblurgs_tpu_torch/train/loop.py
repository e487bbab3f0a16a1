"""Host training loop (reference ``train.py:35-233``).

Counterpart of ``deblurgs_tpu/train/loop.py``. The device runs one
:func:`~deblurgs_tpu_torch.train.step.train_step` an iteration; the host
decides everything between steps:

- phase switching: sharp warm-up (n_sub=1, curve frozen) → blur synthesis
  (all sub-frames) at ``curve_start_iter``; the SH degree bump every 1000
  iterations (reference ``train.py:121-123``); the ``random_sample_until``
  jitter cutoff. Each combination is one :class:`TrainStatics`, cached
  under the key JAX compiles a variant for (the port runs eagerly and
  compiles nothing);
- capacity management: when densification drops insertions, or the
  active count nears the slots while densifying, the Gaussian capacity
  doubles and every per-Gaussian leaf is padded (:func:`grow_capacity`);
  when the pair count passes 85% of ``max_pairs``, the pair budget
  doubles; ``max_pairs == 0`` sizes it once at the start
  (:meth:`Trainer.autosize_max_pairs`); on the xla backend ``k_max``
  doubles when a tile's list outgrows it;
- the saving cadence (PLY snapshots, ``cm.npz``, full checkpoints), the
  EMA-smoothed log, the visualizer and ``time.txt`` (the wall time of
  :meth:`Trainer.train`, which ends on a drain's host copy).

Metrics stay on the device between drains: every ``sync_every`` iterations
(and at a save and the last iteration) the pending metrics are copied to
the host in one transfer. The random draws of every step come from one
``torch.Generator`` on the run's device, seeded from ``seed``; ``draws_fn``
replaces them (tests inject JAX's draws through it).

Several processes: when a process group of more than one rank is up, each
rank keeps only its rows of the training images
(``parallel/multihost.py``; build the ``Scene`` with
``load_indices=multihost.host_local_camera_split(n)`` to decode only
those) and a step's image is broadcast from the rank that owns it. Every
rank draws the same camera sequence and the same step draws: the scene's
shuffle and the run's generator are seeded alike on every rank. ``train(mesh=)``
shards each step's sub-frames over the mesh's ranks. As in JAX, every rank
writes the snapshots, checkpoints and ``time.txt`` of ``model_path``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from deblurgs_tpu_torch.core.camera import c2w_to_view, make_camera_arrays
from deblurgs_tpu_torch.data.gaussian_ply import load_gaussian_ply, save_gaussian_ply
from deblurgs_tpu_torch.data.scene import Scene
from deblurgs_tpu_torch.device import resolve_device
from deblurgs_tpu_torch.models import gaussians as gm
from deblurgs_tpu_torch.models import motion as motion_lib
from deblurgs_tpu_torch.ops import rasterize
from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
from deblurgs_tpu_torch.parallel import multihost, shard
from deblurgs_tpu_torch.train import checkpoint as ckpt_lib
from deblurgs_tpu_torch.train import optim
from deblurgs_tpu_torch.train import step as step_lib
from deblurgs_tpu_torch.train.config import OptimizationConfig
from deblurgs_tpu_torch.utils.profiling import count, span

# the drained scalars of one step's metrics, copied to the host together
_DRAINED = ("loss", "l1", "t_smooth", "hinge", "psnr", "num_active", "num_pairs",
            "max_per_tile", "overflowed", "overflow_count")


class EmaLogger:
    """EMA-smoothed metric printer (reference ``utils/logger.py``)."""

    def __init__(self, ema_weight: float = 0.6, print_fn=print):
        self.ema_weight = ema_weight
        self.values: dict = {}
        self.print_fn = print_fn

    def update(self, metrics: dict):
        for k, v in metrics.items():
            v = float(v) if not isinstance(v, (int,)) else v
            if k in self.values:
                w = self.ema_weight
                self.values[k] = w * self.values[k] + (1 - w) * v
            else:
                self.values[k] = v

    def show(self, step: int):
        parts = [f"it {step}"]
        for k, v in self.values.items():
            parts.append(f"{k}={v:.5g}")
        self.print_fn("  ".join(parts))


def grow_capacity(state: step_lib.TrainState, new_capacity: int) -> step_lib.TrainState:
    """Pad every per-Gaussian leaf (params, aux, both Adam moments) to a
    larger capacity. New slots are inactive with identity rotation; the
    Adam step counts are per leaf and carry over unchanged."""
    old = state.params.xyz.shape[0]
    assert new_capacity > old

    def pad(x, fill=0.0):
        extra = torch.full((new_capacity - old,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                           device=x.device)
        return torch.cat([x, extra])

    params = gm.GaussianParams(*(pad(leaf) for leaf in state.params))
    params.rotation[old:, 0] = 1.0
    aux = gm.GaussianAux(active=pad(state.aux.active, False),
                         max_radii2d=pad(state.aux.max_radii2d),
                         xyz_grad_accum=pad(state.aux.xyz_grad_accum),
                         denom=pad(state.aux.denom))
    adam = optim.AdamState(mu=gm.GaussianParams(*(pad(leaf) for leaf in state.adam_g.mu)),
                           nu=gm.GaussianParams(*(pad(leaf) for leaf in state.adam_g.nu)),
                           step=state.adam_g.step)
    return state._replace(params=params, aux=aux, adam_g=adam)


@dataclasses.dataclass
class Trainer:
    """Owns the step cache and runs the full DeblurGS schedule."""

    scene: Scene
    gcfg: gm.GaussianConfig
    mcfg: motion_lib.MotionConfig
    ocfg: OptimizationConfig
    rcfg: RasterizeConfig
    tone_mapping: str = "gamma"
    model_path: Optional[str] = None
    save_iterations: tuple = (50_000, 100_000, 150_000)
    checkpoint_iterations: tuple = ()
    render_iterations: tuple = ()
    visualize: bool = False
    vis_cam_idx: Optional[int] = None  # overview focus camera (None = zoom-out search)
    log_every: int = 10
    sync_every: int = 10   # drain cadence: one host transfer per drain
    on_metrics: Optional[Callable] = None   # (iteration, StepMetrics) at each drain
    debug: bool = False    # NaN guard: dump the state and abort on a non-finite loss
    batched_render: bool = False  # all sub-frames in ONE render_batch (mixed layout)
    cams_per_step: int = 1  # B training cameras per step
    device: str | torch.device = "cuda"
    seed: int = 0          # seeds the run's generator (curve init noise, step draws)
    draws_fn: Optional[Callable] = None   # (iteration, state) -> StepDraws

    def __post_init__(self):
        if self.batched_render and not (self.rcfg.backend == "pallas"
                                        and self.rcfg.layout == "mixed"):
            # batched rendering stacks all views on the mixed kernel's tile
            # axis; the xla/oracle backends (and the lockstep layout) have
            # no batched path
            print(f"[render] backend={self.rcfg.backend!r} "
                  f"layout={self.rcfg.layout!r} has no batched path — "
                  "falling back to per-view rendering")
            self.batched_render = False
        rank, world = multihost.rank_world()
        if world > 1:
            # this rank's card (an explicit index is kept: ranks share it)
            self.device = shard.rank_device(self.device, rank, world)
            self._gts = multihost.assemble_global_images(
                self.scene.train_images, multihost.global_mesh("cam", device=self.device))
        else:
            self.device = resolve_device(self.device)
            self._gts = torch.as_tensor(self.scene.train_images, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self._step_cache: dict = {}
        self.logger = EmaLogger()
        self._proj = torch.as_tensor(self.scene.proj, device=self.device)
        self.training_time_sec = 0.0
        self._visualizer = None
        self._pending: list = []

    def _get_visualizer(self):
        if self._visualizer is None:
            from deblurgs_tpu_torch.utils.visualizer import Visualizer

            self._visualizer = Visualizer(
                self.scene, self.gcfg, self.mcfg, self.rcfg, self.model_path,
                self.ocfg.iterations, vis_cam_idx=self.vis_cam_idx, device=self.device)
        return self._visualizer

    def statics(self, sh_degree: int, n_sub: int, random_sample: bool,
                rcfg: RasterizeConfig, mesh=None) -> step_lib.TrainStatics:
        """The train step's static settings for one phase, pair budget and
        mesh."""
        return step_lib.TrainStatics(
            gcfg=self.gcfg, mcfg=self.mcfg, ocfg=self.ocfg, rcfg=rcfg,
            cs=self.scene.camera_static, sh_degree=sh_degree, n_sub=n_sub,
            tone_mapping=self.tone_mapping, spatial_lr_scale=float(self.scene.cameras_extent),
            random_sample=random_sample,
            white_background=getattr(self.scene, "white_background", False), mesh=mesh,
            batched_render=self.batched_render, cams_per_step=self.cams_per_step)

    # -- the step's statics keyed as JAX keys its compiled variants
    def _get_statics(self, sh_degree: int, n_sub: int, random_sample: bool, capacity: int,
                     rcfg: RasterizeConfig, mesh=None) -> step_lib.TrainStatics:
        key = (sh_degree, n_sub, random_sample, capacity, rcfg, mesh)
        if key not in self._step_cache:
            self._step_cache[key] = self.statics(sh_degree, n_sub, random_sample, rcfg, mesh)
        return self._step_cache[key]

    def init_state(self, load_path: str | None = None, load_motion_path: str | None = None,
                   start_checkpoint: str | None = None,
                   capacity: int | None = None) -> tuple[step_lib.TrainState, int]:
        """The initial state and first iteration: Gaussians from the scene's
        point cloud (or a trained run's PLY), curves at the nominal poses
        (or a ``cm.npz``), or a whole checkpoint, which resumes at its
        ``step``."""
        dev = self.device
        if start_checkpoint:
            state = ckpt_lib.load_checkpoint(start_checkpoint, device=dev)
            return state, int(state.step)
        pcd = self.scene.info.point_cloud
        n0 = pcd.points.shape[0]
        capacity = capacity or max(1 << int(np.ceil(np.log2(max(n0 * 2, 1024)))), 1024)
        if load_path:
            it = Scene.search_max_iteration(os.path.join(load_path, "point_cloud"))
            params, aux = load_gaussian_ply(
                os.path.join(load_path, "point_cloud", f"iteration_{it}", "point_cloud.ply"),
                self.gcfg, capacity, device=dev)
        else:
            params, aux = gm.create_from_pcd(
                torch.as_tensor(pcd.points, dtype=torch.float32, device=dev),
                torch.as_tensor(pcd.colors, dtype=torch.float32, device=dev),
                self.gcfg, capacity)
        if load_motion_path:
            motion = ckpt_lib.load_motion(load_motion_path, device=dev)
        else:
            motion = motion_lib.init_motion(
                torch.as_tensor(self.scene.rotations, dtype=torch.float32, device=dev),
                torch.as_tensor(self.scene.centers, dtype=torch.float32, device=dev),
                self.mcfg, self.generator).params()
        return step_lib.init_state(params, motion, aux), 1

    def phase_statics(self, iteration: int):
        """(sh_degree, n_sub, random_sample) for this iteration."""
        sh_degree = min(iteration // 1000, self.gcfg.sh_degree)
        n_sub = self.mcfg.n_subframes if iteration >= self.ocfg.curve_start_iter else 1
        random_sample = (self.mcfg.curve_random_sample
                         and iteration < self.ocfg.random_sample_until)
        return sh_degree, n_sub, random_sample

    @torch.no_grad()
    def autosize_max_pairs(self, state: step_lib.TrainState) -> int:
        """Pair capacity for ``max_pairs == 0``: the pairs preprocess emits
        (``sum(tiles_touched)``, the count the step reports) at every
        training camera's nominal pose, the worst view budgeted for the
        whole launch — n_sub sub-frames (batched) × cams_per_step views —
        with 1.5× headroom for densification and the curves' spread, rounded
        up to a power of two and at least 2^16. The reactive doubling in
        :meth:`train` stays on for growth that outruns the estimate."""
        rin = gm.render_inputs(state.params, self.gcfg)
        rots = torch.as_tensor(self.scene.rotations, dtype=torch.float32, device=self.device)
        centers = torch.as_tensor(self.scene.centers, dtype=torch.float32, device=self.device)
        counts = []
        for i in range(rots.shape[0]):
            cam = make_camera_arrays(c2w_to_view(rots[i], centers[i]), self._proj)
            pre = rasterize._preprocess(
                rin["means3d"], rin["scales"], rin["rotations"], rin["opacities"], rin["shs"],
                cam, self.scene.camera_static, self.rcfg, self.gcfg.sh_degree, None,
                state.aux.active, None)
            counts.append(pre.tiles_touched.to(torch.int64).sum())
        per_view = int(torch.stack(counts).max())
        n_views = (self.mcfg.n_subframes if self.batched_render else 1) * self.cams_per_step
        budget = int(per_view * n_views * 1.5)
        max_pairs = 1 << max(16, int(np.ceil(np.log2(max(budget, 1)))))
        print(f"[pairs] auto-sized max_pairs = {max_pairs} (probe worst {per_view} "
              f"pairs/view × {n_views} views × 1.5 headroom)")
        return max_pairs

    def _select(self):
        """The step's camera index (B == 1) or indices and its GT images
        (broadcast from their owners when the ranks split the images)."""
        if self.cams_per_step == 1:
            cam_idx = self.scene.get_random_cam_idx()
            return cam_idx, cam_idx, multihost.select_camera(self._gts, cam_idx)
        # B draws from the epoch-shuffled viewpoint stack (the reference
        # pops one per iteration, train.py:118-124)
        cam_idx = [self.scene.get_random_cam_idx() for _ in range(self.cams_per_step)]
        sel = torch.as_tensor(cam_idx, dtype=torch.int64, device=self.device)
        if isinstance(self._gts, multihost.RankImages):
            return cam_idx, sel, torch.stack([multihost.select_camera(self._gts, c)
                                              for c in cam_idx])
        return cam_idx, sel, self._gts[sel]

    def train(self, state: step_lib.TrainState, first_iter: int = 1,
              iterations: int | None = None, mesh=None) -> step_lib.TrainState:
        """Train from ``first_iter`` to ``iterations``; ``mesh`` (a sub-frame
        ``parallel.shard.Mesh``) shards each step's views over its ranks."""
        t_start = time.perf_counter()
        iterations = iterations or self.ocfg.iterations
        if self.rcfg.max_pairs <= 0:
            with span("train.autosize"):
                self.rcfg = dataclasses.replace(self.rcfg,
                                                max_pairs=self.autosize_max_pairs(state))
        rcfg = self.rcfg
        for iteration in range(first_iter, iterations + 1):
            with span("train.iteration"):
                state, rcfg = self._iteration(state, iteration, iterations, rcfg, mesh)
        # the last iteration drained: its host copy waited for the device
        self.training_time_sec += time.perf_counter() - t_start

        if self.visualize and self._visualizer is not None:
            self._visualizer.save_video()
        n_overflow = int(state.overflow_count)
        if n_overflow:
            print(f"[pairs] WARNING: {n_overflow} iterations trained on a truncated pair "
                  "list (capacity overflow)")
        if self.model_path:
            with open(os.path.join(self.model_path, "time.txt"), "w") as fp:
                print(f"Training Time = {self.training_time_sec:7.5f}sec", file=fp)
                print(f"Overflowed iterations = {n_overflow}", file=fp)
        return state

    def _iteration(self, state: step_lib.TrainState, iteration: int, iterations: int,
                   rcfg: RasterizeConfig, mesh):
        """One iteration of :meth:`train`: the step, the drain on its
        cadence, the log and the saves."""
        with span("train.select"):
            sh_degree, n_sub, random_sample = self.phase_statics(iteration)
            st = self._get_statics(sh_degree, n_sub, random_sample, state.params.xyz.shape[0],
                                   rcfg, mesh)
            cam_idx, sel, gt = self._select()
        with span("train.draws"):
            draws = (self.draws_fn(iteration, state) if self.draws_fn is not None
                     else step_lib.draw_step(state, st, gt.shape, self.generator))
        with span("train.step"):
            state, metrics = step_lib.train_step(state, gt, sel, self._proj, st, draws=draws)
        # metrics stay on the device; drained in batches below
        self._pending.append((iteration, cam_idx, metrics))
        if (iteration % self.sync_every == 0 or iteration in self.save_iterations
                or iteration == iterations):
            with span("train.drain"):
                state, rcfg = self._drain(state, rcfg)
        if iteration % self.log_every == 0 and self.logger.values:
            self.logger.show(iteration)

        if self.model_path and iteration in self.save_iterations:
            self.save_snapshot(state, iteration)
        if self.model_path and iteration in self.checkpoint_iterations:
            ckpt_lib.save_checkpoint(
                os.path.join(self.model_path, f"chkpnt{iteration}.npz"), state)
        if self.visualize and self.model_path:
            self._get_visualizer().run(iteration, state)
        if self.model_path and iteration in self.render_iterations:
            self._get_visualizer().traj_render(iteration, state,
                                               cam_idx=self.vis_cam_idx or 0)
            self._get_visualizer().visualize_alignment(iteration, state)
        return state, rcfg

    def _drain(self, state: step_lib.TrainState, rcfg: RasterizeConfig):
        """Copy the pending metrics to the host in one transfer and act on
        them in order: NaN guard, capacity growth, pair budget, log."""
        pending = self._pending
        f64 = lambda x: x.to(self.device, torch.float64)   # noqa: E731
        host = torch.stack([torch.stack([f64(getattr(m, k)) for k in _DRAINED]
                                        + [f64(m.densify.n_dropped)])
                            for _, _, m in pending]).cpu().numpy()
        for (it_p, cam_p, m), row in zip(pending, host):
            vals = dict(zip(_DRAINED + ("n_dropped",), row.tolist()))
            # ---- NaN guard (debug mode): a post-mortem snapshot of the
            # state (already up to sync_every-1 steps past the bad one) and
            # the offending step's inputs, then abort
            if self.debug and not math.isfinite(vals["loss"]):
                snap = os.path.join(self.model_path or ".", f"snapshot_nan_it{it_p}.npz")
                ckpt_lib.save_checkpoint(snap, state)
                with open(snap + ".txt", "w") as fp:
                    print(f"non-finite loss at iteration {it_p}\ncam_idx={cam_p}\n"
                          f"metrics={m}", file=fp)
                raise FloatingPointError(
                    f"non-finite loss {vals['loss']} at iteration {it_p} (cam {cam_p}) — "
                    f"state dumped to {snap}")
            num_active, num_pairs = int(vals["num_active"]), int(vals["num_pairs"])
            count("staging.pairs_emitted", num_pairs)
            # ---- capacity: pre-grow near full while densification can
            # still insert (dropped insertions are lost, not retried); the
            # reactive path catches a burst that outran it, but not twice
            # for the same entry
            cap_now = state.params.xyz.shape[0]
            grew = False
            if it_p < self.ocfg.densify_until_iter and num_active > 0.9 * cap_now:
                print(f"[capacity] → {cap_now * 2} (pre-grow: {num_active} active > 90% "
                      f"of {cap_now})")
                with span("drain.grow_capacity"):
                    state = grow_capacity(state, cap_now * 2)
                grew = True
            if int(vals["n_dropped"]) > 0 and not grew:
                new_cap = state.params.xyz.shape[0] * 2
                print(f"[capacity] → {new_cap} (dropped {int(vals['n_dropped'])})")
                with span("drain.grow_capacity"):
                    state = grow_capacity(state, new_cap)
            if vals["overflowed"]:
                print(f"[pairs] OVERFLOW at iter {it_p}: {num_pairs} pairs > capacity "
                      f"{rcfg.max_pairs} — step trained on a truncated pair list "
                      f"(total {int(vals['overflow_count'])} such steps)")
            if num_pairs > 0.85 * rcfg.max_pairs:
                rcfg = dataclasses.replace(rcfg, max_pairs=rcfg.max_pairs * 2)
                print(f"[pairs] max_pairs → {rcfg.max_pairs}")
            if rcfg.backend == "xla" and int(vals["max_per_tile"]) > rcfg.k_max:
                rcfg = dataclasses.replace(rcfg, k_max=rcfg.k_max * 2)
                print(f"[pairs] k_max → {rcfg.k_max}")
            self.logger.update({"l1": vals["l1"], "smooth": vals["t_smooth"],
                                "hinge": vals["hinge"], "psnr": vals["psnr"],
                                "#pts": num_active})
            if self.on_metrics is not None:
                self.on_metrics(it_p, m)
        self._pending = []
        return state, rcfg

    def save_snapshot(self, state: step_lib.TrainState, iteration: int):
        pc_dir = self.scene.point_cloud_dir(iteration)
        save_gaussian_ply(os.path.join(pc_dir, "point_cloud.ply"), state.params, state.aux,
                          self.gcfg)
        ckpt_lib.save_motion(os.path.join(self.model_path, "cm.npz"), state.motion)
