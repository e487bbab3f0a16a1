"""The DeblurGS train step (reference ``train.py:104-208`` hot loop).

Counterpart of ``deblurgs_tpu/train/step.py``. One call renders all
sub-frames of the step's blurry observations (one batched render: K3, K1;
on the xla and oracle backends one render a view),
synthesises the blur as their mean, computes the loss (L1 + temporal
smoothness + depth-TV + opacity hinge), backpropagates through the
rasterizer (K2, K4) and the Bézier camera curves by autograd, clips,
applies Adam with the reference's per-group scheduled LRs, accumulates the
densification statistics and, on cadence, runs the densify/prune and
opacity-reset events.

Differences from the JAX step, none of them in what it computes:

- the state's ``step`` is a Python int, so the cadence of the events and
  the phase gates are decided on the host and the events that do not
  fire cost nothing (JAX takes both ``lax.cond`` branches into one jit);
- JAX draws its randomness from ``jax.random.split(state.rng, 5)``, whose
  streams torch cannot reproduce: the draws are a :class:`StepDraws`
  argument (standard uniforms and normals, transformed here as JAX
  transforms its own), drawn from a ``torch.Generator`` when not given;
  ``state.rng`` is carried for the checkpoint and not used;
- with ``mesh`` set, JAX's ``shard_map`` splits the views over devices in
  one process; here each rank of a process group runs this step on its
  block of views (``parallel/shard.py``). The curves and Gaussians are
  replicated (their gradients summed over the ranks in backward,
  ``shard.replicate``), the rendered images and depths are gathered, so
  every rank computes the whole loss (the blur mean, the smoothness pairs
  that straddle two ranks' blocks, the depth TV) and takes its own views'
  share of the cotangent back (``shard.gather_rows``); the densification
  statistics and the pair counts are reduced over the ranks. A mesh on the
  Gaussian axis (``parallel/gauss_shard.py``) instead renders every view
  from this rank's rows of the state, gathered at the binning boundary.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from deblurgs_tpu_torch.core.camera import CameraArrays, CameraStatic
from deblurgs_tpu_torch.models import densify as densify_lib
from deblurgs_tpu_torch.models import gaussians as gm
from deblurgs_tpu_torch.models import motion as motion_lib
from deblurgs_tpu_torch.models import tonemap
from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig, render, render_batch
from deblurgs_tpu_torch.parallel import gauss_shard, shard
from deblurgs_tpu_torch.train import losses, optim, schedules
from deblurgs_tpu_torch.train.config import OptimizationConfig
from deblurgs_tpu_torch.utils.profiling import span


class TrainState(NamedTuple):
    params: gm.GaussianParams
    motion: motion_lib.MotionParams
    aux: gm.GaussianAux
    adam_g: optim.AdamState
    adam_m: optim.AdamState
    step: int                      # the reference's 1-based iteration
    rng: np.ndarray                # the JAX key of a carried checkpoint (unused)
    overflow_count: torch.Tensor   # [] int32: steps whose pair list was truncated


@dataclasses.dataclass(frozen=True)
class TrainStatics:
    """Everything static about the trainer (same fields as JAX's)."""

    gcfg: gm.GaussianConfig
    mcfg: motion_lib.MotionConfig
    ocfg: OptimizationConfig
    rcfg: RasterizeConfig
    cs: CameraStatic
    sh_degree: int             # active SH degree
    n_sub: int                 # sub-frames rendered this phase (1 or f)
    tone_mapping: str = "gamma"
    spatial_lr_scale: float = 1.0
    random_sample: bool = False
    white_background: bool = False  # extra opacity reset at densify_from_iter
    mesh: shard.Mesh | None = None  # sub-frame (or, through gauss_shard, Gaussian)
                                    # sharding over a process group
    batched_render: bool = False  # ONE render_batch for all views (pallas
                                  # only; else, and on xla/oracle, a loop)
    cams_per_step: int = 1     # B training cameras per step

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, shard.Mesh):
            raise TypeError(f"mesh must be a parallel.shard.Mesh, got {type(self.mesh).__name__}")


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    t_smooth: torch.Tensor
    hinge: torch.Tensor
    depth_tv: torch.Tensor
    psnr: torch.Tensor
    num_active: torch.Tensor
    num_pairs: torch.Tensor
    max_per_tile: torch.Tensor
    overflowed: torch.Tensor       # [] bool: this step truncated pairs
    overflow_count: torch.Tensor   # [] int32: cumulative truncated steps
    densify: densify_lib.DensifyReport


class StepDraws(NamedTuple):
    """A step's random numbers, in the forms JAX draws them
    (``train/step.py:136-165,334`` and ``models/densify.py:108-111``)."""

    bg: torch.Tensor                       # [3] U(0, 1): the background
    nu_u: torch.Tensor | None = None       # [B, f-2] U(0, 1): sub-frame time jitter
    noise: torch.Tensor | None = None      # [B, H, W, 3] N(0, 1): GT noise
    split: tuple | None = None             # two [P, 3] N(0, 1): split samples


def init_state(params: gm.GaussianParams, motion: motion_lib.MotionParams,
               aux: gm.GaussianAux, rng=None) -> TrainState:
    return TrainState(
        params=params, motion=motion, aux=aux, adam_g=optim.init(params),
        adam_m=optim.init(motion), step=1,
        rng=np.zeros(2, np.uint32) if rng is None else np.asarray(rng),
        overflow_count=torch.zeros((), dtype=torch.int32, device=params.xyz.device))


def _noise_scale(step: int, ocfg: OptimizationConfig) -> torch.Tensor:
    return schedules.expon_lr(step, ocfg.noise_init, ocfg.noise_final,
                              max_steps=ocfg.iterations)


def _events(step: int, ocfg: OptimizationConfig, white_background: bool):
    do_stats = step < ocfg.densify_until_iter
    do_densify = (do_stats and step > ocfg.densify_from_iter
                  and step % ocfg.densification_interval == 0)
    do_reset = do_stats and (step % ocfg.opacity_reset_interval == 0
                             or (white_background and step == ocfg.densify_from_iter))
    return do_stats, do_densify, do_reset


def draw_step(state: TrainState, st: TrainStatics, gt_shape, generator: torch.Generator
              ) -> StepDraws:
    """The draws the step at ``state.step`` needs, from ``generator``."""
    dev = state.params.xyz.device
    B = st.cams_per_step
    kw = dict(generator=generator, device=dev)
    P = _capacity(state, st)
    _, do_densify, _ = _events(state.step, st.ocfg, st.white_background)
    nu_u = None
    if st.n_sub > 1 and st.random_sample and st.mcfg.curve_random_sample:
        nu_u = torch.rand((B, state.motion.nu.shape[1]), **kw)
    bg = torch.rand(3, **kw)
    noise = None
    if float(_noise_scale(state.step, st.ocfg)) != 0.0:
        noise = torch.randn((B,) + tuple(gt_shape[-3:]), **kw)
    split = None
    if do_densify:
        split = (torch.randn((P, 3), **kw), torch.randn((P, 3), **kw))
    return StepDraws(bg=bg, nu_u=nu_u, noise=noise, split=split)


def _gauss_mesh(st: TrainStatics):
    """The step's Gaussian-axis mesh, or None."""
    return st.mesh if st.mesh is not None and st.mesh.axis == gauss_shard.GAUSS_AXIS else None


def _view_mesh(st: TrainStatics):
    """The step's sub-frame mesh, or None."""
    return st.mesh if st.mesh is not None and _gauss_mesh(st) is None else None


def _capacity(state: TrainState, st: TrainStatics) -> int:
    """The whole Gaussian capacity (a Gaussian-axis rank holds a block)."""
    g = _gauss_mesh(st)
    return state.params.xyz.shape[0] * (g.size if g is not None else 1)


def _render_views(cams: CameraArrays, rin, active, vsp, bg, st: TrainStatics):
    """Images, depths, radii and pair counts of this rank's block of the
    views ``cams`` (all of them without a sub-frame mesh): one batched
    render (pallas), else the views one by one, stacked. On a Gaussian-axis
    mesh the preprocessed fields of every rank's rows are gathered before
    binning."""
    g = _gauss_mesh(st)
    kw = dict(cfg=st.rcfg, sh_degree=st.sh_degree, active=active,
              pre_hook=None if g is None else
              (lambda pre: gauss_shard.gather_preprocessed(g, pre)))
    args = (rin["means3d"], rin["scales"], rin["rotations"], rin["opacities"], rin["shs"])
    if st.batched_render and st.rcfg.backend == "pallas":
        def block(_, views, vsp_l):
            out = render_batch(*args, views, st.cs, bg, vsp=vsp_l, **kw)
            return out.image, out.depth, out.radii, out.num_pairs, out.max_per_tile

        return shard.sharded_block_render(block, _view_mesh(st))(None, cams, vsp)

    def one(_, cam_vsp):
        out = render(*args, cam_vsp[0], st.cs, bg, vsp=cam_vsp[1], **kw)
        return out.image, out.depth, out.radii, out.num_pairs, out.max_per_tile

    return shard.sharded_subframe_render(one, _view_mesh(st))(None, cams, vsp)


class Forward(NamedTuple):
    """What :func:`forward_loss` hands to :func:`backward` and :func:`apply`."""

    total: torch.Tensor
    leaves: tuple               # the differentiated params, motion and vsp
    blurred: torch.Tensor
    gt_linear: torch.Tensor
    parts: tuple                # (l1, t_smooth, hinge, depth_tv)
    radii: torch.Tensor
    num_pairs: torch.Tensor
    max_per_tile: torch.Tensor


def forward_loss(state: TrainState, gt_image: torch.Tensor, cam_idx, proj: torch.Tensor,
                 st: TrainStatics, draws: StepDraws) -> Forward:
    """The step's forward half: sub-frame cameras from the differentiated
    curves, one batched render (or a loop), the blur and the loss. On a
    sub-frame mesh this rank renders its block of the views; on a
    Gaussian-axis mesh every view from its rows of the state."""
    ocfg, gcfg, mcfg = st.ocfg, st.gcfg, st.mcfg
    vmesh, gmesh = _view_mesh(st), _gauss_mesh(st)
    B = st.cams_per_step
    n_views = B * st.n_sub
    dev = state.params.xyz.device
    if B == 1:
        gt_image = gt_image[None]
    cam_idx = torch.as_tensor(cam_idx, dtype=torch.int64, device=dev).reshape(B)
    step = int(state.step)
    P = state.params.xyz.shape[0]
    active = state.aux.active
    bg = draws.bg
    gt_linear = tonemap.tone_map(gt_image, tonemap.inverse_kind(st.tone_mapping))
    noise = _noise_scale(step, ocfg)
    if float(noise) != 0.0:
        gt_linear = gt_linear + draws.noise * noise.to(dev)
    lambda_t_smooth = schedules.expon_lr(step, ocfg.lambda_t_smooth_init,
                                         ocfg.lambda_t_smooth_final,
                                         max_steps=ocfg.iterations).to(dev)
    n_active = (gm.num_active(active) if gmesh is None
                else gauss_shard.global_active(gmesh, active))

    # nu is sampled from the differentiated motion leaves, so the alignment
    # logits get gradients (train/step.py:138-145 of the JAX package)
    params = gm.GaussianParams(*(t.detach().requires_grad_(True) for t in state.params))
    motion = motion_lib.MotionParams(*(t.detach().requires_grad_(True) for t in state.motion))
    block = shard.local_views(vmesh, n_views)
    vsp = torch.zeros((block.stop - block.start, P, 2), dtype=torch.float32, device=dev,
                      requires_grad=True)
    # replicated leaves: their cotangents are summed over the ranks in
    # backward (the Gaussians' only on a sub-frame mesh: on the Gaussian
    # axis each rank owns its rows)
    rparams = gm.GaussianParams(*shard.replicate(vmesh, *params))
    rmotion = motion_lib.MotionParams(*shard.replicate(st.mesh, *motion))
    rin = gm.render_inputs(rparams, gcfg)
    if st.n_sub == 1:
        nu = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    else:
        nu = motion_lib.sample_nus(rmotion, cam_idx, mcfg,
                                   draws.nu_u if st.random_sample else None)
    cams = motion_lib.subframe_cameras_batch(rmotion, cam_idx, nu, proj, mcfg)
    images, depths, radii, num_pairs, max_per_tile = _render_views(
        cams, rin, active, vsp, bg, st)
    if vmesh is not None:
        # every rank computes the whole loss from every view
        images = shard.gather_rows(vmesh, images)
        depths = shard.gather_rows(vmesh, depths)
        counts = torch.stack([torch.max(num_pairs), torch.max(max_per_tile)]).to(torch.int64)
        num_pairs, max_per_tile = shard.all_reduce(vmesh, counts, "max")
    images_b = images.reshape((B, st.n_sub) + images.shape[1:])
    blurred = torch.mean(images_b, dim=1)

    l1 = losses.l1_loss(blurred, gt_linear)
    t_smooth = torch.mean(torch.stack([losses.batchwise_smoothness_loss(x) for x in images_b]))
    depth_tv = (losses.tv_loss(depths) if ocfg.lambda_depth_tv > 0.0
                else torch.zeros((), device=dev))
    x = params.opacity[:, 0]
    lo = torch.where(x <= 0.0, x, 0.0)
    hi = torch.where(x >= 1.0, x - 1.0, 0.0)
    hinge = torch.sum(torch.where(active, lo**2 + hi**2, 0.0))
    if gmesh is not None:
        hinge = shard.sum_replicated(gmesh, hinge)
    hinge = hinge / torch.clamp(n_active, min=1)
    total = (l1 + lambda_t_smooth * t_smooth + ocfg.lambda_depth_tv * depth_tv
             + ocfg.lambda_hinge * hinge)
    return Forward(total=total, leaves=tuple(params) + tuple(motion) + (vsp,), blurred=blurred,
                   gt_linear=gt_linear, parts=(l1, t_smooth, hinge, depth_tv), radii=radii,
                   num_pairs=num_pairs, max_per_tile=max_per_tile)


def backward(fwd: Forward):
    """Gradients of the loss for (params, motion, vsp): through the
    compositor's K2 and K4, and by autograd through preprocess and the
    curves."""
    grads = torch.autograd.grad(fwd.total, fwd.leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(fwd.leaves, grads)]
    return gm.GaussianParams(*grads[:6]), motion_lib.MotionParams(*grads[6:9]), grads[9]


@torch.no_grad()
def apply(state: TrainState, fwd: Forward, grads, st: TrainStatics, draws: StepDraws):
    """The step's update half: clipping, scheduled LRs, densification
    statistics, the densify/prune and opacity-reset events, Adam with its
    masks and gates, overflow detection. Returns (new state, metrics)."""
    ocfg, gcfg = st.ocfg, st.gcfg
    B = st.cams_per_step
    step = int(state.step)
    dev = state.params.xyz.device
    gmesh = _gauss_mesh(st)
    do_stats, do_densify, do_reset = _events(step, ocfg, st.white_background)
    g_params, g_motion, g_vsp = grads

    # --- optional grad-value clipping (reference train.py:204-205)
    if ocfg.clip_grad > 0.0:
        c = ocfg.clip_grad
        g_params = gm.GaussianParams(*(torch.clamp(g, -c, c) for g in g_params))
        g_motion = motion_lib.MotionParams(*(torch.clamp(g, -c, c) for g in g_motion))

    # --- per-group learning rates (gaussian_model.py:175-208)
    sls = st.spatial_lr_scale
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    lr_g = gm.GaussianParams(
        xyz=schedules.expon_lr(step, ocfg.position_lr_init * sls, ocfg.position_lr_final * sls,
                               max_steps=ocfg.iterations),
        f_dc=f32(ocfg.feature_lr), f_rest=f32(ocfg.feature_lr / 20.0),
        scaling=f32(ocfg.scaling_lr), rotation=f32(ocfg.rotation_lr),
        opacity=f32(ocfg.opacity_lr))
    lr_m = motion_lib.MotionParams(
        rot_ctrl=schedules.curve_half_life_lr(step, ocfg.curve_rotation_lr,
                                              ocfg.curve_start_iter, ocfg.curve_lr_half_iter),
        trans_ctrl=schedules.curve_half_life_lr(step, ocfg.curve_controlpoints_lr,
                                                ocfg.curve_start_iter, ocfg.curve_lr_half_iter),
        nu=schedules.warmup_exp_decay(step, ocfg.curve_alignment_lr, 1e-7,
                                      ocfg.curve_alignment_start, ocfg.iterations))

    # --- densification statistics from this step's grads, before any event
    # or Adam step (train.py:187-193); the loss averages over B cameras, so
    # the vsp cotangent is scaled back by B; on a sub-frame mesh the views'
    # sums and max are reduced over the ranks' blocks, on the Gaussian axis
    # each rank keeps its rows
    aux = state.aux
    if do_stats:
        radii = fwd.radii
        if gmesh is not None:
            radii = radii[..., gauss_shard.local_rows(gmesh, _capacity(state, st))]
        vis = radii > 0
        norm = torch.linalg.norm(g_vsp, dim=-1) * B
        accum_inc, count, radii_max = shard.reduce_view_stats(
            _view_mesh(st), torch.sum(torch.where(vis, norm, 0.0), dim=0),
            torch.sum(vis, dim=0).to(torch.float32),
            torch.max(torch.where(vis, radii, 0), dim=0).values.to(torch.float32))
        denom_inc = count / st.n_sub
        aux = aux._replace(xyz_grad_accum=aux.xyz_grad_accum + accum_inc,
                           denom=aux.denom + denom_inc,
                           max_radii2d=torch.maximum(aux.max_radii2d, radii_max))

    # --- densify / prune, then opacity reset, on the pre-update params
    # (train.py:195-201 precede :203-208)
    new_params, adam_g = state.params, state.adam_g
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    report = densify_lib.DensifyReport(zero, zero, zero, zero)
    if do_densify:
        thr = schedules.expon_lr(step, ocfg.densify_grad_threshold_init,
                                 ocfg.densify_grad_threshold_final,
                                 max_steps=ocfg.densify_annealing_until).to(dev)
        def event(p, a, ad):
            return densify_lib.densify_and_prune(
                p, a, ad, draws.split, cfg=gcfg, grad_threshold=thr,
                scene_extent=st.spatial_lr_scale, percent_dense=ocfg.percent_dense)

        with span("apply.densify"):
            new_params, aux, adam_g, report = (
                event(new_params, aux, adam_g) if gmesh is None else
                gauss_shard.densify_event(gmesh, new_params, aux, adam_g, event))
    if do_reset:
        new_params, adam_g = densify_lib.reset_opacity(new_params, adam_g, gcfg)

    # --- Adam (train.py:203-208): surgered tensors have no grads in the
    # reference, so a densify step skips every Gaussian leaf, a reset step
    # the opacity leaf, and the final step the whole optimizer
    curve_on = ocfg.curve_start_iter <= step < ocfg.curve_end_iter
    not_final = step < ocfg.iterations
    g_on = not_final and not do_densify
    mask_g = gm.GaussianParams(*([aux.active] * 6))
    gate_g = gm.GaussianParams(g_on, g_on, g_on, g_on, g_on, g_on and not do_reset)
    mask_m = motion_lib.MotionParams(*([curve_on and not_final] * 3))
    with span("apply.adam"):
        new_params, adam_g = optim.update(new_params, g_params, adam_g, lr_g,
                                          update_mask=mask_g, leaf_gate=gate_g)
        new_motion, adam_m = optim.update(state.motion, g_motion, state.adam_m, lr_m,
                                          update_mask=mask_m)

    # --- in-step overflow detection (pair capacity; on xla also the walk's
    # k_max, past which a tile's list is truncated)
    overflowed = torch.max(fwd.num_pairs) > st.rcfg.max_pairs
    if st.rcfg.backend == "xla":
        overflowed = overflowed | (torch.max(fwd.max_per_tile) > st.rcfg.k_max)
    overflow_count = state.overflow_count + overflowed.to(torch.int32)
    l1, t_smooth, hinge, depth_tv = (x.detach() for x in fwd.parts)
    metrics = StepMetrics(
        loss=fwd.total.detach(), l1=l1, t_smooth=t_smooth, hinge=hinge, depth_tv=depth_tv,
        psnr=losses.psnr(torch.clamp(fwd.blurred, 0, 1), torch.clamp(fwd.gt_linear, 0, 1)),
        num_active=(gm.num_active(aux.active) if gmesh is None
                    else gauss_shard.global_active(gmesh, aux.active)),
        num_pairs=torch.max(fwd.num_pairs),
        max_per_tile=torch.max(fwd.max_per_tile), overflowed=overflowed,
        overflow_count=overflow_count, densify=report)
    new_state = TrainState(params=new_params, motion=new_motion, aux=aux, adam_g=adam_g,
                           adam_m=adam_m, step=step + 1, rng=state.rng,
                           overflow_count=overflow_count)
    return new_state, metrics


def train_step(state: TrainState, gt_image: torch.Tensor, cam_idx, proj: torch.Tensor,
               st: TrainStatics, draws: StepDraws | None = None,
               generator: torch.Generator | None = None):
    """One optimization step: (new state, :class:`StepMetrics`).

    ``gt_image`` [H, W, 3] and ``cam_idx`` an int or [] tensor; with
    ``st.cams_per_step == B > 1``, ``gt_image`` [B, H, W, 3] and
    ``cam_idx`` [B]: the loss is the mean over B blurry observations and
    B·n_sub views render in one pass. ``draws`` defaults to
    :func:`draw_step` from ``generator`` (one seeded with the step number
    if none is given). The state's tensors are not modified in place.
    """
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=state.params.xyz.device).manual_seed(
                int(state.step))
        draws = draw_step(state, st, gt_image.shape, generator)
    with span("step.forward"):
        fwd = forward_loss(state, gt_image, cam_idx, proj, st, draws)
    with span("step.backward"):
        grads = backward(fwd)
    with span("step.apply"):
        return apply(state, fwd, grads, st, draws)


def make_train_step(st: TrainStatics):
    """The train step bound to static settings (JAX's jit wrapper; the
    port runs eagerly)."""
    return lambda state, gt, idx, proj, **kw: train_step(state, gt, idx, proj, st, **kw)
