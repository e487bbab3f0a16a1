"""Plain DeblurGS training steps: the reference the benchmark holds the
program's first steps to.

From the inputs the benchmark hands to both sides (the point cloud and its
colours, the training cameras, the ground-truth images, the seed of the
curves' initial jitter, the split samples of a densification step), this
works out again everything the program derives: the scene radius, the 3-NN
scales and the initial Gaussians (``gaussian_model.py::create_from_pcd``),
the se(3) Bézier curves (``scene/motion.py``), and then one DeblurGS step
at a time (``train.py:104-208``): the sub-frame cameras, the render of every
sub-frame, the blur as their mean, the reverse-gamma ground truth, L1 +
temporal smoothness + opacity hinge, autograd, the densification statistics
(each visible Gaussian's view-space gradient norm in NDC units, summed over
the sub-frames), the densify-and-prune event on its cadence
(``gaussian_model.py:404-454``: clone the hot small Gaussians, split the
hot large ones into two samples at scale / 1.6, prune opacity under 0.005,
new rows with fresh moments, the statistics restarted), and Adam with the
reference's per-group learning-rate schedules (eps 1e-15, one step count a
leaf; a densify step skips the Gaussian leaves, whose tensors it replaced).
An opacity reset step is not followed.

Rows: a pruned row stays in place, inactive; a split's first child takes
its parent's row; clones and then the splits' second children are
appended, each in the order of their source rows.

``dtype`` runs all of it in another precision (the control runs it in
bfloat16). It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import geometry as geo
from portbench.reference import render as ras

GAUSS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
MOTION = ("rot_ctrl", "trans_ctrl", "nu")
LEAVES = GAUSS + MOTION


class Inputs(NamedTuple):
    """What the benchmark makes from the seed and hands to both sides."""

    points: torch.Tensor     # [N, 3] the COLMAP cloud
    colors: torch.Tensor     # [N, 3] its colours in [0, 1]
    rotations: torch.Tensor  # [n, 3, 3] c2w rotations of the training cameras
    centers: torch.Tensor    # [n, 3] their centres
    gt: torch.Tensor         # [n, H, W, 3] blurry observations in [0, 1]
    fovx: float
    fovy: float
    curve_seed: int          # seeds the generator of the curves' initial jitter


class State(NamedTuple):
    leaves: dict             # name → tensor
    mu: dict
    nu: dict
    t: dict                  # name → Adam step count (int)
    step: int
    active: torch.Tensor     # [P] bool: rows that are Gaussians (pruned rows stay, off)
    accum: torch.Tensor      # [P] float32: summed view-space gradient norms
    denom: torch.Tensor      # [P] float32: visible sub-frames / F


class Densified(NamedTuple):
    """Source rows of one densify event, and the Gaussians after it."""

    cloned: torch.Tensor     # [n] int64
    split: torch.Tensor
    pruned: torch.Tensor     # rows active before and not after
    n_active: int


def scene_radius(points: np.ndarray, centers: np.ndarray) -> float:
    """``getNerfppNorm`` with a point cloud: the smaller of the cameras'
    10th-percentile distance to the cloud's mean and 1.1× their spread."""
    d = np.linalg.norm(centers - points.mean(axis=0), axis=1)
    spread = np.max(np.linalg.norm(centers - centers.mean(axis=0), axis=1)) * 1.1
    return float(min(np.percentile(d, 10.0), spread))


def knn3_mean_sq(points: torch.Tensor, rows: int = 256) -> torch.Tensor:
    """Mean squared distance of each point to its 3 nearest others (exact)."""
    n = points.shape[0]
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    for lo in range(0, n, rows):
        q = points[lo:lo + rows]
        d2 = ((q[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        d2[torch.arange(q.shape[0]), torch.arange(lo, lo + q.shape[0])] = float("inf")
        out[lo:lo + rows] = torch.topk(d2, 3, largest=False).values.mean(-1)
    return out


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> torch.Tensor:
    """``get_expon_lr_func`` without delay, in float32."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    if lr_init <= 0.0:
        return f(0.0)
    t = torch.clamp(f(step) / float(max_steps), 0.0, 1.0)
    return torch.exp(torch.log(f(lr_init)) * (1 - t) + torch.log(f(lr_final or 1e-6)) * t)


def curve_lr(step: int, lr: float, start: int, half: int) -> torch.Tensor:
    """Curve control-point LR: halves every ``half`` steps from ``start``."""
    n = torch.clamp(torch.tensor(float(step - start + 1)), min=0.0)
    return lr * torch.pow(torch.tensor(0.5), n / half)


class ReferenceTrainer:
    """The reference's training state and steps for one configuration."""

    def __init__(self, cfg: dict, inputs: Inputs, dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cli, self.opt = cfg["cli"], cfg["optimization"]
        self.inputs = inputs
        self.dtype = dtype
        self.dev = inputs.points.device
        self.H, self.W = inputs.gt.shape[1:3]
        self.proj = geo.projection(0.01, 100.0, inputs.fovx, inputs.fovy, dtype, self.dev)
        self.extent = scene_radius(inputs.points.double().cpu().numpy(),
                                   inputs.centers.double().cpu().numpy())

    def init_state(self, step: int) -> State:
        """The initial Gaussians and curves, at iteration ``step``, with
        fresh Adam moments."""
        x = self.inputs
        f32 = torch.float32
        pts = x.points.to(f32)
        n = pts.shape[0]
        dist2 = torch.clamp(knn3_mean_sq(pts), min=1e-7)
        scale = torch.log(torch.clamp(torch.sqrt(dist2), min=0.001))
        k = (self.cli["sh_degree"] + 1) ** 2
        rotation = torch.zeros((n, 4), dtype=f32, device=self.dev)
        rotation[:, 0] = 1.0
        leaves = dict(
            xyz=pts.clone(), f_dc=((x.colors.to(f32) - 0.5) / geo.SH_C0)[:, None, :],
            f_rest=torch.zeros((n, k - 1, 3), dtype=f32, device=self.dev),
            scaling=scale[:, None].repeat(1, 3), rotation=rotation,
            opacity=torch.full((n, 1), 0.1, dtype=f32, device=self.dev))
        # the curves start at each camera's pose, every control point
        # jittered by N(0, 0.001²): rotation curves drawn first
        m = torch.zeros((x.rotations.shape[0], 4, 4), dtype=f32, device=self.dev)
        m[:, :3, :3] = x.rotations.to(f32).transpose(-1, -2)
        m[:, 3, :3] = x.centers.to(f32)
        m[:, 3, 3] = 1.0
        log6 = geo.se3_log(m)
        gen = torch.Generator(device=self.dev).manual_seed(x.curve_seed)
        c = self.cli["curve_order"] + 1
        rot = log6[:, None, 3:].repeat(1, c, 1)
        rot = rot + 0.001 * torch.randn(rot.shape, generator=gen, device=self.dev)
        trans = log6[:, None, :3].repeat(1, c, 1)
        trans = trans + 0.001 * torch.randn(trans.shape, generator=gen, device=self.dev)
        f = self.cli["num_subframes"]
        nu0 = torch.linspace(1.0 / (f - 1), 1.0 - 1.0 / (f - 1), f - 2, device=self.dev)
        nu = torch.log(nu0 / (1.0 - nu0))[None].repeat(x.rotations.shape[0], 1)
        leaves.update(rot_ctrl=rot, trans_ctrl=trans, nu=nu)
        leaves = {k: v.to(self.dtype) for k, v in leaves.items()}
        zeros = lambda: {k: torch.zeros_like(v) for k, v in leaves.items()}   # noqa: E731
        stat = torch.zeros(n, dtype=f32, device=self.dev)
        return State(leaves=leaves, mu=zeros(), nu=zeros(), t={k: 0 for k in leaves},
                     step=step, active=torch.ones(n, dtype=torch.bool, device=self.dev),
                     accum=stat, denom=stat.clone())

    def loss_and_grads(self, state: State, cam: int, bg: torch.Tensor):
        """One step's loss, the gradient of every leaf, and the step's
        densification statistics: each Gaussian's summed NDC view-space
        gradient norm over the sub-frames it is visible in, and that count."""
        it, o, cli = state.step, self.opt, self.cli
        lv = {k: v.detach().requires_grad_(True) for k, v in state.leaves.items()}
        views = geo.subframe_views(lv["rot_ctrl"][cam], lv["trans_ctrl"][cam], lv["nu"][cam])
        F = views.shape[0]
        campos = geo.camera_center(views)
        degree = min(it // 1000, cli["sh_degree"])
        shs = torch.cat([lv["f_dc"], lv["f_rest"]], 1)
        quats = lv["rotation"] / torch.clamp(torch.linalg.norm(lv["rotation"], dim=-1,
                                                                keepdim=True), min=1e-12)
        opac = torch.clamp(lv["opacity"], 0.0, 1.0)[:, 0]
        active = state.active
        pre = ras.project(lv["xyz"], torch.exp(lv["scaling"]), quats, opac,
                          geo.sh_color(shs, lv["xyz"], campos, degree), views, self.proj,
                          self.W, self.H, math.tan(self.inputs.fovx / 2),
                          math.tan(self.inputs.fovy / 2), cli["tile"], active)
        lists = ras.bin_pairs(pre.rect, pre.depth.detach(), self.W, self.H, cli["tile"],
                              (pre.means2d, pre.conic, pre.opacity))
        G = pre.opacity.numel()
        outs = {"xy": pre.means2d.reshape(G, 2), "conic": pre.conic.reshape(G, 3),
                "opacity": pre.opacity.reshape(G), "color": pre.color.reshape(G, 3)}
        fields = {k: v.detach().requires_grad_(True) for k, v in outs.items()}
        bg = bg.to(self.dtype)
        tiles, _, _, _ = ras.composite(fields, lists, bg)
        images = ras.tiles_to_images(tiles, F, lists, self.W, self.H).requires_grad_(True)
        del tiles
        gt_lin = torch.clamp(self.inputs.gt[cam].to(self.dtype), min=1e-8) ** 2.2
        lam_t = expon_lr(it, o["lambda_t_smooth_init"], o["lambda_t_smooth_final"],
                         o["iterations"]).to(self.dev, self.dtype)
        l1 = torch.mean(torch.abs(images.mean(0) - gt_lin))
        smooth = torch.mean(torch.abs(images[1:] - images[:-1]))
        loss_img = l1 + lam_t * smooth
        (d_img,) = torch.autograd.grad(loss_img, images)
        del images
        ras.composite_backward(fields, lists, bg, ras.images_to_tiles(d_img, lists))
        x = lv["opacity"][:, 0]
        hinge = torch.sum(torch.where(active, torch.where(x <= 0.0, x, 0.0) ** 2
                                      + torch.where(x >= 1.0, x - 1.0, 0.0) ** 2, 0.0)
                          ) / active.sum()
        surrogate = o["lambda_hinge"] * hinge
        for k, v in outs.items():
            if fields[k].grad is not None:
                surrogate = surrogate + torch.sum(v * fields[k].grad)
        grads = torch.autograd.grad(surrogate, [lv[k] for k in LEAVES], allow_unused=True)
        grads = {k: torch.zeros_like(lv[k]) if g is None else g for k, g in zip(LEAVES, grads)}
        loss = (loss_img + o["lambda_hinge"] * hinge).detach()
        # pixel = ((ndc + 1) * size - 1) / 2: the NDC gradient is the
        # pixel gradient times size / 2
        P = x.numel()
        g_xy = fields["xy"].grad
        g_xy = torch.zeros_like(outs["xy"]) if g_xy is None else g_xy
        half = torch.tensor([self.W / 2.0, self.H / 2.0], dtype=g_xy.dtype, device=self.dev)
        norm = torch.linalg.vector_norm((g_xy * half).float(), dim=-1).reshape(F, P)
        vis = pre.radius > 0
        stats = (torch.where(vis, norm, 0.0).sum(0), vis.sum(0).float())
        return float(loss), grads, stats

    def densify(self, state: State, split_normals) -> tuple:
        """The densify-and-prune event on the pre-update state: (state with
        the new rows, fresh moments on them and on the split rows, the
        statistics restarted; what it did)."""
        o, it, f32 = self.opt, state.step, torch.float32
        lv, active = state.leaves, state.active
        thr = expon_lr(it, o["densify_grad_threshold_init"], o["densify_grad_threshold_final"],
                       o["densify_annealing_until"]).to(self.dev)
        avg = torch.where(state.denom > 0, state.accum / state.denom, 0.0)
        scale = torch.exp(lv["scaling"].to(f32))
        small = scale.max(-1).values <= o["percent_dense"] * self.extent
        hot = active & (avg >= thr)
        clone, split = hot & small, hot & ~small
        ci, si = clone.nonzero()[:, 0], split.nonzero()[:, 0]
        # two samples of each split Gaussian, offsets from its own covariance
        rot = ras.quat_to_rot(lv["rotation"][si].to(f32) / torch.linalg.norm(
            lv["rotation"][si].to(f32), dim=-1, keepdim=True))
        n1, n2 = (n.to(self.dev)[si] for n in split_normals)
        xyz = lv["xyz"][si].to(f32)
        child = [torch.einsum("pij,pj->pi", rot, n * scale[si]) + xyz for n in (n1, n2)]
        child_scaling = torch.log(torch.clamp(scale[si] / 1.6, min=0.001))
        leaves, mu, nu = {}, dict(state.mu), dict(state.nu)
        for k in GAUSS:
            v = lv[k].clone()
            if k == "xyz":
                v[si] = child[0].to(v.dtype)
                second = child[1].to(v.dtype)
            elif k == "scaling":
                v[si] = child_scaling.to(v.dtype)
                second = v[si]
            else:
                second = v[si]
            leaves[k] = torch.cat([v, lv[k][ci], second])
            for m in (mu, nu):
                m[k] = m[k].clone()
                m[k][si] = 0
                m[k] = torch.cat([m[k], torch.zeros_like(m[k][:ci.numel() + si.numel()])])
        for k in MOTION:
            leaves[k] = lv[k]
        n_new = ci.numel() + si.numel()
        grown = torch.cat([active, torch.ones(n_new, dtype=torch.bool, device=self.dev)])
        prune = grown & (torch.clamp(leaves["opacity"][:, 0].to(f32), 0.0, 1.0) < 0.005)
        grown = grown & ~prune
        stat = torch.zeros(grown.numel(), dtype=f32, device=self.dev)
        new = state._replace(leaves=leaves, mu=mu, nu=nu, active=grown, accum=stat,
                             denom=stat.clone())
        return new, Densified(cloned=ci, split=si, pruned=prune[:active.numel()].nonzero()[:, 0],
                              n_active=int(grown.sum()))

    def step(self, state: State, cam: int, bg: torch.Tensor, split_normals=None):
        """(new state, loss, gradients, what a densify event did or None) of
        the step at ``state.step``; ``split_normals``: a densify step's two
        [P', 3] standard normal draws, indexed by row."""
        it, o = state.step, self.opt
        do_stats = it < o["densify_until_iter"]
        do_densify = (do_stats and it > o["densify_from_iter"]
                      and it % o["densification_interval"] == 0)
        if do_stats and it % o["opacity_reset_interval"] == 0:
            raise ValueError(f"the reference follows no opacity reset step (iteration {it})")
        loss, grads, (acc_inc, count) = self.loss_and_grads(state, cam, bg)
        if do_stats:
            state = state._replace(accum=state.accum + acc_inc,
                                   denom=state.denom + count / self.cli["num_subframes"])
        done = None
        if do_densify:
            state, done = self.densify(state, split_normals)
        if o["clip_grad"] > 0.0:
            grads = {k: torch.clamp(g, -o["clip_grad"], o["clip_grad"]) for k, g in grads.items()}
        sls = self.extent
        lr = dict(xyz=expon_lr(it, o["position_lr_init"] * sls, o["position_lr_final"] * sls,
                               o["iterations"]),
                  f_dc=o["feature_lr"], f_rest=o["feature_lr"] / 20.0, scaling=o["scaling_lr"],
                  rotation=o["rotation_lr"], opacity=o["opacity_lr"],
                  rot_ctrl=curve_lr(it, o["curve_rotation_lr"], o["curve_start_iter"],
                                    o["curve_lr_half_iter"]),
                  trans_ctrl=curve_lr(it, o["curve_controlpoints_lr"], o["curve_start_iter"],
                                      o["curve_lr_half_iter"]),
                  nu=0.0 if o["curve_alignment_lr"] <= 1e-8 or it <= o["curve_alignment_start"]
                  else None)
        if lr["nu"] is None:
            raise ValueError("the reference does not schedule the alignment learning rate")
        on_g = it < o["iterations"] and not do_densify
        on_m = o["curve_start_iter"] <= it < o["curve_end_iter"] and it < o["iterations"]
        leaves, mu, nu, t = (dict(state.leaves), dict(state.mu), dict(state.nu),
                             dict(state.t))
        rows = state.active[:, None]
        for k in LEAVES:
            if not (on_g if k in GAUSS else on_m):
                continue
            g = grads[k]
            t[k] += 1
            tt = torch.tensor(float(t[k]), dtype=torch.float32)
            m2 = 0.9 * mu[k] + 0.1 * g
            v2 = 0.999 * nu[k] + 0.001 * (g * g)
            m_hat = m2 / (1 - 0.9 ** tt).to(self.dev, self.dtype)
            v_hat = v2 / (1 - 0.999 ** tt).to(self.dev, self.dtype)
            step_lr = torch.as_tensor(lr[k], dtype=torch.float32).to(self.dev, self.dtype)
            upd = step_lr * m_hat / (torch.sqrt(v_hat) + 1e-15)
            if k in GAUSS:
                on = rows.reshape(rows.shape[:1] + (1,) * (g.dim() - 1))
                m2, v2 = torch.where(on, m2, mu[k]), torch.where(on, v2, nu[k])
                upd = torch.where(on, upd, 0.0)
            mu[k], nu[k] = m2, v2
            leaves[k] = leaves[k] - upd
        return (state._replace(leaves=leaves, mu=mu, nu=nu, t=t, step=it + 1), loss, grads,
                done)
