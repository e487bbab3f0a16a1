"""Plain DeblurGS training steps from a trained scene: the reference that
the configuration ``deblurgs-field1080-late`` holds the program's steps to.

It is ``reference/train.py``'s trainer (the scene radius, the curves at
the nominal poses with their seeded jitter, the step, Adam with the
reference's schedules) with two departures:

- the Gaussians are not made from the point cloud (3-NN scales, opacity
  0.1): they are a trained run's snapshot, read from the columns of its
  PLY in the standard 3DGS layout (``GaussianModel.load_ply``: opacity
  stored as a logit, scales as logs, features channel-major) into the
  fork's parameters (clamped opacity, ``log(max(scale, 0.001))``), every
  row a Gaussian;
- one step's loss and gradients are worked out in blocks of consecutive
  sub-frames, so that a scene of millions of Gaussians fits on one card:
  first every block without autograd, for the blurred image, the loss and
  the loss's gradient in the sub-frame images; then each block again,
  with autograd, sending its share of that gradient back to the leaves,
  whose gradients are the sum over the blocks. This departs in the order
  of evaluation only: the same images, loss and sums, added up in another
  order.

``dtype`` runs all of it in another precision (the control runs it in
bfloat16). It imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import geometry as geo
from portbench.reference import render as ras
from portbench.reference import train

# sub-frames a block: a block's binning holds ~3 × 11.5M pairs
BLOCK = 3


def leaves_from_columns(cols: dict, sh_degree: int, device) -> dict:
    """The Gaussian leaves of a PLY's columns (float32 arrays by name), as
    the fork loads a standard 3DGS snapshot."""
    k = (sh_degree + 1) ** 2
    n = len(cols["x"])
    rest = sorted((c for c in cols if c.startswith("f_rest_")), key=lambda c: int(c[7:]))
    if len(rest) != 3 * (k - 1):
        raise ValueError(f"{len(rest)} f_rest columns, SH degree {sh_degree} needs {3 * (k - 1)}")
    opac = 1.0 / (1.0 + np.exp(-cols["opacity"][:, None]))
    scale = np.exp(np.stack([cols[f"scale_{i}"] for i in range(3)], -1))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    f_rest = np.stack([cols[c] for c in rest], -1).reshape(n, 3, k - 1).transpose(0, 2, 1)
    return dict(xyz=t(np.stack([cols["x"], cols["y"], cols["z"]], -1)),
                f_dc=t(np.stack([cols[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :]),
                f_rest=t(f_rest), scaling=torch.log(torch.clamp(t(scale), min=0.001)),
                rotation=t(np.stack([cols[f"rot_{i}"] for i in range(4)], -1)),
                opacity=torch.clamp(t(opac), 0.0, 1.0))


class ReferenceTrainer(train.ReferenceTrainer):
    """The reference's trainer over a trained scene's Gaussians (``columns``:
    its PLY's columns), a step's sub-frames in blocks of ``block``."""

    def __init__(self, cfg: dict, inputs: train.Inputs, columns: dict, dtype=torch.float32,
                 block: int = BLOCK):
        super().__init__(cfg, inputs, dtype)
        self.columns, self.block = columns, block

    def init_state(self, step: int) -> train.State:
        """The trained Gaussians and the curves at the nominal poses, at
        iteration ``step``, with fresh Adam moments."""
        x, f32 = self.inputs, torch.float32
        leaves = leaves_from_columns(self.columns, self.cli["sh_degree"], self.dev)
        n = leaves["xyz"].shape[0]
        # the curves as reference/train.py starts them: every control point
        # at the camera's pose, jittered by N(0, 0.001²), rotations first
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
        return train.State(leaves=leaves, mu=zeros(), nu=zeros(), t={k: 0 for k in leaves},
                           step=step, active=torch.ones(n, dtype=torch.bool, device=self.dev),
                           accum=stat, denom=stat.clone())

    def loss_and_grads(self, state: train.State, cam: int, bg: torch.Tensor):
        """``train.ReferenceTrainer.loss_and_grads`` in blocks of sub-frames:
        the loss, every leaf's gradient and the densification statistics."""
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
        bg = bg.to(self.dtype)
        blocks = [(lo, min(F, lo + self.block)) for lo in range(0, F, self.block)]

        def stage(lo: int, hi: int):
            pre = ras.project(lv["xyz"], torch.exp(lv["scaling"]), quats, opac,
                              geo.sh_color(shs, lv["xyz"], campos[lo:hi], degree),
                              views[lo:hi], self.proj, self.W, self.H,
                              math.tan(self.inputs.fovx / 2), math.tan(self.inputs.fovy / 2),
                              cli["tile"], active)
            lists = ras.bin_pairs(pre.rect, pre.depth.detach(), self.W, self.H, cli["tile"],
                                  (pre.means2d, pre.conic, pre.opacity))
            G = pre.opacity.numel()
            outs = {"xy": pre.means2d.reshape(G, 2), "conic": pre.conic.reshape(G, 3),
                    "opacity": pre.opacity.reshape(G), "color": pre.color.reshape(G, 3)}
            return pre, lists, outs

        # every block without autograd: the sub-frame images
        images = []
        with torch.no_grad():
            for lo, hi in blocks:
                _, lists, outs = stage(lo, hi)
                tiles, _, _, _ = ras.composite(outs, lists, bg)
                images.append(ras.tiles_to_images(tiles, hi - lo, lists, self.W, self.H))
                del tiles, lists, outs
        images = torch.cat(images).requires_grad_(True)
        gt_lin = torch.clamp(self.inputs.gt[cam].to(self.dtype), min=1e-8) ** 2.2
        lam_t = train.expon_lr(it, o["lambda_t_smooth_init"], o["lambda_t_smooth_final"],
                               o["iterations"]).to(self.dev, self.dtype)
        l1 = torch.mean(torch.abs(images.mean(0) - gt_lin))
        smooth = torch.mean(torch.abs(images[1:] - images[:-1]))
        loss_img = l1 + lam_t * smooth
        (d_img,) = torch.autograd.grad(loss_img, images)
        del images

        # each block again with autograd: its share of the gradient
        x = lv["opacity"][:, 0]
        hinge = torch.sum(torch.where(active, torch.where(x <= 0.0, x, 0.0) ** 2
                                      + torch.where(x >= 1.0, x - 1.0, 0.0) ** 2, 0.0)
                          ) / active.sum()
        grads = dict(zip(train.LEAVES, torch.autograd.grad(
            o["lambda_hinge"] * hinge, [lv[k] for k in train.LEAVES], allow_unused=True,
            retain_graph=True)))
        P = x.numel()
        half = torch.tensor([self.W / 2.0, self.H / 2.0], dtype=self.dtype, device=self.dev)
        accum = torch.zeros(P, dtype=torch.float32, device=self.dev)
        count = torch.zeros(P, dtype=torch.float32, device=self.dev)
        for lo, hi in blocks:
            pre, lists, outs = stage(lo, hi)
            fields = {k: v.detach().requires_grad_(True) for k, v in outs.items()}
            ras.composite_backward(fields, lists, bg, ras.images_to_tiles(d_img[lo:hi], lists))
            surrogate = sum(torch.sum(v * fields[k].grad) for k, v in outs.items()
                            if fields[k].grad is not None)
            if not torch.is_tensor(surrogate):
                continue
            part = torch.autograd.grad(surrogate, [lv[k] for k in train.LEAVES],
                                       allow_unused=True, retain_graph=True)
            for k, g in zip(train.LEAVES, part):
                if g is not None:
                    grads[k] = g if grads[k] is None else grads[k] + g
            # pixel = ((ndc + 1) * size - 1) / 2: the NDC gradient is the
            # pixel gradient times size / 2
            g_xy = fields["xy"].grad
            g_xy = torch.zeros_like(outs["xy"]) if g_xy is None else g_xy
            norm = torch.linalg.vector_norm((g_xy * half).float(), dim=-1).reshape(hi - lo, P)
            vis = pre.radius > 0
            accum += torch.where(vis, norm, 0.0).sum(0)
            count += vis.sum(0).float()
            del pre, lists, outs, fields, surrogate, part
        grads = {k: torch.zeros_like(lv[k]) if g is None else g for k, g in grads.items()}
        loss = (loss_img + o["lambda_hinge"] * hinge).detach()
        return float(loss), grads, (accum, count)
