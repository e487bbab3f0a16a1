"""iNeRF-style test-pose refinement (reference ``test.py:39-186``).

Counterpart of ``deblurgs_tpu/eval/pose_opt.py``. After curve optimisation
the trained scene's world frame has drifted from the COLMAP frame, so
held-out poses are re-fit before scoring: per test view a unit quaternion
and a translation make the view matrix, and Adam minimises the L1 error of
the tone-mapped, clamped render against the ground truth. The gradient
flows through the rasterizer's camera path as in training (on the
lockstep layout: K5 forward, K6 and K4 backward).

Hyperparameters as the reference: lr 5e-5 (rotation) / 5e-4 (translation),
ONE ``torch.optim.Adam`` over the two [n, ...] tensors with eps 1e-15 (a
step for view i still decays the other rows' moments and moves them by
their residual momentum, with one global step count: the reference's
semantics, ``test.py:154-158``), StepLR ×0.9 every ``num_iter // 20``
epochs, one epoch = one step per view in a random order. The order comes
from a ``torch.Generator`` (JAX draws it from ``PRNGKey(0)``, whose stream
torch cannot reproduce) or is passed in as ``orders``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from deblurgs_tpu_torch.core import transforms as tf
from deblurgs_tpu_torch.core.camera import CameraArrays, make_camera_arrays
from deblurgs_tpu_torch.eval.session import render_fitted
from deblurgs_tpu_torch.models import gaussians as gm
from deblurgs_tpu_torch.models import tonemap as tm
from deblurgs_tpu_torch.models.motion import _rotmat_to_quat
from deblurgs_tpu_torch.train.losses import l1_loss


class PoseParams(NamedTuple):
    quat: torch.Tensor    # [n, 4] (w, x, y, z): c2w rotation
    trans: torch.Tensor   # [n, 3]: w2c translation


def init_pose_params(rotations: torch.Tensor, translations: torch.Tensor) -> PoseParams:
    """rotations [n, 3, 3] c2w; translations [n, 3] w2c (CameraInfo R/T)."""
    return PoseParams(quat=_rotmat_to_quat(rotations.to(torch.float32)),
                      trans=translations.to(torch.float32))


def pose_to_camera(params: PoseParams, idx: int, proj: torch.Tensor) -> CameraArrays:
    """The view matrix of view ``idx`` (reference ``OptimPoseModel.forward``:
    ``view[:3, :3] = rotmat``, ``view[3, :3] = trans`` in the row-vector
    convention), differentiable in the pose."""
    R = tf.quat_to_rotmat(params.quat[idx] + 1e-8, normalize=True)
    dev = R.device
    top = torch.cat([R, torch.zeros((3, 1), dtype=R.dtype, device=dev)], dim=1)
    bottom = torch.cat([params.trans[idx], torch.ones(1, dtype=R.dtype, device=dev)])
    return make_camera_arrays(torch.cat([top, bottom[None]], dim=0), proj)


def optimize_test_poses(session, gt_images: torch.Tensor, rotations: torch.Tensor,
                        translations: torch.Tensor, proj: torch.Tensor, *,
                        num_iter_per_view: int = 2000, lr_rot: float = 5e-5,
                        lr_trans: float = 5e-4, verbose: bool = True,
                        generator: torch.Generator | None = None,
                        orders: Sequence[Sequence[int]] | None = None) -> PoseParams:
    """Refine all test poses; returns the optimised :class:`PoseParams`
    (detached). ``gt_images`` [n, H, W, 3] on the session's device;
    ``orders[epoch]`` replaces the drawn view order of that epoch."""
    init = init_pose_params(rotations, translations)
    quat = init.quat.detach().clone().requires_grad_(True)
    trans = init.trans.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([{"params": [quat], "lr": lr_rot},
                            {"params": [trans], "lr": lr_trans}], lr=lr_trans, eps=1e-15)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=max(num_iter_per_view // 20, 1),
                                            gamma=0.9)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        rin = gm.render_inputs(session.params, session.gcfg)
    n = quat.shape[0]
    bg = torch.zeros(3, device=session.device)
    ema = 0.0
    for epoch in range(num_iter_per_view):
        order = orders[epoch] if orders is not None else torch.randperm(n, generator=generator)
        for idx in [int(i) for i in order]:
            cam = pose_to_camera(PoseParams(quat, trans), idx, proj)
            out = render_fitted(session, rin, cam, bg)
            img = torch.clamp(tm.tone_map(out.image, session.tone_mapping), 0.0, 1.0)
            loss = l1_loss(img, gt_images[idx])
            opt.zero_grad(set_to_none=False)
            loss.backward()
            opt.step()
            ema = 0.6 * ema + 0.4 * float(torch.mean((img.detach() - gt_images[idx]) ** 2))
        sched.step()
        if verbose and epoch % 20 == 0:
            print(f"  pose-opt epoch {epoch}: "
                  f"PSNR={20 * math.log10(1.0 / math.sqrt(max(ema, 1e-12))):6.2f}")
    return PoseParams(quat.detach(), trans.detach())
