"""Gradients of the port's whole render path against ``jax.grad`` of the JAX
package's ``render_batch`` (Pallas mixed layout, interpret mode).

The port's gradients below the compositor are plain torch autograd through
``ops/preprocess.py`` and the camera curves, as the JAX package's are
plain ``jax.grad`` (its only custom VJPs are the blends'). Checked: means3d,
scales, rotations, opacities, SH, the cameras' view / full_proj / campos,
the viewspace channel ``vsp``, and the sub-frame curve leaves (rot_ctrl,
trans_ctrl, the alignment logits nu). Tolerance: atol 5e-5 after dividing
by JAX's max |g| (JAX's blend itself lands up to 2.1e-5 from a float64
evaluation, ``tests/test_torch_backward.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.core import camera as jcam
from deblurgs_tpu.models import motion as jmm
from deblurgs_tpu.ops import rasterize as jras
from deblurgs_tpu_torch.core import camera as tcam
from deblurgs_tpu_torch.models import motion as tmm
from deblurgs_tpu_torch.ops import rasterize as tras
from tests.test_torch_backward import assert_grads_close
from tests.torch_bridge import (make_camera, make_gaussians, motion_leaves, np_of, projection,
                                to_jax, to_torch)

torch.set_num_threads(1)

W, H, F = 48, 32, 3
ATOL = 5e-5
RKW = dict(tile_w=16, tile_h=16, max_pairs=1 << 13, need_n_contrib=False, backend="pallas",
           layout="mixed", window=2)
SCENE_NAMES = ("means3d", "scales", "rotations", "opacities", "shs")


def _inputs(seed=31):
    scene = make_gaussians(seed, n=150, sh_deg=1, spread=1.2)
    cam = make_camera(W, H, n_views=F)
    rng = np.random.default_rng(seed)
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    w_img = rng.standard_normal((F, H, W, 3)).astype(np.float32)
    w_dep = (0.02 * rng.standard_normal((F, H, W))).astype(np.float32)
    active = np.ones(150, bool)
    active[::7] = False
    return scene, cam, bg, w_img, w_dep, active


def _jax_loss(scene, cams, cs, bg, w_img, w_dep, active, vsp):
    out = jras.render_batch(*scene, cams, cs, bg, cfg=jras.RasterizeConfig(interpret=True, **RKW),
                            sh_degree=1, active=active, vsp=vsp)
    return jnp.sum(out.image * w_img) + jnp.sum(out.depth * w_dep)


def _torch_loss(scene, cams, cs, bg, w_img, w_dep, active, vsp):
    out = tras.render_batch(*scene, cams, cs, bg, cfg=tras.RasterizeConfig(**RKW),
                            sh_degree=1, active=active, vsp=vsp)
    return torch.sum(out.image * w_img) + torch.sum(out.depth * w_dep)


def test_render_batch_grads_match_jax():
    scene, cam, bg, w_img, w_dep, active = _inputs()
    vsp = np.zeros((F, 150, 2), np.float32)
    jc, jcs = cam.jax()
    jscene = to_jax(*scene)
    jgrads = jax.grad(
        lambda sc, c, v: _jax_loss(sc, c, jcs, jnp.asarray(bg), jnp.asarray(w_img),
                                   jnp.asarray(w_dep), jnp.asarray(active), v),
        argnums=(0, 1, 2))(jscene, jc, jnp.asarray(vsp))

    tc, tcs = cam.torch()
    tscene = [t.requires_grad_(True) for t in to_torch(*scene)]
    tcams = tcam.CameraArrays(*(t.requires_grad_(True) for t in tc))
    tvsp = torch.zeros((F, 150, 2), requires_grad=True)
    loss = _torch_loss(tscene, tcams, tcs, torch.from_numpy(bg), torch.from_numpy(w_img),
                       torch.from_numpy(w_dep), torch.from_numpy(active), tvsp)
    got = torch.autograd.grad(loss, tscene + list(tcams) + [tvsp])

    want = list(jgrads[0]) + [jgrads[1].view, jgrads[1].full_proj, jgrads[1].campos, jgrads[2]]
    names = SCENE_NAMES + ("view", "full_proj", "campos", "vsp")
    for name, g, w in zip(names, got, want):
        assert float(np.abs(np_of(w)).max()) > 0, name
        assert_grads_close(g, w, atol=ATOL, name=name)
    # inactive slots get no gradient
    assert float(got[0][~torch.from_numpy(active)].abs().max()) == 0.0


@pytest.mark.parametrize("curve_type", ["se3", "quarternion_cartesian"])
def test_subframe_curve_grads_match_jax(curve_type):
    """Gradients reach the curve leaves through sample_nu and the sub-frame
    cameras, the alignment logits included (``tests/test_train.py:138``)."""
    scene, cam, bg, w_img, w_dep, active = _inputs(seed=32)
    leaves = motion_leaves(n_images=2, order=3, n_subframes=F, curve_type=curve_type)
    jcfg = jmm.MotionConfig(curve_order=3, n_subframes=F, curve_type=curve_type)
    tcfg = tmm.MotionConfig(curve_order=3, n_subframes=F, curve_type=curve_type)
    proj = projection(0.01, 100.0, 1.1, 2 * np.arctan(np.tan(0.55) * H / W))
    cs = cam.static
    jscene, jbg = to_jax(*scene), jnp.asarray(bg)
    idx = 1

    def jloss(rot, trans, nu):
        p = jmm.MotionParams(rot, trans, nu)
        cams = jmm.subframe_cameras(p, idx, jmm.sample_nu(p, idx, jcfg), jnp.asarray(proj), jcfg)
        return _jax_loss(jscene, cams, jcam.CameraStatic(**cs), jbg, jnp.asarray(w_img),
                         jnp.asarray(w_dep), jnp.asarray(active), None)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(leaves[f"motion/{k}"])
                                                for k in ("rot_ctrl", "trans_ctrl", "nu")))
    tleaves = tmm.MotionParams(*(torch.from_numpy(leaves[f"motion/{k}"]).requires_grad_(True)
                                 for k in ("rot_ctrl", "trans_ctrl", "nu")))
    nu = tmm.sample_nus(tleaves, [idx], tcfg)
    cams = tmm.subframe_cameras_batch(tleaves, [idx], nu, torch.from_numpy(proj), tcfg)
    loss = _torch_loss(to_torch(*scene), cams, tcam.CameraStatic(**cs), torch.from_numpy(bg),
                       torch.from_numpy(w_img), torch.from_numpy(w_dep),
                       torch.from_numpy(active), None)
    got = torch.autograd.grad(loss, tuple(tleaves))
    for name, g, w in zip(("rot_ctrl", "trans_ctrl", "nu"), got, want):
        assert float(np.abs(np_of(w)[idx]).max()) > 0, name
        assert_grads_close(g, w, atol=ATOL, name=name)
