"""Carrying trained weights between the JAX package and the PyTorch port.

``runs/r5_jointb_state.npz`` is a JAX-trained state (9,600 Gaussians, SH
degree 2, 12 cameras, order-9 se3 curves, F = 21). It round-trips through
``from_jax_arrays`` / ``to_jax_arrays`` exactly, and a blurry ``query`` of
camera 0 from it matches the JAX package's (rendered at 64×64, fovx 1.1,
tile 16, three sub-frame times so the interpreted JAX kernel stays fast).

At that size a tile's list runs to ~2,500 pairs, and the JAX package's
Pallas kernel takes its transmittance as exp(prefix sum of log(1 - alpha))
with the prefix in split-bf16 matmuls. Its distance from the exact
(float64) sequential composite of the same pairs depends on the host: it
read 5.3e-4 on one x86 host and 1.044e-3 on another, where the port's
float32 sequential loop read 3.69e-6. So the query is held to JAX at atol
2e-3, twice the larger reading (depth, which adds T·z_far, at 5e-2), and
both are held to the float64 composite: the port within 1e-5, JAX within
2e-3, and the port never further from it than JAX. The float64 truth
must differ from the port's float32 output somewhere, or the composite
that was meant to run in float64 did not.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.core import camera as jcam
from deblurgs_tpu.models import blur as jblur
from deblurgs_tpu.models import gaussians as jgm
from deblurgs_tpu.models import motion as jmm
from deblurgs_tpu.ops import rasterize as jras
from deblurgs_tpu_torch import weights
from deblurgs_tpu_torch.core import camera as tcam
from deblurgs_tpu_torch.models import blur as tblur
from deblurgs_tpu_torch.models import motion as tmm
from deblurgs_tpu_torch.ops import cuda_blend_mixed
from deblurgs_tpu_torch.ops import rasterize as tras
from tests.torch_bridge import np_of

torch.set_num_threads(1)

STATE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "runs", "r5_jointb_state.npz")
KEYS = ("params/", "motion/", "aux/active")


@pytest.fixture(scope="module")
def state():
    with np.load(STATE) as d:
        return {k: np.array(d[k]) for k in d.files if k.startswith(KEYS)}


def test_roundtrip_is_exact(state):
    gaussians, motion, active = weights.from_jax_arrays(state, device="cpu")
    assert gaussians.cfg.sh_degree == 2 and gaussians.xyz.shape == (9600, 3)
    assert (motion.cfg.curve_order, motion.cfg.n_subframes, motion.cfg.curve_type) == (9, 21, "se3")
    assert isinstance(gaussians.xyz, torch.nn.Parameter) and active.dtype == torch.bool
    back = weights.to_jax_arrays(gaussians, motion, active)
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_quaternion_curves_are_recognised(state):
    flat = dict(state)
    flat["motion/rot_ctrl"] = np.zeros((12, 10, 4), np.float32)
    _, motion, _ = weights.from_jax_arrays(flat, device="cpu")
    assert motion.cfg.curve_type == "quarternion_cartesian"


def test_query_matches_jax(state, monkeypatch):
    size, fovx = 64, 1.1
    static = dict(width=size, height=size, tanfovx=math.tan(fovx / 2),
                  tanfovy=math.tan(fovx / 2))
    proj = np.array(jcam.get_projection_matrix(0.01, 100.0, fovx, fovx))
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    nu = np.array([0.0, 0.5, 1.0], np.float32)
    kw = dict(backend="pallas", layout="mixed", max_pairs=1 << 15, tile_w=16, tile_h=16,
              need_n_contrib=False)

    params = jgm.GaussianParams(*(jnp.asarray(state[f"params/{k}"])
                                  for k in jgm.GaussianParams._fields))
    motion_p = jmm.MotionParams(*(jnp.asarray(state[f"motion/{k}"])
                                  for k in jmm.MotionParams._fields))
    aux = jgm.GaussianAux(jnp.asarray(state["aux/active"]), None, None, None)
    a = jax.jit(lambda p, x, m: jblur.query(
        p, x, m, 0, jnp.asarray(proj), jcam.CameraStatic(**static),
        gcfg=jgm.GaussianConfig(sh_degree=2), mcfg=jmm.MotionConfig(curve_order=9, n_subframes=21),
        rcfg=jras.RasterizeConfig(interpret=True, **kw), background=jnp.asarray(bg),
        nu=jnp.asarray(nu)))(params, aux, motion_p)

    gaussians, motion, active = weights.from_jax_arrays(state, device="cpu")
    with torch.no_grad():
        b = tblur.query(gaussians, active, motion, 0, torch.from_numpy(proj),
                        tcam.CameraStatic(**static), rcfg=tras.RasterizeConfig(**kw),
                        background=torch.from_numpy(bg), nu=torch.from_numpy(nu))
        # the sharp mid-trajectory view renders too
        mid = tmm.middle_cameras(motion, torch.from_numpy(proj))
        sharp = tras.render(**gaussians.render_inputs(),
                            cam=tcam.CameraArrays(*(x[0] for x in mid)),
                            cs=tcam.CameraStatic(**static), bg=torch.from_numpy(bg),
                            cfg=tras.RasterizeConfig(**kw), sh_degree=2, active=active)
    # the same query composited in float64 by the plain version
    def exact(cfg, staged):
        out = cuda_blend_mixed.forward_ref(cfg, staged.fields.double(), staged.tile_start,
                                           staged.tile_stop)
        return tuple(x.float() if x.is_floating_point() else x for x in out)

    monkeypatch.setattr(cuda_blend_mixed, "forward_mixed", exact)
    with torch.no_grad():
        truth = np_of(tblur.query(gaussians, active, motion, 0, torch.from_numpy(proj),
                                  tcam.CameraStatic(**static), rcfg=tras.RasterizeConfig(**kw),
                                  background=torch.from_numpy(bg),
                                  nu=torch.from_numpy(nu)).blurred)
    err_port = np.abs(np_of(b.blurred) - truth).max()
    err_jax = np.abs(np_of(a.blurred) - truth).max()
    assert err_port > 0.0, "the float64 composite did not run"
    assert err_port <= 1e-5 and err_jax <= 2e-3 and err_port <= err_jax, (err_port, err_jax)
    np.testing.assert_allclose(np_of(b.blurred), np_of(a.blurred), atol=2e-3)
    # depth = D + T·z_far: JAX's transmittance drift, times z_far = 100
    np.testing.assert_allclose(np_of(b.depths), np_of(a.depths), atol=5e-2, rtol=1e-4)
    np.testing.assert_array_equal(np_of(b.radii), np_of(a.radii))
    assert np.isfinite(np_of(sharp.image)).all()
    assert int(sharp.num_pairs) <= kw["max_pairs"]
