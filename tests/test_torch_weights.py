"""Carrying trained weights between the JAX package and the PyTorch port.

``runs/r5_jointb_state.npz`` is a JAX-trained state (9,600 Gaussians, SH
degree 2, 12 cameras, order-9 se3 curves, F = 21). It round-trips through
``from_jax_arrays`` / ``to_jax_arrays`` exactly, and a blurry ``query`` of
camera 0 from it matches the JAX package's (rendered at 64×64, fovx 1.1,
tile 16, three sub-frame times so the interpreted JAX kernel stays fast).

At that size a tile's list runs to ~2,500 pairs. The query's numbers:

- ``err_port``: the port's float32 query against the same composite in
  float64 arithmetic under the port's own float32 gate decisions (alpha
  >= 1/255, power <= 0, the stop before T < 1e-4; :func:`gated_composite`).
  It measures arithmetic alone and is held at 1e-5 (3.4e-6 read).
- gate flips: a pair whose float32 and float64 alphas fall on either side
  of 1/255 (or whose T falls on either side of 1e-4) is composited in one
  walk and dropped in the other, and which pairs sit on a threshold
  depends on the host's float32 rounding upstream. On one x86 host one
  pair flipped on the alpha gate (sub-frame 0, pixel (27, 53), pair 264 of
  its tile: alpha 0.00392158 in float32, 0.00392146 in float64, T 0.0477),
  moving that pixel 2.8e-5 (its bound below: 2.0e-4). So the float64
  walk with its own decisions is held apart: it may differ from the gated
  one only at flipped pixels, each by at most the flipped pairs' share
  alpha·T·M (T·M for a stop flip; M the largest colour or background
  value, which bounds the pair's own term and everything behind it) over
  the blur's sub-frames, and at no more than ``FLIP_SHARE`` of the pixels.
- ``err_jax``: the JAX package's Pallas kernel takes its transmittance as
  exp(prefix sum of log(1 - alpha)) with the prefix in split-bf16 matmuls;
  it read 5.3e-4 on one x86 host and 1.044e-3 on another from the float64
  composite. The query is held to JAX at atol 2e-3, twice the larger
  reading (depth, which adds T·z_far, at 5e-2), JAX to the float64
  composite within 2e-3, and the port never further from it than JAX.
  The float64 composite must differ from the port's float32 output
  somewhere, or the composite meant to run in float64 did not.
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
from deblurgs_tpu_torch.ops import tile_blend
from tests.torch_bridge import np_of

torch.set_num_threads(1)

STATE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "runs", "r5_jointb_state.npz")
KEYS = ("params/", "motion/", "aux/active")
# at most this share of the query's pixels may move with a gate flip
FLIP_SHARE = 1e-3


def gated_composite(cfg, staged, bg, own_gates: bool):
    """K1's plain walk (``forward_ref``'s arithmetic, pair by pair) in
    float64, its gate decisions (elig, stop) taken from the same walk in
    float32 unless ``own_gates``. Returns the float32 (C, D, final_T,
    n_con) and, per tile pixel, the flip bound: the sum of alpha·T·M (T·M
    for a stop) over the pairs whose float64 decision differs from the one
    taken, M the largest colour or background value."""
    start, stop_ = staged.tile_start.long(), staged.tile_stop.long()
    count, px = stop_ - start, cfg.tile_px
    pix = [p.double() for p in cuda_blend_mixed._pixel_coords(cfg, torch.arange(len(start)))]
    walks = [staged.fields.double()] + ([] if own_gates else [staged.fields])
    T = [torch.ones((len(start), px), dtype=f.dtype) for f in walks]
    done = [torch.zeros((len(start), px), dtype=torch.bool) for _ in walks]
    C = torch.zeros((len(start), px, 3), dtype=torch.float64)
    D = torch.zeros((len(start), px), dtype=torch.float64)
    bound = torch.zeros_like(D)
    M = max(float(staged.fields[6:9, :int(stop_.max())].max()), float(bg.max()))
    for k in range(int(count.max())):
        live = torch.nonzero(count > k)[:, 0]
        gates = []
        for f, Tw, dw in zip(walks, T, done):
            ff = f[:10, start[live] + k]
            dx = ff[0][:, None] - pix[0][live].to(f.dtype)
            dy = ff[1][:, None] - pix[1][live].to(f.dtype)
            power = (-0.5 * (ff[2][:, None] * dx * dx + ff[4][:, None] * dy * dy)
                     - ff[3][:, None] * dx * dy)
            alpha = torch.clamp(ff[5][:, None] * torch.exp(torch.clamp(power, max=0.0)),
                                max=0.99)
            elig = ~dw[live] & (power <= 0.0) & (alpha >= cuda_blend_mixed._ALPHA_MIN)
            test_T = Tw[live] * (1.0 - alpha)
            gates.append((elig, elig & (test_T < cuda_blend_mixed._T_EPS), alpha, test_T))
        elig, stop = gates[-1][:2]
        e64, s64, alpha, _ = gates[0]
        Tm = T[0][live]
        flip_share = torch.where(stop | s64, Tm, alpha * Tm) * M
        bound[live] += torch.where((e64 != elig) | (s64 != stop), flip_share, 0.0)
        contrib = elig & ~stop
        for (_, _, _, test_T), Tw, dw in zip(gates, T, done):
            dw[live] |= stop
            Tw[live] = torch.where(contrib, test_T, Tw[live])
        w = torch.where(contrib, alpha * Tm, 0.0)
        ff = walks[0][:10, start[live] + k]
        C[live] += w[..., None] * ff[6:9].T[:, None, :]
        D[live] += w * ff[9][:, None]
    n_con = torch.zeros((len(start), px), dtype=torch.int32)
    return (C.float(), D.float(), T[0].float(), n_con), bound


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
    # the same query composited in float64, under the float32 gate decisions
    # and under its own
    def query64(own_gates):
        bounds = []

        def exact(cfg, staged):
            out, bound = gated_composite(cfg, staged, torch.from_numpy(bg), own_gates)
            bounds.append(tile_blend._tiles_to_images(cfg, bound))
            return out

        monkeypatch.setattr(cuda_blend_mixed, "forward_mixed", exact)
        with torch.no_grad():
            image = tblur.query(gaussians, active, motion, 0, torch.from_numpy(proj),
                                tcam.CameraStatic(**static), rcfg=tras.RasterizeConfig(**kw),
                                background=torch.from_numpy(bg), nu=torch.from_numpy(nu)).blurred
        return np_of(image), np_of(sum(bounds) / len(bounds))

    truth, flip_bound = query64(own_gates=False)
    truth_own, no_bound = query64(own_gates=True)
    assert not no_bound.any()
    err_port = np.abs(np_of(b.blurred) - truth).max()
    err_jax = np.abs(np_of(a.blurred) - truth).max()
    assert err_port > 0.0, "the float64 composite did not run"
    assert err_port <= 1e-5 and err_jax <= 2e-3 and err_port <= err_jax, (err_port, err_jax)
    # the float64 walk's own gate decisions move only the flipped pixels,
    # each within its flipped pairs' share
    moved = np.abs(truth_own - truth)
    flipped = (moved > 0).any(-1)
    assert (moved <= flip_bound[..., None]).all(), (moved.max(), flip_bound[flipped])
    assert flipped.sum() <= FLIP_SHARE * flipped.size, np.argwhere(flipped)
    np.testing.assert_allclose(np_of(b.blurred), np_of(a.blurred), atol=2e-3)
    # depth = D + T·z_far: JAX's transmittance drift, times z_far = 100
    np.testing.assert_allclose(np_of(b.depths), np_of(a.depths), atol=5e-2, rtol=1e-4)
    np.testing.assert_array_equal(np_of(b.radii), np_of(a.radii))
    assert np.isfinite(np_of(sharp.image)).all()
    assert int(sharp.num_pairs) <= kw["max_pairs"]
