"""The lockstep layout of the PyTorch port (K5 forward, K6 backward, one
view) against the JAX package's ``layout="lockstep"`` Pallas path, run in
interpret mode as its own tests run it.

- ``blend_fused``'s outputs against JAX's at image atol 1e-5 / rtol 1e-4
  with ``n_con`` exact, in four (tile, window, need_n_contrib) cases that
  take each value of each knob;
- ``blend_fused``'s gradients against ``jax.vjp`` at 5e-5 and against a
  float64 evaluation at 2e-6 (after scaling by the reference's max |g|:
  the tolerances of ``tests/test_torch_backward.py``), and ``render``'s
  gradient into the camera's view matrix (the pose-refinement path)
  against ``jax.grad`` of JAX's ``render``;
- one view on the lockstep layout against the mixed layout: K5 and K6 run
  K1's and K2's kernels, and their plain versions are K1's and K2's, so
  outputs and gradients agree bit for bit;
- K6's (K2's) per-pair pixel sums, four pixels a thread in one, two and
  eight warp patches (16 and 32 wide), are sums of the pixels' terms;
- the configuration rules JAX applies to lockstep.

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.ops import rasterize as jras
from deblurgs_tpu.ops import tile_blend as jtb
from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_lockstep, cuda_blend_mixed
from deblurgs_tpu_torch.ops import rasterize as tras
from deblurgs_tpu_torch.ops import tile_blend as ttb
from tests.test_torch_backward import GRAD_NAMES, assert_grads_close, check_pair_sums
from tests.torch_bridge import make_camera, make_gaussians, np_of, to_jax, to_torch

torch.set_num_threads(1)

W, H, MAX_PAIRS = 64, 48, 1 << 13
JAX_ATOL = 5e-5
F64_ATOL = 2e-6


def _configs(tile, window, need_n_contrib):
    kw = dict(width=W, height=H, tile_w=tile, tile_h=tile, max_pairs=MAX_PAIRS,
              need_n_contrib=need_n_contrib, layout="lockstep", backend="pallas",
              window=window)
    return jtb.BlendConfig(interpret=True, **kw), ttb.BlendConfig(**kw)


def _scene(tile, seed=21, n=150, opacity_max=0.95):
    """JAX preprocess outputs (numpy) of one view of a seeded scene, the
    background and seeded image/depth cotangents."""
    jcam, jcs = make_camera(W, H).jax()
    m, s, r, o, sh = to_jax(*make_gaussians(seed, n=n, sh_deg=1, opacity_max=opacity_max))
    out = jras.pre_lib.preprocess(m, jras.build_covariance(s, r), sh, None, o, jcam, jcs,
                                  sh_degree=1, tile_w=tile, tile_h=tile, tight_rect=True)
    flat = [np.asarray(getattr(out, k)) for k in
            ("means2d", "conic", "opacity", "color", "depth", "rect", "tiles_touched")]
    rng = np.random.default_rng(seed + 1)
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    w_img = rng.standard_normal((H, W, 3)).astype(np.float32)
    w_dep = (0.05 * rng.standard_normal((H, W))).astype(np.float32)
    return flat, bg, w_img, w_dep


# (tile, window, need_n_contrib): each value of each knob appears
CASES = [(16, 1, True), (16, 2, False), (32, 1, False), (32, 2, True)]


def _f64_outputs(tcfg, flat, bg):
    """image, depth, final_T from K5's plain version in float64 on the
    port's float32 staging."""
    st = cuda_blend.sort_stage(tcfg, *to_torch(*flat), tcfg.max_pairs)
    out = cuda_blend_lockstep.forward_lockstep_ref(tcfg, st.fields.double(), st.tile_start,
                                                   st.tile_stop)
    return ttb.compose(tcfg, *out, torch.from_numpy(bg).double())[:3]


@pytest.mark.parametrize("tile,window,need_n_contrib", CASES,
                         ids=["t16_w1_ncon", "t16_w2", "t32_w1", "t32_w2_ncon"])
def test_lockstep_forward_matches_jax(tile, window, need_n_contrib):
    """The image at atol 1e-5 / rtol 1e-4 and ``n_con`` exactly. final_T
    and depth (= D + final_T·100) are held to JAX at 5e-5 and 5e-3: on
    these scenes JAX's transmittance, a prefix product of (1 - alpha) in
    split bf16, lands up to 3.0e-5 from a float64 evaluation of the same
    pairs, the port's float32 loop 2.8e-7. So the port is also held to
    the float64 evaluation, at 1e-6 (image, final_T) and 1e-4 (depth)."""
    jcfg, tcfg = _configs(tile, window, need_n_contrib)
    flat, bg, _, _ = _scene(tile)
    want = jtb.blend_fused(jcfg, *to_jax(*flat), jnp.asarray(bg))
    with torch.no_grad():
        got = ttb.blend_fused(tcfg, *to_torch(*flat), torch.from_numpy(bg))
        exact = _f64_outputs(tcfg, flat, bg)
    tol_jax = dict(image=(1e-5, 1e-4), depth=(5e-3, 1e-4), final_T=(5e-5, 1e-4))
    tol_f64 = dict(image=1e-6, depth=1e-4, final_T=1e-6)
    for name, g, w, e in zip(("image", "depth", "final_T"), got[:3], want[:3], exact):
        atol, rtol = tol_jax[name]
        np.testing.assert_allclose(np_of(g), np_of(w), atol=atol, rtol=rtol, err_msg=name)
        np.testing.assert_allclose(np_of(g), np_of(e), atol=tol_f64[name], rtol=0, err_msg=name)
    np.testing.assert_array_equal(np_of(got[3]), np_of(want[3]))
    assert int(got[4]) == int(want[4]) and int(got[5]) == int(want[5])
    assert int(np_of(got[3]).max()) > 0 if need_n_contrib else not np_of(got[3]).any()


def _jax_vjp(jcfg, flat, bg, w_img, w_dep):
    rect, area = to_jax(*flat[5:7])

    def f(m, c, o, col, d, b):
        img, dep, *_ = jtb.blend_fused(jcfg, m, c, o, col, d, rect, area, b)
        return img, dep

    _, vjp = jax.vjp(f, *to_jax(*flat[:5], bg))
    return vjp((jnp.asarray(w_img), jnp.asarray(w_dep)))


def _torch_grads(tcfg, flat, bg, w_img, w_dep):
    diff = [t.requires_grad_(True) for t in to_torch(*flat[:5], bg)]
    img, dep, *_ = ttb.blend_fused(tcfg, *diff[:5], *to_torch(*flat[5:7]), diff[5])
    loss = (img * torch.from_numpy(w_img)).sum() + (dep * torch.from_numpy(w_dep)).sum()
    return torch.autograd.grad(loss, diff)


def _f64_grads(tcfg, flat, bg, w_img, w_dep):
    """The same gradients from K5's and K6's plain versions in float64, on
    the port's float32 staging."""
    st = cuda_blend.sort_stage(tcfg, *to_torch(*flat), tcfg.max_pairs)
    fields = st.fields.double()
    C, D, T, _ = cuda_blend_lockstep.forward_lockstep_ref(tcfg, fields, st.tile_start,
                                                          st.tile_stop)
    dpix = ttb._images_to_tiles(tcfg, torch.from_numpy(w_img).double())
    dd = ttb._images_to_tiles(tcfg, torch.from_numpy(w_dep).double())
    bg64 = torch.from_numpy(bg).double()
    total = cuda_blend_mixed.backward_total(tcfg, bg64, T, dpix, dd, C, D)
    pg = cuda_blend_lockstep.backward_lockstep_ref(tcfg, fields, st.tile_start, st.tile_stop,
                                                   dpix, dd, total)
    s = cuda_blend.reduce_pair_grads(st, pg, flat[0].shape[0])
    return (s[:, 0:2], s[:, 2:5], s[:, 5], s[:, 6:9], s[:, 9],
            torch.einsum("tp,tpc->c", T, dpix))


@pytest.mark.parametrize("tile,window,need_n_contrib", [(16, 2, False), (32, 1, True)],
                         ids=["t16_w2", "t32_w1_ncon"])
def test_lockstep_grads_match_jax_vjp(tile, window, need_n_contrib):
    jcfg, tcfg = _configs(tile, window, need_n_contrib)
    flat, bg, w_img, w_dep = _scene(tile, seed=8)
    want = _jax_vjp(jcfg, flat, bg, w_img, w_dep)
    got = _torch_grads(tcfg, flat, bg, w_img, w_dep)
    exact = _f64_grads(tcfg, flat, bg, w_img, w_dep)
    for name, g, w, e in zip(GRAD_NAMES, got, want, exact):
        assert float(np.abs(np_of(w)).max()) > 0, name
        assert_grads_close(g, e, atol=F64_ATOL, name=name)
        assert_grads_close(g, w, atol=JAX_ATOL, name=name)


def test_render_camera_grad_matches_jax():
    """d loss / d view through ``render`` on the lockstep layout: the
    gradient that test-pose refinement follows."""
    cam = make_camera(W, H)
    (jc, jcs), (tc, tcs) = cam.jax(), cam.torch()
    gauss = make_gaussians(5, n=150, sh_deg=1, opacity_max=0.9)
    rng = np.random.default_rng(6)
    w_img = rng.standard_normal((H, W, 3)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    kw = dict(tile_w=16, tile_h=16, max_pairs=MAX_PAIRS, layout="lockstep", backend="pallas")
    jcfg = jras.RasterizeConfig(interpret=True, **kw)

    def jloss(view):
        c = jc._replace(view=view, full_proj=view @ jnp.asarray(cam.proj))
        out = jras.render(*to_jax(*gauss), c, jcs, jnp.asarray(bg), cfg=jcfg, sh_degree=1)
        return jnp.sum(out.image * jnp.asarray(w_img))

    want = jax.grad(jloss)(jc.view)
    view = tc.view.clone().requires_grad_(True)
    tcam = tc._replace(view=view, full_proj=view @ torch.from_numpy(cam.proj))
    out = tras.render(*to_torch(*gauss), tcam, tcs, torch.from_numpy(bg),
                      cfg=tras.RasterizeConfig(**kw), sh_degree=1)
    (got,) = torch.autograd.grad((out.image * torch.from_numpy(w_img)).sum(), view)
    assert float(np.abs(np_of(want)).max()) > 0
    assert_grads_close(got, want, atol=JAX_ATOL, name="d view")


@pytest.mark.parametrize("tile,need_n_contrib", [(16, True), (32, False), (8, False)])
def test_plain_versions_equal_the_mixed_ones(tile, need_n_contrib):
    """One view through ``blend_fused`` on the lockstep layout (K5/K6's
    plain versions) and on the mixed layout (K1/K2's) gives the same
    outputs and the same gradients bit for bit (16×16, 32×32 and 8×8
    tiles: one, four and one pixel a thread): K6's plain version is K2's,
    in K2's pixel layout and sum order. K6's per-slot output is zero in
    rows 10-15 and past the last tile's range."""
    _, lock = _configs(tile, 1, need_n_contrib)
    mixed = ttb.BlendConfig(**{**lock.__dict__, "layout": "mixed"})
    flat, bg, w_img, w_dep = _scene(tile, seed=3)
    outs = []
    for cfg in (lock, mixed):
        diff = [t.requires_grad_(True) for t in to_torch(*flat[:5], bg)]
        out = ttb.blend_fused(cfg, *diff[:5], *to_torch(*flat[5:7]), diff[5])
        loss = (out[0] * torch.from_numpy(w_img)).sum() + (out[1] * torch.from_numpy(w_dep)).sum()
        outs.append([o.detach() for o in out] + list(torch.autograd.grad(loss, diff)))
    assert int(np_of(outs[0][3]).max()) > 0 if need_n_contrib else not np_of(outs[0][3]).any()
    for a, b in zip(outs[0][:6], outs[1][:6]):
        assert torch.equal(a, b)
    for name, a, b in zip(GRAD_NAMES, outs[0][6:], outs[1][6:]):
        assert torch.equal(a, b), name
    st = cuda_blend.sort_stage(lock, *to_torch(*flat), lock.max_pairs)
    C, D, T, _ = cuda_blend_lockstep.forward_lockstep(lock, st)
    pg = cuda_blend_lockstep.backward_lockstep(
        lock, st, torch.from_numpy(bg), T, ttb._images_to_tiles(lock, torch.from_numpy(w_img)),
        ttb._images_to_tiles(lock, torch.from_numpy(w_dep)), C, D)
    assert bool(pg[:10].any())
    assert bool((pg[10:] == 0).all()) and bool((pg[:, int(st.tile_stop[-1]):] == 0).all())


def test_plain_backward_on_a_tile_subset():
    """The tile-subset form (as ``chip_smoke.py`` samples tiles) gives the
    full call's slots exactly and zeros elsewhere."""
    _, tcfg = _configs(16, 1, True)
    flat, bg, w_img, w_dep = _scene(16, seed=4)
    st = cuda_blend.sort_stage(tcfg, *to_torch(*flat), tcfg.max_pairs)
    C, D, T, _ = cuda_blend_lockstep.forward_lockstep(tcfg, st)
    args = (torch.from_numpy(bg), T, ttb._images_to_tiles(tcfg, torch.from_numpy(w_img)),
            ttb._images_to_tiles(tcfg, torch.from_numpy(w_dep)), C, D)
    full = cuda_blend_lockstep.backward_lockstep(tcfg, st, *args)
    total = cuda_blend_mixed.backward_total(tcfg, *args)
    tiles = torch.tensor([5, 0, 9])
    sub = cuda_blend_lockstep.backward_lockstep_ref(tcfg, st.fields, st.tile_start, st.tile_stop,
                                                    args[2], args[3], total, tiles=tiles)
    mask = torch.zeros(st.fields.shape[1], dtype=torch.bool)
    for t in tiles.tolist():
        lo, hi = int(st.tile_start[t]), int(st.tile_stop[t])
        assert hi > lo and torch.equal(sub[:, lo:hi], full[:, lo:hi])
        mask[lo:hi] = True
    assert not bool(sub[:, ~mask].any())


# tile of each pixel count: K2's layout there (patch width, warp patches)
SUM_TILES = {64: ((8, 8), (8, 1)), 256: ((16, 16), (16, 2)), 500: ((250, 2), (32, 8)),
             1024: ((32, 32), (16, 8))}


@pytest.mark.parametrize("px", [64, 256, 500, 1024])
def test_pixel_sum_order_is_a_sum(px):
    """K6's (K2's) per-pair sums of one walk step, four pixels a thread in
    one, two and eight warp patches, 8, 16 and 32 pixels wide (the 8×8
    tile leaves half the patch's places empty), against the pixels' terms
    summed in float64 (within float32 reassociation)."""
    (tile_w, tile_h), want = SUM_TILES[px]
    ppt, pw, _, n = check_pair_sums(tile_w, tile_h, seed=px)
    assert (ppt, pw, n) == (4,) + want


def test_lockstep_config_rules_match_jax():
    """``fast`` and ``chunk`` are refused with lockstep, as in JAX;
    ``window`` is accepted and has no effect; stacked views are refused."""
    base = dict(width=W, height=H, layout="lockstep", need_n_contrib=False)
    for kw in (dict(fast=True), dict(chunk=256, max_pairs=1024)):
        for cls in (jtb.BlendConfig, ttb.BlendConfig):
            with pytest.raises(ValueError):
                cls(**base, **kw)
    flat, _, _, _ = _scene(16)
    outs = []
    for window in (1, 4):
        _, tcfg = _configs(16, window, False)
        with torch.no_grad():
            outs.append(ttb.blend_fused(tcfg, *to_torch(*flat), torch.zeros(3)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    cfg3 = ttb.BlendConfig(**base, n_images=3)
    with pytest.raises(NotImplementedError, match="mixed"):
        cuda_blend.sort_stage(cfg3, *to_torch(*[np.concatenate([x] * 3) for x in flat]), 4096)
