"""Gradients of the compositor (K2 + K4) of the PyTorch port against the JAX
package's Pallas path, run in interpret mode as its own tests run it.

- ``blend_fused``'s gradients (means2d, conic, opacity, color, depth, bg)
  against ``jax.vjp`` of JAX's ``blend_fused``, default and ``fast``;
- K2's plain version + ``reduce_pair_grads`` against JAX's
  ``backward_mixed`` on the same scene (its per-Gaussian sums);
- K4's plain version against ``pallas_blend._reduce_sorted`` and
  ``segment_sum``, with NaN in the sentinel slots;
- the indefinite-conic NaN regression of ``tests/test_pallas_blend.py``.

Gradients are compared after dividing by the reference's max |g|
(``tests/test_rasterizer.py:106-108``). Against a float64 evaluation of the
same function the port lands within 2e-7 on these scenes, and JAX's Pallas
path within 1.5e-5 (2.1e-5 on the same scenes at 64×48, where a 2e-5
tolerance failed): its transmittance is exp of a prefix sum of
log(1 - alpha), and its pixel sums are moment matmuls with cancellation.
So the port is held to the float64 evaluation at 2e-6, and to JAX at 5e-5.
``JAX_PLATFORMS=cpu python -m tests.test_torch_backward [W H]`` prints
these errors. The CUDA kernels run only on the card: ``tests/test_torch_cuda.py`` holds
them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.ops import pallas_blend as jpb
from deblurgs_tpu.ops import pallas_blend_mixed as jpbm
from deblurgs_tpu.ops import rasterize as jras
from deblurgs_tpu.ops import tile_blend as jtb
from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed
from deblurgs_tpu_torch.ops import tile_blend as ttb
from tests.torch_bridge import make_camera, make_gaussians, np_of, to_jax, to_torch

torch.set_num_threads(1)

W, H, TILE, MAX_PAIRS = 48, 32, 16, 1 << 13
GRAD_ATOL = 2e-5
JAX_ATOL = 5e-5     # JAX itself lands up to 2.1e-5 from float64 (module docstring)
F64_ATOL = 2e-6
GRAD_NAMES = ("means2d", "conic", "opacity", "color", "depth", "bg")


def assert_grads_close(got, want, atol=GRAD_ATOL, name=""):
    """|got - want| / max|want| <= atol (``tests/test_rasterizer.py:106-108``)."""
    got, want = np_of(got).astype(np.float64), np_of(want).astype(np.float64)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), f"non-finite port grad: {name}"
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0, err_msg=name)


def _configs(n_images, need_n_contrib=False, fast=False):
    kw = dict(width=W, height=H, tile_w=TILE, tile_h=TILE, max_pairs=MAX_PAIRS,
              need_n_contrib=need_n_contrib, fast=fast, n_images=n_images,
              layout="mixed", backend="pallas", window=2)
    return jtb.BlendConfig(interpret=True, **kw), ttb.BlendConfig(**kw)


def _scene(n_images, seed=21):
    """Flattened JAX preprocess outputs (numpy) of a small scene seen by
    ``n_images`` cameras, the background, and seeded image/depth cotangents."""
    cam = make_camera(W, H, n_views=n_images) if n_images > 1 else make_camera(W, H)
    jcam, jcs = cam.jax()
    m, s, r, o, sh = to_jax(*make_gaussians(seed, n=140, sh_deg=1))
    cov6 = jras.build_covariance(s, r)

    def pre(c):
        return jras.pre_lib.preprocess(m, cov6, sh, None, o, c, jcs, sh_degree=1,
                                       tile_w=TILE, tile_h=TILE, tight_rect=True)

    out = jax.vmap(pre)(jcam) if n_images > 1 else pre(jcam)
    lead = 2 if n_images > 1 else 1
    flat = [np.asarray(getattr(out, k)).reshape((-1,) + np.asarray(getattr(out, k)).shape[lead:])
            for k in ("means2d", "conic", "opacity", "color", "depth", "rect", "tiles_touched")]
    rng = np.random.default_rng(seed + 1)
    img_shape = ((n_images,) if n_images > 1 else ()) + (H, W)
    bg = np.array([0.3, 0.6, 0.2], np.float32)
    w_img = rng.standard_normal(img_shape + (3,)).astype(np.float32)
    w_dep = (0.05 * rng.standard_normal(img_shape)).astype(np.float32)
    return flat, bg, w_img, w_dep


def _jax_vjp(jcfg, flat, bg, w_img, w_dep):
    diff = to_jax(*flat[:5], bg)
    rect, area = to_jax(*flat[5:7])

    def f(m, c, o, col, d, b):
        img, dep, *_ = jtb.blend_fused(jcfg, m, c, o, col, d, rect, area, b)
        return img, dep

    _, vjp = jax.vjp(f, *diff)
    return vjp((jnp.asarray(w_img), jnp.asarray(w_dep)))


def _f64_grads(tcfg, flat, bg, w_img, w_dep):
    """The same gradients from the plain versions in float64, on the port's
    float32 staging (the sorted pair list does not depend on the dtype)."""
    st = cuda_blend.sort_stage(tcfg, *to_torch(*flat), tcfg.max_pairs)
    fields = st.fields.double()
    C, D, T, _ = cuda_blend_mixed.forward_ref(tcfg, fields, st.tile_start, st.tile_stop)
    dpix = ttb._images_to_tiles(tcfg, torch.from_numpy(w_img).double())
    dd = ttb._images_to_tiles(tcfg, torch.from_numpy(w_dep).double())
    bg64 = torch.from_numpy(bg).double()
    total = cuda_blend_mixed.backward_total(tcfg, bg64, T, dpix, dd, C, D)
    pg = cuda_blend_mixed.backward_ref(tcfg, fields, st.tile_start, st.tile_stop, dpix, dd,
                                       total)
    s = cuda_blend.reduce_pair_grads(st, pg, flat[0].shape[0])
    return (s[:, 0:2], s[:, 2:5], s[:, 5], s[:, 6:9], s[:, 9],
            torch.einsum("tp,tpc->c", T, dpix))


def _torch_grads(tcfg, flat, bg, w_img, w_dep):
    diff = [t.requires_grad_(True) for t in to_torch(*flat[:5], bg)]
    rect, area = to_torch(*flat[5:7])
    img, dep, *_ = ttb.blend_fused(tcfg, *diff[:5], rect, area, diff[5])
    loss = (img * torch.from_numpy(w_img)).sum() + (dep * torch.from_numpy(w_dep)).sum()
    return torch.autograd.grad(loss, diff)


@pytest.mark.parametrize("n_images,need_n_contrib,fast",
                         [(1, False, False), (1, True, False), (3, False, False),
                          (3, False, True)],
                         ids=["F1", "F1_n_contrib", "F3", "F3_fast"])
def test_blend_grads_match_jax_vjp(n_images, need_n_contrib, fast):
    jcfg, tcfg = _configs(n_images, need_n_contrib, fast)
    flat, bg, w_img, w_dep = _scene(n_images)
    want = _jax_vjp(jcfg, flat, bg, w_img, w_dep)
    got = _torch_grads(tcfg, flat, bg, w_img, w_dep)
    exact = _f64_grads(tcfg, flat, bg, w_img, w_dep)
    for name, g, w, e in zip(GRAD_NAMES, got, want, exact):
        assert float(np.abs(np_of(w)).max()) > 0, name
        assert_grads_close(g, e, atol=F64_ATOL, name=name)
        assert_grads_close(g, w, atol=JAX_ATOL, name=name)


def _port_pair_grads(tcfg, flat, bg, dl_pix, dl_d):
    staged = cuda_blend.sort_stage(tcfg, *to_torch(*flat), tcfg.max_pairs)
    C, D, T, _ = cuda_blend_mixed.forward_mixed(tcfg, staged)
    args = (torch.from_numpy(bg), T, torch.from_numpy(dl_pix), torch.from_numpy(dl_d), C, D)
    return staged, args, cuda_blend_mixed.backward_mixed(tcfg, staged, *args)


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast"])
def test_plain_backward_and_reduce_match_jax_backward_mixed(fast):
    jcfg, tcfg = _configs(3, fast=fast)
    flat, bg, _, _ = _scene(3, seed=8)
    rng = np.random.default_rng(4)
    nt, px = tcfg.total_tiles, tcfg.tile_px
    dl_pix = rng.standard_normal((nt, px, 3)).astype(np.float32)
    dl_d = (0.05 * rng.standard_normal((nt, px))).astype(np.float32)

    jflat = to_jax(*flat)
    prep, _, _ = jpb.prepare_fused(jcfg, *jflat, jcfg.max_pairs)
    jC, jD, jT, _ = jpbm.forward_mixed(jcfg, prep)
    P = flat[0].shape[0]
    want = jpbm.backward_mixed(jcfg, prep, P, jnp.asarray(bg), jT, jnp.asarray(dl_pix),
                               jnp.asarray(dl_d), jC, jD)

    staged, args, pair_grads = _port_pair_grads(tcfg, flat, bg, dl_pix, dl_d)
    # rows 10-15 and the slots no tile range covers are zero
    assert bool((pair_grads[10:] == 0).all())
    covered = int(staged.tile_stop[-1])
    assert bool((pair_grads[:, covered:] == 0).all())
    sums = cuda_blend.reduce_pair_grads(staged, pair_grads, P)
    got = (sums[:, 0:2], sums[:, 2:5], sums[:, 5], sums[:, 6:9], sums[:, 9],
           torch.einsum("tp,tpc->c", args[1], args[2]))
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert_grads_close(g, w, atol=JAX_ATOL, name=name)


def test_plain_backward_on_a_tile_subset_and_repeat_calls():
    """The tile-subset form (as ``chip_smoke.py`` samples tiles) gives the
    full call's slots exactly, and two calls are bitwise equal."""
    _, tcfg = _configs(3)
    flat, bg, _, _ = _scene(3, seed=3)
    rng = np.random.default_rng(5)
    dl_pix = rng.standard_normal((tcfg.total_tiles, tcfg.tile_px, 3)).astype(np.float32)
    dl_d = rng.standard_normal((tcfg.total_tiles, tcfg.tile_px)).astype(np.float32)
    staged, args, full = _port_pair_grads(tcfg, flat, bg, dl_pix, dl_d)
    assert torch.equal(full, cuda_blend_mixed.backward_mixed(tcfg, staged, *args))
    tiles = torch.tensor([5, 0, 17, 11])
    total = cuda_blend_mixed.backward_total(tcfg, *args)
    sub = cuda_blend_mixed.backward_ref(tcfg, staged.fields, staged.tile_start,
                                        staged.tile_stop, args[2], args[3], total, tiles=tiles)
    for t in tiles.tolist():
        lo, hi = int(staged.tile_start[t]), int(staged.tile_stop[t])
        assert torch.equal(sub[:, lo:hi], full[:, lo:hi])
    assert int(torch.count_nonzero(sub)) == int(torch.count_nonzero(sub[:, torch.cat([
        torch.arange(int(staged.tile_start[t]), int(staged.tile_stop[t])) for t in tiles.tolist()])]))


def test_pixel_sum_order_is_a_sum():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((7, 256)))
    torch.testing.assert_close(cuda_blend_mixed._pixel_sum(x), x.sum(-1))


# ---------------------------------------------------------------------------
# K4's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_emit,P,mp", [(0, 37, 300, 1024), (3, 555, 4000, 4096)])
def test_reduce_plain_matches_jax(seed, n_emit, P, mp):
    """The cases of ``tests/test_pallas_blend.py:294-317``: ranks in runs,
    sentinel slots (rank P) holding NaN, rows 10-15 zero."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 40, n_emit)
    total = min(int(counts.sum()), mp)
    ranks = np.repeat(np.arange(n_emit), counts)[:mp]
    ranks = np.pad(ranks, (0, mp - ranks.shape[0]), constant_values=n_emit - 1)
    pg = np.where(np.arange(mp) < total, ranks, P).astype(np.int32)
    grads = rng.standard_normal((16, mp)).astype(np.float32)
    grads[10:] = 0.0
    grads[:, total:] = np.nan
    got = np_of(cuda_blend.reduce_sorted(torch.from_numpy(grads), torch.from_numpy(pg), P))
    win = np.asarray(jpb._reduce_sorted(jnp.asarray(pg), jnp.asarray(grads), P, interpret=True))
    seg = np.asarray(jax.ops.segment_sum(
        jnp.where(jnp.asarray(pg < P)[:, None], jnp.asarray(grads).T, 0.0),
        jnp.minimum(jnp.asarray(pg), P), num_segments=P + 1))[:P]
    assert got.shape == (P, 16) and np.isfinite(got).all()
    assert (got[:, 10:] == 0).all() and (got[n_emit:] == 0).all()
    np.testing.assert_allclose(got[:, :10], seg[:, :10], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got[:n_emit, :10], win[:n_emit, :10], atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the indefinite-conic NaN regression (tests/test_pallas_blend.py:320)
# ---------------------------------------------------------------------------


def _hostile_scene():
    """One 16×16 tile, three splats in depth order: [normal, HOSTILE,
    normal]; the hostile conic is indefinite, its power strictly positive
    at every pixel (far-field power > +800)."""
    return [np.array([[8.3, 8.2], [4.5, 12.5], [10.4, 6.3]], np.float32),
            np.array([[0.08, 0.01, 0.06], [-5.0, -0.1, -5.0], [0.05, 0.0, 0.05]], np.float32),
            np.array([0.8, 0.9, 0.7], np.float32),
            np.array([[0.9, 0.2, 0.1], [0.2, 0.9, 0.3], [0.1, 0.3, 0.8]], np.float32),
            np.array([2.0, 3.0, 4.0], np.float32),
            np.tile(np.array([0, 0, 1, 1], np.int32), (3, 1)),
            np.ones(3, np.int32)]


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast"])
def test_indefinite_conic_grads_are_finite_and_match_jax(fast):
    kw = dict(width=16, height=16, tile_w=16, tile_h=16, max_pairs=128, layout="mixed",
              backend="pallas", need_n_contrib=False, tile_cull=False, fast=fast)
    jcfg, tcfg = jtb.BlendConfig(interpret=True, **kw), ttb.BlendConfig(**kw)
    flat = _hostile_scene()
    bg = np.array([0.25, 0.5, 0.75], np.float32)
    w_img = np.random.default_rng(7).standard_normal((16, 16, 3)).astype(np.float32)
    w_dep = np.full((16, 16), 0.1, np.float32)
    want = _jax_vjp(jcfg, flat, bg, w_img, w_dep)
    got = _torch_grads(tcfg, flat, bg, w_img, w_dep)
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert_grads_close(g, w, name=name)
    # the hostile pair is ineligible at every pixel: its own grads are zero
    assert bool((got[1][1] == 0).all()) and float(got[2][1]) == 0.0
    assert bool((got[0][1] == 0).all())


if __name__ == "__main__":
    # Each gradient's error against the float64 evaluation, for the port and
    # for JAX (max |diff| / max |g|), on the scenes of
    # test_blend_grads_match_jax_vjp; optional frame size:
    #     JAX_PLATFORMS=cpu python -m tests.test_torch_backward [W H]
    import sys

    if len(sys.argv) == 3:
        W, H = int(sys.argv[1]), int(sys.argv[2])
    for n_images, fast in ((1, False), (3, False), (3, True)):
        jcfg, tcfg = _configs(n_images, fast=fast)
        flat, bg, w_img, w_dep = _scene(n_images)
        want = _jax_vjp(jcfg, flat, bg, w_img, w_dep)
        got = _torch_grads(tcfg, flat, bg, w_img, w_dep)
        exact = _f64_grads(tcfg, flat, bg, w_img, w_dep)
        for name, g, w, e in zip(GRAD_NAMES[:5], got, want, exact):
            e = np_of(e)
            scale = np.abs(e).max()
            print(f"{W}x{H} F={n_images} fast={fast} {name}: "
                  f"port {np.abs(np_of(g) - e).max() / scale:.2e} "
                  f"jax {np.abs(np_of(w) - e).max() / scale:.2e}")
