"""Gradients of the compositor (K2 + K4) of the PyTorch port against the JAX
package's Pallas path, run in interpret mode as its own tests run it.

- ``blend_fused``'s gradients (means2d, conic, opacity, color, depth, bg)
  against ``jax.vjp`` of JAX's ``blend_fused``, default and ``fast``;
- K2's plain version + ``reduce_pair_grads`` against JAX's
  ``backward_mixed`` on the same scene (its per-Gaussian sums);
- K4's plain version against ``pallas_blend._reduce_sorted`` and
  ``segment_sum``, with NaN in the sentinel slots;
- K2's pixel-sum order over its pixel layout (warp patches at one, two or
  four pixels a thread, or row strips) is a sum of the pixels' terms, also
  on splats that straddle patch edges;
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


def _configs(n_images, need_n_contrib=False, fast=False, tile=TILE):
    kw = dict(width=W, height=H, tile_w=tile, tile_h=tile, max_pairs=MAX_PAIRS,
              need_n_contrib=need_n_contrib, fast=fast, n_images=n_images,
              layout="mixed", backend="pallas", window=2)
    return jtb.BlendConfig(interpret=True, **kw), ttb.BlendConfig(**kw)


def _scene(n_images, seed=21, tile=TILE):
    """Flattened JAX preprocess outputs (numpy) of a small scene seen by
    ``n_images`` cameras, the background, and seeded image/depth cotangents."""
    cam = make_camera(W, H, n_views=n_images) if n_images > 1 else make_camera(W, H)
    jcam, jcs = cam.jax()
    m, s, r, o, sh = to_jax(*make_gaussians(seed, n=140, sh_deg=1))
    cov6 = jras.build_covariance(s, r)

    def pre(c):
        return jras.pre_lib.preprocess(m, cov6, sh, None, o, c, jcs, sh_degree=1,
                                       tile_w=tile, tile_h=tile, tight_rect=True)

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


@pytest.mark.parametrize("fast,tile", [(False, 16), (True, 16), (False, 32)],
                         ids=["default", "fast", "t32"])
def test_plain_backward_and_reduce_match_jax_backward_mixed(fast, tile):
    """K2's plain version (tile 32: 16×8 warp patches, 2×4 of them; tile
    16: 1×2) and K4's on the staging's runs against JAX's backward_mixed."""
    jcfg, tcfg = _configs(3, fast=fast, tile=tile)
    flat, bg, _, _ = _scene(3, seed=8, tile=tile)
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


def _pair_terms(f, contrib, N, GD, w, dls, dx, dy):
    """The ten per-pixel terms of one walk step's per-pair sums, masked to
    the compositing pixels, each written out as the module docstring of
    ``csrc/backward_mixed.cu`` states it."""
    ca, cbq, cc = (f[i][:, None] for i in (2, 3, 4))
    terms = (-N * (ca * dx + cbq * dy), -N * (cc * dy + cbq * dx), -0.5 * N * dx * dx,
             -N * dx * dy, -0.5 * N * dy * dy, GD) + tuple(w * d for d in dls)
    return [torch.where(contrib, t, 0.0) for t in terms]


def _naive_pair_sums(cfg, tiles, f, contrib, N, GD, w, dls, dx, dy):
    """The per-pair sums of one walk step by ``torch.sum`` over the pixels'
    terms: an order with nothing of K2's layout in it."""
    return [t.sum(-1) for t in _pair_terms(f, contrib, N, GD, w, dls, dx, dy)]


def check_pair_sums(tile_w, tile_h, seed=0, n=6):
    """K2's per-pair sums of one walk step in its layout at this tile
    (``_patch_pair_sums``) against the same terms summed in float64, within
    float32 reassociation: 1e-5 of each row's sum of |term|. Returns the
    layout."""
    cfg = ttb.BlendConfig(width=2 * tile_w, height=2 * tile_h, tile_w=tile_w, tile_h=tile_h)
    rng = np.random.default_rng(seed)
    px = tile_w * tile_h
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))   # noqa: E731
    tiles = torch.from_numpy(rng.integers(0, cfg.num_tiles, n))
    f = torch.zeros((10, n))
    f[0], f[1] = f32(rng.uniform(0, 2 * tile_w, n)), f32(rng.uniform(0, 2 * tile_h, n))
    f[2], f[4] = f32(rng.uniform(0.05, 1.0, n)), f32(rng.uniform(0.05, 1.0, n))
    f[3] = f32(rng.uniform(-0.04, 0.04, n))
    pix_x, pix_y = cuda_blend_mixed._pixel_coords(cfg, tiles)
    dx, dy = f[0][:, None] - pix_x, f[1][:, None] - pix_y
    contrib = torch.from_numpy(rng.random((n, px)) < 0.7)
    N, GD, w, *dls = (f32(rng.standard_normal((n, px))) for _ in range(7))
    got = cuda_blend_mixed._patch_pair_sums(cfg, tiles, f, contrib, N, GD, w, dls, dx, dy)
    terms = _pair_terms(f.double(), contrib, N.double(), GD.double(), w.double(),
                        [d.double() for d in dls], dx.double(), dy.double())
    assert len(got) == len(terms) == 10
    for row, (g, t) in enumerate(zip(got, terms)):
        err = (g.double() - t.sum(-1)).abs()
        assert bool((err <= 1e-5 * t.abs().sum(-1)).all()), f"row {row}: {err.max():.3e}"
        assert bool(t.abs().sum(-1).gt(0).all())
    return cuda_blend_mixed.backward_layout(tile_w, tile_h)


def test_pixel_sum_order_is_a_sum():
    """K2's order in the row strips (a 40×20 tile, which no eight warp
    patches cover): four pixels a thread, moments a pixel."""
    assert check_pair_sums(40, 20) == (4, 0, 0, 0)


@pytest.mark.parametrize("tile_w,tile_h", [(32, 32), (16, 16), (8, 8), (16, 8), (24, 24)])
def test_patch_pixel_sum_is_a_sum(tile_w, tile_h):
    """K2's order (warp patches, four pixels a thread) covers each pixel of
    the tile once, in at most the kernel's 8 warps, and sums them."""
    pw, ph, nx, n = cuda_blend_mixed.patch_layout(tile_w, tile_h)
    assert n <= 8 and pw * ph == 128
    idx = cuda_blend_mixed.backward_pixels(tile_w, tile_h).flatten()
    assert sorted(idx[idx < tile_w * tile_h].tolist()) == list(range(tile_w * tile_h))
    if (tile_w, tile_h) == (32, 32):
        assert (pw, ph, n) == (16, 8, 8)
    cfg = ttb.BlendConfig(width=64, height=64, tile_w=tile_w, tile_h=tile_h)
    x = torch.from_numpy(np.random.default_rng(tile_w).standard_normal((5, tile_w * tile_h)))
    torch.testing.assert_close(cuda_blend_mixed._patch_pixel_sum(cfg, x), x.sum(-1))


def _edge_scene(n=400, seed=11, size=64):
    """Splats centred on and near K2's 16×8 patch edges of 32×32 tiles
    (x near multiples of 16, y near multiples of 8), with sizes from
    sub-pixel to several patches, elongated and rotated conics and
    opacities from below 1/255 to 0.99: staged inputs of one view."""
    rng = np.random.default_rng(seed)
    mx = 16.0 * rng.integers(0, size // 16 + 1, n) + rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], n)
    my = 8.0 * rng.integers(0, size // 8 + 1, n) + rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], n)
    mx += rng.uniform(-0.05, 0.05, n)
    sig = np.exp(rng.uniform(np.log(0.3), np.log(12.0), (n, 2)))
    th = rng.uniform(0, np.pi, n)
    c, s_ = np.cos(th), np.sin(th)
    cov = np.empty((n, 2, 2))
    cov[:, 0, 0] = c * c * sig[:, 0] ** 2 + s_ * s_ * sig[:, 1] ** 2 + 0.3
    cov[:, 1, 1] = s_ * s_ * sig[:, 0] ** 2 + c * c * sig[:, 1] ** 2 + 0.3
    cov[:, 0, 1] = cov[:, 1, 0] = c * s_ * (sig[:, 0] ** 2 - sig[:, 1] ** 2)
    inv = np.linalg.inv(cov)
    conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
    opac = np.exp(rng.uniform(np.log(1e-3), np.log(0.99), n))
    rad = 3.0 * np.sqrt(np.maximum(cov[:, 0, 0], cov[:, 1, 1]))
    t = size // 32
    rect = np.stack([np.clip((mx - rad) // 32, 0, t), np.clip((my - rad) // 32, 0, t),
                     np.clip((mx + rad) // 32 + 1, 0, t), np.clip((my + rad) // 32 + 1, 0, t)],
                    -1).astype(np.int32)
    area = ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])).astype(np.int32)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))   # noqa: E731
    return [f32(np.stack([mx, my], -1)), f32(conic), f32(opac), f32(rng.uniform(0, 1, (n, 3))),
            f32(rng.uniform(1, 5, n)), torch.from_numpy(rect), torch.from_numpy(area)]


@pytest.mark.parametrize("fast,tile", [(False, 32), (True, 32), (False, 16)],
                         ids=["t32", "t32_fast", "t16"])
def test_patch_order_on_straddling_splats(fast, tile):
    """On splats that straddle K2's patch edges, its plain version (pixel
    sums by warp patch, per-thread moments) gives the pixels' terms summed
    by ``torch.sum`` to float32 reassociation, and the splats do reach
    several patches."""
    size = 64
    cfg = ttb.BlendConfig(width=size, height=size, tile_w=tile, tile_h=tile, max_pairs=1 << 13,
                          need_n_contrib=False, fast=fast)
    flat = _edge_scene(size=size)
    staged = cuda_blend.sort_stage(cfg, *flat, cfg.max_pairs)
    rng = np.random.default_rng(2)
    dl_pix = torch.from_numpy(rng.standard_normal((cfg.total_tiles, cfg.tile_px, 3))
                              .astype(np.float32))
    dl_d = torch.from_numpy((0.05 * rng.standard_normal((cfg.total_tiles, cfg.tile_px)))
                            .astype(np.float32))
    C, D, T, _ = cuda_blend_mixed.forward_mixed(cfg, staged)
    total = cuda_blend_mixed.backward_total(cfg, torch.tensor([0.2, 0.3, 0.4]), T, dl_pix, dl_d,
                                            C, D)
    args = (cfg, staged.fields, staged.tile_start, staged.tile_stop, dl_pix, dl_d, total)
    patches = cuda_blend_mixed.backward_ref(*args)
    naive = cuda_blend_mixed.backward_walk(*args, None, _naive_pair_sums)
    assert bool(patches[:10].any()) and bool((patches[10:] == 0).all())
    for row in range(10):
        assert_grads_close(patches[row], naive[row], atol=1e-6, name=f"row {row}")
    # many pairs pass the gate in two patches or more
    kept = int(staged.tile_stop[-1])
    f = staged.fields[:, :kept]
    px, py = cuda_blend_mixed._pixel_coords(cfg, f[10].long())
    dx, dy = f[0][:, None] - px, f[1][:, None] - py
    power = -0.5 * (f[2][:, None] * dx * dx + f[4][:, None] * dy * dy) - f[3][:, None] * dx * dy
    gate = (power <= 0) & (f[5][:, None] * torch.exp(torch.clamp(power, max=0.0)) >= 1 / 255)
    idx = cuda_blend_mixed.backward_pixels(tile, tile).flatten(1)
    per_patch = torch.cat([gate, gate.new_zeros((kept, 1))], 1)[:, idx].any(-1)
    assert per_patch.shape[1] > 1 and int((per_patch.sum(1) > 1).sum()) > kept // 4


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
