"""Staging (K3 + the sort) and compositing (K1) of the PyTorch port against
the JAX package's Pallas path, run in interpret mode as its own tests run it.

- staging against ``pallas_blend._sort_stage``: integer outputs exactly,
  field rows at atol 1e-6, tile cull on and off, F = 1 and F = 3;
- K3's plain version against ``broadcast_fields(..., interpret=True)``,
  bitwise on the slots below ``total``;
- K1's plain version against ``forward_mixed`` on the same staged fields:
  C, D, final_T at atol 1e-5 / rtol 1e-4 (``tests/test_rasterizer.py``'s
  tolerance), ``n_con`` exactly;
- the hostile scenes of ``tests/test_pallas_blend.py`` (their gradients are
  in ``tests/test_torch_backward.py``).

The CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
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
from deblurgs_tpu_torch.device import resolve_device
from deblurgs_tpu_torch.ops import binning as tbin
from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed
from deblurgs_tpu_torch.ops import rasterize as tras
from deblurgs_tpu_torch.ops import tile_blend as ttb
from tests.torch_bridge import make_camera, make_gaussians, np_of, to_jax, to_torch

torch.set_num_threads(1)

W, H, TILE, MAX_PAIRS = 48, 32, 8, 1 << 12
STAGED = ("fields", "s_tile", "s_gc", "ids", "n_emit", "tile_start", "tile_stop",
          "total", "max_per_tile")


def _blend_configs(n_images, need_n_contrib, fast=False, width=W, height=H, tile=TILE,
                   max_pairs=MAX_PAIRS, window=2, tile_cull=True):
    kw = dict(width=width, height=height, tile_w=tile, tile_h=tile, max_pairs=max_pairs,
              need_n_contrib=need_n_contrib, fast=fast, n_images=n_images,
              layout="mixed", backend="pallas", window=window, tile_cull=tile_cull)
    return jtb.BlendConfig(interpret=True, **kw), ttb.BlendConfig(**kw)


def _preprocessed(n_images, seed=13):
    """Flattened JAX preprocess outputs of a small scene (numpy), the
    common input of both stagings."""
    cam = make_camera(W, H, n_views=n_images) if n_images > 1 else make_camera(W, H)
    jcam, jcs = cam.jax()
    m, s, r, o, sh = to_jax(*make_gaussians(seed, n=120, sh_deg=1))
    rcfg = jras.RasterizeConfig(tile_w=TILE, tile_h=TILE)
    cov6 = jras.build_covariance(s, r)

    def pre(c):
        return jras.pre_lib.preprocess(m, cov6, sh, None, o, c, jcs, sh_degree=1,
                                       tile_w=rcfg.tile_w, tile_h=rcfg.tile_h,
                                       tight_rect=True)

    out = jax.vmap(pre)(jcam) if n_images > 1 else pre(jcam)
    flat = lambda x: np.asarray(x).reshape((-1,) + np.asarray(x).shape[(2 if n_images > 1 else 1):])  # noqa: E731
    return [flat(getattr(out, k)) for k in
            ("means2d", "conic", "opacity", "color", "depth", "rect", "tiles_touched")]


def _jax_stage(jcfg, pre):
    """JAX's staging, jitted (one compile instead of one per operator)."""
    return jax.jit(lambda *x: jpb._sort_stage(jcfg, *x, jcfg.max_pairs))(*to_jax(*pre))


def _stage_both(jcfg, tcfg, pre):
    a = _jax_stage(jcfg, pre)
    b = cuda_blend.sort_stage(tcfg, *to_torch(*pre), tcfg.max_pairs)
    return a, b


def _staged_from_jax(a) -> cuda_blend.Staged:
    return cuda_blend.Staged(*(torch.from_numpy(np.array(x)) for x in a))


@pytest.mark.parametrize("n_images", [1, 3])
@pytest.mark.parametrize("need_n_contrib", [True, False], ids=["cull_off", "cull_on"])
def test_staging_matches_jax(n_images, need_n_contrib):
    jcfg, tcfg = _blend_configs(n_images, need_n_contrib)
    a, b = _stage_both(jcfg, tcfg, _preprocessed(n_images))
    total = int(np_of(b.total))
    assert 0 < total <= MAX_PAIRS
    for name, x, y in zip(STAGED, a, b):
        if name == "fields":
            np.testing.assert_allclose(np_of(y), np_of(x), atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(np_of(y), np_of(x), err_msg=name)
    # the cull retires pairs to the sentinel tail
    kept = int((np_of(b.s_tile) < tcfg.total_tiles).sum())
    assert (kept < total) == (not need_n_contrib)


def test_staging_overflow_keeps_truncation():
    """A pair budget below the emitted count: the slots past it are
    dropped and ``total`` still reports the full count."""
    pre = _preprocessed(1)
    jcfg, tcfg = _blend_configs(1, True, max_pairs=256)
    a, b = _stage_both(jcfg, tcfg, pre)
    assert int(np_of(b.total)) > 256
    for name, x, y in zip(STAGED, a, b):
        if name == "fields":
            np.testing.assert_allclose(np_of(y), np_of(x), atol=1e-6, err_msg=name)
        elif name != "tile_stop":
            np.testing.assert_array_equal(np_of(y), np_of(x), err_msg=name)


def _edge_preprocessed(n_images):
    """``_preprocessed`` with hostile rows among the emitting Gaussians: a
    depth of -0.0, negative depths and a conic whose tile-box edges
    overflow (inf - inf on some edges, +inf on others). No NaN: JAX's
    one-hot matmul broadcast spreads one to every slot of its window
    (0 · NaN), the port's copy does not (a NaN row is held on the card)."""
    pre = [x.copy() for x in _preprocessed(n_images)]
    conic, depth = pre[1], pre[4]
    emit = np.flatnonzero(pre[6] > 0)
    depth[emit[2]] = -0.0
    depth[emit[4]] = -2.0
    depth[emit[len(emit) // 2]] = -1e-3
    conic[emit[8]] = (1e38, 0.0, -1e38)
    return pre


def _jax_sort_operands(monkeypatch, jcfg, pre):
    """What JAX's ``_sort_stage`` hands its stable sort: the per-slot tile
    id, depth key and rank (``pallas_blend.py:314-342``), read off the
    ``jax.lax.sort`` call inside the jitted stage."""
    seen = []
    real = jax.lax.sort

    def spy(operands, *args, **kwargs):
        if kwargs.get("num_keys") == 2:     # the (tile, depth) sort, not a search's
            seen.append(operands[:3])
        return real(operands, *args, **kwargs)

    def run(*x):
        jpb._sort_stage(jcfg, *x, jcfg.max_pairs)
        (operands,) = seen
        return operands

    monkeypatch.setattr(jax.lax, "sort", spy)
    return [np.asarray(x) for x in jax.jit(run)(*to_jax(*pre))]


# (n_images, need_n_contrib, max_pairs): a culled pair, the stacked-tile
# offset, the overflow slots' sentinels, the uncut lists
SLOT_KEY_CASES = [(1, False, MAX_PAIRS), (3, False, MAX_PAIRS), (3, False, 256),
                  (1, True, MAX_PAIRS)]


@pytest.mark.parametrize("n_images,need_n_contrib,max_pairs", SLOT_KEY_CASES,
                         ids=["F1-cull_on", "F3-cull_on", "F3-overflow", "F1-cull_off"])
def test_slot_keys_match_jax(monkeypatch, n_images, need_n_contrib, max_pairs):
    """The plain version of K3's key epilogue (``slot_keys_ref``, which the
    CPU path runs) against JAX's staging before its sort, bit for bit:
    tile ids, depth keys and ranks, with -0.0, negative depths and an
    overflowing conic among the rows; the packed key orders as JAX's
    (tile, depth)."""
    jcfg, tcfg = _blend_configs(n_images, need_n_contrib, max_pairs=max_pairs)
    pre = _edge_preprocessed(n_images)
    j_tile, j_depth, j_gc = _jax_sort_operands(monkeypatch, jcfg, pre)
    c = cuda_blend.compact_table(tcfg, *to_torch(*pre), max_pairs)
    keys = cuda_blend.broadcast_keys(tcfg, c)[1]      # the CPU path: slot_keys_ref
    np.testing.assert_array_equal(np_of(keys.tile), j_tile)
    # as values: JAX's broadcast is a one-hot matmul, whose sum turns -0.0
    # into +0.0; the port's copies the bits (the key packs both as +0.0)
    np.testing.assert_array_equal(np_of(keys.depth_key), j_depth)
    np.testing.assert_array_equal(np_of(keys.gc_sent), j_gc)
    key = np_of(keys.key)
    np.testing.assert_array_equal(key >> 32, j_tile)
    np.testing.assert_array_equal(np.argsort(key, kind="stable"),
                                  np.lexsort((j_depth + np.float32(0.0), j_tile)))
    # the case holds what it names
    total, tt = int(c.total), tcfg.total_tiles
    live = np.arange(max_pairs) < min(total, max_pairs)
    kept = j_tile < tt
    assert (kept[live].all()) == need_n_contrib
    assert (j_tile[~live] == tt).all() and (j_depth[~live] == np.float32(3e37)).all()
    assert (j_gc[~live] == c.ctable.shape[0]).all()
    assert (total > max_pairs) == (max_pairs < MAX_PAIRS)
    assert (j_tile[kept] >= tcfg.num_tiles).any() == (n_images > 1 and max_pairs == MAX_PAIRS)
    assert (j_depth[kept] < 0).any()
    if max_pairs == MAX_PAIRS:
        depth = np_of(keys.depth_key)[kept]
        assert (np.signbit(depth) & (depth == 0)).any()


@pytest.mark.parametrize("n_images,max_pairs", [(1, MAX_PAIRS), (3, MAX_PAIRS), (3, 256)],
                         ids=["F1", "F3", "F3-overflow"])
def test_permute_plain_holds_what_k7_relies_on(n_images, max_pairs):
    """K7's plain version (``permute_sorted_ref``) against the rules K7
    computes by: the sorted tile id is the sorted key's high half; rows
    11-12 are the per-image tile's origin, the sentinel rows' from the
    modulo for stacked views only (0, 0), and (0, tiles_y · tile_h) for one
    view; a -0.0 depth stays -0.0; the rank and inverse follow the sort."""
    _, tcfg = _blend_configs(n_images, False, max_pairs=max_pairs)
    c = cuda_blend.compact_table(tcfg, *to_torch(*_edge_preprocessed(n_images)), max_pairs)
    fslot, keys = cuda_blend.broadcast_keys(tcfg, c)       # the CPU path: slot_keys_ref
    srt = torch.sort(keys.key, stable=True)
    fields, s_tile, s_gc, inv = cuda_blend.permute_sorted_ref(tcfg, fslot, c, keys, srt)
    order = srt.indices
    assert torch.equal(s_tile, srt.values >> 32)
    assert torch.equal(fields[10], s_tile.float())
    kept = s_tile < tcfg.total_tiles
    assert 0 < int(kept.sum()) < max_pairs
    tx0, ty0 = fields[11].long(), fields[12].long()
    view = s_tile[kept] // tcfg.num_tiles
    assert torch.equal(view * tcfg.num_tiles + ty0[kept] // tcfg.tile_h * tcfg.tiles_x
                       + tx0[kept] // tcfg.tile_w, s_tile[kept])
    assert bool((tx0[kept] < tcfg.width).all()) and bool((ty0[kept] < tcfg.height).all())
    assert bool((view > 0).any()) == (n_images > 1 and max_pairs == MAX_PAIRS)
    assert bool((tx0[~kept] == 0).all())
    assert bool((ty0[~kept] == (tcfg.tiles_y * tcfg.tile_h if n_images == 1 else 0)).all())
    depth = fields[9]
    np.testing.assert_array_equal(np_of(depth.view(torch.int32)),
                                  np_of(keys.depth_key[order].view(torch.int32)))
    assert bool((kept & (depth == 0) & torch.signbit(depth)).any())
    assert torch.equal(s_gc, keys.gc_sent[order])
    assert torch.equal(inv[order], torch.arange(max_pairs, dtype=torch.int32))
    assert bool((fields[13:] == 0).all())


def test_depth_order_key():
    """The packed sort key orders f32 depths like the floats themselves,
    with the 3e37 sentinel last."""
    d = torch.tensor([3e37, 0.5, 1e-30, 7.0, 0.0, 2.5, 1e30, 0.2500001, 0.25])
    key = tbin.depth_order_bits(d)
    assert torch.equal(torch.argsort(key, stable=True), torch.argsort(d, stable=True))


@pytest.mark.parametrize("seed,n_emit,p,max_pairs", [(0, 37, 300, 1024), (3, 200, 700, 2048)])
def test_broadcast_plain_matches_jax_kernel(seed, n_emit, p, max_pairs):
    rng = np.random.default_rng(seed)
    area = np.zeros(p, np.int32)
    area[np.sort(rng.choice(p, n_emit, replace=False))] = rng.integers(1, 12, n_emit)
    ctable = rng.standard_normal((p, 16)).astype(np.float32)
    gauss_c, _, _, _, total = tbin.expand_compact(torch.from_numpy(area), max_pairs)
    total = min(int(total), max_pairs)
    got = cuda_blend.broadcast_fields_ref(torch.from_numpy(ctable), gauss_c)
    ref = jpb.broadcast_fields(jnp.asarray(ctable), jnp.asarray(np_of(gauss_c).astype(np.int32)),
                               interpret=True)
    assert got.shape == (16, max_pairs)
    np.testing.assert_array_equal(np_of(got)[:, :total], np.asarray(ref)[:, :total])


def test_broadcast_plain_matches_jax_past_the_table():
    """Ranks at and past the table's last row (P, P + 1, ... as sentinel
    slots carry): JAX's one-hot matmul over zero-padded rows gives 0
    there, and so does K3's plain version, bit for bit everywhere."""
    rng = np.random.default_rng(9)
    p, max_pairs = 300, 1024
    ctable = rng.standard_normal((p, 16)).astype(np.float32)
    ranks = np.sort(rng.integers(160, p + 40, max_pairs)).astype(np.int32)
    assert (ranks >= p).sum() > 50
    got = cuda_blend.broadcast_fields_ref(torch.from_numpy(ctable), torch.from_numpy(ranks))
    ref = jpb.broadcast_fields(jnp.asarray(ctable), jnp.asarray(ranks), interpret=True)
    np.testing.assert_array_equal(np_of(got), np.asarray(ref))
    assert (np_of(got)[:, ranks >= p] == 0).all()


K1_CASES = [(True, False), (False, False), (False, True)]


@pytest.mark.parametrize("need_n_contrib,fast", K1_CASES, ids=["n_contrib", "plain", "fast"])
def test_composite_plain_matches_jax_kernel(need_n_contrib, fast):
    jcfg, tcfg = _blend_configs(3, need_n_contrib, fast=fast)
    a = _jax_stage(jcfg, _preprocessed(3))
    ref = jax.jit(lambda *x: jpbm.forward_mixed(
        jcfg, jpbm.prepare_mixed(jcfg, *x, jcfg.max_pairs)))(*a[:-1])
    got = cuda_blend_mixed.forward_mixed(tcfg, _staged_from_jax(a))
    for name, x, y in zip(("C", "D", "final_T"), ref[:3], got[:3]):
        np.testing.assert_allclose(np_of(y), np_of(x), atol=1e-5, rtol=1e-4, err_msg=name)
    np.testing.assert_array_equal(np_of(got[3]), np_of(ref[3]))
    if need_n_contrib:
        assert np_of(got[3]).max() > 1


# ---------------------------------------------------------------------------
# hostile scenes (tests/test_pallas_blend.py)
# ---------------------------------------------------------------------------


def _render_both(gauss, cam, bg, jcfg, tcfg, sh_degree=1):
    jc, jcs = cam.jax()
    tc, tcs = cam.torch()
    a = jax.jit(lambda *g: jras.render(*g, jc, jcs, jnp.asarray(bg), cfg=jcfg,
                                       sh_degree=sh_degree))(*to_jax(*gauss))
    b = tras.render(*to_torch(*gauss), tc, tcs, torch.from_numpy(bg), cfg=tcfg,
                    sh_degree=sh_degree)
    return a, b


def _wall(n=120, seed=21):
    """Opaque wall of Gaussians: T crosses 1e-4 (freeze semantics)."""
    means, scales, rots, opac, shs = make_gaussians(seed, n=n, sh_deg=1, opacity_max=0.95)
    rng = np.random.default_rng(31)
    means = np.stack([0.2 * rng.standard_normal(n), 0.2 * rng.standard_normal(n),
                      np.linspace(-0.5, 0.5, n)], axis=-1).astype(np.float32)
    return means, scales, rots, np.full_like(opac, 0.98), shs


def test_early_termination_scene():
    """The wall seen from three views in one batched render (the shapes
    of the tests above, so the interpreted kernels are already built)."""
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    cam = make_camera(W, H, n_views=3)
    jc, jcs = cam.jax()
    tc, tcs = cam.torch()
    kw = dict(max_pairs=MAX_PAIRS, layout="mixed", backend="pallas", window=2,
              tile_w=TILE, tile_h=TILE)
    gauss = _wall()
    jcfg = jras.RasterizeConfig(interpret=True, **kw)
    a = jax.jit(lambda *g: jras.render_batch(*g, jc, jcs, jnp.asarray(bg), sh_degree=1,
                                             cfg=jcfg))(*to_jax(*gauss))
    b = tras.render_batch(*to_torch(*gauss), tc, tcs, torch.from_numpy(bg), sh_degree=1,
                          cfg=tras.RasterizeConfig(**kw))
    assert int(np_of(b.num_pairs)) <= MAX_PAIRS
    assert float(np_of(b.final_T).min()) < 1e-3      # termination actually hit
    np.testing.assert_allclose(np_of(b.image), np_of(a.image), atol=5e-5, rtol=1e-3)
    np.testing.assert_allclose(np_of(b.final_T), np_of(a.final_T), atol=1e-6, rtol=1e-3)
    np.testing.assert_array_equal(np_of(b.n_contrib), np_of(a.n_contrib))


def _indefinite_scene():
    """Two 16×16 tiles; three splats in the first, in depth order: [normal,
    HOSTILE, normal]. The hostile conic is indefinite, its power strictly
    positive at every pixel (ineligible everywhere, far-field power >
    +800). The second tile is empty."""
    means2d = np.array([[8.3, 8.2], [4.5, 12.5], [10.4, 6.3]], np.float32)
    conic = np.array([[0.08, 0.01, 0.06], [-5.0, -0.1, -5.0], [0.05, 0.0, 0.05]], np.float32)
    opacity = np.array([0.8, 0.9, 0.7], np.float32)
    color = np.array([[0.9, 0.2, 0.1], [0.2, 0.9, 0.3], [0.1, 0.3, 0.8]], np.float32)
    depth = np.array([2.0, 3.0, 4.0], np.float32)
    rect = np.tile(np.array([0, 0, 1, 1], np.int32), (3, 1))
    area = np.ones(3, np.int32)
    bg = np.array([0.25, 0.5, 0.75], np.float32)
    return [means2d, conic, opacity, color, depth, rect, area, bg]


def test_indefinite_conic_pair_is_inert_and_empty_tile_fill():
    cfg = ttb.BlendConfig(width=32, height=16, tile_w=16, tile_h=16, max_pairs=128,
                          need_n_contrib=True)
    scene = _indefinite_scene()
    img, dep, final_t, n_con, total, _ = ttb.blend_fused(cfg, *to_torch(*scene))
    img = np_of(img)
    assert np.isfinite(img).all() and int(total) == 3
    # the hostile pair is never composited: the last contributor is the
    # third pair, and dropping the hostile pair changes nothing
    assert set(np.unique(np_of(n_con)[:, :16])) <= {0, 1, 3}
    keep = [0, 2]
    without = ttb.blend_fused(cfg, *(torch.from_numpy(x[keep]) for x in scene[:-1]),
                              torch.from_numpy(scene[-1]))
    np.testing.assert_array_equal(np_of(without[0]), img)
    # the empty tile (pallas_blend_mixed.py:578-580): C = D = 0, T = 1, n = 0
    np.testing.assert_array_equal(img[:, 16:], np.broadcast_to(scene[-1], (16, 16, 3)))
    assert (np_of(dep)[:, 16:] == cfg.z_far).all() and (np_of(final_t)[:, 16:] == 1).all()
    assert (np_of(n_con)[:, 16:] == 0).all()


def _saturating_scene():
    """700 copies of one fat opaque splat over the whole 64×32 frame: every
    tile holds ~700 pairs and every pixel freezes within the first few."""
    n = 700
    rng = np.random.default_rng(9)
    means = (0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    scales = np.full((n, 3), 2.5, np.float32)
    rots = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    opac = np.full((n,), 0.9, np.float32)
    shs = (0.3 * rng.standard_normal((n, 4, 3))).astype(np.float32)
    return (means, scales, rots, opac, shs), make_camera(64, 32), np.array([0.3, 0.1, 0.5],
                                                                         np.float32)


def test_saturating_scene_matches_sequential_reference():
    """Against the JAX package's sequential (XLA) compositor, as its
    chunk-skip test holds the Pallas kernel."""
    gauss, cam, bg = _saturating_scene()
    a, b = _render_both(gauss, cam, bg,
                        jras.RasterizeConfig(backend="xla", max_pairs=1 << 13, k_max=1024),
                        tras.RasterizeConfig(max_pairs=1 << 13, window=2))
    assert float(np_of(a.final_T).max()) < 1e-2
    assert int(np_of(b.max_per_tile)) > 2 * 128
    np.testing.assert_allclose(np_of(b.image), np_of(a.image), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(np_of(b.final_T), np_of(a.final_T), atol=1e-7, rtol=1e-3)
    np.testing.assert_array_equal(np_of(b.n_contrib), np_of(a.n_contrib))


@pytest.mark.parametrize("scene", ["random", "saturating"])
def test_fast_mode_within_eps_bound(scene):
    """``fast`` drops only the T < 1e-4 freeze: outputs stay within
    _T_EPS/(1 - alpha)-order of the exact path (bounds of
    ``tests/test_pallas_blend.py::TestFastBlend``)."""
    if scene == "random":
        gauss, cam, bg = (make_gaussians(21, n=150, sh_deg=1, opacity_max=0.95),
                          make_camera(W, H), np.array([0.2, 0.4, 0.6], np.float32))
        tol = dict(image=2e-4, depth=2e-2, final_T=2e-4)
    else:
        # alpha reaches 0.98: the frozen T sits up to _T_EPS / (1 - 0.98)
        # = 5e-3 above the continued product, and what fast mode composites
        # past the freeze is at most that T times a colour below 1
        gauss, cam, bg = _wall(), make_camera(W, H), np.array([0.2, 0.4, 0.6], np.float32)
        tol = dict(image=5e-3, depth=None, final_T=5e-3)
    tc, tcs = cam.torch()
    outs = [tras.render(*to_torch(*gauss), tc, tcs, torch.from_numpy(bg), sh_degree=1,
                        cfg=tras.RasterizeConfig(max_pairs=1 << 12, need_n_contrib=False,
                                                 fast=fast))
            for fast in (True, False)]
    if scene == "saturating":
        assert float(np_of(outs[1].final_T).min()) < 1e-3
    for name, atol in tol.items():
        if atol is not None:
            np.testing.assert_allclose(np_of(getattr(outs[0], name)),
                                       np_of(getattr(outs[1], name)), atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# configuration, dispatch and the gradient contract
# ---------------------------------------------------------------------------


def test_config_validation_matches_jax():
    with pytest.raises(ValueError, match="fast"):
        ttb.BlendConfig(width=16, height=16, fast=True)
    with pytest.raises(ValueError, match="chunk"):
        ttb.BlendConfig(width=16, height=16, chunk=100, max_pairs=1000)
    with pytest.raises(ValueError, match="backend"):
        tras.RasterizeConfig(backend="cuda")
    with pytest.raises(ValueError, match="layout"):
        tras.RasterizeConfig(layout="windowed")
    cfg = ttb.BlendConfig(width=50, height=30, tile_w=16, tile_h=8, n_images=3)
    ref = jtb.BlendConfig(width=50, height=30, tile_w=16, tile_h=8, n_images=3)
    for name in ("tiles_x", "tiles_y", "num_tiles", "total_tiles", "tile_px"):
        assert getattr(cfg, name) == getattr(ref, name)


@pytest.mark.parametrize("kw", [dict(backend="xla"), dict(backend="oracle"),
                                dict(layout="lockstep")])
def test_unported_paths_raise(kw):
    """Batched rendering stacks the views on the mixed kernel's tile axis:
    as in JAX it refuses the xla and oracle backends and the lockstep
    layout (which render one view at a time), naming what it got."""
    cam = make_camera(W, H)
    tc, tcs = cam.torch()
    gauss = to_torch(*make_gaussians(1, n=10))
    with pytest.raises(NotImplementedError, match=next(iter(kw.values()))):
        tras.render_batch(*gauss, tc, tcs, torch.zeros(3), cfg=tras.RasterizeConfig(**kw))


def test_blend_refuses_gradients():
    """blend_fused no longer refuses inputs that require grad: on the
    indefinite-conic scene the gradients are finite and the hostile pair's
    own conic and opacity gradients are exactly zero."""
    scene = to_torch(*_indefinite_scene())
    diff = [scene[i].requires_grad_(True) for i in (0, 1, 2, 3, 4, 7)]
    cfg = ttb.BlendConfig(width=32, height=16, max_pairs=128)
    img, dep, *_ = ttb.blend_fused(cfg, *scene)
    (img.sum() + 0.1 * dep.sum()).backward()
    for t in diff:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
    assert bool((scene[1].grad[1] == 0).all()) and float(scene[2].grad[1]) == 0.0


def test_tiling_roundtrip_matches_jax():
    cfg = ttb.BlendConfig(width=20, height=12, tile_w=8, tile_h=4)
    jcfg = jtb.BlendConfig(width=20, height=12, tile_w=8, tile_h=4)
    img = np.random.default_rng(2).standard_normal((12, 20, 3)).astype(np.float32)
    tiles = ttb.image_to_tiles(cfg, torch.from_numpy(img))
    np.testing.assert_array_equal(np_of(tiles), np.asarray(jtb.image_to_tiles(jcfg, jnp.asarray(img))))
    np.testing.assert_array_equal(np_of(ttb.tiles_to_image(cfg, tiles)), img)


def test_wrappers_never_fall_back():
    """A tensor on neither the CPU nor a CUDA device is refused; it is
    not quietly routed to the plain version."""
    meta = torch.device("meta")
    c = cuda_blend.Compact(torch.empty((4, 16), device=meta),
                           *(torch.empty(8, dtype=torch.int64, device=meta) for _ in range(7)))
    with pytest.raises(ValueError):
        cuda_blend.broadcast_keys(ttb.BlendConfig(width=8, height=8), c)
    staged = cuda_blend.Staged(*(torch.empty(1, device=meta) for _ in STAGED))
    with pytest.raises(ValueError):
        cuda_blend_mixed.forward_mixed(ttb.BlendConfig(width=8, height=8), staged)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
