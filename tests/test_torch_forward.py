"""K1's schedule (``cuda_blend_mixed.forward_schedule``) and K3's plain
version on the CPU, at golden scale (40×32 to 64×48 pixels, 100–150
Gaussians).

- the schedule (K1's pixel layout, the per-warp exit) gives outputs bit for
  bit equal to ``forward_ref`` at tile 8, 16, 32, a non-square tile and an
  odd tile that takes the row strips, ``fast`` on and off,
  ``need_n_contrib`` on and off, on splats that straddle the warp patches'
  edges and tiles that saturate within a few pairs;
- its visit counts: the per-warp exit walks no more (warp, pair) visits
  than the block-wide exit of the row strips, and no fewer than the
  evaluations over the pixels a warp holds, nor than the visits in which
  some pixel composites;
- K1's layout covers every pixel once in at most eight warps;
- the warp cull of uncut lists is conservative: on adversarial splats
  (alpha = 1/255 contours within a pixel of a warp patch's edge, opacities
  near 1/255, near-singular and indefinite conics, a non-finite colour)
  every (pair, pixel) that passes the alpha gate lies in the pair's cull
  box, the schedule's culled visits composite nothing, and its outputs stay
  the plain version's;
- the schedule against JAX's ``forward_mixed`` (Pallas, interpret mode) at
  tile 32 and 16×8, at ``tests/test_rasterizer.py``'s tolerance;
- K3's plain version writes 0 for a rank outside [0, n_rows), as the
  kernel does and as JAX's ``broadcast_fields`` gives.

``tests/test_torch_cuda.py`` holds the kernels to these plain versions on
the card.
"""

import jax
import numpy as np
import pytest
import torch

from deblurgs_tpu.ops import pallas_blend as jpb
from deblurgs_tpu.ops import pallas_blend_mixed as jpbm
from deblurgs_tpu.ops import tile_blend as jtb
from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed as cbm
from deblurgs_tpu_torch.ops import tile_blend as ttb
from tests.torch_bridge import np_of, to_jax

torch.set_num_threads(1)

W, H, MAX_PAIRS = 64, 48, 1 << 13


def _scene(tile_w, tile_h, width=W, height=H, n=140, seed=5, n_wall=30):
    """Staged inputs (one view) of ``n`` splats: most centred on or near the
    edges of K1's warp patches at this tile (x near multiples of the patch
    width, y near multiples of the patch's rows), with sizes from sub-pixel
    to several patches, elongated and rotated conics, opacities from below
    1/255 to 0.99; the first ``n_wall`` are wide and 0.99 opaque over the
    left half of the frame, so its tiles saturate within a few pairs."""
    rng = np.random.default_rng(seed)
    ppt, pw, _, _ = cbm.forward_layout(tile_w, tile_h)
    gx = pw or tile_w
    gy = (32 // pw * ppt) if pw else tile_h
    mx = gx * rng.integers(0, width // gx + 1, n) + rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], n)
    my = gy * rng.integers(0, height // gy + 1, n) + rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], n)
    mx += rng.uniform(-0.05, 0.05, n)
    sig = np.exp(rng.uniform(np.log(0.3), np.log(12.0), (n, 2)))
    mx[:n_wall] = rng.uniform(0, width / 2, n_wall)
    my[:n_wall] = rng.uniform(0, height, n_wall)
    sig[:n_wall] = rng.uniform(14.0, 24.0, (n_wall, 2))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cov = np.empty((n, 2, 2))
    cov[:, 0, 0] = c * c * sig[:, 0] ** 2 + s * s * sig[:, 1] ** 2 + 0.3
    cov[:, 1, 1] = s * s * sig[:, 0] ** 2 + c * c * sig[:, 1] ** 2 + 0.3
    cov[:, 0, 1] = cov[:, 1, 0] = c * s * (sig[:, 0] ** 2 - sig[:, 1] ** 2)
    inv = np.linalg.inv(cov)
    conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
    opac = np.exp(rng.uniform(np.log(1e-3), np.log(0.99), n))
    opac[:n_wall] = 0.99
    rad = 3.0 * np.sqrt(np.maximum(cov[:, 0, 0], cov[:, 1, 1]))
    tx, ty = -(-width // tile_w), -(-height // tile_h)
    rect = np.stack([np.clip((mx - rad) // tile_w, 0, tx), np.clip((my - rad) // tile_h, 0, ty),
                     np.clip((mx + rad) // tile_w + 1, 0, tx),
                     np.clip((my + rad) // tile_h + 1, 0, ty)], -1).astype(np.int32)
    area = ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])).astype(np.int32)
    f32 = lambda x: np.asarray(x, np.float32)   # noqa: E731
    return [f32(np.stack([mx, my], -1)), f32(conic), f32(opac), f32(rng.uniform(0, 1, (n, 3))),
            f32(rng.uniform(1, 5, n)), rect, area]


def _staged(tile_w, tile_h, need_n_contrib=False, fast=False, **kw):
    cfg = ttb.BlendConfig(width=kw.get("width", W), height=kw.get("height", H), tile_w=tile_w,
                          tile_h=tile_h, max_pairs=MAX_PAIRS, need_n_contrib=need_n_contrib,
                          fast=fast)
    flat = [torch.from_numpy(x) for x in _scene(tile_w, tile_h, **kw)]
    staged = cuda_blend.sort_stage(cfg, *flat, cfg.max_pairs)
    assert 0 < int(staged.total) <= MAX_PAIRS
    return cfg, staged


TILES = [(8, 8), (16, 16), (32, 32), (16, 8), (40, 20)]
FLAGS = [(True, False), (False, False), (False, True)]


@pytest.mark.parametrize("need_n_contrib,fast", FLAGS, ids=["n_contrib", "plain", "fast"])
@pytest.mark.parametrize("tile_w,tile_h", TILES, ids=[f"{w}x{h}" for w, h in TILES])
def test_schedule_matches_plain(tile_w, tile_h, need_n_contrib, fast):
    """K1's schedule gives forward_ref's outputs bit for bit, and walks
    between evaluations / (32·ppt) and the row strips' block-exit visits."""
    cfg, st = _staged(tile_w, tile_h, need_n_contrib, fast)
    args = (cfg, st.fields, st.tile_start, st.tile_stop)
    want = cbm.forward_ref(*args)
    *got, visits = cbm.forward_schedule(*args)
    for name, g, w in zip(("C", "D", "final_T", "n_con"), got, want):
        assert torch.equal(g, w), name
    if need_n_contrib:
        assert int(got[3].max()) > 1
    else:
        assert not bool(got[3].any())
    ppt = cbm.forward_layout(tile_w, tile_h)[0]
    v = {k: int(x) for k, x in visits.items()}
    # every pixel evaluates every pair of its tile unless it freezes, and
    # only the exact path freezes
    every = int((st.tile_stop - st.tile_start).sum()) * cfg.tile_px
    assert v["evaluations"] == every if fast else v["evaluations"] < every
    assert -(-v["evaluations"] // (32 * ppt)) <= v["warp_exit"] <= v["block_exit"]
    assert v["warp_exit"] * 128 >= v["evaluations"]
    assert 0 < v["composite"] <= v["warp_exit"]


@pytest.mark.parametrize("tile_w,tile_h", [(32, 32), (16, 16), (16, 8)])
def test_warp_exit_saves_visits_on_saturated_tiles(tile_w, tile_h):
    """The wall saturates most pixels of its tiles: the per-warp exit walks
    fewer visits than the block exit over the scene, and on the wall's
    tiles alone (walked as a subset, with the same outputs) at most 0.6 of
    their pairs times eight warps."""
    cfg, st = _staged(tile_w, tile_h)
    args = (cfg, st.fields, st.tile_start, st.tile_stop)
    C, D, T, n_con, visits = cbm.forward_schedule(*args)
    assert int(visits["warp_exit"]) < int(visits["block_exit"])
    counts = st.tile_stop - st.tile_start
    wall = torch.nonzero((T < 1e-3).float().mean(-1) >= 0.8)[:, 0]
    assert wall.numel() >= 2
    sub = cbm.forward_schedule(*args, tiles=wall)
    assert 10 * int(sub[4]["warp_exit"]) <= 6 * 8 * int(counts[wall].sum())
    for a, b in zip(sub[:4], (C, D, T, n_con)):
        assert torch.equal(a, b[wall])


@pytest.mark.parametrize("tile_w,tile_h,want", [
    (32, 32, (4, 16, 2, 8)), (16, 16, (1, 16, 1, 8)), (8, 8, (1, 8, 1, 2)),
    (16, 8, (1, 16, 1, 4)), (24, 24, (4, 16, 2, 6)), (16, 24, (2, 16, 1, 6)),
    (40, 20, (4, 0, 0, 0)), (512, 2, (4, 0, 0, 0)), (3, 300, (4, 0, 0, 0)), (1, 1, (1, 1, 1, 1))])
def test_forward_layout_covers_each_pixel_once(tile_w, tile_h, want):
    """Pixels a thread by tile size, warp patches where eight warps cover
    the tile, row strips where none do; every pixel held exactly once."""
    assert cbm.forward_layout(tile_w, tile_h) == want
    pix = cbm.forward_pixels(tile_w, tile_h)
    assert pix.shape[0] <= 8 and pix.shape[1] == 32 and pix.shape[2] == want[0]
    px = tile_w * tile_h
    assert sorted(pix[pix < px].tolist()) == list(range(px))
    if want[1]:     # a thread's pixels share one column
        assert bool(((pix % tile_w == pix[..., :1] % tile_w) | (pix == px)).all())


def test_forward_layout_refuses_large_tiles():
    with pytest.raises(ValueError):
        cbm.forward_layout(64, 32)


@pytest.mark.parametrize("tile_w,tile_h", [(32, 32), (16, 8)])
def test_schedule_matches_jax_kernel(tile_w, tile_h):
    """The schedule's outputs against JAX's forward_mixed on the same
    staged fields (C, D, final_T at atol 1e-5 / rtol 1e-4, n_con exact)."""
    kw = dict(width=W, height=H, tile_w=tile_w, tile_h=tile_h, max_pairs=MAX_PAIRS,
              need_n_contrib=True, n_images=1, layout="mixed", backend="pallas", window=2)
    jcfg = jtb.BlendConfig(interpret=True, **kw)
    a = jax.jit(lambda *x: jpb._sort_stage(jcfg, *x, jcfg.max_pairs))(
        *to_jax(*_scene(tile_w, tile_h)))
    ref = jax.jit(lambda *x: jpbm.forward_mixed(
        jcfg, jpbm.prepare_mixed(jcfg, *x, jcfg.max_pairs)))(*a[:-1])
    st = cuda_blend.Staged(*(torch.from_numpy(np.array(x)) for x in a))
    got = cbm.forward_schedule(ttb.BlendConfig(**kw), st.fields, st.tile_start, st.tile_stop)
    for name, x, y in zip(("C", "D", "final_T"), ref[:3], got[:3]):
        np.testing.assert_allclose(np_of(y), np_of(x), atol=1e-5, rtol=1e-4, err_msg=name)
    np.testing.assert_array_equal(np_of(got[3]), np_of(ref[3]))
    assert float(np_of(got[2]).min()) < 1e-3


@pytest.mark.parametrize("n_rows", [0, 7])
def test_broadcast_plain_writes_nan_out_of_range(n_rows):
    """K3's plain version: ctable[gauss_c].T where the rank is in range,
    0 where it is negative or at least n_rows (never an IndexError); the
    name predates the change from NaN to JAX's 0."""
    rng = np.random.default_rng(4)
    ctable = torch.from_numpy(rng.standard_normal((n_rows, 16)).astype(np.float32))
    gauss_c = torch.tensor([0, 0, 1, 3, 3, 6, 7, -1, 9, 2 ** 31 - 1, 6], dtype=torch.int32)
    got = cuda_blend.broadcast_fields_ref(ctable, gauss_c)
    assert got.shape == (16, gauss_c.shape[0])
    ok = (gauss_c >= 0) & (gauss_c < n_rows)
    assert bool((got[:, ~ok] == 0).all())
    if n_rows:
        assert torch.equal(got[:, ok], ctable[gauss_c[ok].long()].T)


def _cull_scene(kind, tile, n=120, seed=17):
    """Staged inputs (one view, 64×48) of splats that test the warp cull at
    this tile's K1 layout: ``edge`` puts each alpha = 1/255 contour's
    extreme column or row within a pixel of a warp patch's edge (rotated and
    axis-aligned conics); ``faint`` has opacities within a few percent of
    1/255, means on pixel centres; ``needle`` near-singular conics
    (covariance eigenvalues 0.3 and up to 3e4), some exactly singular or
    indefinite; ``nonfinite`` one NaN and one infinite colour among
    ordinary splats. Rects cover the contour plus two pixels."""
    rng = np.random.default_rng(seed)
    ppt, pw, _, _ = cbm.forward_layout(tile, tile)
    ph = 32 // pw * ppt
    th = rng.uniform(0, np.pi, n) * (rng.random(n) < 0.6)
    sig = np.exp(rng.uniform(np.log(0.6), np.log(6.0), (n, 2)))
    opac = rng.uniform(0.05, 0.99, n)
    if kind == "faint":
        opac = np.float32(1 / 255) * rng.uniform(0.98, 1.06, n)
    elif kind == "nonfinite":
        opac = rng.uniform(0.05, 0.5, n)
    elif kind == "needle":
        sig[:, 0] = np.exp(rng.uniform(np.log(3.0), np.log(170.0), n))
        sig[:, 1] = np.sqrt(0.3 - 0.29 * (rng.random(n) < 0.5))
    c, s_ = np.cos(th), np.sin(th)
    cov = np.empty((n, 2, 2))
    cov[:, 0, 0] = c * c * sig[:, 0] ** 2 + s_ * s_ * sig[:, 1] ** 2
    cov[:, 1, 1] = s_ * s_ * sig[:, 0] ** 2 + c * c * sig[:, 1] ** 2
    cov[:, 0, 1] = cov[:, 1, 0] = c * s_ * (sig[:, 0] ** 2 - sig[:, 1] ** 2)
    inv = np.linalg.inv(cov)
    conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
    if kind == "needle":     # exactly singular and indefinite conics
        conic[:8, 1] = np.sqrt(conic[:8, 0] * conic[:8, 2])
        conic[8:16, 1] = 1.5 * np.sqrt(conic[8:16, 0] * conic[8:16, 2])
    # the 1/255 contour's half-extents
    lg = 2 * np.log(np.maximum(255 * opac, 1.0))
    hx, hy = np.sqrt(lg * cov[:, 0, 0]), np.sqrt(lg * cov[:, 1, 1])
    mx = rng.uniform(0, W, n)
    my = rng.uniform(0, H, n)
    if kind == "edge":
        # the contour's right or left extreme (or bottom or top) at a patch
        # edge, plus or minus up to a pixel
        side = rng.integers(0, 4, n)
        ex = pw * rng.integers(1, W // pw, n) + rng.uniform(-1, 1, n) - 0.5
        ey = ph * rng.integers(1, H // ph, n) + rng.uniform(-1, 1, n) - 0.5
        mx = np.where(side == 0, ex - hx, np.where(side == 1, ex - 1 + hx, mx))
        my = np.where(side == 2, ey - hy, np.where(side == 3, ey - 1 + hy, my))
    elif kind == "faint":
        mx, my = np.round(mx), np.round(my)
    color = rng.uniform(0, 1, (n, 3))
    if kind == "nonfinite":
        color[3, 1], color[7, 0] = np.nan, np.inf
    rad_x, rad_y = np.minimum(hx, 200) + 2, np.minimum(hy, 200) + 2
    tx, ty = -(-W // tile), -(-H // tile)
    rect = np.stack([np.clip((mx - rad_x) // tile, 0, tx), np.clip((my - rad_y) // tile, 0, ty),
                     np.clip((mx + rad_x) // tile + 1, 0, tx),
                     np.clip((my + rad_y) // tile + 1, 0, ty)], -1).astype(np.int32)
    area = ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])).astype(np.int32)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))   # noqa: E731
    flat = [f32(np.stack([mx, my], -1)), f32(conic), f32(opac), f32(color),
            f32(rng.uniform(1, 5, n)), torch.from_numpy(rect), torch.from_numpy(area)]
    cfg = ttb.BlendConfig(width=W, height=H, tile_w=tile, tile_h=tile, max_pairs=MAX_PAIRS,
                          need_n_contrib=True)
    staged = cuda_blend.sort_stage(cfg, *flat, cfg.max_pairs)
    assert 0 < int(staged.total) <= MAX_PAIRS
    return cfg, staged


CULL_KINDS = ["edge", "faint", "needle", "nonfinite"]


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("kind", CULL_KINDS)
def test_cull_box_holds_every_gated_pixel(kind, tile):
    """Every (pair, pixel of its tile) that passes K1's gates (power <= 0,
    alpha >= 1/255 in the plain version's float32 sequence) lies in the
    pair's cull box; a pair with a non-finite field or a conic that is not
    positive definite gets the whole plane."""
    cfg, st = _cull_scene(kind, tile)
    kept = int(st.tile_stop[-1])
    f = st.fields[:, :kept]
    box = cbm.cull_box(f)
    x, y = cbm._pixel_coords(cfg, f[10].long())
    dx, dy = f[0][:, None] - x, f[1][:, None] - y
    power = -0.5 * (f[2][:, None] * dx * dx + f[4][:, None] * dy * dy) - f[3][:, None] * dx * dy
    alpha = torch.clamp(f[5][:, None] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    gated = (power <= 0.0) & (alpha >= 1 / 255)
    inside = ((box[0][:, None] <= x) & (x <= box[1][:, None])
              & (box[2][:, None] <= y) & (y <= box[3][:, None]))
    assert int(gated.sum()) > 0
    assert not bool((gated & ~inside).any()), int((gated & ~inside).sum())
    whole = torch.isinf(box).all(0) & (box[0] < 0) & (box[1] > 0)
    det = f[2] * f[4] - f[3] * f[3]
    assert bool(whole[~torch.isfinite(f[:10]).all(0) | (det <= 0)].all())
    if kind in ("needle", "nonfinite"):
        assert bool(whole.any())


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("kind", CULL_KINDS)
def test_cull_is_conservative_on_adversarial_scenes(kind, tile):
    """On uncut lists the schedule's warp cull skips visits, none of which
    composites anything (``culled_composite`` 0), and its outputs stay the
    plain version's (NaN where a non-finite colour reaches, as there)."""
    cfg, st = _cull_scene(kind, tile)
    args = (cfg, st.fields, st.tile_start, st.tile_stop)
    want = cbm.forward_ref(*args)
    *got, visits = cbm.forward_schedule(*args)
    for name, g, w in zip(("C", "D", "final_T", "n_con"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True, msg=name)
    v = {k: int(x) for k, x in visits.items()}
    assert v["culled_composite"] == 0 and 0 < v["culled"] < v["warp_exit"]
    assert v["composite"] + v["culled"] <= v["warp_exit"]
    assert bool(torch.isnan(got[0]).any()) == (kind == "nonfinite")
