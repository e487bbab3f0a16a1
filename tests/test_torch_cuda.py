"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file itself imports no JAX; ``tests/conftest.py`` does, so on a host
without JAX run it without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deblurgs_tpu_torch.core.camera import CameraStatic, get_projection_matrix  # noqa: E402
from deblurgs_tpu_torch.core.transforms import build_covariance  # noqa: E402
from deblurgs_tpu_torch.device import resolve_device  # noqa: E402
from deblurgs_tpu_torch.models import motion as motion_lib  # noqa: E402
from deblurgs_tpu_torch.models.gaussians import GaussianConfig  # noqa: E402
from deblurgs_tpu_torch.ops import binning, cuda_blend, cuda_blend_lockstep  # noqa: E402
from deblurgs_tpu_torch.ops import cuda_blend_mixed  # noqa: E402
from deblurgs_tpu_torch.ops import preprocess as pre_lib  # noqa: E402
from deblurgs_tpu_torch.ops import tile_blend  # noqa: E402
from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig  # noqa: E402
from deblurgs_tpu_torch.train import checkpoint  # noqa: E402
from deblurgs_tpu_torch.train import step as step_lib  # noqa: E402
from deblurgs_tpu_torch.train.config import OptimizationConfig  # noqa: E402
from deblurgs_tpu_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.cuda
W, H, F = 256, 192, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    with torch.no_grad():            # gradients are taken explicitly below
        yield resolve_device("cuda")


def assert_scaled_close(got, want, atol=2e-5):
    """|got - want| / max|want| <= atol, per tensor."""
    scale = float(want.abs().max()) or 1.0
    torch.testing.assert_close(got / scale, want / scale, atol=atol, rtol=0)


def launches(kernel: str) -> int:
    return profiling.counters().get(f"kernel.{kernel}", 0)


def _staged_inputs(card, n=3000, need_n_contrib=False, fast=False, tile_w=16, tile_h=16):
    """A seeded scene seen by F sub-frame cameras, preprocessed on the card
    at tile_w × tile_h tiles and flattened as render_batch flattens it."""
    rng = np.random.default_rng(0)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=card)  # noqa: E731
    q = rng.standard_normal((n, 4))
    means = t(rng.standard_normal((n, 3)) * 1.5)
    cov6 = build_covariance(t(np.exp(rng.uniform(math.log(0.01), math.log(0.1), (n, 3)))),
                            t(q / np.linalg.norm(q, axis=-1, keepdims=True)))
    opac = t(rng.uniform(0.1, 0.95, n))
    shs = t(rng.standard_normal((n, 4, 3)) * 0.3)
    fovy = 2 * math.atan(math.tan(0.6) * H / W)
    cs = CameraStatic(width=W, height=H, tanfovx=math.tan(0.6), tanfovy=math.tan(fovy / 2))
    proj = get_projection_matrix(0.01, 100.0, 1.2, fovy, device=card)
    motion = motion_lib.init_motion(
        torch.eye(3, device=card)[None], torch.tensor([[0.0, 0.0, -5.0]], device=card),
        motion_lib.MotionConfig(curve_order=3, n_subframes=F),
        torch.Generator(device=card).manual_seed(0), init_noise=0.02)
    cams = motion_lib.subframe_cameras(motion, 0, motion_lib.sample_nu(motion, 0), proj)
    pre = pre_lib.preprocess(means, cov6, shs, None, opac, cams, cs, sh_degree=1,
                             tile_w=tile_w, tile_h=tile_h, tight_rect=True)
    flat = [x.reshape((F * n,) + x.shape[2:]) for x in (
        pre.means2d, pre.conic, pre.opacity, pre.color, pre.depth, pre.rect, pre.tiles_touched)]
    cfg = tile_blend.BlendConfig(width=W, height=H, tile_w=tile_w, tile_h=tile_h,
                                 max_pairs=1 << 17, n_images=F,
                                 need_n_contrib=need_n_contrib, fast=fast, layout="mixed")
    return cfg, flat


def test_broadcast_kernel_matches_plain(card):
    rng = np.random.default_rng(0)
    area = torch.from_numpy(rng.integers(0, 9, 5000).astype(np.int32)).to(card)
    ctable = torch.from_numpy(rng.standard_normal((5000, 16)).astype(np.float32)).to(card)
    gauss_c = binning.expand_compact(area, 1 << 15)[0]
    before = launches("K3")
    got = cuda_blend.broadcast_fields(ctable, gauss_c)
    assert launches("K3") == before + 1
    assert torch.equal(got, cuda_blend.broadcast_fields_ref(ctable, gauss_c))


@pytest.mark.parametrize("max_pairs", [1, 3, 130, 1027, 4096])
def test_broadcast_kernel_odd_sizes_and_ranks_out_of_range(card, max_pairs):
    """K3 at max_pairs not a multiple of 4 or of 128, with ranks below 0
    and at or past n_rows, also from a view 4 B off 16 B alignment: the
    plain version's values, 0 where the rank is out of range."""
    rng = np.random.default_rng(max_pairs)
    n_rows = 500
    ctable = torch.from_numpy(rng.standard_normal((n_rows, 16)).astype(np.float32)).to(card)
    ranks = np.sort(rng.integers(-2, n_rows + 3, max_pairs + 1)).astype(np.int32)
    ranks[-1] = n_rows          # at least one rank past the table
    gauss_c = torch.from_numpy(ranks).to(card)
    for g in (gauss_c[1:], gauss_c[:-1]):
        got = cuda_blend.broadcast_fields(ctable, g)
        want = cuda_blend.broadcast_fields_ref(ctable, g)
        bad = (g < 0) | (g >= n_rows)
        assert torch.equal(got, want)
        assert bool((got[:, bad] == 0).all())


K1_TILES = [(32, 32), (16, 16), (8, 8), (16, 8), (40, 20)]


@pytest.mark.parametrize("need_n_contrib,fast", [(True, False), (False, False), (False, True)],
                         ids=["n_contrib", "plain", "fast"])
@pytest.mark.parametrize("tile_w,tile_h", K1_TILES, ids=[f"{w}x{h}" for w, h in K1_TILES])
def test_composite_kernel_matches_plain(card, tile_w, tile_h, need_n_contrib, fast):
    """K1 bit for bit against its plain version at tile 32, 16 and 8, a
    non-square tile and one no warp patches fit (row strips), n_con on and
    off and ``fast``; the launch is counted."""
    cfg, flat = _staged_inputs(card, need_n_contrib=need_n_contrib, fast=fast, tile_w=tile_w,
                               tile_h=tile_h)
    staged = cuda_blend.sort_stage(cfg, *flat, cfg.max_pairs)
    assert int(staged.total) <= cfg.max_pairs
    before = launches("K1")
    got = cuda_blend_mixed.forward_mixed(cfg, staged)
    assert launches("K1") == before + 1
    want = cuda_blend_mixed.forward_ref(cfg, staged.fields, staged.tile_start, staged.tile_stop)
    torch.cuda.synchronize()
    for x, y in zip(want, got):
        assert torch.equal(y, x)
    if need_n_contrib:
        assert int(got[3].max()) > 1


@pytest.mark.parametrize("tile_w,tile_h", K1_TILES, ids=[f"{w}x{h}" for w, h in K1_TILES])
def test_cull_matches_plain(card, tile_w, tile_h):
    """On uncut lists (need_n_contrib on) K1 with and without its warp cull
    gives the same bits, and K2 with and without it bit for bit its plain
    version, in its layout by tile (row strips at 40×20)."""
    cfg, flat = _staged_inputs(card, need_n_contrib=True, tile_w=tile_w, tile_h=tile_h)
    staged = cuda_blend.sort_stage(cfg, *flat, cfg.max_pairs)
    outs = [cuda_blend_mixed.launch_forward("K1", cfg, staged, cull=c) for c in (True, False)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    C, D, T, _ = outs[0]
    dl_pix, dl_d = _cotangents(cfg)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)
    total = cuda_blend_mixed.backward_total(cfg, bg, T, dl_pix, dl_d, C, D)
    want = cuda_blend_mixed.backward_ref(cfg, staged.fields, staged.tile_start,
                                         staged.tile_stop, dl_pix, dl_d, total)
    for cull in (True, False):
        got = cuda_blend_mixed.launch_backward("K2", cfg, staged, bg, T, dl_pix, dl_d, C, D,
                                               cull=cull)
        torch.cuda.synchronize()
        assert torch.equal(got, want), cull


def test_blend_kernel_path_matches_plain_path(card):
    cfg, flat = _staged_inputs(card)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)
    img, dep, final_t, _, total, _ = tile_blend.blend_fused(cfg, *flat, bg)
    c = cuda_blend.compact_table(cfg, *flat, cfg.max_pairs)
    st = cuda_blend.sort_slots(cfg, cuda_blend.broadcast_fields_ref(c.ctable, c.gauss_c), c)
    plain = tile_blend.compose(cfg, *cuda_blend_mixed.forward_ref(
        cfg, st.fields, st.tile_start, st.tile_stop), bg)
    torch.testing.assert_close(img, plain[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(dep, plain[1], atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(final_t, plain[2], atol=1e-5, rtol=0)
    assert img.shape == (F, H, W, 3) and bool(torch.isfinite(img).all())


def test_wrappers_check_their_inputs(card):
    with pytest.raises(ValueError):
        cuda_blend.broadcast_fields(torch.zeros((4, 16), dtype=torch.float64, device=card),
                                    torch.zeros(8, dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        cuda_blend.broadcast_fields(torch.zeros((4, 8), device=card),
                                    torch.zeros(8, dtype=torch.int32, device=card))
    cfg = tile_blend.BlendConfig(width=64, height=64, tile_w=64, tile_h=32)
    staged = cuda_blend.Staged(*(torch.zeros(1, device=card) for _ in range(9)))
    with pytest.raises(ValueError):
        cuda_blend_mixed.forward_mixed(cfg, staged._replace(
            fields=torch.zeros((16, 128), device=card)))


def _cotangents(cfg, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((cfg.total_tiles, cfg.tile_px, 3), generator=g, device="cuda"),
            0.05 * torch.randn((cfg.total_tiles, cfg.tile_px), generator=g, device="cuda"))


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast"])
def test_backward_kernel_matches_plain(card, fast):
    cfg, flat = _staged_inputs(card, fast=fast)
    staged = cuda_blend.sort_stage(cfg, *flat, cfg.max_pairs)
    C, D, T, _ = cuda_blend_mixed.forward_mixed(cfg, staged)
    dl_pix, dl_d = _cotangents(cfg)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)
    before = launches("K2")
    got = cuda_blend_mixed.backward_mixed(cfg, staged, bg, T, dl_pix, dl_d, C, D)
    assert launches("K2") == before + 1
    total = cuda_blend_mixed.backward_total(cfg, bg, T, dl_pix, dl_d, C, D)
    want = cuda_blend_mixed.backward_ref(cfg, staged.fields, staged.tile_start,
                                         staged.tile_stop, dl_pix, dl_d, total)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and bool((got[10:] == 0).all())
    # bit for bit: the patch order, the early exits and the reduce-scatter
    # are the plain version's
    assert torch.equal(got[:10], want[:10])


def test_reduce_kernel_matches_plain(card):
    rng = np.random.default_rng(3)
    P, n_emit, mp = 6000, 4000, 1 << 16
    counts = rng.integers(1, 30, n_emit)
    ranks = np.repeat(np.arange(n_emit), counts)[:mp]
    total = ranks.shape[0]
    ranks = np.pad(ranks, (0, mp - total), constant_values=P)
    perm = rng.permutation(mp)          # ranks in any slot order, as after the depth sort
    s_gc = torch.from_numpy(ranks[perm].astype(np.int32)).to(card)
    grads = torch.from_numpy(rng.standard_normal((16, mp)).astype(np.float32)).to(card)
    grads[10:] = 0
    grads[:, s_gc == P] = float("nan")  # sentinel slots are never read
    before = launches("K4")
    got = cuda_blend.reduce_sorted(grads, s_gc, P)
    assert launches("K4") == before + 1
    want = cuda_blend.reduce_sorted_ref(grads, s_gc, P)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and bool((got[:, 10:] == 0).all())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    assert torch.equal(got, cuda_blend.reduce_sorted(grads, s_gc, P))


def test_reduce_main_path_matches_plain(card):
    """K4 on the main path (the staging's runs, sums to original rows)
    against the float64 sums by sorted rank scattered to rows, on K2's
    output; two calls bitwise equal."""
    cfg, flat = _staged_inputs(card)
    staged = cuda_blend.sort_stage(cfg, *flat, cfg.max_pairs)
    C, D, T, _ = cuda_blend_mixed.forward_mixed(cfg, staged)
    dl_pix, dl_d = _cotangents(cfg)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)
    pg = cuda_blend_mixed.backward_mixed(cfg, staged, bg, T, dl_pix, dl_d, C, D)
    P = flat[0].shape[0]
    before = launches("K4")
    got = cuda_blend.reduce_pair_grads(staged, pg, P)
    assert launches("K4") == before + 1
    sums = cuda_blend.reduce_sorted_ref(pg, staged.s_gc, P)
    want = torch.zeros((P + 1, 16), device=card)
    want[torch.where(torch.arange(P, device=card) < staged.n_emit, staged.ids, P)] = sums
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and bool((got[:, 10:] == 0).all())
    assert_scaled_close(got, want[:P], atol=1e-6)
    assert torch.equal(got, cuda_blend.reduce_pair_grads(staged, pg, P))
    torch.testing.assert_close(got, cuda_blend.reduce_pair_grads_ref(staged, pg, P),
                               atol=2e-5, rtol=1e-5)


def test_blend_gradients_are_deterministic(card):
    cfg, flat = _staged_inputs(card)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)
    w = torch.rand((F, H, W, 3), generator=torch.Generator(device="cuda").manual_seed(2),
                   device=card)

    def grads():
        with torch.enable_grad():
            diff = [t.clone().requires_grad_(True) for t in flat[:5] + [bg]]
            img, dep, *_ = tile_blend.blend_fused(cfg, *diff[:5], flat[5], flat[6], diff[5])
            return torch.autograd.grad((img * w).sum() + 0.1 * dep.sum(), diff)

    a, b = grads(), grads()
    for x, y in zip(a, b):
        assert torch.equal(x, y) and bool(torch.isfinite(x).all())


def _trained_step_inputs(device, size=64):
    state = checkpoint.load_checkpoint(
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "runs", "r5_jointb_state.npz"), device=device)
    cs = CameraStatic(width=size, height=size, tanfovx=math.tan(0.55), tanfovy=math.tan(0.55))
    proj = get_projection_matrix(0.01, 100.0, 1.1, 1.1, device=device)
    st = step_lib.TrainStatics(
        gcfg=GaussianConfig(sh_degree=2),
        mcfg=motion_lib.MotionConfig(curve_order=9, n_subframes=21), ocfg=OptimizationConfig(),
        rcfg=RasterizeConfig(tile_w=16, tile_h=16, need_n_contrib=False, max_pairs=1 << 20),
        cs=cs, sh_degree=2, n_sub=21, batched_render=True, tone_mapping="identity")
    gt = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (size, size, 3))
                          .astype(np.float32)).to(device)
    bg = torch.tensor([0.3, 0.5, 0.7], device=device)
    return state._replace(step=7001), gt, proj, st, step_lib.StepDraws(bg=bg)


def _mismatches(got, want, scale, tol) -> int:
    return int((~torch.isclose(got.cpu(), want, atol=tol * scale, rtol=0)).sum())


def test_train_step_on_card_matches_cpu(card):
    """One step of the r5 trained state (64×64, F = 21, deep tile lists):
    the card and the CPU give the same loss and pair count, the same
    gradients (recovered from the first moments, which Adam updates
    linearly) and the same parameter updates, but for a few Gaussians.
    The two platforms round preprocess's matrix products differently, so a
    (pixel, pair) gate near alpha = 1/255 or T = 1e-4 can flip and move one
    Gaussian's gradient; Adam's normalised update then turns a small
    gradient change into a visible step. Each leaf is compared after
    scaling by its largest CPU value; at most 0.1% of a leaf (and at least
    4 entries) may differ."""
    with torch.enable_grad():
        out = {}
        for dev in ("cpu", "cuda"):
            state, gt, proj, st, draws = _trained_step_inputs(dev)
            out[dev] = (state,) + step_lib.train_step(state, gt, 0, proj, st, draws=draws)
    (s0, sc, mc), (_, sg, mg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(mg.loss.cpu(), mc.loss, rtol=1e-5, atol=0)
    assert int(mg.num_pairs) == int(mc.num_pairs) and not bool(mg.overflowed)
    report = {}
    for group in ("adam_g", "adam_m"):
        old, new_c, new_g = (getattr(x, group).mu for x in (s0, sc, sg))
        for name, o, c, g in zip(old._fields, old, new_c, new_g):
            grad_c, grad_g = (c - 0.9 * o) / 0.1, (g.cpu() - 0.9 * o) / 0.1
            report[f"grad {name}"] = _mismatches(grad_g, grad_c, float(grad_c.abs().max()), 1e-3)
    for group in ("params", "motion"):
        old, new_c, new_g = (getattr(x, group) for x in (s0, sc, sg))
        for name, o, c, g in zip(old._fields, old, new_c, new_g):
            d_c, d_g = c - o, g.cpu() - o
            report[f"step {name}"] = _mismatches(d_g, d_c, float(d_c.abs().max()), 1e-2)
    numel = {**{f"grad {k}": v.numel() for k, v in s0.adam_g.mu._asdict().items()},
             **{f"grad {k}": v.numel() for k, v in s0.adam_m.mu._asdict().items()},
             **{f"step {k}": v.numel() for k, v in s0.params._asdict().items()},
             **{f"step {k}": v.numel() for k, v in s0.motion._asdict().items()}}
    bad = {k: (v, numel[k]) for k, v in report.items() if v > max(4, numel[k] // 1000)}
    assert not bad, f"entries off per leaf (count, size): {bad}; all: {report}"


def _one_view(card, tile, need_n_contrib):
    """The first sub-frame of ``_staged_inputs``' scene as one view staged
    for the lockstep kernels, and the same list's mixed configuration."""
    cfg, flat = _staged_inputs(card)
    n = flat[0].shape[0] // F
    flat = [x[:n] for x in flat]
    kw = dict(width=W, height=H, tile_w=tile, tile_h=tile, max_pairs=1 << 16,
              need_n_contrib=need_n_contrib)
    lock = tile_blend.BlendConfig(layout="lockstep", **kw)
    staged = cuda_blend.sort_stage(lock, *flat, lock.max_pairs)
    assert int(staged.total) <= lock.max_pairs
    return lock, tile_blend.BlendConfig(layout="mixed", **kw), staged, flat


@pytest.mark.parametrize("tile,need_n_contrib", [(16, True), (16, False), (32, True)])
def test_lockstep_kernels_match_plain(card, tile, need_n_contrib):
    """K5 equals its plain version and K1 on the same list bit for bit,
    ``n_con`` included; K6 equals its plain version and K2 on the same list
    slot for slot, bit for bit, and two K6 calls agree."""
    cfg, mixed, staged, _ = _one_view(card, tile, need_n_contrib)
    before = (launches("K5"), launches("K6"))
    got = cuda_blend_lockstep.forward_lockstep(cfg, staged)
    args = (cfg, staged.fields, staged.tile_start, staged.tile_stop)
    want = cuda_blend_lockstep.forward_lockstep_ref(*args)
    k1 = cuda_blend_mixed.forward_mixed(mixed, staged)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, k1):
        assert torch.equal(a, b) and torch.equal(a, c)
    if need_n_contrib:
        assert int(got[3].max()) > 1
    C, D, T, _ = got
    dl_pix, dl_d = _cotangents(cfg)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)
    pg = cuda_blend_lockstep.backward_lockstep(cfg, staged, bg, T, dl_pix, dl_d, C, D)
    total = cuda_blend_mixed.backward_total(cfg, bg, T, dl_pix, dl_d, C, D)
    torch.cuda.synchronize()
    assert torch.equal(pg, cuda_blend_lockstep.backward_lockstep_ref(*args, dl_pix, dl_d, total))
    assert torch.equal(pg, cuda_blend_mixed.backward_mixed(mixed, staged, bg, T, dl_pix, dl_d, C,
                                                           D))
    assert torch.equal(pg, cuda_blend_lockstep.backward_lockstep(cfg, staged, bg, T, dl_pix,
                                                                 dl_d, C, D))
    assert (launches("K5"), launches("K6")) == (before[0] + 1, before[1] + 2)


def test_lockstep_blend_gradients_match_plain(card):
    cfg, _, _, flat = _one_view(card, 16, True)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)
    w = torch.rand((H, W, 3), generator=torch.Generator(device="cuda").manual_seed(2),
                   device=card)

    def grads(fl):
        with torch.enable_grad():
            diff = [t.clone().requires_grad_(True) for t in fl[:5] + [bg.to(fl[0].device)]]
            img, dep, *_ = tile_blend.blend_fused(cfg, *diff[:5], fl[5], fl[6], diff[5])
            loss = (img * w.to(img.device)).sum() + 0.1 * dep.sum()
            return torch.autograd.grad(loss, diff)

    a, b = grads(flat), grads(flat)
    plain = grads([x.cpu() for x in flat])
    for x, y, z in zip(a, b, plain):
        assert torch.equal(x, y) and bool(torch.isfinite(x).all())
        assert_scaled_close(x.cpu(), z, atol=1e-4)
