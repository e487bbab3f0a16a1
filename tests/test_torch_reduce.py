"""K4 on the main path of the PyTorch port: the per-Gaussian sums of the
per-slot gradients taken through the staging's own runs.

Before the staging sort each Gaussian's slots lie in one run by compact
rank (``Staged.seg``); ``Staged.inv`` gives each pre-sort slot's sorted
position. ``reduce_pair_grads`` sums each run there and writes the sum to
the Gaussian's original row. These tests hold its plain version (which the
kernel mirrors) to the float64 segment sum by sorted rank scattered through
``ids`` (the JAX package's ``reduce_pair_grads``, ``pallas_blend.py:929-948``)
with culled slots, an overflowing pair budget and padding ranks, and to
JAX's own ``reduce_pair_grads`` on the same staged list. Both sides sum
float32 values in float64, so they agree to the last float32 bit but for
rounding at ties: held at 1e-7 of each column's largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.ops import pallas_blend as jpb
from deblurgs_tpu_torch.ops import cuda_blend, cuda_blend_mixed
from deblurgs_tpu_torch.ops import tile_blend as ttb
from tests.test_torch_backward import _configs, _scene, assert_grads_close
from tests.torch_bridge import np_of, to_torch

torch.set_num_threads(1)


def _by_rank(staged, pair_grads, P):
    """float64 segment sum by sorted rank, scattered to original rows."""
    sums = cuda_blend.reduce_sorted_ref(pair_grads.double(), staged.s_gc, P)
    ids_u = torch.where(torch.arange(P) < staged.n_emit, staged.ids, P)
    out = torch.zeros((P + 1, 16), dtype=torch.float64)
    out[ids_u] = sums
    return out[:P]


def _staged_grads(max_pairs, tile_cull=True, pad=0, seed=8):
    """A 3-view scene staged at ``max_pairs`` (culled slots with the tile
    cull on), ``pad`` non-emitting Gaussians appended (padding ranks), and
    K2's plain per-slot gradients for seeded cotangents."""
    _, cfg = _configs(3)
    cfg = ttb.BlendConfig(**{**cfg.__dict__, "max_pairs": max_pairs, "tile_cull": tile_cull})
    flat, bg, _, _ = _scene(3, seed=seed)
    flat = to_torch(*flat)
    if pad:
        flat = [torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype)]) for x in flat]
    staged = cuda_blend.sort_stage(cfg, *flat, cfg.max_pairs)
    rng = np.random.default_rng(seed)
    dl_pix = torch.from_numpy(rng.standard_normal((cfg.total_tiles, cfg.tile_px, 3))
                              .astype(np.float32))
    dl_d = torch.from_numpy((0.05 * rng.standard_normal((cfg.total_tiles, cfg.tile_px)))
                            .astype(np.float32))
    C, D, T, _ = cuda_blend_mixed.forward_mixed(cfg, staged)
    pg = cuda_blend_mixed.backward_mixed(cfg, staged, torch.from_numpy(bg), T, dl_pix, dl_d, C, D)
    return cfg, staged, pg, flat[0].shape[0]


@pytest.mark.parametrize("max_pairs,tile_cull,pad", [(1 << 13, True, 0), (1 << 13, False, 0),
                                                    (300, True, 0), (1 << 13, True, 37)],
                         ids=["culled", "no_cull", "overflow", "padded"])
def test_reduce_pair_grads_matches_segment_sum(max_pairs, tile_cull, pad):
    cfg, staged, pg, P = _staged_grads(max_pairs, tile_cull, pad)
    total, n_emit = int(staged.total), int(staged.n_emit)
    cap = min(total, max_pairs)
    assert (total > max_pairs) == (max_pairs == 300)
    kept = int(staged.tile_stop[-1])
    assert (kept < cap) == tile_cull
    # the runs: all pre-sort slots below the cap, by rank; padding ranks empty
    seg = staged.seg.long()
    assert staged.seg.dtype == torch.int32 and staged.inv.dtype == torch.int32
    assert int(seg[0]) == 0 and int(seg[-1]) == cap and bool((seg[1:] >= seg[:-1]).all())
    assert bool((seg[n_emit:] == cap).all())
    assert torch.equal(torch.sort(staged.inv.long()).values, torch.arange(max_pairs))
    # each run slot's sorted position carries its rank (or the cull's P)
    rank = torch.repeat_interleave(torch.arange(P), seg[1:] - seg[:-1])
    s_gc = staged.s_gc[staged.inv[:cap].long()]
    assert bool(((s_gc == rank) | (s_gc == P)).all())
    assert int((s_gc == P).sum()) == cap - kept
    got = cuda_blend.reduce_pair_grads(staged, pg, P)
    want = _by_rank(staged, pg, P)
    assert got.shape == (P, 16) and got.dtype == torch.float32
    assert bool((got[:, 10:] == 0).all()) and bool(got[:, :10].any())
    for c in range(10):
        assert_grads_close(got[:, c], want[:, c], atol=1e-7, name=f"col {c}")
    if pad:
        assert not bool(got[P - pad:].any())


def test_reduce_pair_grads_matches_jax():
    """The port's sums against JAX's ``reduce_pair_grads`` (its default
    ``segment_sum`` path) on the JAX package's staging of the same scene."""
    jcfg, tcfg = _configs(3)
    flat, bg, _, _ = _scene(3, seed=5)
    _, staged, pg, P = _staged_grads(tcfg.max_pairs, seed=5)
    prep = jpb.prepare_fused(jcfg, *[jnp.asarray(x) for x in flat], jcfg.max_pairs)[0]
    want = np_of(jpb.reduce_pair_grads(prep, jnp.asarray(np_of(pg)), P))
    got = np_of(cuda_blend.reduce_pair_grads(staged, pg, P))
    assert want.shape == got.shape
    for c in range(10):
        assert_grads_close(got[:, c], want[:, c], atol=1e-6, name=f"col {c}")


def test_reduce_pair_grads_needs_the_runs():
    _, staged, pg, P = _staged_grads(1 << 13)
    with pytest.raises(ValueError, match="inverse"):
        cuda_blend.reduce_pair_grads(staged._replace(inv=None), pg, P)
    with pytest.raises(ValueError, match="ranks"):
        cuda_blend.reduce_pair_grads(staged, pg, P + 1)
