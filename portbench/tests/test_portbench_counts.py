"""The benchmark's evaluation count and window arithmetic."""

import math

import torch

from portbench.counts import evaluations, formulas
from portbench.drivers import train_loop
from portbench.reference import render as ras


def brute_force(fields, lists, tile):
    """Per pixel, walk its tile's list one pair at a time."""
    nt = lists.tiles_x * lists.tiles_y
    keep_fn = evaluations.tile_visible(tile)
    evals = kept = 0
    for t in range(lists.count.numel()):
        s, c = int(lists.start[t]), int(lists.count[t])
        g = lists.pair[s:s + c]
        lt = t % nt
        tx0, ty0 = (lt % lists.tiles_x) * tile, (lt // lists.tiles_x) * tile
        keep = keep_fn(fields["xy"][g][None], fields["conic"][g][None],
                       fields["opacity"][g][None], torch.tensor([[float(tx0)]]),
                       torch.tensor([[float(ty0)]]))[0].tolist()
        kept += sum(keep)
        for p in range(tile * tile):
            x, y = tx0 + p % tile, ty0 + p // tile
            T = 1.0
            for j, gi in enumerate(g.tolist()):
                evals += keep[j]
                mx, my = fields["xy"][gi].tolist()
                a, b, cc = fields["conic"][gi].tolist()
                dx, dy = mx - x, my - y
                power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
                alpha = min(0.99, float(fields["opacity"][gi]) * math.exp(min(power, 0.0)))
                if power > 0 or alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    break
                T *= 1 - alpha
    return evals, kept


def test_evaluation_count_equals_brute_force():
    gen = torch.Generator().manual_seed(3)
    F, P, W, H, tile = 2, 40, 32, 24, 8
    xy = torch.rand((F, P, 2), generator=gen) * torch.tensor([W, H])
    sig = 0.5 + 4 * torch.rand((F, P), generator=gen)
    conic = torch.stack([1 / sig**2, 0.1 * torch.randn((F, P), generator=gen) / sig**2,
                         1 / sig**2], -1)
    opac = 0.3 + 0.69 * torch.rand((F, P), generator=gen)
    r = torch.ceil(3 * sig)
    rect = torch.stack([torch.clamp(torch.floor((xy[..., 0] - r) / tile), 0, W // tile),
                        torch.clamp(torch.floor((xy[..., 1] - r) / tile), 0, H // tile),
                        torch.clamp(torch.floor((xy[..., 0] + r + tile - 1) / tile), 0, W // tile),
                        torch.clamp(torch.floor((xy[..., 1] + r + tile - 1) / tile), 0, H // tile)],
                       -1).long()
    depth = torch.rand((F, P), generator=gen)
    lists = ras.bin_pairs(rect, depth, W, H, tile)
    fields = {"xy": xy.reshape(-1, 2), "conic": conic.reshape(-1, 3),
              "opacity": opac.reshape(-1), "color": torch.rand((F * P, 3), generator=gen)}
    _, _, evals, kept = ras.composite(fields, lists, torch.zeros(3), budget=1 << 12, seg=3,
                                      keep_fn=evaluations.tile_visible(tile))
    assert (int(evals), int(kept)) == brute_force(fields, lists, tile)
    assert 0 < int(kept) < lists.pair.numel()


def test_window_counts_whole_chunks():
    clock = iter([4.0, 8.0, 12.0, 12.5]).__next__
    calls = []
    n, wall, ends = train_loop.window(lambda: calls.append(1), 10, 10.0, 0.0, lambda: None,
                                      clock=clock)
    assert (n, wall, len(calls), ends) == (30, 12.5, 3, [4.0, 8.0, 12.0])
    assert n and wall / n * 1e3 == 12.5 / 30 * 1e3


def test_roofline_arithmetic():
    peaks = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    assert formulas.roofline_s(67e12, 1.0, peaks) == 1.0
    assert formulas.roofline_s(0.0, 3.35e12, peaks) == 1.0
    assert formulas.k2_bytes(1, 1, 1) == 40 + 8 + 20 + 40
    busy, merged = formulas.busy_union([(0, 2), (1, 3), (5, 6), (9, 12)], 0, 10)
    assert busy == 5 and merged == [[0, 3], [5, 6], [9, 10]]
