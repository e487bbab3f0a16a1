"""Mean squared distance to the 3 nearest neighbours (``distCUDA2``).

Counterpart of ``deblurgs_tpu/ops/knn.py`` (reference
``simple_knn.cu:185-221``), with the same two methods:

- ``exact``: per point, the mean of the min(3, N-1) smallest squared
  distances to the other points, in row chunks (O(N²), a one-time cost of
  scene initialisation). ``models/gaussians.py::create_from_pcd`` takes it
  on the card for every N; the JAX package goes to the native host search
  above 50k points only because its on-chip exact pass is slow;
- ``approx``: the Morton-window search: candidates from ±``window``
  neighbours under three shifted Morton orderings, merged without counting
  a point twice.
"""

from __future__ import annotations

import torch


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (simple_knn.cu ``prepMorton``);
    int64 arithmetic whose masks keep JAX's uint32 results."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _codes(unit: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(unit * 1023.0, 0, 1023).to(torch.int64)
    return _expand_bits(q[:, 0]) | (_expand_bits(q[:, 1]) << 1) | (_expand_bits(q[:, 2]) << 2)


def _bounds(points: torch.Tensor):
    mn = torch.min(points, dim=0).values
    extent = torch.clamp(torch.max(points, dim=0).values - mn, min=1e-9)
    return mn, extent


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes of points normalised to their AABB ([N, 3] f32
    → [N] int64)."""
    mn, extent = _bounds(points)
    return _codes((points - mn) / extent)


def _exact_knn3_mean_sq(points: torch.Tensor) -> torch.Tensor:
    n = points.shape[0]
    k = min(3, n - 1)
    if k <= 0:
        return torch.zeros(n, dtype=torch.float32, device=points.device)
    chunk = max(1, min(1024, (1 << 27) // (3 * n)))   # bounds the [chunk, N, 3] temporary
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    cols = torch.arange(n, device=points.device)
    for lo in range(0, n, chunk):
        q = points[lo:lo + chunk]
        d2 = torch.sum((q[:, None, :] - points[None, :, :]) ** 2, dim=-1)
        rows = torch.arange(lo, lo + q.shape[0], device=points.device)
        d2 = torch.where(rows[:, None] == cols[None, :], torch.inf, d2)
        out[lo:lo + q.shape[0]] = torch.mean(torch.topk(d2, k, largest=False).values, dim=-1)
    return out


def _window_knn3_mean_sq(points: torch.Tensor, window: int = 24) -> torch.Tensor:
    """Morton-ordered window search, merged over 3 grid-shifted orderings,
    tracking neighbour ids so a point found under two orderings counts
    once (``knn.py:70-124``). Argsorts and the merge are stable, so equal
    codes and equal distances order as JAX's do."""
    n = points.shape[0]
    dev = points.device
    best_d = torch.full((n, 3), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((n, 3), -1, dtype=torch.int64, device=dev)
    mn, extent = _bounds(points)
    idx = torch.arange(n, device=dev)
    for shift in (0.0, 1.0 / 3.0, 2.0 / 3.0):
        unit = (points - mn) / extent * (1.0 - shift * 0.5) + shift * 0.25
        order = torch.argsort(_codes(unit), stable=True)
        inv = torch.empty_like(order)
        inv[order] = idx
        sorted_pts = points[order]
        cand_d2, cand_id = [], []
        for off in range(1, window + 1):
            for sgn in (-off, off):
                j = idx + sgn
                ok = (j >= 0) & (j < n)
                j = torch.clamp(j, 0, n - 1)
                d2 = torch.sum((sorted_pts - sorted_pts[j]) ** 2, dim=-1)
                cand_d2.append(torch.where(ok, d2, torch.inf))
                cand_id.append(torch.where(ok, order[j], -2))
        cand_d = torch.stack(cand_d2, dim=-1)[inv]      # back to original order
        cand_i = torch.stack(cand_id, dim=-1)[inv]
        # drop candidates already among the best 3 (cross-ordering duplicates)
        dup = torch.any(cand_i[:, :, None] == best_i[:, None, :], dim=-1)
        cand_d = torch.where(dup, torch.inf, cand_d)
        md = torch.cat([best_d, cand_d], dim=-1)
        mi = torch.cat([best_i, cand_i], dim=-1)
        top = torch.sort(md, dim=-1, stable=True).indices[:, :3]
        best_d = torch.gather(md, 1, top)
        best_i = torch.gather(mi, 1, top)
    return torch.mean(best_d, dim=-1)


def knn3_mean_sq_dist(points: torch.Tensor, method: str = "exact",
                      window: int = 24) -> torch.Tensor:
    """[N, 3] → [N] mean squared distance to the 3 nearest other points:
    ``exact`` (default) or ``approx`` (the Morton-window search)."""
    if method == "exact":
        return _exact_knn3_mean_sq(points)
    return _window_knn3_mean_sq(points, window=window)
