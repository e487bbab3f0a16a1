"""Mean squared distance to the 3 nearest neighbours (``distCUDA2``).

Counterpart of ``deblurgs_tpu/ops/knn.py``'s exact path (reference
``simple_knn.cu:185-221``): per point, the mean of the min(3, N-1)
smallest squared distances to the other points, computed in row chunks
(O(N²), a one-time cost of scene initialisation). The JAX package's
Morton-window approximation and its native host search are not ported:
the exact search runs on the card at the operating point's 100k points.
"""

from __future__ import annotations

import torch


def knn3_mean_sq_dist(points: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N] mean squared distance to the 3 nearest other points."""
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
