"""Plain tile rasteriser: preprocess, binning and front-to-back compositing.

The reference 3D Gaussian splatting rasteriser (diff-gaussian-rasterization
``forward.cu``, ``backward.cu``, ``auxiliary.h``) as DeblurGS configures
it, in plain PyTorch: per-Gaussian preprocess (cull, projection, EWA 2D
covariance with its 0.3 px dilation, the 1/255-ellipse emission rectangle),
(tile, depth) binning by two stable sorts, and compositing with the alpha
gate (alpha >= 1/255, alpha <= 0.99) and the transmittance stop (a pixel
stops at the first pair that would take T below 1e-4). Gradients come from
autograd; alpha's 0.99 clamp passes its gradient through, as the CUDA
rasteriser's backward does.

Compositing walks chunks of tiles with the pairs of each tile's list in
segments; a chunk stops once every pixel in it has stopped. Within a
segment the transmittance is a cumulative product. It imports nothing of
the program under test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


class Projected(NamedTuple):
    means2d: torch.Tensor   # [F, P, 2] pixel-space centres
    conic: torch.Tensor     # [F, P, 3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor   # [F, P]
    color: torch.Tensor     # [F, P, 3]
    depth: torch.Tensor     # [F, P]
    rect: torch.Tensor      # [F, P, 4] int64 tile rectangle (x0, y0, x1, y1), empty if culled
    radius: torch.Tensor    # [F, P] 3-sigma radius in pixels, 0 where not visible


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) [P, 4] → rotation [P, 3, 3]."""
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _rect(px, py, rx, ry, tiles_x: int, tiles_y: int, tile: int):
    x0 = torch.clamp(torch.floor((px - rx) / tile), 0, tiles_x)
    y0 = torch.clamp(torch.floor((py - ry) / tile), 0, tiles_y)
    x1 = torch.clamp(torch.floor((px + rx + tile - 1) / tile), 0, tiles_x)
    y1 = torch.clamp(torch.floor((py + ry + tile - 1) / tile), 0, tiles_y)
    return torch.stack([x0, y0, x1, y1], -1).to(torch.int64)


def project(xyz, scales, quats, opacity, shs_color, views, proj, width: int, height: int,
            tanfovx: float, tanfovy: float, tile: int, active, cull_z: float = 0.2
            ) -> Projected:
    """Preprocess of P Gaussians in F views.

    xyz [P, 3], scales [P, 3] (activated), quats [P, 4] (unit), opacity
    [P] (activated), shs_color [F, P, 3] (the views' SH colour), views
    [F, 4, 4] row-vector world-to-view, proj [4, 4].
    """
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1)
    p_view = hom @ views[:, :, :3]                      # [F, P, 3]
    z = p_view[..., 2]
    front = z > cull_z
    clip = hom @ (views @ proj)                         # [F, P, 4]
    w = torch.where(front, clip[..., 3] + 1e-7, torch.ones_like(z))
    ndc = clip[..., :2] / w[..., None]

    rot = quat_to_rot(quats)
    L = rot * scales[:, None, :]
    sigma = L @ L.transpose(-1, -2)                     # [P, 3, 3] world covariance
    W = views[:, None, :3, :3].transpose(-1, -2)        # [F, 1, 3, 3] world → view
    M = W @ sigma[None] @ W.transpose(-1, -2)           # [F, P, 3, 3]
    tz = torch.where(front, z, torch.ones_like(z))
    fx, fy = width / (2.0 * tanfovx), height / (2.0 * tanfovy)
    tx = torch.clamp(p_view[..., 0] / tz, -1.3 * tanfovx, 1.3 * tanfovx) * tz
    ty = torch.clamp(p_view[..., 1] / tz, -1.3 * tanfovy, 1.3 * tanfovy) * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], -1),
                     torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], -1)], -2)
    cov = J @ M @ J.transpose(-1, -2)                   # [F, P, 2, 2]
    a = cov[..., 0, 0] + 0.3
    b = cov[..., 0, 1]
    c = cov[..., 1, 1] + 0.3
    det = a * c - b * b
    ok = det != 0.0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), zero)
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    radius = torch.where(front & ok, radius, zero).detach()
    px = ((ndc[..., 0] + 1.0) * width - 1.0) * 0.5
    py = ((ndc[..., 1] + 1.0) * height - 1.0) * 0.5

    tiles_x, tiles_y = -(-width // tile), -(-height // tile)
    with torch.no_grad():
        r3 = _rect(px, py, radius, radius, tiles_x, tiles_y, tile)
        area3 = (r3[..., 2] - r3[..., 0]) * (r3[..., 3] - r3[..., 1])
        visible = front & ok & (area3 > 0) & active[None]
        # emission rectangle: the box of the alpha >= 1/255 ellipse (+0.1 in
        # the log and +1 px of slack), inside the 3-sigma square
        lg = torch.log(torch.clamp(255.0 * opacity, min=1e-12)) + 0.1
        rx = torch.minimum(torch.sqrt(torch.clamp(2.0 * lg * a, min=0.0)) + 1.0, radius)
        ry = torch.minimum(torch.sqrt(torch.clamp(2.0 * lg * c, min=0.0)) + 1.0, radius)
        rect = _rect(px, py, rx, ry, tiles_x, tiles_y, tile)
        rect = torch.where(visible[..., None], rect, torch.zeros_like(rect))
    return Projected(means2d=torch.stack([px, py], -1), conic=conic,
                     opacity=opacity.expand(z.shape), color=shs_color, depth=z, rect=rect,
                     radius=torch.where(visible, radius, zero))


class Lists(NamedTuple):
    """Every view's tiles' depth-ordered pair lists (views stacked on the
    tile axis: view v owns tiles [v·nt, (v+1)·nt))."""

    pair: torch.Tensor    # [n_pairs] flat (view · P + Gaussian) index, by (tile, depth)
    start: torch.Tensor   # [F · nt] first pair of each tile
    count: torch.Tensor   # [F · nt] pairs of each tile
    tiles_x: int
    tiles_y: int
    tile: int


def reaches_tile(xy, conic, opacity, x0, y0, tile: int, margin: float = 1.0):
    """Whether a splat's alpha can reach 1/255 anywhere in the tile box
    [x0, x0 + tile - 1] × [y0, y0 + tile - 1], with ``margin`` of room in
    the log: the least Mahalanobis distance from the mean to the box (0
    inside it; else the least over the four edges, each a 1-D quadratic)
    against 2·log(255·opacity)."""
    mx, my = xy[:, 0], xy[:, 1]
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    x1, y1 = x0 + (tile - 1), y0 + (tile - 1)

    def dist(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    best = torch.full_like(mx, float("inf"))
    for xe in (x0, x1):
        dx = mx - xe
        dy = torch.clamp(-b * dx / torch.clamp(c, min=1e-12), my - y1, my - y0)
        best = torch.minimum(best, dist(dx, dy))
    for ye in (y0, y1):
        dy = my - ye
        dx = torch.clamp(-b * dy / torch.clamp(a, min=1e-12), mx - x1, mx - x0)
        best = torch.minimum(best, dist(dx, dy))
    inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)
    best = torch.where(inside, torch.zeros_like(best), best)
    return -0.5 * best >= -torch.log(torch.clamp(255.0 * opacity, min=1e-12)) - margin


def bin_pairs(rect: torch.Tensor, depth: torch.Tensor, width: int, height: int,
              tile: int, splats: tuple | None = None) -> Lists:
    """Each Gaussian's pairs with the tiles of its rectangle, ordered by
    tile and, within a tile, by depth (ties in Gaussian order). With
    ``splats`` (xy [F, P, 2], conic [F, P, 3], opacity [F, P]) a pair
    whose splat cannot reach its tile (:func:`reaches_tile`) is left out:
    no pixel of the tile could composite it."""
    F, P = depth.shape
    tiles_x, tiles_y = -(-width // tile), -(-height // tile)
    nt = tiles_x * tiles_y
    r = rect.reshape(F * P, 4)
    w = r[:, 2] - r[:, 0]
    area = w * (r[:, 3] - r[:, 1])
    owner = torch.repeat_interleave(torch.arange(F * P, device=rect.device), area)
    first = torch.cumsum(area, 0) - area
    local = torch.arange(owner.numel(), device=rect.device) - first[owner]
    wo = w[owner]
    tx = r[owner, 0] + local % wo
    ty = r[owner, 1] + local // wo
    if splats is not None:
        xy, conic, opacity = (x.detach().reshape(F * P, -1) for x in splats)
        dt = xy.dtype
        keep = reaches_tile(xy[owner], conic[owner], opacity[owner, 0],
                            (tx * tile).to(dt), (ty * tile).to(dt), tile)
        owner, tx, ty = owner[keep], tx[keep], ty[keep]
    t = (owner // P) * nt + ty * tiles_x + tx
    by_depth = torch.argsort(depth.reshape(F * P)[owner], stable=True)
    order = by_depth[torch.argsort(t[by_depth], stable=True)]
    count = torch.bincount(t, minlength=F * nt)
    return Lists(pair=owner[order], start=torch.cumsum(count, 0) - count, count=count,
                 tiles_x=tiles_x, tiles_y=tiles_y, tile=tile)


def chunk_plan(lists: Lists, budget: int, seg: int | None) -> list:
    """Chunks of tiles, longest lists first, each holding at most
    ``budget`` (pixel, pair) elements a segment (``seg`` pairs, or the
    whole list when None)."""
    px = lists.tile * lists.tile
    counts = lists.count.cpu()
    order = torch.argsort(counts, descending=True, stable=True)
    sorted_counts = counts[order].tolist()
    chunks, i = [], 0
    while i < len(sorted_counts) and sorted_counts[i] > 0:
        L = sorted_counts[i]
        n = max(1, budget // (px * (L if seg is None else min(L, seg))))
        chunks.append((order[i:i + n], L))
        i += n
    return chunks


def _pixels(lists: Lists, tiles: torch.Tensor, dtype):
    nt = lists.tiles_x * lists.tiles_y
    lt = tiles % nt
    p = torch.arange(lists.tile * lists.tile, device=tiles.device)
    x = ((lt % lists.tiles_x) * lists.tile)[:, None] + (p % lists.tile)[None]
    y = ((lt // lists.tiles_x) * lists.tile)[:, None] + (p // lists.tile)[None]
    return x.to(dtype), y.to(dtype)


def composite_chunk(fields: dict, lists: Lists, tiles: torch.Tensor, L: int, seg: int,
                    keep_fn=None):
    """Front-to-back compositing of the tiles ``tiles`` (lists up to ``L``
    long). ``fields``: flat per-(view, Gaussian) ``xy`` [G, 2], ``conic``
    [G, 3], ``opacity`` [G], ``color`` [G, 3], differentiable.

    Returns (C [n, PX, 3], T [n, PX], evaluations, kept). With ``keep_fn``
    (pair fields, tile origins → [n, S] bool), ``evaluations`` counts the
    (pixel, pair) gate tests that compositing the pairs ``keep_fn`` keeps
    needs, each pixel testing its tile's pairs in order up to the one it
    stops at, and ``kept`` those pairs; else both are 0.
    """
    dev = tiles.device
    dtype = fields["opacity"].dtype
    px, py = _pixels(lists, tiles, dtype)
    n, npx = px.shape
    start, cnt = lists.start[tiles], lists.count[tiles]
    T = torch.ones((n, npx), dtype=dtype, device=dev)        # over the composited pairs
    gate = torch.ones((n, npx), dtype=dtype, device=dev)     # over every eligible pair
    C = torch.zeros((n, npx, 3), dtype=dtype, device=dev)
    evaluations = torch.zeros((), dtype=torch.int64, device=dev)
    kept = torch.zeros((), dtype=torch.int64, device=dev)
    last = lists.pair.numel() - 1
    for s0 in range(0, L, seg):
        k = torch.arange(s0, min(L, s0 + seg), device=dev)
        valid = k[None] < cnt[:, None]                       # [n, S]
        g = lists.pair[torch.clamp(start[:, None] + k[None], max=last)]
        xy, cn = fields["xy"][g], fields["conic"][g]          # [n, S, 2], [n, S, 3]
        dx = xy[:, None, :, 0] - px[..., None]                # [n, PX, S]
        dy = xy[:, None, :, 1] - py[..., None]
        power = (-0.5 * (cn[:, None, :, 0] * dx * dx + cn[:, None, :, 2] * dy * dy)
                 - cn[:, None, :, 1] * dx * dy)
        raw = fields["opacity"][g][:, None, :] * torch.exp(torch.clamp(power, max=0.0))
        with torch.no_grad():
            alpha = torch.clamp(raw, max=0.99)
            elig = valid[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
            gate_in = gate[..., None] * torch.cumprod(
                1.0 - torch.where(elig, alpha, torch.zeros_like(alpha)), -1)
            contrib = elig & (gate_in >= T_EPS)
            if keep_fn is not None:
                live = torch.cat([gate[..., None], gate_in[..., :-1]], -1) >= T_EPS
                keep = keep_fn(xy, cn, fields["opacity"][g], px[:, :1], py[:, :1]) & valid
                evaluations += (live & keep[:, None, :]).sum()
                kept += keep.sum()
            gate = gate_in[..., -1]
        # alpha's value with the gradient of the unclamped product
        a = torch.where(contrib, raw - (raw - alpha).detach(), torch.zeros_like(raw))
        Tin = T[..., None] * torch.cumprod(1.0 - a, -1)
        w = a * torch.cat([T[..., None], Tin[..., :-1]], -1)
        C = C + w @ fields["color"][g]
        T = Tin[..., -1]
        if not bool((gate >= T_EPS).any()):
            break
    return C, T, evaluations, kept


def composite(fields: dict, lists: Lists, bg: torch.Tensor, budget: int = 1 << 27,
              seg: int = 256, keep_fn=None):
    """Every tile, without gradients: (image tiles [F · nt, PX, 3],
    final T [F · nt, PX], evaluations, kept)."""
    n_all = lists.count.numel()
    npx = lists.tile * lists.tile
    dtype = fields["opacity"].dtype
    dev = lists.count.device
    out = bg.to(dtype).expand(n_all, npx, 3).clone()
    T = torch.ones((n_all, npx), dtype=dtype, device=dev)
    evaluations = torch.zeros((), dtype=torch.int64, device=dev)
    kept = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for tiles, L in chunk_plan(lists, budget, seg):
            tiles = tiles.to(dev)
            C, Tc, e, k = composite_chunk(fields, lists, tiles, L, seg, keep_fn)
            out[tiles] = C + Tc[..., None] * bg
            T[tiles] = Tc
            evaluations += e
            kept += k
    return out, T, evaluations, kept


def composite_backward(fields: dict, lists: Lists, bg: torch.Tensor, d_tiles: torch.Tensor,
                       budget: int = 1 << 26, seg: int = 256) -> None:
    """Accumulate into the ``.grad`` of ``fields`` the gradient of
    ``sum(image tiles · d_tiles)``, chunk by chunk (each chunk's forward is
    recomputed with autograd)."""
    dev = lists.count.device
    for tiles, L in chunk_plan(lists, budget, None):
        tiles = tiles.to(dev)
        C, T, _, _ = composite_chunk(fields, lists, tiles, L, seg)
        img = C + T[..., None] * bg
        torch.sum(img * d_tiles[tiles]).backward()


def tiles_to_images(tiles: torch.Tensor, F: int, lists: Lists, width: int,
                    height: int) -> torch.Tensor:
    """[F · nt, PX, C] → [F, H, W, C] (padding cropped)."""
    t, tx, ty = lists.tile, lists.tiles_x, lists.tiles_y
    x = tiles.reshape(F, ty, tx, t, t, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(F, ty * t, tx * t, -1)[:, :height, :width]


def images_to_tiles(img: torch.Tensor, lists: Lists) -> torch.Tensor:
    """[F, H, W, C] → [F · nt, PX, C] (zero padding)."""
    F, H, W, c = img.shape
    t, tx, ty = lists.tile, lists.tiles_x, lists.tiles_y
    pad = img.new_zeros((F, ty * t, tx * t, c))
    pad[:, :H, :W] = img
    x = pad.reshape(F, ty, t, tx, t, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(F * ty * tx, t * t, c)
