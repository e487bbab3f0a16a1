"""The compositing work one training iteration needs, counted by the
benchmark's own plain walk.

A gate evaluation is one pixel testing one pair of its tile's
depth-ordered list; the list holds the pairs whose 1/255 ellipse meets the
tile, and each pixel tests them in order up to the pair it stops at
(the ``evaluations`` that ``deblurgs_tpu_torch/ops/cuda_blend_mixed.py::
forward_schedule`` adds up step by step as ``live.sum()``, line 186,
and that ``chip_smoke.py::k1_schedule``, lines 1259-1276, reads). The walk
is the reference compositor's (``portbench/reference/render.py``) on the
iteration's own inputs, so a program that skips more of this work shows a
higher share of the roofline, not a lower count.

``tile_visible`` is a copy of ``deblurgs_tpu_torch/ops/cuda_blend.py::
_tile_visible`` (lines 129-167): the concave power's maximum over the tile
box against ``-log(255·opacity)``, with the same safety margin.
"""

from __future__ import annotations

import math

import torch

from portbench import scene
from portbench.reference import geometry as geo
from portbench.reference import render as ras


def tile_visible(tile: int):
    """A ``keep_fn`` for :func:`portbench.reference.render.composite_chunk`:
    per pair, whether its alpha reaches 1/255 anywhere in its tile."""
    def keep(xy, cn, opacity, tx0, ty0):
        mx, my = xy[..., 0], xy[..., 1]
        a, b, c = cn[..., 0], cn[..., 1], cn[..., 2]
        x0, y0 = tx0, ty0                      # [n, 1]
        x1, y1 = x0 + (tile - 1), y0 + (tile - 1)
        inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)

        def q(dx, dy):
            return -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy

        def edge_x(xe):
            dx = mx - xe
            py = torch.minimum(torch.maximum(my + b * dx / torch.clamp(c, min=1e-12), y0), y1)
            return q(dx, my - py)

        def edge_y(ye):
            dy = my - ye
            px = torch.minimum(torch.maximum(mx + b * dy / torch.clamp(a, min=1e-12), x0), x1)
            return q(mx - px, dy)

        pmax = torch.maximum(torch.maximum(edge_x(x0), edge_x(x1)),
                             torch.maximum(edge_y(y0), edge_y(y1)))
        pmax = torch.where(inside, torch.zeros_like(pmax), pmax)
        thresh = -torch.log(torch.clamp(255.0 * opacity, min=1e-12))
        return pmax >= thresh - (0.05 + 0.01 * torch.abs(thresh))

    return keep


def count_iteration(snap: dict, sc: dict, cli: dict) -> dict:
    """The evaluations and the pairs of the tile-culled lists of one
    iteration, from its state ``snap`` (the leaves, ``active``, ``cam``,
    ``iteration``) before the step: every sub-frame of its camera."""
    with torch.no_grad():
        cam = snap["cam"]
        views = geo.subframe_views(snap["rot_ctrl"][cam], snap["trans_ctrl"][cam],
                                   snap["nu"][cam])
        degree = min(snap["iteration"] // 1000, cli["sh_degree"])
        shs = torch.cat([snap["f_dc"], snap["f_rest"]], 1)
        q = snap["rotation"]
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
        fovx, fovy = scene.fov(sc)
        proj = geo.projection(0.01, 100.0, fovx, fovy, torch.float32, views.device)
        pre = ras.project(snap["xyz"], torch.exp(snap["scaling"]), q,
                          torch.clamp(snap["opacity"], 0.0, 1.0)[:, 0],
                          geo.sh_color(shs, snap["xyz"], geo.camera_center(views), degree),
                          views, proj, sc["width"], sc["height"], math.tan(fovx / 2),
                          math.tan(fovy / 2), cli["tile"], snap["active"])
        lists = ras.bin_pairs(pre.rect, pre.depth, sc["width"], sc["height"], cli["tile"],
                              (pre.means2d, pre.conic, pre.opacity))
        G = pre.opacity.numel()
        fields = {"xy": pre.means2d.reshape(G, 2), "conic": pre.conic.reshape(G, 3),
                  "opacity": pre.opacity.reshape(G), "color": pre.color.reshape(G, 3)}
        bg = torch.zeros(3, device=views.device)
        _, _, evaluations, kept = ras.composite(fields, lists, bg,
                                                keep_fn=tile_visible(cli["tile"]))
        tiles = lists.count.numel()
        return {"evaluations": int(evaluations), "kept_pairs": int(kept), "tiles": tiles,
                "pixels": tiles * cli["tile"] ** 2}
