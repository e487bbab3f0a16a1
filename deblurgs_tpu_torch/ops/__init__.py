"""Rasterizer ops (counterpart of ``deblurgs_tpu/ops``).

1. ``preprocess``       — per-Gaussian cull/project/conic/SH.
2. ``binning``          — pair expansion (compact and original id
                          space), ``bin_gaussians``, range search.
3. ``cuda_blend``       — staging: segmented broadcast with the slots'
                          tile ids, exact tile cull and sort keys (kernel
                          K3), stable (tile, depth) sort, the sorted
                          pair list (kernel K7); the gradient reduce by
                          compact rank (kernel K4).
4. ``cuda_blend_mixed`` — front-to-back compositing of stacked views
                          (kernel K1) and its per-pair gradients (kernel K2).
5. ``cuda_blend_lockstep`` — the same for one view, ``layout="lockstep"``
                          (K5 and K6: K1's and K2's kernels on one
                          view's tiles, with their own launch counts).
6. ``tile_blend``       — BlendConfig, tiling, ``blend_fused`` (an
                          autograd Function: K3 and K1 or K5 forward; K2 or
                          K6, then K4, backward) and ``blend``, the xla
                          backend's lockstep walk with its hand-written
                          backward (plain PyTorch).
7. ``oracle``           — the dense per-pixel compositor (the anchor).
8. ``rasterize``        — the public ``render`` (pallas, xla, oracle) /
                          ``render_batch`` (pallas, mixed).
9. ``knn``              — 3-NN mean squared distance (scene initialisation):
                          exact, or the Morton-window search.
10. ``kernels``         — builds and loads ``csrc/*.cu`` on first use.
"""
