"""Rasterizer ops (counterpart of ``deblurgs_tpu/ops``).

1. ``preprocess``       — per-Gaussian cull/project/conic/SH.
2. ``binning``          — compact pair expansion and range search.
3. ``cuda_blend``       — staging: segmented broadcast (kernel K3), exact
                          tile cull, stable (tile, depth) sort; the
                          gradient reduce by compact rank (kernel K4).
4. ``cuda_blend_mixed`` — front-to-back compositing (kernel K1) and its
                          per-pair gradients (kernel K2).
5. ``tile_blend``       — BlendConfig, tiling, ``blend_fused`` (an
                          autograd Function: K3, K1 forward; K2, K4 backward).
6. ``rasterize``        — the public ``render`` / ``render_batch``.
7. ``knn``              — 3-NN mean squared distance (scene initialisation).
8. ``kernels``          — builds and loads ``csrc/*.cu`` on first use.
"""
