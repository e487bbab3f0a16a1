"""Command-line entry points (counterpart of ``deblurgs_tpu/cli``): ``train``
(with its ``args``), ``render_spiral``, ``render_trainview``, ``evaluate``,
``metrics``, and the COLMAP tools ``preprocess``, ``triangulate``,
``colmap_reorder`` and ``visualize_colmap``."""
