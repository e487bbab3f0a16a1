"""Command-line entry points (counterpart of ``deblurgs_tpu/cli``; only
``evaluate`` is ported so far)."""
