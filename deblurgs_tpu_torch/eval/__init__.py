"""Evaluation and export: trained-session loading, test-pose refinement,
metrics (PSNR, SSIM, offline LPIPS) and the spiral path (counterpart of
``deblurgs_tpu/eval``)."""
