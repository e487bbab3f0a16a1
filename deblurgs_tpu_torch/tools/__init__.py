"""External-tool drivers (counterpart of ``deblurgs_tpu/tools``): the
COLMAP preprocessing and registration pipelines."""
