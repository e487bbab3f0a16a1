"""Data / IO layer: COLMAP parsers, PLY I/O, scene readers, scene
assembly and Gaussian snapshots (counterpart of ``deblurgs_tpu/data``).
Host numpy; only ``gaussian_ply`` creates tensors, on the device it is
given."""

from deblurgs_tpu_torch.data.readers import (  # noqa: F401
    BasicPointCloud,
    CameraInfo,
    SceneInfo,
    load_scene_info,
    read_blender_scene,
    read_colmap_scene,
)
from deblurgs_tpu_torch.data.scene import Scene  # noqa: F401
