"""Model layer: Gaussian scene, camera-motion curves, densification, tone
mapping and the blur-synthesis query (counterpart of ``deblurgs_tpu/models``)."""

from deblurgs_tpu_torch.models.gaussians import GaussianConfig, GaussianModel  # noqa: F401
from deblurgs_tpu_torch.models.motion import MotionConfig, MotionModel  # noqa: F401
