"""deblurgs_tpu_torch — PyTorch/CUDA port of the DeblurGS framework.

The render path and the train step of ``deblurgs_tpu`` (camera-motion blur
synthesis over per-image SE(3) Bézier trajectories, rendered by a
tile-binned Gaussian-splatting rasterizer, trained jointly with the
trajectories) rebuilt on PyTorch, with hand-written CUDA kernels for the
hot spots:

- ``ops/cuda_blend.py``: pair staging (expansion, tile cull, two-key sort),
  the segmented-broadcast kernel K3 and the gradient reduce K4
  (counterpart of ``deblurgs_tpu/ops/pallas_blend.py``);
- ``ops/cuda_blend_mixed.py``: the front-to-back compositing kernel K1 and
  its backward K2 (counterpart of ``deblurgs_tpu/ops/pallas_blend_mixed.py``);
- ``train/step.py``: the train step (counterpart of
  ``deblurgs_tpu/train/step.py``), gradients by autograd around K2 and K4.

Kernels are compiled with ``nvcc`` from ``csrc/`` into ``build/`` on first
use; importing this package needs neither CUDA nor a compiler. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"`` (or CPU tensors),
in which case every kernel wrapper runs its plain PyTorch version.

Matrix convention (same as the JAX package): row-vector transforms,
``p_view = p_hom @ view`` with ``view`` the transposed world-to-view matrix,
``full_proj = view @ proj``.
"""

__version__ = "0.1.0"

from deblurgs_tpu_torch.ops.rasterize import (  # noqa: F401
    RasterizeConfig,
    render,
    render_batch,
)
