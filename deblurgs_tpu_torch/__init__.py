"""deblurgs_tpu_torch — PyTorch/CUDA port of the DeblurGS framework.

The render path, training and held-out evaluation of ``deblurgs_tpu``
(camera-motion blur synthesis over per-image SE(3) Bézier trajectories,
rendered by a tile-binned Gaussian-splatting rasterizer, trained jointly
with the trajectories; ``data/`` reads datasets and trained runs,
``train/loop.py`` and ``cli/train.py`` run a training schedule,
``utils/`` watches it, ``eval/`` and ``cli/`` render, export and score a
trained run) rebuilt on PyTorch, with hand-written CUDA kernels for the
hot spots:

- ``ops/cuda_blend.py``: pair staging (expansion, tile cull, two-key sort),
  the segmented-broadcast kernel K3 (with the slots' sort keys), the
  sorted pair list's kernel K7 and the gradient reduce K4
  (counterpart of ``deblurgs_tpu/ops/pallas_blend.py``);
- ``ops/cuda_blend_mixed.py``: the front-to-back compositing kernel K1 and
  its backward K2 (counterpart of ``deblurgs_tpu/ops/pallas_blend_mixed.py``);
- ``ops/cuda_blend_lockstep.py``: the same function on one view, K5 and its
  backward K6 (``layout="lockstep"``; counterpart of ``pallas_blend.py``'s
  ``forward`` and ``backward``), which launch K1's and K2's kernels;
- ``train/step.py``: the train step (counterpart of
  ``deblurgs_tpu/train/step.py``), gradients by autograd around K2 and K4.

The xla backend (``ops/tile_blend.py::blend``, a lockstep walk over pair
slots with a hand-written backward) and the oracle (``ops/oracle.py``)
render the same function in plain PyTorch, as JAX runs them outside any
Pallas kernel. ``native/`` is the host library (3-NN, COLMAP parsing;
g++ at first use) and ``tools/`` drives COLMAP.

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
