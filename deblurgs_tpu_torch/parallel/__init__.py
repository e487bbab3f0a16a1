"""Scale-out over ranks of a ``torch.distributed`` group.

Counterpart of ``deblurgs_tpu/parallel/``. Three axes shard: the sub-frames
of a step (``shard.py``: each rank renders its block of views, the scene
replicated), the Gaussians (``gauss_shard.py``: each rank owns a block of
the capacity's rows) and the pixels (``tile_shard.py``: each rank renders a
row slab). ``multihost.py`` joins the group, starts the ranks of one
machine and keeps each rank's training images.
"""

from deblurgs_tpu_torch.parallel.shard import make_mesh, sharded_subframe_render  # noqa: F401
