"""Reflection-based argparse groups (reference ``arguments/__init__.py``).

Counterpart of ``deblurgs_tpu/cli/args.py``: ``ParamGroup`` turns
attribute defaults into ``--flags`` (a leading underscore adds a
one-letter shorthand; a True-default bool gets a ``--no_*`` opt-out),
``ModelParams`` keeps the JAX package's flags and defaults one for one, so
a run's ``cfg_args`` reads back in both packages, and ``get_combined_args``
/ ``write_run_config`` round-trip that file. The JAX package pins a JAX
platform for its child processes through an environment variable; the
port's training CLI passes its ``--device`` to them instead.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser, Namespace


class GroupParams:
    pass


class ParamGroup:
    def __init__(self, parser: ArgumentParser, name: str, fill_none=False):
        group = parser.add_argument_group(name)
        for key, value in vars(self).items():
            shorthand = False
            if key.startswith("_"):
                shorthand = True
                key = key[1:]
            t = type(value)
            value = value if not fill_none else None
            args = ["--" + key] + (["-" + key[0:1]] if shorthand else [])
            if t == bool:
                group.add_argument(*args, default=value, action="store_true")
                if value:
                    # store_true cannot turn a True default off
                    group.add_argument("--no_" + key, dest=key, action="store_false")
            else:
                group.add_argument(*args, default=value, type=t)

    def extract(self, args):
        group = GroupParams()
        for k, v in vars(args).items():
            if k in vars(self) or ("_" + k) in vars(self):
                setattr(group, k, v)
        return group


class ModelParams(ParamGroup):
    """Reference ``ModelParams`` (``arguments/__init__.py:47-88``) plus the
    rasterizer flags of the JAX package, with its defaults."""

    def __init__(self, parser, sentinel=False):
        self.sh_degree = 2
        self._source_path = ""
        self._model_path = ""
        self._images = "images"
        self._resolution = -1
        self._white_background = False
        self.eval = False
        self.llffhold = 0
        self.num_initial_pcd = -1

        self.num_subframes = 21
        self.curve_order = 9
        self.curve_type = "se3"

        self.z_near = 0.2
        self.z_far = 100.0

        self.random_init = False
        self.alpha_lower_bound = 0.0
        self.scale_lb = 0.0
        self.scale_ub = -1.0
        self.tone_mapping_type = "gamma"
        self.activation = "relu"
        self.use_isotrophic = False
        self.curve_random_sample = False

        self.backend = "pallas"       # "pallas" | "xla" | "oracle"
        self.max_pairs = 0            # pair-list capacity; 0 = sized at train
                                      # start (Trainer.autosize_max_pairs)
        self.tile = 32
        self.window = 2               # TPU grid shape: no effect in the port
        self.kernel_layout = "mixed"  # "mixed" (K1/K2) | "lockstep" (K5/K6)
        self.tile_cull = True         # exact per-pair tile cull
        self.fast = False             # fast blend: drop the T-freeze gate
        self.tight_rect = True        # 1/255-ellipse AABB emission rects
        self.batched_render = True    # all sub-frames in ONE render_batch
        self.cams_per_step = 1        # B training cameras per step

        super().__init__(parser, "Loading Parameters", sentinel)

    def extract(self, args):
        g = super().extract(args)
        g.source_path = os.path.abspath(g.source_path)
        return g


class OptimizationParams(ParamGroup):
    """Reference ``OptimizationParams`` (``arguments/__init__.py:90-123``):
    the fields of :class:`~deblurgs_tpu_torch.train.config.OptimizationConfig`."""

    def __init__(self, parser):
        from deblurgs_tpu_torch.train.config import OptimizationConfig

        for field, value in vars(OptimizationConfig()).items():
            setattr(self, field, value)
        super().__init__(parser, "Optimization Parameters")


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """CLI args merged over the persisted ``cfg_args`` (reference ``:125-145``)."""
    args_cmdline = parser.parse_args(sys.argv[1:] if argv is None else argv)
    cfgfile_string = "Namespace()"
    try:
        with open(os.path.join(args_cmdline.model_path, "cfg_args")) as cfg_file:
            cfgfile_string = cfg_file.read()
    except (TypeError, FileNotFoundError):
        pass
    merged = vars(eval(cfgfile_string, {"Namespace": Namespace})).copy()
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)


def write_run_config(args, model_path: str):
    """Persist ``args.txt`` + ``cfg_args`` (reference ``train.py:236-247``)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "args.txt"), "w") as fp:
        for k, v in args.__dict__.items():
            print(k, ":", v, file=fp)
    with open(os.path.join(model_path, "cfg_args"), "w") as fp:
        fp.write(str(Namespace(**vars(args))))
