"""Load a trained run (model dir) back into render-ready state.

Counterpart of ``deblurgs_tpu/eval/session.py`` (reference: the eval-time
path of ``Scene.__init__`` with ``load_iteration=-1`` and
``camera_motion_module.load``, ``motion.py:351-365``), driven by the run's
persisted ``cfg_args``. A key missing from ``cfg_args`` takes JAX's
default: ``kernel_layout`` "lockstep", ``tile`` 16, ``window`` 1,
``backend`` "xla", and ``max_pairs`` ≤ 0 or missing means ``1 << 19`` to
start with. A view that emits more pairs than the budget holds grows it
and renders again (:func:`render_fitted`), and so does a view on xla
whose longest tile list passes ``k_max``, where JAX's session composites
a truncated list. The session's tensors live on its device; the scene
stays on the host.
"""

from __future__ import annotations

import dataclasses
import math
import os
from argparse import Namespace

import torch

from deblurgs_tpu_torch.core.camera import CameraArrays
from deblurgs_tpu_torch.data.gaussian_ply import load_gaussian_ply
from deblurgs_tpu_torch.data.scene import Scene
from deblurgs_tpu_torch.device import resolve_device
from deblurgs_tpu_torch.models import gaussians as gm
from deblurgs_tpu_torch.models import tonemap as tm
from deblurgs_tpu_torch.models.motion import MotionConfig, MotionParams
from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig, render
from deblurgs_tpu_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class TrainedSession:
    scene: Scene
    gcfg: gm.GaussianConfig
    mcfg: MotionConfig
    rcfg: RasterizeConfig
    params: gm.GaussianParams
    aux: gm.GaussianAux
    motion: MotionParams
    iteration: int
    tone_mapping: str
    device: torch.device


def read_cfg_args(model_path: str) -> Namespace:
    """The training CLI's ``cfg_args``: the repr of its argparse Namespace."""
    with open(os.path.join(model_path, "cfg_args")) as f:
        return eval(f.read(), {"Namespace": Namespace})


def load_session(model_path: str, source_path: str | None = None,
                 load_iteration: int = -1, resolution: int | None = None,
                 backend: str | None = None, device="cuda") -> TrainedSession:
    dev = resolve_device(device)
    args = read_cfg_args(model_path)
    source = source_path or args.source_path
    use_sigmoid = getattr(args, "activation", "relu") == "sigmoid"

    gcfg = gm.GaussianConfig(
        sh_degree=args.sh_degree,
        alpha_lower_bound=getattr(args, "alpha_lower_bound", 0.0),
        scale_lb=getattr(args, "scale_lb", 0.0),
        scale_ub=getattr(args, "scale_ub", -1.0),
        use_isotropic=getattr(args, "use_isotrophic", False),
        use_sigmoid=use_sigmoid,
        z_near=getattr(args, "z_near", 0.2),
        z_far=getattr(args, "z_far", 100.0),
    )
    mcfg = MotionConfig(curve_order=args.curve_order, n_subframes=args.num_subframes,
                        curve_type=args.curve_type)
    # max_pairs <= 0 is the training CLI's "auto-size at train start" marker;
    # eval renders one view: the single-view default, grown by render_fitted
    mp = getattr(args, "max_pairs", 1 << 19)
    rcfg = RasterizeConfig(
        backend=backend or getattr(args, "backend", "xla"),
        max_pairs=mp if mp > 0 else 1 << 19,
        tile_w=getattr(args, "tile", 16), tile_h=getattr(args, "tile", 16),
        window=getattr(args, "window", 1),
        layout=getattr(args, "kernel_layout", "lockstep"),
        cull_z=gcfg.z_near, z_far=gcfg.z_far, use_sigmoid=use_sigmoid,
    )
    scene = Scene(
        source, model_path=None,
        images=getattr(args, "images", "images"),
        resolution=resolution if resolution is not None else args.resolution,
        eval_split=getattr(args, "eval", False),
        llffhold=getattr(args, "llffhold", 0),
        num_initial_pcd=getattr(args, "num_initial_pcd", -1),
        z_near=gcfg.z_near, z_far=gcfg.z_far,
        use_sigmoid=use_sigmoid, shuffle=False,
    )
    pc_root = os.path.join(model_path, "point_cloud")
    it = Scene.search_max_iteration(pc_root) if load_iteration == -1 else load_iteration
    params, aux = load_gaussian_ply(
        os.path.join(pc_root, f"iteration_{it}", "point_cloud.ply"), gcfg, device=dev)
    motion = ckpt_lib.load_motion(os.path.join(model_path, "cm.npz"), device=dev)
    return TrainedSession(scene=scene, gcfg=gcfg, mcfg=mcfg, rcfg=rcfg, params=params,
                          aux=aux, motion=motion, iteration=it,
                          tone_mapping=getattr(args, "tone_mapping_type", "gamma"), device=dev)


def render_fitted(session: TrainedSession, rin: dict, cam: CameraArrays, bg: torch.Tensor):
    """``render`` of one view at the session's budgets. A view that emits
    more pairs than ``max_pairs`` holds, or on xla has a tile list longer
    than ``k_max``, would composite a truncated list; instead the budget
    grows, for this view and every later one, and the view renders again:
    ``max_pairs`` to the next power of two above 1.5× the pairs emitted,
    ``k_max`` to the next power of two that holds the longest list."""
    args = (rin["means3d"], rin["scales"], rin["rotations"], rin["opacities"], rin["shs"], cam,
            session.scene.camera_static, bg)
    kw = dict(sh_degree=session.gcfg.sh_degree, active=session.aux.active)
    out = render(*args, cfg=session.rcfg, **kw)
    n, longest = int(out.num_pairs), int(out.max_per_tile)
    rcfg = session.rcfg
    if n > rcfg.max_pairs:
        rcfg = dataclasses.replace(rcfg, max_pairs=1 << math.ceil(math.log2(1.5 * n)))
        print(f"[pairs] a view emits {n} pairs: the session's max_pairs → {rcfg.max_pairs}")
    if rcfg.backend == "xla" and longest > rcfg.k_max:
        rcfg = dataclasses.replace(rcfg, k_max=1 << math.ceil(math.log2(longest)))
        print(f"[pairs] a tile lists {longest} pairs: the session's k_max → {rcfg.k_max}")
    if rcfg == session.rcfg:
        return out
    session.rcfg = rcfg
    return render(*args, cfg=session.rcfg, **kw)


def render_view(session: TrainedSession, cam: CameraArrays, *, tone_map: bool = True,
                bg: torch.Tensor | None = None):
    """Render one view of a loaded session: (image [H, W, 3] clamped to
    [0, 1], tone-mapped unless ``tone_map`` is False; depth [H, W])."""
    bg = torch.zeros(3, device=session.device) if bg is None else bg
    with torch.no_grad():
        out = render_fitted(session, gm.render_inputs(session.params, session.gcfg), cam, bg)
        img = tm.tone_map(out.image, session.tone_mapping) if tone_map else out.image
        return torch.clamp(img, 0.0, 1.0), out.depth
