"""A dry run of every sharded path on n ranks of one machine: the port's
counterpart of ``__graft_entry__.py::dryrun_multichip``.

Each rank is a spawned process of one ``torch.distributed`` group
(``multihost.launch``), and the exercises are JAX's five, one real step
each on toy scenes made with numpy from a seed:

1. the train step with its sub-frames sharded, one a rank, per view (xla);
2. the same with two sub-frames a rank, each rank's block in one batched
   render (pallas, mixed layout);
3. realistic static shapes: 768×384 at tile 32 (288 tiles a view), 2^17
   Gaussian slots (4,096 live), a 2^18-slot pair budget, batched;
4. the Gaussian axis at 2^20 slots (4,096 live), two sub-frames, xla;
5. one 768×384 frame in row slabs, one a rank.

Every loss must be finite, the step of 3 must not overflow its pair
budget, and every rank must print the same numbers. Run::

    python -m deblurgs_tpu_torch.scripts.dryrun_multichip --ranks 4 --device cpu
    python -m deblurgs_tpu_torch.scripts.dryrun_multichip --ranks 4 [--share_card]

On the card, each rank takes a card of its own (NCCL) unless
``--share_card`` lets fewer cards hold them (gloo, collectives staged
through host memory).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import numpy as np
import torch


def _toy(n: int, width: int, height: int, capacity: int, seed: int, dev):
    """JAX's ``_toy_scene`` in numpy: n Gaussians seeded from a point cloud
    (colour 0.5) in ``capacity`` slots, its camera and the identity curves
    of two images."""
    from deblurgs_tpu_torch.core.camera import CameraStatic, get_projection_matrix
    from deblurgs_tpu_torch.models import gaussians as gm

    fovx = 1.1
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    cs = CameraStatic(width=width, height=height, tanfovx=math.tan(fovx / 2),
                      tanfovy=math.tan(fovy / 2))
    proj = get_projection_matrix(0.01, 100.0, fovx, fovy, device=dev)
    means = torch.as_tensor(np.random.default_rng(seed).standard_normal((n, 3)),
                            dtype=torch.float32, device=dev)
    params, aux = gm.create_from_pcd(means, torch.full((n, 3), 0.5, device=dev),
                                     gm.GaussianConfig(sh_degree=1), capacity)
    return params, aux, cs, proj


def _step(params, aux, cs, proj, n_sub: int, rcfg, mesh, seed: int, gauss=False,
          batched=False):
    """One train step of the toy scene on ``mesh``: (loss, overflow count)."""
    from deblurgs_tpu_torch.models import gaussians as gm
    from deblurgs_tpu_torch.models import motion as motion_lib
    from deblurgs_tpu_torch.parallel import gauss_shard
    from deblurgs_tpu_torch.train import step as step_lib
    from deblurgs_tpu_torch.train.config import OptimizationConfig

    dev = params.xyz.device
    mcfg = motion_lib.MotionConfig(curve_order=3, n_subframes=n_sub)
    motion = motion_lib.init_motion(
        torch.eye(3, device=dev).expand(2, 3, 3),
        torch.tensor([[0.0, 0.0, -4.0]] * 2, device=dev), mcfg,
        torch.Generator(device=dev).manual_seed(seed), init_noise=0.005).params()
    st = step_lib.TrainStatics(
        gcfg=gm.GaussianConfig(sh_degree=1), mcfg=mcfg,
        ocfg=OptimizationConfig(curve_start_iter=1, densify_from_iter=10_000,
                                opacity_reset_interval=10_000),
        rcfg=rcfg, cs=cs, sh_degree=1, n_sub=n_sub, tone_mapping="identity",
        spatial_lr_scale=2.0, mesh=None if gauss else mesh, batched_render=batched)
    state = step_lib.init_state(params, motion, aux)
    gt = torch.full((cs.height, cs.width, 3), 0.4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if gauss:
        fn = gauss_shard.make_gauss_train_step(st, mesh)
        state = gauss_shard.shard_gauss_state(state, mesh)
    else:
        fn = step_lib.make_train_step(st)
    state, metrics = fn(state, gt, 0, proj, generator=gen)
    return float(metrics.loss), int(state.overflow_count)


def rank_main(rank: int, device, share_card: bool) -> dict:
    """The five exercises on this rank; every rank returns the same."""
    from deblurgs_tpu_torch.core.camera import c2w_to_view
    from deblurgs_tpu_torch.models import gaussians as gm
    from deblurgs_tpu_torch.ops.rasterize import RasterizeConfig
    from deblurgs_tpu_torch.parallel import gauss_shard, shard, tile_shard

    kw = dict(device=device, share_card=share_card)
    mesh = shard.make_mesh(**kw)
    dev, n = mesh.device, mesh.size
    out = {}
    params, aux, cs, proj = _toy(64, 32, 32, 96, 0, dev)
    xla = RasterizeConfig(backend="xla", max_pairs=1 << 11, k_max=128)
    out["per_view"] = _step(params, aux, cs, proj, n, xla, mesh, 1)
    mixed = RasterizeConfig(max_pairs=1 << 12, need_n_contrib=False)
    out["batched"] = _step(params, aux, cs, proj, 2 * n, mixed, mesh, 3, batched=True)
    bparams, baux, bcs, bproj = _toy(4096, 768, 384, 1 << 17, 5, dev)
    big = RasterizeConfig(max_pairs=1 << 18, tile_w=32, tile_h=32, need_n_contrib=False)
    out["large_shapes"] = _step(bparams, baux, bcs, bproj, n, big, mesh, 5, batched=True)
    gparams, gaux = gm.create_from_pcd(bparams.xyz[:4096], torch.full((4096, 3), 0.5, device=dev),
                                       gm.GaussianConfig(sh_degree=1), 1 << 20)
    gmesh = gauss_shard.make_gauss_mesh(**kw)
    out["gauss_2^20"] = _step(gparams, gaux, cs, proj, 2,
                              dataclasses.replace(xla, max_pairs=1 << 15, k_max=256), gmesh, 7,
                              gauss=True)
    pmesh = tile_shard.make_pixel_mesh(**kw)
    pcfg = RasterizeConfig(backend="xla", max_pairs=1 << 13, k_max=256, tile_w=32, tile_h=32)
    rin = gm.render_inputs(bparams, gm.GaussianConfig(sh_degree=1))
    view = c2w_to_view(torch.eye(3, device=dev), torch.tensor([0.0, 0.0, -4.0], device=dev))
    with torch.no_grad():
        frame = tile_shard.row_sharded_render(pmesh, bcs, bproj, pcfg, sh_degree=1)(
            rin["means3d"], rin["scales"], rin["rotations"], rin["opacities"], rin["shs"],
            view, torch.zeros(3, device=dev), active=baux.active).image
    assert frame.shape == (384, 768, 3)
    out["tile_sharded_mean"] = float(frame.mean())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--share_card", action="store_true")
    args = p.parse_args(argv)
    from deblurgs_tpu_torch.parallel import multihost

    if torch.device(args.device).type == "cuda":
        from deblurgs_tpu_torch.ops import kernels

        kernels.load_library()       # built once here, before the ranks start
    results = multihost.launch(rank_main, args.ranks, args.device, args.share_card,
                               device=args.device, share_card=args.share_card,
                               timeout_s=1800)
    first = results[0]
    if any(r != first for r in results[1:]):
        raise AssertionError(f"the ranks disagree: {results}")
    losses = [v[0] for v in first.values() if isinstance(v, tuple)]
    if not all(math.isfinite(x) for x in losses + [first["tile_sharded_mean"]]):
        raise AssertionError(f"non-finite result: {first}")
    if first["large_shapes"][1]:
        raise AssertionError("pair-budget overflow in the large-shape step")
    print(f"dryrun_multichip({args.ranks}): ok, " + ", ".join(
        f"{k}={v[0] if isinstance(v, tuple) else v:.4f}" for k, v in first.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
