"""Standalone COLMAP-workspace builder from known camera poses.

Reference counterpart: ``scripts/triangulation.py:33-150`` — given any
loadable dataset (Blender JSON or an existing COLMAP layout), fix the known
intrinsics/extrinsics and run COLMAP's ``point_triangulator`` to produce a
standard workspace (``images/`` + ``sparse/0``) with a triangulated sparse
point cloud. Useful for converting Blender/LLFF captures to the COLMAP
layout the training pipeline ingests.

Counterpart of ``deblurgs_tpu/cli/triangulate.py``. Usage:
    python -m deblurgs_tpu_torch.cli.triangulate -s <dataset> --result_path <out>
"""

from __future__ import annotations

import os
import shutil
import sys
from argparse import ArgumentParser

import numpy as np

from deblurgs_tpu_torch.cli.args import ModelParams
from deblurgs_tpu_torch.core.camera import fov2focal
from deblurgs_tpu_torch.data.colmap import rotmat2qvec
from deblurgs_tpu_torch.data.readers import load_scene_info
from deblurgs_tpu_torch.tools.colmap_pipeline import (
    do_system, triangulate_known_poses,
)


def triangulate(cam_infos, output_path: str) -> str:
    """Build ``<output_path>/{images, sparse/0}`` from known-pose cameras.

    Mirrors reference ``triangulation.py::triangulate``: copy the GT
    images, extract/match features, write fixed PINHOLE intrinsics +
    database-ordered extrinsics, triangulate, and export a TXT model copy.
    Returns the binary sparse dir.
    """
    images_dir = os.path.join(output_path, "images")
    shutil.rmtree(output_path, ignore_errors=True)
    os.makedirs(images_dir)

    pose_by_name = {}
    for cam in cam_infos:
        name = os.path.basename(cam.image_path)
        shutil.copyfile(cam.image_path, os.path.join(images_dir, name))
        # CameraInfo.R is the c2w rotation, .T the w2c translation — COLMAP
        # wants the w2c quaternion (reference triangulation.py:108-112)
        pose_by_name[name] = (rotmat2qvec(cam.R.T), cam.T)

    c0 = cam_infos[0]
    fx = fov2focal(c0.FovX, c0.width)
    fy = fov2focal(c0.FovY, c0.height)
    sparse_tmp, db = triangulate_known_poses(
        output_path, images_dir, pose_by_name, c0.width, c0.height, fx, fy)

    # move the result into the conventional sparse/0 + a TXT copy
    # (reference triangulation.py:124-147)
    sparse_out = os.path.join(output_path, "sparse", "0")
    shutil.rmtree(sparse_out, ignore_errors=True)
    os.replace(sparse_tmp, sparse_out)
    shutil.rmtree(os.path.join(output_path, "sparse", "1"),
                  ignore_errors=True)
    sparse_txt = os.path.join(output_path, "sparse_txt")
    os.makedirs(sparse_txt, exist_ok=True)
    do_system(f"colmap model_converter --input_path {sparse_out} "
              f"--output_path {sparse_txt} --output_type TXT")
    print("[DONE]")
    return sparse_out


def main(argv=None):
    parser = ArgumentParser(description="Triangulation script parameters")
    lp = ModelParams(parser)
    parser.add_argument("--result_path", type=str, required=True,
                        help="new colmap directory")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    lpe = lp.extract(args)

    info = load_scene_info(
        lpe.source_path, images=lpe.images, eval_split=lpe.eval,
        llffhold=lpe.llffhold, num_initial_pcd=lpe.num_initial_pcd,
        z_near=lpe.z_near, z_far=lpe.z_far,
        white_background=lpe.white_background,
    )
    return triangulate(list(info.train_cameras), args.result_path)


if __name__ == "__main__":
    main()
