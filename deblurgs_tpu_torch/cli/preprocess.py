"""Dataset ingestion CLI — reference ``scripts/run_colmap.py``.

Counterpart of ``deblurgs_tpu/cli/preprocess.py``, with its flags::

    python -m deblurgs_tpu_torch.cli.preprocess (--video V | --images DIR)
        -o RESULT [--camera_model OPENCV] [--mask_path MASKS]

Video (or image folder) → frames → COLMAP feature/match/map/bundle-adjust
(+ undistortion for non-pinhole models) → a training-ready dataset layout.
Requires the ``colmap`` binary.
"""

from __future__ import annotations

import os
import shutil
import sys
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--video", type=str, default=None,
                        help="input video to decode into frames")
    parser.add_argument("--images", type=str, default=None,
                        help="existing image folder to copy in")
    parser.add_argument("--result_path", "-o", type=str, required=True)
    parser.add_argument("--downsample", type=int, default=1)
    parser.add_argument("--resize", type=float, default=1.0)
    parser.add_argument("--clip_start", type=float, default=0.0)
    parser.add_argument("--clip_end", type=float, default=1.0)
    parser.add_argument("--camera_model", type=str, default="OPENCV")
    parser.add_argument("--colmap_matcher", type=str, default="exhaustive",
                        choices=["exhaustive", "sequential", "spatial",
                                 "transitive", "vocab_tree"])
    parser.add_argument("--focal_length", type=float, default=None)
    parser.add_argument("--mask_path", type=str, default=None,
                        help="folder of per-image masks: black = keep for "
                             "COLMAP features (reference move_mask)")
    parser.add_argument("--reverse_mask", action="store_true",
                        help="invert the mask keep/ignore convention")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    from deblurgs_tpu_torch.tools import colmap_pipeline as cp

    images_dir = os.path.join(args.result_path, "images")
    os.makedirs(args.result_path, exist_ok=True)
    if args.video:
        n = cp.extract_video_frames(
            args.video, images_dir, downsample=args.downsample,
            clip=(args.clip_start, args.clip_end), resize=args.resize)
        print(f"extracted {n} frames")
    elif args.images:
        if os.path.abspath(args.images) != os.path.abspath(images_dir):
            shutil.copytree(args.images, images_dir, dirs_exist_ok=True)
    else:
        parser.error("one of --video / --images is required")

    if args.mask_path:
        cp.prepare_masks(args.result_path, args.mask_path,
                         reverse=args.reverse_mask)
        print("masks staged (masks/ + colmap_masks/)")

    cp.run_colmap(args.result_path, camera_model=args.camera_model,
                  matcher=args.colmap_matcher,
                  focal_length=args.focal_length)
    print(f"dataset ready at {args.result_path}")


if __name__ == "__main__":
    main()
