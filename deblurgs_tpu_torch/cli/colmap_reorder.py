"""Rewrite a COLMAP ``images.txt`` in database image-id order.

Standalone equivalent of reference ``utils/colmap_reoder.py``: aligns the
text-model row order with the feature database so downstream tools that
index by database order see consistent ids. The original file is kept as
``images_sorted.txt``. Counterpart of ``deblurgs_tpu/cli/colmap_reorder.py``::

    python -m deblurgs_tpu_torch.cli.colmap_reorder --datadir DIR
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--datadir", type=str, required=True)
    parser.add_argument("--database_filename", type=str,
                        default="database.db")
    parser.add_argument("--sparse_dirname", type=str, default="sparse_txt",
                        help="directory under datadir holding images.txt")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    from deblurgs_tpu_torch.tools.colmap_pipeline import reorder_images_txt

    out = reorder_images_txt(args.datadir, args.database_filename,
                             args.sparse_dirname)
    print(f"rewrote {out} in database order")


if __name__ == "__main__":
    main()
