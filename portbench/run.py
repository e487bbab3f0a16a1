"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

``--trace 0`` measures the cell's end-to-end metrics over a window of S
seconds; ``--trace 1`` reads its per-layer metrics from a profiled run.
Both check the program's first training steps against the plain reference.
Needs a CUDA card; exits non-zero and prints no result without one.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # kernel caches at fixed paths inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
