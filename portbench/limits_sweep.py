"""Readings that set ``portbench/limits.json``, at a cell's own size.

    python3 portbench/limits_sweep.py --workload NAME --seeds S1,S2,... \
        [--control-seeds ...] [--fault-seeds ...]

For every seed, one run of the cell with no measured window gives the sound
program's three numbers (the lower readings). On the control seeds the
reference in bfloat16 is put in the program's place and compared with the
float32 reference on the same steps; on the fault seeds each fault of
``portbench/faults.py`` that needs a run is planted in the program (the
upper readings). One JSON line a reading; needs the card.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import check, faults, harness, scene  # noqa: E402
from portbench.drivers import train_loop  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("limits_sweep: no CUDA card", file=sys.stderr)
        return 2
    w = harness.cell(harness.benchmark(), args.workload)
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    first, n = tr["start_iteration"], tr["check_steps"]

    def run(seed: int) -> dict:
        return train_loop.run(dict(cfg=cfg, traffic=tr, seed=seed, seconds=0.0, trace=0,
                                   device="cuda", t_start=time.perf_counter()))

    def emit(kind: str, seed: int, numbers: dict, **extra) -> None:
        print(json.dumps(dict(kind=kind, seed=seed, **{k: numbers[k] for k in check.NUMBERS},
                              parts=numbers["parts"], **extra)), flush=True)

    for seed in args.seeds:
        res = run(seed)
        emit("program", seed, res["numbers"], readings=res["readings"],
             reference_s=res["info"]["reference_s"])
        if seed in args.control_seeds:
            x = scene.make_inputs(cfg, seed, torch.device("cuda"))
            records = {first + k: rec for k, rec in enumerate(res["records"])}
            t0 = time.perf_counter()
            low = train_loop.reference_readings(cfg, x, first, records, n, dtype=torch.bfloat16)
            emit("control_bf16", seed, check.compare(low, res["readings"]["reference"]),
                 seconds=time.perf_counter() - t0)
            del x
        del res
        torch.cuda.empty_cache()
    for seed in args.fault_seeds:
        for name in ("half_the_batch", "answer_altered", "densify_skipped"):
            with faults.planted(name):
                emit(name, seed, run(seed)["numbers"])
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
