"""A fault of the trained scene's cell, planted in the program underneath
the loop, for the check that ``correct`` catches it, and the readings that
set it beside the sound program and the bfloat16 control on the card:

    python3 portbench/faults_late.py --seeds S1,S2,... [--control-seeds ...] \
        [--fault-seeds ...]

``group_dropped``: the first sub-frame group of every step sends no
gradient back (its images and depths cut from autograd): the loss is the
sound one, the gradients miss that group's share. For every seed, one run
of ``train-field1080-late`` with no measured window gives the sound
program's numbers; on the control seeds the reference in bfloat16 is put in
the program's place and compared with the float32 reference on the same
steps; on the fault seeds the run is made again with the fault planted.
One JSON line a reading; needs the card.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import check, harness, scene  # noqa: E402
from portbench.drivers import train_late  # noqa: E402

WORKLOAD = "train-field1080-late"


def _first_group_dropped(real):
    def render(lo, hi, *args, **kwargs):
        images, depths, *rest = real(lo, hi, *args, **kwargs)
        if lo == 0:
            images, depths = images.detach(), depths.detach()
        return (images, depths, *rest)
    return render


FAULTS = {
    "group_dropped": ("deblurgs_tpu_torch.train.step", "_render_group", _first_group_dropped),
}


@contextlib.contextmanager
def planted(name: str):
    module, attr, wrap = FAULTS[name]
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, wrap(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("faults_late: no CUDA card", file=sys.stderr)
        return 2
    w = harness.cell(harness.benchmark(), WORKLOAD)
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    first, n = tr["start_iteration"], tr["check_steps"]

    def run(seed: int) -> dict:
        return train_late.run(dict(cfg=cfg, traffic=tr, seed=seed, seconds=0.0, trace=0,
                                   device="cuda", t_start=time.perf_counter()))

    def emit(kind: str, seed: int, numbers: dict, **extra) -> None:
        print(json.dumps(dict(kind=kind, seed=seed, **{k: numbers[k] for k in check.NUMBERS},
                              correct=check.verdict(numbers, check.load_limits())[0],
                              parts=numbers["parts"], **extra)), flush=True)

    for seed in args.seeds:
        res = run(seed)
        emit("program", seed, res["numbers"], readings=res["readings"], info=res["info"])
        if seed in args.control_seeds:
            x = scene.make_inputs(cfg, seed, torch.device("cuda"))
            cols = train_late.trained_columns(cfg, x, seed)
            records = {first + k: rec for k, rec in enumerate(res["records"])}
            t0 = time.perf_counter()
            low = train_late.reference_readings(cfg, x, cols, first, records, n,
                                                dtype=torch.bfloat16)
            emit("control_bf16", seed, check.compare(low, res["readings"]["reference"]),
                 seconds=time.perf_counter() - t0)
            del x, cols
        del res
        torch.cuda.empty_cache()
    for seed in args.fault_seeds:
        for name in FAULTS:
            with planted(name):
                emit(name, seed, run(seed)["numbers"])
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
