"""One run of one cell: what ``BENCHMARK.json`` names, found by name.

- the cell: ``BENCHMARK.json``'s ``workloads`` entry (config, traffic, chips);
- its configuration: ``portbench/configs/<config>.json``;
- its traffic: ``portbench/traffic/<traffic>.json``, whose ``driver`` names
  ``portbench/drivers/<driver>.py``;
- each per-layer metric: ``portbench/metrics/<name>.py``, whose
  ``read(t)`` takes the traced run's readings and returns the number or
  None (nothing to read: the metric is left out of the line).

The result is the last line of standard output; the numbers compared for
``correct`` close standard error.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
BANNED = ("jax", "jaxlib", "flax", "deblurgs_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(name: str) -> dict:
    return load_json(PKG, "configs", f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(PKG, "traffic", f"{name}.json")


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(name: str):
    """The per-layer metric ``name``'s reader module (file names keep the
    metric's dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  os.path.join(PKG, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def banned_modules(modules=None) -> list:
    """Top-level names of ``modules`` (default: ``sys.modules``) that are
    JAX's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & set(BANNED))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def per_layer_input(res: dict) -> dict:
    tr = res["trace"]
    seg = tr["seg"]
    return dict(iterations=tr["iterations"], wall_s=seg["wall_s"], busy_s=seg["busy_s"],
                window_s=seg["window_s"], device_ops=seg["device_ops"], syncs=tr["syncs"],
                sync_iterations=tr["sync_iterations"], counts=tr["counts"],
                peaks=load_json(PKG, "peaks.json"), kernels=load_json(PKG, "kernels.json"))


def main(args, t_start: float) -> int:
    bench = benchmark()
    w = cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"portbench: {w['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    from portbench import check

    cfg, tr = config(w["config"]), traffic(w["traffic"])
    res = driver(tr["driver"]).run(dict(cfg=cfg, traffic=tr, seed=args.seed,
                                        seconds=args.seconds, trace=args.trace,
                                        device="cuda", t_start=t_start))
    correct, checks = check.verdict(res["numbers"], check.load_limits())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": w["chips"],
              "memory_peak_bytes": res["peak_bytes"]}
    if args.trace:
        t = per_layer_input(res)
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, args.workload):
                value = reader(m["name"]).read(t)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
    else:
        win = res["window"]
        values = {"iter_ms": win["wall_s"] / win["iterations"] * 1e3,
                  "peak_gb": res["peak_bytes"] / 1e9, "setup_s": win["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, args.workload)}
    readings = {side: dict(r, densify=check.summary(r.get("densify")))
                for side, r in res["readings"].items()}
    info = dict(res["info"], power=power_limit(), readings=readings,
                parts=res["numbers"]["parts"])
    if not args.trace:
        info["chunk_ends_s"] = res["window"]["chunk_ends_s"]
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if args.trace:
        from portbench import trace

        info["counts"] = res["trace"]["counts"]
        line["breakdown"] = trace.breakdown(res["trace"]["seg"])
    line["checks"] = checks
    # last, once everything that runs in this process has run
    bad = banned_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps({"info": info}), flush=True)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
