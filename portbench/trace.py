"""The traced run's readings: a profiled segment of whole drain chunks and a
second segment with its host syncs counted.

``profile_segment`` runs a callable under ``torch.profiler`` inside a
``portbench.window`` range and returns every device operation and host
operation of that range with its interval (µs on the trace's clock).
``breakdown`` turns them into the contract's ``breakdown``: the device
operations that took most time, and the device's idle time by the host
operation running in the middle of each gap.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from portbench.counts import formulas

WINDOW = "portbench.window"
# host ranges of the profiler's own bookkeeping, not of the program
PROFILER_OWN = ("Activity Buffer Request",)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_segment(fn, dev) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            wall = time.perf_counter() - t0
    device, host, window = [], [], None
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.name == WINDOW:
            # the range shows on the device's timeline too, as an annotation
            if e.device_type != DeviceType.CUDA:
                window = span[1:]
        elif e.device_type == DeviceType.CUDA:
            device.append(span)
        elif e.name not in PROFILER_OWN:
            host.append(span)
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    busy_us, merged = formulas.busy_union([(s, e) for _, s, e in device], *window)
    return {"device_ops": device, "host_ops": host, "window_us": window, "wall_s": wall,
            "busy_s": busy_us / 1e6, "window_s": (window[1] - window[0]) / 1e6,
            "merged": merged}


def count_syncs(fn, dev) -> int:
    """Host syncs of ``fn`` under the CUDA sync debug mode (none are
    counted off the card)."""
    if dev.type != "cuda":
        fn()
        return 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return formulas.sync_count(caught)


def breakdown(seg: dict, top: int = 10, labelled_gaps: int = 2000) -> dict:
    by_name: dict = {}
    for name, s, e in seg["device_ops"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = seg["window_us"]
    edges = [lo] + [x for iv in seg["merged"] for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = seg["host_ops"]
    hs = np.array([s for _, s, _ in host])
    he = np.array([e for _, _, e in host])
    idle: dict = {}
    for a, b in gaps[:labelled_gaps]:
        mid = 0.5 * (a + b)
        inside = np.nonzero((hs <= mid) & (he >= mid))[0] if len(host) else []
        label = (min((host[i] for i in inside), key=lambda h: h[2] - h[1])[0]
                 if len(inside) else "host between operations")
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    rest = sum(b - a for a, b in gaps[labelled_gaps:]) / 1e6
    if rest:
        idle["shorter gaps"] = rest
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in device_ops],
            "idle_gaps": [[n[:120], s] for n, s in idle_gaps]}
