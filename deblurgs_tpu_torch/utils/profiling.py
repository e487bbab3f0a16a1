"""Tracing of the port: spans on the profiler's clock, counters, and a
trace's device time put down to its spans (counterpart of
``deblurgs_tpu/utils/profiling.py``).

- :func:`span` opens a range on ``torch.profiler``'s host timeline while a
  profiler records, and otherwise costs one check of the profiler's state.
  There is no switch: spans are on exactly when something profiles (an
  operator's :func:`trace`, a benchmark's traced run). The spans are the
  profiler's own events, so they share the trace's clock, and every
  kernel, copy, ``cudaMalloc`` and synchronise in a trace can be put down
  to the span whose interval holds the host call that issued it
  (:func:`put_down`, :func:`by_span`).
- :func:`count` adds to a counter of a plain dict of integers
  (:func:`counters`), always on: host-side adds of host values only. The
  kernel wrappers count their launches as ``kernel.K1`` … ``kernel.K6``;
  the staging counts the slots it sorts (``staging.slots``) and the
  training loop's drain the pairs the steps emitted
  (``staging.pairs_emitted``).
- :func:`trace` records a trace for TensorBoard or Perfetto.

A span is a function-scope range of the profiler (``_RecordFunctionFast``),
not a ``record_function`` user range: the profiler mirrors a user range
onto the device timeline, as an annotation over the kernels launched in
it, and a reader that takes every device-side event of a trace for device
work would count those annotations as busy time.
"""

from __future__ import annotations

import collections
import contextlib
import re
import threading

import numpy as np
import torch

# every span the port opens; one name's intervals never overlap
SPANS = (
    "train.autosize", "train.iteration", "train.select", "train.draws", "train.step",
    "train.drain", "drain.grow_capacity",
    "step.forward", "step.backward", "step.apply", "apply.densify", "apply.adam",
    "render.preprocess", "render.staging", "staging.compact", "staging.broadcast",
    "staging.sort", "render.composite", "render.compose",
    "blend.backward", "backward.composite", "backward.reduce",
)
# host runtime calls that wait for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
# where device work whose launch no span holds is put down
OUTSIDE = "(no span)"
# a CUDA runtime or driver call's name (cudaLaunchKernel, cuLaunchKernel)
_RUNTIME = re.compile(r"cu(da)?[A-Z]")

_NO_SPAN = contextlib.nullcontext()
_counts: collections.Counter = collections.Counter()
_counts_lock = threading.Lock()


def span(name: str):
    """A context manager: the profiler's range ``name`` while a profiler
    records, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer) to the counter ``name``."""
    with _counts_lock:
        _counts[name] += n


def counters() -> dict:
    """A copy of every counter."""
    with _counts_lock:
        return dict(_counts)


def reset_counters() -> None:
    with _counts_lock:
        _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body into ``log_dir`` (TensorBoard's profiler plugin or
    Perfetto read it); the spans are in it. Yields the profiler, whose
    events :func:`by_span` puts down to spans once the body has run."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _locate(spans, times):
    """For each host time: which span names hold it ([names, times] bool)
    and the innermost one's index (the shortest interval; -1 for none)."""
    names = sorted({name for name, _, _ in spans})
    t = np.asarray(times, dtype=np.float64)
    holds = np.zeros((len(names), t.size), dtype=bool)
    width = np.full((len(names), t.size), np.inf)
    for i, name in enumerate(names):
        iv = np.array(sorted((s, e) for n, s, e in spans if n == name), dtype=np.float64)
        k = np.maximum(np.searchsorted(iv[:, 0], t, side="right") - 1, 0)
        holds[i] = (t >= iv[k, 0]) & (t <= iv[k, 1])
        width[i] = np.where(holds[i], iv[k, 1] - iv[k, 0], np.inf)
    inner = np.where(holds.any(0), width.argmin(0) if names else -1, -1)
    return names, holds, inner


def put_down(spans, launches, device_ops, calls=()) -> dict:
    """Put a trace's device time and host calls down to spans.

    ``spans``: (name, start, end) host intervals of any thread;
    ``launches``: (correlation id, host time) of the runtime calls that
    issued device work; ``device_ops``: (correlation id, start, end) on the
    device; ``calls``: (name, host time) of host runtime calls to count.
    Times share one clock (the trace's µs). A device operation belongs to
    its launch's innermost span, whatever thread launched it (autograd
    runs the backward on a thread of its own), and counts toward the total
    of every span name that holds the launch.

    Returns ``{"device_us": {span: [total, self]}, "calls": {span: {name:
    n}}}``; work and calls that no span holds go under :data:`OUTSIDE`.
    """
    launched = dict(launches)
    times = [launched.get(corr, np.nan) for corr, _, _ in device_ops]
    dur = np.array([e - s for _, s, e in device_ops], dtype=np.float64)
    names, holds, inner = _locate(spans, times)
    device = {name: [float(dur[holds[i]].sum()), float(dur[inner == i].sum())]
              for i, name in enumerate(names)}
    rest = float(dur[inner < 0].sum())
    if rest:
        device[OUTSIDE] = [rest, rest]
    cnames, _, cinner = _locate(spans, [t for _, t in calls])
    out: dict = {}
    for (call, _), i in zip(calls, cinner):
        where = out.setdefault(cnames[i] if i >= 0 else OUTSIDE, {})
        where[call] = where.get(call, 0) + 1
    return {"device_us": device, "calls": out}


def trace_events(prof) -> tuple:
    """(spans, launches, device_ops, calls) of a finished
    ``torch.profiler.profile`` for :func:`put_down`: the ranges of
    :data:`SPANS`, the CUDA runtime and driver calls, and the device's
    kernels, copies and memsets. The profiler's mirrors of user ranges on
    the device timeline, which carry a host range's name, are left out."""
    events = prof.profiler.kineto_results.events()
    on_device = [e.device_type() == torch.autograd.DeviceType.CUDA for e in events]
    host_names = {e.name() for e, d in zip(events, on_device) if not d}
    spans, launches, device_ops, calls = [], [], [], []
    for e, d in zip(events, on_device):
        name, t0 = e.name(), e.start_ns() / 1e3
        t1 = t0 + e.duration_ns() / 1e3
        if d:
            if name not in host_names:
                device_ops.append((e.correlation_id(), t0, t1))
        elif _RUNTIME.match(name):
            launches.append((e.correlation_id(), t0))
            calls.append((name, t0))
        elif name in SPANS:
            spans.append((name, t0, t1))
    return spans, launches, device_ops, calls


def by_span(prof) -> dict:
    """:func:`put_down` of a finished profiler's trace."""
    return put_down(*trace_events(prof))
