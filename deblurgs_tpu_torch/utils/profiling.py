"""Profiling / tracing hooks (counterpart of ``deblurgs_tpu/utils/profiling.py``;
the reference has only the wall-clock accumulation into ``time.txt``).

``trace`` records a ``torch.profiler`` trace (host operators and, on a
card, its kernels) for TensorBoard; ``StepTimer`` keeps rolling per-step
wall-clock statistics as JSON lines.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace into ``log_dir`` (viewable in
    TensorBoard's profiler plugin or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Rolling per-step wall-clock stats, periodically flushed as JSON lines.

    A superset of the reference's ``time.txt`` accumulation
    (``train.py:106,211-212,227-228``).
    """

    def __init__(self, path: str | None = None, flush_every: int = 500):
        self.path = path
        self.flush_every = flush_every
        self.total = 0.0
        self.count = 0
        self._t0 = None
        self._window: list[float] = []

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.time() - self._t0
        self.total += dt
        self.count += 1
        self._window.append(dt)
        if self.path and self.count % self.flush_every == 0:
            self.flush()

    def flush(self):
        if not self.path:
            return
        import numpy as np

        w = np.array(self._window) if self._window else np.zeros(1)
        rec = {
            "step": self.count,
            "total_sec": round(self.total, 3),
            "mean_ms": round(float(w.mean()) * 1000, 3),
            "p50_ms": round(float(np.percentile(w, 50)) * 1000, 3),
            "p95_ms": round(float(np.percentile(w, 95)) * 1000, 3),
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._window.clear()

    def write_time_txt(self, model_path: str):
        with open(os.path.join(model_path, "time.txt"), "w") as fp:
            print(f"Training Time = {self.total:7.5f}sec", file=fp)
