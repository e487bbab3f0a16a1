"""The port's tracing (``utils/profiling.py``): the spans of a training
iteration and their nesting under ``torch.profiler``, none without one, the
counters (the staging's slots and emitted pairs, under threads), the wall
time ``time.txt`` holds, and device work and host calls put down to spans
on synthetic events.

Scene: ``tests/test_data.py``'s synthetic COLMAP scene (3 cameras, 40
points, 64×48), 3 sub-frames batched on the pallas path's plain versions,
a densify event and a capacity growth in two iterations.
"""

import dataclasses
import os
import sys
import threading
import time
from argparse import ArgumentParser

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deblurgs_tpu_torch.cli import args as targs
from deblurgs_tpu_torch.cli import train as tcli
from deblurgs_tpu_torch.data.scene import Scene
from deblurgs_tpu_torch.ops import cuda_blend, tile_blend
from deblurgs_tpu_torch.train import loop
from deblurgs_tpu_torch.utils import profiling
from tests.test_data import write_colmap_binary, write_images

# each span a training run opens, and the spans it may nest in
NESTING = {
    "train.autosize": (), "train.iteration": (),
    "train.select": ("train.iteration",), "train.draws": ("train.iteration",),
    "train.step": ("train.iteration",), "train.drain": ("train.iteration",),
    "drain.grow_capacity": ("train.drain",),
    "step.forward": ("train.step",), "step.backward": ("train.step",),
    "step.apply": ("train.step",), "apply.densify": ("step.apply",),
    "apply.adam": ("step.apply",),
    "render.preprocess": ("step.forward", "train.autosize"),
    "render.staging": ("step.forward",), "staging.compact": ("render.staging",),
    "staging.broadcast": ("render.staging",), "staging.sort": ("render.staging",),
    "render.composite": ("step.forward",), "render.compose": ("step.forward",),
    "blend.backward": ("step.backward",), "backward.composite": ("blend.backward",),
    "backward.reduce": ("blend.backward",),
}


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("profiling") / "scene")
    write_colmap_binary(os.path.join(root, "sparse", "0"), n_cams=3, n_pts=40)
    write_images(os.path.join(root, "images"), [f"{i:03d}.png" for i in range(3)], w=64, h=48)
    return root


def _trainer(source, **kw):
    """A trainer whose iteration 2 densifies and whose first drain grows
    the capacity (40 points in 44 slots), with the pair budget autosized,
    and its state at iteration 2."""
    parser = ArgumentParser()
    lp, op = targs.ModelParams(parser), targs.OptimizationParams(parser)
    ns = parser.parse_args(["-s", "scene", "-m", "model", "--num_subframes", "3",
                            "--curve_order", "2"])
    g, m, o, r = tcli.build_configs(lp.extract(ns), op.extract(ns))
    o = dataclasses.replace(o, curve_start_iter=1, densify_from_iter=1, densification_interval=2)
    trainer = loop.Trainer(scene=Scene(source, None, resolution=1), gcfg=g, mcfg=m, ocfg=o,
                           rcfg=r, tone_mapping="identity", device="cpu", batched_render=True,
                           sync_every=2, **kw)
    state, _ = trainer.init_state(capacity=44)
    return trainer, state._replace(step=2)


def test_spans_nest_in_a_training_iteration(source):
    trainer, state = _trainer(source)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train(state, 2, 3)
    spans = profiling.trace_events(prof)[0]
    assert {name for name, _, _ in spans} == set(NESTING) <= set(profiling.SPANS)
    assert [name for name, _, _ in spans].count("train.iteration") == 2
    assert [name for name, _, _ in spans].count("train.autosize") == 1
    for name, s, e in spans:
        if NESTING[name]:
            assert any(n in NESTING[name] and s0 <= s and e <= e0 for n, s0, e0 in spans), name


def test_spans_open_only_under_a_profiler(source, monkeypatch):
    """Without a profiler no span opens a profiler range; the counters
    still count the slots sorted and the pairs drained."""
    opened = []
    real = torch._C._profiler._RecordFunctionFast

    def recording(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", recording)
    pairs = []
    trainer, state = _trainer(source, on_metrics=lambda it, m: pairs.append(int(m.num_pairs)))
    before = profiling.counters()
    state = trainer.train(state, 2, 3)
    after = profiling.counters()
    assert opened == []
    assert after["staging.pairs_emitted"] - before.get("staging.pairs_emitted", 0) == sum(pairs)
    assert after["staging.slots"] - before.get("staging.slots", 0) == 2 * trainer.rcfg.max_pairs
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train(state, 4, 4)
    assert "train.iteration" in opened and "staging.sort" in opened


def test_sort_stage_counts_its_slots():
    """``staging.slots`` adds the length of the slot arrays each
    ``sort_stage`` call sorts, whatever the pairs emitted."""
    cfg = tile_blend.BlendConfig(width=32, height=32, tile_w=16, tile_h=16, max_pairs=96,
                                 need_n_contrib=False)
    gen = torch.Generator().manual_seed(0)
    P = 6
    means2d = torch.rand((P, 2), generator=gen) * 32
    conic = torch.tensor([[0.1, 0.0, 0.1]]).repeat(P, 1)
    rect = torch.tensor([[0, 0, 2, 2]], dtype=torch.int32).repeat(P, 1)
    area = torch.full((P,), 4, dtype=torch.int32)
    args = (means2d, conic, torch.full((P,), 0.5), torch.rand((P, 3), generator=gen),
            torch.rand(P, generator=gen) + 1, rect, area)
    before = profiling.counters().get("staging.slots", 0)
    for max_pairs in (96, 40):
        cuda_blend.sort_stage(cfg, *args, max_pairs)
    assert profiling.counters()["staging.slots"] - before == 96 + 40


def test_counters_add_up_under_threads():
    """Adds from more threads than cores, switching often, lose none."""
    n_threads, n_adds = 2 * (os.cpu_count() or 4), 2000
    before = profiling.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [profiling.count("test.threads", 3)
                                                    for _ in range(n_adds)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters()["test.threads"] - before == 3 * n_threads * n_adds


def test_time_txt_holds_the_wall_of_train(source, tmp_path):
    trainer, state = _trainer(source, model_path=str(tmp_path), save_iterations=())
    t0 = time.perf_counter()
    trainer.train(state, 2, 3)
    wall = time.perf_counter() - t0
    assert 0.5 * wall < trainer.training_time_sec <= wall
    with open(tmp_path / "time.txt") as f:
        lines = f.read().splitlines()
    assert lines == [f"Training Time = {trainer.training_time_sec:7.5f}sec",
                     "Overflowed iterations = 0"]


def test_put_down_takes_the_innermost_span():
    """Each device operation goes to the innermost span holding its
    launch and to the total of every span holding it; an operation whose
    launch no span holds, or that has no launch, goes outside."""
    spans = [("train.step", 0.0, 100.0), ("step.forward", 10.0, 50.0),
             ("render.staging", 20.0, 30.0), ("step.apply", 60.0, 90.0)]
    launches = [(1, 5.0), (2, 15.0), (3, 25.0), (4, 70.0), (5, 150.0)]
    ops = [(1, 200.0, 201.0), (2, 201.0, 203.0), (3, 203.0, 207.0), (4, 207.0, 215.0),
           (5, 215.0, 231.0), (6, 231.0, 263.0)]
    got = profiling.put_down(spans, launches, ops)["device_us"]
    assert got == {"train.step": [15.0, 1.0], "step.forward": [6.0, 2.0],
                   "render.staging": [4.0, 4.0], "step.apply": [8.0, 8.0],
                   profiling.OUTSIDE: [48.0, 48.0]}


def test_put_down_a_launch_from_another_thread():
    """Autograd launches the backward's kernels from a thread of its own:
    a launch inside the first thread's ``step.backward`` belongs to it, and
    to ``blend.backward`` while that span, opened on the second thread, is
    open."""
    spans = [("step.backward", 0.0, 100.0),          # the caller's thread
             ("blend.backward", 20.0, 40.0),         # autograd's thread
             ("backward.composite", 25.0, 30.0)]
    launches = [(7, 10.0), (8, 27.0), (9, 35.0), (10, 60.0)]
    ops = [(7, 300.0, 301.0), (8, 301.0, 311.0), (9, 311.0, 313.0), (10, 313.0, 317.0)]
    got = profiling.put_down(spans, launches, ops)["device_us"]
    assert got == {"step.backward": [17.0, 5.0], "blend.backward": [12.0, 2.0],
                   "backward.composite": [10.0, 10.0]}


def test_put_down_counts_calls_by_span():
    spans = [("train.iteration", 0.0, 100.0), ("train.drain", 80.0, 95.0)]
    calls = [("cudaStreamSynchronize", 50.0), ("cudaStreamSynchronize", 90.0),
             ("cudaMalloc", 85.0), ("cudaStreamSynchronize", 120.0)]
    got = profiling.put_down(spans, [], [], calls)["calls"]
    assert got == {"train.iteration": {"cudaStreamSynchronize": 1},
                   "train.drain": {"cudaStreamSynchronize": 1, "cudaMalloc": 1},
                   profiling.OUTSIDE: {"cudaStreamSynchronize": 1}}


class _Event:
    """A profiler event as ``trace_events`` reads it."""

    def __init__(self, name, device, corr, start_us, dur_us):
        self._v = (name, device, corr, start_us, dur_us)

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return int(self._v[3] * 1e3)

    def duration_ns(self):
        return int(self._v[4] * 1e3)


def test_trace_events_sorts_a_trace():
    """Spans by name, runtime and driver calls by name, device work by
    device; a user range's mirror on the device and the host's other
    operations are left out."""
    events = [_Event("portbench.window", False, 1, 0, 500),
              _Event("train.step", False, 2, 10, 100),
              _Event("aten::add", False, 3, 20, 5),
              _Event("cudaLaunchKernel", False, 40, 22, 2),
              _Event("cuLaunchKernel", False, 41, 30, 2),
              _Event("cudaStreamSynchronize", False, 42, 40, 9),
              _Event("forward_mixed_kernel", True, 40, 50, 7),
              _Event("Memcpy DtoD (Device -> Device)", True, 41, 57, 3),
              _Event("portbench.window", True, 1, 50, 10)]
    prof = type("P", (), {"profiler": type("K", (), {"kineto_results": type(
        "R", (), {"events": staticmethod(lambda: events)})})})
    spans, launches, ops, calls = profiling.trace_events(prof)
    assert spans == [("train.step", 10.0, 110.0)]
    assert launches == [(40, 22.0), (41, 30.0), (42, 40.0)]
    assert ops == [(40, 50.0, 57.0), (41, 57.0, 60.0)]
    assert [c for c, _ in calls] == ["cudaLaunchKernel", "cuLaunchKernel",
                                     "cudaStreamSynchronize"]
    assert profiling.by_span(prof)["device_us"] == {"train.step": [10.0, 10.0]}
