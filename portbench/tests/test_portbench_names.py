"""Every name in BENCHMARK.json resolves to the benchmark's files."""

import json
import os

import pytest

from portbench import harness

BENCH = harness.benchmark()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches(cfg):
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    data = harness.config(cfg["name"])
    assert data["name"] == cfg["name"]
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    assert any(c["name"] == w["config"] for c in BENCH["configs"])
    tr = harness.traffic(w["traffic"])
    mod = harness.driver(tr["driver"])
    assert callable(mod.run)
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(m):
    assert callable(harness.reader(m["name"]).read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in m.get("workloads", []):
        harness.cell(BENCH, w)


def test_end_to_end_metrics_are_produced():
    names = {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in names
    assert names <= {"iter_ms", "peak_gb", "setup_s"}


def test_paths_hold_the_benchmark():
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    assert BENCH["command"][1] == "portbench/run.py"
    assert len(json.dumps(BENCH)) < 64 * 1024
