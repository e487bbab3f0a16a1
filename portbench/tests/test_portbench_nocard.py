"""Without a card the benchmark fails and prints no result."""

import subprocess
import sys

import pytest

from portbench import harness


def test_run_fails_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "train-field1080",
                          "--seed", "4294967301", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_harness_refuses_the_cpu(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = type("A", (), dict(workload=harness.benchmark()["workloads"][0]["name"], seed=1,
                              seconds=1.0, trace=0))
    assert harness.main(args, 0.0) != 0
    assert '"correct"' not in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in harness.benchmark()["workloads"]])
def test_cell_runs_on_the_card(cuda_device, workload):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", "4294967301", "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
