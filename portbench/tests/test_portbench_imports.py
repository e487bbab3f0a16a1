"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import importlib
import os
import sys
import types

import pytest

from portbench import check, harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.PKG) for f in fs
               if f.endswith(".py"))


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "deblurgs_tpu"}


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.basename(p))
def test_reference_imports_nothing_of_the_program(path):
    assert "deblurgs_tpu_torch" not in top_level_imports(path)


def test_names_are_compared_whole():
    assert harness.banned_modules(["deblurgs_tpu_torch.ops.knn", "jaxtyping", "numpy"]) == []
    assert harness.banned_modules(["jax.numpy", "deblurgs_tpu.ops", "flax"]) == [
        "deblurgs_tpu", "flax", "jax"]


@pytest.mark.parametrize("loads_jax", [False, True], ids=["clean", "reader_imports_jax"])
def test_harness_looks_for_jax_last(monkeypatch, tmp_path, capsys, loads_jax):
    """A traced run whose metric reader imports a module named ``jax``
    prints no result, though the driver's run was clean."""
    import torch

    for name in [n for n in sys.modules if n.split(".")[0] in harness.BANNED]:
        monkeypatch.delitem(sys.modules, name)
    (tmp_path / "jax.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stub")
    monkeypatch.setattr(harness, "power_limit", lambda: None)
    seg = {"device_ops": [("k", 0.0, 5.0)], "host_ops": [], "window_us": (0.0, 10.0),
           "wall_s": 1e-5, "busy_s": 5e-6, "window_s": 1e-5, "merged": [(0.0, 5.0)]}
    res = dict(numbers=dict({k: 0.0 for k in check.NUMBERS}, parts={}),
               readings={"program": {}, "reference": {}}, info={}, peak_bytes=1,
               attempted=1, failed=0,
               trace=dict(seg=seg, iterations=1, syncs=0, sync_iterations=1,
                          counts={"evaluations": 0}))
    monkeypatch.setattr(harness, "driver", lambda name: types.SimpleNamespace(run=lambda c: res))

    def read(t):
        if loads_jax:
            importlib.import_module("jax")
        return 1.0

    monkeypatch.setattr(harness, "reader", lambda name: types.SimpleNamespace(read=read))
    args = types.SimpleNamespace(workload=harness.benchmark()["workloads"][0]["name"], seed=1,
                                 seconds=1.0, trace=1)
    try:
        rc = harness.main(args, 0.0)
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert (rc != 0) is loads_jax
    assert ('"correct"' in out.out) is not loads_jax
    assert ("jax" in out.err) is loads_jax
