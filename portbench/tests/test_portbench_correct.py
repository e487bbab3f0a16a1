"""``correct`` at a size a test run holds, on the CPU (the kernels' plain
versions): a sound run passes every limit; the control (the reference in
bfloat16 in the program's place) and each fault planted in the program
underneath the loop fail one of them at least."""

import ast
import copy
import inspect
import time

import pytest
import torch

from portbench import check, faults, harness, scene
from portbench.drivers import train_loop

WORKLOAD = "train-field1080"


def tiny_config() -> dict:
    cfg = copy.deepcopy(harness.config(harness.cell(harness.benchmark(), WORKLOAD)["config"]))
    cfg["scene"].update(width=48, height=32, points=300, views=6, llffhold=3, cloud_sigma=1.0)
    cfg["cli"].update(num_subframes=4, curve_order=3, tile=16)
    return cfg


def run_tiny(seed: int = 5) -> dict:
    tr = harness.traffic(harness.cell(harness.benchmark(), WORKLOAD)["traffic"])
    return train_loop.run(dict(cfg=tiny_config(), traffic=tr, seed=seed, seconds=0.0, trace=0,
                               device="cpu", t_start=time.perf_counter()))


def correct(numbers: dict) -> bool:
    return check.verdict(numbers, check.load_limits())[0]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sound_run_is_correct():
    res = run_tiny()
    assert correct(res["numbers"]), res["numbers"]
    assert res["attempted"] == 10 and res["failed"] == 0


def test_control_in_bfloat16_is_not_correct():
    cfg, tr = tiny_config(), harness.traffic("train_loop")
    res = run_tiny()
    x = scene.make_inputs(cfg, 5, torch.device("cpu"))
    first, n = tr["start_iteration"], tr["check_steps"]
    ref = res["readings"]["reference"]
    records = {first + k: rec for k, rec in enumerate(res["records"])}
    low = train_loop.reference_readings(cfg, x, first, records, n, dtype=torch.bfloat16)
    assert not correct(check.compare(low, ref))


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault):
    with faults.planted(fault):
        assert not correct(run_tiny()["numbers"])


def test_scene_sets_what_the_constructor_sets():
    """The benchmark assembles the program's ``Scene`` from images in
    memory; ``Scene.__init__`` (which reads a dataset from disk) sets no
    attribute that it leaves out."""
    from deblurgs_tpu_torch.data.scene import Scene

    tree = ast.parse(inspect.getsource(Scene.__init__).lstrip())
    assigned = {t.attr for node in ast.walk(tree) if isinstance(node, (ast.Assign, ast.AnnAssign))
                for t in (node.targets if isinstance(node, ast.Assign) else [node.target])
                for t in (t.elts if isinstance(t, ast.Tuple) else [t])
                if isinstance(t, ast.Attribute) and getattr(t.value, "id", None) == "self"}
    cfg = tiny_config()
    scn = scene.program_scene(cfg, scene.make_inputs(cfg, 5, torch.device("cpu")), 5)
    assert assigned and assigned <= set(vars(scn))
