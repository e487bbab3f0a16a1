"""The trained scene's cell (``train-field1080-late``) at a size a test run
holds, on the CPU: its modules import without a card, its readers read the
program's counters, a sound run in two sub-frame groups is correct, and
the dropped group and the bfloat16 control are not."""

import copy
import time

import pytest
import torch

from portbench import check, faults_late, harness, scene
from portbench.drivers import train_late
from portbench.reference import late

WORKLOAD = "train-field1080-late"
SEED = 4294967311


def tiny_config() -> dict:
    cfg = copy.deepcopy(harness.config(harness.cell(harness.benchmark(), WORKLOAD)["config"]))
    cfg["scene"].update(width=48, height=32, points=300, gaussians=1000, views=6, llffhold=3,
                        cloud_sigma=1.0)
    cfg["cli"].update(num_subframes=5, curve_order=3, tile=16)
    return cfg


@pytest.fixture(scope="module")
def two_groups():
    """The planner splits the tiny scene's five sub-frames in two groups
    of 2^14 slots (its budget at full size is the card's ceiling)."""
    from deblurgs_tpu_torch.train import loop

    real, n = loop.plan_groups, torch.get_num_threads()
    loop.plan_groups = lambda *args, **kwargs: (1 << 14, 2)
    torch.set_num_threads(2)
    yield
    loop.plan_groups = real
    torch.set_num_threads(n)


def run_tiny() -> dict:
    tr = harness.traffic(harness.cell(harness.benchmark(), WORKLOAD)["traffic"])
    return train_late.run(dict(cfg=tiny_config(), traffic=tr, seed=SEED, seconds=0.0, trace=0,
                               device="cpu", t_start=time.perf_counter()))


@pytest.fixture(scope="module")
def sound(two_groups):
    return run_tiny()


def correct(numbers: dict) -> bool:
    return check.verdict(numbers, check.load_limits())[0]


def test_modules_import_without_a_card():
    assert callable(train_late.run) and callable(late.ReferenceTrainer.loss_and_grads)
    assert callable(faults_late.main) and set(faults_late.FAULTS) == {"group_dropped"}


@pytest.fixture
def program_counters(monkeypatch):
    from deblurgs_tpu_torch.utils import profiling

    store = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(store))
    return store


def test_readers_of_the_program_counters(program_counters):
    groups = harness.reader("subframe_groups.late").read
    share = harness.reader("recompute_share.late").read
    slots = harness.reader("staging_slot_use.late").read
    assert groups({}) is share({}) is slots({}) is None
    program_counters.update({"step.calls": 20, "step.subframe_groups": 60,
                             "staging.slots": 120 * 2 ** 27,
                             "staging.pairs_emitted": 60 * 2 ** 27,
                             "staging.pairs_recomputed": 30 * 2 ** 27})
    assert groups({}) == pytest.approx(3.0)
    assert share({}) == pytest.approx(50.0)
    assert slots({}) == pytest.approx(50.0)


def test_sound_run_in_groups_is_correct(sound):
    assert correct(sound["numbers"]), sound["numbers"]
    info = sound["info"]
    assert info["subframe_groups"] == 2 and info["capacity"] == [2048, 2048]
    assert sound["attempted"] == 10 and sound["failed"] == 0
    assert info["pairs_first_step"]["staged"] == 2 * info["pairs_first_step"]["recomputed"]


def test_dropped_group_is_not_correct(two_groups):
    with faults_late.planted("group_dropped"):
        numbers = run_tiny()["numbers"]
    assert not correct(numbers), numbers


def test_control_in_bfloat16_is_not_correct(sound):
    cfg, tr = tiny_config(), harness.traffic("train_loop_late")
    first, n = tr["start_iteration"], tr["check_steps"]
    x = scene.make_inputs(cfg, SEED, torch.device("cpu"))
    cols = train_late.trained_columns(cfg, x, SEED)
    records = {first + k: rec for k, rec in enumerate(sound["records"])}
    low = train_late.reference_readings(cfg, x, cols, first, records, n, dtype=torch.bfloat16)
    assert not correct(check.compare(low, sound["readings"]["reference"]))
