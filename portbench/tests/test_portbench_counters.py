"""The readers of the program's counters, on counters set here."""

import pytest

from portbench import harness


@pytest.fixture
def program_counters(monkeypatch):
    from deblurgs_tpu_torch.utils import profiling

    store = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(store))
    return store


def test_staging_slot_use_reads_pairs_over_slots(program_counters):
    read = harness.reader("staging_slot_use.train").read
    assert read({}) is None
    program_counters.update({"staging.slots": 4 * 2 ** 27, "staging.pairs_emitted": 2 ** 27})
    assert read({}) == pytest.approx(25.0)


def test_staging_slot_use_reads_nothing_without_the_counters(monkeypatch):
    from deblurgs_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert harness.reader("staging_slot_use.train").read({}) is None
