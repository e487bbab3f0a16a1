"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests marked ``cuda`` need a CUDA card and skip without one; the card is
looked for inside the ``cuda_device`` fixture, never at import.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips on a host without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")
