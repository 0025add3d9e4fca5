"""CPU tests of the benchmark harness; tests that need a card carry the
``card`` marker and skip without one."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips on the CPU")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and the timed path run only there")
    return torch.device("cuda", 0)
