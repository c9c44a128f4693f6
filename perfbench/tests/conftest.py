"""Tests of the benchmark. CPU tests run anywhere; tests marked `card`
need an NVIDIA card and skip without one (decided in the `card` fixture,
never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.get_device_name(0)
