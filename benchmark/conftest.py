"""pytest settings of the benchmark's own tests (``pytest
benchmark/tests``): the repository's root on the path, and the ``card``
marker of the tests that need a CUDA device, which skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device and skips without one; run "
        "on the card with `pytest benchmark/tests`")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
