"""Tests of the benchmark harness. Those that need the card carry the
``card`` marker and take the ``card`` fixture, which skips where there is
no CUDA device; the decision is made when the test runs, never at import.

On the card: ``python -m pytest -q -m card h100bench/tests`` from the root
of a checkout."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (an H100); skips elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
