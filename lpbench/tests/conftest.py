"""Tests of the benchmark harness.  Run from the repository root:

    python -m pytest lpbench/tests -q

Tests marked ``card`` need a CUDA card and skip without one (decided
inside the ``card`` fixture); on the card they run as

    python -m pytest lpbench/tests -q -m card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return "cuda"
