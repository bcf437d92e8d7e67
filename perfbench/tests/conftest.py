"""Tests of the benchmark itself: the CPU ones run anywhere; those marked
``card`` skip without a CUDA card (decided inside the ``card`` fixture)
and are run on the card by the command in ``perfbench/README.md``."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
