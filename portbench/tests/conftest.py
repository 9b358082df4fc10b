"""Tests of the benchmark itself: ``python3 -m pytest portbench/tests -q``
from the root of the checkout. Tests marked ``card`` need a CUDA card and
skip without one (the ``card`` fixture decides, at run time); run them on a
machine with one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
