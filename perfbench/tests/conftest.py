"""The benchmark's own tests: the harness on the CPU at tiny sizes.  Tests
that need the card are marked ``cuda`` and skip without one (decided in
the ``card`` fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
