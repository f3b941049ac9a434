"""The benchmark's own tests: CPU tests at small sizes, and tests marked
`gpu` that need the card (they skip without one, decided in the `card`
fixture)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")
