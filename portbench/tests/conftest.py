"""CPU tests of the port's benchmark (`python -m pytest portbench/tests -q`).

Tests that need the card take the `card` fixture, which decides inside
the test whether there is one and skips here; the marker `card` names
them (`-m card` selects them on a machine with the card)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda")
