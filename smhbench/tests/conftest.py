"""The benchmark's own tests: run with `python -m pytest smhbench/tests -q`
from the root of a checkout. Tests that need a CUDA card carry the `card`
marker and ask for the `cuda_card` fixture, which decides whether a card is
present when the test runs, never when a module is imported."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs on the card are the chip's")
    return torch.device("cuda:0")


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")
