"""The benchmark's own tests (python -m pytest benchmark/tests): CPU tests
at small sizes, and tests marked `card` that run on the H100 and skip here.
Whether there is a card is decided inside the `card` fixture, never while a
module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
