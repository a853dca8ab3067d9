"""The benchmark's own tests (not collected by the repo's `pytest tests/`).

    python -m pytest benchmark/tests -q            # CPU: skips the card's
    python -m pytest benchmark/tests -q -m card    # on the card's machine

Tests that need the card carry the `card` marker and skip inside the
`card` fixture where torch sees no CUDA device."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (runs the cells themselves)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    return torch.device("cuda:0")
