"""The benchmark's own tests: `python -m pytest portbench/tests -q`.

Tests that need a CUDA card carry the `cuda` marker and skip themselves
inside the test where none is usable; they run on the card with the same
command. The CPU tests run every cell at a tiny size on the CPU.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips itself without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
