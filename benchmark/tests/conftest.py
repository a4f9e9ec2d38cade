"""Test settings of the benchmark's own tests (``python -m pytest
benchmark/tests``). ``tests/conftest.py`` does not reach this folder.

The ``cuda`` marker marks a test that needs a CUDA card; such a test asks
the ``cuda_device`` fixture, which skips it where there is none. Whether
there is a card is decided inside the fixture, never while a module is
imported.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


