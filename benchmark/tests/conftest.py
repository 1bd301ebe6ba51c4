"""The benchmark harness's tests: on the CPU, at tiny sizes, except
those marked ``card``, which run the real cells and skip (deciding in
the test) where there is no CUDA device.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips inside the test "
        "without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
