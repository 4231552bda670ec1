"""The benchmark's own tests (run with `python3 -m pytest perfbench/tests`;
the repository's tier-1 run does not collect them). A test that needs the
card carries the `card` marker and skips, from inside the test, where no
CUDA device is present."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never when the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
