"""The harness's CPU tests. Those that need the card carry the `chip`
marker and skip here; whether a card is there is decided inside the
test, by the `cuda` fixture."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; run on the chip with "
        "`python -m pytest jfbench/tests -m chip`")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
