"""The benchmark's tests import it as ``portbench`` from the checkout's root."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card() -> str:
    """The CUDA device; skips where there is none (decided here, never while
    the tests are collected)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
