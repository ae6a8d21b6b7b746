"""Shared fixtures of the benchmark's own tests.

They run on the CPU at small sizes. ``card`` skips a test unless a CUDA
card is there; it decides when the test runs, never at import.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
