"""Fixtures of the benchmark's tests: the repository root on the path, and
the card for the tests marked ``cuda`` (decided here, never at import)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest -m cuda benchmark/tests)")
    return torch.device("cuda", 0)
