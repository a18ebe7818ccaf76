"""Shared helpers of the benchmark's own tests (``pytest portbench/tests``
from the repository root). They run on the CPU at small sizes, through
the plain paths of the program; the ``gpu``-marked ones need a card."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is present (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
