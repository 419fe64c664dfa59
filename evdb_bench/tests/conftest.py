"""Fixtures of the benchmark's own tests (run them with
``python -m pytest evdb_bench/tests``; the card's with ``-m cuda``)."""

import pytest


@pytest.fixture
def cuda_device():
    """The CUDA card, decided when the test runs (never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
