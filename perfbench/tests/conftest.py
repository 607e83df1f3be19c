"""Shared fixtures of the benchmark's own tests (CPU; card-only tests carry
the ``cuda`` marker and skip where there is no card)."""

import pytest
import torch

torch.set_num_threads(2)

# Widths and depths small enough for a CPU check of a cell's control flow.
TINY = dict(d_model=32, d_ff=64, num_heads=2, d_kv=16, num_layers=2, num_decoder_layers=2)


@pytest.fixture
def card() -> None:
    """Skips the test where no CUDA card is present (decided here, not at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
