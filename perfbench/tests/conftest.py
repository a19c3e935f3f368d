"""CPU tests of the benchmark harness (``python -m pytest perfbench/tests``).

The harness's modules are imported as run.py imports them, with
``perfbench/`` and the checkout's root on ``sys.path`` (``toys.py``, which
also holds the cells at toy sizes). Tests that need a card take the
``card`` fixture, which skips without one (marker ``gpu``):

    python -m pytest -o addopts="" -m gpu perfbench/tests
"""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel route and the timed paths run there")
    return torch.device("cuda", 0)
