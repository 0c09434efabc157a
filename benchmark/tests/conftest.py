"""CPU tests of the benchmark, run from the root of the checkout:

    python -m pytest benchmark/tests -q

Cases that need the card carry the ``cuda`` marker and skip elsewhere,
decided in the ``card`` fixture."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
