"""Fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``): a checkout cut to a tiny size, one at full size with
the parked cells in it, and the card check of the ``cuda`` tests, decided
in a fixture."""
import pytest
import torch

import tiny


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(scope="module")
def full_root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("full"), cut=False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
