"""Fixtures of the benchmark's CPU tests.

    PYTHONPATH=src python -m pytest -q portbench/tests

``tiny_root`` is a checkout in a temporary directory (``tiny.make_root``).
"""
from __future__ import annotations

import pytest
import torch

from tiny import make_root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
