"""Torch's intra-op thread count for the port's CPU test files.

The Tier-1 run puts six test workers on the host's eight cores, so each
port test file runs torch on one or two threads (by default torch takes
every core).  The count also decides the summation order of torch's CPU
reductions, and the parity tests were measured at the count each file
names: at one thread a BatchNorm's statistics, summed in one run, drift
1.1e-5 off JAX's (tests/test_torch_pointnet2.py holds 1e-5); at two the
GeoA3 attacks' iterates part from JAX's at more points than their rule
allows.  A module-scoped fixture, not a call at import: every worker
imports every test file, so only the last import's count would hold.
"""

import pytest
import torch


def threads(n: int):
    """An autouse fixture that sets ``n`` threads for its module's tests."""

    @pytest.fixture(autouse=True, scope="module")
    def torch_threads():
        torch.set_num_threads(n)

    return torch_threads
