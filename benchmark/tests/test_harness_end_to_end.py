"""A tiny run of each cell on the CPU, held against the reference, comes out
correct, and repeats its answers from the same seed."""

import pytest

from benchmark.tests import tiny


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_tiny_run_is_correct(workload):
    result, checks = tiny.run_tiny(workload, seed=2**31 + 101)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
