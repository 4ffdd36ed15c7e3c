"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, everything else of a run driven on the
CPU, once for each fault a cell can have (``benchmark/faults.py``)."""

import pytest

from benchmark.faults import FAULTS
from benchmark.tests import tiny


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, checks = tiny.run_tiny(workload, seed=2**31 + 53)
    assert not result["correct"], checks
    assert result["failed"] == result["attempted"]

