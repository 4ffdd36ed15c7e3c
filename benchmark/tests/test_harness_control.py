"""The control comes out not correct: the plain reference computed in
bfloat16 put in the program's place, and (the sweep) the program's own
bfloat16-payload engine, judged by each cell's comparison and limits."""

import pytest

from benchmark import control
from benchmark.tests import tiny

CASES = [(w, "reference_bf16") for w in tiny.CELLS] + [("glm_sweep.rows_2p24", "program_bf16")]


@pytest.mark.parametrize("workload,variant", CASES)
def test_control_is_not_correct(workload, variant):
    r = control.control_numbers(tiny.BENCH, workload, 2**31 + 29, [variant], device="cpu",
                                inputs=tiny.inputs(workload))
    assert not r[variant]["correct"], r
