"""The cells at a size a CPU test run holds: the same jobs, solvers and
comparison, at about the full cells' rows a feature and rows an entity (16
a feature, 64 a user, 256 an item on average), with limits of their own.

The limits (``LIMITS``) are set as the cells' are, from readings at this
size on the CPU: the largest of 13 sound seeds (lower), and the smallest
reading of the controls (3 seeds) that is three times the lower or more,
or of a fault of ``benchmark/faults.py`` (3 seeds) that is ten times it
(upper); each limit at or above the two readings' geometric mean:

- sweep: ``objective_gap`` 1.46e-7 / 1.32e-5 (the program's bf16
  payload); ``grad_ratio`` 0.133 / 0.417 (reference in bf16);
  ``score_gap`` 3.26e-7 / 1.80e-3 (bf16 payload); ``auc_gap`` 3.57e-7 /
  1.15e-5 (bf16 payload); ``loss_gap`` 7.26e-10 / 6.96e-9 (bf16
  payload); ``change_gap`` 8.38e-5 / 0.0833 (half the rows);
- GLMix: ``objective_gap`` 5.93e-8 / 1e-3 (objective altered);
  ``grad_ratio`` 0.0260 / 0.153 (reference in bf16); ``auc_gap`` 5.53e-8
  / 2.48e-5 (reference in bf16); ``loss_gap`` 1.17e-7 / 0.144 (reference
  in bf16); ``change_gap`` 2.89e-5 / 0.477 (half the rows).
"""

import copy
import time

from benchmark import run

BENCH = run.load("BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
LIMITS = {
    "glm_sweep.rows_2p24": {"objective_gap": 3e-6, "grad_ratio": 0.25, "score_gap": 5e-5,
                            "auc_gap": 3e-6, "loss_gap": 3e-9, "change_gap": 3e-3},
    "glmix_fit.rows_2p22": {"objective_gap": 1e-5, "grad_ratio": 0.08, "auc_gap": 2e-6,
                            "loss_gap": 1e-3, "change_gap": 1e-2},
}


def inputs(workload: str) -> tuple:
    cell, config, traffic, _ = run.cell_inputs(BENCH, workload)
    config = copy.deepcopy(config)
    config.update(rows=4096, heldout_rows=16384)
    config["fixed_effect"].update(features=4096)
    for re in config.get("random_effects", {}).values():
        re.update(entities=re["entities"] // 1024, features=256)
    return cell, config, traffic, LIMITS[workload]


def run_tiny(workload: str, seed: int = 2**31 + 11, seconds: float = 0.5) -> tuple:
    """(result line, checks) of one run on the CPU."""
    return run.run_cell(BENCH, workload, seed, seconds, False, device="cpu",
                        t0=time.perf_counter(), inputs=inputs(workload))
