"""The control of a cell's comparison, and its faults: something known to be
wrong put in the program's place, whose answers the comparison has to find
not correct, read beside the program's own sound answers at the cell's own
size.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 \
        --variants sound half_batch reference_bf16

Variants:

- ``sound``: one job of the program as the benchmark runs it;
- a fault of ``benchmark/faults.py`` (``stuck_step``,
  ``stuck_fixed_effect``, ``half_batch``, ``auc_altered``,
  ``objective_altered``): one job of the program with the fault planted;
- ``reference_bf16``: the plain reference trainer (``reference/train.py``)
  computed in bfloat16, the precision below the configuration's float32,
  put in the program's place;
- ``program_bf16`` (the sweep only): the program itself with its own
  lower-precision path switched on, the fused fixed-effect engine's
  bfloat16 payload (``fused_perm.from_coo(payload_dtype="bfloat16")``),
  for the training and the held-out rows.

For each seed the data is made once, and the program's layouts are built
once for every program variant. Prints, for each seed and variant, each
number beside its limit and whether the comparison found the answers
correct, and one JSON line of all readings last. Not part of the
benchmark's runs.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402

PROGRAM = ("sound",) + tuple(FAULTS)


def _bf16_layouts(job, device) -> None:
    """The sweep's program over the bfloat16-payload engine."""
    from photon_ml_tpu_torch.ops import fused_perm
    from photon_ml_tpu_torch.ops.data import LabeledData

    (train, labels), (heldout, heldout_labels) = job.parts["train"], job.parts["heldout"]

    def bf16(game_data):
        shard = game_data.feature_shards["features"]
        return fused_perm.from_coo(shard.rows, shard.cols, shard.vals,
                                   (game_data.num_rows, shard.dim), payload_dtype="bfloat16",
                                   device=device)

    job.data = LabeledData.create(bf16(train), labels.to(device))
    job.heldout_feats = bf16(heldout)
    job.heldout_labels = heldout_labels.to(device)
    job.parts = None


def _verdict(numbers: dict, limits: dict) -> dict:
    return {"numbers": numbers, "limits": limits,
            "correct": all(numbers[k] <= lim for k, lim in limits.items())}


def control_numbers(bench, workload, seed, variants, device="cuda", inputs=None) -> dict:
    """{variant: the comparison's numbers, limits and verdict} of one seed."""
    import pytest
    import torch

    from benchmark import datagen
    from benchmark.reference import judge, train
    from benchmark.spans import Spans

    cell, config, traffic, limits = inputs or run.cell_inputs(bench, workload)
    compare = getattr(judge, config["job"])
    data = datagen.make(config, traffic, seed, device)
    trained = getattr(train, config["job"])(data, config, torch.float64)
    out = {}
    if "reference_bf16" in variants:
        answers = getattr(train, config["job"])(data, config, torch.bfloat16)
        out["reference_bf16"] = _verdict(compare(data, config, [answers], trained)[0], limits)
    job_module = importlib.import_module(f"benchmark.jobs.{config['job']}")
    for kind in ("program_bf16", "program"):
        wanted = [v for v in variants if v in PROGRAM] if kind == "program" else (
            ["program_bf16"] if "program_bf16" in variants else [])
        if not wanted:
            continue
        if kind == "program_bf16" and config["job"] != "glm_sweep":
            raise SystemExit(f"no program_bf16 control for the job {config['job']!r}")
        job = job_module.Job(config, data, device, Spans())
        if kind == "program_bf16":
            _bf16_layouts(job, device)
        else:
            job.build()
        job.warm_up()
        for variant in wanted:
            with pytest.MonkeyPatch.context() as patch:
                if variant in FAULTS:
                    FAULTS[variant](patch)
                answers = job.answers(job.run())
                answers.update(job.last_answers())
            out[variant] = _verdict(compare(data, config, [answers], trained)[0], limits)
        job.free()
        del job
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["reference_bf16"],
                   choices=PROGRAM + ("reference_bf16", "program_bf16"))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    os.environ["USE_FLAX"] = "0"
    bench = run.load("BENCHMARK.json")
    out = []
    for seed in args.seeds:
        t = time.perf_counter()
        r = control_numbers(bench, args.workload, seed, args.variants)
        out.append({"seed": seed, "seconds": time.perf_counter() - t, "variants": r})
        for variant, v in r.items():
            for k, x in v["numbers"].items():
                print(f"seed {seed} {variant} {k} {x!r} limit {v['limits'].get(k)!r}",
                      file=sys.stderr)
            print(f"seed {seed} {variant} correct {v['correct']}", file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
