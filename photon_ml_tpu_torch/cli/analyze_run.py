"""Replay a telemetry run ledger into a performance report.

Reads the JSONL RunLedger a ``--telemetry-out`` run (or ``bench.py``
telemetry mode) wrote, reconstructs the span tree, and prints per-phase
occupancy/bubble accounting with the SolverStats / TransferStats /
jit-retrace joins. Optionally emits the structured ``RunReport`` as JSON,
gates on wall-clock attribution coverage (the CI analyze smoke gate), and
runs the offline tuner over the report to propose a config.

Usage:
    # human-readable occupancy report
    python -m photon_ml_tpu_torch.cli.analyze_run out/run-ledger.jsonl

    # CI gate: fail unless >=95% of wall-clock is attributed
    python -m photon_ml_tpu_torch.cli.analyze_run out/run-ledger.jsonl \
        --check-coverage 0.95

    # structured report + tuner proposal over the registered knob space
    python -m photon_ml_tpu_torch.cli.analyze_run out/run-ledger.jsonl \
        --json report.json --propose --propose-json proposal.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from photon_ml_tpu_torch.telemetry.analyze import analyze_ledger, format_report


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="analyze_run",
        description="Replay a telemetry run ledger into a performance report.",
    )
    parser.add_argument("ledger", help="Path to a run-ledger JSONL file.")
    parser.add_argument(
        "--json",
        default=None,
        metavar="PATH",
        help="Also write the structured RunReport as JSON to PATH ('-' for stdout).",
    )
    parser.add_argument(
        "--check-coverage",
        type=float,
        default=None,
        metavar="FRACTION",
        help=(
            "Exit nonzero unless attributed time covers at least FRACTION of "
            "wall-clock AND does not exceed it by the same margin (catches "
            "both unattributed time and cross-thread double-counting)."
        ),
    )
    parser.add_argument(
        "--propose",
        action="store_true",
        help="Run the offline tuner over the report and print its proposal.",
    )
    parser.add_argument(
        "--propose-json",
        default=None,
        metavar="PATH",
        help="Write the tuner proposal as JSON to PATH (implies --propose).",
    )
    parser.add_argument(
        "--progress",
        action="store_true",
        help=(
            "Render the convergence report (iterations-to-tolerance per "
            "coordinate, objective shares, per-block gap estimates, "
            "anomalies) from the ledger's progress records; exits nonzero "
            "when the ledger carries none."
        ),
    )
    parser.add_argument(
        "--requests",
        action="store_true",
        help=(
            "Render the request-plane tail-latency attribution (per-stage "
            "p50/p99, tail breakdown with exemplar request ids, "
            "interference overlap) from the ledger's sampled request "
            "records; exits nonzero when the ledger carries none."
        ),
    )
    parser.add_argument(
        "--cluster",
        action="store_true",
        help=(
            "Render the cluster-plane skew attribution (per-pass busy/"
            "allreduce-wait/bubble decomposition, per-host work vs the "
            "assigner's predicted shares, straggler ranking, imbalance "
            "trend) from the ledger's cluster_pass/host_pass records; "
            "exits nonzero when the ledger carries none."
        ),
    )
    parser.add_argument(
        "--quiet",
        action="store_true",
        help="Suppress the human-readable report (JSON outputs still written).",
    )
    return parser.parse_args(argv)


def run(args: argparse.Namespace) -> int:
    report = analyze_ledger(args.ledger)
    if args.progress:
        from photon_ml_tpu_torch.telemetry.progress import format_progress_report

        if not report.progress:
            print(
                "analyze_run: ledger carries no progress records (train with "
                "--progress-out to record the convergence plane)",
                file=sys.stderr,
            )
            return 1
        if not args.quiet:
            print(format_progress_report(report.progress))
    if args.requests:
        from photon_ml_tpu_torch.telemetry.analyze import format_request_report

        if not report.requests:
            print(
                "analyze_run: ledger carries no request records (serve with "
                "a RequestPlane attached — serve_game --request-sample-rate "
                "— to record sampled lifecycles)",
                file=sys.stderr,
            )
            return 1
        if not args.quiet:
            print(format_request_report(report.requests))
    if args.cluster:
        from photon_ml_tpu_torch.telemetry.analyze import format_cluster_report

        if not report.cluster:
            print(
                "analyze_run: ledger carries no cluster_pass records (run "
                "the cluster plane with telemetry — train_game --hosts "
                "N --telemetry-out, or bench.py --multihost with "
                "BENCH_TELEMETRY_DIR — to record skew profiles)",
                file=sys.stderr,
            )
            return 1
        if not args.quiet:
            print(format_cluster_report(report.cluster))
    if not args.quiet:
        print(format_report(report))
    if args.json:
        payload = json.dumps(report.to_dict(), indent=2, sort_keys=True)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as f:
                f.write(payload + "\n")

    if args.propose or args.propose_json:
        from photon_ml_tpu_torch.tuning import propose

        proposal = propose(report)
        if not args.quiet:
            print()
            print(f"tuner proposal over {len(proposal.knobs)} registered knob(s):")
            for name, knob in sorted(proposal.knobs.items()):
                marker = "->" if knob.changed else "  "
                print(
                    f"  {marker} {name}: {knob.value!r}"
                    + (f" (default {knob.default!r})" if knob.changed else "")
                )
                print(f"       {knob.rationale}")
        if args.propose_json:
            with open(args.propose_json, "w", encoding="utf-8") as f:
                f.write(
                    json.dumps(proposal.to_dict(), indent=2, sort_keys=True) + "\n"
                )

    if args.check_coverage is not None:
        lo, hi = args.check_coverage, 2.0 - args.check_coverage
        if not (lo <= report.coverage <= hi):
            print(
                f"analyze_run: coverage {report.coverage:.4f} outside "
                f"[{lo:.2f}, {hi:.2f}] — "
                + (
                    "unattributed wall-clock time"
                    if report.coverage < lo
                    else "attributed more than wall-clock (double-counting?)"
                ),
                file=sys.stderr,
            )
            return 1
        print(
            f"analyze_run: coverage {report.coverage:.4f} within "
            f"[{lo:.2f}, {hi:.2f}]"
        )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
