"""The port's run-ledger analysis (``telemetry/analyze.py``,
``cli/analyze_run.py``) against the JAX package's, on ledgers the port
writes.

- ``analyze_records`` of the same records gives the same ``RunReport``, and
  ``convergence_report`` the same convergence report; ``classify_span``
  sorts every span name of the training path as the JAX package does;
- ``analyze_run`` prints the same text and exits with the same code on
  the same ledger, for the plain report, ``--progress``, ``--json -``,
  ``--propose``, ``--check-coverage`` and the request and cluster reports
  (which a training ledger does not carry).
"""

import pytest

import photon_ml_tpu.telemetry as jt
import photon_ml_tpu_torch.telemetry as tt
from _torch_parity import tiny_glmix_argv, write_tiny_glmix
from photon_ml_tpu.cli import analyze_run as jax_analyze_run
from photon_ml_tpu_torch.cli import analyze_run, train_game
from test_torch_cd_async import _fit, _problem, _torch_data


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()
    yield
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    """(a run ledger with the convergence plane riding along, from a traced
    async fit; the CLI's run ledger; the CLI's progress ledger)."""
    root = tmp_path_factory.mktemp("torch_analyze")
    combined = str(root / "combined.jsonl")
    run = tt.start_run("fit", ledger_path=combined)
    tracker = tt.ConvergenceTracker(ledger=run.ledger)
    try:
        _fit(_torch_data(_problem(n_users=8, rows_per_user=12)), "async", 1, n_outer=2)
        # the fit's estimator takes no tracker: record a few points by hand
        for outer, obj in enumerate((12.0, 11.0, 10.5)):
            tracker.record_coordinate(outer, "fixed", obj, grad_norm=0.1,
                                      solver_iterations=5 + outer,
                                      convergence_reason="GRADIENT_CONVERGED")
            tracker.record_validation(outer, "fixed", 0.7 + 0.01 * outer)
    finally:
        run.finish()
        tt.disable_tracing()
    paths = write_tiny_glmix(root / "data")
    cli_ledger, progress = str(root / "cli.jsonl"), str(root / "progress.jsonl")
    assert train_game.main(tiny_glmix_argv(
        paths, root / "out", "--device", "cpu", "--telemetry-out", cli_ledger,
        "--progress-out", progress)) == 0
    tt.get_registry().reset()
    return {"combined": combined, "cli": cli_ledger, "progress": progress}


@pytest.mark.parametrize("which", ["combined", "cli", "progress"])
def test_reports_of_the_same_records_match(ledgers, which):
    records = tt.validate_ledger(ledgers[which])
    mine = tt.analyze_records(records, source_path=ledgers[which])
    ref = jt.analyze_records(jt.validate_ledger(ledgers[which]), source_path=ledgers[which])
    assert mine.to_dict() == ref.to_dict()
    assert tt.format_report(mine) == jt.format_report(ref)
    if which != "cli":
        prog = tt.extract_progress_records(records)
        assert prog and tt.convergence_report(prog) == jt.convergence_report(prog)
    assert tt.analyze_ledger(ledgers[which]).to_dict() == mine.to_dict()


def test_classify_span_matches():
    names = ["game/fit", "game/build_coordinate", "game/resolve_coordinate", "cd/run",
             "cd/outer_iter", "cd/coordinate", "cd/reconcile", "cd/overlap", "cd/objective",
             "cd/validate", "fe/solve", "re/train", "re/solve_bucket", "re/adaptive_round",
             "read training data", "fit", "preprocess", "train", "validate", "output",
             "save model", "something/else"]
    assert [tt.classify_span(n) for n in names] == [jt.classify_span(n) for n in names]


def test_run_report_round_trips_as_the_jax_one(ledgers):
    d = jt.analyze_ledger(ledgers["combined"]).to_dict()
    assert tt.RunReport.from_dict(d).to_dict() == jt.RunReport.from_dict(d).to_dict() == d


@pytest.mark.parametrize("flags", [(), ("--progress",), ("--json", "-"), ("--propose",),
                                   ("--check-coverage", "0.5"), ("--check-coverage", "0.999"),
                                   ("--requests",), ("--cluster",), ("--quiet",)])
@pytest.mark.parametrize("which", ["combined", "cli", "progress"])
def test_analyze_run_output_matches(ledgers, which, flags, capsys):
    rc = analyze_run.main([ledgers[which], *flags])
    mine = capsys.readouterr()
    ref_rc = jax_analyze_run.main([ledgers[which], *flags])
    ref = capsys.readouterr()
    assert rc == ref_rc
    assert mine.out == ref.out
    assert mine.err == ref.err
