"""The nearline CLIs on the ratings fixture: the port's ``update_game`` and
``serve_game --watch-deltas`` against the JAX package's.

- ``update_game`` publishes ``delta-000001``, then chains ``delta-000002``
  with a fixed-effect refresh, then compacts the chain: the same summary
  as the JAX CLI's on the same base artifact, model and events (the same
  generations, base fingerprints, touched and new counts), delta manifests
  equal but for the publish time, rows within atol 2e-3, and each chain
  verifies against the base.
- ``serve_game --watch-deltas`` swaps both deltas in mid-replay, as the
  JAX CLI does with its own.
"""

import json
import os

import numpy as np
import pytest

from test_incremental import RATINGS, ratings_artifact  # noqa: F401  (a fixture)
import photon_ml_tpu.incremental as JI
import photon_ml_tpu_torch.incremental as TI
from photon_ml_tpu.cli import update_game as jax_update_cli
from photon_ml_tpu.cli.serve_game import main as jax_serve
from photon_ml_tpu_torch.cli import update_game as port_update_cli
from photon_ml_tpu_torch.cli.serve_game import main as port_serve

SUMMARY_KEYS = ("generation", "base_fingerprint", "rows_updated", "num_events",
                "touched_entities", "new_entities", "fixed_effects_refreshed")


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def config(ratings_artifact, tmp_path_factory):  # noqa: F811
    """The fixture's coordinate config with L2 lambda 1 on both coordinates
    and L-BFGS to 100 iterations at tolerance 1e-7 (the fixture's own
    lambda 0.1 leaves the fixed effect a near-flat direction along the
    intercept, where two f32 solves stop up to 0.3 apart at objectives
    5e-5 apart)."""
    cfg = json.load(open(ratings_artifact["config"]))
    for c in cfg["coordinates"].values():
        c["optimizer"].update(regularization_weight=1.0, max_iterations=100, tolerance=1e-7)
    path = str(tmp_path_factory.mktemp("update_game_config") / "game.json")
    json.dump(cfg, open(path, "w"))
    return path


@pytest.fixture(scope="module")
def published(ratings_artifact, config, tmp_path_factory):  # noqa: F811
    """Both CLIs' two chained deltas (the second after one fixed-effect
    refresh) and the chain compacted by the second run."""
    root = tmp_path_factory.mktemp("update_game")
    out = {}
    for key, cli, extra in (("jax", jax_update_cli, []), ("port", port_update_cli,
                                                          ["--device", "cpu"])):
        deltas = str(root / key / "deltas")
        argv = ["--base-artifact-dir", ratings_artifact["artifact_dir"],
                "--model-dir", ratings_artifact["model_dir"],
                "--coordinate-config", config,
                "--events-data-dirs", os.path.join(RATINGS, "train"),
                "--output-dir", deltas, *extra]
        compacted = str(root / key / "compacted")
        summaries = [cli.run(cli.parse_args(argv)),
                     cli.run(cli.parse_args(argv + ["--refresh-fixed-iterations", "1",
                                                    "--compact-into", compacted]))]
        out[key] = {"deltas": deltas, "summaries": summaries, "compacted": compacted}
    return out


def test_update_game_main_prints_its_summary(ratings_artifact, tmp_path, capsys):  # noqa: F811
    assert port_update_cli.main([
        "--base-artifact-dir", ratings_artifact["artifact_dir"],
        "--model-dir", ratings_artifact["model_dir"],
        "--coordinate-config", ratings_artifact["config"],
        "--events-data-dirs", os.path.join(RATINGS, "train"),
        "--output-dir", str(tmp_path / "d"), "--generation", "7", "--device", "cpu"]) == 0
    summary = _last_json(capsys)
    assert summary["generation"] == 7
    assert os.path.isdir(tmp_path / "d" / "delta-000007")


def test_update_game_summaries_match_jax(published, ratings_artifact):  # noqa: F811
    j, t = published["jax"]["summaries"], published["port"]["summaries"]
    for a, b in zip(t, j):
        # the second delta chains to each package's own first one, whose
        # manifest carries its publish time
        keys = [k for k in SUMMARY_KEYS if a["generation"] == 1 or k != "base_fingerprint"]
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert [s["generation"] for s in t] == [1, 2]
    assert t[0]["base_fingerprint"] == TI.fingerprint_dir(ratings_artifact["artifact_dir"])
    assert t[1]["base_fingerprint"] == t[0]["fingerprint"]
    assert t[1]["fixed_effects_refreshed"] == ["fixed"] and t[0]["rows_updated"] > 0
    assert t[1]["compacted_fingerprint"] == TI.fingerprint_dir(published["port"]["compacted"])
    assert "compacted_into" not in t[0]


def test_update_game_deltas_match_jax(published, ratings_artifact):  # noqa: F811
    base = TI.fingerprint_dir(ratings_artifact["artifact_dir"])
    jpaths = JI.discover_deltas(published["jax"]["deltas"])
    tpaths = TI.discover_deltas(published["port"]["deltas"])
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths] == [
        "delta-000001", "delta-000002"]
    tchain = [TI.load_delta(p) for p in tpaths]
    TI.verify_chain(base, tchain)
    JI.verify_chain(base, [JI.load_delta(p) for p in tpaths])  # the JAX package reads them
    for tp, jp in zip(tpaths, jpaths):
        tm, jm = (json.load(open(os.path.join(p, TI.DELTA_MANIFEST_FILE))) for p in (tp, jp))
        for m in (tm, jm):
            m.pop("created_at_unix")
        if tm["generation"] == 2:  # chained to each package's own first delta
            tm.pop("base_fingerprint"), jm.pop("base_fingerprint")
        assert tm == jm
        td, jd = TI.load_delta(tp), JI.load_delta(jp)
        for cid, (ids, rows) in jd.re_rows.items():
            assert td.re_rows[cid][0] == ids
            np.testing.assert_allclose(td.re_rows[cid][1], rows, atol=2e-3)
        for cid, w in jd.fe_updates.items():
            np.testing.assert_allclose(td.fe_updates[cid], w, atol=2e-3)
    from photon_ml_tpu_torch.serving import load_artifact

    compacted = load_artifact(published["port"]["compacted"])
    assert sorted(compacted.tables) == ["fixed", "per_user"]


def test_serve_game_watch_deltas_matches_jax(published, ratings_artifact, tmp_path,  # noqa: F811
                                             capsys):
    snaps = {}
    for key, main, extra in (("jax", jax_serve, []), ("port", port_serve, ["--device", "cpu"])):
        out = str(tmp_path / f"{key}.json")
        assert main(["--artifact-dir", ratings_artifact["artifact_dir"],
                     "--data-dirs", os.path.join(RATINGS, "test"), "--max-requests", "100",
                     "--bucket-sizes", "4,16", "--watch-deltas", published[key]["deltas"],
                     "--watch-chunk", "64", "--metrics-output", out, *extra]) == 0
        capsys.readouterr()
        snaps[key] = json.load(open(out))
    t, j = snaps["port"], snaps["jax"]
    assert sorted(t) == sorted(j)
    fields = ("generation", "rolled_back", "rows_updated")
    assert [{f: r[f] for f in fields} for r in t["swap_reports"]] == [
        {f: r[f] for f in fields} for r in j["swap_reports"]]
    assert [r["generation"] for r in t["swap_reports"]] == [1, 2]
    assert t["swaps"]["current_generation"] == j["swaps"]["current_generation"] == 2
    assert t["swaps"]["num_rollbacks"] == 0
    assert (t["num_requests"], t["xla_compiles"]) == (j["num_requests"], j["xla_compiles"])
