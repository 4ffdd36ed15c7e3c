"""The port's ``serve_game`` CLI against the JAX package's on the ratings
fixture (a GAME model with random coefficients over the committed data).

- Both CLIs, given the same flags (pack + export, SLO tracking, overload
  control, full request sampling, two tenants), report the same request,
  batch and signature counts; the exported artifacts agree on every byte
  a reader looks at, and their scores of the replayed rows agree within
  atol 1e-6, rtol 2e-4.
- ``--cache-capacity``, ``--sealed``, ``--scorers 2`` and the default serve
  the same number of requests; ``--auto-tune`` persists a tuned config the
  next boot applies; the introspection endpoints answer during a hold.
- Each of the nearline and variant flags (``--watch-deltas``,
  ``--watch-chunk``, ``--variants``, ``--variant-ramp``, ``--variant-seed``,
  ``--tenant-rate``, ``--tenant-burst``) serves the same requests as the
  JAX CLI given the same flags, with the same swaps, router decisions,
  quota verdicts and variant states, and the variant runs' scores by
  request id within atol 1e-6, rtol 2e-4; without a card the CLI needs
  ``--device cpu``.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from _torch_serving_parity import assert_results_close
from test_serving import RATINGS, _ratings_model_dir
import photon_ml_tpu.serving as J
import photon_ml_tpu_torch.serving as T
from photon_ml_tpu.cli.serve_game import main as jax_main
from photon_ml_tpu_torch.cli.serve_game import main as port_main

TEST_DIR = os.path.join(RATINGS, "test")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _ratings_model_dir(tmp_path_factory)


def _serve(main, model_dir, out, *extra, device=True):
    argv = ["--model-dir", model_dir, "--data-dirs", TEST_DIR,
            "--metrics-output", str(out), "--max-requests", "120",
            "--bucket-sizes", "4,16", *extra]
    if device:
        argv += ["--device", "cpu"]
    assert main(argv) == 0
    with open(out) as f:
        return json.load(f)


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = p
    return out


def test_cli_report_and_artifact_equal_jax(model_dir, tmp_path):
    flags = ["--slo-latency-ms", "1000", "--overload-control",
             "--request-sample-rate", "1", "--tenants", "a,b"]
    j = _serve(jax_main, model_dir, tmp_path / "j.json", "--export-artifact-dir",
               str(tmp_path / "jart"), *flags, device=False)
    t = _serve(port_main, model_dir, tmp_path / "t.json", "--export-artifact-dir",
               str(tmp_path / "tart"), *flags)
    assert sorted(t) == sorted(j)
    for key in ("num_requests", "num_batches", "xla_compiles", "serving_mode",
                "num_scorers", "bucket_sizes"):
        assert t[key] == j[key], key
    assert t["num_requests"] == 120
    assert sorted(t["request_plane"]) == sorted(j["request_plane"])
    assert t["request_plane"]["requests_total"] == j["request_plane"]["requests_total"]
    assert sorted(t["slo"]) == sorted(j["slo"]) and t["overload"]["attached_batchers"] == 0
    jf, tf = _files(tmp_path / "jart"), _files(tmp_path / "tart")
    assert sorted(jf) == sorted(tf)
    for f in tf:
        if not f.endswith(".bin"):  # PHIX stores: see test_torch_serving_artifact
            assert open(tf[f], "rb").read() == open(jf[f], "rb").read(), f
    ja, ta = J.load_artifact(str(tmp_path / "jart")), T.load_artifact(str(tmp_path / "tart"))
    from photon_ml_tpu.io.data_reader import read_game_data as jread
    from photon_ml_tpu.io.data_reader import FeatureShardConfiguration as JCfg
    from photon_ml_tpu_torch.io.data_reader import read_game_data as tread
    from photon_ml_tpu_torch.io.data_reader import FeatureShardConfiguration as TCfg

    def _requests(pkg, read, Cfg, art):
        cfg = {s: Cfg(feature_bags=c["feature_bags"], add_intercept=c["add_intercept"])
               for s, c in art.configurations["feature_shards"].items()}
        data, _, uids = read([TEST_DIR], cfg, dict(art.feature_index),
                             id_tags=art.random_effect_types(), is_response_required=False)
        return pkg.requests_from_game_data(data, art, uids=uids, max_requests=120)

    jr, tr = _requests(J, jread, JCfg, ja), _requests(T, tread, TCfg, ta)
    jres = J.GameScorer(ja).score_batch(jr[:64], bucket_size=64)
    tres = T.GameScorer(ta, device="cpu").score_batch(tr[:64], bucket_size=64)
    assert_results_close(tres, jres)


@pytest.mark.parametrize("mode", [[], ["--sealed"], ["--cache-capacity", "32"],
                                  ["--scorers", "2"], ["--device-budget-rows", "8",
                                                       "--admit-batch", "4"]])
def test_serving_modes_serve_every_request(model_dir, tmp_path, mode):
    t = _serve(port_main, model_dir, tmp_path / "t.json", *mode)
    assert t["num_requests"] == 120
    assert t["xla_compiles"] <= 2
    want = {"--cache-capacity": "cached"}.get(mode[0] if mode else "", "sharded")
    assert t["serving_mode"] == want
    assert t["num_scorers"] == (2 if mode[:1] == ["--scorers"] else 1)
    if mode[:1] == ["--device-budget-rows"]:
        assert t["admission"]["deferred_total"] > 0


def test_auto_tune_persists_a_config_the_next_boot_applies(model_dir, tmp_path):
    art = str(tmp_path / "art")
    assert port_main(["--model-dir", model_dir, "--export-artifact-dir", art,
                      "--device", "cpu"]) == 0
    first = _serve(port_main, model_dir, tmp_path / "a.json", "--auto-tune",
                   "--auto-tune-warmup", "32", "--export-artifact-dir", str(tmp_path / "art2"))
    assert "auto_tune" in first and first["num_requests"] == 120
    tuned = T.load_tuned_config(str(tmp_path / "art2"))
    assert tuned is not None
    T.save_tuned_config(art, {"serving.bucket_sizes": [2, 8]})
    boot = port_main(["--artifact-dir", art, "--data-dirs", TEST_DIR, "--max-requests", "20",
                      "--metrics-output", str(tmp_path / "b.json"), "--device", "cpu"])
    assert boot == 0
    assert json.load(open(tmp_path / "b.json"))["bucket_sizes"] == [2, 8]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read().decode()


def test_introspection_endpoints_answer_during_a_hold(model_dir, tmp_path):
    port_file = tmp_path / "port"
    rc = {}

    def _run():
        rc["rc"] = port_main([
            "--model-dir", model_dir, "--data-dirs", TEST_DIR, "--max-requests", "40",
            "--slo-latency-ms", "1000", "--request-sample-rate", "1",
            "--introspect-port", "0", "--introspect-port-file", str(port_file),
            "--introspect-hold", "60", "--device", "cpu"])

    th = threading.Thread(target=_run)
    th.start()
    try:
        deadline = time.monotonic() + 60
        port = None
        while port is None and time.monotonic() < deadline:
            if port_file.exists() and port_file.read_text():
                port = int(port_file.read_text())
            time.sleep(0.01)
        assert port is not None
        for _ in range(600):  # until the replay drained into the hold
            status, body = _get(port, "/healthz")
            if json.loads(body)["phase"] == "drained":
                break
            time.sleep(0.05)
        assert status == 200 and json.loads(body)["healthy"]
        status, varz = _get(port, "/varz")
        assert status == 200 and json.loads(varz)["mode"] == "sharded"
        status, metrics = _get(port, "/metrics")
        assert status == 200 and "serving" in metrics
        assert _get(port, "/requests")[0] == 200
        assert _get(port, "/quitquitquit")[0] == 200
    finally:
        th.join(timeout=60)
    assert not th.is_alive() and rc["rc"] == 0


@pytest.fixture(scope="module")
def watched(model_dir, tmp_path_factory):
    """The port's export of the model, and a watch dir holding one delta
    chained to its fingerprint: five users' rows rewritten, one user new."""
    import photon_ml_tpu_torch.incremental as TI

    root = tmp_path_factory.mktemp("watched")
    art = str(root / "artifact")
    assert port_main(["--model-dir", model_dir, "--export-artifact-dir", art,
                      "--device", "cpu"]) == 0
    artifact = T.load_artifact(art)
    table = artifact.tables["per_user"]
    names = [table.entity_index.get_feature_name(i) for i in range(5)] + ["brand-new"]
    rng = np.random.default_rng(2)
    rows = {e: {int(j): float(v) for j, v in zip(rng.integers(0, table.dim, 3),
                                                  rng.normal(0, 0.5, 3))} for e in names}
    delta = TI.build_delta({"per_user": rows}, artifact, base_fingerprint=TI.fingerprint_dir(art),
                           generation=1, created_at_unix=100.0)
    TI.save_delta(delta, str(root / "deltas" / TI.delta_dir_name(1)))
    return art, str(root / "deltas")


@pytest.mark.parametrize("flags", [
    ["--watch-deltas", "{deltas}"],
    ["--watch-deltas", "{deltas}", "--watch-chunk", "16"],
    ["--variants", "v1,v2"],
    ["--variants", "v1", "--variant-ramp", "30"],
    ["--variants", "v1", "--variant-seed", "7"],
    ["--variants", "v1", "--tenants", "a,b", "--tenant-rate", "1000"],
    ["--variants", "v1", "--tenants", "a,b", "--tenant-rate", "0.001", "--tenant-burst", "25"],
], ids=["watch-deltas", "watch-chunk", "variants", "variant-ramp", "variant-seed",
        "tenant-rate", "tenant-burst"])
def test_nearline_and_variant_flags_match_jax(watched, tmp_path, flags, monkeypatch):
    art, deltas = watched
    flags = [f.format(deltas=deltas) for f in flags]
    snaps, served = {}, {"jax": [], "port": []}
    for key, plane in (("jax", J.TenancyPlane), ("port", T.TenancyPlane)):
        def replay(self, *args, _real=plane.replay, _out=served[key], **kwargs):
            results = _real(self, *args, **kwargs)
            _out.extend(results)
            return results

        monkeypatch.setattr(plane, "replay", replay)
    for key, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        out = tmp_path / f"{key}.json"
        assert main(["--artifact-dir", art, "--data-dirs", TEST_DIR, "--max-requests", "120",
                     "--bucket-sizes", "4,16", "--metrics-output", str(out), *flags,
                     *extra]) == 0
        snaps[key] = json.load(open(out))
    t, j = snaps["port"], snaps["jax"]
    assert sorted(t) == sorted(j)
    for key in ("num_requests", "serving_mode", "num_scorers", "bucket_sizes"):
        assert t[key] == j[key], key
    if "--watch-deltas" in flags:
        want = [(1, False, 6)]
        for snap in (t, j):
            assert [(r["generation"], r["rolled_back"], r["rows_updated"])
                    for r in snap["swap_reports"]] == want
        assert t["xla_compiles"] == j["xla_compiles"]
        return
    assert t["serving_mode"] == "sharded-tenancy"
    assert t["num_results"] == j["num_results"]
    tt, jt = t["tenancy"], j["tenancy"]
    assert sorted(tt) == sorted(jt)
    assert tt["router"] == jt["router"] and tt["variants"] == jt["variants"]
    assert tt.get("quota") == jt.get("quota")
    # the same requests scored by both planes, within the serving tolerance
    by_id = {k: sorted(v, key=lambda r: r.request_id) for k, v in served.items()}
    assert len(by_id["port"]) == t["num_results"] > 0
    assert_results_close(by_id["port"], by_id["jax"])
    if "--tenant-rate" in flags:
        # a burst of 25 a tenant at a rate that refills nothing; else the
        # burst is the rate, 1000, and every request is admitted
        want = 2 * 25 if "--tenant-burst" in flags else t["num_requests"]
        admitted = sum(s["admitted"] for s in tt["quota"]["tenants"].values())
        assert admitted == t["num_results"] == want


def test_export_only_and_nothing_to_do(model_dir, tmp_path):
    art = str(tmp_path / "art")
    assert port_main(["--model-dir", model_dir, "--export-artifact-dir", art,
                      "--device", "cpu"]) == 0
    assert T.load_artifact(art).tables["per_user"].n_entities > 0
    assert port_main(["--model-dir", model_dir]) == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a card")
def test_needs_device_cpu_without_a_card(model_dir, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(["--model-dir", model_dir, "--export-artifact-dir", str(tmp_path / "a")])
    assert not os.path.exists(tmp_path / "a")
