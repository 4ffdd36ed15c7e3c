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
- ``--watch-deltas`` / ``--watch-chunk`` are refused naming Queue A item
  9b, the variant flags naming item 9c; without a card the CLI needs
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


@pytest.mark.parametrize("flags,item", [
    (["--watch-deltas", "d"], "9b"), (["--watch-chunk", "64"], "9b"),
    (["--variants", "v"], "9c"), (["--variant-ramp", "10"], "9c"),
    (["--variant-seed", "1"], "9c"), (["--tenant-rate", "1"], "9c"),
    (["--tenant-burst", "2"], "9c"),
])
def test_unported_flags_are_refused_naming_their_item(model_dir, flags, item):
    with pytest.raises(SystemExit) as e:
        port_main(["--model-dir", model_dir, "--data-dirs", TEST_DIR, *flags,
                   "--device", "cpu"])
    assert f"Queue A item {item}" in str(e.value) or f"item {item}" in str(e.value)
    assert e.value.code not in (0, None)


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
