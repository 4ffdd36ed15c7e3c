"""The PyTorch port's package boundary and device rules.

photon_ml_tpu_torch must import neither jax nor anything of photon_ml_tpu
(it keeps its own copies), must switch TF32 off, and its entry points must
refuse to run on the host unless asked.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "photon_ml_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py"))


def test_import_pulls_in_no_jax_in_a_fresh_process():
    # tests/conftest.py imports jax in this process, hence a subprocess
    script = (
        "import importlib, json, pkgutil, sys\n"
        "import photon_ml_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'photon_ml_tpu' or k.startswith('photon_ml_tpu.'))\n"
        "print(json.dumps({'modules': mods, 'bad': bad}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    # every module of the port was imported
    assert len(result["modules"]) == len(_port_files()) - 1  # minus the root __init__


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "photon_ml_tpu"), (
                f"{path}:{node.lineno} imports {name}"
            )


def test_the_port_never_loads_the_reference_native_libraries(tmp_path):
    """The port builds and loads its own copies of the host C++ libraries
    (build/photon_ml_tpu_torch/), never photon_ml_tpu/native/_*.so: after
    a native Avro read and an off-heap store build and lookup in a fresh
    process, the process maps no file of the JAX package's native dir."""
    script = (
        "import json, sys\n"
        "from photon_ml_tpu_torch.io.data_reader import FeatureShardConfiguration, "
        "read_game_data, write_training_examples\n"
        "from photon_ml_tpu_torch.indexmap.offheap import build_offheap_index_map\n"
        "d = sys.argv[1]\n"
        "write_training_examples(d + '/part-0.avro', [{'label': 1.0, "
        "'features': [('f', '1', 2.0)]}])\n"
        "m = build_offheap_index_map(['f\\x011'], d + '/idx')\n"
        "data, _, _ = read_game_data([d], {'g': FeatureShardConfiguration(['features'], False)},"
        " index_maps={'g': m})\n"
        "assert data.feature_shards['g'].cols.tolist() == [0]\n"
        "maps = [l.split()[-1] for l in open('/proc/self/maps') if l.rstrip().endswith('.so')]\n"
        "print(json.dumps(sorted(set(maps))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path)], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    libs = json.loads(out.stdout.strip().splitlines()[-1])
    reference_native = str(REPO / "photon_ml_tpu" / "native")
    assert not [p for p in libs if p.startswith(reference_native)]
    port_build = str(REPO / "build" / "photon_ml_tpu_torch")
    for name in ("libavrodecode-", "libindexstore-"):
        assert [p for p in libs if p.startswith(port_build) and name in p], name


def test_tf32_is_off_after_import():
    import photon_ml_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from photon_ml_tpu_torch.cli import score_game
    from photon_ml_tpu_torch.convert import game_model_from_numpy
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.ops import features, fused_perm

    _no_card(monkeypatch)
    coords = {"fixed": {"feature_shard": "g", "means": np.zeros(3, np.float32)}}
    rows, cols, vals = np.array([0]), np.array([1]), np.array([1.0], np.float32)
    data = GameData(
        labels=np.zeros(1), feature_shards={"g": FeatureShard(rows, cols, vals, 3)},
        id_tags={},
    )
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="is_available"):
        game_model_from_numpy(coords, "LOGISTIC_REGRESSION")
    with pytest.raises(RuntimeError, match="is_available"):
        data.sparse_features("g")
    with pytest.raises(RuntimeError, match="is_available"):
        fused_perm.from_coo(rows, cols, vals, (1, 3))
    with pytest.raises(RuntimeError, match="is_available"):
        features.from_scipy_like(rows, cols, vals, (1, 3))
    with pytest.raises(RuntimeError, match="is_available"):
        load_game_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="is_available"):
        score_game.main([
            "--data-dirs", str(tmp_path), "--model-dir", str(tmp_path),
            "--output-dir", str(tmp_path / "out"),
        ])
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.estimators.game import (
        FixedEffectCoordinateConfiguration,
        GameEstimator,
    )
    from photon_ml_tpu_torch.types import TaskType

    with pytest.raises(RuntimeError, match="is_available"):
        GameEstimator(TaskType.LOGISTIC_REGRESSION,
                      {"fixed": FixedEffectCoordinateConfiguration("g")})
    with pytest.raises(RuntimeError, match="is_available"):
        build_random_effect_dataset(["a"], rows, cols, vals, 3, np.zeros(1),
                                    RandomEffectDataConfiguration("userId"))
    with pytest.raises(RuntimeError, match="is_available"):
        train_game.main([
            "--train-data-dirs", str(tmp_path), "--coordinate-config", str(tmp_path / "c.json"),
            "--task", "LOGISTIC_REGRESSION", "--output-dir", str(tmp_path / "out"),
        ])
    # asked for explicitly, the host is fine
    assert game_model_from_numpy(coords, "LOGISTIC_REGRESSION", device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
