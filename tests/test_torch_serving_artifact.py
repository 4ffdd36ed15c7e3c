"""The serving artifact: the port's ``pack_game_model`` / ``save_artifact`` /
``load_artifact`` against the JAX package's, on the same models.

- A GLMix model (fixed effect + two index-mapped random effects, a random
  projection one too) and a full GAME model with a factored coordinate
  pack to the same tables, bit for bit.
- Every file the port saves is byte-equal to the JAX package's save of the
  same model when the JAX package writes its PHIX stores with its plain
  writer; against its native writer the stores agree on every byte a
  reader looks at (its ``malloc`` leaves the key length and index of empty
  forward slots unset).
- Each package loads the other's artifact; the tuned config round-trips.
"""

import os
import struct

import numpy as np
import pytest

from _torch_parity import coordinates_of_jax_model, glmix_numpy, jax_game_model
from photon_ml_tpu.indexmap import offheap as joffheap
from photon_ml_tpu_torch.convert import game_model_from_numpy
from photon_ml_tpu_torch.indexmap import DefaultIndexMap
from photon_ml_tpu_torch.indexmap import offheap
import photon_ml_tpu.serving as J
import photon_ml_tpu_torch.serving as T


def _glmix(seed: int, projector: str = "index_map"):
    _, _, _, coords = glmix_numpy(seed=seed, n=40, fe_dim=20, re_dim=12,
                                  projector=projector)
    jm = jax_game_model(coords)
    tm = game_model_from_numpy(coordinates_of_jax_model(jm), jm.task, device="cpu")
    return jm, tm


def _full_game(seed: int = 7, d: int = 10, k: int = 3, entities: int = 9):
    """FE + a factored coordinate (two buckets) in both packages."""
    import jax.numpy as jnp
    import torch

    from photon_ml_tpu.algorithm.factored_random_effect import (
        FactoredRandomEffectModel as JF,
    )
    from photon_ml_tpu.models.game import CoordinateMeta as JMeta, GameModel as JGame
    from photon_ml_tpu.models.random_effect import RandomEffectModel as JRE
    from photon_ml_tpu.projector import ProjectorType as JP
    from photon_ml_tpu.types import TaskType as JT
    from photon_ml_tpu_torch.algorithm.factored_random_effect import (
        FactoredRandomEffectModel as TF,
    )
    from photon_ml_tpu_torch.models.game import CoordinateMeta as TMeta, GameModel as TGame
    from photon_ml_tpu_torch.models.random_effect import RandomEffectModel as TRE
    from photon_ml_tpu_torch.projector import ProjectorType as TP
    from photon_ml_tpu_torch.types import TaskType as TT

    rng = np.random.default_rng(seed)
    fe = rng.standard_normal(d).astype(np.float32)
    B = rng.standard_normal((d, k)).astype(np.float32)
    ids = [[f"m{e}" for e in range(0, entities, 2)], [f"m{e}" for e in range(1, entities, 2)]]
    lat = [rng.standard_normal((len(b) + 1, k)).astype(np.float32) for b in ids]  # a pad lane
    lat[0][0] = 0.0  # an all-zero latent row packs to a zero row
    pidx = [np.tile(np.arange(k), (len(w), 1)) for w in lat]
    valid = [np.ones_like(p, dtype=bool) for p in pidx]
    loc = {eid: (b, e) for b, blk in enumerate(ids) for e, eid in enumerate(blk)}

    def models(pkg):
        if pkg == "jax":
            from photon_ml_tpu.models.coefficients import Coefficients
            from photon_ml_tpu.models.glm import GeneralizedLinearModel

            latent = JRE("movieId", JT.LINEAR_REGRESSION, [jnp.asarray(w) for w in lat],
                         [None, None], [jnp.asarray(p, dtype=jnp.int32) for p in pidx],
                         [jnp.asarray(v) for v in valid], ids, loc, k, JP.IDENTITY)
            return JGame(
                models={"fixed": GeneralizedLinearModel(Coefficients(means=jnp.asarray(fe)),
                                                        JT.LINEAR_REGRESSION),
                        "mf": JF("movieId", JT.LINEAR_REGRESSION, latent, jnp.asarray(B))},
                meta={"fixed": JMeta("g"), "mf": JMeta("m", "movieId")},
                task=JT.LINEAR_REGRESSION,
            )
        from photon_ml_tpu_torch.models.coefficients import Coefficients
        from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel

        latent = TRE("movieId", TT.LINEAR_REGRESSION, [torch.from_numpy(w) for w in lat],
                     [None, None], [torch.from_numpy(p.astype(np.int64)) for p in pidx],
                     [torch.from_numpy(v) for v in valid], ids, loc, k, TP.IDENTITY)
        return TGame(
            models={"fixed": GeneralizedLinearModel(Coefficients(means=torch.from_numpy(fe)),
                                                    TT.LINEAR_REGRESSION),
                    "mf": TF("movieId", TT.LINEAR_REGRESSION, latent, torch.from_numpy(B))},
            meta={"fixed": TMeta("g"), "mf": TMeta("m", "movieId")},
            task=TT.LINEAR_REGRESSION,
        )

    return models("jax"), models("port")


def _maps():
    names = ["(INTERCEPT)", "f\x01a", "f\x01b", "é\x01x", "z"]
    # indices kept as given (not dense, not in key order)
    return {"g": dict(zip(names, [4, 0, 7, 2, 9]))}


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _pack_both(kind):
    if kind == "glmix":
        jm, tm = _glmix(1)
    elif kind == "random_projection":
        jm, tm = _glmix(2, projector="random")
    else:
        jm, tm = _full_game()
    maps = _maps()
    from photon_ml_tpu.indexmap import DefaultIndexMap as JMap

    ja = J.pack_game_model(jm, index_maps={s: JMap(m) for s, m in maps.items()},
                           model_name="m", configurations={"a": 1, "tuned_config": {"x": 2}})
    ta = T.pack_game_model(tm, index_maps={s: DefaultIndexMap(m) for s, m in maps.items()},
                           model_name="m", configurations={"a": 1, "tuned_config": {"x": 2}})
    return ja, ta


KINDS = ["glmix", "random_projection", "full_game"]


@pytest.mark.parametrize("kind", KINDS)
def test_pack_equals_jax_bitwise(kind):
    ja, ta = _pack_both(kind)
    assert sorted(ja.tables) == sorted(ta.tables)
    for cid, jt in ja.tables.items():
        tt = ta.tables[cid]
        assert (tt.feature_shard, tt.random_effect_type) == (jt.feature_shard, jt.random_effect_type)
        np.testing.assert_array_equal(tt.weights.view(np.uint32), np.asarray(jt.weights).view(np.uint32))
        if jt.is_random_effect:
            assert dict(tt.entity_index.items()) == dict(jt.entity_index.items())
    assert ta.tuned_config == ja.tuned_config == {"x": 2}
    assert ta.configurations == ja.configurations == {"a": 1}
    assert ta.shard_dims() == ja.shard_dims()
    assert ta.random_effect_types() == ja.random_effect_types()


@pytest.fixture
def jax_plain_writer(monkeypatch):
    """The JAX package's PHIX stores written by its pure-Python writer."""
    monkeypatch.setattr(joffheap, "_lib", None)
    monkeypatch.setattr(joffheap, "_lib_failed", True)


@pytest.mark.parametrize("kind", KINDS)
def test_saved_files_byte_equal_jax(tmp_path, jax_plain_writer, kind):
    ja, ta = _pack_both(kind)
    J.save_artifact(ja, str(tmp_path / "jax"))
    T.save_artifact(ta, str(tmp_path / "port"))
    jf, tf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(tf) == sorted(jf)
    assert any(f.endswith("table.npy") for f in tf) and "model-metadata.json" in tf
    for f in tf:
        assert tf[f] == jf[f], f


def _meaningful(raw: bytes) -> bytes:
    """A PHIX file with the key length and index of empty forward slots
    zeroed (bytes no reader looks at)."""
    _, _, slots, _, fwd_off, _, _, _ = offheap._HEADER.unpack_from(raw, 0)
    out = bytearray(raw)
    for s in range(slots):
        at = fwd_off + 16 * s
        if struct.unpack_from("<Q", raw, at)[0] == 0xFFFFFFFFFFFFFFFF:
            out[at + 8:at + 16] = bytes(8)
    return bytes(out)


def test_saved_files_equal_jax_native_on_every_read_byte(tmp_path):
    ja, ta = _pack_both("glmix")
    J.save_artifact(ja, str(tmp_path / "jax"))
    T.save_artifact(ta, str(tmp_path / "port"))
    jf, tf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(tf) == sorted(jf)
    for f in tf:
        want = _meaningful(jf[f]) if f.endswith(".bin") else jf[f]
        assert tf[f] == want, f


def test_native_single_partition_writer_equals_plain_version(tmp_path):
    keys = [k.encode() for k in ["b", "a", "é\x01x", "(INTERCEPT)", "zz"]]
    idx = np.array([7, 1, 30, 0, 4], dtype=np.uint32)
    offheap.build_partition(str(tmp_path / "n.bin"), keys, idx)
    offheap._build_partition_python(str(tmp_path / "p.bin"), keys, idx)
    assert (tmp_path / "n.bin").read_bytes() == (tmp_path / "p.bin").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_artifact(tmp_path, writer):
    ja, ta = _pack_both("full_game")
    out = str(tmp_path / "a")
    (J.save_artifact(ja, out) if writer == "jax" else T.save_artifact(ta, out))
    jl, tl = J.load_artifact(out), T.load_artifact(out)
    assert jl.task.name == tl.task.name and jl.model_name == tl.model_name == "m"
    assert jl.configurations == tl.configurations
    assert jl.tuned_config == tl.tuned_config == {"x": 2}
    for cid, jt in jl.tables.items():
        tt = tl.tables[cid]
        np.testing.assert_array_equal(np.asarray(tt.weights), np.asarray(jt.weights))
        if jt.is_random_effect:
            ids = sorted(dict(ta.tables[cid].entity_index.items())) + ["ghost"]
            np.testing.assert_array_equal(tt.entity_index.get_indices(ids),
                                          jt.entity_index.get_indices(ids))
            assert tl.entity_row(cid, ids[0]) == jl.entity_row(cid, ids[0])
    names = sorted(_maps()["g"]) + ["nope"]
    np.testing.assert_array_equal(tl.feature_index["g"].get_indices(names),
                                  jl.feature_index["g"].get_indices(names))


def test_tuned_config_round_trips(tmp_path):
    _, ta = _pack_both("glmix")
    out = str(tmp_path / "a")
    T.save_artifact(ta, out)
    assert T.load_tuned_config(out) is None
    tuned = {"serving.bucket_sizes": [1, 4, 16], "serving.max_nnz": 8}
    path = T.save_tuned_config(out, tuned, provenance={"source": "test"})
    assert os.path.basename(path) == "tuned-config.json"
    assert T.load_tuned_config(out) == tuned == J.load_tuned_config(out)
    # the sidecar overrides the metadata's tuned section, in both packages
    assert T.load_artifact(out).tuned_config == tuned == J.load_artifact(out).tuned_config
    J.save_tuned_config(out, {"serving.max_nnz": 4})
    assert T.load_tuned_config(out) == {"serving.max_nnz": 4}


def test_save_is_atomic_over_an_existing_artifact(tmp_path):
    from photon_ml_tpu_torch.io.model_io import save_game_model_metadata
    from photon_ml_tpu_torch.types import TaskType

    _, ta = _pack_both("glmix")
    out = str(tmp_path / "a")
    T.save_artifact(ta, out)
    T.save_artifact(ta, out)  # replaces in place, leaves no temporaries
    assert sorted(os.listdir(tmp_path)) == ["a"]
    save_game_model_metadata(str(tmp_path / "plain"), TaskType.LINEAR_REGRESSION)
    with pytest.raises(ValueError, match="not a serving artifact"):
        T.load_artifact(str(tmp_path / "plain"))
