"""The nearline loop's training half: the port's ``incremental`` package
against the JAX package's, on one model fitted by the JAX package and
carried into the port.

- ``incremental_update`` with 0 and 1 fixed-effect refreshes, merged or
  not: the same touched and new entities, re-solved rows within atol 2e-3,
  the events' squared-error objective of the updated model within rtol
  1e-4, and a factored coordinate passed through untouched.
- Delta directories are byte-equal to the JAX package's for the same
  numbers, with equal fingerprints; a delta built by one package chains
  onto the other's artifact.
- ``apply_delta``, ``compact``, ``verify_chain``, ``rebase_delta``,
  ``discover_deltas`` and ``OverlayIndexMap`` agree; a broken chain raises
  in both packages.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from _torch_nearline_parity import (
    NEW,
    TOUCHED,
    UNTOUCHED,
    estimators,
    jax_plain_phix_writer,
    make_nearline,
)
import photon_ml_tpu.incremental as JI
import photon_ml_tpu.serving as J
import photon_ml_tpu_torch.incremental as TI
import photon_ml_tpu_torch.serving as T
from photon_ml_tpu_torch.convert import delta_from_numpy, delta_to_numpy


@pytest.fixture(scope="module")
def nl(tmp_path_factory):
    return make_nearline(str(tmp_path_factory.mktemp("nearline")))


@pytest.fixture(scope="module")
def updates(nl):
    """Both packages' updates for each (refresh, merge)."""
    je, te = estimators()
    out = {}
    for refresh in (0, 1):
        for merge in (True, False):
            out[refresh, merge] = (
                JI.incremental_update(je, nl["jmodel"], nl["jevents"],
                                      refresh_fixed_iterations=refresh, merge=merge),
                TI.incremental_update(te, nl["tmodel"], nl["tevents"],
                                      refresh_fixed_iterations=refresh, merge=merge),
            )
    return out


def _sq_objective(scores, labels) -> float:
    """0.5 * the sum of squared residuals of the updated model's scores."""
    s = scores.double().numpy() if isinstance(scores, torch.Tensor) else np.asarray(scores)
    return float(0.5 * ((s.astype(np.float64) - np.asarray(labels, np.float64)) ** 2).sum())


@pytest.mark.parametrize("refresh", [0, 1])
@pytest.mark.parametrize("merge", [True, False])
def test_incremental_update_matches_jax(nl, updates, refresh, merge):
    ju, tu = updates[refresh, merge]
    assert tu.touched_entities == ju.touched_entities
    assert set(tu.touched_entities["per_user"]) == set(TOUCHED + NEW)
    assert tu.new_entities == ju.new_entities == {"per_user": tuple(sorted(NEW))}
    assert tu.num_events == ju.num_events == nl["tevents"].num_rows
    assert sorted(tu.fe_updates) == sorted(ju.fe_updates) == (["fixed"] if refresh else [])
    for cid, w in ju.fe_updates.items():
        np.testing.assert_allclose(tu.fe_updates[cid], np.asarray(w), atol=2e-3)
    assert sorted(tu.re_updates) == sorted(ju.re_updates)
    for cid, rows in ju.re_updates.items():
        assert sorted(tu.re_updates[cid]) == sorted(rows)
        for eid, coefs in rows.items():
            got = tu.re_updates[cid][eid]
            assert sorted(got) == sorted(coefs)
            np.testing.assert_allclose([got[k] for k in sorted(got)],
                                       [coefs[k] for k in sorted(coefs)], atol=2e-3)
    # the solver's per-bucket telemetry comes through from the re-solves
    assert [s.num_entities for s in tu.solver_stats["per_user"]] == [
        s.num_entities for s in ju.solver_stats["per_user"]]
    assert tu.transfer_stats["per_user"].coordinate_updates == 1
    sub = tu.models["per_user"]
    want = ({f"u{i}" for i in range(8)} | set(NEW)) if merge else set(TOUCHED + NEW)
    assert set(sub.entity_to_loc) == set(ju.models["per_user"].entity_to_loc) == want
    if merge:
        # untouched entities keep their exact old coefficients
        old, now = dict(nl["tmodel"].models["per_user"].items()), dict(sub.items())
        for eid in UNTOUCHED:
            assert now[eid] == old[eid]
    je, te = estimators()
    tobj = _sq_objective(tu.game_model(te).score(nl["tevents"]), nl["tevents"].labels)
    jobj = _sq_objective(ju.game_model(je).score(nl["jevents"]), nl["jevents"].labels)
    assert tobj == pytest.approx(jobj, rel=1e-4)


def _factored_models(nl):
    """Both packages' sub-models plus one factored coordinate over userId
    (k = 2) with seeded latents and projection."""
    import jax.numpy as jnp
    from photon_ml_tpu.algorithm.factored_random_effect import (
        FactoredRandomEffectModel as JMF,
    )
    from photon_ml_tpu.models.random_effect import RandomEffectModel as JRE
    from photon_ml_tpu.projector import ProjectorType as JPT
    from photon_ml_tpu.types import TaskType as JTask
    from photon_ml_tpu_torch.algorithm.factored_random_effect import (
        FactoredRandomEffectModel as TMF,
    )
    from photon_ml_tpu_torch.models.random_effect import RandomEffectModel as TRE
    from photon_ml_tpu_torch.projector import ProjectorType as TPT
    from photon_ml_tpu_torch.types import TaskType as TTask

    rng = np.random.default_rng(5)
    ids = [f"u{i}" for i in range(8)]
    lat = rng.normal(size=(8, 2)).astype(np.float32) * 0.1
    B = rng.normal(size=(3, 2)).astype(np.float32)
    idx, ok = np.tile(np.arange(2), (8, 1)), np.ones((8, 2), bool)
    common = dict(random_effect_type="userId", entity_ids=[ids],
                  entity_to_loc={e: (0, i) for i, e in enumerate(ids)}, global_dim=2)
    jmf = JMF("userId", JTask.LINEAR_REGRESSION, JRE(
        task=JTask.LINEAR_REGRESSION, coefficients=[jnp.asarray(lat)], variances=[None],
        proj_indices=[jnp.asarray(idx, dtype=jnp.int32)], proj_valid=[jnp.asarray(ok)],
        projector_type=JPT.IDENTITY, **common), jnp.asarray(B))
    tmf = TMF("userId", TTask.LINEAR_REGRESSION, TRE(
        task=TTask.LINEAR_REGRESSION, coefficients=[torch.from_numpy(lat)], variances=[None],
        proj_indices=[torch.from_numpy(idx)], proj_valid=[torch.from_numpy(ok)],
        projector_type=TPT.IDENTITY, **common), torch.from_numpy(B))
    return ({**nl["jmodel"].models, "mf": jmf}, {**nl["tmodel"].models, "mf": tmf})


def test_factored_coordinate_passes_through(nl):
    jmodels, tmodels = _factored_models(nl)
    je, te = estimators(factored=True)
    ju = JI.incremental_update(je, jmodels, nl["jevents"], refresh_fixed_iterations=1)
    tu = TI.incremental_update(te, tmodels, nl["tevents"], refresh_fixed_iterations=1)
    assert tu.models["mf"] is tmodels["mf"] and ju.models["mf"] is jmodels["mf"]
    assert sorted(tu.re_updates) == sorted(ju.re_updates) == ["per_user"]
    for eid, coefs in ju.re_updates["per_user"].items():
        got = tu.re_updates["per_user"][eid]
        np.testing.assert_allclose([got[k] for k in sorted(got)],
                                   [coefs[k] for k in sorted(coefs)], atol=2e-3)
    np.testing.assert_allclose(tu.fe_updates["fixed"], np.asarray(ju.fe_updates["fixed"]),
                               atol=2e-3)


def _files(root) -> dict:
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            out[os.path.relpath(os.path.join(d, f), root)] = open(os.path.join(d, f), "rb").read()
    return out


@pytest.fixture(scope="module")
def deltas(nl, updates, tmp_path_factory):
    """Both packages' deltas of the same numbers (the JAX update's rows and
    FE vector), saved; generation 1 rooted at the base fingerprint."""
    root = tmp_path_factory.mktemp("deltas")
    ju, _ = updates[1, False]
    fp = JI.fingerprint_dir(nl["jdir"])
    jd = JI.build_delta(ju.re_updates, nl["ja"], fe_updates=ju.fe_updates,
                        base_fingerprint=fp, generation=1, created_at_unix=100.0)
    td = TI.build_delta(ju.re_updates, nl["ta"],
                        fe_updates={c: np.asarray(w) for c, w in ju.fe_updates.items()},
                        base_fingerprint=fp, generation=1, created_at_unix=100.0)
    jd = JI.save_delta(jd, str(root / "jax" / JI.delta_dir_name(1)))
    td = TI.save_delta(td, str(root / "port" / TI.delta_dir_name(1)))
    return {"root": root, "jd": jd, "td": td, "fp": fp,
            "jdir": str(root / "jax" / JI.delta_dir_name(1)),
            "tdir": str(root / "port" / TI.delta_dir_name(1))}


def test_delta_files_byte_equal_jax(nl, deltas, tmp_path):
    assert TI.fingerprint_dir(nl["tdir"]) == JI.fingerprint_dir(nl["jdir"]) == deltas["fp"]
    jf, tf = _files(deltas["jdir"]), _files(deltas["tdir"])
    assert sorted(tf) == sorted(jf) == ["delta-manifest.json", "fixed-effect/fixed.npy",
                                        "random-effect/per_user/rows.npy"]
    for f in tf:
        assert tf[f] == jf[f], f
    assert deltas["td"].fingerprint == deltas["jd"].fingerprint == TI.fingerprint_dir(
        deltas["tdir"]) == JI.fingerprint_dir(deltas["jdir"])
    # the JAX delta's numbers carried through convert save to the same bytes
    carried = TI.save_delta(delta_from_numpy(deltas["jd"]), str(tmp_path / "carried"))
    assert _files(tmp_path / "carried") == tf and carried.fingerprint == deltas["jd"].fingerprint
    back = delta_to_numpy(carried)
    assert back["re_rows"]["per_user"][0] == deltas["jd"].re_rows["per_user"][0]
    np.testing.assert_array_equal(back["re_rows"]["per_user"][1],
                                  deltas["jd"].re_rows["per_user"][1])
    again = TI.save_delta(delta_from_numpy(back), str(tmp_path / "again"))
    assert _files(tmp_path / "again") == tf and again.fingerprint == carried.fingerprint


def test_load_delta_reads_the_other_packages_files(deltas):
    for load, path, other in ((TI.load_delta, deltas["jdir"], deltas["td"]),
                              (JI.load_delta, deltas["tdir"], deltas["jd"])):
        d = load(path)
        assert (d.fingerprint, d.base_fingerprint, d.generation, d.created_at_unix) == (
            other.fingerprint, other.base_fingerprint, other.generation, other.created_at_unix)
        assert d.coordinates() == other.coordinates() == ("fixed", "per_user")
        assert d.num_rows_updated == other.num_rows_updated == len(TOUCHED + NEW)
        ids, rows = d.re_rows["per_user"]
        assert list(ids) == list(other.re_rows["per_user"][0])
        np.testing.assert_array_equal(np.asarray(rows), np.asarray(other.re_rows["per_user"][1]))


def _same_artifact(ja, ta):
    assert sorted(ta.tables) == sorted(ja.tables)
    for cid, jt in ja.tables.items():
        tt = ta.tables[cid]
        np.testing.assert_array_equal(np.asarray(tt.weights).view(np.uint32),
                                      np.asarray(jt.weights).view(np.uint32))
        if jt.is_random_effect:
            names = [f"u{i}" for i in range(8)] + NEW + ["nobody"]
            np.testing.assert_array_equal(tt.entity_index.get_indices(names),
                                          jt.entity_index.get_indices(names))
            assert len(tt.entity_index) == len(jt.entity_index)
            n = len(jt.entity_index)
            assert [tt.entity_index.get_feature_name(i) for i in range(n)] == [
                jt.entity_index.get_feature_name(i) for i in range(n)]


def test_apply_delta_matches_jax(nl, deltas):
    jart = JI.apply_delta(nl["ja"], deltas["jd"])
    tart = TI.apply_delta(nl["ta"], deltas["td"])
    _same_artifact(jart, tart)
    assert isinstance(tart.tables["per_user"].entity_index, TI.OverlayIndexMap)
    # the input artifact is not mutated
    _same_artifact(nl["ja"], nl["ta"])


def test_compact_matches_jax(nl, updates, deltas, tmp_path):
    """A chain of two deltas, compacted by each package: the same
    artifact, bitwise, byte-equal files, equal fingerprints; and the port
    compacts the JAX package's chain over its own base to the same
    bytes."""
    ju, _ = updates[0, True]
    scaled = {c: {e: {k: 0.5 * v for k, v in m.items()} for e, m in rows.items()}
              for c, rows in ju.re_updates.items()}
    j2 = JI.save_delta(JI.build_delta(scaled, nl["ja"], base_fingerprint=deltas["jd"].fingerprint,
                                      generation=2, created_at_unix=200.0),
                       str(deltas["root"] / "jax" / JI.delta_dir_name(2)))
    t2 = TI.save_delta(TI.build_delta(scaled, nl["ta"], base_fingerprint=deltas["td"].fingerprint,
                                      generation=2, created_at_unix=200.0),
                       str(deltas["root"] / "port" / TI.delta_dir_name(2)))
    assert t2.fingerprint == j2.fingerprint
    jchain = JI.discover_deltas(str(deltas["root"] / "jax"))
    tchain = TI.discover_deltas(str(deltas["root"] / "port"))
    assert [os.path.basename(p) for p in tchain] == [os.path.basename(p) for p in jchain] == [
        "delta-000001", "delta-000002"]
    with jax_plain_phix_writer():
        jfp = JI.compact(nl["jdir"], jchain, str(tmp_path / "jc"))
    tfp = TI.compact(nl["tdir"], tchain, str(tmp_path / "tc"))
    cross = TI.compact(nl["jdir"], jchain, str(tmp_path / "xc"))
    assert tfp == jfp == cross == TI.fingerprint_dir(str(tmp_path / "tc"))
    assert _files(tmp_path / "tc") == _files(tmp_path / "jc")
    folded = TI.apply_delta(TI.apply_delta(nl["ta"], deltas["td"]), t2)
    reloaded = T.load_artifact(str(tmp_path / "tc"))
    _same_artifact(J.load_artifact(str(tmp_path / "jc")), reloaded)
    for cid, table in folded.tables.items():
        np.testing.assert_array_equal(np.asarray(reloaded.tables[cid].weights),
                                      np.asarray(table.weights))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_broken_chain_raises_in_both(deltas, pkg):
    I, d = (JI, deltas["jd"]) if pkg == "jax" else (TI, deltas["td"])
    bogus = dataclasses.replace(d, base_fingerprint="0" * 16, generation=2,
                                fingerprint="f" * 16)
    with pytest.raises(ValueError, match="chain broken at position 1"):
        I.verify_chain(deltas["fp"], [d, bogus])
    I.verify_chain(deltas["fp"], [d])
    moved = I.rebase_delta(d, "a" * 16)
    assert (moved.base_fingerprint, moved.fingerprint) == ("a" * 16, None)
    assert d.base_fingerprint == deltas["fp"]
    I.verify_chain("a" * 16, [moved])
    with pytest.raises(ValueError, match="chain broken"):
        I.verify_chain("a" * 16, [d])


def test_discover_and_overlay_index_map_match_jax(nl, deltas, tmp_path):
    for I, sub in ((JI, "j"), (TI, "t")):
        d = str(tmp_path / sub)
        os.makedirs(os.path.join(d, "delta-000002"))
        assert I.discover_deltas(d) == [] and I.discover_deltas(str(tmp_path / "none")) == []
        for g in (2, 1):
            I.save_delta(deltas["td"], os.path.join(d, I.delta_dir_name(g)))
        assert [os.path.basename(p) for p in I.discover_deltas(d)] == [
            "delta-000001", "delta-000002"]
    assert TI.delta_dir_name(42) == JI.delta_dir_name(42) == "delta-000042"
    jbase = nl["ja"].tables["per_user"].entity_index
    tbase = nl["ta"].tables["per_user"].entity_index
    n = len(tbase)
    jo, to = JI.OverlayIndexMap(jbase, {"v0": n, "v1": n + 1}), TI.OverlayIndexMap(
        tbase, {"v0": n, "v1": n + 1})
    names = ["v1", "u3", "nobody", "v0", "u0"]
    np.testing.assert_array_equal(to.get_indices(names), jo.get_indices(names))
    assert len(to) == len(jo) == n + 2
    assert [to.get_feature_name(i) for i in range(n + 2)] == [
        jo.get_feature_name(i) for i in range(n + 2)]
    assert to.get_index("v0") == n and to.get_index("u0") == tbase.get_index("u0")


def test_build_delta_refuses_what_the_artifact_lacks(nl):
    for I, art in ((JI, nl["ja"]), (TI, nl["ta"])):
        with pytest.raises(ValueError, match="not a random effect"):
            I.build_delta({"fixed": {}}, art)
        with pytest.raises(ValueError, match="base artifact expects"):
            I.build_delta({}, art, fe_updates={"fixed": np.zeros(2)})
