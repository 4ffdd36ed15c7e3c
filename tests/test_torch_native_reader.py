"""The port's native columnar Avro reader (``io/native_reader.py``,
``native/avrodecode.cpp``) against the JAX package's native reader and the
port's own Python codec.

- ``read_game_data`` on the native path gives the JAX native reader's
  ``GameData``, uids, id tags and index maps, array for array and key for
  key (feature keys numbered per bag stream, intercepts after all bag
  entries), with and without fixed index maps;
- the port's native and Python paths hold the same data up to the
  feature-index permutation;
- ``file_row_counts``, ``list_data_files`` and ``iter_game_data`` equal
  the JAX package's;
- a chunked decode (``block_start`` / ``block_count``) is bitwise the
  matching rows of a whole-file decode, and container block counts sum to
  the row count;
- the fallback to the Python codec on an unsupported schema is taken where
  the JAX package takes it; a corrupt record count yields a null handle; a
  missing tag or label raises; a source that does not compile raises;
- the packed decode releases the interpreter lock (ctypes flags, no
  timing).

Mirrors the JAX package's tests/test_native_reader.py.
"""

import ctypes
import os
import shutil

import numpy as np
import pytest

from photon_ml_tpu.io import data_reader as jdr
from photon_ml_tpu.io import native_reader as jnr
from photon_ml_tpu_torch.io import data_reader as dr
from photon_ml_tpu_torch.io import native_reader as nr
from photon_ml_tpu_torch.io import schemas as _schemas
from photon_ml_tpu_torch.io.avro import (
    MAGIC,
    SYNC_SIZE,
    AvroSchema,
    _decode,
    _encode,
    _Reader,
    write_avro_file,
)
from photon_ml_tpu_torch.io.data_reader import read_game_data, write_training_examples
from photon_ml_tpu_torch.utils import nativelib


def _records(rng, n=300):
    recs = []
    for i in range(n):
        rec = {
            "uid": f"r{i}",
            "label": float(rng.integers(0, 2)),
            "features": [
                ("f", str(j), float(v))
                for j, v in zip(rng.choice(40, 4, replace=False), rng.standard_normal(4))
            ],
            "userFeatures": [("u", str(i % 3), 1.0)],
            "metadataMap": {"userId": f"u{i % 7}"},
        }
        if i % 3 == 0:
            rec["weight"] = 2.0
        if i % 4 == 0:
            rec["offset"] = 0.5
        recs.append(rec)
    return recs


@pytest.fixture
def avro_dir(tmp_path, rng):
    recs = _records(rng)
    d = tmp_path / "data"
    d.mkdir()
    write_training_examples(str(d / "part-0.avro"), recs[:200])
    write_training_examples(str(d / "part-1.avro"), recs[200:])
    return str(d)


def _shards(reader):
    return {
        "g": reader.FeatureShardConfiguration(feature_bags=["features"], add_intercept=True),
        "u": reader.FeatureShardConfiguration(feature_bags=["userFeatures"], add_intercept=False),
    }


SHARDS = _shards(dr)


def _assert_same(a, b):
    """Two (GameData, index maps, uids) triples: equal array for array,
    key for key."""
    da, ma, ua = a
    db, mb, ub = b
    for f in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(da, f), getattr(db, f))
    assert ua == ub
    assert sorted(da.id_tags) == sorted(db.id_tags)
    for tag in da.id_tags:
        np.testing.assert_array_equal(da.id_tags[tag], db.id_tags[tag])
    assert sorted(da.feature_shards) == sorted(db.feature_shards)
    for sid in da.feature_shards:
        sa, sb = da.feature_shards[sid], db.feature_shards[sid]
        assert sa.dim == sb.dim
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
        assert [ma[sid].get_feature_name(i) for i in range(len(ma[sid]))] == \
               [mb[sid].get_feature_name(i) for i in range(len(mb[sid]))]


def _densify(shard, n):
    m = np.zeros((n, shard.dim), np.float32)
    np.add.at(m, (shard.rows, shard.cols), shard.vals)
    return m


def test_native_path_is_taken(avro_dir):
    assert nr.native_available()
    got = dr._read_game_data_native(
        [avro_dir], SHARDS, None, ["userId"], "label", "offset", "weight", "uid", True,
    )
    assert got is not None


def test_native_read_equals_the_jax_native_reader(avro_dir):
    assert jnr.native_available()
    port = read_game_data([avro_dir], SHARDS, id_tags=["userId"])
    jax = jdr.read_game_data([avro_dir], _shards(jdr), id_tags=["userId"])
    _assert_same(port, jax)
    # the maps the two packages built, fed back for a scoring-style read
    _assert_same(
        read_game_data([avro_dir], SHARDS, index_maps=port[1], id_tags=["userId"]),
        jdr.read_game_data([avro_dir], _shards(jdr), index_maps=jax[1], id_tags=["userId"]),
    )
    # build_index_maps alone, native in both
    pm = dr.build_index_maps([avro_dir], SHARDS)
    jm = jdr.build_index_maps([avro_dir], _shards(jdr))
    for sid in SHARDS:
        assert dict(pm[sid].items()) == dict(jm[sid].items())


def test_native_read_matches_the_python_codec(avro_dir, monkeypatch):
    dn, mn, un = read_game_data([avro_dir], SHARDS, id_tags=["userId"])
    monkeypatch.setattr(dr, "_read_game_data_native", lambda *a: None)
    monkeypatch.setattr(dr, "_build_index_maps_native", lambda *a: None)
    dp, mp, up = read_game_data([avro_dir], SHARDS, id_tags=["userId"])
    for f in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(dn, f), getattr(dp, f))
    assert un == up
    np.testing.assert_array_equal(dn.id_tags["userId"], dp.id_tags["userId"])
    for sid in SHARDS:
        # the two paths number keys in different orders: compare by name
        names_n = [mn[sid].get_feature_name(i) for i in range(len(mn[sid]))]
        names_p = [mp[sid].get_feature_name(i) for i in range(len(mp[sid]))]
        assert sorted(names_n) == sorted(names_p)
        perm = [names_n.index(k) for k in names_p]
        np.testing.assert_array_equal(
            _densify(dn.feature_shards[sid], dn.num_rows)[:, perm],
            _densify(dp.feature_shards[sid], dp.num_rows),
        )


def test_scoring_with_fixed_index_map_drops_unmapped_features(avro_dir):
    from photon_ml_tpu_torch.indexmap import DefaultIndexMap

    maps = {"g": DefaultIndexMap({"f\x011": 0, "f\x012": 1, "(INTERCEPT)": 2}),
            "u": DefaultIndexMap({"u\x010": 0})}
    data, _, _ = read_game_data([avro_dir], SHARDS, index_maps=maps, id_tags=["userId"])
    jmaps = {sid: jdr.DefaultIndexMap(dict(m.items())) for sid, m in maps.items()}
    jdata, _, _ = jdr.read_game_data([avro_dir], _shards(jdr), index_maps=jmaps,
                                     id_tags=["userId"])
    for sid in SHARDS:
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(data.feature_shards[sid], f),
                                          getattr(jdata.feature_shards[sid], f))
    assert set(data.feature_shards["g"].cols.tolist()) <= {0, 1, 2}
    assert data.feature_shards["u"].dim == 1


def test_row_counts_and_file_iteration_equal_jax(avro_dir):
    assert dr.list_data_files(avro_dir) == jdr.list_data_files(avro_dir)
    assert dr.file_row_counts(avro_dir) == jdr.file_row_counts(avro_dir)
    assert [n for _, n in dr.file_row_counts([avro_dir])] == [200, 100]
    maps = dr.build_index_maps([avro_dir], SHARDS)
    jmaps = {sid: jdr.DefaultIndexMap(dict(m.items())) for sid, m in maps.items()}
    pieces = list(dr.iter_game_data(avro_dir, SHARDS, maps, id_tags=["userId"]))
    jpieces = list(jdr.iter_game_data(avro_dir, _shards(jdr), jmaps, id_tags=["userId"]))
    assert [p for p, _, _ in pieces] == [p for p, _, _ in jpieces]
    for (_, d, u), (_, jd, ju) in zip(pieces, jpieces):
        _assert_same((d, maps, u), (jd, jmaps, ju))
    with pytest.raises(ValueError, match="prebuilt index_maps"):
        next(dr.iter_game_data(avro_dir, SHARDS, None))


def test_missing_tag_raises(avro_dir):
    with pytest.raises(ValueError, match="missing id tag"):
        read_game_data([avro_dir], SHARDS, id_tags=["itemId"])


def _feature_bag_type():
    return {"type": "array", "items": {
        "type": "record", "name": "FeatureAvro",
        "fields": [{"name": "name", "type": "string"},
                   {"name": "term", "type": "string"},
                   {"name": "value", "type": "double"}],
    }}


def test_missing_label_raises(tmp_path):
    # nullable-label schema (RESPONSE_PREDICTION-style input)
    schema = {"type": "record", "name": "ScoredExample", "fields": [
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "features", "type": _feature_bag_type()},
    ]}
    path = str(tmp_path / "p.avro")
    write_avro_file(path, schema, [
        {"label": None, "features": [{"name": "f", "term": "1", "value": 1.0}]}])
    with pytest.raises(ValueError, match="has no 'label'"):
        read_game_data([path], {"g": SHARDS["g"]})
    data, _, _ = read_game_data([path], {"g": SHARDS["g"]}, is_response_required=False)
    assert np.isnan(data.labels[0])


def test_fallback_on_unsupported_schema_where_jax_falls_back(tmp_path, monkeypatch):
    # a record schema with a nested record field compiles to no program
    schema = {"type": "record", "name": "Odd", "fields": [
        {"name": "label", "type": "double"},
        {"name": "inner", "type": {"type": "record", "name": "Inner",
                                   "fields": [{"name": "x", "type": "double"}]}},
        {"name": "features", "type": _feature_bag_type()},
    ]}
    path = str(tmp_path / "odd.avro")
    write_avro_file(path, schema, [
        {"label": 1.0, "inner": {"x": 2.0},
         "features": [{"name": "f", "term": "1", "value": 3.0}]}])
    assert dr._read_game_data_native(
        [path], {"g": SHARDS["g"]}, None, [], "label", "offset", "weight", "uid", True) is None
    assert jdr._read_game_data_native(
        [path], {"g": _shards(jdr)["g"]}, None, [], "label", "offset", "weight", "uid",
        True) is None
    data, maps, _ = read_game_data([path], {"g": SHARDS["g"]})
    jdata, jmaps, _ = jdr.read_game_data([path], {"g": _shards(jdr)["g"]})
    assert data.num_rows == 1  # the python codec handled it
    _assert_same((data, maps, [None]), (jdata, jmaps, [None]))
    # the schemas io/schemas.py writes all compile
    root = AvroSchema(_schemas.TRAINING_EXAMPLE).root
    assert nr.compile_program(root, ["label"], ["uid"], ["features"], ["userId"]) is not None
    # a requested id tag with a numeric schema type falls back, as in JAX
    num_tag = {"type": "record", "name": "T", "fields": [
        {"name": "label", "type": "double"}, {"name": "userId", "type": "long"}]}
    assert nr.compile_program(num_tag, ["label"], ["userId"], []) is None
    assert jnr.compile_program(num_tag, ["label"], ["userId"], []) is None


def test_corrupt_record_count_no_crash(tmp_path):
    """A corrupted record count must come back as a null handle, never a
    process abort (the decoder's never-UB contract)."""
    path = str(tmp_path / "c.avro")
    write_training_examples(path, [{"uid": "a", "label": 1.0, "features": [("f", "1", 2.0)]}])
    with open(path, "rb") as f:
        raw = f.read()
    r = _Reader(raw)
    r.read(4)
    meta = _decode(r, {"type": "map", "values": "bytes"})
    plan = nr.compile_program(AvroSchema(meta["avro.schema"].decode()).root,
                              ["label"], [], ["features"])
    assert plan is not None
    lib = nr._load_native()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    blob = b"\x00" * 4
    h = lib.avro_decode(
        ctypes.cast(ctypes.c_char_p(blob), u8p), len(blob), 1 << 55,
        np.ascontiguousarray(plan.program).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(plan.program) // 3, len(plan.num_fields), plan.n_str_cols,
        len(plan.bag_fields), ctypes.cast(ctypes.c_char_p(b""), u8p),
        np.zeros(0, np.int32).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        0, plan.tag_col_base,
    )
    assert not h  # null handle, process alive


def _write_multiblock(tmp_path, rng, n=400):
    """One Avro file with many container blocks (a tiny sync interval)."""
    recs = [{
        "uid": f"r{i}", "label": float(rng.integers(0, 2)), "weight": 1.0 + (i % 3),
        "features": [{"name": "f", "term": str(j), "value": float(v)}
                     for j, v in zip(rng.choice(30, 3, replace=False), rng.standard_normal(3))],
        "metadataMap": {"userId": f"u{i % 5}"},
    } for i in range(n)]
    path = str(tmp_path / "multiblock.avro")
    write_avro_file(path, _schemas.TRAINING_EXAMPLE, recs, sync_interval=1024)
    return path


def _plan(path):
    with open(path, "rb") as f:
        raw = f.read()
    r = _Reader(raw)
    assert r.read(4) == MAGIC
    meta = _decode(r, {"type": "map", "values": "bytes"})
    plan = nr.compile_program(AvroSchema(meta["avro.schema"].decode()).root,
                              ["label", "weight", "offset"], ["uid"], ["features"], ["userId"])
    assert plan is not None
    return plan, raw


def test_container_block_counts_sum_to_rows(tmp_path, rng):
    path = _write_multiblock(tmp_path, rng)
    counts = nr.container_block_counts(path)
    assert len(counts) > 4
    assert sum(counts) == 400 and all(c > 0 for c in counts)
    assert counts == jnr.container_block_counts(path)


@pytest.mark.parametrize("count", [1, 2])
def test_chunked_decode_bitwise_identical(tmp_path, rng, count):
    path = _write_multiblock(tmp_path, rng)
    plan, raw = _plan(path)
    counts = nr.container_block_counts(path, data=raw)
    whole = nr.read_columnar_file(path, plan, data=raw)
    assert whole is not None
    row = 0
    for start in range(len(counts)):
        part = nr.read_columnar_file(path, plan, data=raw, block_start=start, block_count=count)
        lo, hi = row, row + sum(counts[start:start + count])
        assert part.n_rows == hi - lo
        for name in ("label", "weight"):
            np.testing.assert_array_equal(part.num[name], whole.num[name][lo:hi])
            np.testing.assert_array_equal(part.num_present[name], whole.num_present[name][lo:hi])
        prec, pval, pkoff, pklen = part.bags["features"]
        wrec, wval, wkoff, wklen = whole.bags["features"]
        sel = (wrec >= lo) & (wrec < hi)
        np.testing.assert_array_equal(prec + lo, wrec[sel])
        np.testing.assert_array_equal(pval, wval[sel])
        assert [part.key_arena[o:o + n] for o, n in zip(pkoff, pklen)] == \
               [whole.key_arena[o:o + n] for o, n in zip(wkoff[sel], wklen[sel])]
        for col_of in ("strs", "tag_strs"):
            for name, (pa, po, pl) in getattr(part, col_of).items():
                wa, wo, wl = getattr(whole, col_of)[name]
                assert [pa[o:o + n] for o, n in zip(po, pl)] == \
                       [wa[o:o + n] for o, n in zip(wo[lo:hi], wl[lo:hi])]
        row += counts[start]


def test_chunked_decode_tail_and_bounds(tmp_path, rng):
    path = _write_multiblock(tmp_path, rng)
    plan, raw = _plan(path)
    counts = nr.container_block_counts(path, data=raw)
    assert nr.read_columnar_file(path, plan, data=raw, block_start=2).n_rows == sum(counts[2:])
    part = nr.read_columnar_file(path, plan, data=raw, block_start=len(counts) - 1,
                                 block_count=99)
    assert part.n_rows == counts[-1]
    with pytest.raises(ValueError, match="out of range"):
        nr.read_columnar_file(path, plan, data=raw, block_start=len(counts) + 1)


def test_unsupported_codec_counts_raise(tmp_path):
    path = str(tmp_path / "weird.avro")
    with open(path, "wb") as f:
        f.write(MAGIC)
        _encode(f, {"type": "map", "values": "bytes"},
                {"avro.schema": b'"null"', "avro.codec": b"snappy"})
        f.write(b"\x00" * SYNC_SIZE)
    with pytest.raises(ValueError, match="unsupported avro codec"):
        nr.container_block_counts(path)


def test_packed_decode_releases_the_interpreter_lock(tmp_path, rng):
    """ctypes releases the GIL around a foreign call exactly when the
    function pointer lacks FUNCFLAG_PYTHONAPI (a CDLL, not a PyDLL): the
    whole inflate + decode of a file then runs without the lock."""
    lib = nr._load_native()
    assert not isinstance(lib, ctypes.PyDLL)
    assert lib.avro_decode_packed._flags_ & ctypes._FUNCFLAG_PYTHONAPI == 0
    # and the call decodes a deflate file in one go
    path = str(tmp_path / "d.avro")
    write_avro_file(path, _schemas.TRAINING_EXAMPLE, [
        {"uid": f"r{i}", "label": 1.0, "features": [], "metadataMap": {"userId": "u"}}
        for i in range(50)], codec="deflate")
    plan, raw = _plan(path)
    assert nr.read_columnar_file(path, plan, data=raw).n_rows == 50


def test_a_decoder_that_does_not_build_raises(tmp_path, avro_dir, monkeypatch):
    """No quiet fallback on a broken toolchain or source: the build error
    surfaces (the reference returns None and reads with Python)."""
    native = tmp_path / "native"
    native.mkdir()
    (native / "avrodecode.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(nativelib, "NATIVE_DIR", native)
    monkeypatch.setattr(nativelib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nativelib, "_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for native/avrodecode.cpp"):
        nr.native_available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        read_game_data([avro_dir], SHARDS)


def test_the_library_name_covers_source_and_link_flags():
    plain = nativelib.library_path("avrodecode")
    linked = nativelib.library_path("avrodecode", ("-lz",))
    assert plain != linked
    assert linked.parent == nativelib.BUILD_DIR
    assert linked == nativelib.library_path("avrodecode", nr.LDFLAGS)
    assert not str(linked).startswith(os.path.dirname(jnr.__file__))
    assert shutil.which("g++")
