"""The port's index maps (``indexmap/__init__.py``) and off-heap PHIX store
(``indexmap/offheap.py``, ``native/indexstore.cpp``) against the JAX
package's.

- stores built by the port are byte-equal to the JAX package's plain
  (Python) writer for 1 and 4 partitions, and to the port's own plain
  writer; against the JAX package's native builder they differ only in the
  key length and index bytes of empty forward slots, which its ``malloc``
  leaves unset (the port's builder zeroes them);
- the port reads JAX-built stores and the JAX package reads the port's;
- the native reader and hash against their plain versions, lookup for
  lookup;
- FNV-1a reference vectors, duplicate keys rejected, ``content_digest``.

Mirrors the JAX package's tests/test_indexmap.py.
"""

import os
import struct

import numpy as np
import pytest

from photon_ml_tpu.indexmap import DefaultIndexMap as JaxDefaultIndexMap
from photon_ml_tpu.indexmap import offheap as joffheap
from photon_ml_tpu_torch.indexmap import (
    INTERCEPT_KEY,
    DefaultIndexMap,
    IndexMap,
    feature_key,
)
from photon_ml_tpu_torch.indexmap import offheap
from photon_ml_tpu_torch.indexmap.offheap import (
    OffHeapIndexMap,
    build_offheap_index_map,
    fnv1a_hashes,
)


def _names(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    names = [feature_key(f"feat{i}", f"t{rng.integers(0, 10)}") for i in range(n)]
    # non-ASCII keys sort by UTF-8 bytes, i.e. by code point
    return names + ["é\x01x", "中\x01y", "z", INTERCEPT_KEY, names[0]]


@pytest.fixture
def jax_plain_writer(monkeypatch):
    """The JAX package's builder on its pure-Python writer."""
    monkeypatch.setattr(joffheap, "_lib", None)
    monkeypatch.setattr(joffheap, "_lib_failed", True)


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_default_index_map_matches_jax():
    m = DefaultIndexMap.from_names(["b", "a", "b", "c"], add_intercept=True)
    jm = JaxDefaultIndexMap.from_names(["b", "a", "b", "c"], add_intercept=True)
    assert dict(m.items()) == dict(jm.items())
    assert m.get_index("zzz") == -1 and m.get_feature_name(99) is None
    np.testing.assert_array_equal(m.get_indices(["b", "missing", "a"]), [1, -1, 0])
    np.testing.assert_array_equal(IndexMap.get_indices(m, ["c", "x"]), [2, -1])
    assert m.content_digest() == jm.content_digest() == IndexMap.content_digest(m)
    perm = DefaultIndexMap({"a": 1, "b": 0, "c": 2, INTERCEPT_KEY: 3})
    assert perm.content_digest() != m.content_digest()
    with pytest.raises(ValueError, match="duplicate"):
        DefaultIndexMap({"a": 0, "b": 0})


@pytest.mark.parametrize("partitions", [1, 4])
def test_stores_are_byte_equal_to_the_jax_builders(tmp_path, jax_plain_writer, partitions):
    names = _names()
    build_offheap_index_map(names, str(tmp_path / "port"), partitions).close()
    joffheap.build_offheap_index_map(names, str(tmp_path / "jax"), partitions).close()
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == ["metadata.json"] + [f"partition-{i}.bin" for i in range(partitions)]
    assert port == jax


@pytest.mark.parametrize("partitions", [1, 4])
def test_native_builder_is_byte_equal_to_its_plain_version(tmp_path, partitions):
    names = _names(800, seed=1)
    with build_offheap_index_map(names, str(tmp_path / "im"), partitions) as m:
        for p in range(partitions):
            lo = int(m._offsets[p])
            path = str(tmp_path / "im" / offheap.PARTITION_FILE.format(i=p))
            keys = [m.get_feature_name(i).encode() for i in range(
                lo, lo + m._parts[p].num_entries)]
            offheap._build_partition_python(
                str(tmp_path / "plain.bin"), keys, np.arange(lo, lo + len(keys), dtype=np.uint32))
            assert open(path, "rb").read() == (tmp_path / "plain.bin").read_bytes()


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


def test_stores_equal_the_jax_native_builders_on_every_byte_a_reader_sees(tmp_path):
    names = _names(2000, seed=4)
    build_offheap_index_map(names, str(tmp_path / "port"), 4).close()
    joffheap.build_offheap_index_map(names, str(tmp_path / "jax"), 4).close()
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(jax)
    assert port.pop("metadata.json") == jax.pop("metadata.json")
    for f in port:
        assert port[f] == _meaningful(jax[f]), f


@pytest.mark.parametrize("partitions", [1, 4])
def test_build_and_lookup(tmp_path, partitions):
    names = _names()
    m = build_offheap_index_map(names, str(tmp_path / "im"), partitions)
    assert len(m) == len(set(names))
    idx = m.get_indices(sorted(set(names)))
    assert idx.min() == 0 and idx.max() == len(m) - 1
    assert len(np.unique(idx)) == len(m)
    assert m.get_index("missing-feature") == -1
    for probe in [0, 1, len(m) // 2, len(m) - 1]:
        name = m.get_feature_name(probe)
        assert name is not None and m.get_index(name) == probe
    assert m.get_feature_name(len(m)) is None and m.get_feature_name(-1) is None
    assert m.get_indices([]).shape == (0,)
    m.close()


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_each_package_reads_the_others_stores(tmp_path, builder):
    names = _names(600, seed=2)
    build = (joffheap if builder == "jax" else offheap).build_offheap_index_map
    build(names, str(tmp_path / "im"), 3).close()
    probes = sorted(set(names)) + ["not-a-feature"]
    with OffHeapIndexMap(str(tmp_path / "im")) as m:
        jm = joffheap.OffHeapIndexMap(str(tmp_path / "im"))
        np.testing.assert_array_equal(m.get_indices(probes), jm.get_indices(probes))
        assert [m.get_feature_name(i) for i in range(len(m) + 1)] == \
               [jm.get_feature_name(i) for i in range(len(jm) + 1)]
        jm.close()


def test_native_reader_against_the_plain_partition(tmp_path):
    names = _names(700, seed=5)
    with build_offheap_index_map(names, str(tmp_path / "im"), 2) as m:
        keys = [n.encode() for n in sorted(set(names))] + [b"absent", b""]
        hashes = fnv1a_hashes(keys)
        parts = (hashes % np.uint64(2)).astype(np.int64)
        plain = [offheap._PythonPartition(str(tmp_path / "im" / offheap.PARTITION_FILE.format(i=p)))
                 for p in range(2)]
        want = [plain[p].get(k, h) for k, h, p in zip(keys, hashes, parts)]
        np.testing.assert_array_equal(m.get_indices([k.decode() for k in keys]), want)
        for i in range(len(m)):
            p = int(np.searchsorted(m._offsets, i, side="right")) - 1
            assert m._parts[p].name_at(i) == plain[p].name_at(i)
        for part in plain:
            part.close()


def test_native_hash_matches_the_plain_hash_and_reference_vectors():
    keys = [b"", b"a", b"foobar", "é\x01x".encode(), b"f\x0112345"]
    blob, offs, lens = offheap._pack_keys(keys)
    np.testing.assert_array_equal(offheap.native_hashes(blob, offs, lens), fnv1a_hashes(keys))
    # FNV-1a 64 known vectors
    assert int(fnv1a_hashes([b""])[0]) == 0xCBF29CE484222325
    assert int(fnv1a_hashes([b"a"])[0]) == 0xAF63DC4C8601EC8C
    assert int(fnv1a_hashes([b"foobar"])[0]) == 0x85944171F73967E8
    np.testing.assert_array_equal(fnv1a_hashes(keys), joffheap.fnv1a_hashes(keys))


def test_duplicate_keys_rejected(tmp_path):
    blob, offs, lens = offheap._pack_keys([b"same", b"same"])
    lib = offheap._load_native()
    rc = lib.phix_build(str(tmp_path / "p.bin").encode(), blob, offheap._ptr(offs),
                        offheap._ptr(lens), offheap._ptr(np.array([0, 1], dtype=np.uint32)), 2)
    assert rc == -17  # EEXIST
    with pytest.raises(ValueError, match="duplicate"):
        offheap._build_partition_python(str(tmp_path / "q.bin"), [b"same", b"same"],
                                        np.array([0, 1], dtype=np.uint32))
    # the builder's entry points keep one copy of a repeated key
    with build_offheap_index_map(["a", "b", "a"], str(tmp_path / "im")) as m:
        assert len(m) == 2 and m.get_indices(["a", "b"]).tolist() == [0, 1]


def test_native_sort_unique_is_sorted_set(tmp_path):
    names = _names(3000, seed=6) + ["", "a", "a\x00", "a\x00b", "\xff", "é"] * 2
    keys = [n.encode() for n in names]
    blob, offs, lens = offheap._pack_keys(keys)
    order = np.empty(len(keys), dtype=np.uint64)
    k = offheap._load_native().phix_sort_unique(blob, offheap._ptr(offs), offheap._ptr(lens),
                                                len(keys), offheap._ptr(order))
    assert [keys[i] for i in order[:k]] == sorted(set(keys))
    assert [keys[i].decode() for i in order[:k]] == sorted(set(names))


def test_content_digest_tracks_store_identity(tmp_path):
    names = _names(300, seed=3)
    m = build_offheap_index_map(names, str(tmp_path / "im"), 2)
    d1 = m.content_digest()
    m.close()
    with OffHeapIndexMap(str(tmp_path / "im")) as m2:
        assert m2.content_digest() == d1
        assert m2.content_digest() == joffheap.OffHeapIndexMap(str(tmp_path / "im")).content_digest()
    part = str(tmp_path / "im" / offheap.PARTITION_FILE.format(i=0))
    st = os.stat(part)
    os.utime(part, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    with OffHeapIndexMap(str(tmp_path / "im")) as m3:
        assert m3.content_digest() != d1


def test_not_a_store_is_refused(tmp_path):
    (tmp_path / "metadata.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="not a PHIX"):
        OffHeapIndexMap(str(tmp_path))
