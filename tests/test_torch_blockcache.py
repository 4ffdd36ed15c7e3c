"""The port's decoded block cache (``photon_ml_tpu_torch/streaming/blockcache.py``)
against the JAX package's, over the streaming tests' part files:

- the plan fingerprint is the JAX package's for the same files and maps;
- every entry the port writes is byte-equal to the JAX package's;
- each package hits the other's cache and serves the same blocks;
- a truncated entry, a bad checksum and a garbage file are misses that
  re-decode and rewrite; touching a part file changes the fingerprint;
- ``sweep_stale`` removes the entries of older plans only;
- a warm pass does no decode work and its prefetcher hides everything;
- id tags, ASCII or not and ending in a NUL or not, load as the JAX
  package loads them.
"""

import os

import numpy as np
import pytest

import photon_ml_tpu.streaming as js
import photon_ml_tpu_torch.streaming as ts
from photon_ml_tpu.io import data_reader as jdr
from photon_ml_tpu_torch.io import data_reader as tdr
from test_torch_streaming import BLOCK_ROWS, _host_block_equal, _shards, write_stream_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("blockcache")
    paths, _ = write_stream_dataset(root)
    return {
        "paths": paths,
        "tmaps": tdr.build_index_maps(paths, _shards(tdr)),
        "jmaps": jdr.build_index_maps(paths, _shards(jdr)),
    }


def _open(pkg, dataset, cache_dir=None, paths=None):
    dr, maps = (tdr, dataset["tmaps"]) if pkg is ts else (jdr, dataset["jmaps"])
    return pkg.StreamingSource.open(paths or dataset["paths"], _shards(dr), index_maps=maps,
                                    block_rows=BLOCK_ROWS, id_tags=("userId",),
                                    cache_dir=cache_dir)


def _fill(source, shards=None):
    return [source.build_block(b, shards=shards) for b in range(source.plan.num_blocks)]


def test_fingerprint_equals_jax(dataset, tmp_path):
    t = _open(ts, dataset, str(tmp_path / "t"))
    j = _open(js, dataset, str(tmp_path / "j"))
    assert t.cache.fingerprint == j.cache.fingerprint
    assert dataset["tmaps"]["global"].content_digest() == dataset["jmaps"]["global"].content_digest()


@pytest.mark.parametrize("shards", [None, ("global",)])
def test_entries_are_byte_equal_to_jax(dataset, tmp_path, shards):
    t = _open(ts, dataset, str(tmp_path / "t"))
    j = _open(js, dataset, str(tmp_path / "j"))
    _fill(t, shards)
    _fill(j, shards)
    want = shards or tuple(t.shard_configs)
    for b in range(t.plan.num_blocks):
        with open(t.cache.entry_path(b, want), "rb") as f:
            mine = f.read()
        with open(j.cache.entry_path(b, want), "rb") as f:
            ref = f.read()
        assert os.path.basename(t.cache.entry_path(b, want)) == os.path.basename(
            j.cache.entry_path(b, want))
        assert mine == ref, b
    assert t.cache.stats.writes == j.cache.stats.writes == t.plan.num_blocks


@pytest.mark.parametrize("writer,reader", [(js, ts), (ts, js)])
def test_each_package_hits_the_others_cache(dataset, tmp_path, writer, reader):
    cache = str(tmp_path / "shared")
    written = _fill(_open(writer, dataset, cache))
    src = _open(reader, dataset, cache)
    decoded = src.files_decoded  # the planning pass
    served = _fill(src)
    assert src.cache.stats.hits == src.plan.num_blocks and src.cache.stats.misses == 0
    assert src.files_decoded == decoded
    for a, b in zip(served, written):
        _host_block_equal(a, b)


def test_truncated_entry_is_a_miss_and_rewritten(dataset, tmp_path):
    cache = str(tmp_path / "c")
    ref = _fill(_open(ts, dataset, cache))
    src = _open(ts, dataset, cache)
    path = src.cache.entry_path(2, tuple(src.shard_configs))
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    _host_block_equal(src.build_block(2), ref[2])
    assert src.cache.stats.invalid == 1 and src.cache.stats.misses == 1
    assert os.path.getsize(path) == size  # rewritten by the re-decode
    fresh = _open(ts, dataset, cache)
    _host_block_equal(fresh.build_block(2), ref[2])
    assert fresh.cache.stats.hits == 1


def test_bad_checksum_is_a_miss(dataset, tmp_path):
    cache = str(tmp_path / "c")
    ref = _fill(_open(ts, dataset, cache))
    src = _open(ts, dataset, cache)
    path = src.cache.entry_path(0, tuple(src.shard_configs))
    with open(path, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        tail = bytearray(f.read(8))
        tail[0] ^= 0xFF
        f.seek(-8, os.SEEK_END)
        f.write(bytes(tail))
    _host_block_equal(src.build_block(0), ref[0])
    assert src.cache.stats.invalid == 1


def test_garbage_file_is_a_miss(dataset, tmp_path):
    cache = str(tmp_path / "c")
    src = _open(ts, dataset, cache)
    path = src.cache.entry_path(1, tuple(src.shard_configs))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"not a block cache entry")
    assert src.cache.load(1, tuple(src.shard_configs)) is None
    assert src.cache.stats.invalid == 1


def test_touched_part_file_changes_the_fingerprint_and_sweep_removes_the_old(dataset, tmp_path):
    import shutil

    data = tmp_path / "data"
    data.mkdir()
    paths = []
    for p in dataset["paths"]:
        shutil.copy(p, data / os.path.basename(p))
        paths.append(str(data / os.path.basename(p)))
    cache = str(tmp_path / "c")
    old = _open(ts, dataset, cache, paths=paths)
    _fill(old)
    st = os.stat(paths[1])
    os.utime(paths[1], ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    new = ts.StreamingSource.open(paths, _shards(tdr), index_maps=dataset["tmaps"],
                                  block_rows=BLOCK_ROWS, id_tags=("userId",))
    new.attach_cache(cache, sweep=False)
    assert new.cache.fingerprint != old.cache.fingerprint
    assert new.cache.load(0, tuple(new.shard_configs)) is None  # a miss
    _fill(new)
    assert sorted(os.listdir(cache)) == sorted([old.cache.fingerprint[:20],
                                                new.cache.fingerprint[:20]])
    removed = new.cache.sweep_stale()
    assert removed == old.plan.num_blocks
    assert os.listdir(cache) == [new.cache.fingerprint[:20]]
    assert new.cache.sweep_stale() == 0


def test_warm_pass_does_no_decode_work(dataset, tmp_path):
    cache = str(tmp_path / "c")
    _fill(_open(ts, dataset, cache), shards=("global",))
    src = _open(ts, dataset, cache)
    work0, decoded0 = src.work_seconds, src.files_decoded
    p = ts.BlockPrefetcher(src, shards=("global",), device="cpu")
    assert len(list(p)) == src.plan.num_blocks
    assert src.work_seconds == work0 and src.files_decoded == decoded0
    assert p.stats.cache_hit_blocks == src.plan.num_blocks
    assert p.stats.decode_s == 0.0 and p.stats.hide_ratio == 1.0


def test_cache_store_failure_is_not_fatal(dataset, tmp_path):
    import photon_ml_tpu_torch.resilience as tr

    tr.configure_faults("stream.blockcache.store=every:1")
    try:
        src = _open(ts, dataset, str(tmp_path / "c"))
        assert len(list(src.iter_blocks(shards=("global",)))) == src.plan.num_blocks
        assert "cache_store_failed" in [f["kind"] for f in tr.recent_failures()]
    finally:
        tr.configure_faults({})
        tr.reset_faults()
        tr.clear_failures()
    assert "stream.blockcache.load" in tr.registered_fault_sites()


@pytest.mark.parametrize("ids", [
    np.array(["u01", "u02", "u3"]),
    np.array(["u01", "u02", "u3"], dtype=object),
    np.array(["u01", "ü02", "用户3", ""]),
    np.array(["u01", "u02\x00", "a\x00b", ""], dtype=object),
], ids=["ascii", "ascii_object", "not_ascii", "ends_in_nul"])
def test_id_tags_load_as_the_jax_package_loads_them(tmp_path, ids):
    """Id tags round-trip through each package's cache as through the JAX
    package's: the port decodes ASCII arenas in bulk and the rest (ids that
    are not ASCII, or end in a NUL) one string at a time, like the JAX
    package; either way the entry bytes and the loaded arrays are the JAX
    package's."""
    rows = 4

    def block(pkg):
        return pkg.HostBlock(
            index=0, start=0, num_real=len(ids), labels=np.ones(rows, np.float32),
            offsets=np.zeros(rows, np.float32), weights=np.ones(rows, np.float32),
            shards={"global": (np.ones((rows, 2), np.float32), np.zeros((rows, 2), np.int32))},
            id_tags={"userId": ids})

    caches = {pkg: pkg.BlockCache(str(tmp_path / pkg.__name__), "f" * 64) for pkg in (ts, js)}
    for pkg, cache in caches.items():
        assert cache.store(block(pkg), ("global",))
    with open(caches[ts].entry_path(0, ("global",)), "rb") as f:
        mine = f.read()
    with open(caches[js].entry_path(0, ("global",)), "rb") as f:
        assert mine == f.read()
    for cache in caches.values():  # the entries each package wrote
        got, want = (pkg.BlockCache(cache.root, cache.fingerprint).load(0, ("global",))
                     .id_tags["userId"] for pkg in (ts, js))
        assert got.dtype == want.dtype == ids.dtype
        assert got.tolist() == want.tolist() == ids.tolist()
