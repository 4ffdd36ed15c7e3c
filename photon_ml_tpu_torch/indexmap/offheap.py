"""Off-heap partitioned feature index map: the PalDB-equivalent native store.

Port of ``photon_ml_tpu/indexmap/offheap.py`` (reference
util/PalDBIndexMap.scala:43: partitioned read-only mmap stores, name->index
and index->name in one store :69-103; PalDBIndexMapBuilder.scala:27;
FeatureIndexingJob.scala:56: hash-partitioned distinct features -> one
store per partition). The store format ("PHIX") and its C++ builder and
reader live in ``native/indexstore.cpp``, built by ``utils/nativelib.py``
into ``build/photon_ml_tpu_torch/``; a failed build raises. The files are
byte-equal to the JAX package's, so either package reads the other's.

The entry points (``build_offheap_index_map``,
``build_offheap_index_map_packed``, ``OffHeapIndexMap``) run the native
builder (its keys sorted and deduplicated natively), reader and hash. ``fnv1a_hashes``,
``_build_partition_python`` and ``_PythonPartition`` are their plain
versions, the reference's pure-Python writer and reader of the same
format: tests hold the native files and lookups against them byte for
byte; no entry point takes them.

Partitioning: key -> partition by fnv1a64(key) % num_partitions. Global
indices are assigned contiguously per partition, in sorted key order
within a partition; ``partition_offsets`` in metadata.json lets reverse
lookup binary-search the owning partition.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import mmap
import os
import pathlib
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.indexmap import IndexMap
from photon_ml_tpu_torch.utils import nativelib

LIBRARY = "indexstore"

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)

METADATA_FILE = "metadata.json"
PARTITION_FILE = "partition-{i}.bin"

_HEADER = struct.Struct("<4sIQQQQQQ")  # magic, version, slots, entries, fwd, rev, keys_off, keys_len
_MAGIC = b"PHIX"
_EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)

_bound = set()

# lookups of at least this many keys run one thread a partition
_PARALLEL_LOOKUPS = 1 << 16


def _load_native() -> ctypes.CDLL:
    """The store library with its C signatures bound; raises when it cannot
    be built."""
    lib = nativelib.load_library(LIBRARY)
    if id(lib) in _bound:
        return lib
    lib.phix_build.restype = ctypes.c_int
    lib.phix_build.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.phix_open.restype = ctypes.c_void_p
    lib.phix_open.argtypes = [ctypes.c_char_p]
    lib.phix_get.restype = ctypes.c_int64
    lib.phix_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.phix_get_batch.restype = None
    lib.phix_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.phix_name_at.restype = ctypes.c_int64
    lib.phix_name_at.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.phix_num_entries.restype = ctypes.c_uint64
    lib.phix_num_entries.argtypes = [ctypes.c_void_p]
    lib.phix_hash_batch.restype = None
    lib.phix_hash_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.phix_sort_unique.restype = ctypes.c_uint64
    lib.phix_sort_unique.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
    ]
    lib.phix_build_members.restype = ctypes.c_int
    lib.phix_build_members.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.phix_close.restype = None
    lib.phix_close.argtypes = [ctypes.c_void_p]
    _bound.add(id(lib))
    return lib


def native_available() -> bool:
    """True once the store library is built and loaded (it raises
    otherwise)."""
    return _load_native() is not None


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _pack_keys(names: Sequence[bytes]):
    """Concatenate byte keys -> (blob, offsets u64, lens u32)."""
    lens = np.fromiter((len(n) for n in names), dtype=np.uint32, count=len(names))
    offs = np.zeros(len(names), dtype=np.uint64)
    if len(names) > 1:
        offs[1:] = np.cumsum(lens[:-1], dtype=np.uint64)
    return b"".join(names), offs, lens


def fnv1a_hashes(names: Sequence[bytes]) -> np.ndarray:
    """Vectorized FNV-1a 64 over byte keys: the plain version of the native
    hash (``phix_hash_batch``, the C++ ``fnv1a`` of indexstore.cpp)."""
    if not len(names):
        return np.zeros(0, dtype=np.uint64)
    lens = np.fromiter((len(n) for n in names), dtype=np.int64, count=len(names))
    max_len = int(lens.max()) if len(lens) else 0
    buf = np.zeros((len(names), max_len), dtype=np.uint8)
    for i, n in enumerate(names):
        buf[i, : len(n)] = np.frombuffer(n, dtype=np.uint8)
    h = np.full(len(names), _FNV_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(max_len):
            live = j < lens
            h[live] = (h[live] ^ buf[live, j].astype(np.uint64)) * _FNV_PRIME
    return h


def native_hashes(blob: bytes, offs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """FNV-1a 64 of the packed keys ``blob[offs[i]:offs[i]+lens[i]]``."""
    lib = _load_native()
    offs = np.ascontiguousarray(offs, dtype=np.uint64)
    lens = np.ascontiguousarray(lens, dtype=np.uint32)
    out = np.empty(len(lens), dtype=np.uint64)
    if len(lens):
        lib.phix_hash_batch(blob, _ptr(offs), _ptr(lens), _ptr(out), len(lens))
    return out


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _pow2_slots(n: int) -> int:
    want = (n * 10) // 7 + 1
    s = 16
    while s < want:
        s <<= 1
    return s


def _build_partition_python(
    path: str, names: Sequence[bytes], indices: np.ndarray
) -> None:
    """Plain version of ``phix_build``: the reference's pure-Python writer
    of the PHIX format (byte-equal files)."""
    n = len(names)
    slots = _pow2_slots(n)
    mask = np.uint64(slots - 1)
    blob, offs, lens = _pack_keys(names)

    fwd_off = np.full(slots, _EMPTY, dtype=np.uint64)
    fwd_len = np.zeros(slots, dtype=np.uint32)
    fwd_idx = np.zeros(slots, dtype=np.uint32)
    rev_ip1 = np.zeros(slots, dtype=np.uint64)
    rev_off = np.zeros(slots, dtype=np.uint64)
    rev_len = np.zeros(slots, dtype=np.uint32)

    hashes = fnv1a_hashes(names)
    rhashes = _splitmix64(np.asarray(indices, dtype=np.uint64))
    for i in range(n):
        slot = int(hashes[i] & mask)
        while fwd_off[slot] != _EMPTY:
            if fwd_len[slot] == lens[i] and blob[
                int(fwd_off[slot]) : int(fwd_off[slot]) + int(lens[i])
            ] == names[i]:
                raise ValueError(f"duplicate key {names[i]!r}")
            slot = (slot + 1) % slots
        fwd_off[slot] = offs[i]
        fwd_len[slot] = lens[i]
        fwd_idx[slot] = indices[i]
        rslot = int(rhashes[i] & mask)
        while rev_ip1[rslot] != 0:
            rslot = (rslot + 1) % slots
        rev_ip1[rslot] = np.uint64(int(indices[i]) + 1)
        rev_off[rslot] = offs[i]
        rev_len[rslot] = lens[i]

    fwd = np.zeros(slots, dtype=[("off", "<u8"), ("len", "<u4"), ("idx", "<u4")])
    fwd["off"], fwd["len"], fwd["idx"] = fwd_off, fwd_len, fwd_idx
    rev = np.zeros(
        slots, dtype=[("ip1", "<u8"), ("off", "<u8"), ("len", "<u4"), ("pad", "<u4")]
    )
    rev["ip1"], rev["off"], rev["len"] = rev_ip1, rev_off, rev_len

    header_size = _HEADER.size
    fwd_bytes = fwd.tobytes()
    rev_bytes = rev.tobytes()
    header = _HEADER.pack(
        _MAGIC, 1, slots, n,
        header_size,
        header_size + len(fwd_bytes),
        header_size + len(fwd_bytes) + len(rev_bytes),
        len(blob),
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(fwd_bytes)
        f.write(rev_bytes)
        f.write(blob)


def build_partition(path: str, names: Sequence[bytes], indices: np.ndarray) -> None:
    """One PHIX partition holding ``names`` at the given ``indices`` (kept
    as given, unlike :func:`build_offheap_index_map`, which numbers keys
    itself): the native ``phix_build``; ``_build_partition_python`` is its
    plain version (byte-equal files)."""
    lib = _load_native()
    blob, offs, lens = _pack_keys(names)
    idx = np.ascontiguousarray(indices, dtype=np.uint32)
    rc = lib.phix_build(str(path).encode(), blob, _ptr(offs),
                        _ptr(np.ascontiguousarray(lens)), _ptr(idx), len(names))
    if rc != 0:
        raise OSError(f"phix_build failed with code {rc} for {path}")


class _PythonPartition:
    """Plain version of the native reader: mmap reader of one PHIX
    partition."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, slots, entries, fwd_off, rev_off, keys_off, keys_len = (
            _HEADER.unpack_from(self._mm, 0)
        )
        if magic != _MAGIC or version != 1:
            raise ValueError(f"not a PHIX v1 store: {path}")
        self.num_entries = entries
        self._slots = slots
        self._buf = memoryview(self._mm)
        self._fwd = np.frombuffer(
            self._buf, dtype=[("off", "<u8"), ("len", "<u4"), ("idx", "<u4")],
            count=slots, offset=fwd_off,
        )
        self._rev = np.frombuffer(
            self._buf,
            dtype=[("ip1", "<u8"), ("off", "<u8"), ("len", "<u4"), ("pad", "<u4")],
            count=slots, offset=rev_off,
        )
        self._keys_off = keys_off

    def get(self, key: bytes, h: int) -> int:
        mask = self._slots - 1
        slot = int(h) & mask
        mm, ko = self._mm, self._keys_off
        while self._fwd["off"][slot] != _EMPTY:
            off = int(self._fwd["off"][slot])
            ln = int(self._fwd["len"][slot])
            if ln == len(key) and mm[ko + off : ko + off + ln] == key:
                return int(self._fwd["idx"][slot])
            slot = (slot + 1) & mask
        return -1

    def name_at(self, index: int) -> Optional[bytes]:
        mask = self._slots - 1
        slot = int(_splitmix64(np.asarray([index], dtype=np.uint64))[0]) & mask
        want = index + 1
        while self._rev["ip1"][slot] != 0:
            if int(self._rev["ip1"][slot]) == want:
                off = self._keys_off + int(self._rev["off"][slot])
                return self._mm[off : off + int(self._rev["len"][slot])]
            slot = (slot + 1) & mask
        return None

    def close(self) -> None:
        # numpy views over the mmap must be dropped before closing it
        self._fwd = None
        self._rev = None
        self._buf.release()
        self._mm.close()
        self._f.close()


class _NativePartition:
    def __init__(self, path: str, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.phix_open(str(path).encode())
        if not self._h:
            raise OSError(f"phix_open failed for {path}")
        self.num_entries = int(lib.phix_num_entries(self._h))

    def get(self, key: bytes) -> int:
        return int(self._lib.phix_get(self._h, key, len(key)))

    def get_batch(self, blob: bytes, offs: np.ndarray, lens: np.ndarray) -> np.ndarray:
        offs = np.ascontiguousarray(offs, dtype=np.uint64)
        lens = np.ascontiguousarray(lens, dtype=np.uint32)
        out = np.empty(len(lens), dtype=np.int64)
        self._lib.phix_get_batch(self._h, blob, _ptr(offs), _ptr(lens), _ptr(out), len(lens))
        return out

    def name_at(self, index: int) -> Optional[bytes]:
        buf = ctypes.create_string_buffer(4096)
        n = self._lib.phix_name_at(self._h, index, buf, 4096)
        if n < 0:
            return None
        if n > 4096:  # rare: longer than the buffer, retry exact
            buf = ctypes.create_string_buffer(n)
            self._lib.phix_name_at(self._h, index, buf, n)
        return buf.raw[: min(n, len(buf.raw))]

    def close(self) -> None:
        if self._h:
            self._lib.phix_close(self._h)
            self._h = None


def build_offheap_index_map(
    names: Iterable[str],
    output_dir: str,
    num_partitions: int = 1,
) -> "OffHeapIndexMap":
    """Distinct, hash-partition, and store feature names; assign contiguous
    global indices per partition (reference FeatureIndexingJob.scala:92-179).
    Returns the opened map. The files are byte-equal to the JAX builder's."""
    return build_offheap_index_map_packed(
        *_pack_keys([n.encode("utf-8") for n in names]), output_dir, num_partitions)


def build_offheap_index_map_packed(
    blob: bytes,
    offs: np.ndarray,
    lens: np.ndarray,
    output_dir: str,
    num_partitions: int = 1,
) -> "OffHeapIndexMap":
    """``build_offheap_index_map`` over packed UTF-8 keys
    ``blob[offs[i]:offs[i]+lens[i]]``, repeats allowed: the distinct keys
    are sorted natively (byte order is code-point order, so this is the
    reference's ``sorted(set(names))``), routed to partition
    fnv1a(key) % P, and each partition gets its keys in sorted order with
    contiguous indices."""
    lib = _load_native()
    out = pathlib.Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    offs = np.ascontiguousarray(offs, dtype=np.uint64)
    lens = np.ascontiguousarray(lens, dtype=np.uint32)
    order = np.empty(len(lens), dtype=np.uint64)
    k = int(lib.phix_sort_unique(blob, _ptr(offs), _ptr(lens), len(lens), _ptr(order))) \
        if len(lens) else 0
    keys = order[:k]
    part_of = (native_hashes(blob, offs[keys], lens[keys])
               % np.uint64(num_partitions)).astype(np.int64)
    # a stable sort keeps the sorted key order inside each partition
    by_part = np.argsort(part_of, kind="stable")
    bounds = np.searchsorted(part_of[by_part], np.arange(num_partitions + 1))

    def build(p: int) -> None:
        members = np.ascontiguousarray(keys[by_part[bounds[p]:bounds[p + 1]]])
        path = str(out / PARTITION_FILE.format(i=p))
        rc = lib.phix_build_members(path.encode(), blob, _ptr(offs), _ptr(lens),
                                    _ptr(members), len(members), int(bounds[p]))
        if rc != 0:
            raise OSError(f"phix_build failed with code {rc} for {path}")

    # the native builds release the interpreter lock: a thread a partition
    with ThreadPoolExecutor(min(num_partitions, os.cpu_count() or 1)) as pool:
        list(pool.map(build, range(num_partitions)))

    (out / METADATA_FILE).write_text(
        json.dumps(
            {
                "format": "PHIX",
                "version": 1,
                "num_partitions": num_partitions,
                "num_entries": k,
                "partition_offsets": [int(b) for b in bounds[:-1]],
            }
        )
    )
    return OffHeapIndexMap(output_dir)


class OffHeapIndexMap(IndexMap):
    """Partitioned mmap'd feature index map (reference PalDBIndexMap.scala:43).

    Opens every partition store through the native reader. Forward lookup
    routes by fnv1a(key) % P; reverse lookup binary-searches
    ``partition_offsets`` (indices are contiguous per partition).
    """

    def __init__(self, directory: str):
        meta = json.loads((pathlib.Path(directory) / METADATA_FILE).read_text())
        if meta.get("format") != "PHIX":
            raise ValueError(f"{directory} is not a PHIX index map directory")
        self._dir = str(directory)
        self._num_partitions = int(meta["num_partitions"])
        self._num_entries = int(meta["num_entries"])
        self._offsets = np.asarray(meta["partition_offsets"], dtype=np.int64)
        lib = _load_native()
        self._parts = [
            _NativePartition(str(pathlib.Path(directory) / PARTITION_FILE.format(i=p)), lib)
            for p in range(self._num_partitions)
        ]

    def get_index(self, name: str) -> int:
        return int(self.get_indices([name])[0])

    def get_indices(self, names: Sequence[str]) -> np.ndarray:
        if not len(names):
            return np.zeros(0, dtype=np.int64)
        return self.get_indices_packed(*_pack_keys([n.encode("utf-8") for n in names]))

    def get_indices_packed(self, blob: bytes, offs: np.ndarray,
                           lens: np.ndarray) -> np.ndarray:
        """Indices of the packed UTF-8 keys ``blob[offs[i]:offs[i]+lens[i]]``
        (-1 for unmapped): one native batch lookup a partition."""
        offs = np.asarray(offs)
        lens = np.asarray(lens)
        parts = (native_hashes(blob, offs, lens) % np.uint64(self._num_partitions)).astype(np.int64)
        out = np.empty(len(lens), dtype=np.int64)

        def lookup(p: int) -> None:
            sel = np.nonzero(parts == p)[0]
            if len(sel):
                out[sel] = self._parts[p].get_batch(blob, offs[sel], lens[sel])

        if self._num_partitions > 1 and len(lens) >= _PARALLEL_LOOKUPS:
            # the native lookups release the interpreter lock: one thread
            # a partition, each writing its own rows of ``out``
            with ThreadPoolExecutor(min(self._num_partitions, os.cpu_count() or 1)) as pool:
                list(pool.map(lookup, range(self._num_partitions)))
        else:
            for p in range(self._num_partitions):
                lookup(p)
        return out

    def get_feature_name(self, index: int) -> Optional[str]:
        if index < 0 or index >= self._num_entries:
            return None
        p = int(np.searchsorted(self._offsets, index, side="right")) - 1
        raw = self._parts[p].name_at(int(index))
        return raw.decode("utf-8") if raw is not None else None

    def __len__(self) -> int:
        return self._num_entries

    def content_digest(self) -> str:
        """Digest of the store directory's file identities — (name, size,
        mtime_ns) of metadata + every partition — instead of the base
        class's O(entries) reverse scan. PHIX stores are immutable once
        built, so file identity IS content identity; a rebuilt store (even
        with identical entries) digests differently, which can only cause
        a spurious cache miss, never a stale hit."""
        h = hashlib.sha256()
        for name in sorted(os.listdir(self._dir)):
            st = os.stat(os.path.join(self._dir, name))
            h.update(
                f"{name}\x00{st.st_size}\x00{st.st_mtime_ns}\x01".encode("utf-8")
            )
        return h.hexdigest()

    def close(self) -> None:
        for p in self._parts:
            p.close()
        self._parts = []

    def __enter__(self) -> "OffHeapIndexMap":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
