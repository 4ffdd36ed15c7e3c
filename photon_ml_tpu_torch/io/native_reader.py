"""Native columnar Avro reading: the C++ data-loader path.

Port of ``photon_ml_tpu/io/native_reader.py``. The generic Python codec
(io/avro.py) builds a dict per record — fine for models and scores, a
bottleneck for training data. This module compiles the writer schema to a
flat field program and hands whole container blocks to
``native/avrodecode.cpp`` (built by ``utils/nativelib.py`` into
``build/photon_ml_tpu_torch/``, linked with ``-lz``), which inflates and
decodes them in one foreign call with the interpreter lock released and
emits columnar buffers: numeric columns, string columns (byte arena +
offsets), and per-feature-bag streams whose "name\\x01term" keys live in one
arena. Feature-key deduplication also runs natively, so Python materializes
O(unique features) strings instead of O(nnz) — the role Spark's JVM Avro
readers play for the reference (AvroDataReader.scala:53).

Schema shapes outside the supported set (see avrodecode.cpp header) return
``None`` from :func:`compile_program`, and an unsupported codec ``None``
from :func:`read_columnar_file`; callers then read with the Python codec,
exactly where the JAX package does. Unlike the reference, a library that
cannot be built or loaded raises: there is no quiet fallback on a missing
toolchain.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.io.avro import MAGIC, SYNC_SIZE, _decode, _Reader
from photon_ml_tpu_torch.utils import nativelib

logger = logging.getLogger("photon_ml_tpu_torch")

LIBRARY = "avrodecode"
LDFLAGS = ("-lz",)

K_DOUBLE, K_FLOAT, K_LONG, K_INT, K_BOOL, K_STRING, K_BYTES = range(7)
K_FEATURES, K_STRMAP = 7, 8

_PRIMITIVES = {
    "double": K_DOUBLE,
    "float": K_FLOAT,
    "long": K_LONG,
    "int": K_INT,
    "boolean": K_BOOL,
    "string": K_STRING,
    "bytes": K_BYTES,
}

_c_i64 = ctypes.c_int64
_c_i32 = ctypes.c_int32
_c_p = ctypes.c_void_p

_bound = set()


def _load_native() -> ctypes.CDLL:
    """The decoder library with its C signatures bound; raises when it
    cannot be built."""
    lib = nativelib.load_library(LIBRARY, LDFLAGS)
    if id(lib) in _bound:
        return lib
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(_c_i32)
    i64p = ctypes.POINTER(_c_i64)
    lib.avro_decode.restype = _c_p
    lib.avro_decode.argtypes = [
        u8p, _c_i64, _c_i64, i32p, _c_i32, _c_i32, _c_i32, _c_i32,
        u8p, i32p, _c_i32, _c_i32,
    ]
    # one inflate + decode call per file, the interpreter lock released
    lib.avro_decode_packed.restype = _c_p
    lib.avro_decode_packed.argtypes = [
        u8p, _c_i64, i64p, i64p, i64p, _c_i32, _c_i32,
        i32p, _c_i32, _c_i32, _c_i32, _c_i32,
        u8p, i32p, _c_i32, _c_i32,
    ]
    lib.res_n_rows.restype = _c_i64
    lib.res_n_rows.argtypes = [_c_p]
    lib.res_num_col.restype = ctypes.POINTER(ctypes.c_double)
    lib.res_num_col.argtypes = [_c_p, _c_i32]
    lib.res_num_present.restype = u8p
    lib.res_num_present.argtypes = [_c_p, _c_i32]
    lib.res_str_arena.restype = u8p
    lib.res_str_arena.argtypes = [_c_p, i64p]
    lib.res_str_off.restype = i64p
    lib.res_str_off.argtypes = [_c_p, _c_i32]
    lib.res_str_len.restype = i32p
    lib.res_str_len.argtypes = [_c_p, _c_i32]
    lib.res_bag_count.restype = _c_i64
    lib.res_bag_count.argtypes = [_c_p, _c_i32]
    lib.res_bag_rec.restype = i32p
    lib.res_bag_rec.argtypes = [_c_p, _c_i32]
    lib.res_bag_val.restype = ctypes.POINTER(ctypes.c_float)
    lib.res_bag_val.argtypes = [_c_p, _c_i32]
    lib.res_bag_key_off.restype = i64p
    lib.res_bag_key_off.argtypes = [_c_p, _c_i32]
    lib.res_bag_key_len.restype = i32p
    lib.res_bag_key_len.argtypes = [_c_p, _c_i32]
    lib.res_key_arena.restype = u8p
    lib.res_key_arena.argtypes = [_c_p, i64p]
    lib.res_free.restype = None
    lib.res_free.argtypes = [_c_p]
    lib.key_dedup.restype = _c_p
    lib.key_dedup.argtypes = [u8p, i64p, i32p, _c_i64]
    lib.dedup_n_unique.restype = _c_i64
    lib.dedup_n_unique.argtypes = [_c_p]
    lib.dedup_ids.restype = i32p
    lib.dedup_ids.argtypes = [_c_p]
    lib.dedup_u_off.restype = i64p
    lib.dedup_u_off.argtypes = [_c_p]
    lib.dedup_u_len.restype = i32p
    lib.dedup_u_len.argtypes = [_c_p]
    lib.dedup_free.restype = None
    lib.dedup_free.argtypes = [_c_p]
    _bound.add(id(lib))
    return lib


def native_available() -> bool:
    """True once the decoder is built and loaded (it raises otherwise)."""
    return _load_native() is not None


def _classify(ftype) -> Optional[Tuple[int, int]]:
    """Field type -> (kind, nullmode) or None if unsupported."""
    nullmode = 0
    if isinstance(ftype, list):
        if len(ftype) != 2:
            return None
        if ftype[0] == "null":
            nullmode, ftype = 1, ftype[1]
        elif ftype[1] == "null":
            nullmode, ftype = 2, ftype[0]
        else:
            return None
    if isinstance(ftype, str):
        kind = _PRIMITIVES.get(ftype)
        return None if kind is None else (kind, nullmode)
    if isinstance(ftype, dict):
        t = ftype.get("type")
        if t == "array":
            items = ftype.get("items")
            if not (
                isinstance(items, dict)
                and items.get("type") == "record"
                and [f["name"] for f in items.get("fields", [])]
                == ["name", "term", "value"]
                and [f["type"] for f in items["fields"]]
                == ["string", "string", "double"]
            ):
                return None
            return (K_FEATURES, nullmode)
        if t == "map" and ftype.get("values") == "string":
            return (K_STRMAP, nullmode)
    return None


class ColumnarPlan:
    """Compiled field program + column bookkeeping for one schema."""

    def __init__(self, program, num_fields, str_fields, bag_fields, tags):
        self.program = program              # np.int32 [n_fields * 3]
        self.num_fields = num_fields        # field name -> numeric col id
        self.str_fields = str_fields        # field name -> string col id
        self.bag_fields = bag_fields        # bag name -> bag id
        self.tags = tags                    # tag name -> string col id
        self.n_str_cols = len(str_fields) + len(tags)
        self.tag_col_base = len(str_fields)


def compile_program(
    schema_root,
    numeric_fields: Sequence[str],
    string_fields: Sequence[str],
    bags: Sequence[str],
    tags: Sequence[str] = (),
) -> Optional[ColumnarPlan]:
    """Compile a record schema into the native field program; None when the
    schema (or a requested capture) falls outside the supported shapes."""
    if not isinstance(schema_root, dict) or schema_root.get("type") != "record":
        return None
    num_fields: Dict[str, int] = {}
    str_fields: Dict[str, int] = {}
    bag_fields: Dict[str, int] = {}
    prog: List[int] = []
    for f in schema_root.get("fields", []):
        name = f["name"]
        cls = _classify(f["type"])
        if cls is None:
            return None
        kind, nullmode = cls
        capture = -1
        if kind <= K_BOOL and name in numeric_fields:
            capture = num_fields.setdefault(name, len(num_fields))
        elif kind <= K_BOOL and name in string_fields:
            # a requested string capture (id tag) with a numeric schema type:
            # the Python codec stringifies it; this path can't — fall back
            return None
        elif kind in (K_STRING, K_BYTES) and name in string_fields:
            capture = str_fields.setdefault(name, len(str_fields))
        elif kind == K_FEATURES and name in bags:
            capture = bag_fields.setdefault(name, len(bag_fields))
        elif kind == K_STRMAP and name == "metadataMap" and tags:
            # tag matching applies ONLY to the metadataMap field, mirroring
            # the Python path (data_reader reads record["metadataMap"])
            capture = 0
        prog.extend([kind, nullmode, capture])
    missing_bags = set(bags) - set(bag_fields)
    if missing_bags:
        return None  # requested bag absent from schema: fall back
    tag_cols = {t: len(str_fields) + i for i, t in enumerate(tags)}
    return ColumnarPlan(
        np.asarray(prog, dtype=np.int32), num_fields, str_fields,
        bag_fields, tag_cols,
    )


class ColumnarFile:
    """Decoded columns of one container file (all arrays numpy copies)."""

    def __init__(self, n_rows, num, num_present, strs, tag_strs, bags, key_arena):
        self.n_rows = n_rows
        self.num = num                  # name -> float64 [n]
        self.num_present = num_present  # name -> bool [n]
        self.strs = strs                # top-level field -> (arena, off, len)
        self.tag_strs = tag_strs        # metadataMap tag -> (arena, off, len)
        self.bags = bags                # name -> (rec, val, key_off, key_len)
        self.key_arena = key_arena      # bytes


def _np_from(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def _scan_container_offsets(
    path: str, data: Optional[bytes] = None
) -> Optional[Tuple[bytes, List[int], List[int], List[int], str]]:
    """Parse the container framing of one Avro file into per-container-block
    payload POSITIONS — no payload bytes are copied and nothing is
    decompressed (the packed native decode inflates straight out of the
    file buffer).

    Returns ``(data, offsets, lengths, counts, codec)`` where container
    block *i* holds ``counts[i]`` records in
    ``data[offsets[i]:offsets[i]+lengths[i]]``, or None when the codec is
    unsupported."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    meta = _decode(r, {"type": "map", "values": "bytes"})
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate"):
        return None
    sync = r.read(SYNC_SIZE)
    offsets: List[int] = []
    lengths: List[int] = []
    counts: List[int] = []
    while r.pos < len(r.buf):
        n = r.read_long()
        size = r.read_long()
        if size < 0 or r.pos + size > len(r.buf):
            raise ValueError(f"{path}: container block overruns file")
        offsets.append(r.pos)
        lengths.append(size)
        counts.append(n)
        r.pos += size
        if r.read(SYNC_SIZE) != sync:
            raise ValueError(f"{path}: sync marker mismatch (corrupt file)")
    return data, offsets, lengths, counts, codec


def container_block_counts(
    path: str, data: Optional[bytes] = None
) -> List[int]:
    """Per-container-block record counts of one Avro file (framing scan only,
    no decompression or record decode). The streaming block planner uses this
    to size blocks without pulling data through the decoder."""
    scanned = _scan_container_offsets(path, data)
    if scanned is None:
        raise ValueError(f"{path}: unsupported avro codec for framing scan")
    return scanned[3]


def read_columnar_file(
    path: str,
    plan: ColumnarPlan,
    data: Optional[bytes] = None,
    block_start: int = 0,
    block_count: Optional[int] = None,
) -> Optional[ColumnarFile]:
    """Decode one container file through the native path (None on any
    mismatch: different schema shape, unsupported codec, decode error).
    ``data`` passes already-read file bytes (header sniffing shares one
    read with decoding). ``block_start``/``block_count`` restrict decoding
    to a contiguous range of *container* blocks — the unit of chunked
    out-of-core reads; only the selected payloads are decompressed, and the
    resulting columns are bitwise-identical to the matching row range of a
    whole-file read."""
    lib = _load_native()
    scanned = _scan_container_offsets(path, data)
    if scanned is None:
        logger.info("%s: avro codec outside the native decoder; python codec", path)
        return None
    data, offsets, lengths, counts, codec = scanned
    n_payloads = len(offsets)
    if block_start < 0 or block_start > n_payloads:
        raise ValueError(
            f"{path}: block_start={block_start} out of range "
            f"[0, {n_payloads}]"
        )
    stop = (
        n_payloads
        if block_count is None
        else min(block_start + max(block_count, 0), n_payloads)
    )
    sel = slice(block_start, stop)
    tag_names = sorted(plan.tags, key=plan.tags.get)
    tag_bytes = b"".join(t.encode("utf-8") for t in tag_names)
    tag_lens = np.asarray(
        [len(t.encode("utf-8")) for t in tag_names], dtype=np.int32
    )
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(_c_i32)
    i64p = ctypes.POINTER(_c_i64)
    prog = np.ascontiguousarray(plan.program)

    # ONE foreign call does inflate + columnar decode for the whole
    # selected range, so the GIL stays released for the full decode window
    # and threads decoding other files run concurrently
    offs_a = np.asarray(offsets[sel], dtype=np.int64)
    lens_a = np.asarray(lengths[sel], dtype=np.int64)
    cnts_a = np.asarray(counts[sel], dtype=np.int64)
    handle = lib.avro_decode_packed(
        ctypes.cast(ctypes.c_char_p(data), u8p),
        len(data),
        offs_a.ctypes.data_as(i64p),
        lens_a.ctypes.data_as(i64p),
        cnts_a.ctypes.data_as(i64p),
        stop - block_start,
        1 if codec == "deflate" else 0,
        prog.ctypes.data_as(i32p),
        len(plan.program) // 3,
        len(plan.num_fields),
        plan.n_str_cols,
        len(plan.bag_fields),
        ctypes.cast(ctypes.c_char_p(tag_bytes), u8p),
        tag_lens.ctypes.data_as(i32p),
        len(tag_names),
        plan.tag_col_base,
    )
    if not handle:
        logger.warning("%s: native decode failed; python fallback", path)
        return None
    try:
        n = int(lib.res_n_rows(handle))
        num = {}
        num_present = {}
        for name, i in plan.num_fields.items():
            num[name] = _np_from(lib.res_num_col(handle, i), n, np.float64)
            num_present[name] = (
                _np_from(lib.res_num_present(handle, i), n, np.uint8) > 0
            )
        arena_len = _c_i64()
        arena_ptr = lib.res_str_arena(handle, ctypes.byref(arena_len))
        arena = (
            ctypes.string_at(arena_ptr, arena_len.value)
            if arena_len.value
            else b""
        )
        def str_col(i):
            return (
                arena,
                _np_from(lib.res_str_off(handle, i), n, np.int64),
                _np_from(lib.res_str_len(handle, i), n, np.int32),
            )

        strs = {name: str_col(i) for name, i in plan.str_fields.items()}
        tag_strs = {name: str_col(i) for name, i in plan.tags.items()}
        karena_len = _c_i64()
        karena_ptr = lib.res_key_arena(handle, ctypes.byref(karena_len))
        key_arena = (
            ctypes.string_at(karena_ptr, karena_len.value)
            if karena_len.value
            else b""
        )
        bags = {}
        for name, b in plan.bag_fields.items():
            cnt = int(lib.res_bag_count(handle, b))
            bags[name] = (
                _np_from(lib.res_bag_rec(handle, b), cnt, np.int64),
                _np_from(lib.res_bag_val(handle, b), cnt, np.float32),
                _np_from(lib.res_bag_key_off(handle, b), cnt, np.int64),
                _np_from(lib.res_bag_key_len(handle, b), cnt, np.int32),
            )
        return ColumnarFile(n, num, num_present, strs, tag_strs, bags, key_arena)
    finally:
        lib.res_free(handle)


def dedup_keys(
    arena: bytes, offs: np.ndarray, lens: np.ndarray
) -> Tuple[np.ndarray, List[str]]:
    """(dense ids aligned with offs/lens, unique keys in first-appearance
    order — the id assignment DefaultIndexMap would produce)."""
    lib = _load_native()
    n = len(offs)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    h = lib.key_dedup(
        ctypes.cast(ctypes.c_char_p(arena), u8p),
        np.ascontiguousarray(offs, dtype=np.int64).ctypes.data_as(
            ctypes.POINTER(_c_i64)
        ),
        np.ascontiguousarray(lens, dtype=np.int32).ctypes.data_as(
            ctypes.POINTER(_c_i32)
        ),
        n,
    )
    try:
        ids = _np_from(lib.dedup_ids(h), n, np.int64)
        nu = int(lib.dedup_n_unique(h))
        u_off = _np_from(lib.dedup_u_off(h), nu, np.int64)
        u_len = _np_from(lib.dedup_u_len(h), nu, np.int32)
        uniques = [
            arena[o : o + k].decode("utf-8") for o, k in zip(u_off.tolist(), u_len.tolist())
        ]
        return ids, uniques
    finally:
        lib.dedup_free(h)


def decode_strings(col: Tuple[bytes, np.ndarray, np.ndarray]) -> List[Optional[str]]:
    """Materialize a string column (None where absent)."""
    arena, off, ln = col
    pairs = zip(off.tolist(), ln.tolist())
    if arena.isascii():
        # byte offsets are character offsets: one decode, then slices
        text = arena.decode("ascii")
        return [None if n < 0 else text[o : o + n] for o, n in pairs]
    return [None if n < 0 else arena[o : o + n].decode("utf-8") for o, n in pairs]
