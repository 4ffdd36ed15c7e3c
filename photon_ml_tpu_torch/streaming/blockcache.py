"""Decoded block cache: padded ELL blocks spilled to an mmap-able file, so
passes after the first stream blocks with no Avro work.

Port of ``photon_ml_tpu/streaming/blockcache.py`` (numpy only, copied, with
a bulk decode of ASCII id tags on load): the same file format (magic ``PHBLKC01``, version 1), the same plan
fingerprint, the same fault sites. For the same part files and index maps
(equal ``content_digest``) an entry written by this package is byte-equal
to the JAX package's, and either package hits the other's cache.

* After ``StreamingSource.build_block`` first materializes a padded
  :class:`HostBlock`, its arrays are spilled to ONE file per (block,
  shard-subset): an 8-byte magic, a JSON header (cache version, plan
  fingerprint, per-array dtype/shape/offset manifest, per-array crc32
  checksums), then the raw little-endian array bytes at 64-byte alignment.
* Reloading maps the file with ``np.memmap`` and returns dtype/shape views
  into the mapping: zero copy, paged in lazily, so a warm pass costs one
  page-cache read per block. The views are read-only; the prefetcher
  copies them into pinned staging before the upload.
* Writers build the entry under a private ``.tmp`` name and ``os.replace``
  it into place, so a reader never observes a torn file.
* Every load validates the magic, version, plan fingerprint and (once per
  process per entry) the per-array checksums; ANY mismatch (truncation,
  corruption, a stale fingerprint after the input data changed) is a miss,
  the caller re-decodes, and the entry is rewritten.

The plan fingerprint commits to the cache version, ``block_rows``, the
ordered part-file list with each file's size and mtime_ns, the feature
shard layout (ELL widths and dims), a content digest of each shard's
feature index map, the id tags and the reader column options, so editing
an input file, swapping the index maps, re-sharding features or changing
the block size all invalidate cleanly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import tempfile
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.resilience.failures import record_failure
from photon_ml_tpu_torch.resilience.faultpoints import fault_point, register_fault_site
from photon_ml_tpu_torch.resilience.retry import RetryExhausted, RetryPolicy

logger = logging.getLogger("photon_ml_tpu_torch")

MAGIC = b"PHBLKC01"
CACHE_VERSION = 1
_ALIGN = 64

FAULT_CACHE_LOAD = register_fault_site(
    "stream.blockcache.load",
    "block-cache entry open/mmap (retried once; any persistent failure"
    " is a clean miss and the block re-decodes)",
)
FAULT_CACHE_STORE = register_fault_site(
    "stream.blockcache.store",
    "block-cache spill write+publish (retried once; a failing cache"
    " never fails training)",
)

# cache IO gets a tighter policy than the decode seam: the fallback
# (re-decode / skip the spill) is cheap, so one quick retry is enough
_CACHE_RETRY = RetryPolicy(max_attempts=2, base_delay_s=0.01)


def _index_map_digest(im) -> str:
    """Digest of one shard's feature name->index assignment."""
    fn = getattr(im, "content_digest", None)
    if callable(fn):
        return str(fn())
    # foreign map object: walk the dense index space (IndexMap contract)
    h = hashlib.sha256()
    for i in range(len(im)):
        h.update(f"{im.get_feature_name(i)}\x00{i}\x01".encode("utf-8"))
    return h.hexdigest()


def plan_fingerprint(
    block_rows: int,
    files: Sequence[str],
    shard_widths: Dict[str, int],
    shard_dims: Dict[str, int],
    id_tags: Sequence[str] = (),
    read_kwargs: Optional[dict] = None,
    index_maps: Optional[Dict[str, object]] = None,
) -> str:
    """Digest of everything the bytes of a decoded block depend on.

    File identity is (path, size, mtime_ns): touching or rewriting any
    part file changes the fingerprint and orphans the old entries (they
    are swept lazily by :meth:`BlockCache.sweep_stale`).

    ``index_maps`` (shard -> IndexMap) MUST be passed whenever the maps
    are loaded externally (--offheap-indexmap-dir): decoded column ids
    are a function of the name->index assignment, and two same-size maps
    with permuted assignments would otherwise produce identical
    fingerprints and silently serve blocks with wrong column indices.
    """
    stats = []
    for path in files:
        st = os.stat(path)
        stats.append([str(path), int(st.st_size), int(st.st_mtime_ns)])
    doc = {
        "version": CACHE_VERSION,
        "block_rows": int(block_rows),
        "files": stats,
        "shard_widths": {k: int(v) for k, v in sorted(shard_widths.items())},
        "shard_dims": {k: int(v) for k, v in sorted(shard_dims.items())},
        "id_tags": list(id_tags),
        "read_kwargs": sorted(
            (str(k), str(v)) for k, v in (read_kwargs or {}).items()
        ),
        "index_maps": {
            str(sid): _index_map_digest(im)
            for sid, im in sorted((index_maps or {}).items())
        },
    }
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _shard_sig(shards: Sequence[str]) -> str:
    blob = "\x00".join(sorted(shards))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:10]


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


@dataclasses.dataclass
class CacheStats:
    """Host-side accounting of one BlockCache (cumulative per instance)."""

    hits: int = 0
    misses: int = 0
    writes: int = 0
    invalid: int = 0       # entries rejected (corrupt/stale) — re-decoded
    load_s: float = 0.0    # wall seconds spent mapping + validating
    write_s: float = 0.0   # wall seconds spent spilling entries


class BlockCache:
    """One fingerprint-keyed directory of spilled block files.

    Layout: ``<root>/<fingerprint[:20]>/block-<index>-<shardsig>.blk``.
    The fingerprint prefix keys the *directory*, so a changed input
    dataset naturally misses without any entry-by-entry checks; the full
    fingerprint is ALSO stored in every header and re-verified on load
    (a truncated hash collision must not resurrect stale data).
    """

    def __init__(self, root: str, fingerprint: str):
        self.root = str(root)
        self.fingerprint = str(fingerprint)
        self.dir = os.path.join(self.root, self.fingerprint[:20])
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._validated: set = set()  # entry paths whose checksums passed

    # -- paths -------------------------------------------------------------

    def entry_path(self, index: int, shards: Sequence[str]) -> str:
        return os.path.join(
            self.dir, f"block-{int(index):06d}-{_shard_sig(shards)}.blk"
        )

    # -- write -------------------------------------------------------------

    def store(self, block, shards: Sequence[str]) -> bool:
        """Spill one HostBlock. Returns False (and logs) on any IO error —
        a failing cache must never fail training."""
        import time as _time

        t0 = _time.perf_counter()
        try:
            os.makedirs(self.dir, exist_ok=True)
            arrays: List[Tuple[str, np.ndarray]] = [
                ("labels", np.ascontiguousarray(block.labels)),
                ("offsets", np.ascontiguousarray(block.offsets)),
                ("weights", np.ascontiguousarray(block.weights)),
            ]
            for sid in sorted(block.shards):
                vals, idx = block.shards[sid]
                arrays.append((f"shard:{sid}:vals", np.ascontiguousarray(vals)))
                arrays.append((f"shard:{sid}:idx", np.ascontiguousarray(idx)))
            tag_meta: Dict[str, str] = {}
            for tag in sorted(block.id_tags):
                arena, offs = _encode_strings(block.id_tags[tag])
                arrays.append((f"tag:{tag}:arena", arena))
                arrays.append((f"tag:{tag}:off", offs))
                tag_meta[tag] = str(block.id_tags[tag].dtype)

            manifest = []
            offset = 0
            for name, arr in arrays:
                offset = _align(offset)
                manifest.append({
                    "name": name,
                    "dtype": arr.dtype.str,      # little-endian '<f4' etc.
                    "shape": list(arr.shape),
                    "offset": offset,
                    "nbytes": int(arr.nbytes),
                    "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
                })
                offset += arr.nbytes
            header = {
                "version": CACHE_VERSION,
                "fingerprint": self.fingerprint,
                "index": int(block.index),
                "start": int(block.start),
                "num_real": int(block.num_real),
                "shards": sorted(block.shards),
                "tag_dtypes": tag_meta,
                "arrays": manifest,
            }
            hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
            base = _align(len(MAGIC) + 4 + len(hdr))

            path = self.entry_path(block.index, shards)

            def _publish():
                # each attempt writes a fresh private tmp, so a retried
                # publish never reuses a half-written file
                fault_point(FAULT_CACHE_STORE)
                fd, tmp = tempfile.mkstemp(
                    dir=self.dir, prefix=f".tmp-{os.getpid()}-", suffix=".blk"
                )
                try:
                    with os.fdopen(fd, "wb") as f:
                        f.write(MAGIC)
                        f.write(len(hdr).to_bytes(4, "little"))
                        f.write(hdr)
                        f.write(b"\x00" * (base - len(MAGIC) - 4 - len(hdr)))
                        at = 0
                        for _, arr in arrays:
                            pad = _align(at) - at
                            if pad:
                                f.write(b"\x00" * pad)
                                at += pad
                            f.write(arr.tobytes())
                            at += arr.nbytes
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, path)  # atomic publish: readers never see torn files
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)

            _CACHE_RETRY.run("stream.blockcache.store", _publish)
            with self._lock:
                self.stats.writes += 1
                self._validated.add(path)  # we just wrote + checksummed it
            return True
        except Exception as e:
            # not just OSError: an odd id-tag dtype, a MemoryError on
            # tobytes() of a huge shard — none of it may abort training
            logger.warning("block cache store failed (%s); continuing", e)
            record_failure(
                "cache_store_failed",
                "stream.blockcache.store",
                f"{type(e).__name__}: {e}",
                block=int(block.index),
            )
            return False
        finally:
            with self._lock:
                self.stats.write_s += _time.perf_counter() - t0

    # -- read --------------------------------------------------------------

    def load(self, index: int, shards: Sequence[str]):
        """Return a HostBlock backed by memmap views, or None on miss or
        any validation failure (the caller then re-decodes and rewrites).
        Checksums are verified the first time each entry is loaded by this
        process; later loads of a validated entry skip the pass so warm
        epochs run at page-cache speed."""
        import time as _time

        from photon_ml_tpu_torch.streaming.blocks import HostBlock

        t0 = _time.perf_counter()
        path = self.entry_path(index, shards)

        def _open():
            # map via an explicit fd so fstat pins the identity of the file
            # actually mapped: the invalidation unlink below must not delete
            # a FRESH entry a concurrent writer just os.replace'd over this
            # path after we opened the stale one
            fault_point(FAULT_CACHE_LOAD)
            with open(path, "rb") as f:
                st = os.fstat(f.fileno())
                m = np.memmap(f, dtype=np.uint8, mode="r")
            return m, (st.st_ino, st.st_size, st.st_mtime_ns)

        try:
            # FileNotFoundError is a normal miss (non-retryable); a flaky
            # open/mmap gets one quick retry before degrading to re-decode
            mm, mapped_key = _CACHE_RETRY.run("stream.blockcache.load", _open)
        except (RetryExhausted, OSError, ValueError):
            with self._lock:
                self.stats.misses += 1
                self.stats.load_s += _time.perf_counter() - t0
            return None
        try:
            header = self._parse_header(mm)
            if header is None or int(header["index"]) != int(index):
                raise ValueError("bad header")
            if header["fingerprint"] != self.fingerprint:
                raise ValueError("stale fingerprint")
            views: Dict[str, np.ndarray] = {}
            with self._lock:
                need_checksums = path not in self._validated
            # manifest offsets are relative to the aligned payload base
            # (the header length is not known until the manifest is final)
            hlen = int.from_bytes(
                mm[len(MAGIC):len(MAGIC) + 4].tobytes(), "little"
            )
            base = _align(len(MAGIC) + 4 + hlen)
            for spec in header["arrays"]:
                off = base + int(spec["offset"])
                nbytes = int(spec["nbytes"])
                if off + nbytes > mm.size:
                    raise ValueError("truncated entry")
                raw = mm[off:off + nbytes]
                if need_checksums:
                    if (zlib.crc32(raw.tobytes()) & 0xFFFFFFFF) != spec["crc32"]:
                        raise ValueError(f"checksum mismatch: {spec['name']}")
                views[spec["name"]] = (
                    raw.view(np.dtype(spec["dtype"]))
                    .reshape(tuple(spec["shape"]))
                )
            blk_shards = {}
            for sid in header["shards"]:
                blk_shards[sid] = (
                    views[f"shard:{sid}:vals"], views[f"shard:{sid}:idx"]
                )
            id_tags = {}
            for tag, dt in header.get("tag_dtypes", {}).items():
                arr = _decode_strings(
                    views[f"tag:{tag}:arena"], views[f"tag:{tag}:off"], dt
                )
                arr.flags.writeable = False  # HostBlock read-only contract
                id_tags[tag] = arr
            with self._lock:
                self.stats.hits += 1
                self._validated.add(path)
                self.stats.load_s += _time.perf_counter() - t0
            return HostBlock(
                index=int(header["index"]),
                start=int(header["start"]),
                num_real=int(header["num_real"]),
                labels=views["labels"],
                offsets=views["offsets"],
                weights=views["weights"],
                shards=blk_shards,
                id_tags=id_tags,
            )
        except (ValueError, KeyError, TypeError) as e:
            # corrupt/truncated/stale: drop the entry so the re-decode's
            # rewrite is the only copy, and miss
            logger.warning("block cache entry %s invalid (%s); re-decoding",
                           os.path.basename(path), e)
            del mm
            try:
                # unlink only while the path still holds the exact file that
                # failed validation — a concurrent writer may have replaced
                # it with a fresh valid entry since we mapped it (a remaining
                # inode-reuse window is theoretical and costs one re-decode,
                # never correctness)
                st_now = os.stat(path)
                if (st_now.st_ino, st_now.st_size,
                        st_now.st_mtime_ns) == mapped_key:
                    os.unlink(path)
            except OSError:
                pass
            with self._lock:
                self.stats.invalid += 1
                self.stats.misses += 1
                self._validated.discard(path)
                self.stats.load_s += _time.perf_counter() - t0
            return None

    def has(self, index: int, shards: Sequence[str]) -> bool:
        """Cheap existence probe (no validation) — used by the readahead
        window to skip scheduling Avro decodes for already-cached blocks."""
        return os.path.exists(self.entry_path(index, shards))

    # -- maintenance -------------------------------------------------------

    def sweep_stale(self) -> int:
        """Delete sibling fingerprint directories (entries of older plans).
        Returns the number of files removed. Safe to skip — stale dirs are
        only disk, never correctness."""
        removed = 0
        try:
            for name in os.listdir(self.root):
                sub = os.path.join(self.root, name)
                if name == self.fingerprint[:20] or not os.path.isdir(sub):
                    continue
                for f in os.listdir(sub):
                    try:
                        os.unlink(os.path.join(sub, f))
                        removed += 1
                    except OSError:
                        pass
                try:
                    os.rmdir(sub)
                except OSError:
                    pass
        except OSError:
            pass
        return removed

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _parse_header(mm: np.ndarray) -> Optional[dict]:
        if mm.size < len(MAGIC) + 4:
            return None
        if mm[: len(MAGIC)].tobytes() != MAGIC:
            return None
        hlen = int.from_bytes(mm[len(MAGIC):len(MAGIC) + 4].tobytes(), "little")
        if hlen <= 0 or len(MAGIC) + 4 + hlen > mm.size:
            return None
        try:
            header = json.loads(mm[len(MAGIC) + 4:len(MAGIC) + 4 + hlen].tobytes())
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        if not isinstance(header, dict) or header.get("version") != CACHE_VERSION:
            return None
        return header


def _encode_strings(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """String/object array -> (uint8 arena, int64 offsets[len+1])."""
    parts = [str(s).encode("utf-8") for s in arr]
    offs = np.zeros(len(parts) + 1, dtype=np.int64)
    if parts:
        np.cumsum([len(p) for p in parts], out=offs[1:])
    arena = np.frombuffer(b"".join(parts), dtype=np.uint8).copy()
    return arena, offs


def _decode_strings(arena: np.ndarray, offs: np.ndarray, dtype: str) -> np.ndarray:
    """uint8 arena + int64 offsets -> the string array of ``dtype``.

    A warm pass loads every block's id tags (65,536 strings a tag at the
    usual block size): decoded one Python string at a time that is ~50 ms
    a tag, with the interpreter lock held against the consumer's thread.
    So ASCII arenas are decoded in bulk: each string's bytes gathered into
    one row of a [n, longest] code-point matrix (zero padded), which is a
    fixed-width unicode array (an ASCII byte is its code point). Strings
    that are not ASCII, or end in a NUL (which a fixed-width string would
    drop), take the per-string path, the JAX package's. Both give the same
    array."""
    offs = np.asarray(offs, dtype=np.int64)
    arena = np.asarray(arena, dtype=np.uint8)
    lens = np.diff(offs)
    n = lens.size
    body = arena[offs[0]:offs[-1]] if n else arena[:0]
    ends_nul = bool(n) and bool((arena[offs[1:][lens > 0] - 1] == 0).any())
    if body.size and int(body.max()) < 128 and not ends_nul:
        width = int(lens.max())
        cols = np.arange(width)
        at = np.minimum(offs[:-1, None] + cols, arena.size - 1)
        points = np.where(cols < lens[:, None], arena[at], 0).astype(np.uint32)
        fixed = points.view(f"U{width}").reshape(n)
        return fixed.astype(object if dtype == "object" else np.dtype(dtype))
    blob = arena.tobytes()
    vals = [
        blob[offs[i]:offs[i + 1]].decode("utf-8")
        for i in range(len(offs) - 1)
    ]
    if dtype == "object":
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out
    return np.asarray(vals, dtype=np.dtype(dtype))
