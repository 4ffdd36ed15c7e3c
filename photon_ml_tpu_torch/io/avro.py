"""Minimal Avro binary codec + object container files (spec-conformant).

No external Avro dependency exists in this environment, so the subset of the
Avro 1.x specification the reference's wire formats need is implemented here:
primitives, records, arrays, maps, unions, enums and fixed, plus the object
container file framing (magic, metadata map, sync-marker-delimited blocks,
null/deflate codecs). Files interoperate with the reference's
photon-avro-schemas records (TrainingExampleAvro etc.).

Reference parity: the schemas live in photon-avro-schemas/src/main/avro/*;
serialization call sites are photon-client data/avro/AvroUtils.scala:46 and
ModelProcessingUtils.scala:58.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterable, Iterator, List, Optional

MAGIC = b"Obj\x01"
SYNC_SIZE = 16
DEFAULT_SYNC_INTERVAL = 64 * 1024  # bytes of serialized data per block

_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes", "string"}


class AvroSchema:
    """A parsed schema plus the registry of named types it defines."""

    def __init__(self, schema: Any):
        if isinstance(schema, str) and schema.lstrip().startswith(("{", "[")):
            schema = json.loads(schema)
        self.named: Dict[str, Any] = {}
        self.root = self._resolve(schema)

    def _resolve(self, s: Any) -> Any:
        """Normalize: register named types, inline name references."""
        if isinstance(s, str):
            if s in _PRIMITIVES:
                return s
            if s in self.named:
                return self.named[s]
            raise ValueError(f"unknown type name: {s}")
        if isinstance(s, list):  # union
            return [self._resolve(b) for b in s]
        if isinstance(s, dict):
            t = s.get("type")
            if t in ("record", "enum", "fixed"):
                out = dict(s)
                self._register(out)
                if t == "record":
                    out["fields"] = [
                        dict(f, type=self._resolve(f["type"])) for f in s["fields"]
                    ]
                return out
            if t == "array":
                return {"type": "array", "items": self._resolve(s["items"])}
            if t == "map":
                return {"type": "map", "values": self._resolve(s["values"])}
            if isinstance(t, (dict, list)):
                return self._resolve(t)
            if t in _PRIMITIVES:
                return t
        raise ValueError(f"unsupported schema: {s!r}")

    def _register(self, s: Dict[str, Any]) -> None:
        name = s["name"]
        ns = s.get("namespace")
        self.named[name] = s
        if ns:
            self.named[f"{ns}.{name}"] = s

    def to_json(self) -> str:
        """Serialize with named types defined once and referenced by name
        afterwards (spec parsers reject duplicate definitions)."""
        seen: set = set()

        def ser(s: Any) -> Any:
            if isinstance(s, str):
                return s
            if isinstance(s, list):
                return [ser(b) for b in s]
            t = s.get("type")
            if t in ("record", "enum", "fixed"):
                full = (
                    f"{s['namespace']}.{s['name']}" if s.get("namespace")
                    else s["name"]
                )
                if full in seen:
                    return s["name"]
                seen.add(full)
                out = {k: v for k, v in s.items() if k != "fields"}
                if t == "record":
                    out["fields"] = [
                        {"name": f["name"], "type": ser(f["type"]),
                         **({"default": f["default"]} if "default" in f else {})}
                        for f in s["fields"]
                    ]
                return out
            if t == "array":
                return {"type": "array", "items": ser(s["items"])}
            if t == "map":
                return {"type": "map", "values": ser(s["values"])}
            return s

        return json.dumps(ser(self.root))


# ---------------------------------------------------------------- encoding

_PACK_FLOAT = struct.Struct("<f").pack
_PACK_DOUBLE = struct.Struct("<d").pack
_SMALL_LONGS = [bytes([n << 1]) for n in range(64)]  # 0..63: one byte


def _long_bytes(n: int) -> bytes:
    """Zigzag varint (Avro spec 'int and long')."""
    if 0 <= n < 64:
        return _SMALL_LONGS[n]
    n = (n << 1) ^ (n >> 63)
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _write_long(out: BinaryIO, n: int) -> None:
    out.write(_long_bytes(n))


def _union_branch(schema: List[Any], value: Any) -> int:
    """Pick the union branch for a Python value (None/bool/num/str/bytes/
    dict/list matched structurally)."""
    def kind(s: Any) -> str:
        return s if isinstance(s, str) else s["type"]

    for i, branch in enumerate(schema):
        k = kind(branch)
        if value is None and k == "null":
            return i
        if isinstance(value, bool) and k == "boolean":
            return i
        if isinstance(value, str) and k in ("string", "enum"):
            return i
        if isinstance(value, (bytes, bytearray)) and k in ("bytes", "fixed"):
            return i
        if isinstance(value, bool):
            continue
        if isinstance(value, int) and k in ("int", "long", "float", "double"):
            return i
        if isinstance(value, float) and k in ("float", "double"):
            return i
        if isinstance(value, dict) and k in ("record", "map"):
            return i
        if isinstance(value, (list, tuple)) and k == "array":
            return i
    raise ValueError(f"no union branch in {schema} for {value!r}")


def _encode(out: BinaryIO, schema: Any, value: Any) -> None:
    _compile_encoder(schema)(out.write, value)


def _compile_encoder(schema: Any, memo: Optional[Dict[int, Any]] = None):
    """Compile ``schema`` into ``fn(write, value)``, which writes the binary
    encoding of ``value`` through ``write``. The schema is walked here once,
    not per value; a named record that refers to itself compiles once
    (``memo``)."""
    if memo is None:
        memo = {}
    if isinstance(schema, list):
        branches = [_compile_encoder(b, memo) for b in schema]

        def union(write, value):
            i = _union_branch(schema, value)
            write(_long_bytes(i))
            branches[i](write, value)

        return union
    t = schema if isinstance(schema, str) else schema["type"]
    if t == "null":
        return lambda write, value: None
    if t == "boolean":
        return lambda write, value: write(b"\x01" if value else b"\x00")
    if t in ("int", "long"):
        return lambda write, value: write(_long_bytes(int(value)))
    if t == "float":
        return lambda write, value: write(_PACK_FLOAT(float(value)))
    if t == "double":
        return lambda write, value: write(_PACK_DOUBLE(float(value)))
    if t == "bytes":
        def raw_bytes(write, value):
            write(_long_bytes(len(value)))
            write(value)

        return raw_bytes
    if t == "string":
        def string(write, value):
            raw = value.encode("utf-8")
            write(_long_bytes(len(raw)))
            write(raw)

        return string
    if t == "record":
        if id(schema) in memo:
            return memo[id(schema)]
        fields = []

        def record(write, value):
            for name, fn, has_default, default in fields:
                if name in value:
                    fn(write, value[name])
                elif has_default:
                    fn(write, default)
                else:
                    raise ValueError(f"missing field {name}")

        memo[id(schema)] = record
        fields.extend((f["name"], _compile_encoder(f["type"], memo), "default" in f,
                       f.get("default")) for f in schema["fields"])
        return record
    if t == "array":
        item = _compile_encoder(schema["items"], memo)

        def array(write, value):
            if value:
                write(_long_bytes(len(value)))
                for v in value:
                    item(write, v)
            write(b"\x00")

        return array
    if t == "map":
        key = _compile_encoder("string")
        item = _compile_encoder(schema["values"], memo)

        def map_(write, value):
            if value:
                write(_long_bytes(len(value)))
                for k, v in value.items():
                    key(write, k)
                    item(write, v)
            write(b"\x00")

        return map_
    if t == "enum":
        symbols = schema["symbols"]
        return lambda write, value: write(_long_bytes(symbols.index(value)))
    if t == "fixed":
        size = schema["size"]

        def fixed(write, value):
            if len(value) != size:
                raise ValueError("fixed size mismatch")
            write(value)

        return fixed
    raise ValueError(f"cannot encode type {t}")


# ---------------------------------------------------------------- decoding

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError("truncated avro data")
        self.pos += n
        return b

    def read_long(self) -> int:
        shift, acc = 0, 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)


def _decode(r: _Reader, schema: Any) -> Any:
    if isinstance(schema, list):
        i = r.read_long()
        if not 0 <= i < len(schema):
            raise ValueError(f"union branch index {i} out of range")
        return _decode(r, schema[i])
    t = schema if isinstance(schema, str) else schema["type"]
    if t == "null":
        return None
    if t == "boolean":
        return r.read(1) != b"\x00"
    if t in ("int", "long"):
        return r.read_long()
    if t == "float":
        return struct.unpack("<f", r.read(4))[0]
    if t == "double":
        return struct.unpack("<d", r.read(8))[0]
    if t == "bytes":
        return r.read(r.read_long())
    if t == "string":
        return r.read(r.read_long()).decode("utf-8")
    if t == "record":
        return {f["name"]: _decode(r, f["type"]) for f in schema["fields"]}
    if t == "array":
        return _read_blocks(r, lambda rr: _decode(rr, schema["items"]))
    if t == "map":
        return dict(
            _read_blocks(
                r, lambda rr: (_decode(rr, "string"), _decode(rr, schema["values"]))
            )
        )
    if t == "enum":
        i = r.read_long()
        if not 0 <= i < len(schema["symbols"]):
            raise ValueError(f"enum index {i} out of range")
        return schema["symbols"][i]
    if t == "fixed":
        return r.read(schema["size"])
    raise ValueError(f"cannot decode type {t}")


# ------------------------------------------------- schema resolution (read)

_PROMOTIONS = {
    "int": ("long", "float", "double"),
    "long": ("float", "double"),
    "float": ("double",),
    "string": ("bytes",),
    "bytes": ("string",),
}


def _type_kind(s: Any) -> str:
    return s if isinstance(s, str) else s["type"]


def _names_compatible(w: Any, r: Any) -> bool:
    wn = w.get("name") if isinstance(w, dict) else None
    rn = r.get("name") if isinstance(r, dict) else None
    # unqualified comparison; aliases are not supported
    if wn is None or rn is None:
        return True
    return wn.split(".")[-1] == rn.split(".")[-1]


def canonical_form(s: Any) -> Any:
    """Structural normal form for schema equivalence: strips doc/order/
    namespace decoration so two spellings of one schema compare equal (and
    take the fast non-resolving decode path)."""
    if isinstance(s, list):
        return [canonical_form(b) for b in s]
    if isinstance(s, str):
        return s
    t = s["type"]
    out: Dict[str, Any] = {"type": t}
    if "name" in s:
        out["name"] = s["name"].split(".")[-1]
    if t == "record":
        out["fields"] = [
            {"name": f["name"], "type": canonical_form(f["type"])}
            for f in s["fields"]
        ]
    elif t == "array":
        out["items"] = canonical_form(s["items"])
    elif t == "map":
        out["values"] = canonical_form(s["values"])
    elif t == "enum":
        out["symbols"] = list(s["symbols"])
    elif t == "fixed":
        out["size"] = s["size"]
    return out


def _match_reader_branch(writer: Any, reader_union: List[Any]) -> Optional[Any]:
    wk = _type_kind(writer)
    for branch in reader_union:
        rk = _type_kind(branch)
        if rk == wk and _names_compatible(writer, branch):
            return branch
    for branch in reader_union:
        if _type_kind(branch) in _PROMOTIONS.get(wk, ()):
            return branch
    return None


def _default_value(schema: Any, default: Any) -> Any:
    """JSON default -> runtime value (Avro spec: bytes/fixed defaults are
    codepoint-latin-1 strings; union defaults use the first branch).
    Containers are copied fresh per call so records never share state."""
    if isinstance(schema, list):
        return _default_value(schema[0], default)
    t = _type_kind(schema)
    if t in ("bytes", "fixed") and isinstance(default, str):
        return default.encode("latin-1")
    if t == "record":
        out = {}
        for f in schema["fields"]:
            if isinstance(default, dict) and f["name"] in default:
                out[f["name"]] = _default_value(f["type"], default[f["name"]])
            elif "default" in f:
                out[f["name"]] = _default_value(f["type"], f["default"])
            else:
                raise ValueError(f"record default missing field {f['name']}")
        return out
    if t == "array":
        return [_default_value(schema["items"], v) for v in default]
    if t == "map":
        return {k: _default_value(schema["values"], v) for k, v in default.items()}
    if t in ("float", "double"):
        return float(default)  # int JSON default -> float value
    return default


def _default_factory(schema: Any, default: Any):
    """Compile a zero-arg factory for a reader default: the JSON->runtime
    conversion happens once here; per record only containers are copied
    (records must never share mutable state)."""
    value = _default_value(schema, default)
    if isinstance(value, (dict, list)):
        import copy

        return lambda value=value: copy.deepcopy(value)
    return lambda value=value: value


def _read_blocks(r: _Reader, item_fn) -> List[Any]:
    """Shared array block framing: count-prefixed blocks, 0 terminates,
    negative count carries a discarded byte-size prefix."""
    out: List[Any] = []
    while True:
        n = r.read_long()
        if n == 0:
            return out
        if n < 0:
            n = -n
            r.read_long()
        for _ in range(n):
            out.append(item_fn(r))


def compile_resolver(writer: Any, reader: Any):
    """Compile (writer schema -> reader schema) resolution into a decode
    closure ``fn(_Reader) -> value`` (Avro spec 'Schema Resolution': fields
    matched by name, defaults for reader-only fields, writer-only fields
    skipped, numeric and string<->bytes promotions, union re-matching).
    All schema walking happens here, once — not per record."""
    if isinstance(writer, list):
        # an unresolvable branch only errors if a datum actually uses it
        # (the spec errors per-datum; union narrowing is legal evolution)
        def _branch_fn(b):
            try:
                return compile_resolver(b, reader)
            except ValueError as e:
                msg = str(e)

                def fail(r: _Reader, msg=msg):
                    raise ValueError(msg)

                return fail

        branch_fns = [_branch_fn(b) for b in writer]

        def union_fn(r: _Reader, fns=branch_fns):
            i = r.read_long()
            if not 0 <= i < len(fns):
                raise ValueError(f"union branch index {i} out of range")
            return fns[i](r)

        return union_fn
    if isinstance(reader, list):
        target = _match_reader_branch(writer, reader)
        if target is None:
            raise ValueError(
                f"writer type {_type_kind(writer)!r} matches no reader union branch"
            )
        return compile_resolver(writer, target)

    wk, rk = _type_kind(writer), _type_kind(reader)
    if wk != rk:
        if rk not in _PROMOTIONS.get(wk, ()):
            raise ValueError(f"cannot resolve writer {wk!r} to reader {rk!r}")
        if rk in ("float", "double"):
            return lambda r: float(_decode(r, writer))
        if rk == "bytes":
            return lambda r: _decode(r, writer).encode("utf-8")
        if rk == "string":
            return lambda r: _decode(r, writer).decode("utf-8")
        return lambda r: _decode(r, writer)  # int -> long

    if wk == "record":
        if not _names_compatible(writer, reader):
            raise ValueError(
                f"record name mismatch: {writer.get('name')} vs {reader.get('name')}"
            )
        reader_fields = {f["name"]: f for f in reader["fields"]}
        # ops: (field name to set | None for skip, decode fn)
        ops = []
        for wf in writer["fields"]:
            rf = reader_fields.get(wf["name"])
            if rf is None:
                ops.append((None, lambda r, s=wf["type"]: _decode(r, s)))
            else:
                ops.append((wf["name"], compile_resolver(wf["type"], rf["type"])))
        written = {f["name"] for f in writer["fields"]}
        defaulted = []
        for rf in reader["fields"]:
            if rf["name"] not in written:
                if "default" not in rf:
                    raise ValueError(
                        f"reader field {rf['name']!r} absent from writer and "
                        "has no default"
                    )
                defaulted.append(
                    (rf["name"], _default_factory(rf["type"], rf["default"]))
                )

        def record_fn(r: _Reader):
            out: Dict[str, Any] = {}
            for name, fn in ops:
                v = fn(r)
                if name is not None:
                    out[name] = v
            for name, make in defaulted:
                out[name] = make()
            return out

        return record_fn
    if wk == "array":
        item = compile_resolver(writer["items"], reader["items"])
        return lambda r: _read_blocks(r, item)
    if wk == "map":
        value = compile_resolver(writer["values"], reader["values"])

        def map_fn(r: _Reader):
            pairs = _read_blocks(
                r, lambda rr: (_decode(rr, "string"), value(rr))
            )
            return dict(pairs)

        return map_fn
    if wk == "enum":
        symbols = list(writer["symbols"])
        known = set(reader["symbols"])
        # Avro spec (1.9+): a writer symbol absent from the reader's enum
        # resolves to the reader's default symbol when one is declared.
        fallback = reader.get("default")
        if fallback is not None and fallback not in known:
            raise ValueError(
                f"enum default {fallback!r} is not one of the reader's "
                f"symbols {sorted(known)}"
            )

        def enum_fn(r: _Reader):
            i = r.read_long()
            if not 0 <= i < len(symbols):
                raise ValueError(f"enum index {i} out of range")
            sym = symbols[i]
            if sym not in known:
                if fallback is not None:
                    return fallback
                raise ValueError(
                    f"enum symbol {sym!r} unknown to reader and the reader "
                    "enum declares no default"
                )
            return sym

        return enum_fn
    if wk == "fixed":
        if writer["size"] != reader["size"]:
            raise ValueError("fixed size mismatch between writer and reader")
        size = writer["size"]
        return lambda r: r.read(size)
    return lambda r: _decode(r, writer)  # identical primitive


# ----------------------------------------------------- object container file

def write_avro_file(
    path: str,
    schema: AvroSchema | Any,
    records: Iterable[Dict[str, Any]],
    codec: str = "deflate",
    sync_interval: int = DEFAULT_SYNC_INTERVAL,
) -> int:
    """Write an Avro object container file; returns the record count."""
    if not isinstance(schema, AvroSchema):
        schema = AvroSchema(schema)
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec: {codec}")
    sync = os.urandom(SYNC_SIZE)
    count_total = 0
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = {
            "avro.schema": schema.to_json().encode("utf-8"),
            "avro.codec": codec.encode("utf-8"),
        }
        _encode(f, {"type": "map", "values": "bytes"}, meta)
        f.write(sync)

        block = io.BytesIO()
        block_count = 0

        def flush() -> None:
            nonlocal block, block_count
            if block_count == 0:
                return
            payload = block.getvalue()
            if codec == "deflate":
                # Avro deflate = raw DEFLATE stream (no zlib header)
                payload = zlib.compress(payload)[2:-4]
            _write_long(f, block_count)
            _write_long(f, len(payload))
            f.write(payload)
            f.write(sync)
            block = io.BytesIO()
            block_count = 0

        encode = _compile_encoder(schema.root)
        for rec in records:
            encode(block.write, rec)
            block_count += 1
            count_total += 1
            if block.tell() >= sync_interval:
                flush()
        flush()
    return count_total


def read_avro_file(
    path: str, schema: Optional[AvroSchema] = None
) -> Iterator[Dict[str, Any]]:
    """Iterate records of an Avro object container file.

    Decoding uses the writer schema embedded in the file. When a reader
    ``schema`` is given and differs, records are resolved to it per the
    Avro spec (fields matched by name, reader-only fields take their
    defaults, writer-only fields are skipped, numeric and string<->bytes
    promotions applied); a root-record-name mismatch raises.
    """
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    meta = _decode(r, {"type": "map", "values": "bytes"})
    writer_schema = AvroSchema(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    sync = r.read(SYNC_SIZE)
    if schema is not None:
        want = schema.root.get("name") if isinstance(schema.root, dict) else None
        got = (
            writer_schema.root.get("name")
            if isinstance(writer_schema.root, dict)
            else None
        )
        if want is not None and got is not None and want.split(".")[-1] != got.split(".")[-1]:
            raise ValueError(
                f"{path}: contains {got!r} records, expected {want!r}"
            )
        # structural comparison: doc/order/namespace spelling differences
        # must not force the (slower) resolving path
        if canonical_form(writer_schema.root) != canonical_form(schema.root):
            decode_fn = compile_resolver(writer_schema.root, schema.root)
        else:
            decode_fn = None
    else:
        decode_fn = None
    while r.pos < len(r.buf):
        n = r.read_long()
        size = r.read_long()
        payload = r.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec != "null":
            raise ValueError(f"unsupported codec: {codec}")
        br = _Reader(payload)
        for _ in range(n):
            if decode_fn is not None:
                yield decode_fn(br)
            else:
                yield _decode(br, writer_schema.root)
        if r.read(SYNC_SIZE) != sync:
            raise ValueError(f"{path}: sync marker mismatch (corrupt file)")


def list_part_files(path: str) -> list:
    """The container files under a path: [path] for a file, else the
    sorted part-*.avro files of the directory (one listing rule shared by
    every reader)."""
    if os.path.isfile(path):
        return [path]
    return [
        os.path.join(path, n)
        for n in sorted(os.listdir(path))
        if n.endswith(".avro") and not n.startswith(".")
    ]


def read_avro_dir(path: str, schema: Optional[AvroSchema] = None) -> Iterator[Dict[str, Any]]:
    """Read all part files of a directory (the reference's part-*.avro
    layout), or a single file when given one."""
    for p in list_part_files(path):
        yield from read_avro_file(p, schema)
