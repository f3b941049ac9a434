"""Copied from serenedb_tpu/columnar/pgcopy.py.

PG binary COPY format codec.

Reference analog: server/connector/duckdb_pg_binary_copy.cpp — the
`PGCOPY\\n\\377\\r\\n\\0` signature, 4-byte flags + extension, per-tuple
int16 field count and int32-length-prefixed fields in PG binary send
format, int16 -1 trailer. Value encodings match server/pgwire.pg_binary
(network byte order; timestamps/dates on the 2000-01-01 PG epoch).
"""

from __future__ import annotations

import struct
from typing import Optional

from .. import errors
from . import dtypes as dt
from .column import Batch, Column

SIGNATURE = b"PGCOPY\n\xff\r\n\x00"

_PG_EPOCH_US = 946_684_800_000_000
_PG_EPOCH_DAYS = 10_957


_OID_IDS = (dt.TypeId.OID, dt.TypeId.REGCLASS, dt.TypeId.REGTYPE,
            dt.TypeId.REGPROC, dt.TypeId.REGNAMESPACE)


def encode_value(v, typ: dt.SqlType) -> Optional[bytes]:
    """One field's binary payload (no length prefix); None = NULL.
    Single source of truth for PG binary sends — the wire result encoder
    (server/pgwire.pg_binary) delegates here."""
    if v is None:
        return None
    tid = typ.id
    if tid is dt.TypeId.BOOL:
        return b"\x01" if v else b"\x00"
    if tid in (dt.TypeId.TINYINT, dt.TypeId.SMALLINT):
        return struct.pack("!h", int(v))
    if tid is dt.TypeId.INT:
        return struct.pack("!i", int(v))
    if tid is dt.TypeId.BIGINT:
        return struct.pack("!q", int(v))
    if tid is dt.TypeId.FLOAT:
        return struct.pack("!f", float(v))
    if tid is dt.TypeId.DOUBLE:
        return struct.pack("!d", float(v))
    if tid is dt.TypeId.TIMESTAMP:
        return struct.pack("!q", int(v) - _PG_EPOCH_US)
    if tid is dt.TypeId.DATE:
        return struct.pack("!i", int(v) - _PG_EPOCH_DAYS)
    if tid is dt.TypeId.INTERVAL:
        return struct.pack("!qii", int(v), 0, 0)
    if tid in _OID_IDS:
        return struct.pack("!I", int(v) & 0xFFFFFFFF)
    if tid is dt.TypeId.ARRAY:
        return _encode_array_binary(str(v), typ.elem or dt.TypeId.VARCHAR)
    if tid is dt.TypeId.RECORD:
        return _encode_record_binary(str(v))
    return str(v).encode()


#: element TypeId → array OID (PG catalog values; record fields carry
#: these so nested arrays render/encode as real arrays)
_ARRAY_OID_OF_ELEM = {
    dt.TypeId.BOOL: 1000, dt.TypeId.SMALLINT: 1005, dt.TypeId.TINYINT: 1005,
    dt.TypeId.INT: 1007, dt.TypeId.BIGINT: 1016, dt.TypeId.FLOAT: 1021,
    dt.TypeId.DOUBLE: 1022, dt.TypeId.VARCHAR: 1009,
    dt.TypeId.DATE: 1182, dt.TypeId.TIMESTAMP: 1115,
}

#: OID → SqlType for record field encoding/rendering (record values
#: carry per-field OIDs in their physical JSON)
_TYPE_OF_OID = {
    16: dt.BOOL, 21: dt.SMALLINT, 23: dt.INT, 20: dt.BIGINT,
    700: dt.FLOAT, 701: dt.DOUBLE, 25: dt.VARCHAR,
    1082: dt.DATE, 1114: dt.TIMESTAMP, 1186: dt.INTERVAL,
    2249: dt.RECORD,
}
for _e, _oid in _ARRAY_OID_OF_ELEM.items():
    _TYPE_OF_OID.setdefault(_oid, dt.SqlType(dt.TypeId.ARRAY, _e))

#: TypeId → field OID for ROW(...) construction (scalars; arrays and
#: records go through field_oid below)
FIELD_OID = {
    dt.TypeId.BOOL: 16, dt.TypeId.TINYINT: 21, dt.TypeId.SMALLINT: 21,
    dt.TypeId.INT: 23, dt.TypeId.BIGINT: 20, dt.TypeId.FLOAT: 700,
    dt.TypeId.DOUBLE: 701, dt.TypeId.VARCHAR: 25, dt.TypeId.NULL: 25,
    dt.TypeId.DATE: 1082, dt.TypeId.TIMESTAMP: 1114,
    dt.TypeId.INTERVAL: 1186, dt.TypeId.RECORD: 2249,
}


def field_oid(t: dt.SqlType) -> int:
    if t.id is dt.TypeId.ARRAY:
        return _ARRAY_OID_OF_ELEM.get(t.elem or dt.TypeId.VARCHAR, 1009)
    return FIELD_OID.get(t.id, 25)


def record_parts(json_text: str):
    """Physical record JSON → ([oid, ...], [value, ...]); None when the
    payload is not a record."""
    import json as _json
    try:
        obj = _json.loads(json_text)
    except Exception:
        return None
    if not (isinstance(obj, dict) and isinstance(obj.get("o"), list)
            and isinstance(obj.get("v"), list)
            and len(obj["o"]) == len(obj["v"])):
        return None
    return obj["o"], obj["v"]


def _scalar_field_text(t: dt.SqlType, v) -> str:
    if t.id is dt.TypeId.BOOL or isinstance(v, bool):
        return "t" if v else "f"
    if t.id is dt.TypeId.TIMESTAMP:
        from ..sql.binder import format_timestamp
        return format_timestamp(int(v))
    if t.id is dt.TypeId.DATE:
        import numpy as _np
        return str(_np.datetime64(int(v), "D"))
    if t.id is dt.TypeId.INTERVAL:
        from ..sql.binder import format_interval
        return format_interval(int(v))
    if isinstance(v, float):
        import math as _math
        if _math.isnan(v):
            return "NaN"
        if _math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))   # PG float8 out: 2, not 2.0
        return repr(v)
    return str(v)


def _array_field_text(json_text: str, elem) -> str:
    """JSON array payload → PG {…} text (element-level; no reg* types
    inside records)."""
    import json as _json
    try:
        vals = _json.loads(json_text)
    except Exception:
        return json_text
    if not isinstance(vals, list):
        return json_text
    et = dt.SqlType(elem) if elem is not None else dt.VARCHAR

    def one(v):
        if v is None:
            return "NULL"
        if isinstance(v, bool):
            return "t" if v else "f"
        if isinstance(v, list):
            return "{" + ",".join(one(x) for x in v) + "}"
        if et.id in (dt.TypeId.DATE, dt.TypeId.TIMESTAMP,
                     dt.TypeId.INTERVAL) and isinstance(v, int):
            return _scalar_field_text(et, v)
        if isinstance(v, str):
            if v == "" or any(ch in v for ch in ',{}"\\ ') or \
                    v.upper() == "NULL":
                return '"' + v.replace("\\", "\\\\").replace(
                    '"', '\\"') + '"'
            return v
        if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return str(v)
    return "{" + ",".join(one(v) for v in vals) + "}"


def _field_rank(v):
    """Type-class rank for cross-kind total ordering inside records."""
    if isinstance(v, bool):
        return 0
    if isinstance(v, (int, float)):
        return 1
    if isinstance(v, str):
        return 2
    return 3


def _cmp_fields(x, y) -> int:
    if isinstance(x, bool) or isinstance(y, bool):
        x, y = bool(x), bool(y)
    rx, ry = _field_rank(x), _field_rank(y)
    if rx != ry:
        return -1 if rx < ry else 1
    if x == y:
        return 0
    try:
        return -1 if x < y else 1
    except TypeError:
        sx, sy = str(x), str(y)
        return -1 if sx < sy else (1 if sx > sy else 0)


def record_cmp_sql(ta: str, tb: str):
    """SQL-operator record comparison: field-wise, first difference
    decides; a NULL field reached before a decision makes the result
    SQL NULL (returns None). PG: ROW(1,NULL)=ROW(2,NULL) is false,
    ROW(1,NULL)=ROW(1,NULL) is NULL. Raises on arity mismatch like PG's
    'cannot compare dissimilar column types'."""
    from .. import errors
    pa, pb = record_parts(ta), record_parts(tb)
    if pa is None or pb is None:
        return _cmp_fields(ta, tb)
    va, vb = pa[1], pb[1]
    if len(va) != len(vb):
        raise errors.SqlError(
            "42804", "cannot compare records with different numbers "
                     "of columns")
    for x, y in zip(va, vb):
        if x is None or y is None:
            return None
        c = _cmp_fields(x, y)
        if c != 0:
            return c
    return 0


def record_cmp_total(ta: str, tb: str) -> int:
    """Btree-style total order for sorting records (PG record_cmp):
    NULL fields sort after every value; NULL == NULL for ordering."""
    pa, pb = record_parts(ta), record_parts(tb)
    if pa is None or pb is None:
        return _cmp_fields(ta, tb)
    va, vb = pa[1], pb[1]
    if len(va) != len(vb):
        return -1 if len(va) < len(vb) else 1
    for x, y in zip(va, vb):
        if x is None and y is None:
            continue
        if x is None:
            return 1
        if y is None:
            return -1
        c = _cmp_fields(x, y)
        if c != 0:
            return c
    return 0


def record_text(json_text: str) -> str:
    """Physical record JSON → PG (…) output (reference:
    server/pg/serialize.cpp record_out): NULL fields are empty; fields
    containing , ( ) " \\ or any whitespace (or empty strings) are quoted
    with doubled quotes. Nested records and arrays render recursively."""
    parts = record_parts(json_text)
    if parts is None:
        return json_text
    oids, vals = parts
    out = []
    for oid, v in zip(oids, vals):
        if v is None:
            out.append("")
            continue
        t = _TYPE_OF_OID.get(int(oid), dt.VARCHAR)
        if t.id is dt.TypeId.RECORD:
            s = record_text(str(v))
        elif t.id is dt.TypeId.ARRAY:
            s = _array_field_text(str(v), t.elem)
        else:
            s = _scalar_field_text(t, v)
        if s == "" or any(ch in s for ch in ',()"\\') or \
                any(ch.isspace() for ch in s):
            s = '"' + s.replace("\\", "\\\\").replace('"', '""') + '"'
        out.append(s)
    return "(" + ",".join(out) + ")"


def _encode_record_binary(json_text: str) -> bytes:
    """PG binary record format: int32 nfields, then per field int32 OID +
    length-prefixed binary payload (reference: server/pg/serialize.cpp
    record_send)."""
    parts = record_parts(json_text)
    if parts is None:
        # not a record payload — one text field
        payload = json_text.encode()
        return struct.pack("!i", 1) + struct.pack("!Ii", 25, len(payload)) \
            + payload
    oids, vals = parts
    out = [struct.pack("!i", len(vals))]
    for oid, v in zip(oids, vals):
        t = _TYPE_OF_OID.get(int(oid), dt.VARCHAR)
        if v is None:
            out.append(struct.pack("!Ii", int(oid), -1))
            continue
        payload = encode_value(v, t)
        out.append(struct.pack("!Ii", int(oid), len(payload)) + payload)
    return b"".join(out)


#: element TypeId → (element OID, element SqlType) for array binary sends
_ARRAY_ELEM = {
    dt.TypeId.BOOL: 16, dt.TypeId.TINYINT: 21, dt.TypeId.SMALLINT: 21,
    dt.TypeId.INT: 23, dt.TypeId.BIGINT: 20, dt.TypeId.FLOAT: 700,
    dt.TypeId.DOUBLE: 701, dt.TypeId.VARCHAR: 25,
    dt.TypeId.DATE: 1082, dt.TypeId.TIMESTAMP: 1114,
}


def _encode_array_binary(json_text: str, elem: dt.TypeId) -> bytes:
    """PG binary array format: ndim, hasnull, elem oid, (dim, lbound),
    then length-prefixed elements (reference: server/pg/serialize.cpp
    array_send). One-dimensional; the physical JSON representation."""
    import json as _json
    try:
        vals = _json.loads(json_text)
    except Exception:
        vals = None
    if not isinstance(vals, list):
        # not an array payload after all — send as text elements
        vals = [json_text]
    hasnull = any(v is None for v in vals)
    et = dt.SqlType(elem)
    out = [struct.pack("!iiI", 1, 1 if hasnull else 0,
                       _ARRAY_ELEM.get(elem, 25)),
           struct.pack("!ii", len(vals), 1)]
    for v in vals:
        if v is None:
            out.append(struct.pack("!i", -1))
            continue
        if isinstance(v, list):
            payload = _json.dumps(v).encode()   # nested: text fallback
        else:
            payload = encode_value(v, et)
        out.append(struct.pack("!i", len(payload)) + payload)
    return b"".join(out)


def decode_value(raw: bytes, typ: dt.SqlType):
    tid = typ.id
    try:
        if tid is dt.TypeId.BOOL:
            if len(raw) != 1:
                raise struct.error("bool is 1 byte")
            return raw != b"\x00"
        if tid in (dt.TypeId.TINYINT, dt.TypeId.SMALLINT):
            return struct.unpack("!h", raw)[0]
        if tid is dt.TypeId.INT:
            return struct.unpack("!i", raw)[0]
        if tid is dt.TypeId.BIGINT:
            return struct.unpack("!q", raw)[0]
        if tid is dt.TypeId.FLOAT:
            return struct.unpack("!f", raw)[0]
        if tid is dt.TypeId.DOUBLE:
            return struct.unpack("!d", raw)[0]
        if tid is dt.TypeId.TIMESTAMP:
            return struct.unpack("!q", raw)[0] + _PG_EPOCH_US
        if tid is dt.TypeId.DATE:
            return struct.unpack("!i", raw)[0] + _PG_EPOCH_DAYS
        if tid is dt.TypeId.INTERVAL:
            us, days, months = struct.unpack("!qii", raw)
            # our intervals are µs-only; days/months fold in at PG's
            # nominal 24h/30d (the text parser makes the same choice)
            return us + (days + months * 30) * 86_400_000_000
        if tid in _OID_IDS:
            return struct.unpack("!I", raw)[0]
        return raw.decode("utf-8")
    except (struct.error, UnicodeDecodeError):
        raise errors.SqlError(
            "22P03", f"incorrect binary data format for type {typ}")


def header() -> bytes:
    return SIGNATURE + struct.pack("!II", 0, 0)   # flags, extension length


def trailer() -> bytes:
    return struct.pack("!h", -1)


def encode_rows(batch: Batch) -> list[bytes]:
    """Per-tuple CopyData payloads (header/trailer NOT included)."""
    types = [c.type for c in batch.columns]
    cols = [c.to_pylist() for c in batch.columns]
    n_fields = struct.pack("!h", len(types))
    out = []
    for i in range(batch.num_rows):
        parts = [n_fields]
        for ci, t in enumerate(types):
            payload = encode_value(cols[ci][i], t)
            if payload is None:
                parts.append(struct.pack("!i", -1))
            else:
                parts.append(struct.pack("!i", len(payload)) + payload)
        out.append(b"".join(parts))
    return out


def decode_to_batch(data: bytes, names: list, types: list) -> Batch:
    """Binary COPY payload → Batch with the given column names/types."""
    cols = decode_stream(data, types)
    return Batch(list(names), [Column.from_pylist(v, t)
                               for v, t in zip(cols, types)])


def encode_full(batch: Batch) -> list[bytes]:
    """header + per-tuple payloads + trailer, ready to stream/write."""
    return [header()] + encode_rows(batch) + [trailer()]


def decode_stream(data: bytes, types: list[dt.SqlType]) -> list[list]:
    """Binary COPY payload → per-column python value lists.

    Tolerates the trailer being absent (some clients close the stream
    instead) but rejects a bad signature or malformed tuples."""
    if not data.startswith(SIGNATURE):
        raise errors.SqlError("22P04",
                              "COPY binary signature not recognized")
    off = len(SIGNATURE)
    if off + 8 > len(data):
        raise errors.SqlError("22P04", "invalid COPY binary header")
    flags, ext = struct.unpack_from("!II", data, off)
    off += 8 + ext
    cols: list[list] = [[] for _ in types]
    n = len(data)
    while off + 2 <= n:
        (nf,) = struct.unpack_from("!h", data, off)
        off += 2
        if nf == -1:
            break                      # trailer
        if nf != len(types):
            raise errors.SqlError(
                "22P04", f"row field count {nf}, expected {len(types)}")
        for ci in range(nf):
            if off + 4 > n:
                raise errors.SqlError("22P04",
                                      "unexpected EOF in COPY binary data")
            (ln,) = struct.unpack_from("!i", data, off)
            off += 4
            if ln < 0:
                cols[ci].append(None)
                continue
            if off + ln > n:
                raise errors.SqlError("22P04",
                                      "unexpected EOF in COPY binary data")
            cols[ci].append(decode_value(data[off:off + ln], types[ci]))
            off += ln
    return cols
