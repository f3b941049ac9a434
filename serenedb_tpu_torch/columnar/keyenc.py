"""Copied from serenedb_tpu/columnar/keyenc.py.

Order-preserving composite primary-key byte encoding.

Reference analog: server/connector/key_encoding.cpp +
server/connector/duckdb_primary_key.h — composite PKs become memcomparable
byte strings, so PK terms support point lookups, PK RANGE scans over the
sorted key array, and PK-based remove filters for UPDATE/DELETE (replayed
identically after a crash regardless of physical row order).

Encoding rules (all big-endian, so bytewise compare == logical compare):
- integers / date / timestamp / interval: 8-byte big-endian with the sign
  bit flipped (two's complement order becomes unsigned byte order)
- floats: IEEE-754 bits; negative values flip ALL bits, positive flip the
  sign bit (standard total-order trick; -0.0 and +0.0 encode differently
  but PK equality uses the same transform on both sides)
- booleans: one byte
- strings: UTF-8 with 0x00 escaped as 0x00 0xFF, terminated by 0x00 0x01 —
  the terminator is lower than any escaped byte pair, so 'a' < 'ab' holds
  and concatenated composite keys stay prefix-free
- NULL never encodes: PKs reject NULLs before this layer (23502)

Composite keys concatenate the per-column encodings.
"""

from __future__ import annotations

import struct

import numpy as np

from . import dtypes as dt

_STR_TERM = b"\x00\x01"
_INT_TYPES = (dt.TypeId.TINYINT, dt.TypeId.SMALLINT, dt.TypeId.INT,
              dt.TypeId.BIGINT, dt.TypeId.DATE, dt.TypeId.TIMESTAMP,
              dt.TypeId.INTERVAL, dt.TypeId.OID)


def _enc_int(v: int) -> bytes:
    v = int(v)
    if not -(1 << 63) <= v < (1 << 63):
        # never wrap: a query literal beyond int64 must fall back to the
        # generic comparison path, not silently alias another key
        raise ValueError(f"integer key out of range: {v}")
    return struct.pack(">Q", v + (1 << 63))


def _enc_float(v: float) -> bytes:
    v = float(v)
    if v == 0.0:
        v = 0.0          # -0.0 == 0.0 in SQL: one canonical key
    elif v != v:
        v = float("nan")  # canonical NaN bits
    bits = struct.unpack(">Q", struct.pack(">d", v))[0]
    if bits & (1 << 63):
        bits = ~bits & ((1 << 64) - 1)     # negative: flip everything
    else:
        bits |= (1 << 63)                  # positive: flip sign bit
    return struct.pack(">Q", bits)


def _enc_str(v: str) -> bytes:
    return v.encode("utf-8").replace(b"\x00", b"\x00\xff") + _STR_TERM


def encode_value(v, t: dt.SqlType) -> bytes:
    if t.id in _INT_TYPES:
        return _enc_int(v)
    if t.id is dt.TypeId.BOOL:
        return b"\x01" if v else b"\x00"
    if t.is_float:
        return _enc_float(v)
    if t.is_string:
        return _enc_str(str(v))
    # catch-all: text encoding of the decoded value keeps equality exact
    # (order may not match SQL order for exotic types — PKs on them are
    # point-lookup only)
    return _enc_str(str(v))


def encode_row(values, types) -> bytes:
    return b"".join(encode_value(v, t) for v, t in zip(values, types))


def encode_key_columns(cols) -> np.ndarray:
    """Encode PK columns of a batch into an object array of key bytes.
    NULLs must have been rejected upstream (PK NOT NULL)."""
    n = len(cols[0]) if cols else 0
    parts = []
    for c in cols:
        t = c.type
        vals = c.to_pylist()
        parts.append([encode_value(v, t) for v in vals])
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = b"".join(p[i] for p in parts)
    return out


def prefix_upper_bound(prefix: bytes):
    """Smallest byte string greater than every key starting with
    `prefix` (for leading-column range scans): increment the last
    non-0xFF byte. None = unbounded above."""
    b = bytearray(prefix)
    while b and b[-1] == 0xFF:
        b.pop()
    if not b:
        return None
    b[-1] += 1
    return bytes(b)
