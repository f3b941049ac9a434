"""Copied from serenedb_tpu/columnar/dtypes.py.

SQL type system mapped onto TPU-friendly physical dtypes.

The reference models types through DuckDB's LogicalType plus PG pseudo-types
(reference: server/pg/pg_types.cpp, server/query/server_engine.cpp:61-216).
Here the logical SQL type system is small and explicit, and every type has a
*physical* representation chosen for the TPU compute path:

- integers/floats/bools/timestamps: native numpy/jax dtypes
- VARCHAR: dictionary-encoded int32 codes on device; the dictionary
  (per-column, per-segment) stays host-side. String predicates are resolved
  against the dictionary on CPU and become integer-code predicates on device.
- DECIMAL is not implemented yet (DOUBLE covers the analytics benchmarks).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class TypeId(enum.Enum):
    BOOL = "BOOLEAN"
    TINYINT = "TINYINT"
    SMALLINT = "SMALLINT"
    INT = "INTEGER"
    BIGINT = "BIGINT"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    VARCHAR = "VARCHAR"
    TIMESTAMP = "TIMESTAMP"  # micros since epoch, int64
    DATE = "DATE"            # days since epoch, int32
    INTERVAL = "INTERVAL"    # duration in micros, int64 (fixed units only)
    NULL = "NULL"            # type of bare NULL literal
    # PG pseudo-types for catalog introspection (reference:
    # server/query/server_engine.cpp:61-216). Physically int64 object ids;
    # casting to/from text resolves names against the live catalog.
    OID = "OID"
    REGCLASS = "REGCLASS"
    REGTYPE = "REGTYPE"
    REGPROC = "REGPROC"
    REGNAMESPACE = "REGNAMESPACE"
    ARRAY = "ARRAY"          # element-typed; physically JSON text in a
                             # dictionary column (wire layer renders/encodes
                             # PG {…} text and the binary array format)
    RECORD = "RECORD"        # anonymous composite (ROW(...)); physically
                             # JSON {"o":[oid,...],"v":[...]} text in a
                             # dictionary column; wire layer renders PG
                             # (…) text / the binary record format (2249)


_NUMPY_OF = {
    TypeId.BOOL: np.dtype(np.bool_),
    TypeId.TINYINT: np.dtype(np.int8),
    TypeId.SMALLINT: np.dtype(np.int16),
    TypeId.INT: np.dtype(np.int32),
    TypeId.BIGINT: np.dtype(np.int64),
    TypeId.FLOAT: np.dtype(np.float32),
    TypeId.DOUBLE: np.dtype(np.float64),
    TypeId.VARCHAR: np.dtype(np.int32),   # dictionary codes
    TypeId.TIMESTAMP: np.dtype(np.int64),
    TypeId.DATE: np.dtype(np.int32),
    TypeId.INTERVAL: np.dtype(np.int64),
    TypeId.NULL: np.dtype(np.int32),
    TypeId.ARRAY: np.dtype(np.int32),     # dictionary codes (JSON text)
    TypeId.RECORD: np.dtype(np.int32),    # dictionary codes (JSON text)
    TypeId.OID: np.dtype(np.int64),
    TypeId.REGCLASS: np.dtype(np.int64),
    TypeId.REGTYPE: np.dtype(np.int64),
    TypeId.REGPROC: np.dtype(np.int64),
    TypeId.REGNAMESPACE: np.dtype(np.int64),
}

_INTEGERS = {TypeId.TINYINT, TypeId.SMALLINT, TypeId.INT, TypeId.BIGINT,
             TypeId.OID, TypeId.REGCLASS, TypeId.REGTYPE, TypeId.REGPROC,
             TypeId.REGNAMESPACE}
_FLOATS = {TypeId.FLOAT, TypeId.DOUBLE}


@dataclass(frozen=True)
class SqlType:
    """A logical SQL type. Kept as a dataclass so parametric types
    (DECIMAL(p,s), VARCHAR(n)) can be added without changing call sites."""

    id: TypeId
    #: ARRAY element type (None elsewhere); frozen+defaulted so equality
    #: and hashing of existing scalar types are unchanged
    elem: "TypeId | None" = None

    @property
    def np_dtype(self) -> np.dtype:
        return _NUMPY_OF[self.id]

    @property
    def is_integer(self) -> bool:
        return self.id in _INTEGERS

    @property
    def is_float(self) -> bool:
        return self.id in _FLOATS

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float or self.id is TypeId.BOOL

    @property
    def is_string(self) -> bool:
        # ARRAY/RECORD share the dictionary-string physical representation
        return self.id in (TypeId.VARCHAR, TypeId.ARRAY, TypeId.RECORD)

    def __str__(self) -> str:  # PG-style rendering
        if self.id is TypeId.ARRAY:
            return f"{(self.elem or TypeId.VARCHAR).value}[]"
        if self.id is TypeId.RECORD:
            return "record"
        return self.id.value


BOOL = SqlType(TypeId.BOOL)
TINYINT = SqlType(TypeId.TINYINT)
SMALLINT = SqlType(TypeId.SMALLINT)
INT = SqlType(TypeId.INT)
BIGINT = SqlType(TypeId.BIGINT)
FLOAT = SqlType(TypeId.FLOAT)
DOUBLE = SqlType(TypeId.DOUBLE)
VARCHAR = SqlType(TypeId.VARCHAR)
TIMESTAMP = SqlType(TypeId.TIMESTAMP)
DATE = SqlType(TypeId.DATE)
INTERVAL = SqlType(TypeId.INTERVAL)
OID = SqlType(TypeId.OID)
REGCLASS = SqlType(TypeId.REGCLASS)
REGTYPE = SqlType(TypeId.REGTYPE)
REGPROC = SqlType(TypeId.REGPROC)
REGNAMESPACE = SqlType(TypeId.REGNAMESPACE)
NULLTYPE = SqlType(TypeId.NULL)
RECORD = SqlType(TypeId.RECORD)


def array_of(elem: "SqlType | TypeId | None") -> SqlType:
    """Element-typed array (TEXT elements when unknown)."""
    if isinstance(elem, SqlType):
        elem = elem.id
    if elem in (None, TypeId.NULL, TypeId.ARRAY):
        elem = TypeId.VARCHAR
    return SqlType(TypeId.ARRAY, elem)

_BY_NAME = {
    "BOOLEAN": BOOL, "BOOL": BOOL,
    "TINYINT": TINYINT, "INT1": TINYINT,
    "SMALLINT": SMALLINT, "INT2": SMALLINT,
    "INTEGER": INT, "INT": INT, "INT4": INT,
    "BIGINT": BIGINT, "INT8": BIGINT, "LONG": BIGINT,
    "FLOAT": FLOAT, "REAL": FLOAT, "FLOAT4": FLOAT,
    "DOUBLE": DOUBLE, "FLOAT8": DOUBLE, "DOUBLE PRECISION": DOUBLE,
    "VARCHAR": VARCHAR, "TEXT": VARCHAR, "STRING": VARCHAR, "CHAR": VARCHAR,
    "TIMESTAMP": TIMESTAMP, "TIMESTAMPTZ": TIMESTAMP, "DATETIME": TIMESTAMP,
    "DATE": DATE,
    "INTERVAL": INTERVAL,
    "OID": OID, "REGCLASS": REGCLASS, "REGTYPE": REGTYPE,
    "REGPROC": REGPROC, "REGPROCEDURE": REGPROC,
    "REGNAMESPACE": REGNAMESPACE,
    "NAME": VARCHAR, "BPCHAR": VARCHAR, "JSON": VARCHAR, "JSONB": VARCHAR,
    "UUID": VARCHAR, "XID": BIGINT, "CID": BIGINT,
}

# numeric widening lattice for binary-op result typing
_RANK = {
    TypeId.BOOL: 0, TypeId.TINYINT: 1, TypeId.SMALLINT: 2, TypeId.INT: 3,
    TypeId.DATE: 3, TypeId.BIGINT: 4, TypeId.TIMESTAMP: 4,
    TypeId.OID: 4, TypeId.REGCLASS: 4, TypeId.REGTYPE: 4, TypeId.REGPROC: 4,
    TypeId.REGNAMESPACE: 4,
    TypeId.FLOAT: 5, TypeId.DOUBLE: 6,
}


def type_from_name(name: str) -> SqlType:
    key = name.upper().strip()
    if key.endswith("[]"):
        return array_of(type_from_name(key[:-2]))
    if key == "ARRAY":          # legacy/unparameterized
        return array_of(None)
    t = _BY_NAME.get(key)
    if t is None:
        raise ValueError(f"unknown type name: {name!r}")
    return t


def unify_pair(a: SqlType, b: SqlType) -> SqlType:
    """Branch-type unification (CASE/COALESCE/VALUES arms): NULL yields
    the other side, equal types stay, numerics widen via common_numeric,
    and any other mix keeps the first typed side (text-vs-x arms render
    through the first type, matching the engine's historical behavior)."""
    if a.id is TypeId.NULL:
        return b
    if b.id is TypeId.NULL or a == b:
        return a
    if a.is_numeric and b.is_numeric:
        return common_numeric(a, b)
    return a


def unify_all(types) -> SqlType:
    t = NULLTYPE
    for x in types:
        t = unify_pair(t, x)
    return t


def common_numeric(a: SqlType, b: SqlType) -> SqlType:
    """Widening for arithmetic/comparison between numeric types."""
    if a.id is TypeId.NULL:
        return b
    if b.id is TypeId.NULL:
        return a
    if not (a.is_numeric or a.id in (TypeId.TIMESTAMP, TypeId.DATE)):
        raise TypeError(f"non-numeric type {a}")
    if not (b.is_numeric or b.id in (TypeId.TIMESTAMP, TypeId.DATE)):
        raise TypeError(f"non-numeric type {b}")
    return a if _RANK[a.id] >= _RANK[b.id] else b


def type_of_numpy(dt: np.dtype) -> SqlType:
    for tid, nd in _NUMPY_OF.items():
        if tid in (TypeId.VARCHAR, TypeId.NULL, TypeId.DATE):
            continue
        if nd == dt:
            return SqlType(tid)
    if np.issubdtype(dt, np.integer):
        return BIGINT
    if np.issubdtype(dt, np.floating):
        return DOUBLE
    raise TypeError(f"unsupported numpy dtype {dt}")
