"""Copied from serenedb_tpu/functions/pgsys.py.

PG system/introspection functions backing the psql \\d-family and ORM
introspection (reference: server/pg/pg_catalog/ support functions and
server/query/server_engine.cpp:61-216 pseudo-type plumbing).

These are catalog-cardinality functions (rows ≈ number of tables/columns),
so row-wise Python is the right tool — none of this is on the TPU hot path.
"""

from __future__ import annotations

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Column
from ..sql.expr import make_string_column, propagate_nulls, string_values
from .scalar import FunctionResolution, _REGISTRY, register


def _strings_out(values, validity):
    return make_string_column(
        np.asarray(["" if v is None else str(v) for v in values],
                   dtype=object).astype(str),
        validity)


def _rowwise_str(fn, n_args=None):
    """Build a resolver for a row-wise function returning text.
    fn(row_values: tuple) -> Optional[str]; NULL args propagate."""
    def resolver(ts):
        if n_args is not None and len(ts) not in n_args:
            return None

        def impl(cols, n):
            pys = [c.to_pylist() for c in cols]
            out, nulls = [], np.zeros(n, dtype=bool)
            for i in range(n):
                row = tuple(p[i] for p in pys)
                if any(v is None for v in row):
                    out.append(None)
                    nulls[i] = True
                    continue
                v = fn(row)
                out.append(v)
                nulls[i] = v is None
            validity = ~nulls if nulls.any() else propagate_nulls(cols)
            return _strings_out(out, validity)
        return FunctionResolution(dt.VARCHAR, impl)
    return resolver


def _const_fn(name, value_fn, typ=dt.VARCHAR):
    @register(name)
    def _f(ts, _v=value_fn, _t=typ):
        def impl(cols, n):
            v = _v()
            return Column.from_pylist([v] * max(n, 1), _t)
        return FunctionResolution(_t, impl)


def _db():
    from ..pgcatalog import current_db
    return current_db()


# -- format_type / visibility ---------------------------------------------

@register("format_type")
def _format_type(ts):
    from ..pgcatalog import format_type_oid

    def impl(cols, n):
        oids = cols[0].to_pylist()
        mods = (cols[1].to_pylist() if len(cols) > 1 else [None] * n)
        out = [None if o is None else format_type_oid(int(o), mods[i])
               for i, o in enumerate(oids)]
        validity = np.asarray([v is not None for v in out], dtype=bool)
        return _strings_out(out, validity if not validity.all() else None)
    return FunctionResolution(dt.VARCHAR, impl)


def _vis(ts):
    def impl(cols, n):
        return Column(dt.BOOL, np.ones(n, dtype=bool),
                      propagate_nulls(cols))
    return FunctionResolution(dt.BOOL, impl)


for _name in ("pg_table_is_visible", "pg_type_is_visible",
              "pg_function_is_visible", "pg_operator_is_visible"):
    _REGISTRY[_name] = _vis


# -- pg_get_* --------------------------------------------------------------

def _index_lookup(oid):
    db = _db()
    if db is None:
        return None
    hit = db.oid_lookup(oid)
    if hit is None or hit[0] != "index":
        return None
    _, schema, iname = hit
    with db.lock:
        s = db.schemas.get(schema)
        if s is None:
            return None
        for tname, t in s.tables.items():
            idx = getattr(t, "indexes", {}).get(iname)
            if idx is not None:
                return schema, tname, iname, idx
    return None


def _pg_get_indexdef_row(row):
    oid = int(row[0])
    colno = int(row[1]) if len(row) > 1 else 0
    hit = _index_lookup(oid)
    if hit is None:
        return None
    schema, tname, iname, idx = hit
    cols = list(getattr(idx, "columns", []))
    if colno > 0:
        return cols[colno - 1] if colno <= len(cols) else ""
    qual = tname if schema == "main" else f"{schema}.{tname}"
    return (f"CREATE INDEX {iname} ON {qual} "
            f"USING {idx.using} ({', '.join(cols)})")


_REGISTRY["pg_get_indexdef"] = _rowwise_str(_pg_get_indexdef_row,
                                            n_args={1, 2, 3})


def _pg_get_viewdef_row(row):
    db = _db()
    if db is None:
        return None
    v = row[0]
    hit = db.oid_lookup(int(v)) if not isinstance(v, str) or \
        str(v).isdigit() else None
    if hit is None and isinstance(v, str):
        try:
            hit = db.oid_lookup(db.resolve_relation_oid(v))
        except errors.SqlError:
            return None
    if hit is None or hit[0] != "view":
        return None
    _, schema, vname = hit
    with db.lock:
        s = db.schemas.get(schema)
        vd = s.views.get(vname) if s else None
    return (getattr(vd, "sql", "") or "") if vd is not None else None


_REGISTRY["pg_get_viewdef"] = _rowwise_str(_pg_get_viewdef_row,
                                           n_args={1, 2})


def _pg_get_userbyid_row(row):
    db = _db()
    if db is not None:
        hit = db.oid_lookup(int(row[0]))
        if hit is not None and hit[0] == "role":
            return hit[2]
    return "serene"


_REGISTRY["pg_get_userbyid"] = _rowwise_str(_pg_get_userbyid_row,
                                            n_args={1})

# pg_get_expr(adbin, adrelid[, pretty]): we store expression *text* in
# adbin, so rendering is identity on the first argument
_REGISTRY["pg_get_expr"] = _rowwise_str(lambda row: str(row[0]),
                                        n_args={2, 3})


def _pg_get_constraintdef_row(row):
    db = _db()
    if db is None:
        return None
    hit = db.oid_lookup(int(row[0]))
    if hit is None or hit[0] != "constraint":
        return None
    _, schema, cname = hit
    tname = cname[:-5] if cname.endswith("_pkey") else cname
    with db.lock:
        s = db.schemas.get(schema)
        t = s.tables.get(tname) if s else None
    if t is None:
        return None
    pk = (getattr(t, "table_meta", {}) or {}).get("primary_key") or []
    return f"PRIMARY KEY ({', '.join(pk)})"


_REGISTRY["pg_get_constraintdef"] = _rowwise_str(
    _pg_get_constraintdef_row, n_args={1, 2})


def _null_resolver(ts):
    def impl(cols, n):
        return Column(dt.VARCHAR, np.zeros(n, dtype=np.int32),
                      np.zeros(n, dtype=bool), np.asarray([""]))
    return FunctionResolution(dt.VARCHAR, impl)


for _name in ("obj_description", "col_description", "shobj_description",
              "pg_get_function_result", "pg_get_function_arguments",
              "pg_get_function_identity_arguments", "pg_get_triggerdef",
              "pg_get_partkeydef", "pg_get_statisticsobjdef"):
    _REGISTRY[_name] = _null_resolver


# -- quoting ---------------------------------------------------------------

_SAFE_IDENT = __import__("re").compile(r"^[a-z_][a-z0-9_$]*$")

# reserved words that must be quoted even when lexically safe (PG's
# quote_ident quotes anything in its reserved-keyword list)
_RESERVED = frozenset("""
    all analyse analyze and any array as asc asymmetric between binary both
    case cast check collate column constraint create cross current_catalog
    current_date current_role current_time current_timestamp current_user
    default deferrable desc distinct do else end except false fetch for
    foreign freeze from full grant group having ilike in initially inner
    intersect into is isnull join lateral leading left like limit localtime
    localtimestamp natural not notnull null offset on only or order outer
    overlaps placing primary references returning right select session_user
    similar some symmetric table then to trailing true union unique user
    using variadic verbose when where window with
""".split())


def _quote_ident_row(row):
    s = str(row[0])
    if _SAFE_IDENT.match(s) and s not in _RESERVED:
        return s
    return '"' + s.replace('"', '""') + '"'


_REGISTRY["quote_ident"] = _rowwise_str(_quote_ident_row, n_args={1})


@register("quote_literal")
def _quote_literal(ts):
    def impl(cols, n):
        vals = cols[0].to_pylist()
        out = [None if v is None
               else "'" + str(v).replace("'", "''") + "'" for v in vals]
        return _strings_out(out, propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("quote_nullable")
def _quote_nullable(ts):
    def impl(cols, n):
        vals = cols[0].to_pylist()
        out = ["NULL" if v is None
               else "'" + str(v).replace("'", "''") + "'" for v in vals]
        return _strings_out(out, None)
    return FunctionResolution(dt.VARCHAR, impl)


# -- sizes -----------------------------------------------------------------

def _rel_size(oid) -> int:
    db = _db()
    if db is None:
        return 0
    hit = db.oid_lookup(int(oid))
    if hit is None:
        return 0
    kind, schema, name = hit
    with db.lock:
        s = db.schemas.get(schema)
        t = s.tables.get(name) if s else None
    if t is None:
        return 0
    total = 0
    b = t.full_batch(None)
    for c in b.columns:
        total += int(c.data.nbytes)
        if getattr(c, "dictionary", None) is not None:
            total += sum(len(str(x)) for x in c.dictionary)
    return total


def _size_resolver(ts):
    def impl(cols, n):
        vals = cols[0].to_pylist()
        data = np.asarray([0 if v is None else _rel_size(v) for v in vals],
                          dtype=np.int64)
        return Column(dt.BIGINT, data, propagate_nulls(cols))
    return FunctionResolution(dt.BIGINT, impl)


for _name in ("pg_relation_size", "pg_total_relation_size",
              "pg_table_size", "pg_indexes_size"):
    _REGISTRY[_name] = _size_resolver


@register("pg_size_pretty")
def _pg_size_pretty(ts):
    def fmt(v):
        v = float(v)
        for unit in ("bytes", "kB", "MB", "GB", "TB"):
            if abs(v) < 10240 or unit == "TB":
                return (f"{int(v)} {unit}" if unit == "bytes"
                        else f"{v:.0f} {unit}")
            v /= 1024.0
    def impl(cols, n):
        vals = cols[0].to_pylist()
        out = [None if v is None else fmt(v) for v in vals]
        return _strings_out(out, propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


# -- session / server state -----------------------------------------------

def _current_role():
    from ..engine import CURRENT_CONNECTION
    conn = CURRENT_CONNECTION.get()
    return getattr(conn, "current_role", None) or "serene"


_const_fn("current_database", lambda: "serene")
_const_fn("current_catalog", lambda: "serene")
_const_fn("current_user", _current_role)
_const_fn("session_user", _current_role)
_const_fn("user", _current_role)
_const_fn("pg_backend_pid", lambda: 1, dt.INT)
_const_fn("pg_is_in_recovery", lambda: False, dt.BOOL)
_const_fn("txid_current", lambda: 1, dt.BIGINT)
_const_fn("pg_postmaster_start_time", lambda: "2026-01-01 00:00:00")
_const_fn("inet_server_addr", lambda: "127.0.0.1")
_const_fn("inet_client_addr", lambda: "127.0.0.1")
_const_fn("pg_conf_load_time", lambda: "2026-01-01 00:00:00")


@register("current_schemas")
def _current_schemas(ts):
    import json

    def impl(cols, n):
        include_implicit = True
        if cols:
            v = cols[0].to_pylist()
            include_implicit = bool(v[0]) if v else True
        arr = (["pg_catalog", "main"] if include_implicit else ["main"])
        s = json.dumps(arr)
        return Column.from_pylist([s] * max(n, 1), dt.VARCHAR)
    return FunctionResolution(dt.VARCHAR, impl)


@register("pg_encoding_to_char")
def _pg_encoding_to_char(ts):
    enc = {6: "UTF8", 0: "SQL_ASCII"}

    def impl(cols, n):
        vals = cols[0].to_pylist()
        out = [None if v is None else enc.get(int(v), "UTF8") for v in vals]
        return _strings_out(out, propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


def _priv_resolver(ts):
    def impl(cols, n):
        return Column(dt.BOOL, np.ones(n, dtype=bool), None)
    return FunctionResolution(dt.BOOL, impl)


for _name in ("has_table_privilege", "has_schema_privilege",
              "has_database_privilege", "has_column_privilege",
              "has_function_privilege", "has_sequence_privilege",
              "pg_has_role"):
    _REGISTRY[_name] = _priv_resolver


@register("to_regclass")
def _to_regclass(ts):
    def impl(cols, n):
        db = _db()
        vals = string_values(cols[0])
        out = np.zeros(n, dtype=np.int64)
        bad = np.zeros(n, dtype=bool)
        for i, v in enumerate(vals):
            try:
                out[i] = db.resolve_relation_oid(str(v)) if db else 0
                bad[i] = db is None
            except errors.SqlError:
                bad[i] = True
        validity = propagate_nulls(cols)
        if bad.any():
            validity = (validity if validity is not None
                        else np.ones(n, dtype=bool)) & ~bad
        return Column(dt.REGCLASS, out, validity)
    return FunctionResolution(dt.REGCLASS, impl)
