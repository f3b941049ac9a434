"""Copied from serenedb_tpu/pgcatalog.py.

System catalog tables (pg_catalog emulation, sdb introspection).

Reference analog: server/pg/pg_catalog/ (92 system-table files materialized
from catalog snapshots; SURVEY.md §2.3) + sdb_catalog (sdb_metrics,
sdb_settings, sdb_log). Covers the full psql \\d-family workflow: pg_class /
pg_namespace / pg_attribute / pg_index / pg_am / pg_constraint / pg_type /
pg_proc with stable OIDs (engine.Database.oid_of), plus empty-but-typed
stubs for every catalog psql and common ORMs introspect, so joins resolve
instead of erroring (reference: server/pg/pg_catalog/pg_locks.cpp etc. are
likewise synthesized-empty).
"""

from __future__ import annotations

from typing import Callable, Optional

from . import errors
from .columnar import dtypes as dt
from .columnar.column import Batch, Column
from .exec.tables import MemTable, TableProvider
from .utils import log as _log
from .utils import metrics as _metrics
from .utils.config import REGISTRY as _settings_registry

# -- static type catalog ---------------------------------------------------
# (oid, typname, typlen, typtype, typcategory, typelem, typarray)
# Standard PG OIDs so drivers/ORMs that hardcode them keep working.
TYPE_ROWS = [
    (16, "bool", 1, "b", "B", 0, 1000),
    (17, "bytea", -1, "b", "U", 0, 1001),
    (18, "char", 1, "b", "S", 0, 1002),
    (19, "name", 64, "b", "S", 18, 1003),
    (20, "int8", 8, "b", "N", 0, 1016),
    (21, "int2", 2, "b", "N", 0, 1005),
    (23, "int4", 4, "b", "N", 0, 1007),
    (24, "regproc", 4, "b", "N", 0, 1008),
    (25, "text", -1, "b", "S", 0, 1009),
    (26, "oid", 4, "b", "N", 0, 1028),
    (114, "json", -1, "b", "U", 0, 199),
    (700, "float4", 4, "b", "N", 0, 1021),
    (701, "float8", 8, "b", "N", 0, 1022),
    (1042, "bpchar", -1, "b", "S", 0, 1014),
    (1043, "varchar", -1, "b", "S", 0, 1015),
    (1082, "date", 4, "b", "D", 0, 1182),
    (1083, "time", 8, "b", "D", 0, 1183),
    (1114, "timestamp", 8, "b", "D", 0, 1115),
    (1184, "timestamptz", 8, "b", "D", 0, 1185),
    (1186, "interval", 16, "b", "T", 0, 1187),
    (1700, "numeric", -1, "b", "N", 0, 1231),
    (2205, "regclass", 4, "b", "N", 0, 2210),
    (2206, "regtype", 4, "b", "N", 0, 2211),
    (2950, "uuid", 16, "b", "U", 0, 2951),
    (4089, "regnamespace", 4, "b", "N", 0, 4090),
    (3614, "tsvector", -1, "b", "U", 0, 3643),
    (3615, "tsquery", -1, "b", "U", 0, 3645),
    (3802, "jsonb", -1, "b", "U", 0, 3807),
]

_TYPE_OID_BY_NAME = {r[1]: r[0] for r in TYPE_ROWS}
_TYPE_NAME_BY_OID = {r[0]: r[1] for r in TYPE_ROWS}

# SqlType → pg type oid (matches server/pgwire._OID)
_ATT_OID = {
    dt.TypeId.BOOL: 16, dt.TypeId.TINYINT: 21, dt.TypeId.SMALLINT: 21,
    dt.TypeId.INT: 23, dt.TypeId.BIGINT: 20, dt.TypeId.FLOAT: 700,
    dt.TypeId.DOUBLE: 701, dt.TypeId.VARCHAR: 25,
    dt.TypeId.TIMESTAMP: 1114, dt.TypeId.DATE: 1082,
    dt.TypeId.INTERVAL: 1186, dt.TypeId.NULL: 25, dt.TypeId.OID: 26,
    dt.TypeId.REGCLASS: 2205, dt.TypeId.REGTYPE: 2206,
    dt.TypeId.REGPROC: 24, dt.TypeId.REGNAMESPACE: 4089,
}

# type oid → SQL rendering for format_type()
_FORMAT_TYPE = {
    16: "boolean", 17: "bytea", 18: '"char"', 19: "name", 20: "bigint",
    21: "smallint", 23: "integer", 24: "regproc", 25: "text", 26: "oid",
    114: "json", 700: "real", 701: "double precision",
    1042: "character", 1043: "character varying", 1082: "date",
    1083: "time without time zone", 1114: "timestamp without time zone",
    1184: "timestamp with time zone", 1186: "interval", 1700: "numeric",
    2205: "regclass", 2206: "regtype", 2950: "uuid", 3614: "tsvector",
    3615: "tsquery", 3802: "jsonb", 4089: "regnamespace",
}

# fixed namespace OIDs (PG uses 11 for pg_catalog)
NS_PG_CATALOG = 11
NS_INFO_SCHEMA = 13
NS_SDB_CATALOG = 14

_PROC_OID_BASE = 10000


def type_oid_of(sql_type: dt.SqlType) -> int:
    return _ATT_OID.get(sql_type.id, 25)


def format_type_oid(oid: int, typmod: Optional[int] = None) -> Optional[str]:
    name = _FORMAT_TYPE.get(int(oid))
    if name is None:
        return "???"
    if typmod is not None and typmod >= 4 and name in (
            "character varying", "character", "numeric"):
        if name == "numeric":
            m = int(typmod) - 4
            return f"numeric({m >> 16},{m & 0xFFFF})"
        return f"{name}({int(typmod) - 4})"
    return name


def resolve_type_oid(text: str) -> int:
    """'::regtype' cast: SQL type name → pg_type oid."""
    from . import errors
    s = text.strip().lower()
    for pre in ("pg_catalog.",):
        if s.startswith(pre):
            s = s[len(pre):]
    alias = {"integer": "int4", "int": "int4", "bigint": "int8",
             "smallint": "int2", "boolean": "bool", "real": "float4",
             "double precision": "float8", "character varying": "varchar",
             "timestamp without time zone": "timestamp",
             "timestamp with time zone": "timestamptz",
             "character": "bpchar", "string": "text"}
    s = alias.get(s, s)
    oid = _TYPE_OID_BY_NAME.get(s)
    if oid is None:
        raise errors.SqlError(errors.UNDEFINED_OBJECT,
                              f'type "{text}" does not exist')
    return oid


def _proc_names() -> list[str]:
    from .functions import scalar as _scalar
    return sorted(_scalar._REGISTRY)


def resolve_proc_oid(text: str) -> int:
    from . import errors
    s = text.strip().lower()
    if s.startswith("pg_catalog."):
        s = s[len("pg_catalog."):]
    names = _proc_names()
    try:
        return _PROC_OID_BASE + names.index(s)
    except ValueError:
        raise errors.SqlError(errors.UNDEFINED_FUNCTION,
                              f'function "{text}" does not exist')


def proc_name_of(oid: int) -> Optional[str]:
    names = _proc_names()
    i = int(oid) - _PROC_OID_BASE
    return names[i] if 0 <= i < len(names) else None


def type_name_of(oid: int) -> Optional[str]:
    return _TYPE_NAME_BY_OID.get(int(oid))


def regtype_render(oid: int) -> str:
    """regtype → text renders the CANONICAL SQL name ('integer', not
    'int4') — PG's format_type() behavior."""
    name = _FORMAT_TYPE.get(int(oid))
    if name is not None:
        return name
    return type_name_of(oid) or str(int(oid))


def resolve_namespace_oid(db, text: str) -> int:
    """'::regnamespace' cast: schema name → pg_namespace oid."""
    from . import errors
    s = text.strip().strip('"')
    fixed = {"pg_catalog": NS_PG_CATALOG,
             "information_schema": NS_INFO_SCHEMA,
             "sdb_catalog": NS_SDB_CATALOG}
    if s in fixed:
        return fixed[s]
    if db is not None:
        with db.lock:
            if s in db.schemas:
                return db.oid_of("schema", "", s)
    raise errors.SqlError(errors.UNDEFINED_OBJECT,
                          f'schema "{text}" does not exist')


def namespace_render(db, oid: int) -> str:
    fixed = {NS_PG_CATALOG: "pg_catalog", NS_INFO_SCHEMA:
             "information_schema", NS_SDB_CATALOG: "sdb_catalog"}
    if oid in fixed:
        return fixed[oid]
    if db is not None:
        hit = db.oid_lookup(oid)
        if hit is not None and hit[0] == "schema":
            return hit[2]
    return str(int(oid))


def regclass_render(db, oid: int) -> str:
    """oid → relation name (search_path-aware: bare name for main)."""
    if db is not None:
        hit = db.oid_lookup(oid)
        if hit is not None:
            kind, schema, name = hit
            if kind in ("table", "view", "index", "sequence"):
                return name if schema == "main" else f"{schema}.{name}"
    return str(int(oid))


def current_db():
    """The Database bound to the executing connection, if any."""
    from .engine import CURRENT_CONNECTION
    conn = CURRENT_CONNECTION.get()
    return None if conn is None else conn.db


# -- table builders --------------------------------------------------------

def _typed(name: str, spec: list[tuple[str, dt.SqlType]],
           rows: dict[str, list]) -> MemTable:
    cols = [Column.from_pylist(rows.get(cn, []), ct) for cn, ct in spec]
    return MemTable(name, Batch([cn for cn, _ in spec], cols))


def _ns_oid(db, sname: str) -> int:
    return db.oid_of("schema", "", sname)


def _rel_rows(db):
    """One row per relation: (oid, schema, name, kind, provider_or_None)."""
    out = []
    with db.lock:
        for sname, s in db.schemas.items():
            for tname, t in s.tables.items():
                out.append((db.oid_of("table", sname, tname), sname, tname,
                            "r", t))
                for iname in getattr(t, "indexes", {}):
                    out.append((db.oid_of("index", sname, iname), sname,
                                iname, "i", t))
            for vname in s.views:
                out.append((db.oid_of("view", sname, vname), sname, vname,
                            "v", None))
        for qname in db.sequences:
            sch, _, nm = qname.rpartition(".")
            out.append((db.oid_of("sequence", sch or "main", nm),
                        sch or "main", nm, "S", None))
    return out


def _pg_namespace(db) -> MemTable:
    with db.lock:
        names = sorted(db.schemas)
    oids = [_ns_oid(db, n) for n in names]
    oids += [NS_PG_CATALOG, NS_INFO_SCHEMA, NS_SDB_CATALOG]
    names += ["pg_catalog", "information_schema", "sdb_catalog"]
    return _typed("pg_namespace", [
        ("oid", dt.OID), ("nspname", dt.VARCHAR), ("nspowner", dt.OID),
        ("nspacl", dt.VARCHAR)], {
        "oid": oids, "nspname": names, "nspowner": [10] * len(oids),
        "nspacl": [None] * len(oids)})


_PG_CLASS_SPEC = [
    ("oid", dt.OID), ("relname", dt.VARCHAR), ("relnamespace", dt.OID),
    ("reltype", dt.OID), ("relowner", dt.OID), ("relam", dt.OID),
    ("relfilenode", dt.OID), ("reltablespace", dt.OID),
    ("relpages", dt.INT), ("reltuples", dt.FLOAT),
    ("relallvisible", dt.INT), ("reltoastrelid", dt.OID),
    ("relhasindex", dt.BOOL), ("relisshared", dt.BOOL),
    ("relpersistence", dt.VARCHAR), ("relkind", dt.VARCHAR),
    ("relnatts", dt.SMALLINT), ("relchecks", dt.SMALLINT),
    ("relhasrules", dt.BOOL), ("relhastriggers", dt.BOOL),
    ("relhassubclass", dt.BOOL), ("relrowsecurity", dt.BOOL),
    ("relforcerowsecurity", dt.BOOL), ("relispopulated", dt.BOOL),
    ("relreplident", dt.VARCHAR), ("relispartition", dt.BOOL),
    ("reloftype", dt.OID), ("reloptions", dt.VARCHAR),
    ("relacl", dt.VARCHAR),
]


def _pg_class(db) -> MemTable:
    rows: dict[str, list] = {c: [] for c, _ in _PG_CLASS_SPEC}
    for oid, sname, name, kind, t in _rel_rows(db):
        n_rows = t.row_count() if (t is not None and kind == "r") else 0
        natts = len(t.column_names) if (t is not None and kind == "r") else 0
        rows["oid"].append(oid)
        rows["relname"].append(name)
        rows["relnamespace"].append(_ns_oid(db, sname))
        rows["reltype"].append(0)
        rows["relowner"].append(10)
        rows["relam"].append(2 if kind == "i" else 0)
        rows["relfilenode"].append(oid)
        rows["reltablespace"].append(0)
        rows["relpages"].append(max(1, n_rows // 128))
        rows["reltuples"].append(float(n_rows))
        rows["relallvisible"].append(0)
        rows["reltoastrelid"].append(0)
        rows["relhasindex"].append(
            bool(getattr(t, "indexes", {})) if kind == "r" else False)
        rows["relisshared"].append(False)
        rows["relpersistence"].append("p")
        rows["relkind"].append(kind)
        rows["relnatts"].append(natts)
        rows["relchecks"].append(0)
        rows["relhasrules"].append(False)
        rows["relhastriggers"].append(False)
        rows["relhassubclass"].append(False)
        rows["relrowsecurity"].append(False)
        rows["relforcerowsecurity"].append(False)
        rows["relispopulated"].append(True)
        rows["relreplident"].append("d")
        rows["relispartition"].append(False)
        rows["reloftype"].append(0)
        rows["reloptions"].append(None)
        rows["relacl"].append(None)
    return _typed("pg_class", _PG_CLASS_SPEC, rows)


_PG_ATTR_SPEC = [
    ("attrelid", dt.OID), ("attname", dt.VARCHAR), ("atttypid", dt.OID),
    ("attstattarget", dt.INT), ("attlen", dt.SMALLINT),
    ("attnum", dt.SMALLINT), ("attndims", dt.INT),
    ("attcacheoff", dt.INT), ("atttypmod", dt.INT), ("attbyval", dt.BOOL),
    ("attstorage", dt.VARCHAR), ("attalign", dt.VARCHAR),
    ("attnotnull", dt.BOOL), ("atthasdef", dt.BOOL),
    ("atthasmissing", dt.BOOL), ("attidentity", dt.VARCHAR),
    ("attgenerated", dt.VARCHAR), ("attisdropped", dt.BOOL),
    ("attislocal", dt.BOOL), ("attinhcount", dt.INT),
    ("attcollation", dt.OID),
]


_view_attr_guard = __import__("threading").local()


def _catalog_signature(db) -> int:
    """Cheap fingerprint of every table's shape + view definitions; when
    unchanged, cached view column layouts are still valid."""
    parts = []
    with db.lock:
        for sn in sorted(db.schemas):
            s = db.schemas[sn]
            for tn in sorted(s.tables):
                t = s.tables[tn]
                parts.append((sn, tn, tuple(t.column_names),
                              tuple(str(ct) for ct in t.column_types)))
            for vn in sorted(s.views):
                parts.append((sn, vn, getattr(s.views[vn], "sql", "")))
    return hash(tuple(parts))


def _view_columns(db) -> dict:
    """(schema, view) → [(name, SqlType)] by zero-row executing each view.
    Guarded against recursion (a view over pg_attribute would otherwise
    re-enter this builder) and cached per catalog signature — psql issues
    several pg_attribute scans per \\d and must not re-plan every view
    each time."""
    if getattr(_view_attr_guard, "busy", False):
        return {}
    sig = _catalog_signature(db)
    cached = getattr(db, "_view_cols_cache", None)
    if cached is not None and cached[0] == sig:
        return cached[1]
    out: dict = {}
    _view_attr_guard.busy = True
    try:
        conn = db.connect()
        try:
            with db.lock:
                names = [(sn, vn) for sn, s in db.schemas.items()
                         for vn in s.views]
            for sn, vn in names:
                try:
                    r = conn.execute(
                        f'SELECT * FROM "{sn}"."{vn}" LIMIT 0')
                    out[(sn, vn)] = list(zip(
                        r.batch.names, [c.type for c in r.batch.columns]))
                except Exception:
                    pass
        finally:
            conn.close()
    finally:
        _view_attr_guard.busy = False
    db._view_cols_cache = (sig, out)
    return out


def _pg_attribute(db) -> MemTable:
    rows: dict[str, list] = {c: [] for c, _ in _PG_ATTR_SPEC}
    vcols = _view_columns(db)
    with db.lock:
        rels = []
        for sname, s in db.schemas.items():
            for tname, t in s.tables.items():
                rels.append((db.oid_of("table", sname, tname), t))
        for (sname, vname), cols in vcols.items():
            rels.append((db.oid_of("view", sname, vname),
                         _typed(vname, cols, {})))
    for oid, t in rels:
        if t is None:
            continue
        nn = set((getattr(t, "table_meta", {}) or {}).get("not_null", []))
        pk = set((getattr(t, "table_meta", {}) or {}).get("primary_key", []))
        for pos, (cn, ct) in enumerate(
                zip(t.column_names, t.column_types), 1):
            rows["attrelid"].append(oid)
            rows["attname"].append(cn)
            rows["atttypid"].append(type_oid_of(ct))
            rows["attstattarget"].append(-1)
            rows["attlen"].append(-1)
            rows["attnum"].append(pos)
            rows["attndims"].append(0)
            rows["attcacheoff"].append(-1)
            rows["atttypmod"].append(-1)
            rows["attbyval"].append(True)
            rows["attstorage"].append("p")
            rows["attalign"].append("i")
            rows["attnotnull"].append(cn in nn or cn in pk)
            rows["atthasdef"].append(False)
            rows["atthasmissing"].append(False)
            rows["attidentity"].append("")
            rows["attgenerated"].append("")
            rows["attisdropped"].append(False)
            rows["attislocal"].append(True)
            rows["attinhcount"].append(0)
            rows["attcollation"].append(0)
    return _typed("pg_attribute", _PG_ATTR_SPEC, rows)


_PG_INDEX_SPEC = [
    ("indexrelid", dt.OID), ("indrelid", dt.OID), ("indnatts", dt.SMALLINT),
    ("indnkeyatts", dt.SMALLINT), ("indisunique", dt.BOOL),
    ("indisprimary", dt.BOOL), ("indisexclusion", dt.BOOL),
    ("indimmediate", dt.BOOL), ("indisclustered", dt.BOOL),
    ("indisvalid", dt.BOOL), ("indcheckxmin", dt.BOOL),
    ("indisready", dt.BOOL), ("indislive", dt.BOOL),
    ("indisreplident", dt.BOOL), ("indkey", dt.VARCHAR),
    ("indoption", dt.VARCHAR), ("indexprs", dt.VARCHAR),
    ("indpred", dt.VARCHAR),
]


def _index_entries(db):
    """(index_oid, table_oid, schema, iname, idx, table) rows."""
    out = []
    with db.lock:
        for sname, s in db.schemas.items():
            for tname, t in s.tables.items():
                toid = db.oid_of("table", sname, tname)
                for iname, idx in getattr(t, "indexes", {}).items():
                    out.append((db.oid_of("index", sname, iname), toid,
                                sname, iname, idx, t))
    return out


def _pg_index(db) -> MemTable:
    rows: dict[str, list] = {c: [] for c, _ in _PG_INDEX_SPEC}
    for ioid, toid, sname, iname, idx, t in _index_entries(db):
        cols = list(getattr(idx, "columns", []))
        attnums = []
        for c in cols:
            try:
                attnums.append(t.column_names.index(c) + 1)
            except ValueError:
                attnums.append(0)
        rows["indexrelid"].append(ioid)
        rows["indrelid"].append(toid)
        rows["indnatts"].append(len(cols))
        rows["indnkeyatts"].append(len(cols))
        rows["indisunique"].append(False)
        rows["indisprimary"].append(False)
        rows["indisexclusion"].append(False)
        rows["indimmediate"].append(True)
        rows["indisclustered"].append(False)
        rows["indisvalid"].append(True)
        rows["indcheckxmin"].append(False)
        rows["indisready"].append(True)
        rows["indislive"].append(True)
        rows["indisreplident"].append(False)
        rows["indkey"].append(" ".join(map(str, attnums)))
        rows["indoption"].append(" ".join("0" for _ in attnums))
        rows["indexprs"].append(None)
        rows["indpred"].append(None)
    return _typed("pg_index", _PG_INDEX_SPEC, rows)


def _pg_am(db) -> MemTable:
    ams = [(2, "btree"), (403, "btree"), (405, "hash"), (783, "gist"),
           (2742, "gin"), (4000, "spgist"), (9001, "inverted"),
           (9002, "ivf"), (9003, "maxsim")]
    return _typed("pg_am", [
        ("oid", dt.OID), ("amname", dt.VARCHAR), ("amhandler", dt.OID),
        ("amtype", dt.VARCHAR)], {
        "oid": [a[0] for a in ams], "amname": [a[1] for a in ams],
        "amhandler": [0] * len(ams), "amtype": ["i"] * len(ams)})


def _pg_constraint(db) -> MemTable:
    spec = [("oid", dt.OID), ("conname", dt.VARCHAR),
            ("connamespace", dt.OID), ("contype", dt.VARCHAR),
            ("condeferrable", dt.BOOL), ("condeferred", dt.BOOL),
            ("convalidated", dt.BOOL), ("conrelid", dt.OID),
            ("contypid", dt.OID), ("conindid", dt.OID),
            ("confrelid", dt.OID), ("conkey", dt.VARCHAR),
            ("confkey", dt.VARCHAR), ("conbin", dt.VARCHAR)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    with db.lock:
        for sname, s in db.schemas.items():
            for tname, t in s.tables.items():
                pk = (getattr(t, "table_meta", {}) or {}).get(
                    "primary_key") or []
                if not pk:
                    continue
                toid = db.oid_of("table", sname, tname)
                attnums = [t.column_names.index(c) + 1
                           for c in pk if c in t.column_names]
                rows["oid"].append(db.oid_of("constraint", sname,
                                             f"{tname}_pkey"))
                rows["conname"].append(f"{tname}_pkey")
                rows["connamespace"].append(_ns_oid(db, sname))
                rows["contype"].append("p")
                rows["condeferrable"].append(False)
                rows["condeferred"].append(False)
                rows["convalidated"].append(True)
                rows["conrelid"].append(toid)
                rows["contypid"].append(0)
                rows["conindid"].append(0)
                rows["confrelid"].append(0)
                rows["conkey"].append("{" + ",".join(map(str, attnums)) + "}")
                rows["confkey"].append(None)
                rows["conbin"].append(None)
    return _typed("pg_constraint", spec, rows)


def _pg_type(db) -> MemTable:
    spec = [("oid", dt.OID), ("typname", dt.VARCHAR),
            ("typnamespace", dt.OID), ("typowner", dt.OID),
            ("typlen", dt.SMALLINT), ("typbyval", dt.BOOL),
            ("typtype", dt.VARCHAR), ("typcategory", dt.VARCHAR),
            ("typispreferred", dt.BOOL), ("typisdefined", dt.BOOL),
            ("typdelim", dt.VARCHAR), ("typrelid", dt.OID),
            ("typelem", dt.OID), ("typarray", dt.OID),
            ("typbasetype", dt.OID), ("typtypmod", dt.INT),
            ("typnotnull", dt.BOOL), ("typcollation", dt.OID),
            ("typdefault", dt.VARCHAR)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    for oid, name, tlen, ttype, tcat, telem, tarr in TYPE_ROWS:
        rows["oid"].append(oid)
        rows["typname"].append(name)
        rows["typnamespace"].append(NS_PG_CATALOG)
        rows["typowner"].append(10)
        rows["typlen"].append(tlen)
        rows["typbyval"].append(tlen in (1, 2, 4, 8))
        rows["typtype"].append(ttype)
        rows["typcategory"].append(tcat)
        rows["typispreferred"].append(name in ("bool", "int4", "text",
                                               "float8"))
        rows["typisdefined"].append(True)
        rows["typdelim"].append(",")
        rows["typrelid"].append(0)
        rows["typelem"].append(telem)
        rows["typarray"].append(tarr)
        rows["typbasetype"].append(0)
        rows["typtypmod"].append(-1)
        rows["typnotnull"].append(False)
        rows["typcollation"].append(0)
        rows["typdefault"].append(None)
    return _typed("pg_type", spec, rows)


def _pg_proc(db) -> MemTable:
    spec = [("oid", dt.OID), ("proname", dt.VARCHAR),
            ("pronamespace", dt.OID), ("proowner", dt.OID),
            ("prolang", dt.OID), ("prokind", dt.VARCHAR),
            ("prosecdef", dt.BOOL), ("proretset", dt.BOOL),
            ("provolatile", dt.VARCHAR), ("pronargs", dt.SMALLINT),
            ("prorettype", dt.OID), ("proargtypes", dt.VARCHAR),
            ("proargnames", dt.VARCHAR), ("prosrc", dt.VARCHAR)]
    names = _proc_names()
    rows = {
        "oid": [_PROC_OID_BASE + i for i in range(len(names))],
        "proname": names,
        "pronamespace": [NS_PG_CATALOG] * len(names),
        "proowner": [10] * len(names),
        "prolang": [12] * len(names),
        "prokind": ["f"] * len(names),
        "prosecdef": [False] * len(names),
        "proretset": [False] * len(names),
        "provolatile": ["i"] * len(names),
        "pronargs": [0] * len(names),
        "prorettype": [25] * len(names),
        "proargtypes": [""] * len(names),
        "proargnames": [None] * len(names),
        "prosrc": names,
    }
    return _typed("pg_proc", spec, rows)


def _pg_roles(db) -> MemTable:
    spec = [("oid", dt.OID), ("rolname", dt.VARCHAR), ("rolsuper", dt.BOOL),
            ("rolinherit", dt.BOOL), ("rolcreaterole", dt.BOOL),
            ("rolcreatedb", dt.BOOL), ("rolcanlogin", dt.BOOL),
            ("rolreplication", dt.BOOL), ("rolconnlimit", dt.INT),
            ("rolpassword", dt.VARCHAR), ("rolvaliduntil", dt.VARCHAR),
            ("rolbypassrls", dt.BOOL), ("rolconfig", dt.VARCHAR)]
    with db.roles._lock:
        rn = sorted(db.roles.roles)
        infos = [db.roles.roles[r] for r in rn]
    rows = {
        "oid": [db.oid_of("role", "", r) for r in rn],
        "rolname": rn,
        "rolsuper": [bool(i.get("superuser")) for i in infos],
        "rolinherit": [True] * len(rn),
        "rolcreaterole": [bool(i.get("superuser")) for i in infos],
        "rolcreatedb": [bool(i.get("superuser")) for i in infos],
        "rolcanlogin": [bool(i.get("login", True)) for i in infos],
        "rolreplication": [False] * len(rn),
        "rolconnlimit": [-1] * len(rn),
        "rolpassword": ["********"] * len(rn),
        "rolvaliduntil": [None] * len(rn),
        "rolbypassrls": [bool(i.get("superuser")) for i in infos],
        "rolconfig": [None] * len(rn),
    }
    return _typed("pg_roles", spec, rows)


def _pg_database(db) -> MemTable:
    spec = [("oid", dt.OID), ("datname", dt.VARCHAR), ("datdba", dt.OID),
            ("encoding", dt.INT), ("datcollate", dt.VARCHAR),
            ("datctype", dt.VARCHAR), ("datistemplate", dt.BOOL),
            ("datallowconn", dt.BOOL), ("datconnlimit", dt.INT),
            ("dattablespace", dt.OID), ("datacl", dt.VARCHAR)]
    return _typed("pg_database", spec, {
        "oid": [1], "datname": ["serene"], "datdba": [10], "encoding": [6],
        "datcollate": ["C"], "datctype": ["C"], "datistemplate": [False],
        "datallowconn": [True], "datconnlimit": [-1], "dattablespace": [0],
        "datacl": [None]})


def _pg_tables(db) -> MemTable:
    rows = db.table_list()
    t = [r for r in rows if r[2] == "table"]
    return _typed("pg_tables", [
        ("schemaname", dt.VARCHAR), ("tablename", dt.VARCHAR),
        ("tableowner", dt.VARCHAR), ("tablespace", dt.VARCHAR),
        ("hasindexes", dt.BOOL), ("hasrules", dt.BOOL),
        ("hastriggers", dt.BOOL), ("rowsecurity", dt.BOOL)], {
        "schemaname": [r[0] for r in t], "tablename": [r[1] for r in t],
        "tableowner": ["serene"] * len(t), "tablespace": [None] * len(t),
        "hasindexes": [False] * len(t), "hasrules": [False] * len(t),
        "hastriggers": [False] * len(t), "rowsecurity": [False] * len(t)})


def _pg_views(db) -> MemTable:
    rows = db.table_list()
    v = [r for r in rows if r[2] == "view"]
    defs = []
    with db.lock:
        for sname, name, _ in v:
            vd = db.schemas[sname].views.get(name)
            defs.append(getattr(vd, "sql", "") or "")
    return _typed("pg_views", [
        ("schemaname", dt.VARCHAR), ("viewname", dt.VARCHAR),
        ("viewowner", dt.VARCHAR), ("definition", dt.VARCHAR)], {
        "schemaname": [r[0] for r in v], "viewname": [r[1] for r in v],
        "viewowner": ["serene"] * len(v), "definition": defs})


def _pg_indexes(db) -> MemTable:
    rows_s, rows_t, rows_i, rows_d = [], [], [], []
    for ioid, toid, sname, iname, idx, t in _index_entries(db):
        rows_s.append(sname)
        rows_t.append(t.name if hasattr(t, "name") else "")
        rows_i.append(iname)
        rows_d.append(f"CREATE INDEX {iname} ON {rows_t[-1]} "
                      f"USING {idx.using} ({', '.join(idx.columns)})")
    return _typed("pg_indexes", [
        ("schemaname", dt.VARCHAR), ("tablename", dt.VARCHAR),
        ("indexname", dt.VARCHAR), ("tablespace", dt.VARCHAR),
        ("indexdef", dt.VARCHAR)], {
        "schemaname": rows_s, "tablename": rows_t, "indexname": rows_i,
        "tablespace": [None] * len(rows_i), "indexdef": rows_d})


def _pg_sequences(db) -> MemTable:
    spec = [("schemaname", dt.VARCHAR), ("sequencename", dt.VARCHAR),
            ("sequenceowner", dt.VARCHAR), ("data_type", dt.VARCHAR),
            ("start_value", dt.BIGINT), ("min_value", dt.BIGINT),
            ("max_value", dt.BIGINT), ("increment_by", dt.BIGINT),
            ("cycle", dt.BOOL), ("cache_size", dt.BIGINT),
            ("last_value", dt.BIGINT)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    with db.lock:
        for qname, info in db.sequences.items():
            sch, _, nm = qname.rpartition(".")
            rows["schemaname"].append(sch or "main")
            rows["sequencename"].append(nm)
            rows["sequenceowner"].append("serene")
            rows["data_type"].append("bigint")
            rows["start_value"].append(int(info.get("start", 1)))
            rows["min_value"].append(1)
            rows["max_value"].append(2**63 - 1)
            rows["increment_by"].append(int(info.get("increment", 1)))
            rows["cycle"].append(False)
            rows["cache_size"].append(1)
            rows["last_value"].append(int(info.get("value", 0)))
    return _typed("pg_sequences", spec, rows)


def _pg_stat_user_tables(db) -> MemTable:
    spec = [("relid", dt.OID), ("schemaname", dt.VARCHAR),
            ("relname", dt.VARCHAR), ("seq_scan", dt.BIGINT),
            ("seq_tup_read", dt.BIGINT), ("idx_scan", dt.BIGINT),
            ("n_tup_ins", dt.BIGINT), ("n_tup_upd", dt.BIGINT),
            ("n_tup_del", dt.BIGINT), ("n_live_tup", dt.BIGINT),
            ("n_dead_tup", dt.BIGINT)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    with db.lock:
        for sname, s in db.schemas.items():
            for tname, t in s.tables.items():
                rows["relid"].append(db.oid_of("table", sname, tname))
                rows["schemaname"].append(sname)
                rows["relname"].append(tname)
                for c in ("seq_scan", "seq_tup_read", "idx_scan",
                          "n_tup_ins", "n_tup_upd", "n_tup_del",
                          "n_dead_tup"):
                    rows[c].append(0)
                rows["n_live_tup"].append(t.row_count())
    return _typed("pg_stat_user_tables", spec, rows)


def _pg_stat_activity(db) -> MemTable:
    from .sql.binder import format_timestamp
    with db.lock:
        sess = [dict(v) for v in db.sessions.values()]
    sess.sort(key=lambda v: v["pid"])

    def ts(v):
        return (format_timestamp(int(v * 1_000_000))
                if v is not None else None)
    return _typed("pg_stat_activity", [
        ("datid", dt.OID), ("datname", dt.VARCHAR), ("pid", dt.INT),
        ("usename", dt.VARCHAR), ("application_name", dt.VARCHAR),
        ("client_addr", dt.VARCHAR), ("backend_start", dt.VARCHAR),
        ("query_start", dt.VARCHAR), ("state", dt.VARCHAR),
        ("wait_event_type", dt.VARCHAR), ("wait_event", dt.VARCHAR),
        ("query_id", dt.BIGINT), ("query", dt.VARCHAR)], {
        "datid": [1] * len(sess), "datname": ["serene"] * len(sess),
        "pid": [v["pid"] for v in sess],
        "usename": [v["usename"] for v in sess],
        "application_name": [v["application_name"] for v in sess],
        "client_addr": [v.get("client_addr") for v in sess],
        "backend_start": [ts(v["backend_start"]) for v in sess],
        "query_start": [ts(v["query_start"]) for v in sess],
        "state": [v["state"] for v in sess],
        # live wait feed (obs/resources.wait_scope): what an ACTIVE
        # session is blocked on right now — worker-pool task waits,
        # search-batch coalescing, collective combines; NULL when
        # running on-CPU or idle (PG semantics)
        "wait_event_type": [v.get("wait_event_type") for v in sess],
        "wait_event": [v.get("wait_event") for v in sess],
        # normalized-statement fingerprint of the session's last
        # completed statement (sdb_stat_statements key), NULL before
        # any profiled execution
        "query_id": [v.get("query_id") for v in sess],
        "query": [v["query"] for v in sess]})


def _pg_settings(db) -> MemTable:
    names = _settings_registry.names()
    return _typed("pg_settings", [
        ("name", dt.VARCHAR), ("setting", dt.VARCHAR),
        ("unit", dt.VARCHAR), ("category", dt.VARCHAR),
        ("short_desc", dt.VARCHAR), ("context", dt.VARCHAR),
        ("vartype", dt.VARCHAR), ("source", dt.VARCHAR),
        ("boot_val", dt.VARCHAR), ("reset_val", dt.VARCHAR)], {
        "name": names,
        "setting": [str(_settings_registry.get_global(n)) for n in names],
        "unit": [None] * len(names),
        "category": ["serenedb"] * len(names),
        "short_desc": [_settings_registry.definition(n).description
                       for n in names],
        "context": ["user"] * len(names),
        "vartype": ["string"] * len(names),
        "source": ["default"] * len(names),
        "boot_val": [str(_settings_registry.get_global(n)) for n in names],
        "reset_val": [str(_settings_registry.get_global(n)) for n in names]})


# information_schema ------------------------------------------------------

#: ISO SQL feature taxonomy rows with THIS ENGINE's honest support flags
#: (reference: server/pg/information_schema/sql_features.txt). A curated
#: representative subset of the standard's feature list.
_SQL_FEATURES = [
    ("B012", "Embedded C", "NO"),
    ("E011", "Numeric data types", "YES"),
    ("E011-01", "INTEGER and SMALLINT data types", "YES"),
    ("E011-02", "REAL, DOUBLE PRECISION and FLOAT data types", "YES"),
    ("E011-04", "Arithmetic operators", "YES"),
    ("E011-05", "Numeric comparison", "YES"),
    ("E011-06", "Implicit casting among the numeric data types", "YES"),
    ("E021", "Character string types", "YES"),
    ("E021-01", "CHARACTER data type", "YES"),
    ("E021-02", "CHARACTER VARYING data type", "YES"),
    ("E021-03", "Character literals", "YES"),
    ("E021-04", "CHARACTER_LENGTH function", "YES"),
    ("E021-05", "OCTET_LENGTH function", "YES"),
    ("E021-06", "SUBSTRING function", "YES"),
    ("E021-07", "Character concatenation", "YES"),
    ("E021-08", "UPPER and LOWER functions", "YES"),
    ("E021-09", "TRIM function", "YES"),
    ("E021-10", "Implicit casting among character types", "YES"),
    ("E021-11", "POSITION function", "YES"),
    ("E031", "Identifiers", "YES"),
    ("E031-01", "Delimited identifiers", "YES"),
    ("E031-02", "Lower case identifiers", "YES"),
    ("E051", "Basic query specification", "YES"),
    ("E051-01", "SELECT DISTINCT", "YES"),
    ("E051-02", "GROUP BY clause", "YES"),
    ("E051-04", "GROUP BY can contain columns not in select list", "YES"),
    ("E051-05", "Select list items can be renamed", "YES"),
    ("E051-06", "HAVING clause", "YES"),
    ("E051-07", "Qualified * in select list", "YES"),
    ("E061", "Basic predicates and search conditions", "YES"),
    ("E061-01", "Comparison predicate", "YES"),
    ("E061-02", "BETWEEN predicate", "YES"),
    ("E061-03", "IN predicate with list of values", "YES"),
    ("E061-04", "LIKE predicate", "YES"),
    ("E061-05", "LIKE predicate: ESCAPE clause", "YES"),
    ("E061-06", "NULL predicate", "YES"),
    ("E061-08", "EXISTS predicate", "YES"),
    ("E061-09", "Subqueries in comparison predicate", "YES"),
    ("E061-11", "Subqueries in IN predicate", "YES"),
    ("E061-13", "Correlated subqueries", "YES"),
    ("E061-14", "Search condition", "YES"),
    ("E071", "Basic query expressions", "YES"),
    ("E071-01", "UNION DISTINCT table operator", "YES"),
    ("E071-02", "UNION ALL table operator", "YES"),
    ("E071-03", "EXCEPT DISTINCT table operator", "YES"),
    ("E071-05", "Columns combined via table operators need not have "
                "exactly the same data type", "YES"),
    ("E071-06", "Table operators in subqueries", "YES"),
    ("E081", "Basic privileges", "YES"),
    ("E081-01", "SELECT privilege at the table level", "YES"),
    ("E081-02", "DELETE privilege", "YES"),
    ("E081-03", "INSERT privilege at the table level", "YES"),
    ("E081-04", "UPDATE privilege at the table level", "YES"),
    ("E091", "Set functions", "YES"),
    ("E091-01", "AVG", "YES"),
    ("E091-02", "COUNT", "YES"),
    ("E091-03", "MAX", "YES"),
    ("E091-04", "MIN", "YES"),
    ("E091-05", "SUM", "YES"),
    ("E091-06", "ALL quantifier", "YES"),
    ("E091-07", "DISTINCT quantifier", "YES"),
    ("E101", "Basic data manipulation", "YES"),
    ("E101-01", "INSERT statement", "YES"),
    ("E101-03", "Searched UPDATE statement", "YES"),
    ("E101-04", "Searched DELETE statement", "YES"),
    ("E111", "Single row SELECT statement", "YES"),
    ("E121", "Basic cursor support", "NO"),
    ("E131", "Null value support (nulls in lieu of values)", "YES"),
    ("E141", "Basic integrity constraints", "YES"),
    ("E141-01", "NOT NULL constraints", "YES"),
    ("E141-03", "PRIMARY KEY constraints", "YES"),
    ("E141-04", "Basic FOREIGN KEY constraint", "NO"),
    ("E151", "Transaction support", "YES"),
    ("E151-01", "COMMIT statement", "YES"),
    ("E151-02", "ROLLBACK statement", "YES"),
    ("E152", "Basic SET TRANSACTION statement", "NO"),
    ("E153", "Updatable queries with subqueries", "YES"),
    ("E161", "SQL comments using leading double minus", "YES"),
    ("E171", "SQLSTATE support", "YES"),
    ("F031", "Basic schema manipulation", "YES"),
    ("F031-01", "CREATE TABLE statement to create persistent base "
                "tables", "YES"),
    ("F031-02", "CREATE VIEW statement", "YES"),
    ("F031-03", "GRANT statement", "YES"),
    ("F031-04", "ALTER TABLE statement: ADD COLUMN clause", "YES"),
    ("F041", "Basic joined table", "YES"),
    ("F041-01", "Inner join (but not necessarily the INNER keyword)",
     "YES"),
    ("F041-02", "INNER keyword", "YES"),
    ("F041-03", "LEFT OUTER JOIN", "YES"),
    ("F041-04", "RIGHT OUTER JOIN", "YES"),
    ("F041-05", "Outer joins can be nested", "YES"),
    ("F041-07", "The inner table in a left or right outer join can also "
                "be used in an inner join", "YES"),
    ("F051", "Basic date and time", "YES"),
    ("F051-01", "DATE data type", "YES"),
    ("F051-02", "TIME data type", "NO"),
    ("F051-03", "TIMESTAMP data type", "YES"),
    ("F081", "UNION and EXCEPT in views", "YES"),
    ("F131", "Grouped operations", "YES"),
    ("F181", "Multiple module support", "NO"),
    ("F201", "CAST function", "YES"),
    ("F221", "Explicit defaults", "YES"),
    ("F261", "CASE expression", "YES"),
    ("F311", "Schema definition statement", "YES"),
    ("F401", "Extended joined table", "YES"),
    ("F401-01", "NATURAL JOIN", "YES"),
    ("F401-02", "FULL OUTER JOIN", "YES"),
    ("F401-04", "CROSS JOIN", "YES"),
    ("F471", "Scalar subquery values", "YES"),
    ("F481", "Expanded NULL predicate", "YES"),
    ("S071", "SQL paths in function and type name resolution", "NO"),
    ("T031", "BOOLEAN data type", "YES"),
    ("T051", "Row types", "YES"),
    ("T071", "BIGINT data type", "YES"),
    ("T121", "WITH (excluding RECURSIVE) in query expression", "YES"),
    ("T321", "Basic SQL-invoked routines", "NO"),
    ("T611", "Elementary OLAP operations", "YES"),
    ("T621", "Enhanced numeric functions", "YES"),
]


def _info_role_table_grants(db) -> MemTable:
    """information_schema.role_table_grants / table_privileges
    (reference: server/pg/information_schema — ACL rows per grantee)."""
    spec = [("grantor", dt.VARCHAR), ("grantee", dt.VARCHAR),
            ("table_catalog", dt.VARCHAR), ("table_schema", dt.VARCHAR),
            ("table_name", dt.VARCHAR), ("privilege_type", dt.VARCHAR),
            ("is_grantable", dt.VARCHAR)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    roles = db.roles
    with roles._lock:
        acls = {k: {r: set(p) for r, p in v.items()}
                for k, v in roles.acls.items()}
    for tkey, acl in sorted(acls.items()):
        schema, _, tname = tkey.rpartition(".")
        for role, privs in sorted(acl.items()):
            for p in sorted(privs):
                rows["grantor"].append("serene")
                rows["grantee"].append(role)
                rows["table_catalog"].append("serene")
                rows["table_schema"].append(schema or "main")
                rows["table_name"].append(tname)
                rows["privilege_type"].append(p.upper())
                rows["is_grantable"].append("NO")
    return _typed("role_table_grants", spec, rows)


def _info_sql_features() -> MemTable:
    spec = [("feature_id", dt.VARCHAR), ("feature_name", dt.VARCHAR),
            ("sub_feature_id", dt.VARCHAR),
            ("sub_feature_name", dt.VARCHAR),
            ("is_supported", dt.VARCHAR),
            ("is_verified_by", dt.VARCHAR), ("comments", dt.VARCHAR)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    for fid, fname, supported in _SQL_FEATURES:
        # PG keeps the dashed id in feature_id and leaves the
        # sub_feature columns empty strings
        rows["feature_id"].append(fid)
        rows["feature_name"].append(fname)
        rows["sub_feature_id"].append("")
        rows["sub_feature_name"].append("")
        rows["is_supported"].append(supported)
        rows["is_verified_by"].append(None)
        rows["comments"].append(None)
    return _typed("sql_features", spec, rows)


def _info_sql_implementation_info() -> MemTable:
    items = [
        ("10003", "CATALOG NAME", None, "Y"),
        ("10004", "COLLATING SEQUENCE", None, "UCS_BASIC"),
        ("23", "MAXIMUM COLUMN NAME LENGTH", 63, None),
        ("17", "MAXIMUM COLUMNS IN GROUP BY", 0, None),
        ("18", "MAXIMUM COLUMNS IN ORDER BY", 0, None),
        ("19", "MAXIMUM COLUMNS IN SELECT", 0, None),
        ("30", "MAXIMUM ROW SIZE", 0, None),
        ("46", "MAXIMUM TABLE NAME LENGTH", 63, None),
        ("35", "MAXIMUM SCHEMA NAME LENGTH", 63, None),
        ("107", "MAXIMUM USER NAME LENGTH", 63, None),
        ("26", "MAXIMUM IDENTIFIER LENGTH", 63, None),
        ("85", "NULL COLLATION", 0, None),
        ("13", "CORRELATION NAME", None, "Y"),
    ]
    spec = [("implementation_info_id", dt.VARCHAR),
            ("implementation_info_name", dt.VARCHAR),
            ("integer_value", dt.INT), ("character_value", dt.VARCHAR),
            ("comments", dt.VARCHAR)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    for iid, name, iv, cv in items:
        rows["implementation_info_id"].append(iid)
        rows["implementation_info_name"].append(name)
        rows["integer_value"].append(iv)
        rows["character_value"].append(cv)
        rows["comments"].append(None)
    return _typed("sql_implementation_info", spec, rows)


def _info_sql_sizing() -> MemTable:
    items = [
        (34, "MAXIMUM CATALOG NAME LENGTH", 63),
        (30, "MAXIMUM ROW SIZE", 0),
        (25, "MAXIMUM IDENTIFIER LENGTH", 63),
        (97, "MAXIMUM COLUMNS IN TABLE", 1600),
        (99, "MAXIMUM TABLES IN SELECT", 0),
        (20, "MAXIMUM COLUMNS IN GROUP BY", 0),
        (21, "MAXIMUM COLUMNS IN INDEX", 32),
        (22, "MAXIMUM COLUMNS IN ORDER BY", 0),
        (23, "MAXIMUM COLUMNS IN SELECT", 0),
        (100, "MAXIMUM VALUE EXPRESSION LENGTH", 0),
    ]
    spec = [("sizing_id", dt.INT), ("sizing_name", dt.VARCHAR),
            ("supported_value", dt.INT), ("comments", dt.VARCHAR)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    for sid, name, val in items:
        rows["sizing_id"].append(sid)
        rows["sizing_name"].append(name)
        rows["supported_value"].append(val)
        rows["comments"].append(None)
    return _typed("sql_sizing", spec, rows)


def _info_tables(db) -> MemTable:
    rows = db.table_list()
    return _typed("tables", [
        ("table_catalog", dt.VARCHAR), ("table_schema", dt.VARCHAR),
        ("table_name", dt.VARCHAR), ("table_type", dt.VARCHAR),
        ("is_insertable_into", dt.VARCHAR)], {
        "table_catalog": ["serene"] * len(rows),
        "table_schema": [r[0] for r in rows],
        "table_name": [r[1] for r in rows],
        "table_type": ["BASE TABLE" if r[2] == "table" else "VIEW"
                       for r in rows],
        "is_insertable_into": ["YES" if r[2] == "table" else "NO"
                               for r in rows]})


def _info_columns(db) -> MemTable:
    spec = [("table_catalog", dt.VARCHAR), ("table_schema", dt.VARCHAR),
            ("table_name", dt.VARCHAR), ("column_name", dt.VARCHAR),
            ("ordinal_position", dt.INT), ("column_default", dt.VARCHAR),
            ("is_nullable", dt.VARCHAR), ("data_type", dt.VARCHAR),
            ("character_maximum_length", dt.INT),
            ("numeric_precision", dt.INT), ("udt_name", dt.VARCHAR)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    with db.lock:
        for sname, s in db.schemas.items():
            for tname, t in s.tables.items():
                nn = set((getattr(t, "table_meta", {}) or {}).get(
                    "not_null", []))
                pk = set((getattr(t, "table_meta", {}) or {}).get(
                    "primary_key", []))
                for pos, (cn, ct) in enumerate(
                        zip(t.column_names, t.column_types), 1):
                    rows["table_catalog"].append("serene")
                    rows["table_schema"].append(sname)
                    rows["table_name"].append(tname)
                    rows["column_name"].append(cn)
                    rows["ordinal_position"].append(pos)
                    rows["column_default"].append(None)
                    rows["is_nullable"].append(
                        "NO" if (cn in nn or cn in pk) else "YES")
                    rows["data_type"].append(
                        format_type_oid(type_oid_of(ct)))
                    rows["character_maximum_length"].append(None)
                    rows["numeric_precision"].append(None)
                    rows["udt_name"].append(
                        type_name_of(type_oid_of(ct)) or "text")
    return _typed("columns", spec, rows)


def _info_schemata(db) -> MemTable:
    with db.lock:
        names = sorted(db.schemas)
    names += ["pg_catalog", "information_schema"]
    return _typed("schemata", [
        ("catalog_name", dt.VARCHAR), ("schema_name", dt.VARCHAR),
        ("schema_owner", dt.VARCHAR)], {
        "catalog_name": ["serene"] * len(names), "schema_name": names,
        "schema_owner": ["serene"] * len(names)})


def _info_table_constraints(db) -> MemTable:
    spec = [("constraint_catalog", dt.VARCHAR),
            ("constraint_schema", dt.VARCHAR),
            ("constraint_name", dt.VARCHAR), ("table_schema", dt.VARCHAR),
            ("table_name", dt.VARCHAR), ("constraint_type", dt.VARCHAR)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    with db.lock:
        for sname, s in db.schemas.items():
            for tname, t in s.tables.items():
                pk = (getattr(t, "table_meta", {}) or {}).get(
                    "primary_key") or []
                if not pk:
                    continue
                rows["constraint_catalog"].append("serene")
                rows["constraint_schema"].append(sname)
                rows["constraint_name"].append(f"{tname}_pkey")
                rows["table_schema"].append(sname)
                rows["table_name"].append(tname)
                rows["constraint_type"].append("PRIMARY KEY")
    return _typed("table_constraints", spec, rows)


def _info_key_column_usage(db) -> MemTable:
    spec = [("constraint_name", dt.VARCHAR), ("table_schema", dt.VARCHAR),
            ("table_name", dt.VARCHAR), ("column_name", dt.VARCHAR),
            ("ordinal_position", dt.INT)]
    rows: dict[str, list] = {c: [] for c, _ in spec}
    with db.lock:
        for sname, s in db.schemas.items():
            for tname, t in s.tables.items():
                pk = (getattr(t, "table_meta", {}) or {}).get(
                    "primary_key") or []
                for i, cn in enumerate(pk, 1):
                    rows["constraint_name"].append(f"{tname}_pkey")
                    rows["table_schema"].append(sname)
                    rows["table_name"].append(tname)
                    rows["column_name"].append(cn)
                    rows["ordinal_position"].append(i)
    return _typed("key_column_usage", spec, rows)


# empty-but-typed catalogs: psql/ORM queries join them; zero rows is the
# truthful answer (no toast tables, no triggers, no row policies, ...)
_EMPTY_TABLES: dict[str, list[tuple[str, dt.SqlType]]] = {
    "pg_description": [("objoid", dt.OID), ("classoid", dt.OID),
                       ("objsubid", dt.INT), ("description", dt.VARCHAR)],
    "pg_shdescription": [("objoid", dt.OID), ("classoid", dt.OID),
                         ("description", dt.VARCHAR)],
    "pg_attrdef": [("oid", dt.OID), ("adrelid", dt.OID),
                   ("adnum", dt.SMALLINT), ("adbin", dt.VARCHAR)],
    "pg_trigger": [("oid", dt.OID), ("tgrelid", dt.OID),
                   ("tgname", dt.VARCHAR), ("tgfoid", dt.OID),
                   ("tgtype", dt.SMALLINT), ("tgenabled", dt.VARCHAR),
                   ("tgisinternal", dt.BOOL)],
    "pg_rewrite": [("oid", dt.OID), ("rulename", dt.VARCHAR),
                   ("ev_class", dt.OID), ("ev_type", dt.VARCHAR)],
    "pg_policy": [("oid", dt.OID), ("polname", dt.VARCHAR),
                  ("polrelid", dt.OID)],
    "pg_inherits": [("inhrelid", dt.OID), ("inhparent", dt.OID),
                    ("inhseqno", dt.INT)],
    "pg_enum": [("oid", dt.OID), ("enumtypid", dt.OID),
                ("enumsortorder", dt.FLOAT), ("enumlabel", dt.VARCHAR)],
    "pg_range": [("rngtypid", dt.OID), ("rngsubtype", dt.OID)],
    "pg_locks": [("locktype", dt.VARCHAR), ("database", dt.OID),
                 ("relation", dt.OID), ("pid", dt.INT),
                 ("mode", dt.VARCHAR), ("granted", dt.BOOL)],
    "pg_extension": [("oid", dt.OID), ("extname", dt.VARCHAR),
                     ("extowner", dt.OID), ("extnamespace", dt.OID),
                     ("extversion", dt.VARCHAR)],
    "pg_depend": [("classid", dt.OID), ("objid", dt.OID),
                  ("objsubid", dt.INT), ("refclassid", dt.OID),
                  ("refobjid", dt.OID), ("refobjsubid", dt.INT),
                  ("deptype", dt.VARCHAR)],
    "pg_event_trigger": [("oid", dt.OID), ("evtname", dt.VARCHAR)],
    "pg_foreign_server": [("oid", dt.OID), ("srvname", dt.VARCHAR)],
    "pg_foreign_table": [("ftrelid", dt.OID), ("ftserver", dt.OID)],
    "pg_foreign_data_wrapper": [("oid", dt.OID), ("fdwname", dt.VARCHAR)],
    "pg_partitioned_table": [("partrelid", dt.OID),
                             ("partstrat", dt.VARCHAR)],
    "pg_publication": [("oid", dt.OID), ("pubname", dt.VARCHAR)],
    "pg_subscription": [("oid", dt.OID), ("subname", dt.VARCHAR)],
    "pg_auth_members": [("roleid", dt.OID), ("member", dt.OID),
                        ("grantor", dt.OID), ("admin_option", dt.BOOL)],
    "pg_tablespace": [("oid", dt.OID), ("spcname", dt.VARCHAR),
                      ("spcowner", dt.OID)],
    "pg_collation": [("oid", dt.OID), ("collname", dt.VARCHAR),
                     ("collnamespace", dt.OID),
                     ("collcollate", dt.VARCHAR)],
    "pg_matviews": [("schemaname", dt.VARCHAR), ("matviewname", dt.VARCHAR),
                    ("matviewowner", dt.VARCHAR),
                    ("definition", dt.VARCHAR)],
    "pg_statio_user_tables": [("relid", dt.OID),
                              ("schemaname", dt.VARCHAR),
                              ("relname", dt.VARCHAR),
                              ("heap_blks_read", dt.BIGINT),
                              ("heap_blks_hit", dt.BIGINT)],
    "referential_constraints": [("constraint_catalog", dt.VARCHAR),
                                ("constraint_schema", dt.VARCHAR),
                                ("constraint_name", dt.VARCHAR),
                                ("unique_constraint_name", dt.VARCHAR)],
    "routines": [("routine_catalog", dt.VARCHAR),
                 ("routine_schema", dt.VARCHAR),
                 ("routine_name", dt.VARCHAR),
                 ("routine_type", dt.VARCHAR),
                 ("data_type", dt.VARCHAR)],
    "character_sets": [("character_set_catalog", dt.VARCHAR),
                       ("character_set_schema", dt.VARCHAR),
                       ("character_set_name", dt.VARCHAR)],
}

_BUILDERS: dict[str, Callable] = {
    "pg_namespace": _pg_namespace,
    "pg_class": _pg_class,
    "pg_attribute": _pg_attribute,
    "pg_index": _pg_index,
    "pg_am": _pg_am,
    "pg_constraint": _pg_constraint,
    "pg_type": _pg_type,
    "pg_proc": _pg_proc,
    "pg_roles": _pg_roles,
    "pg_user": _pg_roles,
    "pg_authid": _pg_roles,
    "pg_shadow": _pg_roles,
    "pg_database": _pg_database,
    "pg_tables": _pg_tables,
    "pg_views": _pg_views,
    "pg_indexes": _pg_indexes,
    "pg_sequences": _pg_sequences,
    "pg_stat_user_tables": _pg_stat_user_tables,
    "pg_stat_activity": _pg_stat_activity,
    "pg_settings": _pg_settings,
    "schemata": _info_schemata,
    "table_constraints": _info_table_constraints,
    "key_column_usage": _info_key_column_usage,
    "role_table_grants": lambda db: _info_role_table_grants(db),
    "table_privileges": lambda db: _info_role_table_grants(db),
    "sql_features": lambda db: _info_sql_features(),
    "sql_implementation_info": lambda db: _info_sql_implementation_info(),
    "sql_sizing": lambda db: _info_sql_sizing(),
}


def system_table(db, parts: list[str]) -> Optional[TableProvider]:
    name = parts[-1].lower()
    schema = parts[-2].lower() if len(parts) >= 2 else None
    if schema is not None and schema not in ("pg_catalog",
                                             "information_schema",
                                             "sdb_catalog"):
        return None
    # information_schema.tables/columns shadow unqualified pg names
    if name == "tables" and schema == "information_schema":
        return _info_tables(db)
    if name == "columns" and (schema == "information_schema" or
                              schema is None):
        return _info_columns(db)
    if name == "views" and schema == "information_schema":
        v = _pg_views(db)
        b = v.full_batch(None)
        return MemTable("views", Batch(
            ["table_catalog", "table_schema", "table_name",
             "view_definition"],
            [Column.from_pylist(["serene"] * b.num_rows, dt.VARCHAR),
             b.column("schemaname"), b.column("viewname"),
             b.column("definition")]))
    if name == "sequences" and schema == "information_schema":
        s = _pg_sequences(db)
        b = s.full_batch(None)
        return MemTable("sequences", Batch(
            ["sequence_catalog", "sequence_schema", "sequence_name",
             "data_type"],
            [Column.from_pylist(["serene"] * b.num_rows, dt.VARCHAR),
             b.column("schemaname"), b.column("sequencename"),
             b.column("data_type")]))
    builder = _BUILDERS.get(name)
    if builder is not None:
        return builder(db)
    if name in _EMPTY_TABLES:
        return _typed(name, _EMPTY_TABLES[name], {})
    if name.startswith("pg_stat_progress"):
        from .utils.progress import REGISTRY as _progress
        recs = _progress.snapshot()
        return _typed(name, [
            ("pid", dt.INT), ("command", dt.VARCHAR), ("phase", dt.VARCHAR),
            ("tuples_done", dt.BIGINT), ("tuples_total", dt.BIGINT)], {
            "pid": [r["pid"] for r in recs],
            "command": [r["command"] for r in recs],
            "phase": [r["phase"] for r in recs],
            "tuples_done": [r["done"] for r in recs],
            "tuples_total": [r["total"] for r in recs]})
    if name == "sdb_indexes":
        rows = {"schema": [], "table": [], "index": [], "type": [],
                "columns": [], "segments": [], "indexed_rows": [],
                "fresh": []}
        with db.lock:
            for sname, s in db.schemas.items():
                for tname, t in s.tables.items():
                    for iname, idx in getattr(t, "indexes", {}).items():
                        rows["schema"].append(sname)
                        rows["table"].append(tname)
                        rows["index"].append(iname)
                        rows["type"].append(idx.using)
                        rows["columns"].append(",".join(idx.columns))
                        segs = max((len(ms.segments) for ms in
                                    getattr(idx, "searchers", {}).values()),
                                   default=1)
                        rows["segments"].append(segs)
                        rows["indexed_rows"].append(
                            getattr(idx, "indexed_rows", t.row_count()))
                        rows["fresh"].append(
                            idx.data_version == t.data_version)
        return MemTable("sdb_indexes", Batch.from_pydict(rows))
    if name == "sdb_settings":
        names = _settings_registry.names()
        return MemTable("sdb_settings", Batch.from_pydict({
            "name": names,
            "setting": [str(_settings_registry.get_global(n))
                        for n in names],
            "description": [_settings_registry.definition(n).description
                            for n in names],
        }))
    if name == "sdb_metrics":
        return metrics_table()
    if name == "sdb_log":
        return log_table()
    if name == "sdb_stat_statements":
        return stat_statements_table()
    if name == "sdb_cache":
        return cache_table()
    if name == "sdb_trace":
        return trace_table([])
    if name == "sdb_query_progress":
        return query_progress_table()
    if name == "sdb_admission":
        return admission_table()
    if name == "sdb_connections":
        return connections_table()
    if name == "sdb_device":
        return device_table()
    if name == "sdb_programs":
        return programs_table()
    if name == "sdb_device_cache":
        return device_cache_table()
    if name == "sdb_posting_pool":
        return posting_pool_table()
    return None


def device_table() -> TableProvider:
    """sdb_device: one row per mesh device (a logical device of a virtual
    mesh included) — kernel launches, transfer bytes/time host→device
    and device→host, and the live-bytes estimate (the device column
    cache and the posting and vector pools, split per holding device).
    The device telemetry ledger (obs/device.py, serene_device_telemetry);
    empty counters when telemetry is off."""
    from .obs.device import device_rows
    rows = device_rows()
    return _typed("sdb_device", [
        ("device", dt.INT), ("platform", dt.VARCHAR),
        ("kind", dt.VARCHAR), ("dispatches", dt.BIGINT),
        ("bytes_up", dt.BIGINT), ("transfers_up", dt.BIGINT),
        ("up_ms", dt.DOUBLE), ("bytes_down", dt.BIGINT),
        ("transfers_down", dt.BIGINT), ("down_ms", dt.DOUBLE),
        ("hbm_bytes_est", dt.BIGINT)], {
        "device": [r["device"] for r in rows],
        "platform": [r["platform"] for r in rows],
        "kind": [r["kind"] for r in rows],
        "dispatches": [r["dispatches"] for r in rows],
        "bytes_up": [r["bytes_up"] for r in rows],
        "transfers_up": [r["transfers_up"] for r in rows],
        "up_ms": [r["up_ms"] for r in rows],
        "bytes_down": [r["bytes_down"] for r in rows],
        "transfers_down": [r["transfers_down"] for r in rows],
        "down_ms": [r["down_ms"] for r in rows],
        "hbm_bytes_est": [r["hbm_bytes_est"] for r in rows]})


def programs_table() -> TableProvider:
    """sdb_programs: the XLA compile ledger — one row per program
    family (fused / fused_build / fused_probe / fused_collective /
    fused_topn / device_agg / device_topn / mesh_* / search programs)
    with live entry counts, cumulative compiles, cache hit/miss totals,
    LRU evictions, recompile-storm count, and compile wall time
    (first-dispatch trace)."""
    from .obs.device import PROGRAMS
    rows = PROGRAMS.snapshot()
    return _typed("sdb_programs", [
        ("family", dt.VARCHAR), ("entries", dt.BIGINT),
        ("compiles", dt.BIGINT), ("hits", dt.BIGINT),
        ("misses", dt.BIGINT), ("evictions", dt.BIGINT),
        ("storms", dt.BIGINT), ("compile_ms_total", dt.DOUBLE),
        ("compile_ms_mean", dt.DOUBLE), ("last_compile_ms", dt.DOUBLE)], {
        "family": [r["family"] for r in rows],
        "entries": [r["entries"] for r in rows],
        "compiles": [r["compiles"] for r in rows],
        "hits": [r["hits"] for r in rows],
        "misses": [r["misses"] for r in rows],
        "evictions": [r["evictions"] for r in rows],
        "storms": [r["storms"] for r in rows],
        "compile_ms_total": [r["compile_ms_total"] for r in rows],
        "compile_ms_mean": [r["compile_ms_mean"] for r in rows],
        "last_compile_ms": [r["last_compile_ms"] for r in rows]})


def device_cache_table() -> TableProvider:
    """sdb_device_cache: one row per live DEVICE_CACHE entry — which
    publication (table/version/epoch) and column occupies HBM, the
    entry kind (col = column tiles, arr = code/rowmask/build-output
    arrays), bytes, holding devices, hit count and idle time. The
    per-publication occupancy view the paged-postings roadmap item
    tunes against."""
    from .obs.device import device_cache_rows
    rows = device_cache_rows()
    return _typed("sdb_device_cache", [
        ("table_name", dt.VARCHAR), ("token", dt.BIGINT),
        ("data_version", dt.BIGINT), ("mutation_epoch", dt.BIGINT),
        ("column_name", dt.VARCHAR), ("kind", dt.VARCHAR),
        ("tag", dt.VARCHAR), ("bytes", dt.BIGINT),
        ("devices", dt.VARCHAR), ("hits", dt.BIGINT),
        ("idle_ms", dt.DOUBLE)], {
        "table_name": [r["table"] for r in rows],
        "token": [r["token"] for r in rows],
        "data_version": [r["data_version"] for r in rows],
        "mutation_epoch": [r["mutation_epoch"] for r in rows],
        "column_name": [r["column"] for r in rows],
        "kind": [r["kind"] for r in rows],
        "tag": [r["tag"] for r in rows],
        "bytes": [r["bytes"] for r in rows],
        "devices": [r["devices"] for r in rows],
        "hits": [r["hits"] for r in rows],
        "idle_ms": [r["idle_ms"] for r in rows]})


def posting_pool_table() -> TableProvider:
    """sdb_posting_pool: one row per (publication, segment) group of
    resident posting-pool terms — which table/version/epoch occupies
    the paged HBM region, how many terms/pages/bytes it holds, hit
    counts and idle time. The occupancy view operators size
    `serene_posting_pages` from (search/posting_pool.py)."""
    from .obs.device import provider_name
    from .search.posting_pool import POOL
    rows = POOL.snapshot()
    return _typed("sdb_posting_pool", [
        ("table_name", dt.VARCHAR), ("token", dt.BIGINT),
        ("data_version", dt.BIGINT), ("mutation_epoch", dt.BIGINT),
        ("segment", dt.BIGINT), ("terms", dt.BIGINT),
        ("pages", dt.BIGINT), ("bytes", dt.BIGINT),
        ("hits", dt.BIGINT), ("idle_ms", dt.DOUBLE)], {
        "table_name": [provider_name(r["token"]) for r in rows],
        "token": [r["token"] for r in rows],
        "data_version": [r["data_version"] for r in rows],
        "mutation_epoch": [r["mutation_epoch"] for r in rows],
        "segment": [r["segment"] for r in rows],
        "terms": [r["terms"] for r in rows],
        "pages": [r["pages"] for r in rows],
        "bytes": [r["bytes"] for r in rows],
        "hits": [r["hits"] for r in rows],
        "idle_ms": [r["idle_ms"] for r in rows]})


def cache_table() -> TableProvider:
    """sdb_cache: one row per live cache entry across both tiers —
    result entries carry their normalized query text and source tables,
    fragment entries their segment + shape digest."""
    from .cache.fragments import FRAGMENTS
    from .cache.result import RESULT_CACHE
    rows = RESULT_CACHE.snapshot() + FRAGMENTS.snapshot()
    return _typed("sdb_cache", [
        ("tier", dt.VARCHAR), ("key", dt.VARCHAR), ("query", dt.VARCHAR),
        ("queryid", dt.BIGINT), ("bytes", dt.BIGINT), ("hits", dt.BIGINT),
        ("rows", dt.BIGINT), ("objects", dt.VARCHAR)], {
        "tier": [e["tier"] for e in rows],
        "key": [e["key"] for e in rows],
        "query": [e["query"] for e in rows],
        "queryid": [e["queryid"] for e in rows],
        "bytes": [e["bytes"] for e in rows],
        "hits": [e["hits"] for e in rows],
        "rows": [e["rows"] for e in rows],
        "objects": [e["objects"] for e in rows]})


def stat_statements_table() -> TableProvider:
    """sdb_stat_statements: cumulative stats per normalized statement
    fingerprint (obs/statements.py), PG pg_stat_statements column
    shapes where they map, plus per-fingerprint latency percentiles
    derived from the entry's log-spaced histogram sketch. LRU-capped by
    serene_stat_statements_max."""
    from .obs.statements import STATEMENTS
    rows = STATEMENTS.snapshot()
    return _typed("sdb_stat_statements", [
        ("queryid", dt.BIGINT), ("query", dt.VARCHAR),
        ("calls", dt.BIGINT), ("total_time_ms", dt.DOUBLE),
        ("mean_time_ms", dt.DOUBLE), ("min_time_ms", dt.DOUBLE),
        ("max_time_ms", dt.DOUBLE), ("p50_time_ms", dt.DOUBLE),
        ("p95_time_ms", dt.DOUBLE), ("p99_time_ms", dt.DOUBLE),
        ("rows", dt.BIGINT),
        ("morsels_pruned", dt.BIGINT), ("cache_hits", dt.BIGINT),
        ("peak_mem_bytes", dt.BIGINT),
        ("last_peak_mem_bytes", dt.BIGINT)], {
        "queryid": [e["queryid"] for e in rows],
        "query": [e["query"] for e in rows],
        "calls": [e["calls"] for e in rows],
        "total_time_ms": [round(e["total_ms"], 6) for e in rows],
        "mean_time_ms": [round(e["total_ms"] / e["calls"], 6)
                         for e in rows],
        "min_time_ms": [round(e["min_ms"], 6) for e in rows],
        "max_time_ms": [round(e["max_ms"], 6) for e in rows],
        "p50_time_ms": [e.get("p50_ms", 0.0) for e in rows],
        "p95_time_ms": [e.get("p95_ms", 0.0) for e in rows],
        "p99_time_ms": [e.get("p99_ms", 0.0) for e in rows],
        "rows": [e["rows"] for e in rows],
        "morsels_pruned": [e["morsels_pruned"] for e in rows],
        "cache_hits": [e.get("cache_hits", 0) for e in rows],
        # max / most-recent accounted peak bytes across this
        # fingerprint's calls (0 when serene_mem_account was off)
        "peak_mem_bytes": [e.get("peak_mem_bytes", 0) for e in rows],
        "last_peak_mem_bytes": [e.get("last_peak_mem_bytes", 0)
                                for e in rows]})


def trace_table(args: list) -> TableProvider:
    """sdb_trace: the flight recorder as a relation. With no argument,
    one row per recorded query timeline (newest last — the listing to
    find a trace id). With a trace id argument, one row per span of
    that timeline, begin-ordered; unknown ids yield an empty relation
    (the entry may have aged out of the ring)."""
    import json as _json

    from .obs.trace import FLIGHT
    if not args or args[0] is None:
        entries = FLIGHT.snapshot()
        return _typed("sdb_trace", [
            ("trace_id", dt.BIGINT), ("query", dt.VARCHAR),
            ("duration_ms", dt.DOUBLE), ("spans", dt.BIGINT),
            ("spans_dropped", dt.BIGINT), ("peak_bytes", dt.BIGINT),
            ("error", dt.VARCHAR)], {
            "trace_id": [e["trace_id"] for e in entries],
            "query": [e["query"] for e in entries],
            "duration_ms": [round(e["duration_ns"] / 1e6, 3)
                            for e in entries],
            "spans": [len(e["spans"]) for e in entries],
            "spans_dropped": [e["spans_dropped"] for e in entries],
            # accounted peak memory of the statement (NULL when
            # serene_mem_account was off for it) — a memory-heavy
            # query is findable in the recorder after the fact
            "peak_bytes": [e.get("peak_bytes") for e in entries],
            "error": [e["error"] or "" for e in entries]})
    try:
        tid = int(args[0])
    except (TypeError, ValueError):
        raise errors.SqlError(errors.INVALID_TEXT_REPRESENTATION,
                              "sdb_trace(id) requires an integer trace id")
    entry = FLIGHT.get(tid)
    spans = entry["spans"] if entry is not None else []
    return _typed("sdb_trace", [
        ("trace_id", dt.BIGINT), ("span", dt.VARCHAR),
        ("category", dt.VARCHAR), ("thread", dt.VARCHAR),
        ("begin_ms", dt.DOUBLE), ("end_ms", dt.DOUBLE),
        ("duration_ms", dt.DOUBLE), ("detail", dt.VARCHAR)], {
        "trace_id": [tid] * len(spans),
        "span": [s["name"] for s in spans],
        "category": [s["cat"] for s in spans],
        "thread": [str(s["thread"]) for s in spans],
        "begin_ms": [round(s["begin_ns"] / 1e6, 4) for s in spans],
        "end_ms": [round(s["end_ns"] / 1e6, 4) for s in spans],
        "duration_ms": [round((s["end_ns"] - s["begin_ns"]) / 1e6, 4)
                        for s in spans],
        "detail": [_json.dumps(s["args"]) if s["args"] else ""
                   for s in spans]})


def query_progress_table() -> TableProvider:
    """sdb_query_progress: one row per RUNNING statement — its current
    operator, morsels scheduled/completed, rows and bytes processed so
    far, live/peak accounted bytes and elapsed time (the
    pg_stat_progress_* analog for query execution, fed live from the
    obs/resources ACTIVE registry; requires serene_mem_account). The
    statement reading this view is itself running, so it appears in
    its own output (PG pg_stat_activity semantics)."""
    from .obs.resources import ACTIVE
    rows = ACTIVE.snapshot()
    return _typed("sdb_query_progress", [
        ("pid", dt.INT), ("query_id", dt.BIGINT), ("query", dt.VARCHAR),
        ("operator", dt.VARCHAR), ("morsels_scheduled", dt.BIGINT),
        ("morsels_done", dt.BIGINT), ("rows", dt.BIGINT),
        ("bytes", dt.BIGINT), ("live_bytes", dt.BIGINT),
        ("peak_bytes", dt.BIGINT), ("elapsed_ms", dt.DOUBLE)], {
        "pid": [r["pid"] for r in rows],
        "query_id": [r["query_id"] for r in rows],
        "query": [r["query"] for r in rows],
        "operator": [r["operator"] for r in rows],
        "morsels_scheduled": [r["morsels_scheduled"] for r in rows],
        "morsels_done": [r["morsels_done"] for r in rows],
        "rows": [r["rows"] for r in rows],
        "bytes": [r["bytes"] for r in rows],
        "live_bytes": [r["live_bytes"] for r in rows],
        "peak_bytes": [r["peak_bytes"] for r in rows],
        "elapsed_ms": [r["elapsed_ms"] for r in rows]})


def admission_table() -> TableProvider:
    """sdb_admission: the workload governor's one-row live view —
    statements running vs queued against the configured limits plus
    cumulative admission totals (sched/governor.py). An sdb_* relation
    on purpose: reads of it are admission-EXEMPT, so an operator can
    inspect a saturated governor without queueing behind it."""
    from .sched.governor import GOVERNOR
    s = GOVERNOR.snapshot()
    return _typed("sdb_admission", [
        ("running", dt.BIGINT), ("queued", dt.BIGINT),
        ("max_concurrent_statements", dt.BIGINT),
        ("queue_depth", dt.BIGINT), ("queued_total", dt.BIGINT),
        ("rejected_total", dt.BIGINT), ("wait_ns_total", dt.BIGINT),
        ("preemptions_total", dt.BIGINT)], {
        "running": [s["running"]], "queued": [s["queued"]],
        "max_concurrent_statements": [s["max_concurrent_statements"]],
        "queue_depth": [s["queue_depth"]],
        "queued_total": [s["queued_total"]],
        "rejected_total": [s["rejected_total"]],
        "wait_ns_total": [s["wait_ns_total"]],
        "preemptions_total": [s["preemptions_total"]]})


def connections_table() -> TableProvider:
    """sdb_connections: one row per open front-door socket — the
    pg_stat_activity analog for the SOCKET layer (sched/governor.py
    ConnectionGate). pid is a process-unique virtual backend id,
    protocol the frontend (pg | http), state the coarse machine
    (active ⇄ idle), idle_s the seconds since the last byte arrived
    on an idle connection. An sdb_* relation on purpose: reads are
    admission-exempt, so an operator can inspect a saturated front
    door without queueing behind it."""
    from .sched.governor import CONNGATE
    rows = CONNGATE.rows()
    return _typed("sdb_connections", [
        ("pid", dt.BIGINT), ("protocol", dt.VARCHAR),
        ("state", dt.VARCHAR), ("idle_s", dt.DOUBLE),
        ("peer", dt.VARCHAR), ("connected_s", dt.DOUBLE),
        ("buffered_bytes", dt.BIGINT)], {
        "pid": [r["pid"] for r in rows],
        "protocol": [r["protocol"] for r in rows],
        "state": [r["state"] for r in rows],
        "idle_s": [r["idle_s"] for r in rows],
        "peer": [r["peer"] for r in rows],
        "connected_s": [r["connected_s"] for r in rows],
        "buffered_bytes": [r["buffered_bytes"] for r in rows]})


def metrics_table() -> TableProvider:
    from .obs.resources import sample_process_gauges
    sample_process_gauges()
    gs = _metrics.REGISTRY.all()
    return MemTable("sdb_metrics", Batch.from_pydict({
        "metric": [g.name for g in gs],
        "value": [g.value for g in gs],
        "description": [g.description for g in gs],
    }))


def log_table() -> TableProvider:
    recs = _log.MANAGER.records()
    return MemTable("sdb_log", Batch.from_pydict({
        "ts": [r.ts for r in recs],
        "level": [r.level.name for r in recs],
        "topic": [r.topic for r in recs],
        "message": [r.message for r in recs],
    }))
