"""Copied from serenedb_tpu/engine.py (Database takes a device, which its
boot and maintenance passes build on; catalog ASTs pickle through
storage.store so a data directory crosses between the packages).

Engine facade: Database (catalog of tables) + Connection (session).

Reference analog: the serened process + per-socket session driving one
DuckDB connection (SURVEY.md §3.2). Here a Database owns the table
namespace; Connections carry session settings and execute statements.
The storage/catalog layers (WAL-backed search tables, versioned snapshots,
RBAC) progressively replace the in-memory structures in this module.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

import numpy as np

from . import errors
from .columnar import dtypes as dt
from .columnar.column import Batch, Column, concat_batches
from .device import DeviceLike, resolve_device
from .exec.plan import ExecContext, PlanNode
from .exec.tables import MemTable, ParquetTable, TableProvider
from .sql import ast, parser
from .sql.binder import ExprBinder, Scope, ScopeColumn, cast_column
from .sql.planner import Planner, TableResolver
from .utils import faults, log, metrics
from .utils.config import SessionSettings


# current connection for context-dependent functions (nextval/currval —
# the reference threads ClientContext through DuckDB function binding)
CURRENT_CONNECTION: contextvars.ContextVar = contextvars.ContextVar(
    "serene_current_connection", default=None)


@dataclass
class QueryResult:
    """One statement's result: rows (maybe empty) + a PG command tag."""
    batch: Batch
    command_tag: str

    @property
    def names(self) -> list[str]:
        return self.batch.names

    def rows(self) -> list[tuple]:
        return self.batch.rows()

    def scalar(self):
        rs = self.rows()
        return rs[0][0] if rs else None


#: statement types the timeline tracer skips: pure session bookkeeping
#: with no execution work — recording their empty timelines would churn
#: the bounded flight recorder (obs/trace.FLIGHT) out of the slow-query
#: entries it exists to preserve
_UNTRACED_STATEMENTS = (ast.SetStmt, ast.ShowStmt, ast.SetRole,
                        ast.Transaction, ast.ListenStmt, ast.NotifyStmt)


def _result_rows(res: "QueryResult") -> int:
    """Rows a statement produced/affected, for statement stats: result
    rows when any came back, else the count off the PG command tag
    ('INSERT 0 5' → 5, 'DELETE 3' → 3, 'SET' → 0)."""
    n = res.batch.num_rows
    if n:
        return n
    parts = res.command_tag.split()
    return int(parts[-1]) if parts and parts[-1].isdigit() else 0


@dataclass
class ViewDef:
    name: str
    query: ast.Select
    sql: str


def _view_references(node, schema: str, table_key: str,
                     depth: int = 0) -> bool:
    """Does a view's AST reference relation (schema, name)? Unqualified
    references resolve to schema "main" (the engine's _split rule), so a
    view over s1.dup never blocks dropping s2.dup. Generic dataclass
    walk."""
    import dataclasses
    if depth > 200 or node is None:
        return False
    if isinstance(node, ast.NamedTable):
        parts = node.parts
        ref_schema = parts[-2].lower() if len(parts) >= 2 else "main"
        return (parts[-1].lower() == table_key and
                ref_schema == schema.lower())
    if isinstance(node, (list, tuple)):
        return any(_view_references(v, schema, table_key, depth + 1)
                   for v in node)
    if isinstance(node, dict):
        return any(_view_references(v, schema, table_key, depth + 1)
                   for v in node.values())
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return any(_view_references(getattr(node, f.name), schema,
                                    table_key, depth + 1)
                   for f in dataclasses.fields(node))
    return False


class SchemaObj:
    def __init__(self, name: str):
        self.name = name
        self.tables: dict[str, TableProvider] = {}
        self.views: dict[str, ViewDef] = {}


class StoredTable(MemTable):
    """A durable columnar table: in-memory working set + WAL write-through +
    parquet checkpoint snapshots (reference analog: a Search-engine table's
    columnstore + SearchDbWal leg, SURVEY.md §2.6)."""

    def __init__(self, name: str, batch: Batch, key: str, table_id: int):
        super().__init__(name, batch)
        self.key = key
        self.table_id = table_id


class Database(TableResolver):
    """The process-wide database: schema → tables/views. Thread-safe for
    DDL/DML via a coarse lock (fine-grained MVCC comes with the catalog
    layer). With `path`, all DDL/DML is durable: definitions in
    catalog.json, data as parquet snapshots + WAL delta (storage/)."""

    #: sequence counters persist in batches of this many values — a crash
    #: skips at most one batch, never repeats (reference: batched counter
    #: persistence, server/catalog/sequence.cpp)
    SEQ_BATCH = 32

    def __init__(self, path: Optional[str] = None,
                 device: DeviceLike = None):
        self.path = path
        #: where the device tier runs: `cuda:0` unless the caller asks for
        #: the CPU (the plain versions of the kernels); every ExecContext
        #: this database's connections create carries it
        self.device = resolve_device(device)
        #: guards the CATALOG (schemas/tables/views dicts), the session
        #: registry and LISTEN/NOTIFY wiring — NOT data-plane execution.
        #: Table data is guarded per-table: writers serialize on
        #: MemTable.write_lock, readers pin the atomic (batch, version,
        #: epoch) publication without any lock, so concurrent SELECTs and
        #: DML on different tables never contend process-wide (reference:
        #: morsel-parallel execution, server_engine.cpp:225-244).
        self.lock = threading.RLock()
        self.schemas: dict[str, SchemaObj] = {"main": SchemaObj("main")}
        self.sequences: dict[str, dict] = {}
        #: user-defined types: name -> {"kind": "enum"|"domain",
        #: "labels": [...], "base": str} (reference: catalog UserType,
        #: server/catalog/object.h:82-94)
        self.types: dict[str, dict] = {}
        # parquet providers are cached by path so repeated queries reuse the
        # provider's HBM column cache and compiled XLA programs
        self._parquet_cache: dict[str, ParquetTable] = {}
        from .auth import Roles
        self.roles = Roles()
        #: dictionaries registered by THIS database; released on close so
        #: process-global analyzer state never leaks across Databases
        self._tsdict_names: set[str] = set()
        # live sessions for pg_stat_activity (id → info dict); entries
        # are removed by Connection.close()/finalizer
        self.sessions: dict[int, dict] = {}
        self._session_seq = 0
        # LISTEN/NOTIFY bus: channel → {Connection}; notifications land in
        # each listener's thread-safe deque and drain at statement
        # boundaries (pgwire sends NotificationResponse before ready)
        self._listeners: dict[str, set] = {}
        # stable in-process OIDs for pg_catalog introspection: assigned
        # lazily per (kind, schema, name), never reused within a process
        # (reference: catalog object ids, server/pg/pg_catalog/)
        self._oids: dict[tuple, int] = {}
        self._oid_rev: dict[int, tuple] = {}
        self._oid_next = 16384
        self.store = None
        self.maintenance = None
        if path is not None:
            from .storage.store import Store
            self.store = Store(path)
            from .device import building_on
            with building_on(self.device):
                self._boot()
            from .storage.maintenance import MaintenanceManager
            self.maintenance = MaintenanceManager(self)
            self.maintenance.start()

    @contextlib.contextmanager
    def quiesced(self, tables):
        """Exclusive writer section over `tables` with fast-path inserts
        drained: raises the quiesce gate on EVERY table first (so an
        insert cannot slip onto an already-drained table while a later one
        is still draining), waits each table's in-flight publishes out
        holding only THAT table's lock (a publisher needs its table's
        write_lock — waiting while holding another table's lock would
        deadlock), then acquires every write_lock in a global order. On
        exit, locks release and gates lower. Mutating ops and checkpoint
        capture run inside this so a committed-but-unpublished insert can
        never order between a commit's WAL tick and its publish (which
        would make live state diverge from replayed state)."""
        tables = sorted(set(tables), key=id)
        for t in tables:
            with t.write_lock:
                t._quiesce_waiters = getattr(t, "_quiesce_waiters", 0) + 1
        try:
            for t in tables:
                with t.write_lock:
                    while getattr(t, "_inflight", 0):
                        t.pub_cond.wait(timeout=5)
            with contextlib.ExitStack() as stack:
                for t in tables:
                    stack.enter_context(t.write_lock)
                yield
        finally:
            for t in tables:
                with t.write_lock:
                    t._quiesce_waiters -= 1
                    t.pub_cond.notify_all()

    def crash(self):
        """Abandon this Database as if the process was killed: stop loops
        without any further checkpoint/refresh pass, release the datadir
        lock, write nothing else. Recovery harnesses reopen the datadir
        afterwards (reference: recovery tests kill serened and restart,
        tests/sqllogic/recovery/)."""
        self._crashed = True
        if self.maintenance is not None:
            self.maintenance.stop()
        if self.store is not None:
            import os
            try:
                os.remove(self.store._lockfile)
            except OSError:
                pass
        from .search.analysis import drop_dictionary
        for name in self._tsdict_names:
            drop_dictionary(name)
        self._tsdict_names.clear()

    def close(self):
        if self.maintenance is not None:
            self.maintenance.stop()
        if self.store is not None:
            # clean shutdown persists exact sequence counters so a restart
            # continues without a gap (PG semantics); only a crash skips
            # ahead to the batched high-water mark
            with self.lock:
                dirty = False
                for seq in self.sequences.values():
                    if seq["hwm"] != seq["value"]:
                        seq["hwm"] = seq["value"]
                        dirty = True
                if dirty:
                    self._persist_sequences()
            self.store.release()
        from .search.analysis import drop_dictionary
        for name in self._tsdict_names:
            drop_dictionary(name)
        self._tsdict_names.clear()

    # -- boot / recovery ---------------------------------------------------

    def _boot(self):
        """Load definitions, table snapshots, then WAL delta replay
        (reference startup order: store → catalog → search recovery,
        serened.cpp:133-150)."""
        from .sql import parser as _parser
        meta = self.store.load_meta()
        for s in meta.get("schemas", ["main"]):
            self.schemas.setdefault(s, SchemaObj(s))
        for key, tdef in meta.get("tables", {}).items():
            schema, name = key.split(".", 1)
            names = [c["name"] for c in tdef["columns"]]
            types = [dt.type_from_name(c["type"]) for c in tdef["columns"]]
            batch = self.store.read_snapshot(tdef["id"], names, types)
            t = StoredTable(name, batch, key, tdef["id"])
            from .storage.store import loads_ast
            t.table_meta = {
                "engine": tdef.get("engine", "columnar"),
                "primary_key": tdef.get("primary_key", []),
                "not_null": tdef.get("not_null", []),
                "defaults": {n: loads_ast(b)
                             for n, b in
                             (tdef.get("defaults") or {}).items()},
                "tokenizers": tdef.get("tokenizers", {}),
                "enums": tdef.get("enums", {}),
                "options": tdef.get("options", {}),
            }
            self.schemas[schema].tables[name.lower()] = t
        for key, vdef in meta.get("views", {}).items():
            schema, name = key.split(".", 1)
            from .storage.store import loads_ast
            q = loads_ast(vdef["ast_b64"])
            self.schemas[schema].views[name.lower()] = ViewDef(name, q, "")

        self.types = dict(meta.get("types", {}))
        self.roles.load_meta(meta.get("auth", {}))
        from .search.analysis import register_dictionary
        for dname, dopts in meta.get("tsdicts", {}).items():
            register_dictionary(dname, dopts, replace=True)
            self._tsdict_names.add(dname.lower())
        for name, sdef in meta.get("sequences", {}).items():
            # resume at the persisted high-water mark: crash skips at most
            # one batch of values, never repeats
            self.sequences[name] = {"value": sdef["hwm"],
                                    "increment": sdef["increment"],
                                    "start": sdef["start"],
                                    "hwm": sdef["hwm"]}

        def committed_of(key: str) -> int:
            tdef = meta.get("tables", {}).get(key)
            if tdef is None:
                return 1 << 62  # dropped table: skip its records
            return tdef.get("checkpoint_tick", 0)

        max_tick = self.store.wal.recover(committed_of, self._apply_wal_op)
        # checkpoint cursors can be ahead of every surviving WAL record
        # (post-GC); ticks must never restart below them or fresh commits
        # would be skipped by a later delta replay
        cursor_ticks = [t.get("checkpoint_tick", 0)
                        for t in meta.get("tables", {}).values()]
        self.store.ticks.advance_to(max(max_tick, *cursor_ticks)
                                    if cursor_ticks else max_tick)
        # rebuild persisted index definitions (backfill from recovered data)
        from .search.index import build_index_for_table
        for idx_name, idef in meta.get("indexes", {}).items():
            t = self._table_by_key(idef["table"])
            if t is None:
                continue
            if not hasattr(t, "indexes"):
                t.indexes = {}
            try:
                t.indexes[idx_name] = build_index_for_table(
                    t, idef["columns"], idef["using"], idef["options"])
            except errors.SqlError:
                log.warn("boot", f"index {idx_name} rebuild failed")

    # -- sequences ---------------------------------------------------------

    def _seq_key(self, name: str) -> str:
        """Sequences are schema-scoped like tables: bare names live in
        main, qualified names ('s2.seq') are used verbatim."""
        return name if "." in name else f"main.{name}"

    def create_sequence(self, name: str, start: int, increment: int,
                        if_not_exists: bool):
        name = self._seq_key(name)
        with self.lock:
            if name in self.sequences:
                if if_not_exists:
                    return
                raise errors.SqlError(errors.DUPLICATE_OBJECT,
                                      f'sequence "{name}" already exists')
            self.sequences[name] = {"value": start - increment,
                                    "increment": increment, "start": start,
                                    "hwm": start - increment}
            self._persist_sequences()

    def drop_sequence(self, name: str, if_exists: bool):
        name = self._seq_key(name)
        with self.lock:
            if name not in self.sequences:
                if if_exists:
                    return
                raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                      f'sequence "{name}" does not exist')
            del self.sequences[name]
            self._persist_sequences()

    def sequence_nextval(self, name: str) -> int:
        name = self._seq_key(name)
        with self.lock:
            seq = self.sequences.get(name)
            if seq is None:
                raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                      f'sequence "{name}" does not exist')
            seq["value"] += seq["increment"]
            if (seq["increment"] > 0 and seq["value"] > seq["hwm"]) or \
                    (seq["increment"] < 0 and seq["value"] < seq["hwm"]):
                seq["hwm"] = seq["value"] + seq["increment"] * self.SEQ_BATCH
                self._persist_sequences()
            return seq["value"]

    def sequence_setval(self, name: str, value: int) -> int:
        name = self._seq_key(name)
        with self.lock:
            seq = self.sequences.get(name)
            if seq is None:
                raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                      f'sequence "{name}" does not exist')
            seq["value"] = value
            seq["hwm"] = value
            self._persist_sequences()
            return value

    def _persist_sequences(self):
        if self.store is None:
            return
        snap = {n: {"hwm": s["hwm"], "increment": s["increment"],
                    "start": s["start"]}
                for n, s in self.sequences.items()}
        self.store.update_meta(
            lambda m: m.__setitem__("sequences", snap))

    def _table_by_key(self, key: str):
        schema, name = key.split(".", 1)
        s = self.schemas.get(schema)
        return s.tables.get(name.lower()) if s else None

    def _apply_wal_op(self, tick: int, op) -> None:
        t = self._table_by_key(op.table)
        if t is None:
            return
        batch = op.batch
        if batch is not None:
            # arrow WAL serde can't carry logical types the physical
            # layout doesn't (ARRAY/RECORD ride as text payloads,
            # INTERVAL as int64 micros) — re-stamp from the catalog
            # schema so replayed appends don't degrade column types
            for name, ct in zip(t.column_names, t.column_types):
                if name in batch and batch.column(name).type != ct and \
                        ct.id in (dt.TypeId.ARRAY, dt.TypeId.RECORD,
                                  dt.TypeId.INTERVAL, dt.TypeId.OID,
                                  dt.TypeId.REGCLASS, dt.TypeId.REGTYPE,
                                  dt.TypeId.REGPROC,
                                  dt.TypeId.REGNAMESPACE):
                    batch.column(name).type = ct
        _apply_ops(t, [(op.kind, batch, op.rows)])

    def _persist_catalog(self):
        if self.store is not None:
            self.store.save_meta()

    # -- resolution (TableResolver) ---------------------------------------

    def _split(self, parts: list[str]) -> tuple[str, str]:
        if len(parts) == 1:
            return "main", parts[0]
        if len(parts) == 2:
            return parts[0], parts[1]
        # database.schema.table — single-database process, ignore the first
        return parts[-2], parts[-1]

    def _acl_check(self, schema: str, name: str, privilege: str = "select"):
        """ACL applies to user tables only; system catalogs stay open
        (reference surfaces introspection to all roles)."""
        conn = CURRENT_CONNECTION.get()
        if conn is not None:
            self.roles.require(conn.current_role,
                               f"{schema}.{name.lower()}", privilege)

    def resolve_table(self, parts: list[str],
                      privilege: str = "select") -> TableProvider:
        schema, name = self._split(parts)
        if schema in ("pg_catalog", "information_schema", "sdb_catalog"):
            from .pgcatalog import system_table
            st = system_table(self, parts)
            if st is not None:
                return st
            raise errors.SqlError(errors.UNDEFINED_TABLE,
                                  f'relation "{".".join(parts)}" does not '
                                  "exist")
        with self.lock:
            s = self.schemas.get(schema)
            if s is None:
                raise errors.SqlError(errors.UNDEFINED_TABLE,
                                      f'schema "{schema}" does not exist')
            t = s.tables.get(name.lower())
        if t is not None:
            self._acl_check(schema, name, privilege)
            return t
        with self.lock:
            v = s.views.get(name.lower())
            if v is not None:
                raise _ViewRef(v)  # unwound by the planner wrapper below
        from .pgcatalog import system_table
        st = system_table(self, parts)
        if st is not None:
            return st
        raise errors.SqlError(errors.UNDEFINED_TABLE,
                              f'relation "{".".join(parts)}" does not exist')

    def resolve_table_function(self, name: str, args: list) -> TableProvider:
        if name in ("read_parquet", "parquet_scan"):
            from .exec.filesource import parquet_source
            pinned = len(args) > 1 and \
                str(args[1]).lower() in ("pinned", "snapshot")
            return parquet_source(self, str(args[0]), pinned=pinned)
        if name in ("read_csv", "read_csv_auto", "csv_scan"):
            from .exec.filesource import csv_source
            header = None
            delim = ","
            if len(args) > 1 and args[1] is not None:
                header = (str(args[1]).lower() in ("true", "t", "1")
                          if not isinstance(args[1], bool) else args[1])
            if len(args) > 2 and args[2] is not None:
                delim = str(args[2])
            return csv_source(self, str(args[0]), header, delim)
        if name == "unnest":
            # set-returning: one row per element; multiple arrays zip with
            # NULL padding (PG: FROM unnest(a, b)); arrays are JSON text
            import json as _json
            lists = []
            for a in args:
                if a is None:
                    lists.append([])
                    continue
                try:
                    elems = _json.loads(str(a))
                except _json.JSONDecodeError:
                    raise errors.SqlError(
                        errors.INVALID_TEXT_REPRESENTATION,
                        f"invalid array literal: {str(a)[:40]!r}")
                if not isinstance(elems, list):
                    raise errors.SqlError(
                        errors.INVALID_TEXT_REPRESENTATION,
                        "unnest expects a JSON array")
                lists.append([
                    _json.dumps(e) if isinstance(e, (list, dict)) else e
                    for e in elems])
            if not lists:
                lists = [[]]
            n = max(len(ls) for ls in lists)
            cols = {}
            for i, ls in enumerate(lists):
                cols["unnest" if i == 0 else f"unnest_{i}"] = \
                    ls + [None] * (n - len(ls))
            return MemTable("unnest", Batch.from_pydict(cols))
        if name == "generate_series":
            # set-returning integer series (PG: generate_series(a, b[, s]))
            if len(args) < 2:
                raise errors.SqlError(
                    "42883", "generate_series requires start and stop")
            if any(a is None for a in args[:3]):
                return MemTable("generate_series", Batch(
                    ["generate_series"],
                    [Column.from_numpy(np.empty(0, dtype=np.int64))]))
            try:
                start, stop = int(args[0]), int(args[1])
                step = int(args[2]) if len(args) > 2 else 1
            except (TypeError, ValueError, OverflowError):
                raise errors.SqlError(
                    errors.INVALID_TEXT_REPRESENTATION,
                    "generate_series arguments must be integers")
            if step == 0:
                raise errors.SqlError(
                    "22023", "step size cannot equal zero")
            n = max(0, (stop - start) // step + 1)
            if n > 50_000_000:
                raise errors.SqlError(
                    "54000", "generate_series result set too large")
            vals = np.arange(start, start + n * step, step, dtype=np.int64)
            return MemTable("generate_series", Batch(
                ["generate_series"], [Column.from_numpy(vals)]))
        if name == "sdb_terms":
            # term-enumeration scan over an inverted index (reference:
            # the TsDict full-scan mode of
            # server/connector/duckdb_search_full_scan.hpp:54-76 — the
            # dictionary itself is a queryable relation)
            if len(args) < 2:
                raise errors.SqlError(
                    "42883", "sdb_terms(table, column) requires a table "
                             "and column name")
            provider = self.resolve_table([str(args[0])])
            col = str(args[1])
            from .search.index import find_index
            idx = find_index(provider, col)
            if idx is None:
                raise errors.SqlError(
                    errors.UNDEFINED_OBJECT,
                    f'no inverted index on "{args[0]}"."{col}"')
            # find_index read-repaired above, so segments carry no
            # deleted docs (mutations rebuild; appends add segments)
            terms: dict[str, int] = {}
            for seg, _base in idx.searchers[col].segments:
                fi = seg.index
                for t, df in zip(fi.terms_str.tolist(),
                                 fi.doc_freq.tolist()):
                    terms[t] = terms.get(t, 0) + int(df)
            items = sorted(terms.items())
            return MemTable("sdb_terms", Batch.from_pydict({
                "term": Column.from_pylist([t for t, _ in items],
                                           dt.VARCHAR),
                "doc_freq": Column.from_pylist([d for _, d in items],
                                               dt.BIGINT),
            }))
        if name == "sdb_log":
            from .pgcatalog import log_table
            return log_table()
        if name == "sdb_metrics":
            from .pgcatalog import metrics_table
            return metrics_table()
        if name == "sdb_stat_statements":
            from .pgcatalog import stat_statements_table
            return stat_statements_table()
        if name == "sdb_cache":
            from .pgcatalog import cache_table
            return cache_table()
        if name == "sdb_trace":
            from .pgcatalog import trace_table
            return trace_table(args)
        if name == "sdb_query_progress":
            from .pgcatalog import query_progress_table
            return query_progress_table()
        if name == "sdb_admission":
            from .pgcatalog import admission_table
            return admission_table()
        if name == "sdb_connections":
            from .pgcatalog import connections_table
            return connections_table()
        if name == "sdb_device":
            from .pgcatalog import device_table
            return device_table()
        if name == "sdb_programs":
            from .pgcatalog import programs_table
            return programs_table()
        if name == "sdb_device_cache":
            from .pgcatalog import device_cache_table
            return device_cache_table()
        if name == "sdb_posting_pool":
            from .pgcatalog import posting_pool_table
            return posting_pool_table()
        raise errors.SqlError(errors.UNDEFINED_FUNCTION,
                              f"table function {name} does not exist")

    # -- DDL ---------------------------------------------------------------

    def create_schema(self, name: str, if_not_exists: bool):
        with self.lock:
            if name in self.schemas:
                if if_not_exists:
                    return
                raise errors.SqlError(errors.DUPLICATE_OBJECT,
                                      f'schema "{name}" already exists')
            self.schemas[name] = SchemaObj(name)

    def create_table(self, schema: str, name: str, provider: TableProvider,
                     if_not_exists: bool):
        with self.lock:
            s = self._schema(schema)
            key = name.lower()
            if key in s.tables or key in s.views:
                if if_not_exists:
                    return False
                raise errors.SqlError(errors.DUPLICATE_TABLE,
                                      f'relation "{name}" already exists')
            s.tables[key] = provider
            return True

    def create_view(self, schema: str, name: str, view: ViewDef,
                    or_replace: bool):
        with self.lock:
            s = self._schema(schema)
            key = name.lower()
            if key in s.tables:
                raise errors.SqlError(errors.DUPLICATE_TABLE,
                                      f'"{name}" is already a table')
            if key in s.views and not or_replace:
                raise errors.SqlError(errors.DUPLICATE_TABLE,
                                      f'relation "{name}" already exists')
            s.views[key] = view

    def drop(self, kind: str, parts: list[str], if_exists: bool,
             cascade: bool):
        schema, name = self._split(parts)
        with self.lock:
            if kind == "schema":
                target = parts[-1]
                if target not in self.schemas:
                    if if_exists:
                        return
                    raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                          f'schema "{target}" does not exist')
                if target == "main":
                    raise errors.SqlError(errors.FEATURE_NOT_SUPPORTED,
                                          "cannot drop schema main")
                if self.schemas[target].tables and not cascade:
                    raise errors.SqlError("2BP01",
                                          f'schema "{target}" is not empty')
                del self.schemas[target]
                return
            s = self._schema(schema, if_exists)
            if s is None:
                return
            key = name.lower()
            if kind == "index":
                from .search.index import _index_lock
                removed = False
                for t in s.tables.values():
                    idxs = getattr(t, "indexes", {})
                    for iname in list(idxs):
                        if iname.lower() == key:
                            with _index_lock(t):
                                idxs.pop(iname, None)
                            removed = True
                if removed or if_exists:
                    return
                raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                      f'index "{name}" does not exist')
            store = s.views if kind == "view" else s.tables
            if kind in ("table", "view") and key in store:
                deps = self._dependent_views(schema, key,
                                             exclude=(schema, key)
                                             if kind == "view" else None)
                if deps and not cascade:
                    dn = deps[0][1]
                    raise errors.SqlError(
                        "2BP01",
                        f'cannot drop {kind} "{name}" because view '
                        f'"{dn}" depends on it')
                for dschema, dname in deps:     # CASCADE: drop dependents
                    self.schemas[dschema].views.pop(dname, None)
            if key not in store:
                if if_exists:
                    return
                raise errors.SqlError(errors.UNDEFINED_TABLE,
                                      f'{kind} "{name}" does not exist')
            del store[key]

    def _dependent_views(self, schema: str, key: str,
                         exclude=None) -> list[tuple[str, str]]:
        """Transitive closure of views depending on relation (schema,
        key) — view-on-view chains included, so CASCADE never dangles a
        second-level view. Caller holds self.lock."""
        out: list[tuple[str, str]] = []
        frontier = [(schema, key)]
        seen = {(schema.lower(), key)}
        while frontier:
            tschema, tkey = frontier.pop()
            for sname2, s2 in self.schemas.items():
                for vname, vdef in s2.views.items():
                    ident = (sname2.lower(), vname)
                    if ident in seen or ident == exclude:
                        continue
                    if _view_references(vdef.query, tschema, tkey):
                        seen.add(ident)
                        out.append((sname2, vname))
                        frontier.append((sname2, vname))
        return out

    def _schema(self, name: str, if_exists_ok: bool = False):
        s = self.schemas.get(name)
        if s is None and not if_exists_ok:
            raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                  f'schema "{name}" does not exist')
        return s

    def table_list(self) -> list[tuple[str, str, str]]:
        with self.lock:
            out = []
            for sname, s in self.schemas.items():
                for t in s.tables:
                    out.append((sname, t, "table"))
                for v in s.views:
                    out.append((sname, v, "view"))
            return sorted(out)

    def catalog_key_of(self, provider) -> Optional[str]:
        """schema.table key when this provider is a user table currently
        registered in the catalog: StoredTable `key` fast path (verified
        against the live catalog — a dropped/replaced table must not
        resolve), else an identity scan. Shared by the transaction
        machinery (Connection._txn_key_of) and the result cache
        (cache/result.py) so provider identity can never diverge
        between them."""
        key = getattr(provider, "key", None)      # StoredTable fast path
        with self.lock:
            if key is not None and self._table_by_key(key) is provider:
                return key
            for sname, sch in self.schemas.items():
                for tname, t in sch.tables.items():
                    if t is provider:
                        return f"{sname}.{tname}"
        return None

    def oid_of(self, kind: str, schema: str, name: str) -> int:
        """Stable per-process OID for a catalog object (lazily assigned).
        kind ∈ {schema, table, view, index, sequence}."""
        key = (kind, schema, name)
        with self.lock:
            oid = self._oids.get(key)
            if oid is None:
                oid = self._oid_next
                self._oid_next += 1
                self._oids[key] = oid
                self._oid_rev[oid] = key
            return oid

    def oid_lookup(self, oid: int):
        """(kind, schema, name) for an OID assigned by oid_of, else None."""
        with self.lock:
            return self._oid_rev.get(int(oid))

    def resolve_relation_oid(self, text: str) -> int:
        """'schema.table' / 'table' → OID, PG ::regclass semantics."""
        parts = [p.strip().strip('"') for p in text.split(".")]
        with self.lock:
            cands = ([(parts[0], parts[1])] if len(parts) == 2
                     else [(sn, parts[0]) for sn in ("main",
                                                     *sorted(self.schemas))])
            for sn, tn in cands:
                s = self.schemas.get(sn)
                if s is None:
                    continue
                tl = tn.lower()
                if tl in s.tables:
                    return self.oid_of("table", sn, tl)
                if tl in s.views:
                    return self.oid_of("view", sn, tl)
                for t in s.tables.values():
                    if tl in getattr(t, "indexes", {}):
                        return self.oid_of("index", sn, tl)
        raise errors.SqlError(errors.UNDEFINED_TABLE,
                              f'relation "{text}" does not exist')

    def resolve_type_name(self, name: str):
        """(SqlType, enum_labels|None) for a declared column/cast type,
        consulting user-defined types (enums store as validated text,
        domains alias their base)."""
        tdef = self.types.get(name.lower())
        if tdef is None:
            try:
                return dt.type_from_name(name), None
            except ValueError:
                raise errors.SqlError(
                    errors.UNDEFINED_OBJECT,
                    f'type "{name}" does not exist')
        if tdef["kind"] == "enum":
            return dt.VARCHAR, list(tdef["labels"])
        # domains may stack over other user types (incl. enums): recurse
        # so the base's physical type AND its labels carry through
        return self.resolve_type_name(tdef["base"])

    def connect(self) -> "Connection":
        return Connection(self)


class _ViewRef(Exception):
    def __init__(self, view: ViewDef):
        self.view = view


class _UpsertScope(Scope):
    """Scope for DO UPDATE SET: unqualified names resolve to the TARGET
    table only (never ambiguous with excluded.*), qualified names see
    both the target alias and `excluded`."""

    def __init__(self, base_cols, exc_cols):
        super().__init__(base_cols + exc_cols)
        self._base = Scope(base_cols)

    def resolve(self, parts):
        if len(parts) == 1:
            return self._base.resolve(parts)
        return super().resolve(parts)


class _ResolverShim(TableResolver):
    """Expands views inline during planning; inside a transaction, reads
    resolve to the connection's pinned snapshot (snapshot isolation)."""

    def __init__(self, db: Database, planner_params, conn=None):
        self.db = db
        self.params = planner_params
        self.conn = conn

    def resolve_table(self, parts: list[str]) -> TableProvider:
        p = self.db.resolve_table(parts)
        if self.conn is not None and self.conn.in_txn:
            return self.conn._txn_read_provider(p)
        return p

    def resolve_table_function(self, name, args):
        return self.db.resolve_table_function(name, args)


class Connection:
    def __init__(self, db: Database, role: str = None):
        from .auth import SUPERUSER
        self.db = db
        self.settings = SessionSettings()
        self.in_txn = False
        self.txn_failed = False
        # snapshot-isolation state: pinned read snapshots + buffered writes
        # (key → {"real", "work", "version", "ops"}), live only in a txn
        self._txn_pins: dict[str, MemTable] = {}
        self._txn_writes: dict[str, dict] = {}
        self._txn_savepoints: list[tuple] = []   # (name, {key: ops_len}, actions_len)
        from collections import deque
        self._listen_channels: set[str] = set()
        #: bounded: a never-draining idle listener must not grow without
        #: limit (oldest notifications drop past the cap)
        self._notifications = deque(maxlen=8192)
        #: set by the wire session to wake an idle client (thread-safe)
        self.notify_hook = None
        #: mid-query cancel: set from ANY thread (CancelRequest socket),
        #: polled cooperatively at executor batch boundaries
        self._cancel_event = threading.Event()
        #: LISTEN/UNLISTEN/NOTIFY deferred to COMMIT inside a txn (PG
        #: queues them transactionally; ROLLBACK discards)
        self._txn_actions: list[tuple] = []
        #: authenticated identity — SET ROLE can never escalate beyond it
        self.session_role = (role or SUPERUSER).lower()
        self.current_role = self.session_role
        #: set by the result cache when the CURRENT statement was served
        #: without executing (cache/result.py); read by the statement-end
        #: observability hook for sdb_stat_statements cache_hits
        self._cache_hit = False
        #: set by _plan when view inlining ran: view identity is not in
        #: the result-cache key, so such statements never cache
        self._plan_inlined_views = False
        #: last executed plan + its span profile (serene_profile on):
        #: read by the statement-end observability hook for the
        #: slow-query log's annotated tree. Best effort — a suspended
        #: streaming portal interleaved with another statement may
        #: overwrite it; the stats/stat_statements path never depends
        #: on it.
        self._active_profile = None
        self._active_plan = None
        #: the executing statement's timeline trace (serene_trace on);
        #: finalized into the flight recorder at statement end
        self._active_trace = None
        #: the executing statement's memory accountant
        #: (serene_mem_account on; obs/resources.py) — read by the
        #: statement-end observability hook for peak-bytes attribution
        self._active_mem = None
        #: workload governor state (sched/governor.py): admission slots
        #: this connection currently holds (nested statements on a
        #: slot-holding connection bypass admission — a session cannot
        #: deadlock itself), the executing statement's enforced
        #: serene_work_mem ceiling in bytes (0 = unlimited), and its
        #: fair-share scheduling identity (tag, serene_priority weight)
        #: read by the worker pool at task-submit time
        self._admission_held = 0
        self._work_mem_limit = 0
        self._sched = None
        import weakref
        with db.lock:
            db._session_seq += 1
            self._session_id = db._session_seq
            db.sessions[self._session_id] = {
                "pid": self._session_id, "usename": self.session_role,
                "application_name": "", "state": "idle", "query": "",
                "backend_start": time.time(), "query_start": None,
                "wait_event_type": None, "wait_event": None}
        weakref.finalize(self, db.sessions.pop, self._session_id, None)

    # -- public API --------------------------------------------------------

    def execute(self, sql: str, params: Optional[list] = None) -> QueryResult:
        results = self.execute_all(sql, params)
        return results[-1] if results else QueryResult(Batch([], []), "")

    def execute_all(self, sql: str,
                    params: Optional[list] = None) -> list[QueryResult]:
        stmts = parser.parse(sql)  # cached copy-on-read in the parser
        out = []
        for st in stmts:
            out.append(self.execute_statement(st, params or [],
                                              sql_text=sql))
        return out

    def execute_streaming(self, st: ast.Statement, params: Optional[list] = None,
                          sql_text: Optional[str] = None):
        """Streaming SELECT execution: (names, types, batch iterator).

        The iterator yields result batches as the executor produces them,
        so the wire session can encode and flush incrementally — bounding
        session memory and time-to-first-row instead of materializing the
        whole result before the first DataRow (reference: the wire
        collector streams rows to the socket DURING execution,
        server/network/pg/wire_collector.h:20-60).

        Only Select/SetOp are streamable; anything else raises ValueError
        (callers route other statements through execute_statement)."""
        if not isinstance(st, (ast.Select, ast.SetOp)):
            raise ValueError("execute_streaming handles SELECT only")
        if self.txn_failed:
            raise errors.SqlError(
                errors.IN_FAILED_TRANSACTION,
                "current transaction is aborted, commands ignored until "
                "end of transaction block")
        params = params or []
        import time as _time
        self.stmt_now_us = int(_time.time() * 1e6)  # now() stability
        from .cache.result import RESULT_CACHE
        self._cache_hit = False
        probe = RESULT_CACHE.begin(self, st, params, sql_text)
        token = CURRENT_CONNECTION.set(self)
        try:
            hit = probe.fast_lookup() if probe is not None else None
            if hit is None:
                plan = self._plan(st, params)  # binding enforces ACLs here
                if probe is not None:
                    probe.prepare(plan)
                    hit = probe.lookup()
        finally:
            CURRENT_CONNECTION.reset(token)
        if hit is not None:
            def run_hit(b=hit):
                t0 = time.perf_counter_ns()
                with self._session_scope(sql_text if sql_text is not None
                                         else "SELECT"):
                    yield b
                    # re-pin the hit flag at drain time: a statement
                    # interleaved with this suspended portal may have
                    # overwritten the connection-level attribution
                    self._cache_hit = True
                    self._obs_record(sql_text, t0, b.num_rows, None, None)
            return (hit.names, [c.type for c in hit.columns], run_hit())
        # streaming memory accounting: the accountant is created here
        # (so the plan's operator wrappers see it on the context) but —
        # like the trace — its contextvar pins per generator step, and
        # its ACTIVE progress row registers at first resume and retires
        # on every exit path
        from .obs.resources import MemoryAccountant
        acct = MemoryAccountant(sql_text or "SELECT",
                                pid=self._session_id) \
            if self._mem_enabled() else None
        self._active_mem = acct
        ctx = self._exec_ctx(params)
        # a cacheable streaming statement accumulates its batches for a
        # post-drain store — bounded: accumulation stops past the cache
        # byte cap, exactly the point where the store would refuse it
        store_cap = (int(self.settings._registry.get_global(
            "serene_result_cache_mb")) << 20) \
            if probe is not None and probe.cacheable else -1

        def run():
            from .cache.result import _batch_nbytes
            from .obs.resources import ACTIVE, CURRENT_MEM
            from .obs.trace import CURRENT_TRACE, FLIGHT, QueryTrace
            t0 = time.perf_counter_ns()
            nrows = 0
            acc: Optional[list] = [] if store_cap >= 0 else None
            acc_bytes = 0
            # streaming trace: the generator resumes on arbitrary
            # threads, so the trace pins CURRENT_TRACE around every
            # step (same-thread set/reset pairs) instead of holding one
            # token across suspensions
            trace = QueryTrace(sql_text or "SELECT") \
                if self._trace_enabled() else None
            if acct is not None:
                ACTIVE.register(acct)
            with self._session_scope(sql_text if sql_text is not None
                                     else "SELECT"):
                from .sched.governor import GOVERNOR, admission_exempt
                ticket = None
                try:
                    # admission gates the first step, not portal OPEN:
                    # the slot is taken when execution actually starts
                    # and held until the portal drains or drops
                    if GOVERNOR.enabled() and not admission_exempt(st):
                        ticket = GOVERNOR.admit(self, sql_text or "SELECT",
                                                trace)
                    it = plan.batches(ctx)
                    while True:
                        # the caller may resume this generator from any
                        # worker thread: pin the connection contextvar
                        # around every underlying step (scalar functions
                        # read it), and the trace + accountant
                        # contextvars with it
                        tok = CURRENT_CONNECTION.set(self)
                        tok_tr = CURRENT_TRACE.set(trace) \
                            if trace is not None else None
                        tok_mem = CURRENT_MEM.set(acct) \
                            if acct is not None else None
                        try:
                            b = next(it)
                        except StopIteration:
                            if acc is not None:
                                out = concat_batches(acc) if acc else \
                                    Batch(list(plan.names),
                                          [Column.from_pylist([], t)
                                           for t in plan.types])
                                probe.store(out)
                            # this generator IS the miss path — re-pin
                            # the flag in case an interleaved statement
                            # on this connection flipped it while we
                            # were suspended
                            self._cache_hit = False
                            entry = None
                            if trace is not None:
                                entry = trace.finish()
                                if acct is not None:
                                    entry["peak_bytes"] = \
                                        acct.totals()[1]
                                entry = FLIGHT.record(entry)
                            trace = None
                            ACTIVE.retire(acct)
                            self._obs_record(sql_text, t0, nrows,
                                             ctx.profile, plan, entry,
                                             mem=acct)
                            return
                        finally:
                            if tok_mem is not None:
                                CURRENT_MEM.reset(tok_mem)
                            if tok_tr is not None:
                                CURRENT_TRACE.reset(tok_tr)
                            CURRENT_CONNECTION.reset(tok)
                        nrows += b.num_rows
                        if acc is not None:
                            acc_bytes += _batch_nbytes(b)
                            if acc_bytes > store_cap:
                                acc = None
                            else:
                                acc.append(b)
                        yield b
                except BaseException as e:  # noqa: BLE001 — re-raised
                    # error/early-close paths (incl. GeneratorExit from
                    # a dropped portal) still dump the timeline and
                    # retire the progress row
                    ACTIVE.retire(acct)
                    if trace is not None:
                        entry = trace.finish(
                            error=f"{type(e).__name__}: {e}")
                        if acct is not None:
                            entry["peak_bytes"] = acct.totals()[1]
                        FLIGHT.record(entry)
                    raise
                finally:
                    # slot returns on EVERY exit: drained, errored, or
                    # a dropped portal's GeneratorExit
                    GOVERNOR.release(ticket)

        return plan.names, plan.types, run()

    def close(self):
        """Deterministically retire this session from pg_stat_activity
        (the weakref finalizer is only the GC backstop)."""
        self.db.sessions.pop(self._session_id, None)
        with self.db.lock:
            for ch in list(self._listen_channels):
                lst = self.db._listeners.get(ch)
                if lst is not None:
                    lst.discard(self)
                    if not lst:
                        del self.db._listeners[ch]
        self._listen_channels.clear()

    def _apply_listen(self, action: str, channel: str):
        with self.db.lock:
            if action == "listen":
                self._listen_channels.add(channel)
                self.db._listeners.setdefault(channel, set()).add(self)
                return
            chans = [channel] if action == "unlisten" \
                else list(self._listen_channels)
            for ch in chans:
                self._listen_channels.discard(ch)
                lst = self.db._listeners.get(ch)
                if lst is not None:
                    lst.discard(self)
                    if not lst:
                        del self.db._listeners[ch]   # no channel-name leak

    def _apply_notify(self, channel: str, payload: str):
        with self.db.lock:
            targets = list(self.db._listeners.get(channel, ()))
        for conn in targets:
            conn._notifications.append((self._session_id, channel, payload))
            hook = conn.notify_hook
            if hook is not None:
                try:
                    hook()
                except Exception:
                    pass

    def take_notifications(self) -> list[tuple]:
        """Drain pending (sender_pid, channel, payload) notifications."""
        out = []
        while self._notifications:
            out.append(self._notifications.popleft())
        return out

    def execute_statement(self, st: ast.Statement, params: list,
                          sql_text: Optional[str] = None) -> QueryResult:
        if self.txn_failed and not isinstance(st, ast.Transaction):
            raise errors.SqlError(
                errors.IN_FAILED_TRANSACTION,
                "current transaction is aborted, commands ignored until "
                "end of transaction block")
        token = CURRENT_CONNECTION.set(self)
        import time as _time
        # PG: now()/current_timestamp are statement-stable — every call
        # within one statement sees this timestamp
        self.stmt_now_us = int(_time.time() * 1e6)
        try:
            with self._session_scope(sql_text if sql_text is not None
                                     else type(st).__name__):
                self._active_profile = None
                self._active_plan = None
                self._cache_hit = False
                # utility statements (SET/SHOW/txn control/LISTEN/...)
                # are not traced: their zero-span timelines would churn
                # the bounded flight recorder out of exactly the slow
                # statements it exists to preserve — a pgwire client
                # issuing SET per query would halve the ring's reach
                label = sql_text if sql_text is not None \
                    else type(st).__name__
                utility = isinstance(st, _UNTRACED_STATEMENTS)
                trace = None if utility else self._begin_trace(label)
                if trace is None:
                    self._active_trace = None
                # memory accounting + live progress share the trace's
                # utility gate: SET/SHOW bookkeeping materializes
                # nothing worth accounting and would churn the
                # progress registry
                acct = None if utility else self._begin_mem(label)
                if acct is None:
                    self._active_mem = None
                t0 = time.perf_counter_ns()
                ticket = None
                try:
                    # workload governor admission (sched/governor.py):
                    # utility statements and catalog-only introspection
                    # bypass; everything else may queue (state 'queued',
                    # Admission/AdmissionQueue wait event, queue_wait
                    # trace span) or reject with 53300. t0 precedes the
                    # gate so queue time counts in end-to-end latency —
                    # the number the concurrency bench decomposes.
                    if not utility:
                        from .sched.governor import (GOVERNOR,
                                                     admission_exempt)
                        if GOVERNOR.enabled() and not admission_exempt(st):
                            ticket = GOVERNOR.admit(self, label, trace)
                    res = self._dispatch(st, params, sql_text)
                except BaseException as e:  # noqa: BLE001 — re-raised
                    # error paths dump the timeline automatically: the
                    # flight recorder keeps the failed statement's spans
                    # for post-mortem (sdb_trace / GET /trace/<id>)
                    self._finish_trace(trace,
                                       error=f"{type(e).__name__}: {e}")
                    self._finish_mem(acct)
                    raise
                finally:
                    if ticket is not None:
                        from .sched.governor import GOVERNOR
                        GOVERNOR.release(ticket)
                entry = self._finish_trace(trace)
                self._finish_mem(acct)
                self._obs_record(sql_text, t0, _result_rows(res),
                                 self._active_profile, self._active_plan,
                                 entry, utility=utility, mem=acct)
                return res
        finally:
            CURRENT_CONNECTION.reset(token)

    def request_cancel(self):
        """Ask the in-flight statement to stop (PG CancelRequest). Safe
        from any thread; a no-op when the connection is idle — the flag
        clears when the next statement starts."""
        self._cancel_event.set()

    def check_cancel(self):
        """Cooperative cancellation point (reference: the session's
        interrupt check inside DuckDB execution tasks,
        pg_wire_session.h:205-220). Executors call this at batch
        boundaries AND between chunked device dispatches, so cancel and
        statement_timeout fire mid-aggregate within one chunk's
        latency."""
        if self._cancel_event.is_set():
            self._cancel_event.clear()
            raise errors.SqlError(
                errors.QUERY_CANCELED,
                "canceling statement due to user request")
        deadline = getattr(self, "_deadline", None)
        if deadline is not None:
            if time.monotonic() > deadline:
                self._deadline = None
                raise errors.SqlError(
                    errors.QUERY_CANCELED,
                    "canceling statement due to statement timeout")
        # serene_work_mem enforcement (sched/governor.py contract):
        # the budget rides the SAME cooperative drain as cancel and
        # timeout, checked against the accountant's live bytes — free
        # when no ceiling is set (one attribute read), one bucket sum
        # per batch boundary when one is
        limit = self._work_mem_limit
        if limit:
            acct = self._active_mem
            if acct is not None:
                live = acct.totals()[0]
                if live > limit:
                    self._work_mem_limit = 0   # abort once, not per morsel
                    from .obs.resources import fmt_kb
                    raise errors.SqlError(
                        errors.OUT_OF_MEMORY,
                        "out of memory: statement live bytes "
                        f"({fmt_kb(live)}) exceed serene_work_mem "
                        f"({fmt_kb(limit)})",
                        hint="raise serene_work_mem or reduce the "
                             "statement's working set")

    @contextlib.contextmanager
    def _session_scope(self, label: str):
        """pg_stat_activity bookkeeping + active-query metrics + txn-abort
        marking shared by the materializing and streaming paths."""
        self._cancel_event.clear()   # cancel targets the CURRENT statement
        timeout_ms = int(self.settings.get("statement_timeout") or 0)
        # serene_statement_timeout_ms rides the same deadline/drain; the
        # LOWER positive value wins when both are set
        g_ms = int(self.settings.get("serene_statement_timeout_ms") or 0)
        if g_ms > 0 and (timeout_ms <= 0 or g_ms < timeout_ms):
            timeout_ms = g_ms
        # save/restore: a statement interleaved with a SUSPENDED streaming
        # portal (extended protocol) must not clobber the portal's
        # deadline — scopes nest, each restores what it found (same for
        # the work-mem ceiling and the fair-share scheduling identity)
        prev_deadline = getattr(self, "_deadline", None)
        self._deadline = (time.monotonic() + timeout_ms / 1000.0
                          if timeout_ms > 0 else None)
        prev_work_mem = self._work_mem_limit
        self._work_mem_limit = int(self.settings.get("serene_work_mem") or 0)
        prev_sched = self._sched
        from .sched.governor import next_stmt_tag
        self._sched = (next_stmt_tag(),
                       int(self.settings.get("serene_priority") or 100))
        sess = self.db.sessions.get(self._session_id)
        if sess is not None:
            sess["state"] = "active"
            sess["query"] = label
            sess["query_start"] = time.time()
            sess["application_name"] = \
                str(self.settings.get("application_name") or "")
        try:
            with metrics.QUERIES_ACTIVE.scoped():
                yield
        except errors.SqlError:
            if self.in_txn:
                self.txn_failed = True
            raise
        finally:
            self._deadline = prev_deadline
            self._work_mem_limit = prev_work_mem
            self._sched = prev_sched
            if sess is not None:
                sess["state"] = ("idle in transaction"
                                 if self.in_txn else "idle")
                # an abandoned wait (error inside a waiting section)
                # must not linger as this session's live wait event
                sess["wait_event_type"] = None
                sess["wait_event"] = None

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, st: ast.Statement, params: list,
                  sql_text: Optional[str] = None) -> QueryResult:
        if isinstance(st, (ast.Drop, ast.DropRole, ast.AlterTable,
                           ast.CreateRole, ast.AlterRole, ast.GrantRevoke,
                           ast.CreateIndex, ast.VacuumStmt)):
            # destructive/administrative DDL is superuser-only in the
            # ownerless v1 model (PG would check ownership)
            if not self.db.roles.is_superuser(self.current_role):
                raise errors.SqlError(
                    errors.INSUFFICIENT_PRIVILEGE,
                    f"must be superuser to run {type(st).__name__}")
        if isinstance(st, (ast.Select, ast.SetOp)):
            batch = self._run_select(st, params, sql_text=sql_text)
            return QueryResult(batch, f"SELECT {batch.num_rows}")
        if isinstance(st, ast.CreateTable):
            return self._create_table(st, params)
        if isinstance(st, ast.CreateSchema):
            self.db.create_schema(st.name, st.if_not_exists)
            if self.db.store is not None:
                self.db.store.update_meta(
                    lambda m: None if st.name in m["schemas"]
                    else m["schemas"].append(st.name))
            return QueryResult(Batch([], []), "CREATE SCHEMA")
        if isinstance(st, ast.CreateView):
            schema, name = self.db._split(st.name)
            # store the SELECT body: pg_get_viewdef/pg_views.definition
            # return the query, not the CREATE statement (PG semantics —
            # tools wrap it in their own CREATE VIEW). body_sql is sliced
            # from token positions by the parser.
            body = (getattr(st, "body_sql", None) or
                    getattr(st, "source_sql", None) or sql_text or "")
            self.db.create_view(schema, name,
                                ViewDef(name, st.query, body),
                                st.or_replace)
            if self.db.store is not None:
                from .storage.store import dumps_ast
                blob = dumps_ast(st.query)
                self.db.store.update_meta(
                    lambda m: m["views"].__setitem__(
                        f"{schema}.{name.lower()}", {"ast_b64": blob}))
            return QueryResult(Batch([], []), "CREATE VIEW")
        if isinstance(st, ast.CreateIndex):
            return self._create_index(st)
        if isinstance(st, ast.CreateRole):
            self.db.roles.create(st.name, st.password, st.login,
                                 st.superuser, st.if_not_exists)
            self._persist_auth()
            return QueryResult(Batch([], []), "CREATE ROLE")
        if isinstance(st, ast.AlterRole):
            self.db.roles.alter(st.name, st.set_password, st.password,
                                st.login, st.superuser)
            self._persist_auth()
            return QueryResult(Batch([], []), "ALTER ROLE")
        if isinstance(st, ast.DropRole):
            self.db.roles.drop(st.name, st.if_exists)
            self._persist_auth()
            return QueryResult(Batch([], []), "DROP ROLE")
        if isinstance(st, ast.GrantRevoke):
            if st.granted_role is not None:
                self.db.roles.grant_role(st.granted_role, st.role,
                                         revoke=not st.grant)
                self._persist_auth()
                return QueryResult(Batch([], []),
                                   "GRANT ROLE" if st.grant
                                   else "REVOKE ROLE")
            schema, name = self.db._split(st.table)
            try:
                self.db.resolve_table(st.table)  # must exist
            except _ViewRef:
                raise errors.SqlError(
                    "42809", f'"{name}" is not a table')
            self.db.roles.grant(f"{schema}.{name.lower()}", st.role,
                                st.privileges, revoke=not st.grant)
            self._persist_auth()
            return QueryResult(Batch([], []),
                               "GRANT" if st.grant else "REVOKE")
        if isinstance(st, ast.SetRole):
            if st.name is None:
                self.current_role = self.session_role  # RESET → auth role
            else:
                if not self.db.roles.exists(st.name):
                    raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                          f'role "{st.name}" does not exist')
                target = st.name.lower()
                # PG: a session may SET ROLE to itself, to any role it is
                # a member of (transitive), or anything if superuser —
                # never an escalation beyond the membership closure
                if target != self.session_role and \
                        not self.db.roles.is_superuser(self.session_role):
                    with self.db.roles._lock:
                        member_of = self.db.roles._closure(
                            self.session_role)
                    if target not in member_of:
                        raise errors.SqlError(
                            errors.INSUFFICIENT_PRIVILEGE,
                            f'permission denied to set role "{st.name}"')
                self.current_role = target
            return QueryResult(Batch([], []), "SET")
        if isinstance(st, ast.AlterTable):
            return self._alter_table(st)
        if isinstance(st, ast.CreateTsDictionary):
            if not self.db.roles.is_superuser(self.current_role):
                raise errors.SqlError(errors.INSUFFICIENT_PRIVILEGE,
                                      "must be superuser to create "
                                      "dictionaries")
            from .search.analysis import (dictionary_exists,
                                          register_dictionary)
            existed = dictionary_exists(st.name)
            register_dictionary(st.name, st.options,
                                if_not_exists=st.if_not_exists)
            if not existed:
                self.db._tsdict_names.add(st.name.lower())
                if self.db.store is not None:
                    opts = dict(st.options)
                    self.db.store.update_meta(
                        lambda m: m.setdefault("tsdicts", {}).__setitem__(
                            st.name.lower(), opts))
            return QueryResult(Batch([], []), "CREATE TEXT SEARCH DICTIONARY")
        if isinstance(st, ast.CreateType):
            key = st.name.lower()
            builtin = True
            try:
                dt.type_from_name(st.name)
            except Exception:
                builtin = False
            if key in self.db.types or builtin:
                if st.if_not_exists:
                    return QueryResult(Batch([], []), "CREATE TYPE")
                raise errors.SqlError(errors.DUPLICATE_OBJECT,
                                      f'type "{st.name}" already exists')
            if st.kind == "domain":
                self.db.resolve_type_name(st.base)   # base must exist
            tdef = {"kind": st.kind, "labels": list(st.labels),
                    "base": st.base}
            self.db.types[key] = tdef
            if self.db.store is not None:
                self.db.store.update_meta(
                    lambda m: m.setdefault("types", {}).__setitem__(
                        key, tdef))
            return QueryResult(Batch([], []),
                               "CREATE TYPE" if st.kind == "enum"
                               else "CREATE DOMAIN")
        if isinstance(st, ast.CreateSequence):
            self.db.create_sequence(".".join(st.name), st.start,
                                    st.increment, st.if_not_exists)
            return QueryResult(Batch([], []), "CREATE SEQUENCE")
        if isinstance(st, ast.Drop):
            if st.kind == "tsdictionary":
                from .search.analysis import drop_dictionary
                target = st.name[-1].lower()
                with self.db.lock:
                    for s in self.db.schemas.values():
                        for t in s.tables.values():
                            for iname, idx in getattr(t, "indexes",
                                                      {}).items():
                                names = {getattr(idx, "analyzer_name",
                                                 "")} | set(
                                    (getattr(idx, "options", {}) or {})
                                    .get("column_tokenizers", {}).values())
                                if target in {n.lower() for n in names}:
                                    raise errors.SqlError(
                                        "2BP01",
                                        f'cannot drop text search '
                                        f'dictionary "{st.name[-1]}" '
                                        f'because index "{iname}" depends '
                                        "on it")
                if not drop_dictionary(st.name[-1]) and not st.if_exists:
                    raise errors.SqlError(
                        errors.UNDEFINED_OBJECT,
                        f'text search dictionary "{st.name[-1]}" does '
                        "not exist")
                self.db._tsdict_names.discard(target)
                if self.db.store is not None:
                    self.db.store.update_meta(
                        lambda m: m.setdefault("tsdicts", {}).pop(
                            target, None))
                return QueryResult(Batch([], []),
                                   "DROP TEXT SEARCH DICTIONARY")
            if st.kind == "sequence":
                self.db.drop_sequence(".".join(st.name), st.if_exists)
                return QueryResult(Batch([], []), "DROP SEQUENCE")
            if st.kind == "type":
                key = st.name[-1].lower()
                if key not in self.db.types:
                    if st.if_exists:
                        return QueryResult(Batch([], []), "DROP TYPE")
                    raise errors.SqlError(
                        errors.UNDEFINED_OBJECT,
                        f'type "{st.name[-1]}" does not exist')
                def _chain(name):
                    # the type name plus every domain base it resolves
                    # through — dropping ANY link breaks the column
                    out = []
                    seen = set()
                    cur = name
                    while cur and cur not in seen:
                        seen.add(cur)
                        out.append(cur)
                        td = self.db.types.get(cur)
                        cur = (td.get("base") or "").lower() \
                            if td and td["kind"] == "domain" else None
                    return out
                for dname, td in self.db.types.items():
                    if td["kind"] == "domain" and \
                            (td.get("base") or "").lower() == key:
                        raise errors.SqlError(
                            "2BP01",
                            f'cannot drop type "{st.name[-1]}" because '
                            f'type "{dname}" depends on it')
                with self.db.lock:
                    for s_ in self.db.schemas.values():
                        for t in s_.tables.values():
                            used = (getattr(t, "table_meta", None)
                                    or {}).get("enums", {})
                            for uname in used.values():
                                if key in _chain(uname):
                                    raise errors.SqlError(
                                        "2BP01",
                                        f'cannot drop type '
                                        f'"{st.name[-1]}" because column '
                                        f'of table "{t.name}" depends '
                                        "on it")
                del self.db.types[key]
                if self.db.store is not None:
                    self.db.store.update_meta(
                        lambda m: m.setdefault("types", {}).pop(key, None))
                return QueryResult(Batch([], []), "DROP TYPE")
            self.db.drop(st.kind, st.name, st.if_exists, st.cascade)
            if self.db.store is not None:
                schema, name = self.db._split(st.name)
                key = f"{schema}.{name.lower()}"
                store = self.db.store

                def mutate(meta):
                    if st.kind == "table" and key in meta["tables"]:
                        dropped_ids.append(meta["tables"][key]["id"])
                        del meta["tables"][key]
                        meta["indexes"] = {k: v for k, v in
                                           meta["indexes"].items()
                                           if v["table"] != key}
                    elif st.kind == "view":
                        meta["views"].pop(key, None)
                    elif st.kind == "schema":
                        target = st.name[-1]
                        if target in meta["schemas"]:
                            meta["schemas"].remove(target)
                        # cascade: purge the schema's persisted objects too,
                        # or the datadir becomes unopenable on restart
                        prefix = f"{target}."
                        for k in [k for k in meta["tables"]
                                  if k.startswith(prefix)]:
                            dropped_ids.append(meta["tables"][k]["id"])
                            del meta["tables"][k]
                        for k in [k for k in meta["views"]
                                  if k.startswith(prefix)]:
                            del meta["views"][k]
                        meta["indexes"] = {
                            k: v for k, v in meta["indexes"].items()
                            if not v["table"].startswith(prefix)}
                    elif st.kind == "index":
                        target = st.name[-1].lower()
                        for k in [k for k in meta["indexes"]
                                  if k.lower() == target]:
                            del meta["indexes"][k]

                dropped_ids: list[int] = []
                store.update_meta(mutate)
                for tid in dropped_ids:
                    # async drop: tombstone now (O(1) rename), reclaim in
                    # the maintenance loop (reference: drop_task.cpp)
                    store.tombstone_snapshot(tid)
            return QueryResult(Batch([], []), f"DROP {st.kind.upper()}")
        if isinstance(st, ast.Insert):
            return self._insert(st, params)
        if isinstance(st, ast.Delete):
            return self._delete(st, params)
        if isinstance(st, ast.Update):
            return self._update(st, params)
        if isinstance(st, ast.Truncate):
            return self._truncate(st)
        if isinstance(st, ast.SetStmt):
            return self._set(st)
        if isinstance(st, ast.ShowStmt):
            return self._show(st)
        if isinstance(st, ast.ListenStmt):
            if self.in_txn:
                # PG defers LISTEN/UNLISTEN effects to COMMIT
                self._txn_actions.append((st.action, st.channel, None))
            else:
                self._apply_listen(st.action, st.channel)
            return QueryResult(Batch([], []),
                               "LISTEN" if st.action == "listen"
                               else "UNLISTEN")
        if isinstance(st, ast.NotifyStmt):
            if self.in_txn:
                # PG queues NOTIFY until COMMIT; ROLLBACK discards it
                self._txn_actions.append(("notify", st.channel, st.payload))
            else:
                self._apply_notify(st.channel, st.payload)
            return QueryResult(Batch([], []), "NOTIFY")
        if isinstance(st, ast.Transaction):
            return self._txn(st)
        if isinstance(st, ast.Explain):
            return self._explain(st, params, sql_text)
        if isinstance(st, ast.VacuumStmt):
            return self._vacuum(st)
        if isinstance(st, ast.CopyStmt):
            return self._copy(st, params)
        raise errors.unsupported(f"statement {type(st).__name__}")

    # -- SELECT ------------------------------------------------------------

    def _plan(self, sel: ast.Select, params: list) -> PlanNode:
        from .sql.search_rewrite import rewrite_search
        planner = Planner(_ResolverShim(self.db, params, self), params)
        self._plan_inlined_views = False
        while True:
            try:
                return rewrite_search(planner.plan_select(sel))
            except _ViewRef as vr:
                self._plan_inlined_views = True
                sel = _inline_view(sel, vr.view)

    def _profile_enabled(self) -> bool:
        try:
            return bool(self.settings.get("serene_profile"))
        except KeyError:  # pragma: no cover — registry always declares it
            return False

    def _trace_enabled(self) -> bool:
        try:
            return bool(self.settings.get("serene_trace"))
        except KeyError:  # pragma: no cover — registry always declares it
            return False

    def _mem_enabled(self) -> bool:
        try:
            return bool(self.settings.get("serene_mem_account"))
        except KeyError:  # pragma: no cover — registry always declares it
            return False

    def _begin_mem(self, label: str):
        """Start the statement's memory accounting + live progress row
        (serene_mem_account on): allocates the accountant, registers it
        in the ACTIVE query registry (sdb_query_progress / GET
        /progress) and publishes it through CURRENT_MEM so pool tasks,
        device uploads and cache stores charge this query's account.
        Observation only — executors never read the accountant back."""
        if not self._mem_enabled():
            self._active_mem = None
            return None
        from .obs.resources import ACTIVE, CURRENT_MEM, MemoryAccountant
        acct = MemoryAccountant(label, pid=self._session_id)
        acct._cv_token = CURRENT_MEM.set(acct)
        ACTIVE.register(acct)
        self._active_mem = acct
        return acct

    def _finish_mem(self, acct) -> None:
        """Retire the statement's accounting: progress row leaves the
        ACTIVE registry (success AND error paths — a failed statement
        must not linger as a phantom running query) and the contextvar
        resets. The accountant object stays readable for statement-end
        attribution (_obs_record, flight-recorder peak stamp)."""
        if acct is None:
            return
        from .obs.resources import ACTIVE, CURRENT_MEM
        if acct._cv_token is not None:
            CURRENT_MEM.reset(acct._cv_token)
            acct._cv_token = None
        ACTIVE.retire(acct)

    def _begin_trace(self, label: str):
        """Start the statement's timeline trace (serene_trace on):
        allocates the trace id and publishes it through CURRENT_TRACE so
        pool tasks / batcher members / device dispatches stamp spans
        into this query's timeline. Observation only — executors never
        read the trace back."""
        if not self._trace_enabled():
            self._active_trace = None
            return None
        from .obs.trace import CURRENT_TRACE, QueryTrace
        tr = QueryTrace(label)
        tr._cv_token = CURRENT_TRACE.set(tr)
        self._active_trace = tr
        return tr

    def _finish_trace(self, tr, error: Optional[str] = None):
        """Finalize a trace into the flight recorder (success AND error
        paths — a failed statement's timeline is exactly the one worth
        keeping). Returns the recorded entry, or None."""
        if tr is None:
            return None
        from .obs.trace import CURRENT_TRACE, FLIGHT
        if tr._cv_token is not None:
            CURRENT_TRACE.reset(tr._cv_token)
            tr._cv_token = None
        entry = tr.finish(error)
        # accounted peak rides the flight-recorder entry so a
        # memory-heavy query is findable after the fact (sdb_trace
        # listing, GET /trace, /_stats.traces)
        acct = self._active_mem
        if acct is not None:
            entry["peak_bytes"] = acct.totals()[1]
        return FLIGHT.record(entry)

    def _exec_ctx(self, params: list) -> ExecContext:
        """Execution context with a span collector attached when
        `serene_profile` is on (obs/trace.py); the collector observes
        only, so results are identical either way."""
        ctx = ExecContext(self.settings, params, device=self.db.device)
        if self._profile_enabled():
            from .obs.trace import QueryProfile
            ctx.profile = QueryProfile()
            self._active_profile = ctx.profile
        # the statement-level accountant (begun next to the trace)
        # rides the context so operator wrappers charge without a
        # contextvar read per batch
        ctx.mem = self._active_mem
        return ctx

    def _run_select(self, sel: ast.Select, params: list,
                    sql_text: Optional[str] = None) -> Batch:
        from .cache.result import RESULT_CACHE
        from .obs.trace import current_trace
        tr = current_trace()
        t_probe = time.perf_counter_ns() if tr is not None else 0
        probe = RESULT_CACHE.begin(self, sel, params, sql_text)
        if probe is not None:
            # plan-skipping fast path: the statement's table set was
            # learned at an earlier store — resolve, re-check ACLs,
            # observe publications, serve
            hit = probe.fast_lookup()
            if hit is not None:
                if tr is not None:
                    tr.add("cache_probe", "cache", t_probe,
                           time.perf_counter_ns(), hit=True)
                return hit
        t_plan = time.perf_counter_ns() if tr is not None else 0
        if tr is not None and t_plan - t_probe > 1000:
            # cache digest + publication observation time: part of the
            # statement's wall clock, attributed so plan+execute+probe
            # spans jointly cover the timeline instead of leaving a gap
            tr.add("cache_probe", "cache", t_probe, t_plan)
        plan = self._plan(sel, params)
        t_exec = time.perf_counter_ns() if tr is not None else 0
        if tr is not None:
            tr.add("plan", "plan", t_plan, t_exec)
        ctx = self._exec_ctx(params)
        if ctx.profile is not None:
            self._active_plan = plan
        if probe is not None:
            probe.prepare(plan)
            hit = probe.lookup()
            if hit is not None:
                return hit
        batch = plan.execute(ctx)
        if tr is not None:
            # the timeline's execution envelope: plan-digest probe,
            # execution and result hand-off — so cache_probe + plan +
            # execute jointly account for the statement's wall time
            # even when no finer-grained span fired (tiny serial
            # queries)
            tr.add("execute", "exec", t_exec, time.perf_counter_ns())
        if probe is not None:
            probe.store(batch)
        return batch

    def _obs_record(self, sql_text: Optional[str], t0_ns: int, rows: int,
                    profile, plan, trace_entry=None,
                    utility: bool = False, mem=None) -> None:
        """Statement-end observability hook (begin is _session_scope):
        query gauges + latency histogram, sdb_stat_statements, the
        slow-query log and the session's pg_stat_activity query id.
        Everything is behind `serene_profile`; failures here must never
        fail the statement's own result path, so this is called only
        after success. `trace_entry` is the statement's flight-recorder
        timeline (serene_trace on) — the slow-query log attaches its
        top-5 widest spans next to the annotated plan tree.

        The latency histogram records BEFORE the serene_profile gate:
        the pool/batch/device histograms fill regardless of that
        setting, and query p50/p99 is half of the admission-control
        signal pair — it must not vanish because profiling was turned
        off. `utility` statements (SET/SHOW/txn bookkeeping) stay OUT
        of it: a client issuing SET per query would otherwise drown the
        percentiles in microsecond observations."""
        elapsed_ns = time.perf_counter_ns() - t0_ns
        if not utility:
            metrics.QUERY_LATENCY_HIST.observe_ns(elapsed_ns)
        mem_peak = mem_live = 0
        if mem is not None:
            # the peak histogram records BEFORE the serene_profile gate
            # for the same reason the latency histogram does: the
            # memory axis is its own setting and half of the
            # admission-control signal pair
            mem_live, mem_peak = mem.totals()
            metrics.QUERY_PEAK_BYTES_HIST.observe_ns(mem_peak)
            metrics.MEM_ACCOUNT_EVENTS.add(mem.event_count())
        if not self._profile_enabled():
            return
        metrics.QUERY_TIME_NS.add(elapsed_ns)
        metrics.QUERIES_EXECUTED.add()
        pruned = 0
        if profile is not None:
            t = profile.totals()
            pruned = t.morsels_pruned + t.morsels_jf_pruned
        if sql_text:
            from .obs.statements import STATEMENTS
            cap = int(self.settings.get("serene_stat_statements_max"))
            qid = STATEMENTS.record(sql_text, elapsed_ns, rows, pruned,
                                    cap,
                                    cache_hit=getattr(self, "_cache_hit",
                                                      False),
                                    peak_bytes=mem_peak)
            sess = self.db.sessions.get(self._session_id)
            if sess is not None:
                sess["query_id"] = qid
        thresh = int(self.settings.get("serene_log_min_duration_ms"))
        if thresh >= 0 and elapsed_ns >= thresh * 1_000_000:
            metrics.SLOW_QUERIES.add()
            msg = (f"duration: {elapsed_ns / 1e6:.3f} ms  "
                   f"statement: {sql_text or '<internal>'}")
            if mem is not None:
                from .obs.resources import fmt_kb
                msg += (f"\nmemory: peak={fmt_kb(mem_peak)} "
                        f"live={fmt_kb(max(mem_live, 0))}")
            if profile is not None and plan is not None:
                from .obs.trace import annotate_plan
                msg += "\n" + "\n".join(annotate_plan(plan, profile,
                                                      mem))
            if trace_entry is not None:
                from .obs.trace import format_top_spans
                msg += "\n" + "\n".join(format_top_spans(trace_entry))
            log.info("slow_query", msg)

    # -- DDL/DML -----------------------------------------------------------

    def _create_table(self, st: ast.CreateTable, params: list) -> QueryResult:
        schema, name = self.db._split(st.name)
        enums: dict = {}
        if st.as_query is None:
            cols = []
            names = []
            for cd in st.columns:
                t, labels = self.db.resolve_type_name(cd.type_name)
                if labels is not None:
                    enums[cd.name] = cd.type_name.lower()
                names.append(cd.name)
                cols.append(Column(t, np.empty(0, dtype=t.np_dtype), None,
                                   np.empty(0, dtype=object)
                                   if t.is_string else None))
            batch = Batch(names, cols)
        else:
            batch = self._run_select(st.as_query, params)
        key = f"{schema}.{name.lower()}"
        if self.db.store is not None:
            table_id = self.db.store.new_table_id()
            provider: MemTable = StoredTable(name, batch, key, table_id)
        else:
            provider = MemTable(name, batch)
        provider.table_meta = {
            "engine": st.engine,
            "primary_key": st.primary_key,
            "not_null": [c.name for c in st.columns if c.not_null],
            "defaults": {c.name: c.default for c in st.columns if c.default},
            "tokenizers": {c.name: c.tokenizer for c in st.columns
                           if c.tokenizer},
            "options": st.options,
            "enums": enums,
        }
        created = self.db.create_table(schema, name, provider,
                                       st.if_not_exists)
        if created and not self.db.roles.is_superuser(self.current_role):
            # creator keeps full use of their own table
            self.db.roles.grant(key, self.current_role, ["all"])
        if created and self.db.store is not None:
            from .storage.store import table_def
            start_tick = self.db.store.ticks.current()
            tdef = table_def(key, provider.table_id, provider.column_names,
                             provider.column_types, provider.table_meta,
                             start_tick)
            if batch.num_rows:
                self.db.store.write_snapshot(provider.table_id, batch)
            self.db.store.update_meta(
                lambda m: m["tables"].__setitem__(key, tdef))
        if st.as_query is not None and created:
            return QueryResult(Batch([], []),
                               f"SELECT {provider.row_count()}")
        return QueryResult(Batch([], []), "CREATE TABLE")

    def _create_index(self, st: ast.CreateIndex) -> QueryResult:
        from .utils.progress import REGISTRY as _progress
        provider = self.db.resolve_table(st.table)
        if not hasattr(provider, "indexes"):
            provider.indexes = {}
        idx_name = st.name or f"{st.table[-1]}_{'_'.join(st.columns)}_idx"
        from .search.index import build_index_for_table
        for c in st.columns:
            if c not in provider.column_names:
                raise errors.SqlError(errors.UNDEFINED_COLUMN,
                                      f'column "{c}" does not exist')
        if st.using is None:
            # no USING clause: text columns get the inverted index (this
            # is a search database), anything else a btree — PG's own
            # default method. Decided from the declared schema type, not a
            # full materialization of the column.
            first_type = provider.column_types[
                provider.column_names.index(st.columns[0])]
            st.using = "inverted" if first_type.is_string else "btree"
        options = dict(st.options)
        if st.column_tokenizers:
            # per-column dictionary names; columns WITHOUT one keep the
            # index default ('text' unless WITH tokenizer=... says else)
            options["column_tokenizers"] = dict(st.column_tokenizers)
        with _progress.track("CREATE INDEX", provider.row_count()):
            built = build_index_for_table(provider, st.columns, st.using,
                                          options)
            from .search.index import _index_lock
            with _index_lock(provider):   # serializes registry mutation
                provider.indexes[idx_name] = built
        if self.db.store is not None and isinstance(provider, StoredTable):
            idef = {"table": provider.key, "columns": list(st.columns),
                    "using": st.using, "options": options}
            self.db.store.update_meta(
                lambda m: m["indexes"].__setitem__(idx_name, idef))
        return QueryResult(Batch([], []), "CREATE INDEX")

    def _alter_table(self, st: ast.AlterTable) -> QueryResult:
        try:
            # DDL is autocommit: ALTER must hit the REAL table, never the
            # txn work copy (COMMIT replays only insert/delete/truncate,
            # and RENAME must not publish uncommitted state)
            table = self._table_for_dml(st.table, txn_route=False)
        except errors.SqlError:
            if st.if_exists:
                return QueryResult(Batch([], []), "ALTER TABLE")
            raise
        # LOCK ORDER: write_lock (via quiesced) first, db.lock inner —
        # the same order DML uses when a WHERE subquery resolves tables
        # under the write_lock (resolve_table takes db.lock). db.lock is
        # only taken around the rename's catalog-dict mutation below.
        with self.db.quiesced([table]):
            full = table.full_batch()
            names = list(full.names)
            if st.action == "add_column":
                if st.column in names:
                    if st.if_not_exists:
                        return QueryResult(Batch([], []), "ALTER TABLE")
                    raise errors.SqlError(
                        "42701", f'column "{st.column}" already exists')
                t, labels = self.db.resolve_type_name(st.type_name)
                if labels is not None:
                    meta_t = getattr(table, "table_meta", None)
                    if meta_t is not None:
                        meta_t.setdefault("enums", {})[st.column] = \
                            st.type_name.lower()
                col = Column.from_pylist([None] * full.num_rows, t)
                table.replace(Batch(names + [st.column],
                                    list(full.columns) + [col]),
                              rows_preserved=True)
            elif st.action == "drop_column":
                if st.column not in names:
                    if st.col_if_exists:
                        return QueryResult(Batch([], []), "ALTER TABLE")
                    raise errors.SqlError(
                        errors.UNDEFINED_COLUMN,
                        f'column "{st.column}" does not exist')
                if len(names) == 1:
                    raise errors.SqlError(
                        "0A000", "cannot drop the only column of a table")
                keep = [i for i, n in enumerate(names) if n != st.column]
                # NOT rows_preserved: dropping a column changes column
                # identity — caches keyed per column name under an
                # unchanged epoch (zone maps) must not survive a later
                # re-add of the same name with different values
                table.replace(Batch([names[i] for i in keep],
                                    [full.columns[i] for i in keep]))
            elif st.action == "rename_column":
                if st.column not in names:
                    raise errors.SqlError(
                        errors.UNDEFINED_COLUMN,
                        f'column "{st.column}" does not exist')
                if st.new_name in names:
                    raise errors.SqlError(
                        "42701", f'column "{st.new_name}" already exists')
                new_names = [st.new_name if n == st.column else n
                             for n in names]
                # NOT rows_preserved: renaming moves values under a new
                # name — per-column-name caches (zone maps) must rebuild
                table.replace(Batch(new_names, list(full.columns)))
            elif st.action == "rename_table":
                schema, name = self.db._split(st.table)
                with self.db.lock:   # catalog-dict mutation
                    s = self.db.schemas[schema]
                    new_key = st.new_name.lower()
                    if new_key in s.tables or new_key in s.views:
                        raise errors.SqlError(
                            errors.DUPLICATE_TABLE,
                            f'relation "{st.new_name}" already exists')
                    del s.tables[name.lower()]
                    table.name = st.new_name
                    s.tables[new_key] = table
                    if isinstance(table, StoredTable):
                        old_skey = table.key
                        table.key = f"{schema}.{new_key}"
            # indexes over altered tables rebuild on next refresh; dropped/
            # renamed columns drop their indexes
            if st.action in ("drop_column", "rename_column"):
                for iname, idx in list(getattr(table, "indexes",
                                               {}).items()):
                    if st.column in idx.columns:
                        del table.indexes[iname]
            # persist new shape
            if self.db.store is not None and isinstance(table, StoredTable):
                from .storage.store import table_def
                tick = self.db.store.ticks.current()
                tdef = table_def(table.key, table.table_id,
                                 table.column_names, table.column_types,
                                 getattr(table, "table_meta", {}), tick)
                self.db.store.write_snapshot(table.table_id,
                                             table.full_batch())
                tdef["checkpoint_tick"] = tick
                key = table.key

                def mutate(m):
                    if st.action == "rename_table":
                        m["tables"].pop(old_skey, None)
                        for idef in m["indexes"].values():
                            if idef["table"] == old_skey:
                                idef["table"] = key
                    m["tables"][key] = tdef
                    if st.action in ("drop_column", "rename_column"):
                        m["indexes"] = {
                            k: v for k, v in m["indexes"].items()
                            if not (v["table"] == key and
                                    st.column in v["columns"])}
                self.db.store.update_meta(mutate)
        return QueryResult(Batch([], []), "ALTER TABLE")

    def _table_for_dml(self, parts: list[str],
                       privilege: str = "insert",
                       txn_route: bool = True) -> MemTable:
        try:
            provider = self.db.resolve_table(parts, privilege)
        except _ViewRef:
            raise errors.SqlError(
                "55000", f'cannot modify view "{parts[-1]}"')
        if not isinstance(provider, MemTable):
            raise errors.SqlError(errors.FEATURE_NOT_SUPPORTED,
                                  "cannot modify this table")
        if self.in_txn and txn_route:
            return self._txn_write_provider(provider)
        return provider

    # -- snapshot-isolation transaction machinery -------------------------
    # Reference analog: the versioned catalog snapshot model (SURVEY.md
    # §3.2 "binding pins a catalog::Snapshot") — a txn reads one immutable
    # snapshot and buffers writes; COMMIT is first-committer-wins.

    def _txn_key_of(self, provider) -> Optional[str]:
        """schema.table key when this provider is a user table (system
        tables and table functions are rebuilt per query — never
        pinned). Delegates to the shared catalog resolution (db.lock is
        an RLock, so callers already holding it nest safely)."""
        return self.db.catalog_key_of(provider)

    @staticmethod
    def _txn_copy(provider, batch, share_indexes: bool = False) -> MemTable:
        copy = MemTable(provider.name, batch)
        meta = getattr(provider, "table_meta", None)
        if meta is not None:
            copy.table_meta = meta
        if share_indexes:
            # segments are immutable: a pin over the CURRENT batch can
            # share the provider's search indexes (in-txn indexed search);
            # batch+version+epoch are ONE atomic observation via pinned()
            # so the freshness checks stay honest without any lock
            cur, ver, epoch = provider.pinned()
            if batch is cur:
                copy.data_version = ver
                copy.mutation_epoch = epoch
                # the per-provider rebuild lock serializes every mutation
                # of the index registry (CREATE INDEX / read-repair), so
                # copying under it is deterministic
                from .search.index import _index_lock
                with _index_lock(provider):
                    copy.indexes = dict(getattr(provider, "indexes",
                                                {}) or {})
        return copy

    def _txn_read_provider(self, provider):
        # _txn_key_of scans the catalog dicts — db.lock guards those; the
        # data pin itself is the provider's atomic publication
        with self.db.lock:
            key = self._txn_key_of(provider)
        if key is None:
            return provider
        w = self._txn_writes.get(key)
        if w is not None:
            return w["work"]          # read-your-writes
        pin = self._txn_pins.get(key)
        if pin is None:
            batch, ver, _ = provider.pinned()
            pin = self._txn_copy(provider, batch, share_indexes=True)
            pin._txn_base_version = ver
            self._txn_pins[key] = pin
        return pin

    def _txn_write_provider(self, provider) -> MemTable:
        with self.db.lock:
            key = self._txn_key_of(provider)
        if key is None:
            raise errors.SqlError(errors.FEATURE_NOT_SUPPORTED,
                                  "cannot modify this table in a "
                                  "transaction")
        w = self._txn_writes.get(key)
        if w is not None:
            return w["work"]
        # seed the working copy from the pinned snapshot (or pin now):
        # the txn keeps seeing its own snapshot + its own writes
        pin = self._txn_read_provider(provider)
        work = self._txn_copy(provider, pin.full_batch())
        work._txn_key = key
        self._txn_writes[key] = {
            "real": provider, "work": work,
            "version": getattr(pin, "_txn_base_version",
                               provider.data_version),
            "ops": []}
        return work

    def _txn_clear(self):
        self._txn_pins = {}
        self._txn_writes = {}
        self._txn_savepoints = []
        self._txn_actions = []

    def _txn_commit_writes(self):
        """First-committer-wins publish: conflict check, one atomic WAL
        commit across all written tables, then in-memory apply."""
        if not self._txn_writes:
            return
        from .storage.wal import WalOp
        # Quiesce committed-but-unpublished fast-path inserts first: such
        # an insert holds an earlier WAL tick but is invisible to the
        # data_version conflict check, and publishing txn ops ahead of it
        # would diverge live row order from replay (tick) order,
        # corrupting positional delete/update records on recovery.
        # quiesced() holds every written table's write_lock, so the
        # conflict check + WAL commit + publish are atomic vs other
        # writers of those tables; writers of OTHER tables proceed.
        with self.db.quiesced(
                [w["real"] for w in self._txn_writes.values()]):
            for key, w in self._txn_writes.items():
                if w["real"].data_version != w["version"] or \
                        self.db._table_by_key(key) is not w["real"]:
                    # concurrent update, or the table was dropped/replaced
                    # under the txn
                    self._txn_clear()
                    raise errors.SqlError(
                        "40001", "could not serialize access due to "
                        "concurrent update")
            if self.db.store is not None:
                wal_ops = [WalOp(w["real"].key, kind, batch, rows)
                           for w in self._txn_writes.values()
                           if isinstance(w["real"], StoredTable)
                           for kind, batch, rows in w["ops"]]
                if wal_ops:
                    self.db.store.commit(wal_ops)
            for w in self._txn_writes.values():
                _apply_ops(w["real"], w["ops"])

    def _insert(self, st: ast.Insert, params: list) -> QueryResult:
        table = self._table_for_dml(st.table)
        if st.returning:
            self.db.resolve_table(st.table, "select")   # PG: RETURNING reads
        target_names = st.columns or table.column_names
        seen_targets = set()
        for c in target_names:
            if c not in table.column_names:
                raise errors.SqlError(errors.UNDEFINED_COLUMN,
                                      f'column "{c}" does not exist')
            if c.lower() in seen_targets:
                raise errors.SqlError(
                    "42701",
                    f'column "{c}" specified more than once')
            seen_targets.add(c.lower())
        if st.query is not None:
            incoming = self._run_select(st.query, params)
            if incoming.num_columns != len(target_names):
                raise errors.SqlError(
                    "42601", "INSERT has more expressions than columns"
                    if incoming.num_columns > len(target_names)
                    else "INSERT has more target columns than expressions")
            # PG maps SELECT output to target columns POSITIONALLY —
            # matching by name would silently insert NULLs
            incoming = Batch(list(target_names), list(incoming.columns))
        else:
            binder = ExprBinder(Scope([]), params)
            one = Batch(["__dummy"], [Column.from_pylist([0])])
            cols_vals: list[list] = [[] for _ in target_names]
            # epoch-int types (INTERVAL/DATE/TIMESTAMP) must keep their
            # bound type: re-inferring from the raw int would type interval
            # micros as BIGINT and then refuse the BIGINT→INTERVAL cast
            cols_types: list = [None] * len(target_names)
            for row in st.values:
                if len(row) != len(target_names):
                    raise errors.SqlError(
                        "42601", "INSERT has more expressions than columns"
                        if len(row) > len(target_names)
                        else "INSERT has more target columns than expressions")
                for k, e in enumerate(row):
                    if isinstance(e, ast.DefaultMarker):
                        dv, dvt = _default_typed(table, target_names[k])
                        cols_vals[k].append(dv)
                        if dvt is not None and dvt.id in (
                                dt.TypeId.INTERVAL, dt.TypeId.DATE,
                                dt.TypeId.TIMESTAMP):
                            cols_types[k] = dvt
                        continue
                    b = binder.bind(e)
                    cols_vals[k].append(b.eval(one).decode(0))
                    if b.type.id in (dt.TypeId.INTERVAL, dt.TypeId.DATE,
                                     dt.TypeId.TIMESTAMP):
                        cols_types[k] = b.type
            incoming = Batch(list(target_names),
                             [Column.from_pylist(v, cols_types[k])
                              for k, v in enumerate(cols_vals)])
        if st.on_conflict is not None:
            pk = _pk_of(table)
            return self._insert_with_pk(st, table, incoming, pk, params)
        aligned = self._insert_batch(table, incoming)
        tag = f"INSERT 0 {incoming.num_rows}"
        if st.returning:
            return QueryResult(self._returning_batch(
                st.returning, table, aligned, params), tag)
        return QueryResult(Batch([], []), tag)

    def _insert_with_pk(self, st, table, incoming: Batch, pk: list,
                        params: list) -> QueryResult:
        """INSERT into a table with a PRIMARY KEY: uniqueness enforcement
        (23505) and ON CONFLICT DO NOTHING / DO UPDATE (reference: PG
        upsert; conflict arbitration is the declared primary key)."""
        action, target, assigns = st.on_conflict
        if action == "update" and not target:
            raise errors.SqlError(
                "42601", "ON CONFLICT DO UPDATE requires a conflict "
                "target")
        if target:
            if not pk or sorted(t.lower() for t in target) != \
                    sorted(c.lower() for c in pk):
                raise errors.SqlError(
                    "42P10", "there is no unique or exclusion constraint "
                    "matching the ON CONFLICT specification")
        if not pk:
            # targetless DO NOTHING on an unconstrained table: nothing can
            # conflict (PG accepts this); plain insert
            aligned = self._insert_batch(table, incoming)
            tag = f"INSERT 0 {aligned.num_rows}"
            if st.returning:
                return QueryResult(self._returning_batch(
                    st.returning, table, aligned, params), tag)
            return QueryResult(Batch([], []), tag)
        with table.write_lock:
            aligned = _align_to_schema(table, incoming)
            _check_not_null(table, aligned)
            _check_enums(self.db, table, aligned)
            key_cols_new = [aligned.column(c).to_pylist() for c in pk]
            _check_pk_not_null(pk, key_cols_new, aligned.num_rows)
            from .columnar import keyenc
            from .search.pkindex import pk_index
            idx = pk_index(table)
            enc_new = keyenc.encode_key_columns(
                [aligned.column(c) for c in pk])
            fresh_rows, conflicts, seen = [], [], set()
            for i in range(aligned.num_rows):
                key = enc_new[i]
                if key in seen:
                    # second hit on the same key within one statement
                    if action == "update":
                        raise errors.SqlError(
                            "21000", "ON CONFLICT DO UPDATE command "
                            "cannot affect row a second time")
                    if action is None:
                        raise errors.SqlError(
                            "23505", "duplicate key value violates "
                            "unique constraint "
                            f"(key columns: {', '.join(pk)})")
                    continue              # DO NOTHING drops the duplicate
                hit = idx.get(key)
                if hit >= 0:
                    if action is None:
                        raise errors.SqlError(
                            "23505", "duplicate key value violates "
                            "unique constraint "
                            f"(key columns: {', '.join(pk)})")
                    conflicts.append((i, hit))
                    seen.add(key)
                    continue              # DO NOTHING also lands here: no-op
                fresh_rows.append(i)
                seen.add(key)
            if action == "nothing":
                conflicts = []
            ops = []
            affected = []
            if conflicts and action == "update":
                full = table.full_batch()
                old_rows = np.asarray([o for _, o in conflicts],
                                      dtype=np.int64)
                exc_rows = [i for i, _ in conflicts]
                updated = self._apply_upsert_assignments(
                    table, full.take(old_rows), aligned.take(
                        np.asarray(exc_rows, dtype=np.int64)),
                    assigns, params)
                # PK-based remove filter (not positional rows): replay
                # after a crash resolves the same keys whatever the
                # physical row order (reference: search_remove_filter)
                ops.append(("delete_pk", None,
                            {"cols": list(pk),
                             "keys": [enc_new[i] for i, _ in conflicts]}))
                ops.append(("insert", updated, None))
                affected.append(updated)
            if fresh_rows:
                fresh = aligned.take(np.asarray(fresh_rows,
                                                dtype=np.int64))
                ops.append(("insert", fresh, None))
                affected.append(fresh)
            n_affected = (len(fresh_rows) +
                          (len(conflicts) if action == "update" else 0))
            if ops:
                self._wal_commit(table, ops)
                _apply_ops(table, ops)
        tag = f"INSERT 0 {n_affected}"
        if st.returning:
            out = concat_batches(affected) if affected else Batch(
                list(table.column_names),
                [Column.from_pylist([], t) for t in table.column_types])
            return QueryResult(self._returning_batch(
                st.returning, table, out, params), tag)
        return QueryResult(Batch([], []), tag)

    def _apply_upsert_assignments(self, table, old: Batch, exc: Batch,
                                  assigns, params: list) -> Batch:
        """DO UPDATE SET evaluation: unqualified columns are the existing
        row, excluded.col is the incoming row (PG semantics)."""
        base_cols = [ScopeColumn(table.name, n, c.type, i)
                     for i, (n, c) in enumerate(zip(old.names,
                                                    old.columns))]
        n_base = len(base_cols)
        exc_cols = [ScopeColumn("excluded", n, c.type, n_base + i)
                    for i, (n, c) in enumerate(zip(exc.names,
                                                   exc.columns))]
        scope = _UpsertScope(base_cols, exc_cols)
        combined = Batch(list(old.names) + [f"__exc_{n}"
                                            for n in exc.names],
                         list(old.columns) + list(exc.columns))
        binder = ExprBinder(scope, params)
        new_cols = {}
        for col_name, e in assigns:
            if col_name not in old:
                raise errors.SqlError(
                    errors.UNDEFINED_COLUMN,
                    f'column "{col_name}" does not exist')
            target_t = old.column(col_name).type
            new_cols[col_name] = _coerce(binder.bind(e).eval(combined),
                                         target_t)
        return Batch(list(old.names),
                     [new_cols.get(n, c)
                      for n, c in zip(old.names, old.columns)])

    def _dml_join(self, table: MemTable, tparts: list[str], extra_ref,
                  where_ast, value_exprs: list, params: list):
        """UPDATE ... FROM / DELETE ... USING core: plan a real join of
        the row-numbered target against the extra FROM tables, evaluate
        the value expressions in the joined scope, and keep the FIRST
        match per target row (PG: which match wins is unspecified).
        Returns (rows int64 sorted-unique, [Column per value expr])."""
        full = table.full_batch()
        rowcol = Column.from_numpy(
            np.arange(full.num_rows, dtype=np.int64))
        ext = Batch(list(full.names) + ["__dml_row"],
                    list(full.columns) + [rowcol])
        target = MemTable(tparts[-1], ext)
        base = _ResolverShim(self.db, params, self)
        db = self.db
        # the interception key is the RESOLVED identity — a same-named
        # table in another schema must hit the real catalog, not the
        # row-numbered target copy
        t_ident = db._split(tparts)
        t_ident = (t_ident[0].lower(), t_ident[1].lower())

        class _TargetShim(TableResolver):
            def resolve_table(self, parts):
                schema2, name2 = db._split(parts)
                if (schema2.lower(), name2.lower()) == t_ident:
                    return target
                return base.resolve_table(parts)

            def resolve_table_function(self, name, args):
                return base.resolve_table_function(name, args)

        # qualified: a self-join alias of the target table would carry
        # its own __dml_row copy and make the bare name ambiguous
        items = [ast.SelectItem(
            ast.ColumnRef([tparts[-1], "__dml_row"]), "__dml_row")]
        for k, e in enumerate(value_exprs):
            items.append(ast.SelectItem(e, f"__v{k}"))
        sel = ast.Select(
            items=items,
            from_=ast.JoinRef("cross", ast.NamedTable(list(tparts)),
                              extra_ref),
            where=where_ast)
        plan = Planner(_TargetShim(), params).plan_select(sel)
        out = plan.execute(ExecContext(self.settings, params,
                                       device=self.db.device))
        arr = out.column("__dml_row").data.astype(np.int64)
        uniq, first = np.unique(arr, return_index=True)
        vals = [out.columns[1 + k].take(first)
                for k in range(len(value_exprs))]
        return uniq, vals

    def _delete(self, st: ast.Delete, params: list) -> QueryResult:
        table = self._table_for_dml(st.table, "delete")
        if st.returning:
            self.db.resolve_table(st.table, "select")
        with self.db.quiesced([table]):
            full = table.full_batch()
            if st.using_ref is not None:
                rows, _ = self._dml_join(table, st.table, st.using_ref,
                                         st.where, [], params)
            elif st.where is None:
                rows = np.arange(full.num_rows, dtype=np.int64)
            else:
                scope = Scope.of(list(full.names),
                                 [c.type for c in full.columns],
                                 st.table[-1])
                planner = Planner(_ResolverShim(self.db, params, self),
                                  params)
                pred = ExprBinder(scope, params,
                                  planner=planner).bind(st.where)
                c = pred.eval(full)
                rows = np.flatnonzero(c.data.astype(bool) & c.valid_mask())
            n = len(rows)
            if st.returning:
                self._validate_returning(st.returning, table, params)
            pk = _pk_of(table)
            if pk:
                from .columnar import keyenc
                # encode ONLY the deleted rows' keys (O(k), not O(N))
                deleted_rows = full.take(rows)
                enc_del = keyenc.encode_key_columns(
                    [deleted_rows.column(c) for c in pk])
                del_op = ("delete_pk", None,
                          {"cols": list(pk), "keys": list(enc_del)})
            else:
                del_op = ("delete", None, rows)
            self._wal_commit(table, [del_op])
            mask = np.ones(full.num_rows, dtype=bool)
            mask[rows] = False
            deleted = full.take(rows) if st.returning else None
            table.replace(full.filter(mask))
        tag = f"DELETE {n}"
        if st.returning:
            return QueryResult(self._returning_batch(
                st.returning, table, deleted, params), tag)
        return QueryResult(Batch([], []), tag)

    def _update(self, st: ast.Update, params: list) -> QueryResult:
        """UPDATE = delete + re-append of the affected rows (matching the
        WAL replay transformation exactly, so recovered row order equals
        live row order — the reference does the same remove+insert in its
        search DML, duckdb_physical_search_update.*)."""
        table = self._table_for_dml(st.table, "update")
        if st.returning:
            self.db.resolve_table(st.table, "select")
        with self.db.quiesced([table]):
            full = table.full_batch()
            scope = Scope.of(list(full.names), [c.type for c in full.columns],
                             st.table[-1])
            planner = Planner(_ResolverShim(self.db, params, self), params)
            binder = ExprBinder(scope, params, planner=planner)
            join_vals = None
            if st.from_ref is not None:
                value_exprs = [e for _cn, e in st.assignments
                               if not isinstance(e, ast.DefaultMarker)]
                rows, jv = self._dml_join(table, st.table, st.from_ref,
                                          st.where, value_exprs, params)
                join_vals = iter(jv)
            elif st.where is not None:
                c = binder.bind(st.where).eval(full)
                mask = c.data.astype(bool) & c.valid_mask()
                rows = np.flatnonzero(mask)
            else:
                rows = np.arange(full.num_rows, dtype=np.int64)
            n = len(rows)
            if n == 0 and not st.returning:
                return QueryResult(Batch([], []), "UPDATE 0")
            updated = full.take(rows)
            new_cols = {}
            for col_name, e in st.assignments:
                if col_name not in full:
                    raise errors.SqlError(errors.UNDEFINED_COLUMN,
                                          f'column "{col_name}" does not exist')
                target_t = full.column(col_name).type
                if isinstance(e, ast.DefaultMarker):
                    dv, dvt = _default_typed(table, col_name)
                    new_cols[col_name] = _coerce(
                        Column.from_pylist([dv] * n, dvt), target_t) \
                        if dv is not None else \
                        Column.from_pylist([None] * n, target_t)
                    continue
                if join_vals is not None:
                    # evaluated in the joined scope, first match per row
                    new_cols[col_name] = _coerce(next(join_vals), target_t)
                    continue
                val = _coerce(binder.bind(e).eval(full), target_t)
                new_cols[col_name] = val.take(rows)
            upd_cols = [new_cols.get(nm, c)
                        for nm, c in zip(updated.names, updated.columns)]
            updated = Batch(list(updated.names), upd_cols)
            if st.returning:
                self._validate_returning(st.returning, table, params)
            _check_not_null(table, updated)
            _check_enums(self.db, table, updated)
            pk = _pk_of(table)
            del_op = ("delete", None, rows)
            if pk:
                from .columnar import keyenc
                from .search.pkindex import pk_index
                key_cols_u = [updated.column(c).to_pylist() for c in pk]
                _check_pk_not_null(pk, key_cols_u, updated.num_rows)
                # encode only the touched rows' keys (O(k)); the cached
                # sorted index answers the uniqueness probes in O(log N)
                old_rows = full.take(rows)
                enc_del = keyenc.encode_key_columns(
                    [old_rows.column(c) for c in pk])
                pk_lower = {c.lower() for c in pk}
                if any(a.lower() in pk_lower for a, _ in st.assignments):
                    # keys may change: new keys must be unique among
                    # themselves AND against the untouched rows
                    enc_upd = keyenc.encode_key_columns(
                        [updated.column(c) for c in pk])
                    idx = pk_index(table)
                    touched = set(int(r) for r in rows)
                    seen = set()
                    for i in range(updated.num_rows):
                        key = enc_upd[i]
                        hit = idx.get(key)
                        if (hit >= 0 and hit not in touched) or key in seen:
                            raise errors.SqlError(
                                "23505", "duplicate key value violates "
                                "unique constraint "
                                f"(key columns: {', '.join(pk)})")
                        seen.add(key)
                # PK remove filter: replay-robust against row order
                del_op = ("delete_pk", None,
                          {"cols": list(pk), "keys": list(enc_del)})
            self._wal_commit(table, [del_op, ("insert", updated, None)])
            # single-publish delete+reinsert: lock-free readers never see
            # the intermediate rows-removed state
            _apply_ops(table, [del_op, ("insert", updated, None)])
        tag = f"UPDATE {n}"
        if st.returning:
            return QueryResult(self._returning_batch(
                st.returning, table, updated, params), tag)
        return QueryResult(Batch([], []), tag)

    def _truncate(self, st: ast.Truncate) -> QueryResult:
        table = self._table_for_dml(st.table, "delete")
        with self.db.quiesced([table]):
            self._wal_commit(table, [("truncate", None, None)])
            table.replace(table.full_batch().slice(0, 0))
        return QueryResult(Batch([], []), "TRUNCATE TABLE")

    # -- session statements ------------------------------------------------

    def _persist_auth(self):
        if self.db.store is not None:
            auth = self.db.roles.to_meta()
            self.db.store.update_meta(
                lambda m: m.__setitem__("auth", auth))

    def _set(self, st: ast.SetStmt) -> QueryResult:
        try:
            if st.value == "DEFAULT":
                self.settings.reset(st.name)
            else:
                self.settings.set(st.name, st.value)
                if st.name == "sdb_faults":
                    faults.arm_from_spec(str(st.value))
        except KeyError as e:
            raise errors.SqlError("42704", str(e).strip("'\""))
        except ValueError as e:
            raise errors.SqlError(
                "22023", f'invalid value for parameter "{st.name}": {e}')
        return QueryResult(Batch([], []), "SET")

    def _show(self, st: ast.ShowStmt) -> QueryResult:
        if st.name == "tables":
            rows = self.db.table_list()
            b = Batch.from_pydict({
                "schema": [r[0] for r in rows],
                "name": [r[1] for r in rows],
                "kind": [r[2] for r in rows]})
            return QueryResult(b, f"SELECT {b.num_rows}")
        if st.name == "all":
            names = self.settings._registry.names()
            b = Batch.from_pydict({
                "name": names,
                "setting": [str(self.settings.get(n)) for n in names]})
            return QueryResult(b, f"SELECT {b.num_rows}")
        try:
            v = self.settings.get(st.name)
        except KeyError as e:
            raise errors.SqlError("42704", str(e).strip("'\""))
        b = Batch.from_pydict({st.name: [_setting_text(v)]})
        return QueryResult(b, "SHOW")

    def _txn(self, st: ast.Transaction) -> QueryResult:
        if st.action in ("savepoint", "release", "rollback_to"):
            return self._txn_savepoint_stmt(st)
        if st.action == "begin":
            if self.in_txn:
                # PG: WARNING, there is already a transaction in progress —
                # the open txn (and its failure state) is preserved
                return QueryResult(Batch([], []), "BEGIN")
            self.in_txn = True
            self.txn_failed = False
            self._txn_clear()
            return QueryResult(Batch([], []), "BEGIN")
        was_failed = self.txn_failed
        self.in_txn = False
        self.txn_failed = False
        if st.action == "commit" and not was_failed:
            try:
                self._txn_commit_writes()
                actions = self._txn_actions
            finally:
                self._txn_clear()
            for action, channel, payload in actions:
                if action == "notify":
                    self._apply_notify(channel, payload)
                else:
                    self._apply_listen(action, channel)
            return QueryResult(Batch([], []), "COMMIT")
        # ROLLBACK, or COMMIT of a failed txn (PG answers ROLLBACK)
        self._txn_clear()
        return QueryResult(Batch([], []), "ROLLBACK")

    def _txn_savepoint_stmt(self, st: ast.Transaction) -> QueryResult:
        """SAVEPOINT / RELEASE / ROLLBACK TO over the txn op buffer: a
        savepoint records each written table's op-count; rolling back
        truncates the op streams and rebuilds the working copies from the
        pins (and, per PG, un-fails an aborted transaction)."""
        name = (st.savepoint or "").lower()
        if not self.in_txn:
            raise errors.SqlError(
                "25P01", f"{st.action.upper().replace('_', ' ')} can only "
                "be used in transaction blocks")
        if st.action == "savepoint":
            if self.txn_failed:
                raise errors.SqlError(
                    errors.IN_FAILED_TRANSACTION,
                    "current transaction is aborted, commands ignored "
                    "until end of transaction block")
            self._txn_savepoints.append(
                (name, {k: len(w["ops"])
                        for k, w in self._txn_writes.items()},
                 len(self._txn_actions)))
            return QueryResult(Batch([], []), "SAVEPOINT")
        idx = next((i for i in range(len(self._txn_savepoints) - 1, -1, -1)
                    if self._txn_savepoints[i][0] == name), None)
        if idx is None:
            raise errors.SqlError(
                "3B001", f'savepoint "{st.savepoint}" does not exist')
        if st.action == "release":
            if self.txn_failed:
                # PG: only ROLLBACK TO may run in an aborted txn —
                # RELEASE would destroy the recovery point
                raise errors.SqlError(
                    errors.IN_FAILED_TRANSACTION,
                    "current transaction is aborted, commands ignored "
                    "until end of transaction block")
            # PG: releasing a savepoint also releases everything above it
            del self._txn_savepoints[idx:]
            return QueryResult(Batch([], []), "RELEASE")
        # rollback_to: truncate ops, rebuild working copies, un-fail
        marks = self._txn_savepoints[idx][1]
        self._txn_actions = \
            self._txn_actions[:self._txn_savepoints[idx][2]]
        del self._txn_savepoints[idx + 1:]
        for key, w in list(self._txn_writes.items()):
            keep = marks.get(key, 0)
            if len(w["ops"]) != keep:
                w["ops"] = w["ops"][:keep]
                pin = self._txn_pins[key]
                w["work"].replace(pin.full_batch())
                _apply_ops(w["work"], w["ops"])
            if not w["ops"]:
                # net-zero writes: drop the entry so COMMIT's conflict
                # check never 40001s on a table this txn no longer touches
                # (the pin stays for snapshot reads)
                del self._txn_writes[key]
        self.txn_failed = False
        return QueryResult(Batch([], []), "ROLLBACK")

    def _explain(self, st: ast.Explain, params: list,
                 sql_text: Optional[str] = None) -> QueryResult:
        fmt = getattr(st, "format", "text")
        if isinstance(st.inner, (ast.Select, ast.SetOp)):
            plan = self._plan(st.inner, params)
            if not st.analyze:
                if fmt == "json":
                    import json as _json

                    from .obs.trace import annotate_plan_json
                    lines = [_json.dumps(
                        [{"Plan": annotate_plan_json(plan, None)}],
                        indent=2)]
                    b = Batch.from_pydict({"QUERY PLAN": lines})
                    return QueryResult(b, f"SELECT {len(lines)}")
                lines = plan.explain()
            else:
                # ANALYZE always instruments (PG semantics), independent
                # of the serene_profile session setting. It also always
                # EXECUTES — the result cache is only consulted for the
                # `Result Cache:` report line (would this statement have
                # been served?) and fed by the instrumented run, so
                # EXPLAIN ANALYZE output is never a stale replay.
                from .cache.result import RESULT_CACHE
                from .obs.trace import QueryProfile, annotate_plan
                probe = RESULT_CACHE.begin(self, st.inner, params,
                                           sql_text)
                cache_line = None
                if probe is not None:
                    probe.prepare(plan)
                    if probe.cacheable:
                        cache_line = ("Result Cache: hit" if probe.peek()
                                      else "Result Cache: miss")
                prof = QueryProfile()
                # ANALYZE always accounts memory too (same PG-style
                # always-instrument rule as the profiler): the inner
                # plan gets its own accountant so the Memory lines key
                # on THIS plan's nodes — the statement-level accountant
                # (begun by execute_statement for the EXPLAIN wrapper)
                # keeps feeding stat_statements/progress
                from .obs.resources import MemoryAccountant
                macct = MemoryAccountant(sql_text or "EXPLAIN",
                                         pid=self._session_id)
                t0 = time.perf_counter()
                result = plan.execute(
                    ExecContext(self.settings, params, profile=prof,
                                mem=macct, device=self.db.device))
                elapsed = (time.perf_counter() - t0) * 1000
                if cache_line == "Result Cache: miss":
                    probe.store(result)
                if fmt == "json":
                    # machine-readable EXPLAIN ANALYZE: the annotated
                    # tree (rows, timings, prune counters, device/shard
                    # keys) as one JSON document, PG's FORMAT JSON shape
                    import json as _json

                    from .obs.trace import annotate_plan_json
                    doc: dict = {
                        "Plan": annotate_plan_json(plan, prof, macct),
                        "Execution Time": round(elapsed, 3),
                        "Rows Returned": result.num_rows,
                        "Peak Memory Bytes": macct.totals()[1],
                    }
                    if cache_line:
                        doc["Result Cache"] = \
                            cache_line.split(": ", 1)[1]
                    lines = [_json.dumps([doc], indent=2)]
                    b = Batch.from_pydict({"QUERY PLAN": lines})
                    return QueryResult(b, f"SELECT {len(lines)}")
                from .obs.resources import fmt_kb
                lines = annotate_plan(plan, prof, macct) + \
                    ([cache_line] if cache_line else []) + [
                    f"Execution Time: {elapsed:.3f} ms",
                    f"Peak Memory: {fmt_kb(macct.totals()[1])}",
                    f"Rows Returned: {result.num_rows}",
                ]
        elif isinstance(st.inner, (ast.Insert, ast.Update, ast.Delete)):
            if fmt == "json":
                raise errors.unsupported(
                    "EXPLAIN (FORMAT JSON) of DML statements")
            lines = self._explain_dml(st, params)
        else:
            raise errors.unsupported(
                f"EXPLAIN of {type(st.inner).__name__}")
        b = Batch.from_pydict({"QUERY PLAN": lines})
        return QueryResult(b, f"SELECT {len(lines)}")

    def _explain_dml(self, st: ast.Explain, params: list) -> list[str]:
        """EXPLAIN [ANALYZE] of INSERT/UPDATE/DELETE, PG's shape: the
        target operator line (`Insert on t`) with the source subplan
        under it when one exists; ANALYZE really executes the DML (side
        effects included, exactly like PG) and stamps the affected-row
        count and wall time on the target line."""
        inner = st.inner
        verb = type(inner).__name__              # Insert / Update / Delete
        schema, name = self.db._split(inner.table)
        target = name if schema == "main" else f"{schema}.{name}"
        lines = [f"{verb} on {target}"]
        if isinstance(inner, ast.Insert):
            if inner.query is not None:
                sub = self._plan(inner.query, params)
                lines += ["  ->  " + sub.explain()[0]] + \
                         ["  " + ln for ln in sub.explain()[1:]]
            elif inner.values is not None:
                lines.append(f"  ->  Values ({len(inner.values)} rows)")
        else:
            # UPDATE/DELETE source: plan the equivalent row-selection
            # SELECT so the subplan shows the real scan + pushed-down
            # filter (PG's shape); statements the planner can't express
            # this way (USING/FROM joins, etc.) keep the one-line plan
            try:
                src = ast.Select(
                    items=[ast.SelectItem(ast.Star())],
                    from_=ast.NamedTable(list(inner.table)),
                    where=inner.where)
                sub = self._plan(src, params)
                lines += ["  ->  " + sub.explain()[0]] + \
                         ["  " + ln for ln in sub.explain()[1:]]
            except errors.SqlError:
                pass
        if st.analyze:
            t0 = time.perf_counter()
            res = self._dispatch(inner, params)
            elapsed = (time.perf_counter() - t0) * 1000
            affected = _result_rows(res)
            lines[0] += (f" (actual time=0.000..{elapsed:.3f} "
                         f"rows={affected} loops=1)")
            lines.append(f"Execution Time: {elapsed:.3f} ms")
        return lines

    def _vacuum(self, st: ast.VacuumStmt) -> QueryResult:
        """VACUUM verbs (reference: SearchTable VACUUM refresh/compact/
        cleanup ops): checkpoint = snapshot + WAL GC; refresh = rebuild
        stale search indexes now."""
        targets: list[MemTable] = []
        if st.table is not None:
            t = self.db.resolve_table(st.table)
            if isinstance(t, MemTable):
                targets.append(t)
        else:
            with self.db.lock:
                for s in self.db.schemas.values():
                    targets.extend(t for t in s.tables.values()
                                   if isinstance(t, MemTable))
        verbs = set(st.verbs) or {"refresh"}
        for t in targets:
            if isinstance(t, StoredTable) and self.db.store is not None:
                # batch+tick must be captured atomically vs writers
                with self.db.quiesced([t]):
                    batch = t.full_batch()
                    tick = self.db.store.ticks.current()
                self.db.store.checkpoint_table(t.key, t.table_id, batch,
                                               tick)
            if verbs & {"refresh", "full"}:
                _refresh_indexes(self.db, t)
        return QueryResult(Batch([], []), "VACUUM")

    def _copy(self, st: ast.CopyStmt, params: list) -> QueryResult:
        from .utils.progress import REGISTRY as _progress
        if st.target in ("STDIN", "STDOUT"):
            raise errors.unsupported(
                f"COPY {st.target} is only available over the wire protocol")
        fmt = str(st.options.get("format", "csv")).lower()
        if st.direction == "from":
            table = self._table_for_dml(st.table)
            with _progress.track("COPY FROM"):
                return self._copy_from(st, table, fmt)
        # COPY TO
        if st.query is not None:
            full = self._run_select(st.query, [])
        else:
            provider = self.db.resolve_table(st.table)
            if self.in_txn:
                provider = self._txn_read_provider(provider)
            full = provider.full_batch(st.columns)
        with _progress.track("COPY TO", full.num_rows):
            if fmt == "parquet":
                # records export as PG (…) text — the physical JSON is a
                # private encoding and must not leak into interchange files
                _write_parquet(st.target, _records_as_text(full))
            elif fmt == "binary":
                from .columnar import pgcopy
                with open(st.target, "wb") as f:
                    for chunk in pgcopy.encode_full(full):
                        f.write(chunk)
            else:
                _write_csv(st.target, _records_as_text(full), st.options)
        return QueryResult(Batch([], []), f"COPY {full.num_rows}")

    def copy_in_data(self, st: ast.CopyStmt, data: bytes) -> QueryResult:
        """COPY ... FROM STDIN: parse the wire-fed payload (PG text format
        by default: tab-delimited, \\N nulls, backslash escapes; or csv)."""
        table = self._table_for_dml(st.table)
        seen = set()
        for c in st.columns or []:
            if c not in table.column_names:
                raise errors.SqlError(errors.UNDEFINED_COLUMN,
                                      f'column "{c}" does not exist')
            if c in seen:
                raise errors.SqlError(
                    "42701", f'column "{c}" specified more than once')
            seen.add(c)
        fmt = str(st.options.get("format", "text")).lower()
        target_names = st.columns or list(table.column_names)
        types = [table.column_types[table.column_names.index(c)]
                 for c in target_names]
        if fmt == "binary":
            from .columnar import pgcopy
            incoming = pgcopy.decode_to_batch(data, target_names, types)
            self._insert_batch(table, incoming)
            return QueryResult(Batch([], []), f"COPY {incoming.num_rows}")
        delim = str(st.options.get("delimiter",
                                   "," if fmt == "csv" else "\t"))
        null_s = str(st.options.get("null", "" if fmt == "csv" else "\\N"))
        text = data.decode("utf-8")
        rows = []
        is_csv = fmt == "csv"
        if is_csv:
            import csv as _csv
            import io as _io
            header = str(st.options.get("header", "false")).lower() in \
                ("true", "on", "1")
            rdr = _csv.reader(_io.StringIO(text), delimiter=delim)
            rows = [r for r in rdr if r]
            if header and rows:
                rows = rows[1:]
        else:
            lines = text.split("\n")
            if lines and lines[-1] == "":
                lines.pop()          # trailing newline, not a row
            for line in lines:
                if line == "\\.":
                    break            # end-of-data marker terminates input
                # raw split: null markers compare BEFORE unescaping so a
                # literal backslash-N value (escaped as \\N) round-trips
                rows.append(_copy_text_split_raw(line, delim))
        from .sql.binder import _cast_text_to

        def parse_chunk(chunk):
            cols_vals: list[list] = [[] for _ in target_names]
            for r in chunk:
                if len(r) != len(target_names):
                    raise errors.SqlError(
                        "22P04", f"row has {len(r)} columns, expected "
                                 f"{len(target_names)}")
                for k, raw in enumerate(r):
                    if raw == null_s:
                        cols_vals[k].append(None)
                        continue
                    val = raw if is_csv else _copy_text_unescape(raw)
                    if types[k].is_string:
                        cols_vals[k].append(val)
                    else:
                        cols_vals[k].append(_cast_text_to(val, types[k]))
            return Batch(list(target_names),
                         [Column.from_pylist(v, t)
                          for v, t in zip(cols_vals, types)])

        incoming = _parse_chunked(rows, parse_chunk, self.settings)
        self._insert_batch(table, incoming)
        return QueryResult(Batch([], []), f"COPY {incoming.num_rows}")

    def copy_out_data(self, st: ast.CopyStmt,
                      ) -> tuple[list[bytes], int, int]:
        """COPY ... TO STDOUT → (encoded rows, row count, column count):
        PG text format by default, or csv with the same options
        copy_in_data honors."""
        if st.query is not None:
            full = self._run_select(st.query, [])
        else:
            provider = self.db.resolve_table(st.table)
            if self.in_txn:
                provider = self._txn_read_provider(provider)
            full = provider.full_batch(st.columns)
        ncols = len(full.columns)
        fmt = str(st.options.get("format", "text")).lower()
        if fmt == "binary":
            from .columnar import pgcopy
            return pgcopy.encode_full(full), full.num_rows, ncols
        full = _records_as_text(full)
        cols = [c.to_pylist() for c in full.columns]
        if fmt == "csv":
            import csv as _csv
            import io as _io
            delim = str(st.options.get("delimiter", ","))
            null_s = str(st.options.get("null", ""))
            out = []
            for i in range(full.num_rows):
                buf = _io.StringIO()
                w = _csv.writer(buf, delimiter=delim, lineterminator="\n")
                w.writerow([null_s if v is None else v
                            for v in (col[i] for col in cols)])
                out.append(buf.getvalue().encode())
            return out, full.num_rows, ncols
        delim = str(st.options.get("delimiter", "\t"))
        null_s = str(st.options.get("null", "\\N"))
        out = []
        for i in range(full.num_rows):
            parts = []
            for v in (col[i] for col in cols):
                if v is None:
                    parts.append(null_s)
                else:
                    s = str(v)
                    s = s.replace("\\", "\\\\").replace("\t", "\\t") \
                         .replace("\n", "\\n").replace("\r", "\\r")
                    parts.append(s)
            out.append((delim.join(parts) + "\n").encode())
        return out, full.num_rows, ncols

    def _copy_from(self, st: ast.CopyStmt, table: MemTable,
                   fmt: str) -> QueryResult:
        if isinstance(st.target, str) and not st.target.startswith(
                ("http://", "https://", "s3://")) and \
                not os.path.exists(st.target):
            raise errors.SqlError(
                "58P01", f'could not open file "{st.target}" for reading: '
                         "No such file or directory")
        seen = set()
        for c in st.columns or []:
            if c not in table.column_names:
                raise errors.SqlError(errors.UNDEFINED_COLUMN,
                                      f'column "{c}" does not exist')
            if c in seen:
                raise errors.SqlError(
                    "42701", f'column "{c}" specified more than once')
            seen.add(c)
        names = st.columns or list(table.column_names)
        types = [table.column_types[table.column_names.index(c)]
                 for c in names]
        if fmt == "parquet":
            # parquet files carry column names: select by NAME so a
            # column-list subset maps correctly, never positionally
            full = ParquetTable(st.target).full_batch()
            missing = [c for c in names if c not in full]
            if missing:
                raise errors.SqlError(
                    errors.UNDEFINED_COLUMN,
                    f'column "{missing[0]}" not present in {st.target}')
            sub = Batch(names, [full.column(c) for c in names])
        elif fmt == "binary":
            from .columnar import pgcopy
            with open(st.target, "rb") as f:
                sub = pgcopy.decode_to_batch(f.read(), names, types)
        elif fmt in ("csv", "text"):
            # csv/text files are headerless positional data over exactly
            # the listed columns (PG COPY semantics)
            sub = _read_csv(st.target, names, types, st.options,
                            self.settings)
        else:
            raise errors.unsupported(f"COPY format {fmt}")
        self._insert_batch(table, sub)
        return QueryResult(Batch([], []), f"COPY {sub.num_rows}")

    def _describe_returning(self, st, params: list):
        """(names, types) of a DML RETURNING clause without executing —
        bound against the target table's schema (Describe support)."""
        provider = self.db.resolve_table(st.table)
        scope = Scope.of(list(provider.column_names),
                         list(provider.column_types), provider.name)
        binder = ExprBinder(scope, params)
        names, types = [], []
        for it in st.returning:
            if isinstance(it.expr, ast.Star):
                for c in scope.columns:
                    names.append(c.name)
                    types.append(c.type)
                continue
            b = binder.bind(it.expr)
            names.append(it.alias or _default_returning_name(it.expr))
            types.append(b.type)
        return names, types

    def _validate_returning(self, items, table: MemTable, params: list):
        """Bind RETURNING against the target schema BEFORE mutating:
        a bad reference must abort the statement atomically, never after
        the WAL commit. (Join-table columns in RETURNING are not
        supported — they fail here, pre-mutation.)"""
        scope = Scope.of(list(table.column_names),
                         list(table.column_types), table.name)
        binder = ExprBinder(scope, params)
        for it in items:
            if not isinstance(it.expr, ast.Star):
                binder.bind(it.expr)

    def _returning_batch(self, items, table: MemTable, affected: Batch,
                         params: list) -> Batch:
        """RETURNING evaluation over the affected rows (PG: the new row
        state for INSERT/UPDATE, the old row for DELETE)."""
        scope = Scope.of(list(affected.names),
                         [c.type for c in affected.columns], table.name)
        binder = ExprBinder(scope, params)
        names, cols = [], []
        for it in items:
            if isinstance(it.expr, ast.Star):
                for c in scope.columns:
                    names.append(c.name)
                    cols.append(affected.columns[c.index])
                continue
            b = binder.bind(it.expr)
            names.append(it.alias or _default_returning_name(it.expr))
            cols.append(b.eval(affected))
        return Batch(names, cols)

    def _insert_batch(self, table: MemTable, incoming: Batch) -> Batch:
        with table.write_lock:
            aligned = _align_to_schema(table, incoming)
            _check_not_null(table, aligned)
            _check_enums(self.db, table, aligned)
            pk = _pk_of(table)
            if pk:
                from .columnar import keyenc
                from .search.pkindex import pk_extend, pk_index
                key_cols = [aligned.column(c).to_pylist() for c in pk]
                _check_pk_not_null(pk, key_cols, aligned.num_rows)
                idx = pk_index(table)
                enc = keyenc.encode_key_columns(
                    [aligned.column(c) for c in pk])
                if len(enc) and (idx.contains_any(enc).any() or
                                 len(set(enc)) != len(enc)):
                    raise errors.SqlError(
                        "23505", "duplicate key value violates "
                        "unique constraint "
                        f"(key columns: {', '.join(pk)})")
                n_before = table.row_count()
                base_ver = table.data_version
                self._wal_commit(table, [("insert", aligned, None)])
                _append_rows(table, aligned)
                pk_extend(table, enc, n_before, base_ver)
                self._ingest_observe(table, aligned)
                return aligned
            # give way to any mutator waiting to quiesce this table —
            # without this gate a sustained insert stream starves it
            while getattr(table, "_quiesce_waiters", 0):
                table.pub_cond.wait(timeout=5)
            table._inflight = getattr(table, "_inflight", 0) + 1
            entry = {"tick": None, "done": False, "ready": False,
                     "batch": None}
            if not hasattr(table, "_pub_entries"):
                table._pub_entries = []
            table._pub_entries.append(entry)
        # parallel-ingest fast path (no PK to reserve): the WAL encode +
        # group-commit fsync run OUTSIDE the DML lock so concurrent bulk
        # INSERTs overlap their compression and share fsyncs (reference:
        # ParallelSink per-thread ChunkWriters,
        # duckdb_physical_search_insert.cpp:107-369). Publishes are
        # SEQUENCED BY TICK below: DELETE/UPDATE WAL records address rows
        # positionally, so live row order must equal replay (tick) order.
        # on_tick runs inside the WAL queue lock, so once this commit
        # knows its tick every earlier tick is already recorded in
        # _pub_entries; still-unticked entries are guaranteed LATER.
        try:
            self._wal_commit(table, [("insert", aligned, None)],
                             on_tick=lambda t: entry.__setitem__("tick", t))
            with table.write_lock:
                if entry["tick"] is None:
                    # no WAL behind this table (in-memory db, txn working
                    # copy): sequence publishes by arrival under the write
                    # lock instead of by WAL tick. A table never mixes the
                    # two domains — it either always logs or never does.
                    table._pub_seq = getattr(table, "_pub_seq", 0) + 1
                    entry["tick"] = table._pub_seq
                entry["batch"] = aligned
                entry["ready"] = True
                table.pub_cond.notify_all()
                if _group_commit_enabled():
                    # coalesced publication: the lowest-ticked committed
                    # entry publishes EVERY contiguous-by-tick ready entry
                    # in one append (one version bump / cache invalidation
                    # per window); followers wake marked done
                    while not entry["done"]:
                        run = _publish_run(table, entry)
                        if run is None:
                            table.pub_cond.wait(timeout=5)
                            continue
                        table.append_batches([e["batch"] for e in run])
                        for e in run:
                            e["done"] = True
                            e["batch"] = None
                        table.pub_cond.notify_all()
                else:
                    while any(e is not entry and not e["done"]
                              and e["tick"] is not None
                              and entry["tick"] is not None
                              and e["tick"] < entry["tick"]
                              for e in table._pub_entries):
                        table.pub_cond.wait(timeout=5)
                    _append_rows(table, aligned)
                    entry["done"] = True
                    table.pub_cond.notify_all()
        finally:
            with table.write_lock:
                entry["done"] = True
                try:
                    table._pub_entries.remove(entry)
                except ValueError:
                    pass
                table._inflight -= 1
                table.pub_cond.notify_all()
        self._ingest_observe(table, aligned)
        return aligned

    def _ingest_observe(self, table: MemTable, aligned: Batch) -> None:
        """Write-path accounting + background-maintenance wakeup: count
        the appended rows/bytes and, when the table carries indexes, wake
        the maintenance ticker so the delta range becomes a segment off
        the query path (the append 'enqueues' its delta implicitly —
        [indexed_rows, n_rows) of every stale index)."""
        metrics.INGEST_BATCHES.add()
        metrics.INGEST_DOCS.add(aligned.num_rows)
        nbytes = 0
        for col in aligned.columns:
            nbytes += int(col.data.nbytes)
            if col.validity is not None:
                nbytes += int(col.validity.nbytes)
            if col.dictionary is not None:
                nbytes += sum(len(str(s)) for s in col.dictionary)
        metrics.INGEST_BYTES.add(nbytes)
        mm = self.db.maintenance
        if mm is not None and getattr(table, "indexes", None):
            mm.notify_append()

    def _wal_commit(self, table: MemTable, ops: list[tuple], on_tick=None):
        """Durably log (kind, batch, rows) ops for a stored table before the
        in-memory publish (WAL-then-apply, reference §3.4). Inside a txn
        the working copy buffers the ops; COMMIT logs them atomically."""
        key = getattr(table, "_txn_key", None)
        if key is not None:
            self._txn_writes[key]["ops"].extend(ops)
            return
        if self.db.store is None or not isinstance(table, StoredTable):
            return
        from .storage.wal import WalOp
        wal_ops = [WalOp(table.key, kind, batch, rows)
                   for kind, batch, rows in ops]
        self.db.store.commit(wal_ops, on_tick=on_tick)


def _group_commit_enabled() -> bool:
    from .utils.config import REGISTRY
    try:
        return bool(REGISTRY.get_global("serene_group_commit"))
    except KeyError:
        return True


def _publish_run(table: MemTable, entry: dict):
    """The group-commit publication window leader election (called under
    the table's write_lock): returns the tick-ordered run of committed
    entries THIS entry must publish — itself plus every later contiguous
    ready entry — or None when a lower-ticked commit is still pending
    (that commit's thread leads, and may publish this entry too).
    Correctness leans on the WAL queue-lock invariant: tick order ==
    enqueue order, and an entry with tick None will be assigned a LATER
    tick than every entry already ticked, so it can never belong before
    this run."""
    pend = [e for e in table._pub_entries
            if not e["done"] and e["tick"] is not None]
    pend.sort(key=lambda e: e["tick"])
    if not pend or pend[0] is not entry:
        return None
    run = []
    for e in pend:
        if not e["ready"]:
            break
        run.append(e)
    return run


def _apply_ops(table: MemTable, ops: list[tuple]) -> None:
    """THE op-replay transformation, shared by WAL recovery, txn commit
    and UPDATE/upsert so committed state always matches recovered state.
    All ops compose on a scratch copy and land in ONE publish: lock-free
    readers can never observe a delete-without-reinsert intermediate
    state of a multi-op statement."""
    scratch = MemTable(table.name, table.full_batch())
    for kind, batch, rows in ops:
        if kind == "insert":
            scratch.append_batch(batch)
        elif kind == "delete":
            full = scratch.full_batch()
            mask = np.ones(full.num_rows, dtype=bool)
            rows = np.asarray(rows, dtype=np.int64)
            mask[rows[rows < full.num_rows]] = False
            scratch.replace(full.filter(mask))
        elif kind == "delete_pk":
            # PK-based remove filter: resolve key bytes against the
            # CURRENT state — identical live and in replay, whatever the
            # physical row order (reference: search_remove_filter.*)
            full = scratch.full_batch()
            mask = np.ones(full.num_rows, dtype=bool)
            idx = None
            if full is table.full_batch():
                # first op of the statement: the provider's cached sorted
                # index covers exactly this batch — O(k log N) resolution
                from .search.pkindex import pk_index
                try:
                    idx = pk_index(table)
                except Exception:
                    idx = None
                if idx is not None and idx.pk_cols != list(rows["cols"]):
                    idx = None
            if idx is not None:
                mask[idx.lookup_rows(rows["keys"])] = False
            else:
                from .columnar import keyenc
                cur = keyenc.encode_key_columns(
                    [full.column(c) for c in rows["cols"]])
                kset = set(rows["keys"])
                mask = np.asarray([k not in kset for k in cur],
                                  dtype=bool)
            scratch.replace(full.filter(mask))
        elif kind == "truncate":
            scratch.replace(scratch.full_batch().slice(0, 0))
    rows_preserved = all(kind == "insert" for kind, _, _ in ops)
    table.replace(scratch.full_batch(), rows_preserved=rows_preserved)


def _pk_of(table) -> list:
    return (getattr(table, "table_meta", None) or {}).get(
        "primary_key") or []


def _check_pk_not_null(pk: list, key_cols: list, n: int):
    for i in range(n):
        for c, kc in zip(pk, key_cols):
            if kc[i] is None:
                raise errors.SqlError(
                    "23502", f'null value in column "{c}" violates '
                    "not-null constraint")


def _default_returning_name(e: ast.Expr) -> str:
    if isinstance(e, ast.ColumnRef):
        return e.parts[-1]
    if isinstance(e, ast.FuncCall):
        return e.name
    return "?column?"


def _default_typed(table: MemTable, name: str):
    """(value, bound SqlType|None) of a column's DEFAULT — the type matters
    for epoch-int families (DATE/TIMESTAMP/INTERVAL) where the raw int
    would otherwise re-infer as BIGINT and then refuse the cast."""
    d = (getattr(table, "table_meta", None) or {}).get("defaults", {})
    e = d.get(name)
    if e is None:
        return None, None
    from .sql.binder import ExprBinder, Scope
    b = ExprBinder(Scope([]), [])
    one = Batch(["__d"], [Column.from_pylist([0])])
    bound = b.bind(e)
    return bound.eval(one).decode(0), bound.type


def _default_column(table: MemTable, name: str, n: int):
    """Evaluate a volatile DEFAULT once per row: bind ONCE, evaluate over
    an n-row dummy batch (row-vectorized impls like nextval() assign per
    row)."""
    d = (getattr(table, "table_meta", None) or {}).get("defaults", {})
    e = d.get(name)
    from .sql.binder import ExprBinder, Scope
    bound = ExprBinder(Scope([]), []).bind(e)
    rows = Batch(["__d"], [Column.from_pylist([0] * n)])
    return bound.eval(rows), bound.type


def _default_is_volatile(table: MemTable, name: str) -> bool:
    """Defaults like nextval()/random() must evaluate once PER ROW (PG);
    constant defaults evaluate once per statement. now() is deliberately
    absent: PG keeps it statement-stable."""
    d = (getattr(table, "table_meta", None) or {}).get("defaults", {})
    e = d.get(name)
    if e is None:
        return False
    _VOLATILE = {"nextval", "random", "gen_random_uuid",
                 "clock_timestamp", "uuid_generate_v4"}

    def walk(n) -> bool:
        if isinstance(n, ast.FuncCall):
            if n.name.lower() in _VOLATILE:
                return True
            return any(walk(a) for a in n.args)
        for attr in ("operand", "left", "right", "expr"):
            c = getattr(n, attr, None)
            if isinstance(c, ast.Expr) and walk(c):
                return True
        args = getattr(n, "args", None)
        if isinstance(args, list) and any(
                isinstance(a, ast.Expr) and walk(a) for a in args):
            return True
        return False
    return walk(e)


def _check_enums(db: "Database", table: MemTable, aligned: Batch):
    """Enum-typed columns accept only their declared labels (22P02).
    Dictionary-encoded columns validate O(unique labels): only the
    dictionary entries actually referenced by valid rows are checked."""
    enums = (getattr(table, "table_meta", None) or {}).get("enums") or {}
    for cname, tname in enums.items():
        if cname not in aligned:
            continue
        try:
            _, labels_list = db.resolve_type_name(tname)
        except Exception:
            continue
        if labels_list is None:
            continue        # domain over a plain base: nothing to check
        labels = set(labels_list)
        col = aligned.column(cname)
        if col.dictionary is not None:
            codes = col.data
            if col.validity is not None:
                codes = codes[col.valid_mask()]
            for code in np.unique(codes):
                v = col.dictionary[int(code)]
                if v not in labels:
                    raise errors.SqlError(
                        "22P02",
                        f'invalid input value for enum {tname}: "{v}"')
            continue
        for v in col.to_pylist():
            if v is not None and v not in labels:
                raise errors.SqlError(
                    "22P02",
                    f'invalid input value for enum {tname}: "{v}"')


def _check_not_null(table: MemTable, aligned: Batch):
    """Enforce NOT NULL column constraints (PG 23502)."""
    nn = (getattr(table, "table_meta", None) or {}).get("not_null", [])
    for name in nn:
        if name not in aligned.names:
            continue
        col = aligned.column(name)
        if col.validity is not None and not col.valid_mask().all():
            raise errors.SqlError(
                "23502", f'null value in column "{name}" of relation '
                         f'"{table.name}" violates not-null constraint')


def _align_to_schema(table: MemTable, incoming: Batch) -> Batch:
    """Project incoming rows onto the table schema: coerce types, fill
    missing columns with their DEFAULT (NULL when none). The aligned batch
    is what goes to the WAL, so replay needs no re-coercion."""
    cols = []
    for name, t in zip(table.column_names, table.column_types):
        if name in incoming.names:
            cols.append(_coerce(incoming.column(name), t))
        elif _default_is_volatile(table, name):
            # nextval()-style defaults: one evaluation PER ROW (PG),
            # bound once and vectorized over the row count
            col, _dvt = _default_column(table, name, incoming.num_rows)
            cols.append(_coerce(col, t))
        else:
            dv, dvt = _default_typed(table, name)
            cols.append(_coerce(
                Column.from_pylist([dv] * incoming.num_rows, dvt), t)
                if dv is not None else
                Column.from_pylist([None] * incoming.num_rows, t))
    return Batch(list(table.column_names), cols)


def _append_rows(table: MemTable, aligned: Batch) -> None:
    table.append_batch(aligned)


def _refresh_indexes(db: Database, table: MemTable) -> None:
    """Refresh any index whose data_version is stale (the refresh leg of
    the reference's RefreshLoop, task.cpp:237-343): appends publish a new
    segment, mutations trigger the rebuild leg, and segment tiers at the
    cap run the merge ladder — this is the maintenance/VACUUM entry, so
    compaction happens HERE (merge=True), off the query path."""
    from .search.index import _repair, needs_merge, refresh_index
    for name, idx in list(getattr(table, "indexes", {}).items()):
        stale = idx.data_version != table.data_version
        if stale or needs_merge(idx):
            # shares the per-provider rebuild lock + pre-build version stamp
            # with the read-repair path so concurrent repairs can't race
            _repair(table, name, idx,
                    lambda cur: refresh_index(table, cur),
                    force=not stale)


def _coerce(col: Column, target: dt.SqlType) -> Column:
    if col.type == target or col.type.id is dt.TypeId.NULL:
        if col.type.id is dt.TypeId.NULL and target.id is not dt.TypeId.NULL:
            return Column.from_pylist([None] * len(col), target)
        return col
    return cast_column(col, target)


def _copy_text_split_raw(line: str, delim: str) -> list[str]:
    """Split one PG COPY text-format line into RAW (still-escaped) fields:
    escape pairs are kept verbatim so the null-marker comparison happens
    before unescaping (PG semantics — a literal backslash-N survives)."""
    out = []
    cur = []
    i = 0
    while i < len(line):
        c = line[i]
        if c == "\\" and i + 1 < len(line):
            cur.append(line[i:i + 2])
            i += 2
            continue
        if c == delim:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    out.append("".join(cur))
    return out


def _copy_text_unescape(raw: str) -> str:
    out = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "\\" and i + 1 < len(raw):
            nxt = raw[i + 1]
            out.append({"t": "\t", "n": "\n", "r": "\r",
                        "\\": "\\"}.get(nxt, nxt))
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _setting_text(v) -> str:
    if isinstance(v, bool):
        return "on" if v else "off"
    return str(v)


def _inline_view(sel, view: ViewDef):
    """Replace references to the view with a subquery ref — in every
    Select leaf of the statement (set-op arms included) and in CTE
    bodies, so a view used anywhere in the query resolves instead of
    spinning _plan's inline-retry loop."""
    def rewrite(ref: ast.TableRef) -> ast.TableRef:
        if isinstance(ref, ast.NamedTable) and \
                ref.parts[-1].lower() == view.name.lower():
            return ast.SubqueryRef(view.query, ref.alias or view.name)
        if isinstance(ref, ast.JoinRef):
            ref.left = rewrite(ref.left)
            ref.right = rewrite(ref.right)
        if isinstance(ref, ast.SubqueryRef):
            # view-over-view: an earlier inlining produced this subquery;
            # the reference to replace now lives inside it
            _rewrite_leaves(ref.query)
        return ref

    def _rewrite_leaves(q) -> None:
        """Rewrite from_ of every Select leaf under q (Select|SetOp),
        and recurse into WITH bodies."""
        stack = [q]
        while stack:
            node = stack.pop()
            for body in getattr(node, "ctes", {}).values():
                stack.append(body.query if isinstance(body, ast.CteDef)
                             else body)
            if isinstance(node, ast.SetOp):
                stack.append(node.left)
                stack.append(node.right)
            elif getattr(node, "from_", None) is not None:
                node.from_ = rewrite(node.from_)

    import copy
    sel2 = copy.deepcopy(sel)
    _rewrite_leaves(sel2)
    return sel2


#: rows per COPY/CSV parse chunk — fixed (worker-count independent) so
#: the chunk split, and with it every parse error and dictionary merge,
#: is deterministic
COPY_PARSE_CHUNK_ROWS = 16384


def _parse_chunked(rows: list, parse_chunk, settings) -> Batch:
    """Chunk-parallel ingest parsing (reference ParallelSink analog:
    per-thread sink writers building column fragments, merged in order).
    parse_chunk(list-of-raw-rows) → Batch; chunks concatenate in row
    order so the result is identical to one serial parse. With a worker
    cap of 1 the whole input parses in one pass — per-chunk dictionary
    encodes + a merge would be pure overhead with zero parallelism."""
    from .parallel.pool import parallel_map, session_workers
    if len(rows) <= COPY_PARSE_CHUNK_ROWS or session_workers(settings) <= 1:
        return parse_chunk(rows)
    chunks = [rows[i:i + COPY_PARSE_CHUNK_ROWS]
              for i in range(0, len(rows), COPY_PARSE_CHUNK_ROWS)]
    return concat_batches(parallel_map(settings, parse_chunk, chunks))


def _read_csv(path: str, names: list, types: list, options: dict,
              settings=None) -> Batch:
    import csv as _csv
    delim = str(options.get("delimiter", ","))
    header = str(options.get("header", "false")).lower() in ("true", "on", "1")
    with open(path, newline="") as f:
        rows = list(_csv.reader(f, delimiter=delim))
    if header and rows:
        rows = rows[1:]

    def parse_chunk(chunk):
        from .sql.binder import _cast_text_to
        cols = []
        for k, (nm, t) in enumerate(zip(names, types)):
            vals = []
            for r in chunk:
                raw = r[k] if k < len(r) else ""
                if raw == "" or raw == "\\N":
                    vals.append(None)
                else:
                    vals.append(raw if t.is_string
                                else _cast_text_to(raw, t))
            cols.append(Column.from_pylist(vals, t))
        return Batch(list(names), cols)

    return _parse_chunked(rows, parse_chunk, settings)


def _records_as_text(batch: Batch) -> Batch:
    """Record columns render as PG (…) text for text/csv COPY output
    (binary keeps the record codec; reference: record_out)."""
    from .columnar import dtypes as _dt
    from .columnar.pgcopy import record_text
    from .sql.expr import make_string_column
    if not any(c.type.id is _dt.TypeId.RECORD for c in batch.columns):
        return batch
    cols = []
    for c in batch.columns:
        if c.type.id is _dt.TypeId.RECORD:
            vals = [None if v is None else record_text(str(v))
                    for v in c.to_pylist()]
            import numpy as _np
            validity = _np.asarray([v is not None for v in vals])
            cols.append(make_string_column(
                _np.asarray(["" if v is None else v for v in vals],
                            dtype=object),
                None if validity.all() else validity))
        else:
            cols.append(c)
    return Batch(list(batch.names), cols)


def _write_csv(path: str, batch: Batch, options: dict):
    import csv as _csv
    delim = str(options.get("delimiter", ","))
    header = str(options.get("header", "false")).lower() in ("true", "on", "1")
    with open(path, "w", newline="") as f:
        w = _csv.writer(f, delimiter=delim)
        if header:
            w.writerow(batch.names)
        for row in batch.rows():
            w.writerow(["" if v is None else v for v in row])


def _write_parquet(path: str, batch: Batch):
    import pyarrow as pa
    import pyarrow.parquet as pq
    arrays = []
    for c in batch.columns:
        vals = c.to_pylist()
        arrays.append(pa.array(vals))
    pq.write_table(pa.table(dict(zip(batch.names, arrays))), path)
