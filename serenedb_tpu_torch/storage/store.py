"""Copied from serenedb_tpu/storage/store.py (pickled ASTs cross between
the two packages: `dumps_ast`, `loads_ast`; checkpoints of a table are
serialized and never move its cursor back).

Durable store: data directory, catalog persistence, table snapshots.

Reference analog: server/catalog/store/ (definitions persisted transactional
via the __sdb_store DuckDB file; SURVEY.md §2.4) + the checkpoint/WAL split
of §5.4: two durability domains — (1) catalog + table *snapshots*
(parquet files + an atomically-replaced catalog.json), and (2) the
per-database WAL (storage/wal.py) holding everything since each table's
checkpoint tick. Recovery = snapshots + delta replay.

Layout:
    <datadir>/catalog.json        definitions + per-table checkpoint ticks
    <datadir>/tables/<id>.parquet table snapshots (written at checkpoint)
    <datadir>/wal/*.wal           commit records since the checkpoints
    <datadir>/LOCK                single-process lockfile
"""

from __future__ import annotations

import base64
import io
import json
import os
import pickle
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.arrow_io import (read_parquet_snapshot,
                                 write_parquet_snapshot)
from ..columnar.column import Batch, Column
from ..utils import faults, log
from ..utils.ticks import TickServer
from .wal import CommitRecord, SearchDbWal, WalOp


class Store:
    def __init__(self, path: str):
        # the snapshots and the WAL's payloads are Arrow: fail before the
        # data directory is touched when the package is missing
        from ..columnar.arrow_io import require_pyarrow
        require_pyarrow()
        self.path = path
        os.makedirs(path, exist_ok=True)
        os.makedirs(os.path.join(path, "tables"), exist_ok=True)
        self._lockfile = os.path.join(path, "LOCK")
        self._acquire_lock()
        self.catalog_path = os.path.join(path, "catalog.json")
        self.wal = SearchDbWal(os.path.join(path, "wal"))
        self.ticks = TickServer()
        # RLock: meta mutations + save_meta happen from connection threads
        # AND the maintenance thread; all must serialize on this lock
        self._lock = threading.RLock()
        self._checkpoint_lock = threading.Lock()
        self.meta: dict = {"next_table_id": 1, "schemas": ["main"],
                           "tables": {}, "views": {}, "indexes": {}}
        # a crash between DROP's tombstone rename and the maintenance GC
        # leaves .dropped files — reclaim them on boot
        self.gc_tombstones()

    def _acquire_lock(self):
        # datadir lockfile (reference: libs/basics lockfile)
        if os.path.exists(self._lockfile):
            try:
                pid = int(open(self._lockfile).read().strip() or 0)
            except ValueError:
                pid = 0
            if pid and _pid_alive(pid):
                raise errors.SqlError(
                    "55000", f"data directory {self.path} is locked by "
                             f"running process {pid}")
        with open(self._lockfile, "w") as f:
            f.write(str(os.getpid()))

    def release(self):
        self.wal.close()
        try:
            os.remove(self._lockfile)
        except OSError:
            pass

    # -- catalog persistence ------------------------------------------------

    def load_meta(self) -> dict:
        if os.path.exists(self.catalog_path):
            with open(self.catalog_path) as f:
                self.meta = json.load(f)
        return self.meta

    def save_meta(self) -> None:
        """Atomic catalog write: tmp + fsync + rename (the definitions
        equivalent of the reference's transactional WriteContext batches)."""
        faults.if_failure("catalog_write_error")
        faults.crash_if_armed("crash_before_catalog_write")
        with self._lock:
            tmp = self.catalog_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.meta, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.catalog_path)
        faults.crash_if_armed("crash_after_catalog_write")

    def update_meta(self, mutator) -> None:
        """Serialize a meta mutation + save against concurrent writers
        (connection DDL vs. the maintenance checkpoint thread)."""
        with self._lock:
            mutator(self.meta)
            self.save_meta()

    def new_table_id(self) -> int:
        with self._lock:
            tid = self.meta["next_table_id"]
            self.meta["next_table_id"] = tid + 1
            return tid

    # -- snapshots -----------------------------------------------------------

    def snapshot_path(self, table_id: int) -> str:
        return os.path.join(self.path, "tables", f"{table_id}.parquet")

    def write_snapshot(self, table_id: int, batch: Batch) -> None:
        path = self.snapshot_path(table_id)
        tmp = path + ".tmp"
        write_parquet_snapshot(tmp, batch)
        os.replace(tmp, path)

    def read_snapshot(self, table_id: int,
                      names: list[str],
                      types: list[dt.SqlType]) -> Batch:
        path = self.snapshot_path(table_id)
        if not os.path.exists(path):
            from ..exec.plan import empty_batch
            return empty_batch(names, types)
        batch = read_parquet_snapshot(path)
        # re-stamp logical types the physical snapshot can't carry
        # (ARRAY/RECORD as JSON text, INTERVAL as int64 micros, reg* as
        # int64 oids): the catalog's declared type wins over inference
        _RESTAMP = (dt.TypeId.ARRAY, dt.TypeId.RECORD, dt.TypeId.INTERVAL,
                    dt.TypeId.OID, dt.TypeId.REGCLASS, dt.TypeId.REGTYPE,
                    dt.TypeId.REGPROC, dt.TypeId.REGNAMESPACE)
        for name, t in zip(names, types):
            if t.id in _RESTAMP and name in batch and \
                    batch.column(name).type != t:
                batch.column(name).type = t
        return batch

    # -- async drops (reference: server/catalog/drop_task.cpp — the DROP
    # statement only tombstones data files; a background task reclaims
    # them, so large drops never stall the DDL path) -----------------------

    def tombstone_snapshot(self, table_id: int) -> None:
        """Rename the snapshot to a .dropped tombstone (atomic, O(1));
        gc_tombstones() reclaims it from the maintenance loop."""
        path = self.snapshot_path(table_id)
        try:
            os.replace(path, f"{path}.dropped")
        except OSError:
            pass   # no snapshot yet (never checkpointed) — nothing to do

    def gc_tombstones(self) -> int:
        """Delete tombstoned snapshots; returns the number reclaimed.
        Also called at startup, so tombstones from a crash between DROP
        and GC are reclaimed on the next boot."""
        tables_dir = os.path.join(self.path, "tables")
        n = 0
        try:
            entries = os.listdir(tables_dir)
        except OSError:
            return 0
        for name in entries:
            if name.endswith(".dropped"):
                try:
                    os.remove(os.path.join(tables_dir, name))
                    n += 1
                except OSError:
                    pass
        return n

    # -- commit / checkpoint --------------------------------------------------

    def commit(self, ops: list[WalOp], on_tick=None) -> int:
        """Durably log one commit; returns its tick. The caller applies the
        ops to memory AFTER this returns (WAL-then-publish, §3.4). Tick
        assignment happens inside the WAL's group-commit queue so WAL file
        order always matches tick order."""
        return self.wal.commit_ops(ops, self.ticks, on_tick=on_tick)

    def checkpoint_table(self, key: str, table_id: int, batch: Batch,
                         tick: int) -> None:
        """Snapshot a table and advance its checkpoint cursor to `tick`.
        The caller must capture (batch, tick) atomically under the database
        DML lock — a tick read after the batch would let a concurrent commit
        land in the gap and be skipped on recovery. Sealed WAL segments
        below the min cursor become garbage."""
        # one checkpoint at a time, and never back: a VACUUM and the
        # maintenance thread may both checkpoint a table, and an older
        # snapshot landing after a newer one's WAL GC would lose the
        # commits between the two ticks
        with self._checkpoint_lock:
            with self._lock:
                entry = self.meta["tables"].get(key)
                if entry is not None and \
                        entry.get("checkpoint_tick", 0) > tick:
                    return
            self.write_snapshot(table_id, batch)
            with self._lock:
                entry = self.meta["tables"].get(key)
                if entry is not None:
                    entry["checkpoint_tick"] = tick
                self.save_meta()
        self.gc()

    def gc(self) -> int:
        with self._lock:
            ticks = [t.get("checkpoint_tick", 0)
                     for t in self.meta["tables"].values()]
        if not ticks:
            return 0
        return self.wal.gc(min(ticks))


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def serialize_type(t: dt.SqlType) -> str:
    # "ELEM[]" for arrays so the element type round-trips through boot
    return str(t)


def table_def(name_key: str, table_id: int, names: list[str],
              types: list[dt.SqlType], meta: dict, start_tick: int) -> dict:
    """start_tick must be the store's current tick at creation: a freshly
    created table must never replay WAL records of an earlier same-named
    (dropped) table."""
    return {
        "id": table_id,
        "columns": [{"name": n, "type": serialize_type(t)}
                    for n, t in zip(names, types)],
        "engine": meta.get("engine", "columnar"),
        "options": meta.get("options", {}),
        "primary_key": meta.get("primary_key", []),
        "not_null": meta.get("not_null", []),
        # DEFAULT expressions persist as pickled ASTs (same encoding as
        # view definitions)
        "defaults": {n: dumps_ast(e)
                     for n, e in (meta.get("defaults") or {}).items()},
        "tokenizers": meta.get("tokenizers", {}),
        "enums": meta.get("enums", {}),
        "checkpoint_tick": start_tick,
    }


# -- pickled ASTs (view definitions, column DEFAULTs) ------------------------
#
# catalog.json holds them as base64 pickles, whose class references name
# a package. Both packages keep the same AST classes at the same module
# paths, so this one writes the reference's names and reads either
# package's: a data directory opens in both.

_PKG = __name__.split(".")[0]
_REF_PKG = "serenedb_tpu"


class _AstPickler(pickle._Pickler):
    """Writes this package's classes under the reference's module names
    (the pure-Python pickler: the C one gives no hook for a global's
    name)."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", None) or ""
        if module == _PKG or module.startswith(_PKG + "."):
            self.save(_REF_PKG + module[len(_PKG):])
            self.save(name or obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _AstUnpickler(pickle.Unpickler):
    """Resolves the reference's module names to this package's."""

    def find_class(self, module, name):
        if module == _REF_PKG or module.startswith(_REF_PKG + "."):
            module = _PKG + module[len(_REF_PKG):]
        return super().find_class(module, name)


def dumps_ast(obj) -> str:
    buf = io.BytesIO()
    _AstPickler(buf, protocol=4).dump(obj)
    return base64.b64encode(buf.getvalue()).decode()


def loads_ast(blob: str):
    return _AstUnpickler(io.BytesIO(base64.b64decode(blob))).load()
