"""Copied from serenedb_tpu/exec/tables.py (device_columns takes the target device).

Table providers: the scan sources the executor reads from.

Reference analog: DuckDB table entries + the iresearch scan table function +
remote-file index sources (SURVEY.md §2.5). Providers expose columnar
batches, and cache *device-resident* columns — the HBM working set that the
north-star design keeps hot between queries (BASELINE.json north_star:
"column batches ship to HBM and run as Pallas kernels").
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column
from ..columnar.device import DeviceColumn, to_device_column
from ..device import resolve_device
from ..utils import metrics

DEFAULT_BATCH_ROWS = 1 << 17


class TableProvider:
    name: str
    column_names: list[str]
    column_types: list[dt.SqlType]

    def row_count(self) -> int:
        raise NotImplementedError

    def full_batch(self, columns: Optional[list[str]] = None) -> Batch:
        raise NotImplementedError

    def batches(self, columns: Optional[list[str]] = None,
                batch_rows: int = DEFAULT_BATCH_ROWS) -> Iterator[Batch]:
        full = self.full_batch(columns)
        n = full.num_rows
        if n == 0:
            yield full
            return
        for start in range(0, n, batch_rows):
            yield full.slice(start, min(start + batch_rows, n))

    # -- device cache ------------------------------------------------------

    #: bumped on every data mutation; device program/column caches key on it
    data_version: int = 0

    def pinned(self):
        """(batch, data_version, mutation_epoch) observation. MemTable
        overrides this with a genuinely atomic single-reference read so
        readers never need a lock against concurrent DML; other providers
        are immutable and the default composition is safe."""
        return (self.full_batch(), self.data_version,
                getattr(self, "mutation_epoch", 0))

    def try_pin(self):
        """Atomic (batch, data_version, mutation_epoch) observation for
        MUTABLE providers (MemTable overrides); None for immutable ones,
        whose per-column reads are torn-free by construction — and which
        must not pay a whole-file materialization just to pin (a
        ParquetTable decodes columns lazily)."""
        return None

    def __init_device_cache(self):
        if not hasattr(self, "_device_cache"):
            #: (column, physical device) -> (version, DeviceColumn): the
            #: shards of a virtual mesh share their device's one copy
            self._device_cache: dict[tuple, tuple[int, DeviceColumn]] = {}
            self._device_lock = threading.Lock()

    def device_columns(self, names, pin=None, device=None) -> dict:
        """{name: DeviceColumn} with EVERY entry built from one
        publication — the given pin (from try_pin()) or per-column reads
        on immutable providers. A multi-column device program must get
        its whole environment here: fetching columns one at a time could
        mix two publications (mismatched lengths / row order) when DML
        lands between the fetches. Entries are version-stamped so a
        racing publish can never leave a stale column cached under the
        new version. `device` is the caller's (the exec context's): the
        provider outlives any one database, so entries also carry the
        device they were uploaded to."""
        dev = resolve_device(device)
        self.__init_device_cache()
        with self._device_lock:
            if pin is not None:
                batch, ver = pin[0], pin[1]
            else:
                batch, ver = None, self.data_version
            out = {}
            for name in names:
                entry = self._device_cache.get((name, str(dev)))
                if entry is None or entry[0] != ver:
                    col = (batch.column(name) if batch is not None
                           else self.full_batch([name]).column(name))
                    dc = to_device_column(col, device=dev)
                    metrics.DEVICE_BYTES.add(
                        int(dc.data.numel() * dc.data.element_size()))
                    self._device_cache[(name, str(dev))] = (ver, dc)
                    out[name] = dc
                else:
                    out[name] = entry[1]
            return out

    def shard_view(self, n_shards: int, block_rows: int,
                   nrows: Optional[int] = None
                   ) -> list[list[tuple[int, int]]]:
        """Deterministic hash-partitioned shard view: per-shard row
        spans under round-robin morsel-block assignment (exec/shard.py
        owns the partitioning function). Blocks never migrate between
        shards, so a pure append only creates/extends TAIL blocks and
        every other shard's zone maps / device uploads stay valid.
        Callers pass `nrows` from their own pinned publication so the
        view can never straddle a concurrent publish."""
        from .shard import shard_spans
        if nrows is None:
            nrows = self.row_count()
        return shard_spans(nrows, block_rows, n_shards)

    def device_column(self, name: str, device=None) -> DeviceColumn:
        return self.device_columns([name], self.try_pin(), device)[name]

    def host_column(self, name: str) -> Column:
        return self.full_batch([name]).column(name)

    def clear_device_cache(self):
        self.__init_device_cache()
        with self._device_lock:
            self._device_cache.clear()
            if hasattr(self, "_device_rowmask"):
                del self._device_rowmask
        # range-sliced uploads (zone-map prefix/suffix pruning) are
        # version-stamped like the main cache, but drop them with it so
        # stale HBM is released on mutation
        if hasattr(self, "_zonemap_devcache"):
            self._zonemap_devcache.clear()

    def type_of(self, name: str) -> dt.SqlType:
        return self.column_types[self.column_names.index(name)]


class MemTable(TableProvider):
    """In-memory columnar table (also the transactional-store table engine's
    in-memory representation until the storage layer lands).

    Two change counters steer index maintenance:
    - data_version: bumps on ANY change (freshness checks)
    - mutation_epoch: bumps when existing row identity/order changes
      (delete/update/truncate) or when COLUMN identity changes
      (drop/rename — per-column-name caches like zone maps must not
      survive values moving under an old name). Pure appends and
      column ADDs keep the epoch, which lets search indexes refresh
      incrementally with a new segment instead of a full rebuild (the
      reference's segment model, SURVEY.md §2.7)."""

    def __init__(self, name: str, batch: Batch):
        self.name = name
        #: the table's entire mutable state, published as ONE reference:
        #: (batch, data_version, mutation_epoch, column_names,
        #: column_types). Readers observe it with a single attribute read
        #: — no lock — so SELECTs never wait on DML and can never pair a
        #: torn batch with the wrong version or schema (reference analog:
        #: publish-by-swap DirectoryReader snapshots, SURVEY.md §2.7; and
        #: the morsel-parallel reads of server_engine.cpp:225-244).
        self._pub = (batch, 0, 0, list(batch.names),
                     [c.type for c in batch.columns])
        #: serializes WRITERS of this table only (DML, checkpoint capture,
        #: ALTER); readers never take it
        self.write_lock = threading.RLock()
        #: wakes fast-path-publish waiters / quiescers of THIS table
        self.pub_cond = threading.Condition(self.write_lock)

    # single-reference publication: all views of the state are slices of
    # one tuple read
    @property
    def _batch(self) -> Batch:
        return self._pub[0]

    @property
    def data_version(self) -> int:
        return self._pub[1]

    @data_version.setter
    def data_version(self, v: int):
        b, _, e, n, t = self._pub
        self._pub = (b, v, e, n, t)

    @property
    def mutation_epoch(self) -> int:
        return self._pub[2]

    @mutation_epoch.setter
    def mutation_epoch(self, e: int):
        b, v, _, n, t = self._pub
        self._pub = (b, v, e, n, t)

    @property
    def column_names(self) -> list:
        return self._pub[3]

    @property
    def column_types(self) -> list:
        return self._pub[4]

    def pinned(self):
        return self._pub[:3]

    def try_pin(self):
        return self._pub[:3]

    def type_of(self, name: str) -> dt.SqlType:
        # one tuple read: two separate property reads could straddle a
        # publish and pair shifted indices during ALTER
        _, _, _, names, types = self._pub
        return types[names.index(name)]

    def row_count(self) -> int:
        return self._batch.num_rows

    def full_batch(self, columns: Optional[list[str]] = None) -> Batch:
        batch = self._batch
        if columns is None:
            return batch
        missing = [c for c in columns if c not in batch]
        if missing:
            raise errors.SqlError(errors.UNDEFINED_COLUMN,
                                  f"column {missing[0]} does not exist")
        return Batch(list(columns), [batch.column(c) for c in columns])

    def replace(self, batch: Batch, *, rows_preserved: bool = False):
        _, v, e, _, _ = self._pub
        self._pub = (batch, v + 1, e if rows_preserved else e + 1,
                     list(batch.names), [c.type for c in batch.columns])
        self.clear_device_cache()

    def append_batch(self, aligned: Batch):
        """Append rows (schema-aligned) without changing existing row
        identity — search indexes stay valid for the old rows."""
        self.append_batches([aligned])

    def append_batches(self, aligned_list: list):
        """Append several schema-aligned batches in ONE publication — the
        group-commit window's in-memory half: one column concat, one
        data_version bump, one device-cache clear, so per-table
        invalidation (result cache keys, device uploads) is paid per
        WINDOW, not per statement. Callers order the batches by WAL tick;
        the concat preserves that order, so replayed state matches."""
        from ..columnar.column import concat_batches
        batch = self._batch
        cols = []
        for i, name in enumerate(self.column_names):
            merged = concat_batches(
                [Batch([name], [batch.columns[i]])] +
                [Batch([name], [a.columns[i]])
                 for a in aligned_list]).columns[0]
            cols.append(merged)
        self.replace(Batch(list(self.column_names), cols),
                     rows_preserved=True)


_PA_TYPE_MAP = None


def _arrow_to_column(arr) -> Column:
    """pyarrow ChunkedArray/Array → Column (sorted-dictionary for strings)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    if pa.types.is_dictionary(t):
        arr = arr.cast(t.value_type)
        t = arr.type
    null_mask = None
    if arr.null_count:
        null_mask = np.asarray(arr.is_valid())
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        if arr.null_count:
            arr = arr.fill_null("")
        enc = pc.dictionary_encode(arr)
        if isinstance(enc, pa.ChunkedArray):
            enc = enc.combine_chunks()
        codes = np.asarray(enc.indices, dtype=np.int64)
        dictionary = np.asarray(enc.dictionary.to_pylist(), dtype=object)
        order = np.argsort(dictionary.astype(str), kind="stable")
        remap = np.empty(len(order), dtype=np.int32)
        remap[order] = np.arange(len(order), dtype=np.int32)
        sorted_dict = dictionary[order]
        return Column(dt.VARCHAR, remap[codes], null_mask, sorted_dict)
    if pa.types.is_timestamp(t):
        us = arr.cast(pa.timestamp("us"))
        data = np.asarray(us.cast(pa.int64()).fill_null(0))
        return Column(dt.TIMESTAMP, data.astype(np.int64), null_mask)
    if pa.types.is_date32(t):
        data = np.asarray(arr.cast(pa.int32()).fill_null(0))
        return Column(dt.DATE, data.astype(np.int32), null_mask)
    if pa.types.is_boolean(t):
        data = np.asarray(arr.fill_null(False))
        return Column(dt.BOOL, data.astype(np.bool_), null_mask)
    if arr.null_count:
        arr = arr.fill_null(0)
    data = np.asarray(arr)
    return Column(dt.type_of_numpy(data.dtype), data, null_mask)


def columns_parallel(tbl, names: list) -> dict:
    """{name: Column} conversions of a pyarrow Table's columns, fanned
    out over the shared worker pool when `serene_parallel_ingest` is on.

    History: an earlier version serialized ALL parquet column work because pyarrow's
    INTERNAL thread pool segfaulted after a write on another daemon
    thread. The crash lived in pyarrow's own pool (use_threads=True),
    which the file READ still avoids; each conversion here runs
    single-threaded pyarrow compute (combine_chunks / cast /
    dictionary_encode) on one of OUR workers, which the regression test
    in tests/test_ingest_stream.py drives through the original
    write-on-daemon-thread-then-read scenario. Off (or a single column)
    falls back to the serial loop — the parity oracle."""
    names = list(names)
    from ..search.segment import _ingest_setting
    if len(names) > 1 and _ingest_setting(None, "serene_parallel_ingest"):
        from ..parallel.pool import parallel_map
        cols = parallel_map(
            None, lambda n: _arrow_to_column(tbl.column(n)), names)
        return dict(zip(names, cols))
    return {n: _arrow_to_column(tbl.column(n)) for n in names}


class ParquetTable(TableProvider):
    """Zero-ETL parquet scan (reference analog: view-over-parquet fast path,
    index_source_view_file.*, examples/demo0/demo.sql)."""

    def __init__(self, path: str, name: Optional[str] = None):
        import pyarrow.parquet as pq
        self.path = path
        self.name = name or path
        self._pf = pq.ParquetFile(path)
        schema = self._pf.schema_arrow
        self.column_names = list(schema.names)
        self.column_types = []
        self._columns: dict[str, Column] = {}
        self._lock = threading.Lock()
        for f in schema:
            self.column_types.append(_arrow_field_type(f.type))

    def row_count(self) -> int:
        return self._pf.metadata.num_rows

    def full_batch(self, columns: Optional[list[str]] = None) -> Batch:
        cols = columns if columns is not None else self.column_names
        missing = [c for c in cols if c not in self.column_names]
        if missing:
            raise errors.SqlError(errors.UNDEFINED_COLUMN,
                                  f"column {missing[0]} does not exist")
        with self._lock:
            to_read = [c for c in cols if c not in self._columns]
            if to_read:
                # use_threads=False: pyarrow's INTERNAL CPU pool segfaults
                # when a write happened on another (daemon) server thread
                # earlier in this process; single-threaded file decode is
                # safe and the column cache amortizes it (see
                # test_filesource server drive). Column BUILDING fans out
                # over OUR worker pool instead (columns_parallel) — each
                # worker runs single-threaded pyarrow compute, which does
                # not wake pyarrow's pool; serene_parallel_ingest=off
                # restores the fully serial loop.
                tbl = self._pf.read(columns=to_read, use_threads=False)
                self._columns.update(columns_parallel(tbl, to_read))
            return Batch(list(cols), [self._columns[c] for c in cols])


def _arrow_field_type(t) -> dt.SqlType:
    import pyarrow as pa
    if pa.types.is_dictionary(t):
        t = t.value_type
    if pa.types.is_boolean(t):
        return dt.BOOL
    if pa.types.is_int8(t):
        return dt.TINYINT
    if pa.types.is_int16(t) or pa.types.is_uint8(t):
        return dt.SMALLINT
    if pa.types.is_int32(t) or pa.types.is_uint16(t):
        return dt.INT
    if pa.types.is_integer(t):
        return dt.BIGINT
    if pa.types.is_float32(t):
        return dt.FLOAT
    if pa.types.is_floating(t):
        return dt.DOUBLE
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return dt.VARCHAR
    if pa.types.is_timestamp(t):
        return dt.TIMESTAMP
    if pa.types.is_date(t):
        return dt.DATE
    return dt.VARCHAR
