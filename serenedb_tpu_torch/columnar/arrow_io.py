"""Copied from serenedb_tpu/columnar/arrow_io.py (pyarrow is imported inside
each function, so an in-memory database never needs it; `require_pyarrow`
names the package when a durable one does; string columns of millions
of rows convert whole, where the copy failed on pyarrow's chunks).

Batch ⇄ Arrow IPC bytes (WAL payloads, parquet snapshots).

Reference analog: DataChunk zstd-1 serde inside WAL INLINE ops
(reference: server/search/search_db_wal.h:50-205). Arrow IPC gives a
well-defined binary frame with zero-copy numeric columns; zstd applied by
the WAL layer."""

from __future__ import annotations

import io

from .. import errors
from . import dtypes as dt
from .column import Batch


def require_pyarrow():
    """The pyarrow module, or SQLSTATE 58030 naming the missing package
    (durable storage and parquet files need it; nothing else does)."""
    try:
        import pyarrow
    except ImportError as e:
        raise errors.SqlError(
            "58030", "durable storage and parquet files need the pyarrow "
                     f"package, which is not installed ({e})") from e
    return pyarrow


def batch_to_arrow(batch: Batch):
    pa = require_pyarrow()
    arrays = []
    fields = []
    for name, col in zip(batch.names, batch.columns):
        mask = ~col.validity if col.validity is not None else None
        if col.type.is_string and col.dictionary is not None:
            # decoded by Arrow from the codes: a column of millions of
            # rows never passes through a numpy unicode array, which
            # pyarrow would hand back in chunks
            arr = pa.DictionaryArray.from_arrays(
                pa.array(col.data, mask=mask),
                pa.array(col.dictionary.astype(str),
                         type=pa.string())).cast(pa.string())
        elif col.type.is_string:
            arr = pa.array(col.data.astype(str), type=pa.string(),
                           mask=mask)
        elif col.type.id is dt.TypeId.TIMESTAMP:
            arr = pa.array(col.data, type=pa.timestamp("us"), mask=mask)
        elif col.type.id is dt.TypeId.DATE:
            arr = pa.array(col.data, type=pa.date32(), mask=mask)
        else:
            arr = pa.array(col.data, mask=mask)
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        arrays.append(arr)
        fields.append(pa.field(name, arr.type))
    return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))


def batch_to_bytes(batch: Batch) -> bytes:
    pa = require_pyarrow()
    rb = batch_to_arrow(batch)
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    return sink.getvalue()


def bytes_to_batch(data: bytes) -> Batch:
    from ..exec.tables import _arrow_to_column
    pa = require_pyarrow()
    with pa.ipc.open_stream(io.BytesIO(data)) as r:
        tbl = r.read_all()
    names = list(tbl.schema.names)
    cols = [_arrow_to_column(tbl.column(n)) for n in names]
    return Batch(names, cols)


def write_parquet_snapshot(path: str, batch: Batch) -> None:
    pa = require_pyarrow()
    import pyarrow.parquet as pq
    rb = batch_to_arrow(batch)
    pq.write_table(pa.Table.from_batches([rb]), path)


def read_parquet_snapshot(path: str) -> Batch:
    require_pyarrow()
    import pyarrow.parquet as pq
    from ..exec.tables import columns_parallel
    tbl = pq.read_table(path, use_threads=False)
    names = list(tbl.schema.names)
    cols = columns_parallel(tbl, names)
    return Batch(names, [cols[n] for n in names])
