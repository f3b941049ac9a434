"""State carried across from the JAX package.

The reference's index, posting store and tables are plain arrays; these
functions take them as numpy arrays (a reference `FieldIndex`'s fields, a
reference `BlockStore`'s fields after `np.asarray` of its device arrays,
the fields of a reference table's `Column`s, or a reference vector
index's centroids, segment arrays and options) and build the port's
objects, so both packages score, aggregate and probe identical state.
Nothing here imports the reference: the caller hands over the arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .columnar import dtypes as dt
from .columnar.column import Batch, Column
from .device import DeviceLike, resolve_device
from .exec.tables import MemTable
from .ops.bm25 import BlockStore
from .search.ivf import IvfIndex, MaxSimIndex, VecSegment
from .search.segment import FieldIndex

FIELD_INDEX_ARRAYS = ("terms", "doc_freq", "offsets", "post_docs",
                      "post_tfs", "pos_offsets", "positions", "norms",
                      "block_max_tf", "block_offsets")

#: BlockStore fields that live on the device, with their dtypes
BLOCK_STORE_DEVICE = {"block_base": np.int32, "block_gaps": np.uint16,
                      "block_tfs8": np.uint8, "raw_docs": np.int32,
                      "raw_tfs": np.int32, "norms": np.int32}
BLOCK_STORE_HOST = ("block_offsets", "heavy", "flat_docs", "flat_tfs",
                    "offsets", "row_plane", "row_slot", "block_bmax_tf",
                    "block_bmin_dl", "norms_host")
BLOCK_STORE_INTS = ("ndocs_pad", "pad_row", "n_packed", "n_raw")


def field_index_from_reference(arrays: dict) -> FieldIndex:
    """The port's FieldIndex from a reference FieldIndex's fields (numpy
    arrays keyed by field name, and the int `total_tokens`)."""
    kw = {name: np.array(arrays[name], copy=True)
          for name in FIELD_INDEX_ARRAYS}
    kw["terms"] = np.asarray([str(t) for t in kw["terms"]], dtype=object)
    return FieldIndex(total_tokens=int(arrays["total_tokens"]), **kw)


def block_store_from_reference(arrays: dict,
                               device: DeviceLike = None) -> BlockStore:
    """The port's BlockStore from a reference BlockStore's fields (numpy
    arrays and ints keyed by field name), device fields placed on
    `device` (`cuda:0` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    kw = {}
    for name, dtype in BLOCK_STORE_DEVICE.items():
        a = np.ascontiguousarray(arrays[name])
        if a.dtype != dtype:
            raise TypeError(f"{name}: expected {np.dtype(dtype)}, "
                            f"got {a.dtype}")
        kw[name] = torch.from_numpy(a.copy()).to(dev)
    for name in BLOCK_STORE_HOST:
        kw[name] = np.array(arrays[name], copy=True)
    for name in BLOCK_STORE_INTS:
        kw[name] = int(arrays[name])
    return BlockStore(**kw)


#: SQL type of a non-dictionary column, by the numpy dtype of its data
_TYPE_OF_DTYPE = {np.dtype(np.bool_): dt.BOOL, np.dtype(np.int8): dt.TINYINT,
                  np.dtype(np.int16): dt.SMALLINT, np.dtype(np.int32): dt.INT,
                  np.dtype(np.int64): dt.BIGINT,
                  np.dtype(np.float32): dt.FLOAT,
                  np.dtype(np.float64): dt.DOUBLE}


def memtable_from_reference(name: str, columns: dict) -> MemTable:
    """The port's MemTable from a reference table's columns, given as
    {column name: (data, validity or None, dictionary or None[, type
    name])} — the reference `Column`'s fields. A column with a dictionary
    is VARCHAR (data holds its codes); the others take the named type
    (a `TypeId` name such as "DATE") or, without one, their type from the
    data's dtype (bool, int8/16/32/64, float32/64)."""
    cols = []
    for cname, fields in columns.items():
        data, validity, dictionary = fields[:3]
        data = np.array(data, copy=True)
        if dictionary is not None:
            typ = dt.VARCHAR
            dictionary = np.array(dictionary, dtype=object, copy=True)
        elif len(fields) > 3:
            typ = dt.SqlType(dt.TypeId[fields[3]])
        else:
            typ = _TYPE_OF_DTYPE.get(data.dtype)
            if typ is None:
                raise TypeError(f"{cname}: no SQL type for {data.dtype}")
        cols.append(Column(typ, data, None if validity is None else
                           np.array(validity, dtype=bool, copy=True),
                           dictionary))
    return MemTable(name, Batch(list(columns), cols))


def _vec_segments(segs, lists: int) -> list:
    """VecSegments from (vals, rows, codes) numpy triples; the reference's
    segments are already sorted (cluster asc, row asc), so the port's
    constructor keeps their order."""
    return [VecSegment(np.array(v, np.float32, copy=True),
                       np.array(r, np.int64, copy=True),
                       np.array(c, np.int32, copy=True), lists)
            for v, r, c in segs]


def ivf_index_from_reference(fields: dict,
                             device: DeviceLike = None) -> IvfIndex:
    """The port's IvfIndex from a reference IvfIndex's state: `centroids`,
    `segs` as (vals, rows, codes) numpy triples in segment order, and the
    scalars and options (`column`, `dim`, `lists`, `metric`, `num_rows`,
    `data_version`, `mutation_epoch`, `options`, `quantized`, and for SQ8
    `host_vectors`, `sq8_lo`, `sq8_scale`), on `device`."""
    def arr(name):
        v = fields.get(name)
        return None if v is None else np.array(v, np.float32, copy=True)
    lists = int(fields["lists"])
    return IvfIndex(
        column=fields["column"], dim=int(fields["dim"]), lists=lists,
        metric=str(fields["metric"]), centroids=arr("centroids"),
        segs=_vec_segments(fields["segs"], lists),
        num_rows=int(fields["num_rows"]),
        data_version=int(fields["data_version"]),
        mutation_epoch=int(fields.get("mutation_epoch", 0)),
        options=dict(fields.get("options") or {}),
        quantized=bool(fields.get("quantized", False)),
        host_vectors=arr("host_vectors"), sq8_lo=arr("sq8_lo"),
        sq8_scale=arr("sq8_scale"), device=device)


def maxsim_index_from_reference(fields: dict,
                                device: DeviceLike = None) -> MaxSimIndex:
    """The port's MaxSimIndex from a reference MaxSimIndex's state:
    `segs` as (vals, rows, codes) triples, `doc_rows`, and `column`,
    `dim`, `num_rows`, `data_version`, `mutation_epoch`, `options`."""
    doc_rows = np.array(fields["doc_rows"], np.int32, copy=True)
    return MaxSimIndex(
        column=fields["column"], dim=int(fields["dim"]),
        segs=_vec_segments(fields["segs"], len(doc_rows)),
        doc_rows=doc_rows, num_rows=int(fields["num_rows"]),
        data_version=int(fields["data_version"]),
        mutation_epoch=int(fields.get("mutation_epoch", 0)),
        options=dict(fields.get("options") or {}), device=device)
