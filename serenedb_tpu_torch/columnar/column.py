"""Copied from serenedb_tpu/columnar/column.py.

Column batch ABI — the unit of data exchange across the whole framework.

Reference analog: DuckDB's DataChunk/Vector flowing between physical operators
(the reference moves DataChunks through morsel-driven pipelines; see
SURVEY.md §3.2). Here the layout is chosen for HBM/TPU:

- struct-of-arrays: one contiguous numpy array per column
- validity as a separate bool array (None ⇒ all valid)
- VARCHAR is dictionary-encoded: `data` holds int32 codes into a host-side
  `dictionary` (numpy object array of python str), kept **lexicographically
  sorted** so integer code order == string order and device-side comparisons
  (<, <=, =, >, >=, GROUP BY, ORDER BY) are exact on codes.
- a NULL code of -1 is never used; validity carries nullness so codes stay
  non-negative and usable as gather indices.

Columns are immutable by convention: operators build new ones.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np

from . import dtypes as dt


@dataclass
class Column:
    type: dt.SqlType
    data: np.ndarray                       # 1-D, physical dtype of `type`
    validity: Optional[np.ndarray] = None  # 1-D bool; None ⇒ all valid
    dictionary: Optional[np.ndarray] = None  # VARCHAR only: sorted unique strs

    def __post_init__(self):
        assert self.data.ndim == 1
        if self.validity is not None:
            assert self.validity.shape == self.data.shape
            if bool(self.validity.all()):
                self.validity = None

    def __len__(self) -> int:
        return len(self.data)

    @property
    def has_nulls(self) -> bool:
        return self.validity is not None

    def valid_mask(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(len(self.data), dtype=bool)
        return self.validity

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_pylist(values: Sequence, typ: Optional[dt.SqlType] = None) -> "Column":
        """Build from python values (None ⇒ NULL). Infers type if not given."""
        non_null = [v for v in values if v is not None]
        if typ is None:
            typ = _infer_type(non_null)
        validity = np.array([v is not None for v in values], dtype=bool)
        n = len(values)
        if typ.is_string:
            strs = [("" if v is None else str(v)) for v in values]
            dictionary, codes = _encode_dictionary(strs)
            col = Column(typ, codes.astype(np.int32), validity, dictionary)
        elif typ.id is dt.TypeId.BOOL:
            data = np.array([bool(v) if v is not None else False for v in values],
                            dtype=np.bool_)
            col = Column(typ, data, validity)
        else:
            fill = 0
            try:
                data = np.array([fill if v is None else v for v in values],
                                dtype=typ.np_dtype)
            except OverflowError:
                from .. import errors
                raise errors.SqlError(
                    "22003",
                    f"value out of range for type "
                    f"{typ.id.name.lower()}")
            col = Column(typ, data, validity)
        if n == 0:
            col.validity = None
        return col

    @staticmethod
    def from_numpy(arr: np.ndarray, typ: Optional[dt.SqlType] = None,
                   validity: Optional[np.ndarray] = None) -> "Column":
        if arr.dtype.kind in ("U", "S", "O"):
            strs = [("" if v is None else str(v)) for v in arr.tolist()]
            dictionary, codes = _encode_dictionary(strs)
            return Column(dt.VARCHAR, codes.astype(np.int32), validity, dictionary)
        if typ is None:
            typ = dt.type_of_numpy(arr.dtype)
        return Column(typ, np.ascontiguousarray(arr, dtype=typ.np_dtype), validity)

    @staticmethod
    def const(value, n: int, typ: Optional[dt.SqlType] = None) -> "Column":
        """Constant column without the python-list round-trip: literals
        sit in EVERY expression eval, so this is np.full/np.zeros (which
        release the GIL) instead of from_pylist's per-element list build
        — the difference between host pipelines scaling and serializing
        on literal materialization."""
        if typ is None:
            typ = _infer_type([] if value is None else [value])
        if value is None:
            if typ.is_string:
                return Column(typ, np.zeros(n, dtype=np.int32),
                              np.zeros(n, dtype=bool),
                              np.asarray([""], dtype=object))
            return Column(typ, np.zeros(n, dtype=typ.np_dtype),
                          np.zeros(n, dtype=bool))
        if typ.is_string:
            return Column(typ, np.zeros(n, dtype=np.int32), None,
                          np.asarray([str(value)], dtype=object))
        if typ.id is dt.TypeId.BOOL:
            return Column(typ, np.full(n, bool(value), dtype=np.bool_))
        try:
            npd = np.dtype(typ.np_dtype)
            if npd.kind in "iu" and isinstance(value, int) and \
                    not (np.iinfo(npd).min <= value <= np.iinfo(npd).max):
                # np.full would silently wrap (np.array raises) — keep
                # from_pylist's 22003 out-of-range behavior
                raise OverflowError(value)
            return Column(typ, np.full(n, value, dtype=typ.np_dtype))
        except (OverflowError, ValueError, TypeError):
            return Column.from_pylist([value] * n, typ)

    # -- accessors ---------------------------------------------------------

    def to_pylist(self) -> list:
        out = []
        valid = self.valid_mask()
        if self.type.is_string:
            d = self.dictionary
            for i in range(len(self.data)):
                out.append(str(d[self.data[i]]) if valid[i] else None)
        else:
            for i in range(len(self.data)):
                v = self.data[i]
                out.append(v.item() if valid[i] else None)
        return out

    def decode(self, i: int):
        """Single-value accessor (python value or None)."""
        if self.validity is not None and not self.validity[i]:
            return None
        if self.type.is_string:
            return str(self.dictionary[self.data[i]])
        return self.data[i].item()

    def take(self, indices: np.ndarray) -> "Column":
        v = None if self.validity is None else self.validity[indices]
        return Column(self.type, self.data[indices], v, self.dictionary)

    def filter(self, mask: np.ndarray) -> "Column":
        return self.take(np.flatnonzero(mask))

    def slice(self, start: int, stop: int) -> "Column":
        v = None if self.validity is None else self.validity[start:stop]
        return Column(self.type, self.data[start:stop], v, self.dictionary)

    def re_dictionary(self) -> "Column":
        """Rebuild the dictionary to only the codes in use (post-filter)."""
        if not self.type.is_string or self.dictionary is None:
            return self
        used = np.unique(self.data)
        new_dict = self.dictionary[used]
        remap = np.zeros(len(self.dictionary), dtype=np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        return Column(self.type, remap[self.data], self.validity, new_dict)


def _infer_type(non_null: list) -> dt.SqlType:
    if not non_null:
        return dt.NULLTYPE
    if all(isinstance(v, bool) for v in non_null):
        return dt.BOOL
    if all(isinstance(v, int) and not isinstance(v, bool) for v in non_null):
        return dt.BIGINT
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in non_null):
        return dt.DOUBLE
    return dt.VARCHAR


def _encode_dictionary(strs: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-unique dictionary encode: codes compare like the strings."""
    arr = np.asarray(strs, dtype=object)
    uniq, codes = np.unique(arr.astype(str), return_inverse=True)
    return uniq.astype(object), codes.astype(np.int32)


def merge_dictionaries(cols: Iterable[Column]) -> list[Column]:
    """Re-encode VARCHAR columns from different batches onto one shared sorted
    dictionary (needed before concatenating or comparing code spaces)."""
    cols = list(cols)
    dicts = [c.dictionary for c in cols if c.dictionary is not None]
    if not dicts:
        return cols
    merged = np.unique(np.concatenate([d.astype(str) for d in dicts]))
    out = []
    for c in cols:
        if c.dictionary is None:
            out.append(c)
            continue
        remap = np.searchsorted(merged, c.dictionary.astype(str)).astype(np.int32)
        out.append(Column(c.type, remap[c.data], c.validity, merged.astype(object)))
    return out


@dataclass
class Batch:
    """An ordered set of equal-length named columns."""

    names: list[str]
    columns: list[Column]
    _index: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        assert len(self.names) == len(self.columns)
        if self.columns:
            n = len(self.columns[0])
            assert all(len(c) == n for c in self.columns), "ragged batch"
        self._index = {n: i for i, n in enumerate(self.names)}

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, name: str) -> Column:
        return self.columns[self._index[name]]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    @staticmethod
    def from_pydict(d: dict) -> "Batch":
        names = list(d.keys())
        cols = [v if isinstance(v, Column)
                else (Column.from_numpy(v) if isinstance(v, np.ndarray)
                      else Column.from_pylist(v))
                for v in d.values()]
        return Batch(names, cols)

    def to_pydict(self) -> dict:
        return {n: c.to_pylist() for n, c in zip(self.names, self.columns)}

    def take(self, indices: np.ndarray) -> "Batch":
        return Batch(list(self.names), [c.take(indices) for c in self.columns])

    def filter(self, mask: np.ndarray) -> "Batch":
        return self.take(np.flatnonzero(mask))

    def slice(self, start: int, stop: int) -> "Batch":
        return Batch(list(self.names), [c.slice(start, stop) for c in self.columns])

    def rows(self) -> list[tuple]:
        cols = [c.to_pylist() for c in self.columns]
        return list(zip(*cols)) if cols else []


def concat_batches(batches: Sequence[Batch]) -> Batch:
    batches = [b for b in batches if b.num_rows > 0] or list(batches[:1])
    if len(batches) == 1:
        return batches[0]
    names = batches[0].names
    out_cols = []
    for i, name in enumerate(names):
        cols = merge_dictionaries([b.columns[i] for b in batches])
        data = np.concatenate([c.data for c in cols])
        if any(c.validity is not None for c in cols):
            validity = np.concatenate([c.valid_mask() for c in cols])
        else:
            validity = None
        typ = next((c.type for c in cols if c.type.id is not dt.TypeId.NULL),
                   cols[0].type)
        out_cols.append(Column(typ, data, validity, cols[0].dictionary))
    return Batch(list(names), out_cols)
