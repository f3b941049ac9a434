"""Copied from serenedb_tpu/search/pkindex.py.

Sorted primary-key index over memcomparable key bytes.

Reference analog: the iresearch PK terms written by the sink writer
(server/connector/search_sink_writer.cpp PK encoding +
key_encoding.cpp) — here a sorted (keys, row_ids) pair per table,
version-stamped like every other index so lock-free readers repair on
staleness instead of trusting a stale structure. Appends extend the
index incrementally (O(k log n) merge); mutations rebuild.

Serves three consumers:
- uniqueness checks for INSERT / upsert (engine)
- PK point lookups and leading-column range scans (PkScanNode)
- PK-based remove filters: WAL delete_pk records resolve key bytes to
  physical rows at apply/replay time, so recovery no longer depends on
  positional row identity for PK tables
"""

from __future__ import annotations

import threading

import numpy as np

from ..columnar import keyenc

_attach_guard = threading.Lock()


class PkIndex:
    def __init__(self, pk_cols: list, keys: np.ndarray, rows: np.ndarray,
                 data_version: int):
        self.pk_cols = pk_cols          # column names, declared order
        self.keys = keys                # sorted object array of bytes
        self.rows = rows                # int64 row ids, aligned with keys
        self.data_version = data_version

    # -- lookups -----------------------------------------------------------

    def get(self, key: bytes) -> int:
        """Row id for an exact key, or -1."""
        i = int(np.searchsorted(self.keys, key))
        if i < len(self.keys) and self.keys[i] == key:
            return int(self.rows[i])
        return -1

    def contains_any(self, keys: np.ndarray) -> np.ndarray:
        """Boolean mask: which of `keys` exist in the index."""
        if len(self.keys) == 0:
            return np.zeros(len(keys), dtype=bool)
        idx = np.searchsorted(self.keys, keys)
        idx = np.clip(idx, 0, len(self.keys) - 1)
        return self.keys[idx] == keys

    def lookup_rows(self, keys) -> np.ndarray:
        """Row ids for exact keys; missing keys are skipped."""
        out = []
        for k in keys:
            r = self.get(k)
            if r >= 0:
                out.append(r)
        return np.asarray(out, dtype=np.int64)

    def range_rows(self, lo, hi) -> np.ndarray:
        """Row ids whose key is in [lo, hi) — None bounds are open."""
        start = 0 if lo is None else int(np.searchsorted(self.keys, lo))
        end = len(self.keys) if hi is None else \
            int(np.searchsorted(self.keys, hi))
        return np.sort(self.rows[start:end].astype(np.int64))


def _build(provider, pk_cols: list) -> PkIndex:
    batch, ver, _ = provider.pinned()
    cols = [batch.column(c) for c in pk_cols]
    keys = keyenc.encode_key_columns(cols)
    order = np.argsort(keys, kind="stable")
    return PkIndex(list(pk_cols), keys[order],
                   order.astype(np.int64), ver)


def pk_index(provider) -> "PkIndex | None":
    """The provider's PK index, rebuilt if stale (version-stamped; same
    repair discipline as search/index.py)."""
    meta = getattr(provider, "table_meta", None) or {}
    pk = meta.get("primary_key") or []
    if not pk:
        return None
    lk = getattr(provider, "_pk_index_lock", None)
    if lk is None:
        with _attach_guard:
            lk = getattr(provider, "_pk_index_lock", None)
            if lk is None:
                lk = threading.Lock()
                provider._pk_index_lock = lk
    with lk:
        idx = getattr(provider, "_pk_index", None)
        if idx is not None and idx.data_version == provider.data_version \
                and idx.pk_cols == list(pk):
            return idx
        idx = _build(provider, pk)
        provider._pk_index = idx
        return idx


def pk_extend(provider, appended_keys: np.ndarray, n_before: int,
              base_version: int):
    """After an append of len(appended_keys) rows starting at row
    n_before: merge the new keys in instead of rebuilding. Caller holds
    the table's write_lock and passes the data_version it observed
    BEFORE publishing — if the cached index is not exactly at that
    version, a concurrent lock-free reader already rebuilt it over the
    published batch (merging again would duplicate the keys) or it is
    stale in some other way; skip and let pk_index() repair."""
    lk = getattr(provider, "_pk_index_lock", None)
    if lk is None:
        return
    with lk:
        idx = getattr(provider, "_pk_index", None)
        if idx is None or idx.data_version != base_version:
            return
        new_rows = np.arange(n_before, n_before + len(appended_keys),
                             dtype=np.int64)
        order = np.argsort(appended_keys, kind="stable")
        ak, ar = appended_keys[order], new_rows[order]
        pos = np.searchsorted(idx.keys, ak)
        keys = np.insert(idx.keys, pos, ak)
        rows = np.insert(idx.rows, pos, ar)
        provider._pk_index = PkIndex(idx.pk_cols, keys, rows,
                                     provider.data_version)
