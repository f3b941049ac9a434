"""Stub of serenedb_tpu/exec/filesource.py: the file table functions
(read_parquet, read_csv) are not ported yet; each raises
FEATURE_NOT_SUPPORTED."""

from __future__ import annotations

from .. import errors


def parquet_source(db, path: str, pinned: bool = False):
    raise errors.unsupported("read_parquet is not ported yet")


def csv_source(db, path: str, header=None, delimiter=","):
    raise errors.unsupported("read_csv is not ported yet")
