"""Stub of serenedb_tpu/storage/wal.py: the write-ahead log is not ported
yet. `WalOp` is the reference's record of one table operation (the engine
builds them only when the database has a store, which the port never
has); opening a log raises FEATURE_NOT_SUPPORTED."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .. import errors
from ..columnar.column import Batch


@dataclass
class WalOp:
    table: str
    kind: str                       # insert | delete | delete_pk | truncate
    batch: Optional[Batch] = None   # insert payload
    rows: Optional[object] = None


class SearchDbWal:
    def __init__(self, *args, **kwargs):
        raise errors.unsupported("the write-ahead log is not ported yet")
