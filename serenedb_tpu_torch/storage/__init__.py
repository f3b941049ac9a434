"""Stub of serenedb_tpu/storage/: the WAL, the snapshot store and the
maintenance loops are not ported yet. `Database(path=...)` raises before
it reaches them; what a statement can still reach raises
FEATURE_NOT_SUPPORTED."""

from . import maintenance, store, wal

__all__ = ["maintenance", "store", "wal"]
