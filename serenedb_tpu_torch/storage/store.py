"""Stub of serenedb_tpu/storage/store.py: snapshots and catalog
persistence are not ported yet; each entry raises FEATURE_NOT_SUPPORTED."""

from __future__ import annotations

from .. import errors


class Store:
    def __init__(self, *args, **kwargs):
        raise errors.unsupported("durable storage is not ported yet")


def table_def(*args, **kwargs):
    raise errors.unsupported("durable storage is not ported yet")
