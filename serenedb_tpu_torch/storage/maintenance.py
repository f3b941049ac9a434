"""Stub of serenedb_tpu/storage/maintenance.py: the background
maintenance loops (checkpoints, WAL GC, index refresh and merges) are not
ported yet."""

from __future__ import annotations

from .. import errors


class MaintenanceManager:
    def __init__(self, *args, **kwargs):
        raise errors.unsupported("background maintenance is not ported yet")
