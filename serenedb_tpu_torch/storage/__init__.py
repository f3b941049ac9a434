"""Copied from serenedb_tpu/storage/__init__.py.

Durability layer: WAL, store (snapshots + catalog persistence), and
background maintenance loops."""

from . import maintenance, store, wal

__all__ = ["maintenance", "store", "wal"]
