"""Stub of serenedb_tpu/exec/device_topn.py: device top-N over a scan
(K6) is not ported yet. `try_device_topn` declines, so the sort runs on
the host."""

from __future__ import annotations


def try_device_topn(node, ctx):
    """ORDER BY col LIMIT k over one cached column: declines."""
    return None
