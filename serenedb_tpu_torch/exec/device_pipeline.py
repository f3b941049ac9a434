"""Stub of serenedb_tpu/exec/device_pipeline.py: the fused join and
filtered top-N device tier (K7, K8) is not ported yet.

Every entry declines (returns None), so `exec/plan.py` hands the query to
the next tier: `device_agg.try_device_aggregate` for single-table
aggregates, the host morsel path for everything else.
"""

from __future__ import annotations


def try_device_pipeline(node, ctx):
    """Aggregate over a join of scans as one device program: declines."""
    return None


def try_device_chained_topn(node, ctx):
    """Top-N over resident group accumulators: declines."""
    return None


def try_device_fused_topn(node, ctx):
    """Filtered top-N in one device program: declines."""
    return None
