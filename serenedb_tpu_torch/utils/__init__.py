"""Copied from serenedb_tpu/utils/__init__.py."""

from . import config, faults, log, metrics, ticks

__all__ = ["config", "faults", "log", "metrics", "ticks"]
