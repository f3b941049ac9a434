"""Copied from serenedb_tpu/exec/__init__.py."""

from . import device, plan, tables

__all__ = ["device", "plan", "tables"]
