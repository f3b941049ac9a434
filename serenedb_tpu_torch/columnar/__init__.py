"""Columnar data: the batch ABI (copied from serenedb_tpu/columnar) and
the host→device tile upload (`device.py`, ported to torch)."""

from . import dtypes
from .column import Batch, Column, concat_batches, merge_dictionaries
from .device import (BLOCK_ROWS, LANES, DeviceColumn, pad_len,
                     to_device_batch, to_device_column)

__all__ = [
    "dtypes", "Batch", "Column", "concat_batches", "merge_dictionaries",
    "BLOCK_ROWS", "LANES", "DeviceColumn", "pad_len", "to_device_batch",
    "to_device_column",
]
