"""Host→device movement of column batches (port of
serenedb_tpu/columnar/device.py).

Columns go to the database's torch device as 2-D (rows/LANES, LANES)
tiles, the reference's layout, so row r of a column is element r of the
flattened tile array on both sides:

- a 1-D column of n rows is padded to a multiple of BLOCK_ROWS = 1024 and
  reshaped to (n_pad // 128, 128); float64 narrows to float32 and int64 to
  int32 when every value fits (else `DeviceNarrowingError`), exactly as the
  reference narrows, so both packages admit the same queries;
- validity travels as a bool mask of the same shape (True = valid row);
  padding rows are invalid;
- integer tiles whose value range fits 8 or 16 bits ship as frame-of-
  reference deltas (uint8/uint16, stored = value - offset); the kernels
  widen and add `offset` as they read them.

Every upload goes through `commit_host_array`, which counts its bytes in
`device.UPLOADS` (via `obs.device.note_upload`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import dtypes as dt
from .column import Batch, Column

LANES = 128
SUBLANES = 8
BLOCK_ROWS = LANES * SUBLANES  # 1024


def pad_len(n: int, multiple: int = BLOCK_ROWS) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


#: raw-scheme device dtype per (narrowed) host dtype; anything else ships
#: as float32, as in the reference
_HOST_TILE_DTYPE = {
    np.dtype(np.bool_): np.int8,     # bool as i8 lanes (mask math)
    np.dtype(np.int8): np.int8,
    np.dtype(np.int16): np.int32,
    np.dtype(np.int32): np.int32,
    np.dtype(np.float32): np.float32,
    np.dtype(np.float64): np.float32,
}


@dataclass
class DeviceColumn:
    """A column resident on the device as (n_pad/128, 128) tiles.

    `scheme` is raw | for8 | for16; for the last two `data` holds
    value - offset as uint8/uint16 (ops/agg_kernels.py `decode_plain`
    and the kernels widen and add `offset`)."""

    type: dt.SqlType
    data: torch.Tensor              # 2-D (rows, LANES)
    mask: torch.Tensor              # 2-D bool, same shape; False on padding
    length: int                     # logical row count
    scheme: str = "raw"             # raw | for8 | for16
    offset: int = 0                 # frame of reference (for8/for16)


class DeviceNarrowingError(ValueError):
    """A column cannot be represented exactly on the device (int64 values
    outside int32 range). Callers treat this like a NotCompilable and run
    the exact host path."""


def _narrow_exact(arr: np.ndarray, n: int) -> np.ndarray:
    """int64 → int32 when provably exact; raises DeviceNarrowingError
    otherwise."""
    if arr.dtype == np.dtype(np.int64):
        if n == 0 or (np.abs(arr, dtype=np.float64).max(initial=0.0) < 2**31):
            return arr.astype(np.int32)
        raise DeviceNarrowingError(
            "int64 column with |values| >= 2^31: no exact device "
            "representation")
    return arr


def commit_host_array(arr: np.ndarray, device: DeviceLike = None
                      ) -> torch.Tensor:
    """Upload one host array to `device`: THE upload choke point of the
    port. Counts the bytes (obs.device.note_upload)."""
    from ..obs import device as _obsdev
    dev = resolve_device(device)
    host = torch.from_numpy(np.ascontiguousarray(arr))
    t0 = time.perf_counter_ns()
    out = host.to(dev) if dev.type != "cpu" else host.clone()
    _obsdev.note_upload(out.numel() * out.element_size(), dev,
                        time.perf_counter_ns() - t0)
    return out


def to_device_column(col: Column, pad_multiple: int = BLOCK_ROWS,
                     device: DeviceLike = None) -> DeviceColumn:
    n = len(col)
    n_pad = pad_len(n, pad_multiple)
    arr = _narrow_exact(col.data, n)
    np_dt = _HOST_TILE_DTYPE.get(arr.dtype, np.float32)
    scheme, offset = "raw", 0
    if arr.dtype.kind == "i" and arr.dtype.itemsize > 1 and n:
        # frame-of-reference narrowing: range-fitting int tiles ship as
        # uint8/uint16 deltas and decode in-kernel (+offset)
        vmin = int(arr.min())
        vmax = int(arr.max())
        rng = vmax - vmin
        if rng < (1 << 8):
            scheme, offset, np_dt = "for8", vmin, np.uint8
            arr = (arr.astype(np.int64) - vmin).astype(np.uint8)
        elif rng < (1 << 16):
            scheme, offset, np_dt = "for16", vmin, np.uint16
            arr = (arr.astype(np.int64) - vmin).astype(np.uint16)
    padded = np.zeros(n_pad, dtype=np_dt)
    padded[:n] = arr.astype(np_dt, copy=False)
    mask = np.zeros(n_pad, dtype=bool)
    mask[:n] = col.valid_mask()
    data2d = commit_host_array(padded.reshape(-1, LANES), device)
    mask2d = commit_host_array(mask.reshape(-1, LANES), device)
    return DeviceColumn(col.type, data2d, mask2d, n, scheme, offset)


def to_device_batch(batch: Batch, columns: Optional[list[str]] = None,
                    device: DeviceLike = None) -> dict:
    names = columns if columns is not None else batch.names
    return {name: to_device_column(batch.column(name), device=device)
            for name in names}
