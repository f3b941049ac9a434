"""Wrappers of the top-N CUDA kernels (`csrc/topn.cu`) and their plain
PyTorch versions.

- `topn_scan` ← serenedb_tpu/exec/device_topn.py `_topn_indices` (`prog`
  :202) and exec/device_pipeline.py `_run_fused_topn` (:2637): decode,
  predicates, the key transform (desc v; asc ~v for ints, -v for f32;
  masked rows take the sentinel) and `lax.top_k`, plus the survivor
  count.
- `chain_topn` ← the stage-2 program of exec/device_pipeline.py
  `try_device_chained_topn` (:2810): top-k over the group slots of
  resident stage-1 accumulators, and the gather of every output down to
  the picked rows.

Both select by a unique 64-bit key per element: the order-preserving u32
image of the transformed value above ~index. Its descending order is
(value desc, index asc), `lax.top_k`'s tie order, so the kernel and the
plain version (`torch.topk` over the same unique keys) return the same
indices. -0.0 is made +0.0 first: the host path's sort ties them (JAX's
`top_k` on the CPU puts +0.0 above -0.0; ROADMAP Queue 3).

Each wrapper launches its kernel for tensors on a CUDA device and counts
the launch in `device.LAUNCHES`; for tensors on the CPU it calls the plain
version (counted under `<name>.plain`). There is no other path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import LAUNCHES
from . import _build
from . import agg_kernels as K

#: the largest k either kernel selects (device_topn.MAX_TOPN_K)
TOPN_MAX_K = 8192
F_DESC, F_FLOAT = 1, 2
_H_ROWS, _H_KEYSLOT, _H_FLAGS, _H_KEYS_OUT, _H_HIST, _H_NSURV = range(10, 16)
_BINS = 256


@dataclass
class TopnSpec:
    """One topn_scan launch, independent of the data: per input slot its
    decode (kind, offset), the predicate programs, the key's slot, the
    direction and whether the key is f32."""
    col_kinds: list
    col_offsets: list
    key_slot: int
    desc: bool
    is_float: bool
    preds: list = field(default_factory=list)


# -- the keys (plain) --------------------------------------------------------

def _key_hi(v: torch.Tensor, desc: bool, is_float: bool) -> torch.Tensor:
    """The u32 image (in int64) of each transformed sort value."""
    if is_float:
        bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        if not desc:
            bits = bits ^ 0x80000000                 # -v
        bits = torch.where(bits == 0x80000000, torch.zeros_like(bits), bits)
        nan = ((bits & 0x7F800000) == 0x7F800000) & ((bits & 0x7FFFFF) != 0)
        bits = torch.where(nan, torch.full_like(bits, 0x7FC00000), bits)
        return torch.where(bits >= 0x80000000, (~bits) & 0xFFFFFFFF,
                           bits | 0x80000000)
    kv = v.to(torch.int32)
    if not desc:
        kv = ~kv
    return (kv.to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000


def _select_plain(hi: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest (hi, ~index) keys, best first. The key,
    less 2^63 so that it orders as an int64, is unique per element."""
    idx = torch.arange(hi.numel(), dtype=torch.int64, device=hi.device)
    key = (hi - 2**31) * 2**32 + (0xFFFFFFFF - idx)
    return torch.topk(key, k).indices


# -- topn_scan ---------------------------------------------------------------

def _check_scan(spec: TopnSpec, cols, rowmask, k: int) -> None:
    if len(cols) != len(spec.col_kinds) or len(cols) > K.MAX_COLS or \
            len(spec.preds) > K.MAX_PREDS:
        raise ValueError("topn_scan: one (data, mask) pair per input slot, "
                         f"at most {K.MAX_COLS}")
    if rowmask.dtype != torch.bool or rowmask.dim() != 2 or \
            rowmask.shape[1] != 128:
        raise ValueError("rowmask: (R, 128) bool")
    for data, mask in cols:
        if data.shape != rowmask.shape or mask.shape != rowmask.shape:
            raise ValueError("column tiles: same shape as the row mask")
    if not 0 <= spec.key_slot < len(cols):
        raise ValueError("key slot outside the input slots")
    if not 1 <= k <= min(TOPN_MAX_K, rowmask.numel()):
        raise ValueError(f"k={k} outside [1, min({TOPN_MAX_K}, rows)]")


def topn_scan_plain(spec: TopnSpec, cols, rowmask: torch.Tensor, k: int):
    """Plain version of `topn_scan`: the same (indices, survivor count)."""
    LAUNCHES.bump("topn_scan.plain")
    _check_scan(spec, cols, rowmask, k)
    n = rowmask.numel()
    env = [(K.decode_plain(kind, off, data.reshape(-1)), mask.reshape(-1))
           for (data, mask), kind, off in zip(cols, spec.col_kinds,
                                              spec.col_offsets)]
    m = rowmask.reshape(-1).clone()
    for ops in spec.preds:
        v, ok = K.eval_plain(ops, env, n)
        m &= (v != 0) & ok
    hi = _key_hi(env[spec.key_slot][0], spec.desc, spec.is_float)
    sent = K.IMG_NEG_INF if spec.is_float else 0       # -inf, int32 min
    hi = torch.where(m, hi, torch.full_like(hi, sent))
    return _select_plain(hi, k), m.sum().reshape(1).to(torch.int64)


def _select_buffers(n: int, k: int, device):
    return (torch.empty(n, dtype=torch.int64, device=device),       # keys
            torch.zeros(3, dtype=torch.int64, device=device),       # state
            torch.zeros(_BINS, dtype=torch.int32, device=device),   # hist
            torch.empty(k, dtype=torch.int64, device=device),       # sel
            torch.empty(k, dtype=torch.int64, device=device))       # idx


def topn_scan(spec: TopnSpec, cols, rowmask: torch.Tensor, k: int):
    """The k best rows of one table's (R, 128) tiles: cols is one (data,
    mask) pair per input slot, rowmask the row validity. A row survives
    where rowmask and every predicate program are TRUE; the others carry
    the sentinel. Returns (indices (k,) int64 best first, survivor count
    (1,) int64)."""
    tensors = [t for pair in cols for t in pair] + [rowmask]
    if not K._is_cuda(*tensors):
        return topn_scan_plain(spec, cols, rowmask, k)
    _check_scan(spec, cols, rowmask, k)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("topn_scan: tensors must be contiguous")
    n = rowmask.numel()
    if n >= 2**32 - 1:
        raise ValueError("topn_scan: row index past 32 bits")
    dev = rowmask.device
    keys, state, hist, sel, idx = _select_buffers(n, k, dev)
    nsurv = torch.zeros(1, dtype=torch.int64, device=dev)
    d, place, ops = K.new_descriptor(cols, spec.col_kinds, spec.col_offsets,
                                     preds=spec.preds)
    d[K._H_ROWMASK] = rowmask.data_ptr()
    d[_H_ROWS], d[_H_KEYSLOT] = n, spec.key_slot
    d[_H_FLAGS] = (F_DESC if spec.desc else 0) | \
        (F_FLOAT if spec.is_float else 0)
    d[_H_KEYS_OUT], d[_H_HIST], d[_H_NSURV] = keys.data_ptr(), \
        hist.data_ptr(), nsurv.data_ptr()
    desc_dev = torch.from_numpy(K.finish_descriptor(d, ops)).to(dev)
    lib = _build.load("topn")
    LAUNCHES.bump("topn_scan")
    _build.check(lib.topn_scan(desc_dev.data_ptr(), n, k, keys.data_ptr(),
                               state.data_ptr(), hist.data_ptr(),
                               sel.data_ptr(), idx.data_ptr(),
                               K._stream(rowmask)), "topn_scan")
    return idx, nsurv


# -- chain_topn --------------------------------------------------------------

def _check_chain(rowcount, src, G, k, outs) -> None:
    if rowcount.dtype != torch.int64 or rowcount.shape != (G,):
        raise ValueError("rowcount: (G,) int64")
    if src is not None and (src.dtype != torch.int64 or src.shape != (G,)):
        raise ValueError("sort column: (G,) int64")
    if not 1 <= k <= min(TOPN_MAX_K, G):
        raise ValueError(f"k={k} outside [1, min({TOPN_MAX_K}, G)]")
    for o in outs:
        if o.numel() % G or o.element_size() not in (4, 8):
            raise ValueError("stage-1 outputs: G rows of 4- or 8-byte "
                             "elements")


def _picked_shape(o: torch.Tensor, G: int, k: int) -> tuple:
    return (k,) if o.numel() == G else (k, o.numel() // G)


def chain_topn_plain(rowcount, src, stride: int, size: int, desc: bool,
                     k: int, outs):
    """Plain version of `chain_topn`."""
    LAUNCHES.bump("chain_topn.plain")
    G = rowcount.numel()
    _check_chain(rowcount, src, G, k, outs)
    present = rowcount > 0
    if src is not None:
        v = src.to(torch.int32)
    else:
        v = ((torch.arange(G, dtype=torch.int64, device=rowcount.device)
              // stride) % size).to(torch.int32)
    hi = _key_hi(v, desc, False)
    hi = torch.where(present, hi, torch.zeros_like(hi))
    idx = _select_plain(hi, k)
    picked = [o.reshape(G, -1)[idx].reshape(_picked_shape(o, G, k))
              for o in outs]
    return idx, present.sum().reshape(1).to(torch.int64), picked


def chain_topn(rowcount: torch.Tensor, src, stride: int, size: int,
               desc: bool, k: int, outs):
    """Select k of the G group slots: the sort value is `src` (a (G,)
    int64 count column) or, when src is None, the slot's group-key digit
    (slot // stride) % size; v for desc, ~v for asc; slots whose row count
    is 0 take int32 min. Returns (slot indices (k,) int64 best first,
    present-slot count (1,) int64, each output of `outs` gathered to the
    picked rows — (k,) for a (G,) output, (k, w) for a (G*w,) one)."""
    tensors = [rowcount, src, *outs]
    if not K._is_cuda(*tensors):
        return chain_topn_plain(rowcount, src, stride, size, desc, k, outs)
    G = rowcount.numel()
    _check_chain(rowcount, src, G, k, outs)
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("chain_topn: tensors must be contiguous")
    dev = rowcount.device
    keys, state, hist, sel, idx = _select_buffers(G, k, dev)
    npres = torch.zeros(1, dtype=torch.int64, device=dev)
    picked = [torch.empty(_picked_shape(o, G, k), dtype=o.dtype, device=dev)
              for o in outs]
    src_ptrs = np.asarray([o.data_ptr() for o in outs] or [0], np.int64)
    row_words = np.asarray([o.numel() * o.element_size() // (4 * G)
                            for o in outs] or [0], np.int64)
    dst_ptrs = np.asarray([p.data_ptr() for p in picked] or [0], np.int64)
    lib = _build.load("topn")
    LAUNCHES.bump("chain_topn")
    _build.check(lib.chain_topn(
        rowcount.data_ptr(), src.data_ptr() if src is not None else 0, G,
        stride, size, int(desc), k, keys.data_ptr(), state.data_ptr(),
        hist.data_ptr(), npres.data_ptr(), sel.data_ptr(), idx.data_ptr(),
        len(outs), src_ptrs.ctypes.data, row_words.ctypes.data,
        dst_ptrs.ctypes.data, K._stream(rowcount)), "chain_topn")
    return idx, npres, picked
