"""Wrappers of the top-N CUDA kernels (`csrc/topn.cu`) and their plain
PyTorch versions.

- `topn_scan` ← serenedb_tpu/exec/device_topn.py `_topn_indices` (`prog`
  :202) and exec/device_pipeline.py `_run_fused_topn` (:2582): decode,
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
version (counted under `<name>.plain`). There is no other path. A call's
outputs and scratch are views of one buffer that the kernel fills (no
fill beforehand), its descriptor or arguments go by value: no copy to the
card.
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
#: chain_topn runs as one block in one launch up to this many group slots
#: (at most 32,768, what the block's shared memory holds); above it, as
#: topn_scan's passes plus one gather. Set from card timings
#: (scripts/topn_shapes.py, PERF.md): the one block's device time is
#: below the passes' up to 16,384 slots and about theirs at 32,768, where
#: it still saves five launches a call.
CHAIN_ONE_MAX = 32768
#: stage-1 outputs one chain_topn call gathers
CHAIN_MAX_OUT = 64
F_DESC, F_FLOAT = 1, 2
_H_KEYSLOT, _H_FLAGS = 11, 12


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


def topn_scan(spec: TopnSpec, cols, rowmask: torch.Tensor, k: int):
    """The k best rows of one table's (R, 128) tiles: cols is one (data,
    mask) pair per input slot, rowmask the row validity. A row survives
    where rowmask and every predicate program are TRUE; the others carry
    the sentinel. Returns (indices (k,) int64 best first, survivor count
    (1,) int64): views of the one buffer the call writes, its scratch
    after them."""
    tensors = [t for pair in cols for t in pair] + [rowmask]
    if not K._is_cuda(*tensors):
        return topn_scan_plain(spec, cols, rowmask, k)
    _check_scan(spec, cols, rowmask, k)
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("topn_scan: tensors must be contiguous tiles "
                             "at 16-byte boundaries")
    n = rowmask.numel()
    if n >= 2**32 - 1:
        raise ValueError("topn_scan: row index past 32 bits")
    d, _place, ops = K.new_descriptor(cols, spec.col_kinds, spec.col_offsets,
                                      preds=spec.preds)
    d[K._H_ROWMASK] = rowmask.data_ptr()
    d[_H_KEYSLOT] = spec.key_slot
    d[_H_FLAGS] = (F_DESC if spec.desc else 0) | \
        (F_FLOAT if spec.is_float else 0)
    desc = K.finish_descriptor(d, ops)
    lib = _build.load("topn")
    size = lib.topn_bytes(n, k)
    words = torch.empty(-(-size // 8), dtype=torch.int64,
                        device=rowmask.device)
    LAUNCHES.bump("topn_scan")
    _build.check(lib.topn_scan(desc.ctypes.data, n, k, words.data_ptr(),
                               size, K._stream(rowmask)), "topn_scan")
    return words[:k], words[k:k + 1]


# -- chain_topn --------------------------------------------------------------

def _check_chain(rowcount, src, G, k, outs) -> None:
    if rowcount.dtype != torch.int64 or rowcount.shape != (G,):
        raise ValueError("rowcount: (G,) int64")
    if src is not None and (src.dtype != torch.int64 or src.shape != (G,)):
        raise ValueError("sort column: (G,) int64")
    if not 1 <= k <= min(TOPN_MAX_K, G):
        raise ValueError(f"k={k} outside [1, min({TOPN_MAX_K}, G)]")
    if len(outs) > CHAIN_MAX_OUT:
        raise ValueError(f"at most {CHAIN_MAX_OUT} stage-1 outputs")
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
    cuda = rowcount.is_cuda
    if (src is not None and src.is_cuda != cuda) or \
            any(o.is_cuda != cuda for o in outs):
        raise ValueError("chain_topn: tensors on mixed devices")
    if not cuda:
        return chain_topn_plain(rowcount, src, stride, size, desc, k, outs)
    if not (rowcount.is_contiguous() and
            (src is None or src.is_contiguous()) and
            all(o.is_contiguous() for o in outs)):
        raise ValueError("chain_topn: tensors must be contiguous")
    G = rowcount.numel()
    lib = _build.load("topn")
    words_n, head, views, row_words = _chain_layout(lib, rowcount, src, G, k,
                                                    outs)
    buf = torch.empty(words_n, dtype=torch.int64, device=rowcount.device)
    typed = {torch.int64: buf}
    picked = []
    for dtype, shape, at in views:
        if dtype not in typed:
            typed[dtype] = buf.view(dtype)
        v = typed[dtype][at:at + k * (shape[1] if len(shape) > 1 else 1)]
        picked.append(v if len(shape) == 1 else v.view(shape))
    args = np.array([rowcount.data_ptr(),
                     src.data_ptr() if src is not None else 0, G, stride,
                     size, int(desc), k, buf.data_ptr(), head, len(outs),
                     CHAIN_ONE_MAX, *[o.data_ptr() for o in outs],
                     *row_words, *[p.data_ptr() for p in picked]], np.int64)
    LAUNCHES.bump("chain_topn")
    _build.check(lib.chain_topn(args.ctypes.data, K._stream(rowcount)),
                 "chain_topn")
    return buf[:k], buf[k:k + 1], picked


_CHAIN_LAYOUTS: dict = {}


def _chain_layout(lib, rowcount, src, G: int, k: int, outs) -> tuple:
    """The call's buffer, by the shapes alone (kept per shape, checked
    the first time): its size in int64 words; the kernel's part in bytes
    (the slots, the count and, above the cap, the selection's scratch);
    then each output's picked rows at a 16-byte boundary, as (dtype,
    shape, offset in elements); and each output's 4-byte words a slot."""
    key = (rowcount.dtype, rowcount.shape, k, CHAIN_ONE_MAX,
           None if src is None else (src.dtype, src.shape),
           tuple((o.dtype, o.numel()) for o in outs))
    layout = _CHAIN_LAYOUTS.get(key)
    if layout is None:
        _check_chain(rowcount, src, G, k, outs)
        head = lib.chain_bytes(G, k, CHAIN_ONE_MAX)
        views, at = [], head
        for o in outs:
            esize = o.element_size()
            at = -(-at // 16) * 16
            views.append((o.dtype, _picked_shape(o, G, k), at // esize))
            at += k * (o.numel() // G) * esize
        row_words = [o.numel() * o.element_size() // (4 * G) for o in outs]
        layout = (-(-max(at, head) // 8), head, views, row_words)
        if len(_CHAIN_LAYOUTS) < 256:
            _CHAIN_LAYOUTS[key] = layout
    return layout
