"""Wrappers of the device-mesh kernels (`csrc/mesh.cu`) and their plain
PyTorch versions.

- `mesh_combine` / `mesh_combine_many` ← the psum / pmin / pmax of
  serenedb_tpu/parallel/mesh.py `apply_axis_combines` (and the psums
  inside `sharded_agg_step`, `sharded_bm25_topk`, `sharded_query_step`,
  `ops/bm25.py` `_mesh_score_fn` and `exec/device_agg.py` `_mesh_wrap`):
  the M shards' partials of each output, read where they lie on the
  mesh's first device (no stack), reduced over the shard axis; every
  output of a call in one launch, more only past the descriptor's caps
  (`combine_launches`). Sums add in shard order 0..M-1 from shard 0's
  value (f32 too, so the result does not depend on a launch's schedule);
  min and max take a NaN from any shard (f32), and compare int32 data as
  unsigned where the caller says (the u32 images of `agg_scan`'s float
  min/max).
- `mesh_agg_partials` ← the body of `sharded_agg_step` for one shard:
  the `lo <= v < hi` and mask filter of a (R, 128) int32 block, the
  selected count (one int32, so R * 128 < 2^31) and the (R, 2) int32
  [hi16, lo16] row sums. One kernel a call, no memset.
- `mesh_score_blocks` ← the scoring body of `sharded_bm25_topk` (BM25
  mode) and `sharded_query_step` (saturation mode, tf / (tf + 1.2)) for
  one shard: gather each posting by `gidx` (entries < 0 are padding),
  its contribution, and the shard's f32 plane of per-doc sums, each
  doc's contributions added in `gidx` order from +0.0. Two kernels a
  call, no memset: the entries bucketed by bin of docs a slice at a
  time, then a block a bin (csrc/mesh.cu's note); `score_plan` mirrors
  the kernel's slices, bins and scratch.

On CUDA tensors each wrapper launches its kernel and counts the call in
`device.LAUNCHES` under its name; on CPU tensors it calls the plain
version (counted under `<name>.plain`). There is no other path. Every
output is exact (integers) or follows one add order that the plain
version writes out, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import LAUNCHES
from . import _build
from .agg_kernels import _is_cuda, _stream
from .bm25_kernels import contrib_plain

#: reduction codes of `mesh_combine` (csrc/mesh.cu MC_*)
COMBINE_OPS = {"sum": 0, "min": 1, "max": 2}
#: element types of `mesh_combine` (csrc/mesh.cu MT_*)
COMBINE_TYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2}
#: scoring modes of `mesh_score_blocks` (csrc/mesh.cu MS_*)
SCORE_MODES = {"bm25": 0, "saturation": 1}
#: the saturation constant of `sharded_query_step` (tf / (tf + 1.2))
SAT_K = 1.2


# -- mesh_combine -------------------------------------------------------------

#: csrc/mesh.cu's caps of one launch (its descriptor goes by value in the
#: 4 KB of kernel parameters): segments (MC_SEGS) and shard pointers
#: (MC_PTRS); a call past either is split into the fewest launches that fit
COMBINE_SEGS = 48
COMBINE_PTRS = 256
#: elements a descriptor segment at most (the kernel's indices are 32-bit):
#: a longer output is cut into several
SEG_MAX = 1 << 30
#: the kernel's code of int32 min/max compared as u32 (csrc/mesh.cu MT_U32)
_U32 = 3


def _parts(parts) -> list:
    """The shards' partials of one output: the rows of an (M, N) stack, or
    a sequence of M tensors."""
    if isinstance(parts, torch.Tensor):
        if parts.dim() != 2 or parts.shape[0] < 1:
            raise ValueError("mesh_combine: a (M, N) stack with M >= 1")
        return list(parts.unbind(0))
    parts = list(parts)
    if not parts:
        raise ValueError("mesh_combine: no parts")
    return parts


def _segments(segments) -> list:
    """(parts list, op, unsigned) a segment, checked."""
    out = []
    for seg in segments:
        parts, op = _parts(seg[0]), seg[1]
        unsigned = bool(seg[2]) if len(seg) > 2 else False
        p0 = parts[0]
        if op not in COMBINE_OPS:
            raise ValueError(f"mesh_combine: op {op!r}")
        if p0.dtype not in COMBINE_TYPES:
            raise TypeError(f"mesh_combine: dtype {p0.dtype}")
        if unsigned and (p0.dtype != torch.int32 or op == "sum"):
            raise ValueError("mesh_combine: unsigned is for int32 min/max")
        if len(parts) > COMBINE_PTRS:
            raise ValueError(f"mesh_combine: {len(parts)} parts, past "
                             f"{COMBINE_PTRS} a launch")
        for p in parts[1:]:
            if p.dtype != p0.dtype or p.numel() != p0.numel() or \
                    p.device != p0.device:
                raise ValueError("mesh_combine: parts differ in dtype, "
                                 "size or device")
        out.append((parts, op, unsigned))
    return out


def combine_launches(segments) -> list:
    """The launches of one call: lists of (segment, start, length) pieces,
    each launch within COMBINE_SEGS pieces and COMBINE_PTRS pointers, in
    order, greedily. Empty outputs take no piece."""
    launches, cur, ptrs = [], [], 0
    for si, (parts, _op, _u) in enumerate(segments):
        n = parts[0].numel()
        for a in range(0, n, SEG_MAX):
            if len(cur) == COMBINE_SEGS or ptrs + len(parts) > COMBINE_PTRS:
                launches.append(cur)
                cur, ptrs = [], 0
            cur.append((si, a, min(SEG_MAX, n - a)))
            ptrs += len(parts)
    if cur:
        launches.append(cur)
    return launches


def _combine_loop(parts: list, op: str, unsigned: bool) -> torch.Tensor:
    """One output as the kernel defines it: an explicit loop over the
    shards, shard 0 first."""
    p0 = parts[0]
    flip = torch.tensor(-(1 << 31), dtype=torch.int32, device=p0.device)
    rows = [r ^ flip for r in parts] if unsigned else list(parts)
    acc = rows[0].clone()
    for r in rows[1:]:
        r = r.reshape(acc.shape)
        if op == "sum":
            acc = acc + r
        elif p0.dtype.is_floating_point:
            nan = torch.full_like(acc, float("nan"))   # 0x7FC00000
            pick = (r < acc) if op == "min" else (r > acc)
            acc = torch.where(torch.isnan(acc) | torch.isnan(r), nan,
                              torch.where(pick, r, acc))
        else:
            acc = torch.minimum(acc, r) if op == "min" else \
                torch.maximum(acc, r)
    return acc ^ flip if unsigned else acc


def mesh_combine_many_plain(segments) -> list:
    """Plain version of `mesh_combine_many`: each output by
    `_combine_loop`; counted once a launch the kernel would make."""
    segs = _segments(segments)
    for _ in combine_launches(segs):
        LAUNCHES.bump("mesh_combine.plain")
    return [_combine_loop(*s) for s in segs]


def mesh_combine_plain(parts, op: str,
                       unsigned: bool = False) -> torch.Tensor:
    """Plain version of `mesh_combine`."""
    return mesh_combine_many_plain([(parts, op, unsigned)])[0]


def mesh_combine_many(segments) -> list:
    """The cross-shard reduction of several outputs in one launch (more
    only past the descriptor's caps): `segments` holds (parts, op) or
    (parts, op, unsigned) a output, parts the M shards' partials of it (an
    (M, N) stack or a sequence of M tensors of one numel and dtype) read
    where they lie, op 'sum' (shard order), 'min' or 'max'. Returns each
    output shaped as its first part."""
    segs = _segments(segments)
    ts = [t for parts, _op, _u in segs for t in parts]
    if not _is_cuda(*ts):
        return mesh_combine_many_plain(segs)
    dev = ts[0].device
    for t in ts:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("mesh_combine: the parts must be contiguous, "
                             "on one card")
    outs = [torch.empty(parts[0].shape, dtype=parts[0].dtype, device=dev)
            for parts, _op, _u in segs]
    descs = combine_descriptors(segs, outs)
    lib = _build.load("mesh") if descs else None
    for desc in descs:
        # the descriptor goes by value: the host array only has to live
        # through the call
        _build.check(lib.mesh_combine(desc.ctypes.data, _stream(outs[0])),
                     "mesh_combine")
        LAUNCHES.bump("mesh_combine")
    return outs


def combine_descriptors(segs: list, outs: list) -> list:
    """The host words of each launch of `combine_launches(segs)` into
    `outs`, as csrc/mesh.cu's `mesh_combine` reads them: the piece count,
    six words a piece (out, n, m, ptr0, type, op), then the pointers."""
    descs = []
    for launch in combine_launches(segs):
        head = 1 + 6 * len(launch)
        n_ptr = sum(len(segs[si][0]) for si, _a, _n in launch)
        desc = np.zeros(head + n_ptr, dtype=np.int64)
        desc[0] = len(launch)
        at = head
        for j, (si, a, n) in enumerate(launch):
            parts, op, unsigned = segs[si]
            es = parts[0].element_size()
            code = _U32 if unsigned else COMBINE_TYPES[parts[0].dtype]
            desc[1 + 6 * j:7 + 6 * j] = (outs[si].data_ptr() + a * es, n,
                                         len(parts), at - head, code,
                                         COMBINE_OPS[op])
            desc[at:at + len(parts)] = [p.data_ptr() + a * es for p in parts]
            at += len(parts)
        descs.append(desc)
    return descs


def mesh_combine(parts, op: str, unsigned: bool = False) -> torch.Tensor:
    """The reduction of the M shards' partials of one output (an (M, N)
    stack, whose rows are the parts, or a sequence of M tensors) over the
    shard axis: 'sum' (shard order), 'min' or 'max'; `unsigned` compares
    int32 words as u32. One launch; shaped as the first part."""
    return mesh_combine_many([(parts, op, unsigned)])[0]


# -- mesh_agg_partials --------------------------------------------------------

def _check_agg(vals: torch.Tensor, mask: torch.Tensor) -> None:
    if vals.dtype != torch.int32 or vals.dim() != 2 or vals.shape[1] != 128:
        raise ValueError("mesh_agg_partials: vals (R, 128) int32")
    if mask.dtype != torch.bool or mask.shape != vals.shape:
        raise ValueError("mesh_agg_partials: mask (R, 128) bool")
    if vals.shape[0] * 128 >= 2**31:
        raise ValueError("mesh_agg_partials: R * 128 lanes past an int32 "
                         "count")


def mesh_agg_partials_plain(vals: torch.Tensor, mask: torch.Tensor,
                            lo: int, hi: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `mesh_agg_partials` (the reference's step body)."""
    LAUNCHES.bump("mesh_agg_partials.plain")
    _check_agg(vals, mask)
    sel = mask & (vals >= int(lo)) & (vals < int(hi))
    cnt = sel.sum(dtype=torch.int64).to(torch.int32).reshape(1)
    v = torch.where(sel, vals, torch.zeros_like(vals))
    parts = torch.stack([(v >> 16).sum(1, dtype=torch.int64),
                         (v & 0xFFFF).sum(1, dtype=torch.int64)], dim=1)
    return cnt, parts.to(torch.int32)


def mesh_agg_partials(vals: torch.Tensor, mask: torch.Tensor, lo: int,
                      hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(count (1,) int32, partials (R, 2) int32 [hi16, lo16]) of the rows
    of one shard's (R, 128) block where mask and lo <= v < hi."""
    if not _is_cuda(vals, mask):
        return mesh_agg_partials_plain(vals, mask, lo, hi)
    _check_agg(vals, mask)
    if not (vals.is_contiguous() and mask.is_contiguous()) or \
            vals.data_ptr() % 16 or mask.data_ptr() % 4:
        raise ValueError("mesh_agg_partials: tensors must be contiguous "
                         "and aligned (16 bytes vals, 4 bytes mask)")
    R = vals.shape[0]
    out = torch.empty(1 + 2 * R, dtype=torch.int32, device=vals.device)
    _build.check(_build.load("mesh").mesh_agg_partials(
        vals.data_ptr(), mask.data_ptr(), R, int(lo), int(hi),
        out.data_ptr(), _stream(vals)), "mesh_agg_partials")
    LAUNCHES.bump("mesh_agg_partials")
    return out[:1], out[1:].view(R, 2)


# -- mesh_score_blocks --------------------------------------------------------

#: csrc/mesh.cu's plan constants: slices at most (a tile block reads a
#: slice's run a thread) and entries a slice at least (one ms_bin_kernel
#: round), bins at most (a slice's histogram in shared memory), the bins
#: a small plane still splits into, the fewest docs a bin (2^2) and the
#: most a tile block (2^13, also a bin's size on a plane past 2M docs)
SLICES_MAX = 256
SLICE_MIN = 2048
BINS_MAX = 16384
BINS_FEW = 512
BIN_SHIFT_MIN = 2
ACC_SHIFT = 13


class ScorePlan(NamedTuple):
    """`mesh_score_blocks`' launch and scratch at (E, ndocs), as
    csrc/mesh.cu `score_plan` computes them: `slices` bin blocks of
    `slice_len` entries; bins of 2^shift docs; `bins * subs` tile blocks
    of 2^acc_shift docs; the stage (8 bytes an entry) and `ends` (bins,
    slices) int32 in one buffer of `bytes`."""
    slices: int
    slice_len: int
    shift: int
    bins: int
    acc_shift: int
    subs: int
    ends_off: int
    bytes: int


def _align16(n: int) -> int:
    return (n + 15) & ~15


def score_plan(E: int, ndocs: int) -> ScorePlan:
    slices = min(max(-(-E // SLICE_MIN), 1), SLICES_MAX)
    slice_len = -(-E // slices) if E > 0 else 1
    shift = ACC_SHIFT
    while shift > BIN_SHIFT_MIN and -(-ndocs >> (shift - 1)) <= BINS_FEW:
        shift -= 1
    while -(-ndocs >> shift) > BINS_MAX:
        shift += 1
    bins = -(-ndocs >> shift)
    acc_shift = min(shift, ACC_SHIFT)
    ends_off = _align16(8 * E)
    return ScorePlan(slices, slice_len, shift, bins, acc_shift,
                     1 << (shift - acc_shift), ends_off,
                     ends_off + _align16(4 * slices * bins))


def _check_score(flat_docs, flat_tfs, norms, gidx, block_term, idf,
                 mode: str) -> None:
    if mode not in SCORE_MODES:
        raise ValueError(f"mesh_score_blocks: mode {mode!r}")
    if gidx.dtype != torch.int32 or gidx.dim() != 2:
        raise ValueError("mesh_score_blocks: gidx (Rb, W) int32")
    if flat_docs.dtype != torch.int32 or flat_tfs.dtype != torch.int32:
        raise TypeError("mesh_score_blocks: flat_docs and flat_tfs int32")
    if mode == "bm25":
        if norms is None or norms.dtype != torch.int32 or \
                idf is None or idf.dtype != torch.float32 or \
                block_term is None or block_term.dtype != torch.int32 or \
                block_term.shape != gidx.shape[:1]:
            raise TypeError("mesh_score_blocks: bm25 takes norms int32, "
                            "block_term (Rb,) int32 and idf f32")


def _entries(flat_docs, flat_tfs, gidx):
    """The valid entries in gidx order: (position, doc, tf f32)."""
    g = gidx.reshape(-1).to(torch.int64)
    pos = torch.nonzero(g >= 0).squeeze(1)
    src = g[pos]
    return pos, flat_docs[src].to(torch.int64), flat_tfs[src].float()


def mesh_score_blocks_plain(flat_docs, flat_tfs, norms, gidx, block_term,
                            idf, avgdl: float, ndocs_pad: int, mode: str,
                            k1: float = 1.2, b: float = 0.75
                            ) -> torch.Tensor:
    """Plain version of `mesh_score_blocks`: a stable sort of the valid
    entries by doc, then per doc its contributions added in gidx order
    from +0.0, one rank at a time."""
    LAUNCHES.bump("mesh_score_blocks.plain")
    _check_score(flat_docs, flat_tfs, norms, gidx, block_term, idf, mode)
    dev = gidx.device
    pos, docs, tfs = _entries(flat_docs, flat_tfs, gidx)
    f32 = torch.float32
    if mode == "bm25":
        from .bm25_kernels import _avg
        dl = norms[docs].float()
        w = idf[block_term.to(torch.int64)[pos // gidx.shape[1]]]
        c = contrib_plain("bm25", tfs, dl, w, k1, b, _avg(avgdl))
    else:
        c = tfs / (tfs + torch.tensor(SAT_K, dtype=f32, device=dev))
    plane = torch.zeros(ndocs_pad, dtype=f32, device=dev)
    if not pos.numel():
        return plane
    order = torch.sort(docs, stable=True).indices
    d, c = docs[order], c[order]
    cnt = torch.bincount(d, minlength=ndocs_pad)
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(d.numel(), device=dev) - start[d]
    for j in range(int(cnt.max())):
        at = rank == j
        plane[d[at]] = plane[d[at]] + c[at]
    return plane


def mesh_score_blocks(flat_docs, flat_tfs, norms, gidx, block_term, idf,
                      avgdl: float, ndocs_pad: int, mode: str,
                      k1: float = 1.2, b: float = 0.75) -> torch.Tensor:
    """(ndocs_pad,) f32 plane of one shard's gathered postings: BM25
    contributions (`mode='bm25'`, `contrib()` with the max(., 1e-9)
    guards) or tf / (tf + 1.2) (`'saturation'`; norms, block_term and
    idf unused), each doc's added in gidx order."""
    ts = [flat_docs, flat_tfs, gidx] + \
        ([norms, block_term, idf] if mode == "bm25" else [])
    if not _is_cuda(*ts):
        return mesh_score_blocks_plain(flat_docs, flat_tfs, norms, gidx,
                                       block_term, idf, avgdl, ndocs_pad,
                                       mode, k1, b)
    _check_score(flat_docs, flat_tfs, norms, gidx, block_term, idf, mode)
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("mesh_score_blocks: tensors must be "
                             "contiguous")
    from .bm25_kernels import _avg
    E = gidx.numel()
    if E >= 2**31 or ndocs_pad >= 2**31:
        raise ValueError("mesh_score_blocks: 2^31 entries or docs")
    dev = gidx.device
    lib = _build.load("mesh")
    buf = torch.empty(score_plan(E, ndocs_pad).bytes, dtype=torch.uint8,
                      device=dev)
    plane = torch.empty(ndocs_pad, dtype=torch.float32, device=dev)
    bm25 = mode == "bm25"
    _build.check(lib.mesh_score_blocks(
        flat_docs.data_ptr(), flat_tfs.data_ptr(),
        norms.data_ptr() if bm25 else None,
        gidx.data_ptr(), block_term.data_ptr() if bm25 else None,
        idf.data_ptr() if bm25 else None, E, gidx.shape[1], ndocs_pad,
        SCORE_MODES[mode], float(k1), float(b), _avg(avgdl),
        buf.data_ptr(), plane.data_ptr(), _stream(gidx)),
        "mesh_score_blocks")
    LAUNCHES.bump("mesh_score_blocks")
    return plane
