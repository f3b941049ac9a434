"""Wrapper of the fused join's probe kernels (`csrc/join.cu`) and their
plain PyTorch version.

`join_probe` ← serenedb_tpu/exec/device_pipeline.py `_probe_phase`
(:1243-1456): per probe row the predicates, the gather of the build
side's per-code match count, the row's output weight, the direct group
code, and one integer accumulation into the group outputs; for RIGHT/FULL
joins the per-code probe presence and then the unmatched build rows,
reduced into the all-NULL group slot (`join_unmatched`, launched by the
same wrapper). The build phase that feeds it — per-code partials — is
`agg_scan` with the build codes as its factorized codes
(exec/device_pipeline.py `_run_fused`).

Outputs follow the reference program's order: the output-row counts,
then per aggregate entry (count,) | (int64 sum, count) | (int32 min/max,
count) | (presence grid,). Counts and sums are int64 (the reference's
8-bit limbs recombine to the same integers).

The wrapper launches the kernels for tensors on a CUDA device and counts
one `join_probe` launch in `device.LAUNCHES`; for tensors on the CPU it
calls the plain version (counted under `join_probe.plain`). There is no
other path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..device import LAUNCHES
from . import _build
from . import agg_kernels as K

# aggregate entry kinds (keep in step with csrc/join.cu)
(JP_COUNT, JP_SUM, JP_MIN, JP_MAX, JP_PRESENCE, JB_COUNT, JB_SUM, JB_MIN,
 JB_MAX) = range(9)
_PROBE_KINDS = (JP_COUNT, JP_SUM, JP_MIN, JP_MAX, JP_PRESENCE)
_H_G, _H_CODES, _H_ROWCOUNT, _H_ROWS, _H_CNT, _H_GSENT, _H_OUTER, _H_PCC, \
    _H_NULLGC = 5, 7, 8, 10, 11, 12, 13, 14, 15


@dataclass
class ProbeAgg:
    """One aggregate entry of the probe phase.

    JP_*: `ops` is a program over the probe slots (its validity gates the
    row: the argument's, ANDed with a FILTER clause by OP_GATE); for
    JP_PRESENCE its value is the distinct column, coded (pkind, plo) into
    [0, pvsize). JB_*: `src` is (per-code value or None, per-code value
    count), (g + 2,) tensors from the build phase (int64 sums, int32
    min/max, int64 counts); `ub_ops`, for RIGHT/FULL, the program over
    the build slots that the unmatched build rows reduce."""
    kind: int
    ops: tuple = ()
    src: tuple = (None, None)
    ub_ops: Optional[tuple] = None
    pkind: int = K.KEY_DICT
    plo: int = 0
    pvsize: int = 1


@dataclass
class ProbeSpec:
    """The probe phase's description: per probe slot its decode (kind,
    offset), the probe predicates, direct key plans (kind, slot, lo,
    size) over group space G, the code sentinel g (probe rows that do not
    survive take g + 1), LEFT/FULL weighting, and the aggregate entries."""
    col_kinds: list
    col_offsets: list
    G: int
    g: int
    outer_left: bool = False
    preds: list = field(default_factory=list)
    keys: list = field(default_factory=list)
    aggs: list = field(default_factory=list)


@dataclass
class UnmatchedSpec:
    """RIGHT/FULL: the build slots' decode, the build predicates and the
    all-NULL group slot the unmatched build rows land in."""
    col_kinds: list
    col_offsets: list
    null_gc: int
    preds: list = field(default_factory=list)


def _outputs(spec: ProbeSpec, device):
    G = spec.G
    z64 = lambda: torch.zeros(G, dtype=torch.int64, device=device)  # noqa
    outs = []
    for a in spec.aggs:
        if a.kind in (JP_COUNT, JB_COUNT):
            outs.append((z64(),))
        elif a.kind in (JP_SUM, JB_SUM):
            outs.append((z64(), z64()))
        elif a.kind in (JP_MIN, JP_MAX, JB_MIN, JB_MAX):
            ident = K.INT32_MAX if a.kind in (JP_MIN, JB_MIN) else K.INT32_MIN
            outs.append((torch.full((G,), ident, dtype=torch.int32,
                                    device=device), z64()))
        elif a.kind == JP_PRESENCE:
            outs.append((torch.zeros(G * a.pvsize, dtype=torch.int32,
                                     device=device),))
        else:
            raise ValueError(f"unknown probe entry kind {a.kind}")
    return z64(), outs


def _check_tiles(cols, kinds, rowmask, codes, what: str) -> None:
    if len(cols) != len(kinds) or len(cols) > K.MAX_COLS:
        raise ValueError(f"{what}: one (data, mask) pair per input slot, at "
                         f"most {K.MAX_COLS}")
    if rowmask.dtype != torch.bool or rowmask.dim() != 2 or \
            rowmask.shape[1] != 128:
        raise ValueError(f"{what}: rowmask (R, 128) bool")
    if codes.dtype != torch.int32 or codes.shape != rowmask.shape:
        raise ValueError(f"{what}: codes (R, 128) int32")
    for data, mask in cols:
        if data.shape != rowmask.shape or mask.shape != rowmask.shape:
            raise ValueError(f"{what}: column tiles of the row mask's shape")


def _check(spec: ProbeSpec, cols, rowmask, codes, cnt_code, right) -> None:
    _check_tiles(cols, spec.col_kinds, rowmask, codes, "join_probe")
    if cnt_code.dtype != torch.int64 or cnt_code.shape != (spec.g + 2,):
        raise ValueError("cnt_code: (g + 2,) int64")
    if len(spec.keys) > K.MAX_KEYS or len(spec.preds) > K.MAX_PREDS or \
            len(spec.aggs) > K.MAX_AGGS:
        raise ValueError("join_probe: spec exceeds the kernel's descriptor")
    for a in spec.aggs:
        if a.kind in _PROBE_KINDS:
            continue
        val, vcnt = a.src
        if vcnt is None or vcnt.dtype != torch.int64 or \
                vcnt.shape != (spec.g + 2,):
            raise ValueError("build partials: (g + 2,) int64 counts")
        want = {JB_SUM: torch.int64, JB_MIN: torch.int32,
                JB_MAX: torch.int32}.get(a.kind)
        if want is not None and (val is None or val.dtype != want or
                                 val.shape != (spec.g + 2,)):
            raise ValueError(f"build partials: (g + 2,) {want} values")
        if right is not None and a.ub_ops is None:
            raise ValueError("RIGHT/FULL: every build entry needs ub_ops")
    if right is not None:
        uspec, bcols, brow, bcodes = right
        _check_tiles(bcols, uspec.col_kinds, brow, bcodes, "join_unmatched")


def _env(cols, kinds, offsets):
    return [(K.decode_plain(k, off, data.reshape(-1)), mask.reshape(-1))
            for (data, mask), k, off in zip(cols, kinds, offsets)]


def _mask(rowmask, preds, env, n):
    m = rowmask.reshape(-1).clone()
    for ops in preds:
        v, ok = K.eval_plain(ops, env, n)
        m &= (v != 0) & ok
    return m


def join_probe_plain(spec: ProbeSpec, cols, rowmask, codes, cnt_code,
                     right=None):
    """Plain version of `join_probe`: the same outputs, whole-column."""
    LAUNCHES.bump("join_probe.plain")
    _check(spec, cols, rowmask, codes, cnt_code, right)
    dev = rowmask.device
    n = rowmask.numel()
    g = spec.g
    rowcount, outs = _outputs(spec, dev)
    env = _env(cols, spec.col_kinds, spec.col_offsets)
    pm = _mask(rowmask, spec.preds, env, n)
    pc = torch.where(pm, codes.reshape(-1).to(torch.int64),
                     torch.full((n,), g + 1, dtype=torch.int64, device=dev))
    cnt = cnt_code[pc]
    w = torch.clamp(cnt, min=1) if spec.outer_left else cnt
    w = torch.where(pm, w, torch.zeros_like(w))
    gc = torch.zeros(n, dtype=torch.int64, device=dev)
    for kind, slot, lo, size in spec.keys:
        data, ok = env[slot]
        c = data.to(torch.int64) if kind == K.KEY_DICT else \
            K._wrap32(data.to(torch.int64) - lo).to(torch.int64)
        c = torch.where(ok, c, torch.full_like(c, size - 1))
        gc = gc * size + c.clamp(0, size - 1)
    gc = torch.where(pm, gc, torch.zeros_like(gc))
    rowcount.index_add_(0, gc, w)
    zero = torch.zeros_like(w)
    for a, out in zip(spec.aggs, outs):
        if a.kind in _PROBE_KINDS:
            v, ok = K.eval_plain(a.ops, env, n)
            m = pm & ok
            if a.kind == JP_PRESENCE:
                pres = m & (w > 0)
                vc = v.to(torch.int64) if a.pkind == K.KEY_DICT else \
                    K._wrap32(v.to(torch.int64) - a.plo).to(torch.int64)
                vc = vc.clamp(0, a.pvsize - 1)
                out[0][(gc * a.pvsize + vc)[pres]] = 1
                continue
            vp = torch.where(m, w, zero)
            if a.kind == JP_COUNT:
                out[0].index_add_(0, gc, vp)
            elif a.kind == JP_SUM:
                out[0].index_add_(0, gc, K._i32(v).to(torch.int64) * vp)
                out[1].index_add_(0, gc, vp)
            else:
                sel = m & (w > 0)
                red = "amin" if a.kind == JP_MIN else "amax"
                out[0].scatter_reduce_(0, gc[sel], K._i32(v)[sel], red)
                out[1].index_add_(0, gc, vp)
            continue
        val, vcnt = a.src
        gathered = torch.where(pm, vcnt[pc], zero)
        if a.kind == JB_COUNT:
            out[0].index_add_(0, gc, gathered)
        elif a.kind == JB_SUM:
            out[0].index_add_(0, gc, torch.where(pm, val[pc], zero))
            out[1].index_add_(0, gc, gathered)
        else:
            sel = gathered > 0
            red = "amin" if a.kind == JB_MIN else "amax"
            out[0].scatter_reduce_(0, gc[sel], val[pc][sel], red)
            out[1].index_add_(0, gc, gathered)
    if right is not None:
        _unmatched_plain(spec, right, pm, pc, rowcount, outs)
    return rowcount, outs


def _unmatched_plain(spec: ProbeSpec, right, pm, pc, rowcount, outs):
    uspec, bcols, brow, bcodes = right
    dev = brow.device
    pcc = torch.zeros(spec.g + 2, dtype=torch.int64, device=dev)
    pcc.index_add_(0, pc[pm], torch.ones_like(pc[pm]))
    nb = brow.numel()
    benv = _env(bcols, uspec.col_kinds, uspec.col_offsets)
    bm = _mask(brow, uspec.preds, benv, nb)
    bc = torch.where(bm, bcodes.reshape(-1).to(torch.int64),
                     torch.full((nb,), spec.g, dtype=torch.int64, device=dev))
    ub = bm & (pcc[bc] == 0)
    at = uspec.null_gc
    rowcount[at] += ub.sum()
    for a, out in zip(spec.aggs, outs):
        if a.kind in _PROBE_KINDS:
            continue
        v, ok = K.eval_plain(a.ub_ops, benv, nb)
        mu = ub & ok
        if a.kind == JB_COUNT:
            out[0][at] += mu.sum()
            continue
        out[1][at] += mu.sum()
        vals = K._i32(v)[mu]
        if a.kind == JB_SUM:
            out[0][at] += vals.to(torch.int64).sum()
        elif vals.numel():
            red = vals.min() if a.kind == JB_MIN else vals.max()
            out[0][at] = torch.minimum(out[0][at], red) \
                if a.kind == JB_MIN else torch.maximum(out[0][at], red)


def _descriptor(spec_cols, kinds, offsets, keys, preds, aggs_words,
                header: dict):
    d, place, ops = K.new_descriptor(spec_cols, kinds, offsets, keys, preds)
    for word, value in header.items():
        d[word] = value
    d[K._H_NAGGS] = len(aggs_words)
    for i, (prog, rest) in enumerate(aggs_words):
        start, count = place(prog)
        words = [rest[0], start, count] + list(rest[1:])
        words += [0] * (K._AGG_W - len(words))
        d[K._AGGS + K._AGG_W * i: K._AGGS + K._AGG_W * (i + 1)] = words
    return K.finish_descriptor(d, ops)


def join_probe(spec: ProbeSpec, cols, rowmask: torch.Tensor,
               codes: torch.Tensor, cnt_code: torch.Tensor, right=None):
    """The probe phase over one probe table's (R, 128) tiles: cols is one
    (data, mask) pair per probe slot, codes the (R, 128) int32 join codes,
    cnt_code the build phase's (g + 2,) int64 match counts. `right` is
    None, or for RIGHT/FULL (UnmatchedSpec, build cols, build row mask,
    build codes). Returns (output-row counts (G,) int64, [per entry])."""
    tensors = [t for pair in cols for t in pair] + [rowmask, codes, cnt_code]
    for a in spec.aggs:
        tensors.extend(t for t in a.src if t is not None)
    if right is not None:
        tensors.extend([t for pair in right[1] for t in pair] +
                       [right[2], right[3]])
    if not K._is_cuda(*tensors):
        return join_probe_plain(spec, cols, rowmask, codes, cnt_code, right)
    _check(spec, cols, rowmask, codes, cnt_code, right)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("join_probe: tensors must be contiguous")
    dev = rowmask.device
    rowcount, outs = _outputs(spec, dev)
    pcc = torch.zeros(spec.g + 2, dtype=torch.int32, device=dev) \
        if right is not None else None
    words = []
    for a, out in zip(spec.aggs, outs):
        o0 = out[0].data_ptr()
        o1 = out[1].data_ptr() if len(out) > 1 else 0
        if a.kind in _PROBE_KINDS:
            words.append((a.ops, (a.kind, o0, o1, 0, 0, a.pkind, a.plo,
                                  a.pvsize)))
        else:
            val, vcnt = a.src
            words.append(((), (a.kind, o0, o1,
                               val.data_ptr() if val is not None else 0,
                               vcnt.data_ptr())))
    d = _descriptor(cols, spec.col_kinds, spec.col_offsets, spec.keys,
                    spec.preds, words, {
                        K._H_ROWMASK: rowmask.data_ptr(), _H_G: spec.G,
                        _H_CODES: codes.data_ptr(),
                        _H_ROWCOUNT: rowcount.data_ptr(),
                        _H_ROWS: rowmask.numel(),
                        _H_CNT: cnt_code.data_ptr(), _H_GSENT: spec.g,
                        _H_OUTER: int(spec.outer_left),
                        _H_PCC: pcc.data_ptr() if pcc is not None else 0})
    descs = [torch.from_numpy(d).to(dev)]
    if right is not None:
        uspec, bcols, brow, bcodes = right
        uwords = [(a.ub_ops, (a.kind, out[0].data_ptr(),
                              out[1].data_ptr() if len(out) > 1 else 0))
                  for a, out in zip(spec.aggs, outs)
                  if a.kind not in _PROBE_KINDS]
        ud = _descriptor(bcols, uspec.col_kinds, uspec.col_offsets, (),
                         uspec.preds, uwords, {
                             K._H_ROWMASK: brow.data_ptr(),
                             _H_CODES: bcodes.data_ptr(),
                             _H_ROWCOUNT: rowcount.data_ptr(),
                             _H_ROWS: brow.numel(), _H_GSENT: spec.g,
                             _H_PCC: pcc.data_ptr(),
                             _H_NULLGC: uspec.null_gc})
        descs.append(torch.from_numpy(ud).to(dev))
    lib = _build.load("join")
    stream = K._stream(rowmask)
    LAUNCHES.bump("join_probe")
    _build.check(lib.join_probe(descs[0].data_ptr(), rowmask.numel(),
                                stream), "join_probe")
    if right is not None:
        LAUNCHES.bump("join_unmatched")
        _build.check(lib.join_unmatched(descs[1].data_ptr(),
                                        right[2].numel(), stream),
                     "join_unmatched")
    return rowcount, outs
