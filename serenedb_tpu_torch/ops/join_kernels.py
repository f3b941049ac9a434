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
one `join_probe` launch (and one `join_unmatched`) in `device.LAUNCHES`;
for tensors on the CPU it calls the plain version (counted under
`join_probe.plain`). There is no other path. A card call is one
allocation carved into every output, init + probe (+ unmatched) launches
with the descriptors by value, and the probe's regime (`probe_regime`)
from the spec alone; what the spec fixes (regime, layout, descriptor
templates) is kept per spec (`_Plan`).
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
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
#: the probe's regimes (csrc/join.cu): block-private cells in shared
#: memory, or leader-elected global atomics
REGIME_SMALL, REGIME_LARGE = 0, 1
#: shared bytes of one block's cells in the SMALL regime
PROBE_SMALL_BYTES = 48 << 10
#: kernels one call launches on the card: init and probe, and the
#: unmatched pass for RIGHT/FULL
CALL_LAUNCHES = {False: 2, True: 3}


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


# -- the card's call ---------------------------------------------------------

def _units(kind: int) -> tuple[int, int]:
    """(64-bit, 32-bit) cell arrays of G cells an entry takes in the SMALL
    regime's shared memory (csrc/join.cu `units64`/`units32`)."""
    if kind in (JP_SUM, JB_SUM):
        return 2, 0
    if kind == JP_PRESENCE:
        return 0, 0
    return 1, int(kind in (JP_MIN, JP_MAX, JB_MIN, JB_MAX))


def probe_cells_bytes(spec: ProbeSpec) -> int:
    """Shared bytes of one block's cells in the SMALL regime: the row
    counts and each entry's 64-bit cells, then the min/max values."""
    n64 = 1 + sum(_units(a.kind)[0] for a in spec.aggs)
    n32 = sum(_units(a.kind)[1] for a in spec.aggs)
    return (8 * n64 + 4 * n32) * spec.G


def probe_regime(spec: ProbeSpec) -> int:
    """SMALL where every output's G cells fit a block's shared-memory
    budget (block-private cells, one flush a block), else LARGE (leader-
    elected global atomics). From the spec alone; csrc/join.cu's entry
    computes the same and refuses a call that disagrees."""
    return REGIME_SMALL if probe_cells_bytes(spec) <= PROBE_SMALL_BYTES \
        else REGIME_LARGE


class _Plan:
    """What a card call of one spec needs that the spec alone fixes: the
    regime, the outputs' layout in the call's one buffer, and (after the
    first call) the descriptors' words, of which a call writes only the
    pointers and row counts (`_probe_positions`)."""

    def __init__(self, spec: ProbeSpec, pcc_len: int):
        self.regime = probe_regime(spec)
        G = spec.G
        # the int64 arrays first (w), then the int32 ones that start at 0
        # (z: presence grids, pcc), at INT32_MAX (x: MIN values) and at
        # INT32_MIN (n: MAX values); shape: per entry its arrays as (kind,
        # index)
        w64, z32, mx, mn, shape = [G], [], [], [], []
        for a in spec.aggs:
            if a.kind in (JP_COUNT, JB_COUNT):
                shape.append((("w", len(w64)),))
                w64.append(G)
            elif a.kind in (JP_SUM, JB_SUM):
                shape.append((("w", len(w64)), ("w", len(w64) + 1)))
                w64 += [G, G]
            elif a.kind in (JP_MIN, JB_MIN):
                shape.append((("x", len(mx)), ("w", len(w64))))
                mx.append(G)
                w64.append(G)
            elif a.kind in (JP_MAX, JB_MAX):
                shape.append((("n", len(mn)), ("w", len(w64))))
                mn.append(G)
                w64.append(G)
            elif a.kind == JP_PRESENCE:
                shape.append((("z", len(z32)),))
                z32.append(G * a.pvsize)
            else:
                raise ValueError(f"unknown probe entry kind {a.kind}")
        if pcc_len:
            z32.append(pcc_len)
        # one int64 buffer: the int64 arrays, then the int32 ones packed
        # two a word (an odd count leaves a pad word, never read)
        narrow = z32 + mx + mn
        nn = sum(narrow)
        self.sizes = w64 + ([-(-nn // 2)] if nn else [])
        if nn % 2 or len(narrow) > 1:
            self.narrow = narrow + [1] * (nn % 2)
        else:
            self.narrow = None      # the one int32 array is the region
        base = {"z": len(w64), "x": len(w64) + len(z32),
                "n": len(w64) + len(z32) + len(mx)}
        flat = [tuple(i if k == "w" else base[k] + i for k, i in e)
                for e in shape]
        self.outs = [operator.itemgetter(*e) if len(e) > 1 else
                     (lambda v, i=e[0]: (v[i],)) for e in flat]
        self.pcc = base["z"] + len(z32) - 1 if pcc_len else None
        self.words = sum(self.sizes)
        self.n64 = len(w64)
        self.sections = (2 * sum(w64) + sum(z32), sum(mx), sum(mn))
        self.tmpl = None        # (probe template, positions, unmatched's)

    def carve(self, device):
        """(buf, rowcount, outs, pcc): every output and pcc as views of
        one buffer, left unset (the call's init launch sets them)."""
        buf = torch.empty(self.words, dtype=torch.int64, device=device)
        views = list(torch.split_with_sizes(buf, self.sizes))
        if len(views) > self.n64:
            region = views.pop().view(torch.int32)
            views += torch.split_with_sizes(region, self.narrow) \
                if self.narrow is not None else (region,)
        return (buf, views[0], [g(views) for g in self.outs],
                views[self.pcc] if self.pcc is not None else None)


#: plans by spec (`_key`)
_PLANS: dict = {}
_PLANS_MAX = 256


def _key(spec: ProbeSpec, right) -> Optional[tuple]:
    """The spec's content as a hashable key, or None (a list somewhere in
    its programs: no plan is kept)."""
    key = (tuple(spec.col_kinds), tuple(spec.col_offsets), spec.G, spec.g,
           spec.outer_left, tuple(spec.preds), tuple(spec.keys),
           tuple((a.kind, a.ops, a.pkind, a.plo, a.pvsize, a.ub_ops)
                 for a in spec.aggs))
    if right is not None:
        uspec = right[0]
        key += (tuple(uspec.col_kinds), tuple(uspec.col_offsets),
                uspec.null_gc, tuple(uspec.preds))
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _plan(spec: ProbeSpec, right) -> _Plan:
    key = _key(spec, right)
    plan = _PLANS.get(key) if key is not None else None
    if plan is None:
        plan = _Plan(spec, spec.g + 2 if right is not None else 0)
        if key is not None:
            if len(_PLANS) >= _PLANS_MAX:
                _PLANS.clear()
            _PLANS[key] = plan
    return plan


def _probe_positions(n_cols: int, n_aggs: int, probe: bool) -> np.ndarray:
    """The words of a descriptor that hold pointers or the row count, in
    the order `_probe_values` gives them."""
    pos = []
    for i in range(n_cols):
        pos += [K._COLS + K._COL_W * i, K._COLS + K._COL_W * i + 1]
    pos += [K._H_ROWMASK, _H_CODES, _H_ROWCOUNT, _H_ROWS, _H_PCC]
    if probe:
        pos.append(_H_CNT)
    per = (3, 4, 5, 6) if probe else (3, 4)
    for i in range(n_aggs):
        pos += [K._AGGS + K._AGG_W * i + w for w in per]
    return np.asarray(pos, dtype=np.int64)


def _probe_values(spec, cols, rowmask, codes, cnt_code, rowcount, outs,
                  pcc) -> list:
    vals = [t.data_ptr() for pair in cols for t in pair]
    vals += [rowmask.data_ptr(), codes.data_ptr(), rowcount.data_ptr(),
             rowmask.numel(), pcc.data_ptr() if pcc is not None else 0,
             cnt_code.data_ptr()]
    for a, out in zip(spec.aggs, outs):
        val, vcnt = a.src
        vals += [out[0].data_ptr(),
                 out[1].data_ptr() if len(out) > 1 else 0,
                 val.data_ptr() if val is not None else 0,
                 vcnt.data_ptr() if vcnt is not None else 0]
    return vals


def _unmatched_values(spec, right, rowcount, outs, pcc) -> list:
    _uspec, bcols, brow, bcodes = right
    vals = [t.data_ptr() for pair in bcols for t in pair]
    vals += [brow.data_ptr(), bcodes.data_ptr(), rowcount.data_ptr(),
             brow.numel(), pcc.data_ptr()]
    for a, out in zip(spec.aggs, outs):
        if a.kind not in _PROBE_KINDS:
            vals += [out[0].data_ptr(),
                     out[1].data_ptr() if len(out) > 1 else 0]
    return vals


def _fresh_descriptors(spec, cols, rowmask, codes, cnt_code, rowcount, outs,
                       pcc, right):
    """The probe descriptor (and the unmatched pass's, or None), built
    word by word."""
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
    if right is None:
        return d, None
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
    return d, ud


def probe_descriptors(plan: Optional[_Plan], spec, cols, rowmask, codes,
                      cnt_code, rowcount, outs, pcc, right=None):
    """The call's descriptors (probe, unmatched or None): the plan's
    templates with this call's pointers and row counts written in, or
    (plan None) a fresh build, which also becomes the plan's templates;
    the two are equal word for word."""
    if plan is None or plan.tmpl is None:
        d, ud = _fresh_descriptors(spec, cols, rowmask, codes, cnt_code,
                                   rowcount, outs, pcc, right)
        if plan is not None:
            n_build = sum(a.kind not in _PROBE_KINDS for a in spec.aggs)
            plan.tmpl = (
                d.copy(), _probe_positions(len(cols), len(spec.aggs), True),
                None if ud is None else (ud.copy(), _probe_positions(
                    len(right[1]), n_build, False)))
        return d, ud
    (tmpl, pos), un = plan.tmpl[:2], plan.tmpl[2]
    d = tmpl.copy()
    d[pos] = _probe_values(spec, cols, rowmask, codes, cnt_code, rowcount,
                           outs, pcc)
    ud = None
    if un is not None:
        ud = un[0].copy()
        ud[un[1]] = _unmatched_values(spec, right, rowcount, outs, pcc)
    return d, ud


def join_probe(spec: ProbeSpec, cols, rowmask: torch.Tensor,
               codes: torch.Tensor, cnt_code: torch.Tensor, right=None):
    """The probe phase over one probe table's (R, 128) tiles: cols is one
    (data, mask) pair per probe slot, codes the (R, 128) int32 join codes,
    cnt_code the build phase's (g + 2,) int64 match counts. `right` is
    None, or for RIGHT/FULL (UnmatchedSpec, build cols, build row mask,
    build codes). Returns (output-row counts (G,) int64, [per entry]).

    On the card one call is one allocation (every output a view of it)
    and `CALL_LAUNCHES` kernels: init, probe (+ unmatched), both
    descriptors by value; no host-to-device copy, no stream sync."""
    tensors = [t for pair in cols for t in pair] + [rowmask, codes, cnt_code]
    for a in spec.aggs:
        tensors.extend(t for t in a.src if t is not None)
    if right is not None:
        tensors.extend([t for pair in right[1] for t in pair] +
                       [right[2], right[3]])
    if not all(t.is_cuda for t in tensors) and \
            not K._is_cuda(*tensors):
        return join_probe_plain(spec, cols, rowmask, codes, cnt_code, right)
    _check(spec, cols, rowmask, codes, cnt_code, right)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("join_probe: tensors must be contiguous")
    plan = _plan(spec, right)
    buf, rowcount, outs, pcc = plan.carve(rowmask.device)
    d, ud = probe_descriptors(plan, spec, cols, rowmask, codes, cnt_code,
                              rowcount, outs, pcc, right)
    lib = _build.load("join")
    LAUNCHES.bump("join_probe")
    if right is not None:
        LAUNCHES.bump("join_unmatched")
    # the descriptors go by value: the host arrays only have to live
    # through the call
    zero, n_max, n_min = plan.sections
    _build.check(lib.join_probe(
        d.ctypes.data, plan.regime, rowmask.numel(), buf.data_ptr(), zero,
        n_max, n_min, ud.ctypes.data if ud is not None else None,
        right[2].numel() if right is not None else 0, K._stream(rowmask)),
        "join_probe")
    return rowcount, outs
