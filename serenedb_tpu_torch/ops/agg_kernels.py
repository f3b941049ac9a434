"""Wrappers of the analytics CUDA kernels (`csrc/agg.cu`) and their plain
PyTorch versions.

- `agg_scan` ← serenedb_tpu/exec/device_agg.py `_run` → `program`
  (:251-301) with the ops/agg.py reductions in its body: frame-of-
  reference decode, the predicate programs (SQL three-valued logic),
  group codes (direct key plans, factorized codes, or one group),
  then per aggregate a count, an exact int64 sum, an f32 sum into a
  per-warp partial plane, an int or f32 min/max, or a DISTINCT presence
  grid (`_presence_scatter` :455).
- `agg_fold` ← the f32 scatter-add of ops/agg.py `group_sum_float`
  (:117): adds the partial plane's P rows of each group in order of p.

An expression is a flat postfix program (`exec/device.compile_expr`
lowers a bound expression to one): a tuple of (opcode, arg, imm) with
imm a 32-bit pattern (int32, or an f32's bits). The kernel interprets it
per row on a stack of (32-bit value, valid bit) entries.

Each wrapper launches its kernel for tensors on a CUDA device and counts
the launch in `device.LAUNCHES`; for tensors on the CPU it calls the plain
version (counted under `<name>.plain`). There is no other path. The plain
versions compute the same function: integer outputs are exact in any
order, min/max go through the same order-preserving u32 image as the
kernel, and the f32 sums add each (warp range, group) cell in row order
and fold the cells in order of p, so kernel and plain version agree bit
for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import LAUNCHES
from . import _build

# -- the ABI shared with csrc/agg.cu (keep the two in step) ------------------

# opcodes
(OP_COL, OP_I32, OP_F32, OP_NULL, OP_I2F, OP_F2I, OP_TOBOOL_I, OP_TOBOOL_F,
 OP_NOT, OP_AND, OP_OR, OP_IS_NULL, OP_IS_NOT_NULL, OP_CMP_I, OP_CMP_F,
 OP_ADD_I, OP_SUB_I, OP_MUL_I, OP_ADD_F, OP_SUB_F, OP_MUL_F, OP_WRAP8,
 OP_SETV, OP_SHRA, OP_SHRL, OP_ANDI, OP_GATE) = range(27)
#: comparison codes (the `arg` of OP_CMP_*)
CMP_CODES = {"=": 0, "<>": 1, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
# column decode kinds
COL_I32, COL_I8, COL_F32, COL_U8, COL_U16 = range(5)
# aggregate kinds
(AGG_COUNT, AGG_SUM_I, AGG_SUM_F, AGG_MIN_I, AGG_MAX_I, AGG_MIN_F,
 AGG_MAX_F, AGG_PRESENCE) = range(8)
# key / presence value coding
KEY_DICT, KEY_INT = 0, 1

MAX_COLS, MAX_KEYS, MAX_PREDS, MAX_AGGS, MAX_OPS = 16, 8, 8, 16, 192
#: stack entries of the per-row interpreter (exec/device.py refuses a
#: deeper program)
MAX_STACK = 8
DESC_WORDS = 480
_H_NCOLS, _H_NKEYS, _H_FACT, _H_NPREDS, _H_NAGGS, _H_G, _H_ROWMASK, \
    _H_CODES, _H_ROWCOUNT, _H_ROW_START, _H_ROW_END, _H_RPW, _H_P = range(13)
_COLS, _KEYS, _PREDS, _AGGS, _OPS = 16, 80, 112, 128, 288
_COL_W, _KEY_W, _PRED_W, _AGG_W = 4, 4, 2, 10

WARP_ROWS = 32
#: warps per block of agg_scan
BLOCK_WARPS = 8
#: most warps (row ranges) one agg_scan launch splits its rows into
MAX_WARPS = 8192
#: byte budget of the f32 partial plane (P, G) of the float sums
FLOAT_PLANE_BYTES = 256 << 20

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
#: order-preserving u32 images of +inf and -inf (identities of MIN_F and
#: MAX_F), as int32 bit patterns
IMG_POS_INF = 0xFF800000 - 2**32
IMG_NEG_INF = 0x007FFFFF


@dataclass
class ScanAgg:
    """One aggregate of a scan: `kind`, its argument program (`ops`, None
    for a presence grid), and for AGG_PRESENCE the value coding
    (column slot, KEY_DICT|KEY_INT, lo, vsize)."""
    kind: int
    ops: Optional[tuple] = None
    pslot: int = 0
    pkind: int = KEY_DICT
    plo: int = 0
    pvsize: int = 1


@dataclass
class ScanSpec:
    """What one agg_scan launch computes, independent of the data:
    per input slot its decode (kind, offset); the predicate programs;
    direct key plans (kind, slot, lo, size) or factorized codes; the group
    count G; the aggregates."""
    col_kinds: list
    col_offsets: list
    preds: list = field(default_factory=list)
    keys: list = field(default_factory=list)
    factorized: bool = False
    G: int = 1
    aggs: list = field(default_factory=list)

    def has_float_sum(self) -> bool:
        return any(a.kind == AGG_SUM_F for a in self.aggs)


def col_kind(dc) -> tuple[int, int]:
    """(decode kind, offset) of a columnar.device.DeviceColumn."""
    if dc.scheme == "for8":
        return COL_U8, dc.offset
    if dc.scheme == "for16":
        return COL_U16, dc.offset
    kind = {torch.int32: COL_I32, torch.int8: COL_I8,
            torch.float32: COL_F32}.get(dc.data.dtype)
    if kind is None:
        raise TypeError(f"no decode for device dtype {dc.data.dtype}")
    return kind, 0


def partition(n_rows: int, G: int, float_sum: bool) -> tuple[int, int]:
    """(P, rows per warp): the contiguous row ranges of one launch, one
    per warp. With a float sum, P x G f32 partials must fit
    FLOAT_PLANE_BYTES. Part of the function's definition, not only of the
    launch: the f32 sums add in this order."""
    if n_rows <= 0:
        return 1, WARP_ROWS
    cap = MAX_WARPS
    if float_sum:
        cap = min(cap, max(1, FLOAT_PLANE_BYTES // (4 * max(G, 1))))
    p = min(-(-n_rows // WARP_ROWS), cap)
    rpw = -(-(-(-n_rows // p)) // WARP_ROWS) * WARP_ROWS
    return -(-n_rows // rpw), rpw


# -- helpers -----------------------------------------------------------------

def _is_cuda(*ts) -> bool:
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {devs}")


def _require(t: torch.Tensor, dtypes, name: str) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def f32_bits(x: float) -> int:
    """The int32 bit pattern of float32(x)."""
    return int(np.array([x], dtype=np.float32).view(np.int32)[0])


def _bits_f32(imm: int, n: int, device) -> torch.Tensor:
    v = torch.tensor([imm], dtype=torch.int32).view(torch.float32)
    return v.to(device).expand(n)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 modulo 2^32 (two's complement)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32) if x.dtype == torch.bool else x


def _cmp(a: torch.Tensor, b: torch.Tensor, code: int) -> torch.Tensor:
    return (a == b, a != b, a < b, a <= b, a > b, a >= b)[code]


def image_u32(v: torch.Tensor) -> torch.Tensor:
    """Order-preserving u32 image (in int64) of f32 values, NaN made the
    positive quiet NaN first so it sorts above +inf."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(torch.isnan(v), torch.full_like(bits, 0x7FC00000),
                       bits)
    return torch.where(bits >= 0x80000000, (~bits) & 0xFFFFFFFF,
                       bits | 0x80000000)


def image_decode(img: torch.Tensor) -> torch.Tensor:
    """f32 values of u32 images (given as int32 bit patterns)."""
    u = img.to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(u >= 0x80000000, u & 0x7FFFFFFF, (~u) & 0xFFFFFFFF)
    return _wrap32(bits).view(torch.float32)


# -- the program evaluator (plain version of the kernel's interpreter) -------

def eval_plain(ops, env: list, n: int):
    """(value, valid) of a postfix program over whole columns. env: per
    input slot (value tensor int32|float32, valid bool tensor) of length n.
    Integer values come back as int32, f32 as float32, booleans as bool."""
    dev = env[0][0].device if env else torch.device("cpu")
    stack: list = []
    for op, arg, imm in ops:
        if op == OP_COL:
            stack.append(env[arg])
        elif op == OP_I32:
            stack.append((torch.full((n,), imm, dtype=torch.int32,
                                     device=dev),
                          torch.ones(n, dtype=torch.bool, device=dev)))
        elif op == OP_F32:
            stack.append((_bits_f32(imm, n, dev),
                          torch.ones(n, dtype=torch.bool, device=dev)))
        elif op == OP_NULL:
            stack.append((torch.zeros(n, dtype=torch.int32, device=dev),
                          torch.zeros(n, dtype=torch.bool, device=dev)))
        elif op in (OP_AND, OP_OR, OP_CMP_I, OP_CMP_F, OP_ADD_I, OP_SUB_I,
                    OP_MUL_I, OP_ADD_F, OP_SUB_F, OP_MUL_F, OP_GATE):
            (b, okb), (a, oka) = stack.pop(), stack.pop()
            ok = oka & okb
            if op == OP_GATE:
                # a, valid only where the boolean b is TRUE
                stack.append((a, ok & (b != 0)))
            elif op in (OP_AND, OP_OR):
                any_null = ~oka | ~okb
                if op == OP_AND:
                    f = (oka & ~a) | (okb & ~b)
                    stack.append((~f, f | ~any_null))
                else:
                    t = (oka & a) | (okb & b)
                    stack.append((t, t | ~any_null))
            elif op == OP_CMP_I:
                stack.append((_cmp(_i32(a), _i32(b), arg), ok))
            elif op == OP_CMP_F:
                stack.append((_cmp(a, b, arg), ok))
            elif op in (OP_ADD_I, OP_SUB_I, OP_MUL_I):
                x, y = _i32(a).to(torch.int64), _i32(b).to(torch.int64)
                r = x + y if op == OP_ADD_I else \
                    x - y if op == OP_SUB_I else x * y
                stack.append((_wrap32(r), ok))
            else:
                r = a + b if op == OP_ADD_F else \
                    a - b if op == OP_SUB_F else a * b
                stack.append((r, ok))
        else:
            v, ok = stack.pop()
            if op == OP_I2F:
                v = v.to(torch.float32)
            elif op == OP_F2I:
                # PG: round half away from zero; the convert saturates
                # and takes NaN to 0, as XLA's and the card's do
                r = torch.copysign(torch.floor(torch.abs(v) + 0.5), v)
                r = r.to(torch.float64).clamp(INT32_MIN, INT32_MAX)
                v = torch.where(torch.isnan(r), torch.zeros_like(r),
                                r).to(torch.int32)
            elif op in (OP_TOBOOL_I, OP_TOBOOL_F):
                v = v != 0
            elif op == OP_NOT:
                v = ~v
            elif op == OP_IS_NULL:
                v, ok = ~ok, torch.ones_like(ok)
            elif op == OP_IS_NOT_NULL:
                v, ok = ok, torch.ones_like(ok)
            elif op == OP_WRAP8:
                v = ((_i32(v) + 128) & 0xFF) - 128
            elif op == OP_SETV:
                v = torch.full_like(v, imm) if v.dtype != torch.bool else \
                    torch.full_like(v, bool(imm))
            elif op == OP_SHRA:
                v = _i32(v) >> imm
            elif op == OP_SHRL:
                v = _wrap32((_i32(v).to(torch.int64) & 0xFFFFFFFF) >> imm)
            elif op == OP_ANDI:
                v = _i32(v) & imm
            else:
                raise ValueError(f"unknown opcode {op}")
            stack.append((v, ok))
    if len(stack) != 1:
        raise ValueError("malformed program")
    return stack[0]


def decode_plain(kind: int, offset: int, tiles: torch.Tensor
                 ) -> torch.Tensor:
    """Logical values of a slot's tiles (flattened): int32 or float32."""
    if kind == COL_U16:
        return (tiles.view(torch.int16).to(torch.int32) & 0xFFFF) + offset
    if kind == COL_U8:
        return tiles.to(torch.int32) + offset
    if kind == COL_I8:
        return tiles.to(torch.int32)
    return tiles


# -- agg_scan ----------------------------------------------------------------

def _outputs(spec: ScanSpec, n_rows: int, device):
    """Zero/identity-initialised raw outputs: the row counts (G,) int64 and
    per aggregate a tuple (see `agg_scan`)."""
    G = spec.G
    z64 = lambda: torch.zeros(G, dtype=torch.int64, device=device)  # noqa
    outs = []
    P, _ = partition(n_rows, G, spec.has_float_sum())
    for a in spec.aggs:
        if a.kind == AGG_COUNT:
            outs.append((z64(),))
        elif a.kind == AGG_SUM_I:
            outs.append((z64(), z64()))
        elif a.kind == AGG_SUM_F:
            outs.append((torch.zeros(P * G, dtype=torch.float32,
                                     device=device), z64()))
        elif a.kind in (AGG_MIN_I, AGG_MAX_I):
            ident = INT32_MAX if a.kind == AGG_MIN_I else INT32_MIN
            outs.append((torch.full((G,), ident, dtype=torch.int32,
                                    device=device), z64()))
        elif a.kind == AGG_MIN_F:
            outs.append((torch.full((G,), IMG_POS_INF, dtype=torch.int32,
                                    device=device), z64(), z64()))
        elif a.kind == AGG_MAX_F:
            outs.append((torch.full((G,), IMG_NEG_INF, dtype=torch.int32,
                                    device=device), z64()))
        elif a.kind == AGG_PRESENCE:
            outs.append((torch.zeros(G * a.pvsize, dtype=torch.int32,
                                     device=device),))
        else:
            raise ValueError(f"unknown aggregate kind {a.kind}")
    return z64(), outs


def _check(spec: ScanSpec, cols, rowmask, codes, tile_start, tile_end):
    if len(cols) != len(spec.col_kinds):
        raise ValueError("one (data, mask) pair per input slot")
    if len(cols) > MAX_COLS or len(spec.keys) > MAX_KEYS or \
            len(spec.preds) > MAX_PREDS or len(spec.aggs) > MAX_AGGS:
        raise ValueError("scan exceeds the kernel's descriptor")
    if sum(len(p) for p in spec.preds) + \
            sum(len(a.ops or ()) for a in spec.aggs) > MAX_OPS:
        raise ValueError("programs exceed the kernel's descriptor")
    n_tiles = rowmask.shape[0]
    if rowmask.dtype != torch.bool or rowmask.dim() != 2 or \
            rowmask.shape[1] != 128:
        raise ValueError("rowmask: (R, 128) bool")
    for (data, mask), kind in zip(cols, spec.col_kinds):
        want = {COL_I32: torch.int32, COL_I8: torch.int8,
                COL_F32: torch.float32, COL_U8: torch.uint8,
                COL_U16: torch.uint16}[kind]
        if data.dtype != want or data.shape != rowmask.shape or \
                mask.shape != rowmask.shape or mask.dtype != torch.bool:
            raise ValueError(f"column tiles: expected {want} "
                             f"{tuple(rowmask.shape)}, got {data.dtype} "
                             f"{tuple(data.shape)}")
    if spec.factorized and (codes is None or codes.dtype != torch.int32 or
                            codes.shape != rowmask.shape):
        raise ValueError("factorized scan: codes (R, 128) int32")
    if not 0 <= tile_start <= tile_end <= n_tiles:
        raise ValueError(f"tile range [{tile_start}, {tile_end}) outside "
                         f"{n_tiles} tiles")


def agg_scan_plain(spec: ScanSpec, cols, rowmask, codes, tile_start: int,
                   tile_end: int):
    """Plain version of `agg_scan`: the same raw outputs, whole-column."""
    LAUNCHES.bump("agg_scan.plain")
    _check(spec, cols, rowmask, codes, tile_start, tile_end)
    dev = rowmask.device
    n = (tile_end - tile_start) * 128
    G = spec.G
    rowcount, outs = _outputs(spec, n, dev)
    sl = slice(tile_start, tile_end)
    env = [(decode_plain(k, off, data[sl].reshape(-1)),
            mask[sl].reshape(-1))
           for (data, mask), k, off in zip(cols, spec.col_kinds,
                                           spec.col_offsets)]
    m = rowmask[sl].reshape(-1).clone()
    for ops in spec.preds:
        v, ok = eval_plain(ops, env, n)
        m &= (v != 0) & ok
    if spec.factorized:
        code = codes[sl].reshape(-1).to(torch.int64)
    else:
        code = torch.zeros(n, dtype=torch.int64, device=dev)
        for kind, slot, lo, size in spec.keys:
            data, ok = env[slot]
            c = data.to(torch.int64) if kind == KEY_DICT else \
                _wrap32(data.to(torch.int64) - lo).to(torch.int64)
            c = torch.where(ok, c, torch.full_like(c, size - 1))
            code = code * size + c.clamp(0, size - 1)
    m &= (code >= 0) & (code < G)
    safe = torch.where(m, code, torch.zeros_like(code))
    rowcount += torch.bincount(safe[m], minlength=G)
    P, rpw = partition(n, G, spec.has_float_sum())
    for a, out in zip(spec.aggs, outs):
        if a.kind == AGG_PRESENCE:
            data, ok = env[a.pslot]
            vc = data.to(torch.int64) if a.pkind == KEY_DICT else \
                _wrap32(data.to(torch.int64) - a.plo).to(torch.int64)
            vc = vc.clamp(0, a.pvsize - 1)
            pm = m & ok
            out[0][(safe * a.pvsize + vc)[pm]] = 1
            continue
        v, ok = eval_plain(a.ops, env, n)
        am = m & ok
        idx = safe[am]
        if a.kind == AGG_COUNT:
            out[0].add_(torch.bincount(idx, minlength=G))
            continue
        out[1].add_(torch.bincount(idx, minlength=G))
        if a.kind == AGG_SUM_I:
            out[0].index_add_(0, idx, _i32(v)[am].to(torch.int64))
        elif a.kind == AGG_SUM_F:
            # row order within each (warp range, group) cell: index_add_
            # on the CPU walks its index in order
            key = (torch.arange(n, device=dev) // rpw) * G + safe
            plane = torch.zeros(P * G, dtype=torch.float32)
            plane.index_add_(0, key[am].cpu(), v[am].cpu())
            out[0].copy_(plane.to(dev))
        elif a.kind in (AGG_MIN_I, AGG_MAX_I):
            red = "amin" if a.kind == AGG_MIN_I else "amax"
            out[0].scatter_reduce_(0, idx, _i32(v)[am], red)
        else:
            img = image_u32(v)
            sel = am
            if a.kind == AGG_MIN_F:
                sel = am & ~torch.isnan(v)
                out[2].add_(torch.bincount(safe[sel], minlength=G))
            red = "amin" if a.kind == AGG_MIN_F else "amax"
            acc = out[0].to(torch.int64) & 0xFFFFFFFF
            acc.scatter_reduce_(0, safe[sel], img[sel], red)
            out[0].copy_(_wrap32(acc))
    return rowcount, outs


def new_descriptor(cols, col_kinds, col_offsets, keys=(), preds=()):
    """A scan descriptor (csrc/expr.cuh) with its column, key and
    predicate sections filled, and `place(prog) -> (start, count)`, which
    appends a program to the op section. Call `finish_descriptor` last."""
    d = np.zeros(DESC_WORDS, dtype=np.int64)
    ops: list = []
    d[_H_NCOLS], d[_H_NKEYS], d[_H_NPREDS] = len(cols), len(keys), \
        len(preds)
    for i, ((data, mask), kind, off) in enumerate(
            zip(cols, col_kinds, col_offsets)):
        d[_COLS + _COL_W * i: _COLS + _COL_W * (i + 1)] = \
            (data.data_ptr(), mask.data_ptr(), kind, off)
    for i, key in enumerate(keys):
        d[_KEYS + _KEY_W * i: _KEYS + _KEY_W * (i + 1)] = key

    def place(prog) -> tuple[int, int]:
        start = len(ops)
        ops.extend(prog)
        return start, len(prog)

    for i, prog in enumerate(preds):
        d[_PREDS + _PRED_W * i: _PREDS + _PRED_W * (i + 1)] = place(prog)
    return d, place, ops


def finish_descriptor(d: np.ndarray, ops: list) -> np.ndarray:
    """Write the op section: one word per op, imm << 32 | arg << 8 | op."""
    if len(ops) > MAX_OPS:
        raise ValueError("programs exceed the kernel's descriptor")
    for i, (op, arg, imm) in enumerate(ops):
        imm32 = imm - 2**32 if imm >= 2**31 else imm
        d[_OPS + i] = (imm32 << 32) | (arg << 8) | op
    return d


def _descriptor(spec: ScanSpec, cols, rowmask, codes, rowcount, outs,
                tile_start: int, tile_end: int, P: int, rpw: int
                ) -> np.ndarray:
    d, place, ops = new_descriptor(cols, spec.col_kinds, spec.col_offsets,
                                   spec.keys, spec.preds)
    d[_H_FACT] = int(spec.factorized)
    d[_H_NAGGS], d[_H_G] = len(spec.aggs), spec.G
    d[_H_ROWMASK] = rowmask.data_ptr()
    d[_H_CODES] = codes.data_ptr() if spec.factorized else 0
    d[_H_ROWCOUNT] = rowcount.data_ptr()
    d[_H_ROW_START], d[_H_ROW_END] = tile_start * 128, tile_end * 128
    d[_H_RPW], d[_H_P] = rpw, P
    for i, (a, out) in enumerate(zip(spec.aggs, outs)):
        start, count = place(a.ops or ())
        ptrs = [t.data_ptr() for t in out] + [0] * (3 - len(out))
        d[_AGGS + _AGG_W * i: _AGGS + _AGG_W * (i + 1)] = \
            (a.kind, start, count, *ptrs, a.pslot, a.pkind, a.plo, a.pvsize)
    return finish_descriptor(d, ops)


def agg_scan(spec: ScanSpec, cols, rowmask: torch.Tensor,
             codes: Optional[torch.Tensor], tile_start: int, tile_end: int):
    """Scan tiles [tile_start, tile_end) of one table: cols is one (data,
    mask) pair of (R, 128) tiles per input slot, rowmask the (R, 128) bool
    row validity, codes the factorized (R, 128) int32 group codes (or
    None). Returns the raw outputs (rowcount, [per aggregate]):

    - AGG_COUNT (count,); AGG_SUM_I (int64 sum, count);
    - AGG_SUM_F (f32 partial plane (P*G,), count) — `agg_fold` it;
    - AGG_MIN_I/AGG_MAX_I (int32 value, count);
    - AGG_MIN_F (u32 image of the min over non-NaN rows, count, non-NaN
      count); AGG_MAX_F (u32 image of the max, NaN above +inf, count);
    - AGG_PRESENCE (int32 (G*vsize,) 0/1 grid,).

    Counts are int64 (G,); images travel as int32 bit patterns."""
    tensors = [t for pair in cols for t in pair] + [rowmask, codes]
    if not _is_cuda(*tensors):
        return agg_scan_plain(spec, cols, rowmask, codes, tile_start,
                              tile_end)
    _check(spec, cols, rowmask, codes, tile_start, tile_end)
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("agg_scan: tensors must be contiguous")
    dev = rowmask.device
    n = (tile_end - tile_start) * 128
    P, rpw = partition(n, spec.G, spec.has_float_sum())
    rowcount, outs = _outputs(spec, n, dev)
    desc = _descriptor(spec, cols, rowmask, codes, rowcount, outs,
                       tile_start, tile_end, P, rpw)
    desc_dev = torch.from_numpy(desc).to(dev)
    lib = _build.load("agg")
    n_blocks = -(-P // BLOCK_WARPS)
    LAUNCHES.bump("agg_scan")
    _build.check(lib.agg_scan(desc_dev.data_ptr(), n_blocks,
                              _stream(rowmask)), "agg_scan")
    return rowcount, outs


# -- agg_fold ----------------------------------------------------------------

def agg_fold_plain(plane: torch.Tensor, G: int) -> torch.Tensor:
    """Plain version of `agg_fold`: out[g] = ((0 + plane[0,g]) + plane[1,g])
    + ... in f32."""
    LAUNCHES.bump("agg_fold.plain")
    rows = plane.view(-1, G)
    out = torch.zeros(G, dtype=torch.float32, device=plane.device)
    for p in range(rows.shape[0]):
        out = out + rows[p]
    return out


def agg_fold(plane: torch.Tensor, G: int) -> torch.Tensor:
    """(G,) f32 sums of a (P*G,) partial plane, adding its P rows of each
    group in order of p."""
    _require(plane, (torch.float32,), "plane")
    if plane.numel() % G:
        raise ValueError("plane: P*G elements")
    if not _is_cuda(plane):
        return agg_fold_plain(plane, G)
    out = torch.empty(G, dtype=torch.float32, device=plane.device)
    lib = _build.load("agg")
    LAUNCHES.bump("agg_fold")
    _build.check(lib.agg_fold(plane.data_ptr(), plane.numel() // G, G,
                              out.data_ptr(), _stream(plane)), "agg_fold")
    return out
