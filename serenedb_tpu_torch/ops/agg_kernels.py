"""Wrappers of the analytics CUDA kernels (`csrc/agg.cu`) and their plain
PyTorch versions.

- `agg_scan` ← serenedb_tpu/exec/device_agg.py `_run` → `program`
  (:251-301) with the ops/agg.py reductions in its body: frame-of-
  reference decode, the predicate programs (SQL three-valued logic),
  group codes (direct key plans, factorized codes, or one group),
  then per aggregate a count, an exact int64 sum, an f32 sum (a partial
  plane, or the sums themselves at large G), an int or f32 min/max, or a
  DISTINCT presence grid (`_presence_scatter` :455).
- `agg_fold` ← the f32 scatter-add of ops/agg.py `group_sum_float`
  (:117): adds the partial plane's P rows of each group in a fixed
  two-level order (runs of p in order, then the runs in order).

An expression is a flat postfix program (`exec/device.compile_expr`
lowers a bound expression to one): a tuple of (opcode, arg, imm) with
imm a 32-bit pattern (int32, or an f32's bits). The kernel interprets it
per row on a stack of (32-bit value, valid bit) entries.

`split` picks the kernel's regime and row ranges from the spec and the
row count alone (SCALAR at G = 1, SMALL where every aggregate's cells
fit a block's shared memory, else SORT with an f32 sum and LARGE
without); the f32 sums' add order is part of that definition, and the
plain versions follow it.

Each wrapper launches its kernel for tensors on a CUDA device and counts
the launch in `device.LAUNCHES`; for tensors on the CPU it calls the plain
version (counted under `<name>.plain`). There is no other path. The plain
versions compute the same function: integer outputs are exact in any
order, min/max go through the same order-preserving u32 image as the
kernel, and the f32 sums add in the kernel's order, so kernel and plain
version agree bit for bit (NaN payloads aside: the card's NaN is
canonical).
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
 OP_SETV, OP_SHRA, OP_SHRL, OP_ANDI, OP_GATE, OP_NVL) = range(28)
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
    _H_CODES, _H_ROWCOUNT, _H_ROW_START, _H_ROW_END, _H_RPB = range(12)
_H_SCRATCH = 14
_COLS, _KEYS, _PREDS, _AGGS, _OPS = 16, 80, 112, 128, 288
_COL_W, _KEY_W, _PRED_W, _AGG_W = 4, 4, 2, 10

#: threads of an agg_scan block (8 warps): the rows of one step
BLOCK_ROWS = 256
BLOCK_WARPS = 8
#: rows per block: at least SCAN_BLOCK_ROWS, more when a launch would
#: take more than MAX_BLOCKS blocks
SCAN_BLOCK_ROWS = 4096
MAX_BLOCKS = 8192
#: shared-memory bytes of one block's cells in the SMALL regime
SMALL_SMEM_BYTES = 48 << 10
REGIME_SCALAR, REGIME_SMALL, REGIME_LARGE, REGIME_SORT = range(4)
#: the SORT regime's counting sort: rows a warp histograms; buckets of
#: 2^bits codes, bits >= SORT_MIN_BITS, at most SORT_MAX_BUCKETS buckets
SORT_RANGE = 2048
SORT_MIN_BITS, SORT_MAX_BUCKETS = 8, 4096
#: agg_fold: runs of max(FOLD_MIN_RUN, ceil(P / FOLD_RUNS)) rows of p
FOLD_RUNS, FOLD_MIN_RUN = 256, 16

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
    count G; the aggregates. `force_global`: the regime of a statement
    split across launches (exec/device_split.py) whose whole cells do not
    fit the SMALL regime, so each launch adds its f32 sums in the order
    the whole statement's would."""
    col_kinds: list
    col_offsets: list
    preds: list = field(default_factory=list)
    keys: list = field(default_factory=list)
    factorized: bool = False
    G: int = 1
    aggs: list = field(default_factory=list)
    force_global: bool = False

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


def _units32(kind: int) -> int:
    """32-bit cell arrays (of G words) an aggregate takes in the SMALL
    regime's shared memory (csrc/agg.cu `units32`)."""
    return {AGG_COUNT: 1, AGG_SUM_I: 1, AGG_SUM_F: 1 + BLOCK_WARPS,
            AGG_MIN_F: 3, AGG_PRESENCE: 0}.get(kind, 2)


def small_cells_bytes(spec: ScanSpec) -> int:
    """Shared bytes of one block's cells in the SMALL regime: the int64
    sums, the row counts, then each aggregate's 32-bit arrays."""
    n64 = sum(a.kind == AGG_SUM_I for a in spec.aggs)
    n32 = 1 + sum(_units32(a.kind) for a in spec.aggs)
    return (8 * n64 + 4 * n32) * spec.G


@dataclass(frozen=True)
class Split:
    """How one agg_scan launch covers its rows: the regime, `blocks`
    blocks of `rows_per_block` contiguous rows, the rows of each f32
    sum's partial plane (the fold's P; 1 in SORT, whose plane is the
    sums) and the dynamic shared bytes a block."""
    regime: int
    blocks: int
    rows_per_block: int
    plane_rows: int
    smem: int


def split(spec: ScanSpec, n_rows: int) -> Split:
    """The regime and row ranges of a launch over n_rows rows, from the
    spec and n_rows alone (never the card): part of the function's
    definition, since the f32 sums add in this order."""
    n = max(n_rows, 0)
    rpb = max(SCAN_BLOCK_ROWS,
              -(-(-(-n // MAX_BLOCKS)) // BLOCK_ROWS) * BLOCK_ROWS)
    blocks = max(1, -(-n // rpb))
    if spec.G == 1:
        return Split(REGIME_SCALAR, blocks, rpb, blocks,
                     len(spec.aggs) * BLOCK_ROWS * 16)
    cells = small_cells_bytes(spec)
    if cells <= SMALL_SMEM_BYTES and not spec.force_global:
        return Split(REGIME_SMALL, blocks, rpb, blocks, cells)
    return Split(REGIME_SORT if spec.has_float_sum() else REGIME_LARGE,
                 blocks, rpb, 1, 0)


def sort_layout(n_rows: int, G: int, n_aggs: int
                ) -> tuple[int, int, int, int]:
    """(bits, buckets, warp ranges, scratch words) of the SORT regime's
    counting sort (csrc/agg.cu `agg_scan`): the rows' codes, aggregate
    bits and n_aggs value columns, the same sorted, the histograms, the
    bucket totals and bases, 4 bytes each."""
    bits = SORT_MIN_BITS
    while (G - 1) >> bits >= SORT_MAX_BUCKETS:
        bits += 1
    nb = ((G - 1) >> bits) + 1
    pw = -(-n_rows // SORT_RANGE)
    return bits, nb, pw, 2 * n_rows * (2 + n_aggs) + pw * nb + 2 * nb


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
    """The current stream of t's card, as the raw handle the kernels take
    (what torch.cuda.current_stream(t.device).cuda_stream gives, without
    making a Stream object a call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


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
            elif op == OP_NVL:
                v = torch.where(ok, _i32(v), torch.full_like(_i32(v), imm))
                ok = torch.ones_like(ok)
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

def _outputs(spec: ScanSpec, sp: Split, device, init: bool = True):
    """The raw outputs: the row counts (G,) int64 and per aggregate a
    tuple (see `agg_scan`), views of two buffers; zero/identity-
    initialised (a fill per min/max), or, with init=False, left unset for
    the kernel's call, which sets them first (csrc/agg.cu `init_kernel`)."""
    G, P = spec.G, sp.plane_rows
    # (dtype, elements, identity) of each output, in order
    shapes = [[(torch.int64, G, 0)]]
    for a in spec.aggs:
        if a.kind == AGG_COUNT:
            shapes.append([(torch.int64, G, 0)])
        elif a.kind == AGG_SUM_I:
            shapes.append([(torch.int64, G, 0), (torch.int64, G, 0)])
        elif a.kind == AGG_SUM_F:
            shapes.append([(torch.float32, P * G, 0), (torch.int64, G, 0)])
        elif a.kind in (AGG_MIN_I, AGG_MAX_I):
            ident = INT32_MAX if a.kind == AGG_MIN_I else INT32_MIN
            shapes.append([(torch.int32, G, ident), (torch.int64, G, 0)])
        elif a.kind == AGG_MIN_F:
            shapes.append([(torch.int32, G, IMG_POS_INF),
                           (torch.int64, G, 0), (torch.int64, G, 0)])
        elif a.kind == AGG_MAX_F:
            shapes.append([(torch.int32, G, IMG_NEG_INF),
                           (torch.int64, G, 0)])
        elif a.kind == AGG_PRESENCE:
            shapes.append([(torch.int32, G * a.pvsize, 0)])
        else:
            raise ValueError(f"unknown aggregate kind {a.kind}")
    # two zeroed buffers, int64 and int32, split into the outputs (the
    # f32 planes are int32 views); a fill per min/max identity
    flat = [x for group in shapes for x in group]
    wide = [x[1] for x in flat if x[0] == torch.int64]
    narrow = [x[1] for x in flat if x[0] != torch.int64]
    alloc = torch.zeros if init else torch.empty
    b64 = alloc(sum(wide), dtype=torch.int64, device=device)
    b32 = alloc(sum(narrow), dtype=torch.int32, device=device)
    v64, v32 = iter(b64.split(wide)), iter(b32.split(narrow))
    views = []
    for dtype, _count, ident in flat:
        v = next(v64) if dtype == torch.int64 else next(v32)
        if dtype == torch.float32:
            v = v.view(torch.float32)
        elif ident and init:
            v.fill_(ident)
        views.append(v)
    it = iter(views)
    groups = [tuple(next(it) for _ in group) for group in shapes]
    return groups[0][0], groups[1:]


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


def _float_plane(sp: Split, G: int, code: torch.Tensor, am: torch.Tensor,
                 v: torch.Tensor) -> np.ndarray:
    """An f32 sum's raw output in the kernel's add order (numpy f32
    arithmetic, one rounding per add; rows the aggregate skips add +0.0,
    which leaves a sum that starts at +0.0 unchanged):

    - SCALAR: per block and thread its rows (base + thread, base += 256)
      in order, the warp's 32 sums in the shuffle tree, the 8 warp sums in
      warp order: one cell per block;
    - SMALL: per (block, warp, group) the warp's rows of the group in row
      order; a block's row folds its 8 warps' rows in warp order;
    - SORT: per group 0 + its rows in row order (np.add.at's order)."""
    n = am.shape[0]
    vals = torch.where(am, v.to(torch.float32),
                       torch.zeros_like(v, dtype=torch.float32))
    vals = vals.cpu().numpy()
    rpb, P = sp.rows_per_block, sp.blocks
    with np.errstate(invalid="ignore", over="ignore"):
        if sp.regime == REGIME_SCALAR:
            x = np.zeros(P * rpb, dtype=np.float32)
            x[:n] = vals
            x = x.reshape(P, rpb // BLOCK_ROWS, BLOCK_ROWS)
            acc = np.zeros((P, BLOCK_ROWS), dtype=np.float32)
            for step in range(x.shape[1]):
                acc = acc + x[:, step]
            t = acc.reshape(P, BLOCK_WARPS, 32)
            for h in (16, 8, 4, 2, 1):
                t = t[..., :h] + t[..., h:2 * h]
            t = t[..., 0]
            out = t[:, 0]
            for w in range(1, BLOCK_WARPS):
                out = out + t[:, w]
            return out
        sel = am.cpu().numpy()
        idx = code.cpu().numpy()[sel]
        if sp.regime == REGIME_SMALL:
            rows = np.flatnonzero(sel)
            warp = (rows // rpb) * BLOCK_WARPS + (rows % BLOCK_ROWS) // 32
            cells = np.zeros(P * BLOCK_WARPS * G, dtype=np.float32)
            np.add.at(cells, warp * G + idx, vals[sel])
            cells = cells.reshape(P, BLOCK_WARPS, G)
            out = cells[:, 0]
            for w in range(1, BLOCK_WARPS):
                out = out + cells[:, w]
            return out.reshape(-1)
        out = np.zeros(G, dtype=np.float32)
        np.add.at(out, idx, vals[sel])
        return out


def agg_scan_plain(spec: ScanSpec, cols, rowmask, codes, tile_start: int,
                   tile_end: int):
    """Plain version of `agg_scan`: the same raw outputs, whole-column."""
    LAUNCHES.bump("agg_scan.plain")
    _check(spec, cols, rowmask, codes, tile_start, tile_end)
    dev = rowmask.device
    n = (tile_end - tile_start) * 128
    G = spec.G
    sp = split(spec, n)
    rowcount, outs = _outputs(spec, sp, dev)
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
            out[0].copy_(torch.from_numpy(
                _float_plane(sp, G, safe, am, v)).to(dev))
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
                tile_start: int, tile_end: int, sp: Split,
                scratch: Optional[torch.Tensor]) -> np.ndarray:
    d, place, ops = new_descriptor(cols, spec.col_kinds, spec.col_offsets,
                                   spec.keys, spec.preds)
    d[_H_FACT] = int(spec.factorized)
    d[_H_NAGGS], d[_H_G] = len(spec.aggs), spec.G
    d[_H_ROWMASK] = rowmask.data_ptr()
    d[_H_CODES] = codes.data_ptr() if spec.factorized else 0
    d[_H_ROWCOUNT] = rowcount.data_ptr()
    d[_H_ROW_START], d[_H_ROW_END] = tile_start * 128, tile_end * 128
    d[_H_RPB] = sp.rows_per_block
    d[_H_SCRATCH] = scratch.data_ptr() if scratch is not None else 0
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
    - AGG_SUM_F (f32 partial plane (P*G,), count) — `agg_fold` it (P is
      `split(spec, rows).plane_rows`; 1 at large G, where the plane is
      already the sums);
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
    sp = split(spec, n)
    rowcount, outs = _outputs(spec, sp, dev, init=False)
    scratch = None
    if sp.regime == REGIME_SORT:
        if n >= 2**31:
            raise ValueError("agg_scan: a large-G f32 sum over 2^31 rows")
        scratch = torch.empty(sort_layout(n, spec.G, len(spec.aggs))[3],
                              dtype=torch.int32, device=dev)
    desc = _descriptor(spec, cols, rowmask, codes, rowcount, outs,
                       tile_start, tile_end, sp, scratch)
    lib = _build.load("agg")
    LAUNCHES.bump("agg_scan")
    # the descriptor goes by value: the host array only has to live
    # through the call
    _build.check(lib.agg_scan(
        desc.ctypes.data, sp.regime, sp.blocks, sp.smem, n, spec.G,
        len(spec.aggs), scratch.data_ptr() if scratch is not None else None,
        _stream(rowmask)), "agg_scan")
    return rowcount, outs


# -- agg_fold ----------------------------------------------------------------

def fold_runs(P: int) -> tuple[int, int]:
    """(run length L, runs R) of agg_fold over P plane rows."""
    L = max(FOLD_MIN_RUN, -(-P // FOLD_RUNS))
    return L, -(-P // L)


def agg_fold_plain(plane: torch.Tensor, G: int) -> torch.Tensor:
    """Plain version of `agg_fold`: per group, each run of L rows of p
    added in order from its first (`fold_runs`), then the run sums added
    in order, in f32."""
    LAUNCHES.bump("agg_fold.plain")
    rows = plane.view(-1, G)
    L, R = fold_runs(rows.shape[0])
    runs = rows[0::L].clone()
    for j in range(1, L):
        part = rows[j::L]
        runs[:part.shape[0]] = runs[:part.shape[0]] + part
    out = runs[0].clone()
    for r in range(1, R):
        out = out + runs[r]
    return out


def agg_fold(plane: torch.Tensor, G: int) -> torch.Tensor:
    """(G,) f32 sums of a (P*G,) partial plane, adding its P rows of each
    group in agg_fold's fixed order (`agg_fold_plain`)."""
    _require(plane, (torch.float32,), "plane")
    if plane.numel() % G or plane.numel() == 0:
        raise ValueError("plane: P*G elements, P >= 1")
    if not _is_cuda(plane):
        return agg_fold_plain(plane, G)
    out = torch.empty(G, dtype=torch.float32, device=plane.device)
    lib = _build.load("agg")
    LAUNCHES.bump("agg_fold")
    _build.check(lib.agg_fold(plane.data_ptr(), plane.numel() // G, G,
                              out.data_ptr(), _stream(plane)), "agg_fold")
    return out
