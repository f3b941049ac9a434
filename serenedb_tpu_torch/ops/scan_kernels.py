"""Wrapper of the scan programs' split prepare (`csrc/scan.cu`) and its
plain PyTorch version.

`scan_eval` has no TPU kernel of its own to replace: the reference's XLA
traces any expression into the one program of K5/K6/K8
(serenedb_tpu/exec/device.py:60 `compile_expr`, device_agg.py:251
`program`). The port's scan kernels (`agg_scan`, `join_probe`,
`topn_scan`) interpret postfix programs on an 8-entry stack over at most
16 columns a launch; where a statement goes past that, the planner
(exec/device_split.py) runs the parts that feed them here first, in one
launch a chunk, through the same op ABI (csrc/expr.cuh), and hands the
results to the scan kernels as extra column slots and a narrowed row mask.

One launch over the rows of a chunk's input tiles runs an `EvalSpec`'s
passes in order:

- the derive passes (`EvalSpec.derived`): each one program's value as a
  column tile (`out`: COL_I32, COL_I8 or COL_F32; an invalid row's value
  is 0) and its bool validity. Derive k is slot `len(col_kinds) + k` of
  the passes after it. A tile is returned (and written) only where it is
  `stored`: the scan launches read it; else its place holds None;
- the mask passes (`EvalSpec.preds`): the (R, 128) bool row mask ANDed
  with every predicate program.

The wrapper launches the kernel for tensors on a CUDA device and counts
the launch in `device.LAUNCHES`; for tensors on the CPU it calls the
plain version (counted under `scan_eval.plain`, once a call). There is no
other path. The plain version evaluates with `agg_kernels.eval_plain`,
the scan kernels' plain interpreter, one pass after another, each derived
value read back from its tile, so the two agree bit for bit (NaN payloads
aside: the card's NaN is canonical).

On the card a spec's `_Plan` (made at its first call and kept on it)
holds what the spec alone fixes: the kernel's words (passes, staged
inputs, ops), uploaded once a device; the programs as the kernel runs
them (`_kernel_ops`: integer + / * and AND / OR chains regrouped
left-deep, a binary op fused with a column or constant right operand);
the stages a derived value that later passes read takes in shared
memory; and the layout of the call's one buffer, which holds every
written tile, its validity and the row mask. A call passes only the
input pointers, the buffer and the row count.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import LAUNCHES
from . import _build
from . import agg_kernels as K

#: (data, mask) input pairs a launch takes by value; stages in shared
#: memory for derived values that later passes read; units of staged
#: input bytes in shared memory (a slot takes 1 for its mask and 1, 2 or
#: 4 for its data) (csrc/scan.cu; keep in step)
MAX_INPUTS, MAX_STAGES, MAX_RAW_UNITS = 128, 16, 40
_NO_RAW = 0xFF
# the plan's words (csrc/scan.cu): header words, then four a pass, a word
# a staged input, the ops
_W_HEAD = 8
_SRC_BASE, _SRC_STAGE, _SRC_OUT = 0, 1, 2
MODE_MASK, MODE_DERIVE = 0, 1
#: a derived tile's storage, by decode kind
_OUT_DTYPE = {K.COL_I32: torch.int32, K.COL_I8: torch.int8,
              K.COL_F32: torch.float32}
#: bytes a row of an input slot's data, by decode kind
_WIDTH = {K.COL_I32: 4, K.COL_F32: 4, K.COL_U16: 2, K.COL_U8: 1,
          K.COL_I8: 1}
_LEAF = (K.OP_COL, K.OP_I32, K.OP_F32)
_NULLARY = _LEAF + (K.OP_NULL,)
_BINARY = (K.OP_AND, K.OP_OR, K.OP_CMP_I, K.OP_CMP_F, K.OP_ADD_I,
           K.OP_SUB_I, K.OP_MUL_I, K.OP_ADD_F, K.OP_SUB_F, K.OP_MUL_F,
           K.OP_GATE)


@dataclass
class Derive:
    """A derive pass: its program over the spec's slots, its tile's
    storage and whether the tile is written (a scan launch reads it)."""
    prog: tuple
    out: int = K.COL_I32
    stored: bool = True


@dataclass
class EvalSpec:
    """One chunk's passes, independent of the data: per input slot its
    decode (kind, offset); the derive passes in order (derive k is slot
    len(col_kinds) + k); the predicate programs of the mask passes."""
    col_kinds: list
    col_offsets: list
    derived: list = field(default_factory=list)
    preds: list = field(default_factory=list)
    plan: Optional["_Plan"] = field(default=None, repr=False,
                                    compare=False)


def _depth(prog, n_slots: int, slot_limit: int) -> int:
    """The stack depth a program needs; it must leave one value and read
    only slots below slot_limit."""
    d = top = 0
    for op, arg, _imm in prog:
        if op in _NULLARY:
            if op == K.OP_COL and not 0 <= arg < slot_limit:
                raise ValueError(f"scan_eval: slot {arg} read before it is "
                                 f"made (of {n_slots})")
            d += 1
        elif op in _BINARY:
            d -= 1
            if d < 1:
                raise ValueError("scan_eval: malformed program")
        elif d < 1:
            raise ValueError("scan_eval: malformed program")
        top = max(top, d)
    if d != 1:
        raise ValueError("scan_eval: malformed program")
    return top


def _check_spec(spec: EvalSpec) -> None:
    n_in = len(spec.col_kinds)
    n_slots = n_in + len(spec.derived)
    if n_in > MAX_INPUTS or len(spec.col_offsets) != n_in or \
            len(spec.derived) > 0xFFFF:
        raise ValueError(f"scan_eval: at most {MAX_INPUTS} input slots, "
                         "one offset each, and 65,535 derive passes")
    for k, d in enumerate(spec.derived):
        if d.out not in _OUT_DTYPE:
            raise ValueError(f"scan_eval: no output kind {d.out}")
        if _depth(d.prog, n_slots, n_in + k) > K.MAX_STACK:
            raise ValueError("scan_eval: a program deeper than the stack")
    for p in spec.preds:
        if _depth(p, n_slots, n_slots) > K.MAX_STACK:
            raise ValueError("scan_eval: a program deeper than the stack")


def _check(widths: list, cols, rowmask) -> None:
    """cols: one (data, mask) pair per input slot, each the bool row
    mask's shape, data of the slot's width (bytes), a bool mask."""
    shape = rowmask.shape
    if len(cols) != len(widths) or rowmask.dtype != torch.bool:
        raise ValueError("scan_eval: one (data, mask) pair per input slot, "
                         "a bool row mask")
    for (data, mask), w in zip(cols, widths):
        if data.shape != shape or mask.shape != shape or \
                mask.dtype != torch.bool or data.element_size() != w:
            raise ValueError("scan_eval: column tiles of the row mask's "
                             "shape, data of the slot's width, a bool mask")


def _tile(v: torch.Tensor, ok: torch.Tensor, out: int) -> torch.Tensor:
    """A derived value as its tile stores it: the 32-bit pattern, 0 where
    invalid, in the storage of `out`."""
    bits = v.contiguous().view(torch.int32) if v.dtype == torch.float32 \
        else K._i32(v)
    bits = torch.where(ok, bits, torch.zeros_like(bits))
    if out == K.COL_F32:
        return bits.view(torch.float32)
    if out == K.COL_I8:
        return (((bits + 128) & 0xFF) - 128).to(torch.int8)
    return bits


def scan_eval_plain(spec: EvalSpec, cols, rowmask: torch.Tensor):
    """Plain version of `scan_eval`: the same tiles and mask, pass by
    pass, whole-column."""
    LAUNCHES.bump("scan_eval.plain")
    _check_spec(spec)
    _check([_WIDTH.get(k) for k in spec.col_kinds], cols, rowmask)
    n, shape, dev = rowmask.numel(), rowmask.shape, rowmask.device
    env = [(K.decode_plain(kind, off, data.reshape(-1)), mask.reshape(-1))
           for (data, mask), kind, off in zip(cols, spec.col_kinds,
                                              spec.col_offsets)]

    def run(prog):       # (a program that reads no column runs on the CPU)
        v, ok = K.eval_plain(prog, env, n)
        return v.to(dev), ok.to(dev)
    tiles = []
    for d in spec.derived:
        v, ok = run(d.prog)
        t = _tile(v, ok, d.out)
        env.append((K.decode_plain(d.out, 0, t), ok))
        tiles.append((t.view(shape), ok.view(shape).clone())
                     if d.stored else None)
    if not spec.preds:
        return tiles, rowmask
    m = rowmask.reshape(-1).clone()
    for ops in spec.preds:
        v, ok = run(ops)
        m &= (v != 0) & ok
    return tiles, m.view(shape)


#: ops whose operands may be regrouped and reordered without changing a
#: bit of any valid result: int32 + and * wrap (exact modulo 2^32), the
#: validity is the AND of the operands', and SQL's AND / OR are Kleene's
_REGROUP = (K.OP_ADD_I, K.OP_MUL_I, K.OP_AND, K.OP_OR)
#: a kernel op word's op byte for a binary op whose right operand is a
#: column (FUSE_COL | op) or a constant (FUSE_IMM | op) (csrc/scan.cu)
FUSE_COL, FUSE_IMM = 0x40, 0x60


def _tree(prog):
    """A postfix program as nested (op, arg, imm, kids)."""
    st = []
    for op, arg, imm in prog:
        if op in _NULLARY:
            st.append((op, arg, imm, ()))
        elif op in _BINARY:
            b, a = st.pop(), st.pop()
            st.append((op, arg, imm, (a, b)))
        else:
            st.append((op, arg, imm, (st.pop(),)))
    return st[0]


def _kernel_ops(prog) -> list:
    """The program as the kernel runs it: chains of a regrouped op
    flattened and rebuilt left-deep, the deepest operand first, so the
    columns and constants come last; a binary op whose right operand is a
    column or constant fused with it into one op (its `arg` holds the
    compare code, the leaf's (op, arg, imm) follows). The stack it needs
    is never deeper than the program's, and every valid result is the
    same bits."""
    def depth(n):
        if not n[3]:
            return 1
        if len(n[3]) == 1:
            return depth(n[3][0])
        return max(depth(n[3][0]), 1 + depth(n[3][1]))

    def operands(n, op):
        if n[0] == op:
            return operands(n[3][0], op) + operands(n[3][1], op)
        return [n]
    out = []

    def emit(n):
        op, arg, imm, kids = n
        if not kids:
            out.append(("op", n))
            return
        if len(kids) == 1:
            emit(kids[0])
            out.append(("op", (op, arg, imm, ())))
            return
        if op in _REGROUP:
            parts = operands(n, op)
            parts.sort(key=lambda m: (not m[3] and m[0] in _LEAF, -depth(m)))
        else:
            parts = list(kids)
        emit(parts[0])
        for m in parts[1:]:
            if not m[3] and m[0] in _LEAF:
                out.append(("fuse", (op, arg, imm, ()), m))
            else:
                emit(m)
                out.append(("op", (op, arg, imm, ())))
    emit(_tree(prog))
    return out


class _Plan:
    """What a card call of one spec needs that the spec alone fixes: the
    kernel's words (uploaded once a device), its stages and the layout of
    the call's buffer (each section at `offset * n_pad` bytes, n_pad the
    row count rounded up to 16, so every section is 16-byte aligned)."""

    def __init__(self, spec: EvalSpec):
        _check_spec(spec)
        n_in, n_der = len(spec.col_kinds), len(spec.derived)
        progs = [d.prog for d in spec.derived] + list(spec.preds)
        last = {}                # derive k -> the last pass that reads it
        for p, prog in enumerate(progs):
            for op, arg, _imm in prog:
                if op == K.OP_COL and arg >= n_in:
                    last[arg - n_in] = p
        # a stage for each derived value a later pass reads, reused once
        # its last reader has run; past MAX_STAGES the value is written
        # and read back from its tile
        stage, busy = {}, {}     # derive -> stage; stage -> its last read
        for k in range(n_der):
            if k not in last:
                continue
            free = [s for s in range(MAX_STAGES)
                    if busy.get(s, -1) <= k]
            if free:
                stage[k] = free[0]
                busy[free[0]] = last[k]
        self.n_stages = max(stage.values(), default=-1) + 1
        written = [d.stored or (k in last and k not in stage)
                   for k, d in enumerate(spec.derived)]
        # the buffer: per written tile its data, then its validity; then
        # the row mask
        at, self.tiles = 0, []
        for k, d in enumerate(spec.derived):
            if written[k]:
                w = _WIDTH[d.out]
                self.tiles.append((k, at, w, at + w, d.stored))
                at += w + 1
        self.mask_at = at if spec.preds else None
        self.row_bytes = at + (1 if spec.preds else 0)
        # the inputs the passes read, staged a group at a time in shared
        # memory while they fit (the rest read from device memory)
        read = {a for prog in progs for op, a, _imm in prog
                if op == K.OP_COL and a < n_in}
        raws, self.raw_units = [], 0
        unit = {}
        for i in sorted(read):
            u = 1 + _WIDTH[spec.col_kinds[i]]
            if self.raw_units + u <= MAX_RAW_UNITS:
                unit[i] = self.raw_units
                raws.append(i | spec.col_kinds[i] << 12 | unit[i] << 16)
                self.raw_units += u
        # an OP_COL's word carries its slot: source, decode kind, ref
        # (the input pair and its staged unit, the stage, or the derive
        # pass whose tile it reads back) and offset
        col = [_SRC_BASE << 8 | kind << 10 | (i | unit.get(i, _NO_RAW) << 8)
               << 16 | (off & 0xFFFFFFFF) << 32
               for i, (kind, off) in enumerate(zip(spec.col_kinds,
                                                   spec.col_offsets))]
        for k, d in enumerate(spec.derived):
            src, ref = (_SRC_STAGE, stage[k]) if k in stage else \
                (_SRC_OUT, k)
            col.append(src << 8 | d.out << 10 | ref << 16)
        tile_at = {k: (a, v) for k, a, _w, v, _s in self.tiles}
        # ops as (kind, node[, leaf]) items; the stack entries below the
        # top that the deepest program needs
        passes, ops, self.stack = [], [], 0
        for p, prog in enumerate(progs):
            if p < n_der:
                d = spec.derived[p]
                head = MODE_DERIVE | d.out << 8 | (stage.get(p, -1) + 1) << 16
                data, valid = tile_at.get(p, (-1, -1))
            else:
                head, data, valid = MODE_MASK, -1, -1
            kops = _kernel_ops(prog)
            passes += [head, len(ops) | len(kops) << 32, data, valid]
            ops.extend(kops)
            depth = 0
            for item in kops:
                n = item[1]
                depth += 0 if item[0] == "fuse" else \
                    1 if n[0] in _NULLARY else -1 if n[0] in _BINARY else 0
                self.stack = max(self.stack, depth - 1)
        raw_at = _W_HEAD + len(passes)
        header = [_W_HEAD, raw_at + len(raws), len(progs),
                  -1 if self.mask_at is None else self.mask_at, raw_at,
                  len(raws)]

        def word(op, arg, imm):
            return col[arg] | op if op == K.OP_COL else \
                (imm & 0xFFFFFFFF) << 32 | arg << 8 | op
        op_words = []
        for item in ops:
            if item[0] == "op":
                op_words.append(word(*item[1][:3]))
                continue
            (op, code, _i, _k), (lop, larg, limm, _lk) = item[1], item[2]
            leaf = col[larg] if lop == K.OP_COL else \
                (limm & 0xFFFFFFFF) << 32
            op_words.append(leaf | code << 13 |
                            (FUSE_COL if lop == K.OP_COL else FUSE_IMM) | op)
        words = header + [0] * (_W_HEAD - len(header)) + passes + raws + \
            op_words
        # each word's 64 bits as an int64
        self.words = np.asarray([w - 2**64 if w >= 2**63 else w
                                 for w in words], dtype=np.int64)
        self.n_out = n_der
        self.dtypes = [_OUT_DTYPE[d.out] for d in spec.derived]
        self.widths = [_WIDTH[k] for k in spec.col_kinds]
        self._dev: dict = {}

    def words_on(self, device: torch.device) -> torch.Tensor:
        """The words on `device`, uploaded at its first call there."""
        t = self._dev.get(device.index)
        if t is None:
            t = self._dev[device.index] = torch.from_numpy(
                self.words).to(device)
        return t

    def carve(self, buf, n: int, n_pad: int, shape):
        """(the derived tiles, None where not stored; the mask or None)
        as views of the call's buffer."""
        tiles = [None] * self.n_out
        for k, at, w, v, stored in self.tiles:
            if stored:
                tiles[k] = (buf[at * n_pad: at * n_pad + w * n].view(
                    self.dtypes[k]).view(shape),
                    buf[v * n_pad: v * n_pad + n].view(torch.bool).view(
                        shape))
        if self.mask_at is None:
            return tiles, None
        at = self.mask_at * n_pad
        return tiles, buf[at: at + n].view(torch.bool).view(shape)


def scan_eval(spec: EvalSpec, cols, rowmask: torch.Tensor):
    """Run `spec`'s passes over every row of one chunk's tiles: cols is
    one (data, mask) pair per input slot, each the row mask's shape.
    Returns (per derive pass its (data, valid) tiles, or None where it is
    not stored; the row mask narrowed by the mask passes, or `rowmask`
    itself where there is none)."""
    if not K._is_cuda(*[t for pair in cols for t in pair], rowmask):
        return scan_eval_plain(spec, cols, rowmask)
    return _launch(spec, cols, rowmask)


def _launch(spec: EvalSpec, cols, rowmask: torch.Tensor):
    plan = spec.plan
    if plan is None:
        plan = spec.plan = _Plan(spec)
    _check(plan.widths, cols, rowmask)
    ptrs = []
    for data, mask in cols:
        if not (data.is_contiguous() and mask.is_contiguous()):
            raise ValueError("scan_eval: tensors must be contiguous")
        ptrs += (data.data_ptr(), mask.data_ptr())
    if not rowmask.is_contiguous():
        raise ValueError("scan_eval: tensors must be contiguous")
    ptrs = np.array(ptrs, dtype=np.int64)
    shape = rowmask.shape
    dev = rowmask.device
    n = rowmask.numel()
    n_pad = -(-n // 16) * 16
    words = plan.words_on(dev)
    buf = torch.empty(plan.row_bytes * n_pad, dtype=torch.uint8,
                      device=dev) if plan.row_bytes else None
    lib = _build.load("scan")
    LAUNCHES.bump("scan_eval")
    _build.check(lib.scan_eval(
        words.data_ptr(), ptrs.ctypes.data, len(cols), rowmask.data_ptr(),
        buf.data_ptr() if buf is not None else None, n, plan.n_stages,
        plan.raw_units, plan.stack, K._stream(rowmask)), "scan_eval")
    tiles, mask = plan.carve(buf, n, n_pad, shape)
    return tiles, rowmask if mask is None else mask
