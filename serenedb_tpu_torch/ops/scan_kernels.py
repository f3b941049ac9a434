"""Wrapper of the scan programs' split pass (`csrc/scan.cu`) and its plain
PyTorch version.

`scan_eval` has no TPU kernel of its own to replace: the reference's XLA
traces any expression into the one program of K5/K6/K8
(serenedb_tpu/exec/device.py:60 `compile_expr`, device_agg.py:251
`program`). The port's scan kernels (`agg_scan`, `join_probe`,
`topn_scan`) interpret postfix programs on an 8-entry stack over at most
16 columns a launch; where a statement goes past that, the planner
(exec/device_split.py) runs parts of it here first, through the same
interpreter (csrc/expr.cuh) and op ABI, and hands the results to the scan
kernel as a narrowed row mask or as extra column slots.

One launch over the rows of up to 16 column tiles does one of:

- mask mode (`EvalSpec.prog` is None): the (R, 128) bool row mask ANDed
  with the conjunction of the predicate programs;
- derive mode: one program's value as a (R, 128) column tile (`out`:
  COL_I32, COL_I8 or COL_F32) and its bool validity; an invalid row's
  value is 0.

The wrapper launches the kernel for tensors on a CUDA device and counts
the launch in `device.LAUNCHES`; for tensors on the CPU it calls the
plain version (counted under `scan_eval.plain`). There is no other path.
The plain version evaluates with `agg_kernels.eval_plain`, the scan
kernels' plain interpreter, so the two agree bit for bit (NaN payloads
aside: the card's NaN is canonical).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..device import LAUNCHES
from . import _build
from . import agg_kernels as K

# header words of the descriptor (csrc/scan.cu; keep in step)
_H_MODE, _H_PROG, _H_PROG_N, _H_OUT, _H_OUT_MASK, _H_ROWS, _H_OUT_KIND = \
    2, 4, 5, 7, 8, 9, 10
MODE_MASK, MODE_DERIVE = 0, 1
#: the derived tile's storage, by decode kind (csrc/scan.cu OUT_*)
_OUT_CODE = {K.COL_I32: 0, K.COL_I8: 1, K.COL_F32: 2}
_OUT_DTYPE = {K.COL_I32: torch.int32, K.COL_I8: torch.int8,
              K.COL_F32: torch.float32}


@dataclass
class EvalSpec:
    """One scan_eval launch, independent of the data: per input slot its
    decode (kind, offset); the predicate programs (mask mode) or the one
    program `prog` and its output kind `out` (derive mode)."""
    col_kinds: list
    col_offsets: list
    preds: list = field(default_factory=list)
    prog: Optional[tuple] = None
    out: int = K.COL_I32


def _check(spec: EvalSpec, cols, rowmask) -> None:
    if len(cols) != len(spec.col_kinds) or len(cols) > K.MAX_COLS:
        raise ValueError("scan_eval: one (data, mask) pair per input slot, "
                         f"at most {K.MAX_COLS}")
    if rowmask.dtype != torch.bool or rowmask.dim() != 2 or \
            rowmask.shape[1] != 128:
        raise ValueError("rowmask: (R, 128) bool")
    for data, mask in cols:
        if data.shape != rowmask.shape or mask.shape != rowmask.shape:
            raise ValueError("column tiles: same shape as the row mask")
    progs = [spec.prog] if spec.prog is not None else spec.preds
    if spec.prog is None and len(spec.preds) > K.MAX_PREDS:
        raise ValueError(f"scan_eval: at most {K.MAX_PREDS} predicates")
    if sum(map(len, progs)) > K.MAX_OPS:
        raise ValueError("programs exceed the kernel's descriptor")
    if spec.prog is not None and spec.out not in _OUT_CODE:
        raise ValueError(f"scan_eval: no output kind {spec.out}")


def scan_eval_plain(spec: EvalSpec, cols, rowmask: torch.Tensor):
    """Plain version of `scan_eval`: the same tile(s), whole-column."""
    LAUNCHES.bump("scan_eval.plain")
    _check(spec, cols, rowmask)
    n = rowmask.numel()
    env = [(K.decode_plain(kind, off, data.reshape(-1)), mask.reshape(-1))
           for (data, mask), kind, off in zip(cols, spec.col_kinds,
                                              spec.col_offsets)]
    dev = rowmask.device

    def run(prog):       # (a program that reads no column runs on the CPU)
        v, ok = K.eval_plain(prog, env, n)
        return v.to(dev), ok.to(dev)
    if spec.prog is None:
        m = rowmask.reshape(-1).clone()
        for ops in spec.preds:
            v, ok = run(ops)
            m &= (v != 0) & ok
        return m.view(rowmask.shape)
    v, ok = run(spec.prog)
    # the value's 32-bit pattern, 0 where invalid, as the kernel stores it
    bits = v.contiguous().view(torch.int32) if v.dtype == torch.float32 \
        else K._i32(v)
    bits = torch.where(ok, bits, torch.zeros_like(bits))
    if spec.out == K.COL_F32:
        v = bits.view(torch.float32)
    elif spec.out == K.COL_I8:
        v = (((bits + 128) & 0xFF) - 128).to(torch.int8)
    else:
        v = bits
    return v.reshape(rowmask.shape), ok.reshape(rowmask.shape).clone()


def scan_eval(spec: EvalSpec, cols, rowmask: torch.Tensor):
    """Run `spec` over every row of one chunk's (R, 128) tiles: cols is
    one (data, mask) pair per input slot. Mask mode returns the (R, 128)
    bool row mask of the rows where `rowmask` and every predicate are
    TRUE; derive mode returns the (data, valid) tiles of `prog` (data of
    `out`'s dtype, 0 where invalid) and reads `rowmask` only for its
    shape."""
    tensors = [t for pair in cols for t in pair] + [rowmask]
    if not K._is_cuda(*tensors):
        return scan_eval_plain(spec, cols, rowmask)
    _check(spec, cols, rowmask)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("scan_eval: tensors must be contiguous")
    dev = rowmask.device
    n = rowmask.numel()
    d, place, ops = K.new_descriptor(cols, spec.col_kinds, spec.col_offsets,
                                     preds=spec.preds if spec.prog is None
                                     else ())
    d[K._H_ROWMASK] = rowmask.data_ptr()
    d[_H_ROWS] = n
    valid = torch.empty(rowmask.shape, dtype=torch.bool, device=dev)
    d[_H_OUT_MASK] = valid.data_ptr()
    out = None
    if spec.prog is None:
        d[_H_MODE] = MODE_MASK
    else:
        d[_H_MODE] = MODE_DERIVE
        d[_H_PROG], d[_H_PROG_N] = place(spec.prog)
        out = torch.empty(rowmask.shape, dtype=_OUT_DTYPE[spec.out],
                          device=dev)
        d[_H_OUT] = out.data_ptr()
        d[_H_OUT_KIND] = _OUT_CODE[spec.out]
    desc = K.finish_descriptor(d, ops)
    lib = _build.load("scan")
    LAUNCHES.bump("scan_eval")
    _build.check(lib.scan_eval(desc.ctypes.data, n, K._stream(rowmask)),
                 "scan_eval")
    return valid if out is None else (out, valid)
