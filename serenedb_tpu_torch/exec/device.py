"""Lowering of bound expressions for the device tier (port of
serenedb_tpu/exec/device.py `compile_expr`).

The reference lowers a `BoundExpr` to a JAX closure over (data, mask)
tile pairs. The port lowers the same grammar to a flat postfix program
that the `agg_scan` kernel interprets per row on a stack of (32-bit
value, valid bit) entries (`ops/agg_kernels.py` holds the opcodes and the
plain whole-column evaluator). Types are resolved here, so every op is
typed: the stack holds int8-wrapped ints ('i8': BOOL/TINYINT tiles), int32
('i'), float32 ('f') or booleans ('b'), and the reference's `_unify`
promotion of an int to f32 becomes an explicit OP_I2F.

Grammar, as the reference's: literals (NULL, bool, int32, float), columns
of numeric or dictionary-string type, `= <> != < <= > >=`, `+ - *`
(int32 wraps), three-valued `and`/`or`/`not`, `is_null`/`is_not_null`,
`cast` to float or int (PG rounding), and string-vs-literal comparison on
sorted-dictionary code thresholds. `NotCompilable` is raised where the
reference raises it: int64 literals, string literals outside a
comparison, division, string-string comparison, other functions, and for
arithmetic on two booleans, which no statement reaches (the binder
refuses `bool + bool` in both packages). A program of any depth lowers:
one that needs a deeper stack than the kernels' (`agg_kernels.MAX_STACK`)
is split across launches by exec/device_split.py.
"""

from __future__ import annotations

import numpy as np

from ..columnar import dtypes as dt
from ..ops import agg_kernels as K
from ..sql.expr import BoundColumn, BoundExpr, BoundFunc, BoundLiteral

_NUMERIC_IDS = {dt.TypeId.BOOL, dt.TypeId.TINYINT, dt.TypeId.SMALLINT,
                dt.TypeId.INT, dt.TypeId.BIGINT, dt.TypeId.FLOAT,
                dt.TypeId.DOUBLE, dt.TypeId.TIMESTAMP, dt.TypeId.DATE}

_CMP = {"op=", "op<>", "op!=", "op<", "op<=", "op>", "op>="}
_ARITH = {"op+", "op-", "op*", "op/", "op%"}
_ARITH_OPS = {"+": (K.OP_ADD_I, K.OP_ADD_F), "-": (K.OP_SUB_I, K.OP_SUB_F),
              "*": (K.OP_MUL_I, K.OP_MUL_F)}


class NotCompilable(Exception):
    """Expression/plan shape the device tier declines — the caller runs
    the host path. `reason` is a short category slug."""

    def __init__(self, msg: str = "", reason: str = "not_compilable"):
        super().__init__(msg)
        self.reason = reason


class DeviceExpr:
    """A lowered expression: the postfix program `ops` over the input
    slots `inputs` (scan column indices, in slot order), its result type
    ('b', 'i8', 'i' or 'f'), and `consts`, every
    data-dependent constant baked into the program (the dictionary-code
    thresholds of string comparisons), which a program cache key that
    drops the publication must include."""

    def __init__(self, ops: tuple, inputs: list[int], type_: str,
                 consts: tuple = ()):
        self.ops = ops
        self.inputs = inputs
        self.type = type_
        self.consts = consts

    def remap(self, slot_of: dict[int, int]) -> tuple:
        """The program with its input slots renumbered to a scan's slots
        (scan column index → scan slot)."""
        return tuple((op, slot_of[self.inputs[arg]] if op == K.OP_COL
                      else arg, imm) for op, arg, imm in self.ops)


def column_type(t: dt.SqlType) -> str:
    """The device value type of a column's decoded tiles."""
    np_dt = t.np_dtype
    if np_dt.kind == "f":
        return "f"
    if np_dt in (np.dtype(np.bool_), np.dtype(np.int8)):
        return "i8"
    return "i"


def compile_expr(expr: BoundExpr, col_types: list[dt.SqlType],
                 dictionaries: dict[int, np.ndarray]) -> DeviceExpr:
    """Lower a bound expression to a postfix program.

    dictionaries: scan column index → sorted dictionary (VARCHAR columns),
    used to resolve string literals to code thresholds here.
    Raises NotCompilable for unsupported shapes (the caller runs the host
    path)."""
    inputs: list[int] = []
    index_of: dict[int, int] = {}
    consts: list = []

    def slot(col_index: int) -> int:
        if col_index not in index_of:
            index_of[col_index] = len(inputs)
            inputs.append(col_index)
        return index_of[col_index]

    # rec(e) -> (ops, type); operands are lowered left to right, so input
    # slots number in the reference's order
    def rec(e: BoundExpr):
        if isinstance(e, BoundLiteral):
            if e.value is None:
                return [(K.OP_NULL, 0, 0)], "i"
            if isinstance(e.value, bool):
                return [(K.OP_I32, 0, 1 if e.value else 0)], "i"
            if isinstance(e.value, int):
                if not (-2**31 <= e.value < 2**31):
                    raise NotCompilable("int64 literal")
                return [(K.OP_I32, 0, e.value)], "i"
            if isinstance(e.value, float):
                return [(K.OP_F32, 0, K.f32_bits(e.value))], "f"
            raise NotCompilable("string literal outside comparison")
        if isinstance(e, BoundColumn):
            if e.type.id not in _NUMERIC_IDS and not e.type.is_string:
                raise NotCompilable(f"column type {e.type}")
            return [(K.OP_COL, slot(e.index), 0)], column_type(e.type)
        if isinstance(e, BoundFunc):
            return rec_func(e)
        raise NotCompilable(type(e).__name__)

    def as_bool(sub):
        ops, t = sub
        if t == "f":
            ops = ops + [(K.OP_TOBOOL_F, 0, 0)]
        elif t != "b":
            ops = ops + [(K.OP_TOBOOL_I, 0, 0)]
        return ops

    def rec_func(e: BoundFunc):
        name = e.name
        if name in _CMP:
            return compile_compare(e)
        if name in _ARITH:
            return compile_arith(e)
        if name in ("and", "or"):
            op = K.OP_AND if name == "and" else K.OP_OR
            ops = as_bool(rec(e.args[0]))
            for a in e.args[1:]:
                ops = ops + as_bool(rec(a)) + [(op, 0, 0)]
            return ops, "b"
        if name == "not":
            return as_bool(rec(e.args[0])) + [(K.OP_NOT, 0, 0)], "b"
        if name in ("is_null", "is_not_null"):
            ops, _t = rec(e.args[0])
            op = K.OP_IS_NOT_NULL if name == "is_not_null" else K.OP_IS_NULL
            return ops + [(op, 0, 0)], "b"
        if name == "cast":
            ops, t = rec(e.args[0])
            if e.type.is_float:
                return (ops + [(K.OP_I2F, 0, 0)] if t != "f" else ops), "f"
            if e.type.is_integer:
                return (ops + [(K.OP_F2I, 0, 0)] if t == "f" else ops), "i"
            raise NotCompilable("cast target")
        raise NotCompilable(f"function {name}")

    def binary(a: BoundExpr, b: BoundExpr):
        """Both operands' programs, an int one promoted to f32 when the
        other is f32 (the reference's `_unify`)."""
        oa, ta = rec(a)
        ob, tb = rec(b)
        if tb == "f" and ta != "f":
            oa = oa + [(K.OP_I2F, 0, 0)]
        if ta == "f" and tb != "f":
            ob = ob + [(K.OP_I2F, 0, 0)]
        return oa + ob, ta, tb

    def compile_compare(e: BoundFunc):
        a, b = e.args
        name = e.name
        # string vs literal → code threshold
        for col, lit, flip in ((a, b, False), (b, a, True)):
            if isinstance(col, BoundColumn) and col.type.is_string and \
                    isinstance(lit, BoundLiteral) and isinstance(lit.value, str):
                d = dictionaries.get(col.index)
                if d is None:
                    raise NotCompilable("no dictionary for string column")
                return compile_str_cmp(col, lit.value, name, flip, d)
        if (isinstance(a, BoundColumn) and a.type.is_string) or \
                (isinstance(b, BoundColumn) and b.type.is_string):
            raise NotCompilable("string-string comparison on device")
        ops, ta, tb = binary(a, b)
        op = K.OP_CMP_F if "f" in (ta, tb) else K.OP_CMP_I
        return ops + [(op, K.CMP_CODES[name[2:]], 0)], "b"

    def compile_str_cmp(col: BoundColumn, s: str, name: str, flip: bool,
                        d: np.ndarray):
        """col OP 'literal' on sorted dictionary codes."""
        op = name[2:]
        if flip:  # 'literal' OP col  →  col FLIP(OP) literal
            op = {"=": "=", "<>": "<>", "!=": "<>", "<": ">", "<=": ">=",
                  ">": "<", ">=": "<="}[op]
        ds = d.astype(str)
        lo = int(np.searchsorted(ds, s, side="left"))
        hi = int(np.searchsorted(ds, s, side="right"))
        exact = lo < len(ds) and ds[lo] == s
        sl = slot(col.index)
        consts.append((col.index, op, lo, hi, exact))
        if op in ("=", "<>", "!=") and not exact:
            # no such string: constant false (=) or true (<>), valid
            # where the column is
            return [(K.OP_COL, sl, 0),
                    (K.OP_SETV, 0, 0 if op == "=" else 1)], "b"
        code, thr = {"=": ("=", lo), "<>": ("<>", lo), "!=": ("<>", lo),
                     "<": ("<", lo), "<=": ("<", hi), ">": (">=", hi),
                     ">=": (">=", lo)}[op]
        return [(K.OP_COL, sl, 0), (K.OP_I32, 0, thr),
                (K.OP_CMP_I, K.CMP_CODES[code], 0)], "b"

    def compile_arith(e: BoundFunc):
        op = e.name[2:]
        if op not in _ARITH_OPS:
            raise NotCompilable("device division")  # PG trunc: host
        ops, ta, tb = binary(e.args[0], e.args[1])
        iop, fop = _ARITH_OPS[op]
        if "f" in (ta, tb):
            return ops + [(fop, 0, 0)], "f"
        if ta == "b" and tb == "b":
            raise NotCompilable("arithmetic on two booleans")
        if ta == "i8" and tb == "i8":
            # int8 op int8 wraps at 8 bits, as the reference's int8 tiles do
            return ops + [(iop, 0, 0), (K.OP_WRAP8, 0, 0)], "i8"
        return ops + [(iop, 0, 0)], "i"

    ops, top = rec(expr)
    return DeviceExpr(tuple(ops), inputs, top, tuple(consts))
