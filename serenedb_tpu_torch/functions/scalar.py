"""Copied from serenedb_tpu/functions/scalar.py.

Scalar function & operator library (CPU reference implementations).

Reference analog: server/connector/functions/{math,string,array,json,...}.cpp
(~8 kLoC of PG-compatible functions; SURVEY.md §2.5). Semantics follow
PostgreSQL: strict NULL propagation unless noted, integer division truncates,
division by zero raises 22012, 1-based string indexing.

Each registry entry resolves (arg_types) -> (result_type, impl) where impl is
(cols: list[Column], n_rows) -> Column.
"""

from __future__ import annotations

import json
import math
import re
from typing import Callable, Optional

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Column
from ..sql.expr import make_string_column, propagate_nulls, string_values


class FunctionResolution:
    def __init__(self, result_type: dt.SqlType, impl: Callable):
        self.result_type = result_type
        self.impl = impl


_REGISTRY: dict[str, Callable] = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def resolve(name: str, arg_types: list[dt.SqlType]) -> FunctionResolution:
    fn = _REGISTRY.get(name)
    if fn is None:
        raise errors.SqlError(errors.UNDEFINED_FUNCTION,
                              f"function {name}({', '.join(map(str, arg_types))}) "
                              "does not exist")
    res = fn(arg_types)
    if res is None:
        raise errors.SqlError(errors.UNDEFINED_FUNCTION,
                              f"function {name}({', '.join(map(str, arg_types))}) "
                              "does not exist")
    return res


def exists(name: str) -> bool:
    return name in _REGISTRY


# -- helpers ---------------------------------------------------------------

def _num(col: Column) -> np.ndarray:
    return col.data


def _result(typ: dt.SqlType, data: np.ndarray, cols: list[Column],
            extra_invalid: Optional[np.ndarray] = None) -> Column:
    validity = propagate_nulls(cols)
    if extra_invalid is not None and extra_invalid.any():
        validity = (validity if validity is not None
                    else np.ones(len(data), dtype=bool)) & ~extra_invalid
    return Column(typ, np.ascontiguousarray(data, dtype=typ.np_dtype), validity)


def _all_numeric(ts: list[dt.SqlType]) -> bool:
    return all(t.is_numeric or t.id in (dt.TypeId.TIMESTAMP, dt.TypeId.DATE)
               or t.id is dt.TypeId.NULL for t in ts)


# -- comparisons -----------------------------------------------------------

_CMP_NP = {
    "=": np.equal, "<>": np.not_equal, "!=": np.not_equal,
    "<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
}


def _make_compare(op: str):
    def resolver(ts: list[dt.SqlType]):
        if len(ts) == 2 and all(t.id is dt.TypeId.RECORD for t in ts):
            return _record_compare(op)

        def impl(cols, n):
            a, b = cols
            if a.type.is_string or b.type.is_string:
                av, bv = string_values(a), string_values(b)
                data = _CMP_NP[op](av, bv)
            else:
                data = _CMP_NP[op](a.data, b.data)
                # PG float total order: NaN = NaN, NaN > everything
                # (reference: server/pg/serialize.cpp float semantics)
                anan = (np.isnan(a.data) if a.data.dtype.kind == "f"
                        else np.zeros(len(a.data), dtype=bool))
                bnan = (np.isnan(b.data) if b.data.dtype.kind == "f"
                        else np.zeros(len(b.data), dtype=bool))
                nan_rows = anan | bnan
                if nan_rows.any():
                    both = anan & bnan
                    if op == "=":
                        fix = both
                    elif op in ("<>", "!="):
                        fix = nan_rows & ~both
                    elif op == "<":
                        fix = bnan & ~anan
                    elif op == "<=":
                        fix = bnan
                    elif op == ">":
                        fix = anan & ~bnan
                    else:  # >=
                        fix = anan
                    data = np.where(nan_rows, fix, data)
            return _result(dt.BOOL, data, cols)
        return FunctionResolution(dt.BOOL, impl)
    return resolver


def _record_compare(op: str) -> FunctionResolution:
    """Field-wise record comparison (PG record_eq/record_cmp family):
    physical-text compare would order ROW(10) before ROW(2) and miss
    cross-width equality, so records parse and compare by value."""
    def impl(cols, n):
        from ..columnar.pgcopy import record_cmp_sql
        av, bv = string_values(cols[0]), string_values(cols[1])
        data = np.zeros(n, dtype=bool)
        sqlnull = np.zeros(n, dtype=bool)
        for i in range(n):
            c = record_cmp_sql(str(av[i]), str(bv[i]))
            if c is None:
                sqlnull[i] = True
            elif op == "=":
                data[i] = c == 0
            elif op in ("<>", "!="):
                data[i] = c != 0
            elif op == "<":
                data[i] = c < 0
            elif op == "<=":
                data[i] = c <= 0
            elif op == ">":
                data[i] = c > 0
            else:
                data[i] = c >= 0
        return _result(dt.BOOL, data, cols, extra_invalid=sqlnull)
    return FunctionResolution(dt.BOOL, impl)


for _op in _CMP_NP:
    _REGISTRY[f"op{_op}"] = _make_compare(_op)


@register("is_distinct_from")
def _is_distinct(ts):
    def impl(cols, n):
        a, b = cols
        av, bv = a.valid_mask(), b.valid_mask()
        if a.type.is_string or b.type.is_string:
            eq = string_values(a) == string_values(b)
        else:
            eq = a.data == b.data
        same = (av & bv & eq) | (~av & ~bv)
        return Column(dt.BOOL, ~same)
    return FunctionResolution(dt.BOOL, impl)


@register("is_not_distinct_from")
def _is_not_distinct(ts):
    inner = _is_distinct(ts)

    def impl(cols, n):
        c = inner.impl(cols, n)
        return Column(dt.BOOL, ~c.data)
    return FunctionResolution(dt.BOOL, impl)


# -- arithmetic ------------------------------------------------------------

def _arith_type(op: str, a: dt.SqlType, b: dt.SqlType) -> dt.SqlType:
    t = dt.common_numeric(a, b)
    if t.id is dt.TypeId.BOOL:
        raise errors.SqlError(errors.DATATYPE_MISMATCH,
                              f"operator {op} does not accept boolean")
    return t


_US_DAY = 86_400_000_000


def _datetime_arith(op: str, ts: list):
    """Result SqlType for timestamp/date/interval arithmetic (PG rules);
    None when the operand types are not a datetime combination."""
    TS, D, IV = dt.TypeId.TIMESTAMP, dt.TypeId.DATE, dt.TypeId.INTERVAL
    a, b = ts[0].id, ts[1].id
    NULL = dt.TypeId.NULL
    if NULL in (a, b) and {a, b} & {TS, D, IV}:
        # NULL operand: the result is NULL of the natural result type
        other = ts[1] if a is NULL else ts[0]
        if op in ("+", "-"):
            return other if other.id is not D else dt.DATE
        if op in ("*", "/") and other.id is IV:
            return dt.INTERVAL
    if op == "+":
        pairs = {
            (TS, IV): dt.TIMESTAMP, (IV, TS): dt.TIMESTAMP,
            (D, IV): dt.TIMESTAMP, (IV, D): dt.TIMESTAMP,
            (IV, IV): dt.INTERVAL,
        }
        r = pairs.get((a, b))
        if r is not None:
            return r
        if a is D and ts[1].is_integer:
            return dt.DATE
        if ts[0].is_integer and b is D:
            return dt.DATE
    elif op == "-":
        pairs = {
            (TS, IV): dt.TIMESTAMP, (D, IV): dt.TIMESTAMP,
            (TS, TS): dt.INTERVAL, (IV, IV): dt.INTERVAL,
            (TS, D): dt.INTERVAL, (D, TS): dt.INTERVAL,
        }
        r = pairs.get((a, b))
        if r is not None:
            return r
        if a is D and b is D:
            return dt.INT            # days
        if a is D and ts[1].is_integer:
            return dt.DATE
    elif op in ("*", "/"):
        if a is IV and ts[1].is_numeric and b is not dt.TypeId.BOOL:
            return dt.INTERVAL
        if op == "*" and ts[0].is_numeric and b is IV and \
                a is not dt.TypeId.BOOL:
            return dt.INTERVAL
    return None


def _to_us(col, n):
    """Column value in microseconds (dates scale by the day)."""
    x = col.data.astype(np.int64)
    if col.type.id is dt.TypeId.DATE:
        x = x * _US_DAY
    return x


def _make_datetime_arith(op: str, ts: list, out_t):
    def impl(cols, n):
        D, IV = dt.TypeId.DATE, dt.TypeId.INTERVAL
        a, b = cols[0], cols[1]
        if op in ("*", "/"):
            iv = a if a.type.id is IV else b
            num = b if a.type.id is IV else a
            x = num.data.astype(np.float64)
            with np.errstate(all="ignore"):
                data = (iv.data.astype(np.float64) * x if op == "*"
                        else iv.data.astype(np.float64) / x)
            if op == "/":
                zero = x == 0
                pn = propagate_nulls(cols)
                live_zero = zero if pn is None else (zero & pn)
                if live_zero.any():
                    raise errors.SqlError(errors.DIVISION_BY_ZERO,
                                          "division by zero")
                with np.errstate(all="ignore"):
                    data = np.where(zero, 0.0, data)
            return _result(out_t, np.round(data).astype(np.int64), cols)
        if out_t.id is dt.TypeId.DATE:
            # date ± integer days
            d = a if a.type.id is D else b
            k = b if a.type.id is D else a
            kk = k.data.astype(np.int64)
            data = (d.data.astype(np.int64) + kk if op == "+"
                    else d.data.astype(np.int64) - kk)
            pn = propagate_nulls(cols)
            over = np.abs(data) > 2**31 - 1
            if pn is not None:
                over &= pn
            if over.any():
                raise errors.SqlError("22008", "date out of range")
            return _result(dt.DATE, data.astype(np.int32), cols)
        if out_t.id is dt.TypeId.INT:
            # date - date = days
            return _result(dt.INT, (a.data.astype(np.int64) -
                                    b.data.astype(np.int64)).astype(
                                        np.int32), cols)
        av, bv = _to_us(a, n), _to_us(b, n)
        data = av + bv if op == "+" else av - bv
        return _result(out_t, data, cols)
    return FunctionResolution(out_t, impl)


def _make_arith(op: str):
    def resolver(ts: list[dt.SqlType]):
        if len(ts) == 2:
            out_t = _datetime_arith(op, ts)
            if out_t is not None:
                return _make_datetime_arith(op, ts, out_t)
        if len(ts) != 2 or not _all_numeric(ts):
            return None
        t = _arith_type(op, ts[0], ts[1])
        if op == "/" and t.is_integer:
            pass  # PG: int/int truncates toward zero
        def impl(cols, n):
            a, b = cols[0].data, cols[1].data
            extra_invalid = None
            if op in ("+", "-", "*") and t.is_integer:
                # compute in int64 and range-check: PG raises 22003 on
                # int32/int64 overflow instead of silently wrapping
                aa = a.astype(np.int64)
                bb = b.astype(np.int64)
                with np.errstate(over="ignore"):
                    if op == "+":
                        data64 = aa + bb
                        bad = ((aa > 0) & (bb > 0) & (data64 < 0)) | \
                              ((aa < 0) & (bb < 0) & (data64 > 0))
                    elif op == "-":
                        data64 = aa - bb
                        bad = ((aa >= 0) & (bb < 0) & (data64 < 0)) | \
                              ((aa < 0) & (bb > 0) & (data64 > 0))
                    else:
                        data64 = aa * bb
                        # verify from BOTH sides: -1 * INT64_MIN wraps and
                        # the aa-side division wraps back to bb, hiding it
                        bad = (aa != 0) & (data64 // np.where(aa == 0, 1,
                                                              aa) != bb)
                        bad |= (bb != 0) & (
                            data64 // np.where(bb == 0, 1, bb) != aa)
                pn = propagate_nulls(cols)
                if pn is not None:
                    bad &= pn
                info = np.iinfo(t.np_dtype)
                small = (data64 < info.min) | (data64 > info.max)
                if pn is not None:
                    small &= pn
                if bad.any() or small.any():
                    kind = {np.dtype(np.int16): "smallint",
                            np.dtype(np.int32): "integer"}.get(
                        np.dtype(t.np_dtype), "bigint")
                    raise errors.SqlError(
                        "22003", f"{kind} out of range")
                data = data64.astype(t.np_dtype)
            elif op == "+":
                data = a.astype(t.np_dtype) + b.astype(t.np_dtype)
            elif op == "-":
                data = a.astype(t.np_dtype) - b.astype(t.np_dtype)
            elif op == "*":
                data = a.astype(t.np_dtype) * b.astype(t.np_dtype)
            elif op in ("/", "%"):
                bb = b.astype(t.np_dtype)
                zero = bb == 0
                # only error on division by zero in non-NULL rows
                pn = propagate_nulls(cols)
                live_zero = zero if pn is None else (zero & pn)
                if t.is_integer:
                    if live_zero.any():
                        raise errors.SqlError(errors.DIVISION_BY_ZERO,
                                              "division by zero")
                    aa = a.astype(np.int64)
                    bb64 = b.astype(np.int64)
                    # zeros can remain in NULL rows; divide by 1 there
                    bsafe = np.where(bb64 == 0, 1, bb64)
                    q = (np.abs(aa) // np.abs(bsafe)) * np.sign(aa) * np.sign(bsafe)
                    data = q if op == "/" else aa - q * bb64
                    data = data.astype(t.np_dtype)
                else:
                    if live_zero.any():
                        raise errors.SqlError(errors.DIVISION_BY_ZERO,
                                              "division by zero")
                    with np.errstate(divide="ignore", invalid="ignore"):
                        data = (a.astype(t.np_dtype) / bb) if op == "/" \
                            else np.fmod(a.astype(t.np_dtype), bb)
            else:
                raise AssertionError(op)
            return _result(t, data, cols, extra_invalid)
        return FunctionResolution(t, impl)
    return resolver


for _op in ("+", "-", "*", "/", "%"):
    _REGISTRY[f"op{_op}"] = _make_arith(_op)


# '+' and comparison registrations collide on name; re-dispatch by type:
def _dispatch(name, arith, compare=None):
    def resolver(ts):
        r = arith(ts)
        if r is not None:
            return r
        return compare(ts) if compare else None
    return resolver


_REGISTRY["op||"] = None  # set below


@register("opneg")
def _neg(ts):
    t = ts[0] if (ts[0].is_numeric or
                  ts[0].id is dt.TypeId.INTERVAL) else None
    if t is None:
        return None

    def impl(cols, n):
        return _result(t, -cols[0].data, cols)
    return FunctionResolution(t, impl)


# -- concat ----------------------------------------------------------------

def _concat_resolver(ts):
    def impl(cols, n):
        parts = [_col_text_values(c) for c in cols]
        data = parts[0]
        for p in parts[1:]:
            data = np.char.add(data, p)
        return make_string_column(data, propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


_REGISTRY["op||"] = _concat_resolver


def _concat_skip_nulls(ts):
    """concat(...) ignores NULL arguments (PG); only || propagates them."""
    if not ts:
        return None   # concat() with no args: 42883, like PG
    def impl(cols, n):
        parts = []
        for c in cols:
            valid = c.valid_mask() if c.validity is not None else None
            vals = _col_text_values(c)
            if valid is not None:
                vals = np.where(valid, vals, "")
            parts.append(vals)
        data = parts[0]
        for p in parts[1:]:
            data = np.char.add(data, p)
        return make_string_column(data, None)
    return FunctionResolution(dt.VARCHAR, impl)


_REGISTRY["concat"] = _concat_skip_nulls


def _concat_ws(ts):
    """concat_ws(sep, ...) joins non-NULL arguments with the separator
    (PG); a NULL separator yields NULL."""
    if len(ts) < 1:
        return None

    def impl(cols, n):
        sep_col = cols[0]
        sep_valid = sep_col.valid_mask()
        seps = string_values(sep_col) if sep_col.type.is_string else \
            np.asarray([_pg_text(v) for v in sep_col.to_pylist()],
                       dtype=object).astype(str)
        pieces = []
        for c in cols[1:]:
            valid = c.valid_mask()
            if c.type.is_string:
                vals = string_values(c)
            else:
                vals = np.asarray([_pg_text(v) for v in c.to_pylist()],
                                  dtype=object).astype(str)
            pieces.append((vals, valid))
        out = np.empty(n, dtype=object)
        for i in range(n):
            parts = [str(v[i]) for v, valid in pieces if valid[i]]
            out[i] = str(seps[i]).join(parts)
        return make_string_column(out, None if sep_valid.all()
                                  else sep_valid)
    return FunctionResolution(dt.VARCHAR, impl)


_REGISTRY["concat_ws"] = _concat_ws


def _pg_text(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "t" if v else "f"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v)) if v == int(v) else str(v)
    return str(v)


def _col_text_values(c) -> np.ndarray:
    """Column → PG cast-to-text renderings (DATE/TIMESTAMP/INTERVAL as
    their text, bool as true/false — expression-context semantics, not
    the wire's t/f)."""
    if c.type.is_string:
        return string_values(c)
    if c.type.id in (dt.TypeId.DATE, dt.TypeId.TIMESTAMP,
                     dt.TypeId.INTERVAL):
        from ..columnar.pgcopy import _scalar_field_text
        return np.asarray(
            ["" if v is None else _scalar_field_text(c.type, v)
             for v in c.to_pylist()], dtype=object).astype(str)
    if c.type.id is dt.TypeId.BOOL:
        return np.asarray(
            ["" if v is None else ("true" if v else "false")
             for v in c.to_pylist()], dtype=object).astype(str)
    return np.asarray([_pg_text(v) for v in c.to_pylist()],
                      dtype=object).astype(str)


# -- math functions --------------------------------------------------------

def _unary_math(np_fn, out_type=None, domain=None, domain_msg=""):
    """domain: predicate over the input array; rows where a VALID input
    falls outside it raise (PG: sqrt(-1)/ln(0) are errors, not NaN)."""
    def resolver(ts):
        if len(ts) != 1 or not _all_numeric(ts):
            return None
        t = out_type or (ts[0] if ts[0].is_integer and np_fn in (np.abs,)
                         else dt.DOUBLE)
        def impl(cols, n):
            x = cols[0].data.astype(np.float64 if t == dt.DOUBLE else t.np_dtype)
            if domain is not None:
                valid = cols[0].valid_mask() \
                    if cols[0].validity is not None else None
                bad = ~domain(x)
                if valid is not None:
                    bad &= valid
                if bad.any():
                    raise errors.SqlError("2201F", domain_msg or
                                          "input is out of range")
            with np.errstate(all="ignore"):
                data = np_fn(x)
            return _result(t, data, cols)
        return FunctionResolution(t, impl)
    return resolver


_REGISTRY["abs"] = _unary_math(np.abs)


@register("round")
def _round(ts):
    t = dt.DOUBLE if ts[0].is_float else ts[0]
    def impl(cols, n):
        x = cols[0].data.astype(np.float64)
        d = cols[1].data.astype(np.int64) if len(cols) > 1 else 0
        # PG rounds half away from zero
        scale = np.power(10.0, d)
        data = np.sign(x) * np.floor(np.abs(x) * scale + 0.5) / scale
        return _result(dt.DOUBLE if not ts[0].is_integer else ts[0], data, cols)
    return FunctionResolution(dt.DOUBLE if not ts[0].is_integer else ts[0], impl)


for name, fn in [("floor", np.floor), ("ceil", np.ceil), ("ceiling", np.ceil),
                 ("exp", np.exp), ("sin", np.sin), ("cos", np.cos),
                 ("tan", np.tan), ("atan", np.arctan),
                 ("degrees", np.degrees), ("radians", np.radians),
                 ("cbrt", np.cbrt)]:
    _REGISTRY[name] = _unary_math(fn)


@register("trunc")
def _trunc(ts):
    """trunc(x[, digits]): toward zero, optional decimal places (PG
    trunc(numeric, int))."""
    if len(ts) not in (1, 2):
        return None
    if len(ts) == 1:
        return _unary_math(np.trunc)(ts)

    def impl(cols, n):
        x = cols[0].data.astype(np.float64)
        d = cols[1].data.astype(np.int64)
        scale = np.power(10.0, d)
        data = np.trunc(x * scale) / scale
        return _result(dt.DOUBLE, data, cols)
    return FunctionResolution(dt.DOUBLE, impl)

_REGISTRY["sqrt"] = _unary_math(
    np.sqrt, domain=lambda x: x >= 0,
    domain_msg="cannot take square root of a negative number")
_REGISTRY["ln"] = _unary_math(
    np.log, domain=lambda x: x > 0,
    domain_msg="cannot take logarithm of zero or a negative number")
_REGISTRY["log10"] = _unary_math(
    np.log10, domain=lambda x: x > 0,
    domain_msg="cannot take logarithm of zero or a negative number")
_REGISTRY["asin"] = _unary_math(np.arcsin, domain=lambda x: np.abs(x) <= 1)
_REGISTRY["acos"] = _unary_math(np.arccos, domain=lambda x: np.abs(x) <= 1)


@register("factorial")
def _factorial(ts):
    def impl(cols, n):
        import math as _math
        vals = cols[0].data.astype(np.int64)
        if (vals < 0).any():
            raise errors.SqlError("2201F",
                                  "factorial of a negative number")
        data = np.asarray([_math.factorial(int(v)) if int(v) < 21 else 0
                           for v in vals], dtype=np.int64)
        if (vals > 20).any():
            raise errors.SqlError("22003", "factorial out of BIGINT range")
        return _result(dt.BIGINT, data, cols)
    return FunctionResolution(dt.BIGINT, impl)


@register("log")
def _log(ts):
    if len(ts) == 1:
        return _REGISTRY["log10"](ts)
    def impl(cols, n):
        base = cols[0].data.astype(np.float64)
        x = cols[1].data.astype(np.float64)
        with np.errstate(all="ignore"):
            data = np.log(x) / np.log(base)
        return _result(dt.DOUBLE, data, cols)
    return FunctionResolution(dt.DOUBLE, impl)


@register("power")
@register("pow")
def _power(ts):
    def impl(cols, n):
        with np.errstate(all="ignore"):
            data = np.power(cols[0].data.astype(np.float64),
                            cols[1].data.astype(np.float64))
        return _result(dt.DOUBLE, data, cols)
    return FunctionResolution(dt.DOUBLE, impl)


@register("mod")
def _mod(ts):
    return _make_arith("%")(ts)


@register("div")
def _div(ts):
    """PG div(a, b): integer-truncating division (toward zero); 22012 on
    zero divisor.  Reference: server/connector/functions/math.cpp."""
    if len(ts) != 2 or not _all_numeric(ts):
        return None
    if ts[0].is_integer and ts[1].is_integer:
        return _make_arith("/")(ts)
    def impl(cols, n):
        b = cols[1].data.astype(np.float64)
        pn = propagate_nulls(cols)
        zero = b == 0
        live_zero = zero if pn is None else (zero & pn)
        if live_zero.any():
            raise errors.SqlError(errors.DIVISION_BY_ZERO,
                                  "division by zero")
        with np.errstate(all="ignore"):
            data = np.trunc(cols[0].data.astype(np.float64) /
                            np.where(zero, 1.0, b))
        return _result(dt.DOUBLE, data, cols)
    return FunctionResolution(dt.DOUBLE, impl)


# -- bitwise operators (parser-desugared: & | # << >> ~) -------------------

def _bitwise(np_fn):
    def resolver(ts):
        if len(ts) != 2 or not all(t.is_integer or t.id is dt.TypeId.NULL
                                   for t in ts):
            return None
        t = max(ts, key=lambda x: x.np_dtype.itemsize if x.is_integer
                else 0)
        if not t.is_integer:
            t = dt.INT
        def impl(cols, n):
            a = cols[0].data.astype(np.int64)
            b = cols[1].data.astype(np.int64)
            with np.errstate(all="ignore"):
                data = np_fn(a, b)
            return _result(t, data.astype(t.np_dtype), cols)
        return FunctionResolution(t, impl)
    return resolver


_REGISTRY["bitand"] = _bitwise(np.bitwise_and)
_REGISTRY["bitor"] = _bitwise(np.bitwise_or)
_REGISTRY["bitxor"] = _bitwise(np.bitwise_xor)
_REGISTRY["bitshiftleft"] = _bitwise(
    lambda a, b: np.left_shift(a, np.clip(b, 0, 63)))
_REGISTRY["bitshiftright"] = _bitwise(
    lambda a, b: np.right_shift(a, np.clip(b, 0, 63)))


@register("bitnot")
def _bitnot(ts):
    if len(ts) != 1 or not (ts[0].is_integer or ts[0].id is dt.TypeId.NULL):
        return None
    t = ts[0] if ts[0].is_integer else dt.INT
    def impl(cols, n):
        return _result(t, np.bitwise_not(
            cols[0].data.astype(np.int64)).astype(t.np_dtype), cols)
    return FunctionResolution(t, impl)


@register("gcd")
def _gcd(ts):
    if len(ts) != 2 or not _all_numeric(ts):
        return None
    def impl(cols, n):
        a = cols[0].data.astype(np.int64)
        b = cols[1].data.astype(np.int64)
        return _result(dt.BIGINT, np.gcd(a, b), cols)
    return FunctionResolution(dt.BIGINT, impl)


@register("lcm")
def _lcm(ts):
    if len(ts) != 2 or not _all_numeric(ts):
        return None
    def impl(cols, n):
        a = cols[0].data.astype(np.int64)
        b = cols[1].data.astype(np.int64)
        with np.errstate(all="ignore"):
            data = np.lcm(a, b)
        return _result(dt.BIGINT, data, cols)
    return FunctionResolution(dt.BIGINT, impl)


@register("width_bucket")
def _width_bucket(ts):
    if len(ts) != 4 or not _all_numeric(ts):
        return None
    def impl(cols, n):
        x = cols[0].data.astype(np.float64)
        lo = cols[1].data.astype(np.float64)
        hi = cols[2].data.astype(np.float64)
        cnt = cols[3].data.astype(np.int64)
        pn = propagate_nulls(cols)
        live = np.ones(n, dtype=bool) if pn is None else pn
        if ((cnt <= 0) & live).any():
            raise errors.SqlError("2201G",
                                  "count must be greater than zero")
        if ((lo == hi) & live).any():
            raise errors.SqlError("2201G",
                                  "lower bound cannot equal upper bound")
        with np.errstate(all="ignore"):
            frac = (x - lo) / np.where(hi == lo, 1.0, hi - lo)
            buck = np.floor(frac * cnt).astype(np.int64) + 1
        buck = np.clip(buck, 0, cnt + 1)
        # descending ranges mirror (PG: operand < bound counts from top)
        desc = hi < lo
        with np.errstate(all="ignore"):
            fd = (lo - x) / np.where(lo == hi, 1.0, lo - hi)
            bd = np.floor(fd * cnt).astype(np.int64) + 1
        buck = np.where(desc, np.clip(bd, 0, cnt + 1), buck)
        return _result(dt.INT, buck, cols)
    return FunctionResolution(dt.INT, impl)


@register("num_nulls")
def _num_nulls(ts):
    def impl(cols, n):
        counts = np.zeros(n, dtype=np.int32)
        for c in cols:
            if c.type.id is dt.TypeId.NULL:
                counts += 1
            elif c.validity is not None:
                counts += (~c.valid_mask()).astype(np.int32)
        return Column(dt.INT, counts)
    return FunctionResolution(dt.INT, impl)


@register("num_nonnulls")
def _num_nonnulls(ts):
    def impl(cols, n):
        counts = np.zeros(n, dtype=np.int32)
        for c in cols:
            if c.type.id is dt.TypeId.NULL:
                continue
            if c.validity is not None:
                counts += c.valid_mask().astype(np.int32)
            else:
                counts += 1
        return Column(dt.INT, counts)
    return FunctionResolution(dt.INT, impl)


@register("sign")
def _sign(ts):
    def impl(cols, n):
        return _result(dt.DOUBLE, np.sign(cols[0].data.astype(np.float64)), cols)
    return FunctionResolution(dt.DOUBLE, impl)


@register("pi")
def _pi(ts):
    def impl(cols, n):
        return Column(dt.DOUBLE, np.full(n, math.pi))
    return FunctionResolution(dt.DOUBLE, impl)


# -- string functions ------------------------------------------------------

def _str_fn(result_type):
    def deco(fn):
        def resolver(ts):
            def impl(cols, n):
                return fn(cols, n)
            return FunctionResolution(result_type, impl)
        return resolver
    return deco


@register("upper")
def _upper(ts):
    def impl(cols, n):
        return make_string_column(np.char.upper(string_values(cols[0])),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("lower")
def _lower(ts):
    def impl(cols, n):
        return make_string_column(np.char.lower(string_values(cols[0])),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("length")
@register("char_length")
def _length(ts):
    def impl(cols, n):
        data = np.char.str_len(string_values(cols[0])).astype(np.int64)
        return _result(dt.BIGINT, data, cols)
    return FunctionResolution(dt.BIGINT, impl)


@register("substr")
@register("substring")
def _substr(ts):
    if len(ts) == 2 and ts[1].is_string:
        # substring(str FROM 'regex'): first regex match, NULL if none;
        # with a capture group, the group (PG semantics)
        def impl_rx(cols, n):
            s = string_values(cols[0])
            pats = string_values(cols[1])
            out = np.empty(n, dtype=object)
            miss = np.zeros(n, dtype=bool)
            for i in range(n):
                try:
                    m = re.search(pats[i], s[i])
                except re.error as e:
                    raise errors.SqlError(
                        "2201B", f"invalid regular expression: {e}")
                if m is None:
                    out[i] = ""
                    miss[i] = True
                else:
                    out[i] = m.group(1) if m.groups() else m.group(0)
                    if out[i] is None:
                        out[i] = ""
                        miss[i] = True
            validity = propagate_nulls(cols)
            if miss.any():
                validity = (validity if validity is not None
                            else np.ones(n, dtype=bool)) & ~miss
            return make_string_column(out.astype(str), validity)
        return FunctionResolution(dt.VARCHAR, impl_rx)
    def impl(cols, n):
        s = string_values(cols[0])
        start = cols[1].data.astype(np.int64)
        ln = cols[2].data.astype(np.int64) if len(cols) > 2 else None
        out = np.empty(len(s), dtype=object)
        for i in range(len(s)):
            st = start[i] - 1  # PG 1-based
            end = None if ln is None else max(st + ln[i], 0) if st >= 0 else max(start[i] - 1 + ln[i], 0)
            if st < 0:
                st2 = 0
                end = None if ln is None else max(start[i] - 1 + ln[i], 0)
            else:
                st2 = st
            out[i] = s[i][st2:end]
        return make_string_column(out.astype(str), propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("replace")
def _replace(ts):
    def impl(cols, n):
        s, old, new = (string_values(c) for c in cols)
        out = np.asarray([a.replace(b, c) for a, b, c in zip(s, old, new)],
                         dtype=object)
        return make_string_column(out.astype(str), propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


def _make_trim(which):
    def resolver(ts):
        def impl(cols, n):
            s = string_values(cols[0])
            chars = None
            if len(cols) > 1:
                chars = string_values(cols[1])
            out = []
            for i, v in enumerate(s):
                ch = None if chars is None else chars[i]
                if which == "both":
                    out.append(v.strip(ch))
                elif which == "left":
                    out.append(v.lstrip(ch))
                else:
                    out.append(v.rstrip(ch))
            return make_string_column(np.asarray(out, dtype=object).astype(str),
                                      propagate_nulls(cols))
        return FunctionResolution(dt.VARCHAR, impl)
    return resolver


_REGISTRY["trim"] = _make_trim("both")
_REGISTRY["btrim"] = _make_trim("both")
_REGISTRY["ltrim"] = _make_trim("left")
_REGISTRY["rtrim"] = _make_trim("right")


@register("starts_with")
def _starts_with(ts):
    def impl(cols, n):
        a, b = string_values(cols[0]), string_values(cols[1])
        data = np.asarray([x.startswith(y) for x, y in zip(a, b)])
        return _result(dt.BOOL, data, cols)
    return FunctionResolution(dt.BOOL, impl)


@register("contains")
def _contains(ts):
    def impl(cols, n):
        a, b = string_values(cols[0]), string_values(cols[1])
        data = np.asarray([y in x for x, y in zip(a, b)])
        return _result(dt.BOOL, data, cols)
    return FunctionResolution(dt.BOOL, impl)


@register("strpos")
@register("position")
def _strpos(ts):
    def impl(cols, n):
        a, b = string_values(cols[0]), string_values(cols[1])
        data = np.asarray([x.find(y) + 1 for x, y in zip(a, b)], dtype=np.int64)
        return _result(dt.BIGINT, data, cols)
    return FunctionResolution(dt.BIGINT, impl)


def _pad_impl(ts, left_side: bool):
    if len(ts) not in (2, 3):
        return None

    def impl(cols, n):
        s = string_values(cols[0])
        k = cols[1].data.astype(np.int64)
        fill = string_values(cols[2]) if len(cols) > 2 else [" "] * n
        out = []
        for v, kk, f in zip(s, k, fill):
            kk = int(kk)
            if kk <= len(v):
                out.append(v[:max(kk, 0)])
            elif not f:
                out.append(v)
            else:
                pad = (f * ((kk - len(v)) // len(f) + 1))[:kk - len(v)]
                out.append(pad + v if left_side else v + pad)
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


_REGISTRY["lpad"] = lambda ts: _pad_impl(ts, left_side=True)
_REGISTRY["rpad"] = lambda ts: _pad_impl(ts, left_side=False)


@register("initcap")
def _initcap(ts):
    def impl(cols, n):
        s = string_values(cols[0])
        out = [v.title() for v in s]
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("ascii")
def _ascii(ts):
    def impl(cols, n):
        s = string_values(cols[0])
        data = np.asarray([ord(v[0]) if v else 0 for v in s],
                          dtype=np.int32)
        return _result(dt.INT, data, cols)
    return FunctionResolution(dt.INT, impl)


@register("chr")
def _chr(ts):
    def impl(cols, n):
        k = cols[0].data.astype(np.int64)
        valid = cols[0].valid_mask() \
            if cols[0].validity is not None else None
        bad = (k <= 0) | (k > 0x10FFFF)
        if valid is not None:
            bad &= valid
        if bad.any():
            raise errors.SqlError(
                "54000", "character number must be between 1 and 1114111")
        out = [chr(int(v)) if 0 < v <= 0x10FFFF else "" for v in k]
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("md5")
def _md5(ts):
    def impl(cols, n):
        import hashlib
        s = string_values(cols[0])
        out = [hashlib.md5(v.encode()).hexdigest() for v in s]
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("octet_length")
def _octet_length(ts):
    def impl(cols, n):
        s = string_values(cols[0])
        out = np.asarray([len(v.encode()) for v in s], dtype=np.int32)
        return _result(dt.INT, out, cols)
    return FunctionResolution(dt.INT, impl)


@register("bit_length")
def _bit_length(ts):
    def impl(cols, n):
        s = string_values(cols[0])
        out = np.asarray([8 * len(v.encode()) for v in s], dtype=np.int32)
        return _result(dt.INT, out, cols)
    return FunctionResolution(dt.INT, impl)


@register("overlay")
def _overlay(ts):
    """overlay(str, repl, start[, count]) — 1-based; count defaults to
    the replacement length (PG)."""
    if len(ts) not in (3, 4):
        return None

    def impl(cols, n):
        sv = string_values(cols[0])
        rv = string_values(cols[1])
        starts = cols[2].data.astype(np.int64)
        counts = cols[3].data.astype(np.int64) if len(cols) > 3 else None
        out = []
        for i in range(n):
            s0, r0 = str(sv[i]), str(rv[i])
            st = max(int(starts[i]), 1)
            cnt = int(counts[i]) if counts is not None else len(r0)
            out.append(s0[: st - 1] + r0 + s0[st - 1 + max(cnt, 0):])
        return make_string_column(np.asarray(out, dtype=object),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("encode")
def _encode(ts):
    """encode(text, format): base64 / hex / escape over the UTF-8 bytes
    (PG encode over bytea; text input is its byte form here)."""
    if len(ts) != 2:
        return None

    def impl(cols, n):
        import base64 as _b64
        data = string_values(cols[0])
        fmts = string_values(cols[1])
        out = []
        for i in range(n):
            raw = str(data[i]).encode("utf-8")
            f = str(fmts[i]).lower()
            if f == "base64":
                out.append(_b64.b64encode(raw).decode())
            elif f == "hex":
                out.append(raw.hex())
            elif f == "escape":
                out.append("".join(
                    chr(b) if 32 <= b < 127 and b != 92
                    else f"\\{b:03o}" for b in raw))
            else:
                raise errors.SqlError(
                    "22023", f"unrecognized encoding: {f!r}")
        return make_string_column(np.asarray(out, dtype=object),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("decode")
def _decode(ts):
    if len(ts) != 2:
        return None

    def impl(cols, n):
        import base64 as _b64
        data = string_values(cols[0])
        fmts = string_values(cols[1])
        out = []
        for i in range(n):
            f = str(fmts[i]).lower()
            s0 = str(data[i])
            try:
                if f == "base64":
                    raw = _b64.b64decode(s0, validate=True)
                elif f == "hex":
                    raw = bytes.fromhex(s0)
                else:
                    raise errors.SqlError(
                        "22023", f"unrecognized encoding: {f!r}")
            except (ValueError, Exception) as e:
                if isinstance(e, errors.SqlError):
                    raise
                raise errors.SqlError("22023",
                                      f"invalid {f} input: {s0!r}")
            out.append(raw.decode("utf-8", errors="replace"))
        return make_string_column(np.asarray(out, dtype=object),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("to_hex")
def _to_hex(ts):
    if len(ts) != 1 or not (ts[0].is_integer or ts[0].id is dt.TypeId.NULL):
        return None
    def impl(cols, n):
        k = cols[0].data.astype(np.int64)
        # PG prints the two's-complement hex of the 32/64-bit value
        width = 32 if ts[0].np_dtype.itemsize <= 4 else 64
        out = [format(int(v) & ((1 << width) - 1), "x") for v in k]
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("format")
def _format(ts):
    if not ts:
        return None
    def impl(cols, n):
        fmt = string_values(cols[0])
        args = cols[1:]
        arg_valid = [c.valid_mask() if c.validity is not None else None
                     for c in args]
        arg_text = [[_pg_text(v) for v in c.to_pylist()] for c in args]
        out = []
        for row in range(n):
            s, pos, res = fmt[row], 0, []
            k = 0
            while k < len(s):
                ch = s[k]
                if ch != "%":
                    res.append(ch)
                    k += 1
                    continue
                if k + 1 >= len(s):
                    raise errors.SqlError(
                        "22023", "unterminated format() type specifier")
                spec = s[k + 1]
                k += 2
                if spec == "%":
                    res.append("%")
                    continue
                if spec not in ("s", "I", "L"):
                    raise errors.SqlError(
                        "22023",
                        f'unrecognized format() type specifier "{spec}"')
                if pos >= len(args):
                    raise errors.SqlError(
                        "22023", "too few arguments for format()")
                is_null = (arg_valid[pos] is not None
                           and not arg_valid[pos][row]) or \
                    args[pos].type.id is dt.TypeId.NULL
                v = None if is_null else arg_text[pos][row]
                pos += 1
                if spec == "s":
                    res.append("" if v is None else v)
                elif spec == "I":
                    if v is None:
                        raise errors.SqlError(
                            "22004",
                            "null values cannot be formatted as an "
                            "SQL identifier")
                    res.append(v if v.isidentifier() and v == v.lower()
                               else '"' + v.replace('"', '""') + '"')
                else:   # %L
                    res.append("NULL" if v is None
                               else "'" + v.replace("'", "''") + "'")
            out.append("".join(res))
        validity = (cols[0].valid_mask()
                    if cols[0].validity is not None else None)
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  validity)
    return FunctionResolution(dt.VARCHAR, impl)


@register("__similar_to")
def _similar_to(ts):
    """SQL SIMILAR TO: SQL wildcards (% _) + regex branches, anchored
    full-match (reference analog: similar_to_escape in PG's regexp.c)."""
    def impl(cols, n):
        pats = string_values(cols[1])
        s = string_values(cols[0])
        out = np.zeros(n, dtype=bool)
        cache = {}
        for i in range(n):
            p = pats[i]
            rx = cache.get(p)
            if rx is None:
                buf = []
                k = 0
                while k < len(p):
                    c = p[k]
                    if c == "%":
                        buf.append(".*")
                    elif c == "_":
                        buf.append(".")
                    elif c == "\\" and k + 1 < len(p):
                        buf.append(re.escape(p[k + 1]))
                        k += 1
                    elif c in ".^$":
                        buf.append(re.escape(c))
                    else:
                        buf.append(c)   # | * + ? { } ( ) [ ] stay regex
                    k += 1
                try:
                    rx = cache[p] = re.compile("(?s)\\A(?:%s)\\Z"
                                               % "".join(buf))
                except re.error as e:
                    raise errors.SqlError(
                        "2201B", f"invalid SIMILAR TO pattern: {e}")
            out[i] = rx.match(s[i]) is not None
        return _result(dt.BOOL, out, cols)
    return FunctionResolution(dt.BOOL, impl)


#: TypeId → pg_typeof() rendering (PG spellings)
_PG_TYPE_NAMES = {
    dt.TypeId.BOOL: "boolean", dt.TypeId.TINYINT: "smallint",
    dt.TypeId.SMALLINT: "smallint", dt.TypeId.INT: "integer",
    dt.TypeId.BIGINT: "bigint", dt.TypeId.FLOAT: "real",
    dt.TypeId.DOUBLE: "double precision", dt.TypeId.VARCHAR: "text",
    dt.TypeId.TIMESTAMP: "timestamp without time zone",
    dt.TypeId.DATE: "date", dt.TypeId.INTERVAL: "interval",
    dt.TypeId.NULL: "unknown", dt.TypeId.OID: "oid",
    dt.TypeId.REGCLASS: "regclass", dt.TypeId.REGTYPE: "regtype",
    dt.TypeId.REGPROC: "regproc", dt.TypeId.REGNAMESPACE: "regnamespace",
}


@register("to_date")
def _to_date(ts):
    if len(ts) != 2:
        return None
    def impl(cols, n):
        from datetime import date as _date
        s = string_values(cols[0])
        fmts = string_values(cols[1])
        epoch = _date(1970, 1, 1)
        out = np.zeros(n, dtype=np.int32)
        import datetime as _dt_mod
        # longest patterns first: "Month" must map before "Mon", "YYYY"
        # before "YY"
        py_map = [("Month", "%B"), ("HH24", "%H"), ("YYYY", "%Y"),
                  ("Mon", "%b"), ("MM", "%m"), ("DD", "%d"),
                  ("MI", "%M"), ("SS", "%S"), ("YY", "%y")]
        for i in range(n):
            f = fmts[i]
            for pat, py in py_map:
                f = f.replace(pat, py)
            try:
                d = _dt_mod.datetime.strptime(s[i], f).date()
            except ValueError as e:
                raise errors.SqlError("22008",
                                      f"invalid value for to_date: {e}")
            out[i] = (d - epoch).days
        return _result(dt.DATE, out, cols)
    return FunctionResolution(dt.DATE, impl)


@register("make_interval")
def _make_interval(ts):
    """make_interval(years, months, weeks, days, hours, mins, secs) —
    positional prefix; calendar units must be zero (this engine's
    intervals are fixed-duration micros, binder.parse_interval)."""
    if len(ts) > 7 or not _all_numeric(ts):
        return None
    def impl(cols, n):
        vals = [c.data.astype(np.float64) for c in cols]
        while len(vals) < 7:
            vals.append(np.zeros(n))
        years, months, weeks, days, hours, mins, secs = vals
        pn = propagate_nulls(cols)
        live = np.ones(n, dtype=bool) if pn is None else pn
        if (((years != 0) | (months != 0)) & live).any():
            raise errors.unsupported(
                "calendar interval units (month/year) — use fixed units "
                "(days/hours/...)")
        us = ((weeks * 7 + days) * 86_400_000_000 +
              hours * 3_600_000_000 + mins * 60_000_000 +
              secs * 1_000_000)
        return _result(dt.INTERVAL, np.round(us).astype(np.int64), cols)
    return FunctionResolution(dt.INTERVAL, impl)


@register("isfinite")
def _isfinite(ts):
    if len(ts) != 1 or ts[0].id not in (dt.TypeId.DATE, dt.TypeId.TIMESTAMP,
                                        dt.TypeId.INTERVAL):
        return None
    def impl(cols, n):
        # epoch-int storage has no infinity encoding: always finite
        return _result(dt.BOOL, np.ones(n, dtype=bool), cols)
    return FunctionResolution(dt.BOOL, impl)


@register("pg_typeof")
def _pg_typeof(ts):
    if len(ts) != 1:
        return None
    name = _PG_TYPE_NAMES.get(ts[0].id, str(ts[0]).lower())
    def impl(cols, n):
        return make_string_column(
            np.asarray([name] * n, dtype=object).astype(str), None)
    # rendered as text (PG's regtype output is its textual type name)
    return FunctionResolution(dt.VARCHAR, impl)


@register("translate")
def _translate(ts):
    def impl(cols, n):
        s = string_values(cols[0])
        frm = string_values(cols[1])
        to = string_values(cols[2])
        out = []
        for v, f, t in zip(s, frm, to):
            # chars beyond len(to) are deleted (PG semantics)
            table = {ord(c): (t[i] if i < len(t) else None)
                     for i, c in enumerate(f)}
            out.append(v.translate(table))
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("left")
def _left(ts):
    def impl(cols, n):
        s = string_values(cols[0])
        k = cols[1].data.astype(np.int64)
        out = [v[:kk] if kk >= 0 else v[:len(v) + kk] for v, kk in zip(s, k)]
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("right")
def _right(ts):
    def impl(cols, n):
        s = string_values(cols[0])
        k = cols[1].data.astype(np.int64)
        out = [(v[-kk:] if kk > 0 else v[-(len(v) + kk):] if len(v) + kk > 0 else "")
               if kk != 0 else "" for v, kk in zip(s, k)]
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("reverse")
def _reverse(ts):
    def impl(cols, n):
        s = string_values(cols[0])
        out = [v[::-1] for v in s]
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("repeat")
def _repeat(ts):
    def impl(cols, n):
        s = string_values(cols[0])
        k = cols[1].data.astype(np.int64)
        out = [v * max(int(kk), 0) for v, kk in zip(s, k)]
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("split_part")
def _split_part(ts):
    def impl(cols, n):
        s = string_values(cols[0])
        sep = string_values(cols[1])
        k = cols[2].data.astype(np.int64)
        out = []
        for v, sp, kk in zip(s, sep, k):
            parts = v.split(sp) if sp else [v]
            idx = int(kk) - 1
            out.append(parts[idx] if 0 <= idx < len(parts) else "")
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


def _like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def like_impl(cols, n, negated=False, ci=False):
    a = string_values(cols[0])
    pats = string_values(cols[1])
    flags = re.IGNORECASE | re.DOTALL if ci else re.DOTALL
    if len(set(pats.tolist())) == 1 and len(pats) > 0:
        rx = re.compile(_like_to_regex(pats[0]), flags)
        data = np.asarray([bool(rx.match(x)) for x in a])
    else:
        data = np.asarray([bool(re.compile(_like_to_regex(p), flags).match(x))
                           for x, p in zip(a, pats)])
    if negated:
        data = ~data
    return _result(dt.BOOL, data, cols)


# (the former backtracking-`re` regexp_match_op path was removed: all
# regex operators now route through the linear-time NFA above)


def _pg_regex_replacement(r: str) -> str:
    """PG replacement syntax → Python re: \\1..\\9 group refs, \\& whole
    match, literal backslash pairs."""
    out = []
    k = 0
    while k < len(r):
        c = r[k]
        if c == "\\" and k + 1 < len(r):
            nxt = r[k + 1]
            if nxt.isdigit():
                out.append("\\" + nxt)
            elif nxt == "&":
                out.append("\\g<0>")
            elif nxt == "\\":
                out.append("\\\\")
            else:
                out.append(re.escape(nxt))
            k += 2
            continue
        out.append(c.replace("\\", "\\\\"))
        k += 1
    return "".join(out)


@register("regexp_replace")
def _regexp_replace(ts):
    if len(ts) not in (3, 4):
        return None
    def impl(cols, n):
        s = string_values(cols[0])
        pat = string_values(cols[1])
        rep = string_values(cols[2])
        flags = string_values(cols[3]) if len(cols) > 3 else None
        out = []
        for i in range(n):
            fl = 0
            count = 1
            if flags is not None:
                for f in flags[i]:
                    if f == "g":
                        count = 0
                    elif f == "i":
                        fl |= re.IGNORECASE
                    elif f == "n" or f == "m":
                        fl |= re.MULTILINE
                    elif f == "s":
                        fl |= re.DOTALL
                    else:
                        raise errors.SqlError(
                            "22023",
                            f'invalid regular expression option: "{f}"')
            try:
                out.append(re.sub(pat[i], _pg_regex_replacement(rep[i]),
                                  s[i], count=count, flags=fl))
            except re.error as e:
                raise errors.SqlError("2201B",
                                      f"invalid regular expression: {e}")
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


@register("regexp_matches")
@register("regexp_match")
def _regexp_match(ts):
    """First-match capture groups (regexp_match); without groups, the
    whole match. Returns NULL on no match (array rendered PG-style)."""
    if len(ts) not in (2, 3):
        return None
    def impl(cols, n):
        s = string_values(cols[0])
        pat = string_values(cols[1])
        flags = string_values(cols[2]) if len(cols) > 2 else None
        out = []
        miss = np.zeros(n, dtype=bool)
        for i in range(n):
            fl = re.IGNORECASE if flags is not None and "i" in flags[i] \
                else 0
            m = re.search(pat[i], s[i], flags=fl)
            if m is None:
                out.append("")
                miss[i] = True
            elif m.groups():
                out.append("{" + ",".join(
                    "NULL" if g is None else g for g in m.groups()) + "}")
            else:
                out.append("{" + m.group(0) + "}")
        validity = propagate_nulls(cols)
        if miss.any():
            validity = (validity if validity is not None
                        else np.ones(n, dtype=bool)) & ~miss
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  validity)
    return FunctionResolution(dt.VARCHAR, impl)


@register("regexp_split_to_array")
def _regexp_split_to_array(ts):
    """regexp_split_to_array(text, pattern[, flags]) → text array
    (physical JSON, rendered PG-style)."""
    if len(ts) not in (2, 3):
        return None

    def impl(cols, n):
        s = string_values(cols[0])
        pat = string_values(cols[1])
        flags = string_values(cols[2]) if len(cols) > 2 else None
        out = []
        for i in range(n):
            fl = re.IGNORECASE if flags is not None and "i" in flags[i] \
                else 0
            try:
                out.append(json.dumps(re.split(pat[i], s[i], flags=fl)))
            except re.error as e:
                raise errors.SqlError(
                    "2201B", f"invalid regular expression: {e}")
        col = make_string_column(
            np.asarray(out, dtype=object).astype(str),
            propagate_nulls(cols))
        return Column(dt.array_of(dt.VARCHAR), col.data, col.validity,
                      col.dictionary)
    return FunctionResolution(dt.array_of(dt.VARCHAR), impl)


# -- conditionals ----------------------------------------------------------

@register("coalesce")
def _coalesce(ts):
    t = next((x for x in ts if x.id is not dt.TypeId.NULL), dt.NULLTYPE)
    def impl(cols, n):
        vals = [c.to_pylist() for c in cols]
        out = []
        for i in range(n):
            v = None
            for col_vals in vals:
                if col_vals[i] is not None:
                    v = col_vals[i]
                    break
            out.append(v)
        return Column.from_pylist(out, t)
    return FunctionResolution(t, impl)


@register("nullif")
def _nullif(ts):
    t = ts[0]
    def impl(cols, n):
        a, b = cols
        if a.type.is_string or b.type.is_string:
            eq = string_values(a) == string_values(b)
        else:
            eq = a.data == b.data
        both_valid = a.valid_mask() & b.valid_mask()
        make_null = both_valid & eq
        validity = a.valid_mask() & ~make_null
        return Column(t, a.data, None if validity.all() else validity,
                      a.dictionary)
    return FunctionResolution(t, impl)


def _make_extreme(is_greatest):
    def resolver(ts):
        t = ts[0]
        for x in ts[1:]:
            if x.is_numeric and t.is_numeric:
                t = dt.common_numeric(t, x)
        def impl(cols, n):
            # NULLs are ignored (PG GREATEST/LEAST semantics)
            vals = [c.to_pylist() for c in cols]
            out = []
            for i in range(n):
                cand = [v[i] for v in vals if v[i] is not None]
                out.append((max(cand) if is_greatest else min(cand)) if cand else None)
            return Column.from_pylist(out, t)
        return FunctionResolution(t, impl)
    return resolver


_REGISTRY["greatest"] = _make_extreme(True)
_REGISTRY["least"] = _make_extreme(False)


# -- date/time -------------------------------------------------------------

_EXTRACT_FIELDS = {"year", "month", "day", "hour", "minute", "second", "dow",
                   "isodow", "doy", "epoch", "quarter", "week", "century",
                   "millennium", "millisecond", "milliseconds",
                   "microsecond", "microseconds"}


@register("extract")
@register("date_part")
def _extract(ts):
    def impl(cols, n):
        field = string_values(cols[0])[0] if n else "year"
        if cols[1].type.id is dt.TypeId.INTERVAL:
            # duration fields over µs (normalized: hour < 24 etc.; our
            # intervals are fixed-duration, unlike PG's month/day split)
            us = cols[1].data.astype(np.int64)
            sign = np.sign(us)
            a = np.abs(us)
            if field == "epoch":
                data = us / 1e6
            elif field == "day":
                data = sign * (a // 86_400_000_000).astype(np.float64)
            elif field == "hour":
                data = sign * ((a // 3_600_000_000) % 24).astype(np.float64)
            elif field == "minute":
                data = sign * ((a // 60_000_000) % 60).astype(np.float64)
            elif field == "second":
                data = sign * ((a % 60_000_000) / 1e6)
            elif field in ("millisecond", "milliseconds"):
                data = sign * ((a % 60_000_000) / 1e3)
            elif field in ("microsecond", "microseconds"):
                data = sign * (a % 60_000_000).astype(np.float64)
            else:
                raise errors.unsupported(
                    f"extract field {field!r} from interval")
            return _result(dt.DOUBLE, data, cols[1:])
        micros = cols[1].data.astype("datetime64[us]") \
            if cols[1].type.id is dt.TypeId.TIMESTAMP \
            else cols[1].data.astype("datetime64[D]").astype("datetime64[us]")
        dts = micros
        Y = dts.astype("datetime64[Y]").astype(np.int64) + 1970
        if field == "year":
            data = Y.astype(np.float64)
        elif field == "month":
            data = (dts.astype("datetime64[M]").astype(np.int64) % 12 + 1).astype(np.float64)
        elif field == "day":
            data = ((dts.astype("datetime64[D]") -
                     dts.astype("datetime64[M]").astype("datetime64[D]"))
                    .astype(np.int64) + 1).astype(np.float64)
        elif field == "hour":
            data = ((dts.astype(np.int64) // 3_600_000_000) % 24).astype(np.float64)
        elif field == "minute":
            data = ((dts.astype(np.int64) // 60_000_000) % 60).astype(np.float64)
        elif field == "second":
            data = ((dts.astype(np.int64) % 60_000_000) / 1e6)
        elif field == "epoch":
            data = dts.astype(np.int64) / 1e6
        elif field == "dow":
            data = ((dts.astype("datetime64[D]").astype(np.int64) + 4) % 7).astype(np.float64)
        elif field == "isodow":
            # PG: Monday=1 … Sunday=7
            data = ((dts.astype("datetime64[D]").astype(np.int64) + 3) % 7
                    + 1).astype(np.float64)
        elif field == "doy":
            data = ((dts.astype("datetime64[D]") -
                     dts.astype("datetime64[Y]").astype("datetime64[D]"))
                    .astype(np.int64) + 1).astype(np.float64)
        elif field == "week":
            # ISO 8601 week number: the week containing the year's first
            # Thursday is week 1
            days = dts.astype("datetime64[D]").astype(np.int64)
            # Thursday of each date's ISO week (Mon-based week start)
            thu = days - (days + 3) % 7 + 3
            thu_d = thu.astype("datetime64[D]")
            year_start = thu_d.astype("datetime64[Y]").astype("datetime64[D]")
            data = ((thu - year_start.astype(np.int64)) // 7
                    + 1).astype(np.float64)
        elif field == "quarter":
            m = dts.astype("datetime64[M]").astype(np.int64) % 12
            data = (m // 3 + 1).astype(np.float64)
        elif field == "century":
            data = np.ceil(Y / 100.0)
        elif field == "millennium":
            data = np.ceil(Y / 1000.0)
        elif field in ("millisecond", "milliseconds"):
            data = (dts.astype(np.int64) % 60_000_000) / 1e3
        elif field in ("microsecond", "microseconds"):
            data = (dts.astype(np.int64) % 60_000_000).astype(np.float64)
        else:
            raise errors.unsupported(f"extract field {field!r}")
        return _result(dt.DOUBLE, data, cols[1:])
    return FunctionResolution(dt.DOUBLE, impl)


_MONTHS = ["January", "February", "March", "April", "May", "June", "July",
           "August", "September", "October", "November", "December"]
_DAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
         "Saturday", "Sunday"]

#: to_char template patterns, longest-first (reference: PG formatting.c)
_TO_CHAR_PATS = [
    ("HH24", lambda d: f"{d.hour:02d}"),
    ("HH12", lambda d: f"{(d.hour % 12) or 12:02d}"),
    ("YYYY", lambda d: f"{d.year:04d}"),
    ("MONTH", lambda d: _MONTHS[d.month - 1].upper().ljust(9)),
    ("Month", lambda d: _MONTHS[d.month - 1].ljust(9)),
    ("month", lambda d: _MONTHS[d.month - 1].lower().ljust(9)),
    ("DDD", lambda d: f"{d.timetuple().tm_yday:03d}"),
    ("DAY", lambda d: _DAYS[d.weekday()].upper().ljust(9)),
    ("Day", lambda d: _DAYS[d.weekday()].ljust(9)),
    ("day", lambda d: _DAYS[d.weekday()].lower().ljust(9)),
    ("MON", lambda d: _MONTHS[d.month - 1][:3].upper()),
    ("Mon", lambda d: _MONTHS[d.month - 1][:3]),
    ("mon", lambda d: _MONTHS[d.month - 1][:3].lower()),
    ("DY", lambda d: _DAYS[d.weekday()][:3].upper()),
    ("Dy", lambda d: _DAYS[d.weekday()][:3]),
    ("dy", lambda d: _DAYS[d.weekday()][:3].lower()),
    ("MS", lambda d: f"{d.microsecond // 1000:03d}"),
    ("US", lambda d: f"{d.microsecond:06d}"),
    ("HH", lambda d: f"{(d.hour % 12) or 12:02d}"),
    ("MM", lambda d: f"{d.month:02d}"),
    ("DD", lambda d: f"{d.day:02d}"),
    ("MI", lambda d: f"{d.minute:02d}"),
    ("SS", lambda d: f"{d.second:02d}"),
    ("YY", lambda d: f"{d.year % 100:02d}"),
    ("AM", lambda d: "AM" if d.hour < 12 else "PM"),
    ("PM", lambda d: "AM" if d.hour < 12 else "PM"),
    ("am", lambda d: "am" if d.hour < 12 else "pm"),
    ("pm", lambda d: "am" if d.hour < 12 else "pm"),
    ("Q", lambda d: str((d.month - 1) // 3 + 1)),
]


def _to_char_one(dtv, fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == '"':                 # quoted literal section
            j = fmt.find('"', i + 1)
            if j < 0:
                out.append(fmt[i + 1:])
                break
            out.append(fmt[i + 1:j])
            i = j + 1
            continue
        for pat, fn in _TO_CHAR_PATS:
            if fmt.startswith(pat, i):
                out.append(fn(dtv))
                i += len(pat)
                break
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


@register("to_char")
def _to_char(ts):
    if len(ts) != 2:
        return None
    src = ts[0]

    def impl(cols, n):
        import datetime as _dtmod
        fmts = string_values(cols[1])
        valid = propagate_nulls(cols)
        out = []
        for i in range(n):
            if valid is not None and not valid[i]:
                out.append("")
                continue
            v = cols[0].data[i]
            if src.id is dt.TypeId.DATE:
                d = _dtmod.datetime(1970, 1, 1) + \
                    _dtmod.timedelta(days=int(v))
            elif src.id is dt.TypeId.TIMESTAMP:
                d = _dtmod.datetime(1970, 1, 1) + \
                    _dtmod.timedelta(microseconds=int(v))
            else:
                # numeric to_char: render the value through the literal
                # text of the format's 9/0 slots is overkill — print it
                out.append(str(cols[0].decode(i)))
                continue
            out.append(_to_char_one(d, fmts[i]))
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  valid)
    return FunctionResolution(dt.VARCHAR, impl)


@register("to_timestamp")
def _to_timestamp(ts):
    def impl(cols, n):
        secs = cols[0].data.astype(np.float64)
        return _result(dt.TIMESTAMP, (secs * 1e6).astype(np.int64), cols)
    return FunctionResolution(dt.TIMESTAMP, impl)


# -- system ----------------------------------------------------------------

@register("version")
def _version(ts):
    def impl(cols, n):
        from .. import __version__
        v = f"PostgreSQL 16.0 (serenedb_tpu {__version__})"
        return Column.from_pylist([v] * max(n, 1), dt.VARCHAR)
    return FunctionResolution(dt.VARCHAR, impl)


@register("current_schema")
def _current_schema(ts):
    def impl(cols, n):
        return Column.from_pylist(["main"] * max(n, 1), dt.VARCHAR)
    return FunctionResolution(dt.VARCHAR, impl)


# -- vector functions (CPU oracle; reference: functions/vector.cpp) --------

def _make_vec_fn(metric):
    def resolver(ts):
        def impl(cols, n):
            # strict NULL propagation: never parse rows where either side is
            # NULL ('' placeholders would raise)
            from ..search.ivf import parse_vector
            a = string_values(cols[0])
            b = string_values(cols[1])
            valid = propagate_nulls(cols)
            out = np.zeros(n, dtype=np.float64)
            for i in range(n):
                if valid is not None and not valid[i]:
                    continue
                x = parse_vector(a[i])
                y = parse_vector(b[i])
                if len(x) != len(y):
                    raise errors.SqlError(
                        errors.DATATYPE_MISMATCH,
                        f"vector dims differ: {len(x)} vs {len(y)}")
                if metric == "l2":
                    d = x.astype(np.float64) - y.astype(np.float64)
                    out[i] = float(np.dot(d, d))
                elif metric == "ip":
                    out[i] = -float(np.dot(x.astype(np.float64),
                                           y.astype(np.float64)))
                else:
                    nx = np.linalg.norm(x)
                    ny = np.linalg.norm(y)
                    out[i] = 1.0 - float(np.dot(x, y)) / max(nx * ny, 1e-9)
            return _result(dt.DOUBLE, out, cols)
        return FunctionResolution(dt.DOUBLE, impl)
    return resolver


_REGISTRY["vec_l2"] = _make_vec_fn("l2")
_REGISTRY["vec_ip"] = _make_vec_fn("ip")
_REGISTRY["vec_cos"] = _make_vec_fn("cos")


@register("vec_maxsim")
def _vec_maxsim(ts):
    """ColBERT-style late interaction between two token matrices
    ('[[...], ...]'): Σ_s max_t <q_s, d_t>, float64 (the exact host
    oracle the device MaxSim program is checked against). A doc or
    query without tokens scores NULL."""
    def impl(cols, n):
        from ..search.ivf import parse_multi_vector
        a = string_values(cols[0])
        b = string_values(cols[1])
        valid = propagate_nulls(cols)
        out = np.zeros(n, dtype=np.float64)
        nulls = np.zeros(n, dtype=bool)
        for i in range(n):
            if valid is not None and not valid[i]:
                continue
            x = parse_multi_vector(a[i])
            y = parse_multi_vector(b[i])
            if x is None or y is None:
                nulls[i] = True
                continue
            if x.shape[1] != y.shape[1]:
                raise errors.SqlError(
                    errors.DATATYPE_MISMATCH,
                    f"vector dims differ: {x.shape[1]} vs {y.shape[1]}")
            sim = y.astype(np.float64) @ x.astype(np.float64).T
            out[i] = float(sim.max(axis=1).sum())
        return _result(dt.DOUBLE, out, cols, extra_invalid=nulls)
    return FunctionResolution(dt.DOUBLE, impl)


@register("vec_dims")
def _vec_dims(ts):
    def impl(cols, n):
        from ..search.ivf import parse_vector
        vals = string_values(cols[0])
        valid = propagate_nulls(cols)
        out = np.zeros(n, dtype=np.int64)
        for i in range(n):
            if valid is None or valid[i]:
                out[i] = len(parse_vector(vals[i]))
        return _result(dt.BIGINT, out, cols)
    return FunctionResolution(dt.BIGINT, impl)


# -- sequence functions (context-dependent; reference: functions/sequence.cpp)

def _current_conn():
    from ..engine import CURRENT_CONNECTION
    conn = CURRENT_CONNECTION.get()
    if conn is None:
        raise errors.SqlError("55000",
                              "sequence functions need a connection context")
    return conn


@register("nextval")
def _nextval(ts):
    def impl(cols, n):
        conn = _current_conn()
        names = string_values(cols[0])
        valid = propagate_nulls(cols)
        cur = dict(getattr(conn, "seq_currval", {}))
        out = np.zeros(n, dtype=np.int64)
        for i, nm in enumerate(names):
            if valid is not None and not valid[i]:
                continue  # NULL name → NULL result, no side effect
            out[i] = conn.db.sequence_nextval(nm)
            cur[nm] = int(out[i])
        conn.seq_currval = cur
        return _result(dt.BIGINT, out, cols)
    return FunctionResolution(dt.BIGINT, impl)


@register("currval")
def _currval(ts):
    def impl(cols, n):
        conn = _current_conn()
        names = string_values(cols[0])
        cur = getattr(conn, "seq_currval", {})
        out = np.zeros(n, dtype=np.int64)
        for i, nm in enumerate(names):
            if nm not in cur:
                raise errors.SqlError(
                    "55000", f'currval of sequence "{nm}" is not yet '
                             "defined in this session")
            out[i] = cur[nm]
        return _result(dt.BIGINT, out, cols)
    return FunctionResolution(dt.BIGINT, impl)


@register("setval")
def _setval(ts):
    def impl(cols, n):
        conn = _current_conn()
        names = string_values(cols[0])
        vals = cols[1].data.astype(np.int64)
        valid = propagate_nulls(cols)
        out = np.zeros(n, dtype=np.int64)
        for i, (nm, v) in enumerate(zip(names, vals)):
            if valid is not None and not valid[i]:
                continue
            out[i] = conn.db.sequence_setval(nm, int(v))
        return _result(dt.BIGINT, out, cols)
    return FunctionResolution(dt.BIGINT, impl)


# -- more datetime ---------------------------------------------------------

_TRUNC_UNITS = ("year", "quarter", "month", "week", "day", "hour", "minute",
                "second")


@register("date_trunc")
def _date_trunc(ts):
    if len(ts) == 2 and ts[1].id not in (dt.TypeId.TIMESTAMP, dt.TypeId.DATE,
                                         dt.TypeId.NULL):
        raise errors.SqlError(errors.DATATYPE_MISMATCH,
                              f"date_trunc does not accept {ts[1]}")

    def impl(cols, n):
        valid = propagate_nulls(cols)
        units = np.char.lower(string_values(cols[0])) if n else \
            np.empty(0, dtype=str)
        distinct_units = {units[i] for i in range(n)
                          if valid is None or valid[i]}
        bad = distinct_units - set(_TRUNC_UNITS)
        if bad:
            raise errors.unsupported(f"date_trunc unit {bad.pop()!r}")
        if len(distinct_units) > 1:
            # per-row units: compute per distinct unit and stitch
            out = np.zeros(n, dtype=np.int64)
            for u in distinct_units:
                mask = (units == u) & (valid if valid is not None
                                       else np.ones(n, dtype=bool))
                sub = impl([Column.const(u, int(mask.sum()), dt.VARCHAR),
                            cols[1].filter(mask)], int(mask.sum()))
                out[np.flatnonzero(mask)] = sub.data
            return Column(dt.TIMESTAMP, out,
                          valid if valid is not None and not valid.all()
                          else valid)
        unit = distinct_units.pop() if distinct_units else "day"
        src = cols[1]
        if src.type.id is dt.TypeId.DATE:
            us = src.data.astype("datetime64[D]").astype("datetime64[us]")
        else:
            us = src.data.astype("datetime64[us]")
        if unit == "year":
            out = us.astype("datetime64[Y]").astype("datetime64[us]")
        elif unit == "quarter":
            months = us.astype("datetime64[M]").astype(np.int64)
            out = ((months // 3) * 3).astype("datetime64[M]") \
                .astype("datetime64[us]")
        elif unit == "month":
            out = us.astype("datetime64[M]").astype("datetime64[us]")
        elif unit == "week":
            days = us.astype("datetime64[D]").astype(np.int64)
            # 1970-01-01 was a Thursday; ISO weeks start Monday (+3 offset)
            out = (((days + 3) // 7) * 7 - 3).astype("datetime64[D]") \
                .astype("datetime64[us]")
        elif unit == "day":
            out = us.astype("datetime64[D]").astype("datetime64[us]")
        elif unit == "hour":
            out = us.astype("datetime64[h]").astype("datetime64[us]")
        elif unit == "minute":
            out = us.astype("datetime64[m]").astype("datetime64[us]")
        else:
            out = us.astype("datetime64[s]").astype("datetime64[us]")
        return _result(dt.TIMESTAMP, out.astype(np.int64), cols)
    return FunctionResolution(dt.TIMESTAMP, impl)


def _now_resolver(ts):
    def impl(cols, n):
        import time as _time
        conn = _current_conn()
        v = getattr(conn, "stmt_now_us", None) if conn is not None \
            else None
        if v is None:    # outside a statement (tests, internal evals)
            v = int(_time.time() * 1e6)
        return Column(dt.TIMESTAMP, np.full(max(n, 1), v, dtype=np.int64))
    return FunctionResolution(dt.TIMESTAMP, impl)


def _clock_timestamp_resolver(ts):
    def impl(cols, n):
        import time as _time
        v = int(_time.time() * 1e6)
        return Column(dt.TIMESTAMP, np.full(max(n, 1), v, dtype=np.int64))
    return FunctionResolution(dt.TIMESTAMP, impl)


_REGISTRY["clock_timestamp"] = _clock_timestamp_resolver


_REGISTRY["now"] = _now_resolver
_REGISTRY["current_timestamp"] = _now_resolver
_REGISTRY["transaction_timestamp"] = _now_resolver


@register("current_date")
def _current_date(ts):
    def impl(cols, n):
        import time as _time
        v = int(_time.time() // 86400)
        return Column(dt.DATE, np.full(max(n, 1), v, dtype=np.int32))
    return FunctionResolution(dt.DATE, impl)


@register("age")
def _age(ts):
    """age(ts, ts) → INTERVAL (micros; PG renders day/time parts).
    age(ts) → midnight of current_date minus ts (PG 1-arg form)."""
    if len(ts) == 1:
        if ts[0].id not in (dt.TypeId.TIMESTAMP, dt.TypeId.DATE):
            return None
        arg_is_date = ts[0].id is dt.TypeId.DATE

        def impl1(cols, n, _date=arg_is_date):
            # statement-stable reference (like now()): every batch/morsel
            # of one statement sees the same "today's midnight"
            conn = _current_conn()
            now_us = getattr(conn, "stmt_now_us", None) \
                if conn is not None else None
            if now_us is None:
                import time as _time
                now_us = int(_time.time() * 1e6)
            midnight = (now_us // 86_400_000_000) * 86_400_000_000
            a = cols[0].data.astype(np.int64)
            if _date:          # DATE stores days-since-epoch, not micros
                a = a * 86_400_000_000
            return _result(dt.INTERVAL, midnight - a, cols)
        return FunctionResolution(dt.INTERVAL, impl1)
    if len(ts) != 2:
        return None   # clean 42883 undefined-function, not an IndexError

    def impl(cols, n):
        a = cols[0].data.astype(np.int64)
        b = cols[1].data.astype(np.int64)
        return _result(dt.INTERVAL, a - b, cols)
    return FunctionResolution(dt.INTERVAL, impl)


@register("atan2")
def _atan2(ts):
    if len(ts) != 2:
        return None

    def impl(cols, n):
        y = cols[0].data.astype(np.float64)
        x = cols[1].data.astype(np.float64)
        return _result(dt.DOUBLE, np.arctan2(y, x), cols)
    return FunctionResolution(dt.DOUBLE, impl)


@register("random")
def _random(ts):
    if ts:
        return None

    def impl(cols, n):
        rng = np.random.default_rng()
        return Column(dt.DOUBLE, rng.random(max(n, 1)))
    return FunctionResolution(dt.DOUBLE, impl)


@register("gen_random_uuid")
def _gen_random_uuid(ts):
    if ts:
        return None

    def impl(cols, n):
        import uuid as _uuid
        out = [str(_uuid.uuid4()) for _ in range(max(n, 1))]
        return make_string_column(np.asarray(out, dtype=object), None)
    return FunctionResolution(dt.VARCHAR, impl)


@register("array_remove")
def _array_remove(ts):
    if len(ts) != 2:
        return None

    def impl(cols, n):
        vals = cols[0].to_pylist()
        rem = cols[1].to_pylist()
        out = []
        for i in range(n):
            v = vals[i]
            if v is None:
                out.append(None)
                continue
            try:
                arr = json.loads(str(v))
            except json.JSONDecodeError:
                arr = None
            if not isinstance(arr, list):
                out.append(v)
                continue
            out.append(json.dumps([x for x in arr if x != rem[i]]))
        col = make_string_column(
            np.asarray(["" if v is None else v for v in out],
                       dtype=object),
            np.asarray([v is not None for v in out]))
        t = ts[0] if ts[0].id is dt.TypeId.ARRAY else dt.array_of(None)
        return Column(t, col.data, col.validity, col.dictionary)
    return FunctionResolution(
        ts[0] if ts[0].id is dt.TypeId.ARRAY else dt.array_of(None), impl)


@register("array_upper")
def _array_upper(ts):
    if len(ts) != 2:
        return None

    def impl(cols, n):
        vals = cols[0].to_pylist()
        dims = cols[1].to_pylist()
        out = np.zeros(n, dtype=np.int64)
        invalid = np.zeros(n, dtype=bool)
        for i in range(n):
            try:
                arr = json.loads(str(vals[i])) if vals[i] is not None \
                    else None
            except json.JSONDecodeError:
                arr = None
            # arrays here are 1-D: any dim other than 1 is NULL (PG)
            if dims[i] == 1 and isinstance(arr, list) and arr:
                out[i] = len(arr)
            else:
                invalid[i] = True
        return _result(dt.INT, out, cols, extra_invalid=invalid)
    return FunctionResolution(dt.INT, impl)


@register("make_date")
def _make_date(ts):
    def impl(cols, n):
        y = cols[0].data.astype(np.int64)
        m = cols[1].data.astype(np.int64)
        d = cols[2].data.astype(np.int64)
        valid = propagate_nulls(cols)
        out = np.zeros(n, dtype=np.int32)
        for i in range(n):
            if valid is not None and not valid[i]:
                continue  # NULL row: sentinel components never parsed
            try:
                out[i] = np.datetime64(
                    f"{y[i]:04d}-{m[i]:02d}-{d[i]:02d}", "D").astype(np.int32)
            except ValueError:
                raise errors.SqlError(
                    "22008", f"date field value out of range: "
                             f"{y[i]}-{m[i]}-{d[i]}")
        return _result(dt.DATE, out, cols)
    return FunctionResolution(dt.DATE, impl)


@register("make_timestamp")
def _make_timestamp(ts):
    if len(ts) != 6:
        return None

    def impl(cols, n):
        y, mo, d, h, mi = (cols[k].data.astype(np.int64) for k in range(5))
        sec = cols[5].data.astype(np.float64)
        valid = propagate_nulls(cols)
        out = np.zeros(n, dtype=np.int64)
        for i in range(n):
            if valid is not None and not valid[i]:
                continue
            try:
                day_us = np.datetime64(
                    f"{y[i]:04d}-{mo[i]:02d}-{d[i]:02d}", "D") \
                    .astype("datetime64[us]").astype(np.int64)
            except ValueError:
                raise errors.SqlError(
                    "22008", f"date field value out of range: "
                             f"{y[i]}-{mo[i]}-{d[i]}")
            if not (0 <= h[i] < 24 and 0 <= mi[i] < 60
                    and 0 <= sec[i] < 60):
                raise errors.SqlError(
                    "22008", "time field value out of range")
            out[i] = day_us + (h[i] * 3600 + mi[i] * 60) * 1_000_000 \
                + int(round(sec[i] * 1e6))
        return _result(dt.TIMESTAMP, out, cols)
    return FunctionResolution(dt.TIMESTAMP, impl)


# -- json (documents stored as TEXT; reference: functions/json.cpp) --------

def _json_extract_impl(ts, as_text: bool):
    def impl(cols, n):
        import json as _json
        docs = string_values(cols[0])
        paths = string_values(cols[1])
        valid = propagate_nulls(cols)
        out = []
        bad = np.zeros(n, dtype=bool)
        for i in range(n):
            if valid is not None and not valid[i]:
                out.append("")
                continue
            try:
                obj = _json.loads(docs[i])
            except _json.JSONDecodeError:
                out.append("")
                bad[i] = True
                continue
            path = paths[i].lstrip("$").lstrip(".")
            cur = obj
            ok = True
            for part in [p for p in re.split(r"[.\[\]]+", path) if p]:
                if isinstance(cur, dict) and part in cur:
                    cur = cur[part]
                elif isinstance(cur, list) and part.isdigit() and \
                        int(part) < len(cur):
                    cur = cur[int(part)]
                else:
                    ok = False
                    break
            if not ok or cur is None:
                out.append("")
                bad[i] = True
            elif isinstance(cur, str) and as_text:
                out.append(cur)         # ..._string: bare text (PG ->>)
            else:
                out.append(_json.dumps(cur))  # json_extract: valid JSON
        col = make_string_column(np.asarray(out, dtype=object).astype(str),
                                 valid)
        if bad.any():
            v = col.valid_mask() & ~bad
            col = Column(dt.VARCHAR, col.data,
                         None if v.all() else v, col.dictionary)
        return col
    return FunctionResolution(dt.VARCHAR, impl)


_REGISTRY["json_extract"] = lambda ts: _json_extract_impl(ts, as_text=False)
_REGISTRY["json_extract_string"] = \
    lambda ts: _json_extract_impl(ts, as_text=True)


# -- PG json operators (-> ->> #> #>> @> <@ ? ?| ?&) -----------------------
# Desugared by the parser (sql/parser.py _JSON_OPS) to these functions
# (reference: the DuckDB fork's json operator → json_extract lowering).

def _json_docs(col, n):
    """Per-row parsed JSON values (None for SQL NULL rows)."""
    texts = string_values(col)
    valid = col.valid_mask() if col.validity is not None else None
    out = []
    for i in range(n):
        if valid is not None and not valid[i]:
            out.append(None)
            continue
        try:
            out.append(json.loads(texts[i]))
        except json.JSONDecodeError:
            raise errors.SqlError(
                errors.INVALID_TEXT_REPRESENTATION,
                f"invalid input syntax for type json: {texts[i][:40]!r}")
    return out


def _json_render(v, as_text: bool):
    if v is None:
        return None
    if as_text and isinstance(v, str):
        return v
    if as_text and isinstance(v, bool):
        return "true" if v else "false"
    return json.dumps(v)


def _json_getelem_impl(ts, as_text: bool):
    if len(ts) != 2:
        return None
    key_is_int = ts[1].is_integer

    def impl(cols, n):
        docs = _json_docs(cols[0], n)
        keys = cols[1].to_pylist()
        out, missing = [], np.zeros(n, dtype=bool)
        for i in range(n):
            doc, cur = docs[i], None
            k = _json_scalar(keys, i)
            if doc is not None and k is not None:
                if key_is_int and isinstance(doc, list):
                    k = int(k)
                    if -len(doc) <= k < len(doc):
                        cur = doc[k]
                elif not key_is_int and isinstance(doc, dict):
                    cur = doc.get(str(k))
            r = _json_render(cur, as_text)
            missing[i] = r is None
            out.append(r or "")
        return _result_text(out, missing, cols)
    return FunctionResolution(dt.VARCHAR, impl)


def _result_text(out, missing, cols):
    col = make_string_column(np.asarray(out, dtype=object).astype(str),
                             propagate_nulls(cols))
    if missing.any():
        v = col.valid_mask() & ~missing
        col = Column(dt.VARCHAR, col.data,
                     None if v.all() else v, col.dictionary)
    return col


def _pg_path_elems(p):
    """'{a,1,b}' (PG text[] literal) or '["a","b"]' (this engine's array
    encoding) → ['a','1','b']."""
    p = p.strip()
    if p.startswith("["):
        try:
            return [str(e) for e in json.loads(p)]
        except json.JSONDecodeError:
            pass
    if p.startswith("{") and p.endswith("}"):
        p = p[1:-1]
    return [e.strip().strip('"') for e in p.split(",") if e.strip() != ""]


def _json_getpath_impl(ts, as_text: bool):
    if len(ts) != 2:
        return None

    def impl(cols, n):
        docs = _json_docs(cols[0], n)
        paths = string_values(cols[1])
        out, missing = [], np.zeros(n, dtype=bool)
        for i in range(n):
            cur = docs[i]
            for part in _pg_path_elems(paths[i]) if cur is not None else []:
                if isinstance(cur, dict) and part in cur:
                    cur = cur[part]
                elif isinstance(cur, list) and \
                        part.lstrip("-").isdigit() and \
                        -len(cur) <= int(part) < len(cur):
                    cur = cur[int(part)]
                else:
                    cur = None
                    break
            r = _json_render(cur, as_text)
            missing[i] = r is None
            out.append(r or "")
        return _result_text(out, missing, cols)
    return FunctionResolution(dt.VARCHAR, impl)


_REGISTRY["json_getelem"] = lambda ts: _json_getelem_impl(ts, as_text=False)
_REGISTRY["json_getelem_text"] = \
    lambda ts: _json_getelem_impl(ts, as_text=True)
_REGISTRY["json_getpath"] = lambda ts: _json_getpath_impl(ts, as_text=False)
_REGISTRY["json_getpath_text"] = \
    lambda ts: _json_getpath_impl(ts, as_text=True)


def _jsonb_contains(a, b, top: bool = True) -> bool:
    """PG jsonb containment: objects pairwise-recursive; arrays ⊇ every
    RHS element; a TOP-LEVEL array contains an RHS scalar (the one special
    case — nested values must match in kind); scalars by equality."""
    if isinstance(a, dict) and isinstance(b, dict):
        return all(k in a and _jsonb_contains(a[k], v, top=False)
                   for k, v in b.items())
    if isinstance(a, list) and isinstance(b, list):
        return all(any(_jsonb_contains(x, y, top=False) for x in a)
                   for y in b)
    if isinstance(a, list) and top:
        return any(_jsonb_contains(x, b, top=False) for x in a)
    if isinstance(a, (dict, list)) or isinstance(b, (dict, list)):
        return False
    return type(a) is type(b) and a == b or \
        (isinstance(a, (int, float)) and not isinstance(a, bool)
         and isinstance(b, (int, float)) and not isinstance(b, bool)
         and a == b)


def _containment_impl(ts, flipped: bool):
    if len(ts) != 2 or not (_stringish(ts[0]) and _stringish(ts[1])):
        return None

    def impl(cols, n):
        a = _json_docs(cols[0], n)
        b = _json_docs(cols[1], n)
        if flipped:
            a, b = b, a
        data = np.asarray([x is not None and y is not None
                           and _jsonb_contains(x, y)
                           for x, y in zip(a, b)])
        return _result(dt.BOOL, data, cols)
    return FunctionResolution(dt.BOOL, impl)


_REGISTRY["contains_op"] = lambda ts: _containment_impl(ts, flipped=False)
_REGISTRY["contained_op"] = lambda ts: _containment_impl(ts, flipped=True)


@register("json_exists_op")
def _json_exists_op(ts):
    if len(ts) != 2:
        return None

    def impl(cols, n):
        docs = _json_docs(cols[0], n)
        keys = string_values(cols[1])
        data = np.asarray([
            (isinstance(d, dict) and keys[i] in d)
            or (isinstance(d, list) and keys[i] in d)
            for i, d in enumerate(docs)])
        return _result(dt.BOOL, data, cols)
    return FunctionResolution(dt.BOOL, impl)


def _json_exists_multi(ts, want_all: bool):
    if len(ts) != 2:
        return None

    def impl(cols, n):
        docs = _json_docs(cols[0], n)
        key_lists = string_values(cols[1])
        out = np.zeros(n, dtype=bool)
        for i, d in enumerate(docs):
            ks = _pg_path_elems(key_lists[i])
            def has(k):
                return (isinstance(d, dict) and k in d) or \
                    (isinstance(d, list) and k in d)
            out[i] = all(map(has, ks)) if want_all else any(map(has, ks))
        return _result(dt.BOOL, out, cols)
    return FunctionResolution(dt.BOOL, impl)


_REGISTRY["json_exists_any"] = \
    lambda ts: _json_exists_multi(ts, want_all=False)
_REGISTRY["json_exists_all"] = \
    lambda ts: _json_exists_multi(ts, want_all=True)


@register("json_valid")
def _json_valid(ts):
    def impl(cols, n):
        import json as _json
        docs = string_values(cols[0])
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            try:
                _json.loads(docs[i])
                out[i] = True
            except _json.JSONDecodeError:
                pass
        return _result(dt.BOOL, out, cols)
    return FunctionResolution(dt.BOOL, impl)


def _make_regex_match(ci: bool, negated: bool):
    """PG ~ / ~* / !~ / !~* — unanchored regex search over strings,
    compiled on the linear-time NFA (search/regexp.py): user patterns
    never hit a backtracking engine."""
    def resolver(ts):
        if len(ts) != 2 or not all(
                t.is_string or t.id is dt.TypeId.NULL for t in ts):
            return None

        def impl(cols, n):
            from ..exec.plan import check_cancel
            from ..search.regexp import RegexpError, compile_regexp
            texts = string_values(cols[0])
            pats = string_values(cols[1])
            valid = propagate_nulls(cols)
            comp_cache: dict = {}
            out = np.zeros(n, dtype=bool)
            for i in range(n):
                if (i & 0x3FF) == 0:
                    # regex over a wide batch is the slowest row loop in
                    # the engine — finer cancel granularity than the
                    # batch boundary (~1k rows ≈ ms)
                    check_cancel()
                if valid is not None and not valid[i]:
                    continue
                pat = pats[i]
                r = comp_cache.get(pat)
                if r is None:
                    try:
                        # unanchored search; ^/$ are real zero-width
                        # assertions in the NFA, composing with the
                        # wrapper per PG semantics (per-branch anchors)
                        r = compile_regexp(f"(.|\n)*({pat})(.|\n)*",
                                           case_fold=ci)
                    except RegexpError as e:
                        raise errors.SqlError(
                            errors.INVALID_REGULAR_EXPRESSION,
                            f"invalid regular expression: {e}")
                    comp_cache[pat] = r
                hay = texts[i].lower() if ci else texts[i]
                out[i] = r.fullmatch(hay)
            if negated:
                out = ~out
            return _result(dt.BOOL, out, cols)
        return FunctionResolution(dt.BOOL, impl)
    return resolver


_REGISTRY["op~"] = _make_regex_match(False, False)
_REGISTRY["op~*"] = _make_regex_match(True, False)
_REGISTRY["op!~"] = _make_regex_match(False, True)
_REGISTRY["op!~*"] = _make_regex_match(True, True)


# -- geo functions ---------------------------------------------------------
# Reference analog: libs/geo (S2-backed WKB/GeoJSON parsing + spherical
# geometry; SURVEY.md §2 "Geo"). TPU re-design: points are WKT/GeoJSON
# text; distance math is vectorized spherical trig over whole columns
# (VPU-friendly batch math, no per-row geometry objects).

_EARTH_RADIUS_M = 6371008.8          # mean radius, as in _sphere functions


def _stringish(t) -> bool:
    return t.is_string or t.id is dt.TypeId.NULL


def _parse_point(s):
    """Accepts 'POINT(lon lat)', '[lon, lat]', or GeoJSON Point."""
    t = s.strip()
    if t[:1] in "[{":
        v = json.loads(t)
        if isinstance(v, dict):
            if str(v.get("type", "")).lower() != "point":
                raise ValueError("not a Point")
            v = v.get("coordinates")
        if not isinstance(v, list) or len(v) != 2:
            raise ValueError("expected two coordinates")
        return float(v[0]), float(v[1])
    if t[:5].upper() == "POINT":
        inner = t[t.index("(") + 1:t.rindex(")")]
        parts = inner.replace(",", " ").split()
        if len(parts) != 2:
            raise ValueError("expected two coordinates")
        return float(parts[0]), float(parts[1])
    raise ValueError("unrecognized point syntax")


def _point_cols(cols, n):
    """(lon, lat) arrays per point-text column. Parse failures raise, so
    validity is exactly propagate_nulls(cols) — which _result applies."""
    lons, lats = [], []
    valid = propagate_nulls(cols)
    for c in cols:
        texts = string_values(c)
        lon = np.zeros(n, dtype=np.float64)
        lat = np.zeros(n, dtype=np.float64)
        for i in range(n):
            if valid is not None and not valid[i]:
                continue
            try:
                lon[i], lat[i] = _parse_point(texts[i])
            except (ValueError, IndexError, TypeError) as e:
                raise errors.SqlError(
                    errors.INVALID_TEXT_REPRESENTATION,
                    f"invalid geometry {texts[i][:40]!r}: {e}")
        lons.append(lon)
        lats.append(lat)
    return lons, lats


def _haversine_m(lon1, lat1, lon2, lat2):
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dp = p2 - p1
    dl = np.radians(lon2 - lon1)
    a = np.sin(dp / 2.0) ** 2 + \
        np.cos(p1) * np.cos(p2) * np.sin(dl / 2.0) ** 2
    return 2.0 * _EARTH_RADIUS_M * np.arcsin(np.minimum(np.sqrt(a), 1.0))


@register("st_point")
def _st_point(ts):
    if len(ts) != 2 or not _all_numeric(ts):
        return None

    def impl(cols, n):
        lon = cols[0].data.astype(np.float64)
        lat = cols[1].data.astype(np.float64)
        # shortest-repr floats: st_x(st_point(x, y)) must round-trip x
        out = np.asarray([f"POINT({float(lon[i])!r} {float(lat[i])!r})"
                          for i in range(n)], dtype=object)
        return make_string_column(out.astype(str), propagate_nulls(cols))
    return FunctionResolution(dt.VARCHAR, impl)


def _st_coord(idx):
    def resolver(ts):
        if len(ts) != 1 or not _stringish(ts[0]):
            return None

        def impl(cols, n):
            (lon,), (lat,) = _point_cols(cols[:1], n)
            return _result(dt.DOUBLE, (lon, lat)[idx], cols)
        return FunctionResolution(dt.DOUBLE, impl)
    return resolver


_REGISTRY["st_x"] = _st_coord(0)
_REGISTRY["st_y"] = _st_coord(1)


@register("st_distance")
def _st_distance(ts):
    if len(ts) != 2 or not all(_stringish(t) for t in ts):
        return None

    def impl(cols, n):
        (lon1, lon2), (lat1, lat2) = _point_cols(cols[:2], n)
        data = _haversine_m(lon1, lat1, lon2, lat2)
        return _result(dt.DOUBLE, data, cols)
    return FunctionResolution(dt.DOUBLE, impl)


_REGISTRY["st_distance_sphere"] = _REGISTRY["st_distance"]


@register("st_dwithin")
def _st_dwithin(ts):
    if len(ts) != 3 or not all(_stringish(t) for t in ts[:2]) or \
            not ts[2].is_numeric:
        return None

    def impl(cols, n):
        (lon1, lon2), (lat1, lat2) = _point_cols(cols[:2], n)
        radius = cols[2].data.astype(np.float64)
        data = _haversine_m(lon1, lat1, lon2, lat2) <= radius
        return _result(dt.BOOL, data, cols)
    return FunctionResolution(dt.BOOL, impl)


# -- array functions -------------------------------------------------------
# Reference analog: server/connector/functions/array.cpp. Arrays are JSON
# text (same encoding array_agg produces), columnar-friendly: a VARCHAR
# column of '[...]' values.


def _array_rows(col, n):
    """Per-row parsed arrays (list or None); non-array JSON raises 22P02."""
    texts = string_values(col)
    valid = col.valid_mask() if col.validity is not None else None
    out = []
    for i in range(n):
        if valid is not None and not valid[i]:
            out.append(None)
            continue
        try:
            v = json.loads(texts[i])
        except json.JSONDecodeError:
            raise errors.SqlError(
                errors.INVALID_TEXT_REPRESENTATION,
                f"invalid array literal: {texts[i][:40]!r}")
        if not isinstance(v, list):
            raise errors.SqlError(
                errors.INVALID_TEXT_REPRESENTATION,
                f"expected a JSON array, got: {texts[i][:40]!r}")
        out.append(v)
    return out


def _json_scalar(vals, i):
    """vals: the column's to_pylist(), materialized ONCE by the caller."""
    v = vals[i]
    if isinstance(v, np.generic):
        v = v.item()
    return v


@register("make_array")
def _make_array(ts):
    # the user-callable spelling: every element taken verbatim
    def impl(cols, n):
        pylists = [c.to_pylist() for c in cols]
        out = []
        for i in range(n):
            out.append(json.dumps(
                [_json_scalar(vals, i) for vals in pylists]))
        return make_string_column(
            np.asarray(out, dtype=object).astype(str), None)
    return FunctionResolution(dt.VARCHAR, impl)


@register("__make_array")
def _make_array_spliced(ts):
    """Parser-internal spelling for ARRAY[...] literals: the first arg is
    a literal splice map (comma-separated indices of elements that are
    array-valued expressions) — never reachable by user SQL."""
    def impl(cols, n):
        spec = cols[0].decode(0) if n else ""
        splice = {int(x) for x in str(spec or "").split(",") if x != ""}
        pylists = [c.to_pylist() for c in cols[1:]]
        out = []
        for i in range(n):
            row = []
            for ci, vals in enumerate(pylists):
                v = _json_scalar(vals, i)
                if ci in splice and isinstance(v, str):
                    try:
                        v = json.loads(v)
                    except json.JSONDecodeError:
                        raise errors.SqlError(
                            errors.INVALID_TEXT_REPRESENTATION,
                            f"invalid array element: {v[:40]!r}")
                row.append(v)
            out.append(json.dumps(row))
        col = make_string_column(
            np.asarray(out, dtype=object).astype(str), None)
        col.type = t
        return col
    # element type: first non-NULL argument after the splice map
    elem = next((x for x in ts[1:]
                 if x.id is not dt.TypeId.NULL), dt.VARCHAR)
    t = dt.array_of(elem)
    return FunctionResolution(t, impl)


@register("__quant_cmp")
def _quant_cmp(ts):
    """op ANY/ALL(array) — parser-internal spelling. SQL three-valued
    semantics: ANY is an OR fold, ALL an AND fold, NULL elements give
    UNKNOWN (reference: PG quantified comparison; used by psql's
    `nspname = ANY(current_schemas(true))`)."""
    if len(ts) != 4:
        return None

    def cmp_one(op, a, b):
        if a is None or b is None:
            return None
        if op in ("~", "~*", "!~", "!~*"):
            flags = re.IGNORECASE if op.endswith("*") else 0
            m = re.search(str(b), str(a), flags) is not None
            return (not m) if op.startswith("!") else m
        if isinstance(a, str) != isinstance(b, str):
            # PG resolves the unknown-typed side toward the typed side:
            # numeric-vs-text coerces the text numerically, never
            # lexicographically (9 < ALL(ARRAY['10']) is true)
            s = a if isinstance(a, str) else b
            try:
                conv = float(s)
                if isinstance(a, str):
                    a = conv
                else:
                    b = conv
            except ValueError:
                if op == "=":
                    return str(a) == str(b)
                if op in ("<>", "!="):
                    return str(a) != str(b)
                raise errors.SqlError(
                    errors.INVALID_TEXT_REPRESENTATION,
                    f'invalid input syntax for type numeric: "{s}"')
        try:
            if op == "=":
                return a == b
            if op in ("<>", "!="):
                return a != b
            if op == "<":
                return a < b
            if op == "<=":
                return a <= b
            if op == ">":
                return a > b
            if op == ">=":
                return a >= b
        except TypeError:
            return str(a) == str(b) if op == "=" else None
        return None

    def impl(cols, n):
        op = cols[0].decode(0) if n else "="
        quant = cols[1].decode(0) if n else "ANY"
        left = cols[2].to_pylist()
        arrs = _array_rows(cols[3], n)
        out = np.zeros(n, dtype=bool)
        validity = np.ones(n, dtype=bool)
        for i in range(n):
            arr = arrs[i]
            if arr is None:
                validity[i] = False
                continue
            votes = [cmp_one(op, left[i], el) for el in arr]
            if quant == "ANY":
                if any(v is True for v in votes):
                    out[i] = True
                elif any(v is None for v in votes):
                    validity[i] = False
            else:  # ALL
                if any(v is False for v in votes):
                    out[i] = False
                elif any(v is None for v in votes):
                    validity[i] = False
                else:
                    out[i] = True
        return Column(dt.BOOL, out, validity if not validity.all() else None)
    return FunctionResolution(dt.BOOL, impl)


@register("array_length")
def _array_length(ts):
    if not ts or not _stringish(ts[0]):
        return None

    def impl(cols, n):
        arrs = _array_rows(cols[0], n)
        data = np.asarray([len(a) if a is not None else 0 for a in arrs],
                          dtype=np.int32)
        return _result(dt.INT, data, cols[:1])
    return FunctionResolution(dt.INT, impl)


_REGISTRY["cardinality"] = _REGISTRY["array_length"]


@register("array_get")
def _array_get(ts):
    if len(ts) != 2 or not _stringish(ts[0]) or not (
            ts[1].is_numeric or ts[1].id is dt.TypeId.NULL):
        return None

    def impl(cols, n):
        arrs = _array_rows(cols[0], n)
        idx = cols[1].data.astype(np.int64)
        out = []
        ok = np.ones(n, dtype=bool)
        for i in range(n):
            a = arrs[i]
            j = int(idx[i]) - 1           # PG arrays are 1-based
            if a is None or j < 0 or j >= len(a) or a[j] is None:
                out.append("")
                ok[i] = False
            else:
                v = a[j]
                if isinstance(v, str):
                    out.append(v)
                elif isinstance(v, (list, dict)):
                    out.append(json.dumps(v))   # nested arrays stay JSON
                else:
                    out.append(_pg_text(v))
        base = propagate_nulls(cols)
        if base is not None:
            ok &= base
        return make_string_column(
            np.asarray(out, dtype=object).astype(str),
            None if ok.all() else ok)
    return FunctionResolution(dt.VARCHAR, impl)


@register("array_append")
def _array_append(ts):
    if len(ts) != 2 or not _stringish(ts[0]):
        return None

    def impl(cols, n):
        arrs = _array_rows(cols[0], n)
        vals = cols[1].to_pylist()
        out = []
        for i in range(n):
            # PG semantics: a NULL array behaves as empty — the result is
            # never NULL (array_append(NULL, 5) = {5})
            a = list(arrs[i]) if arrs[i] is not None else []
            a.append(_json_scalar(vals, i))
            out.append(json.dumps(a))
        col = make_string_column(
            np.asarray(out, dtype=object).astype(str), None)
        col.type = t
        return col
    if ts[0].id is dt.TypeId.ARRAY and ts[0].elem is not None:
        elem = dt.SqlType(ts[0].elem)
        v = ts[1]
        # appended value must fit the element type (PG: 42883 otherwise)
        if v.id is not dt.TypeId.NULL and \
                elem.is_numeric != v.is_numeric:
            return None
        t = ts[0]
    else:
        t = ts[0] if ts[0].id is dt.TypeId.ARRAY else dt.array_of(ts[1])
    return FunctionResolution(t, impl)


@register("array_cat")
def _array_cat(ts):
    if len(ts) != 2 or not all(_stringish(t) for t in ts):
        return None

    def impl(cols, n):
        a1 = _array_rows(cols[0], n)
        a2 = _array_rows(cols[1], n)
        # PG: NULL || x = x; NULL only when BOTH sides are NULL
        out = [json.dumps((x or []) + (y or [])) for x, y in zip(a1, a2)]
        both_null = np.asarray([x is None and y is None
                                for x, y in zip(a1, a2)])
        col = make_string_column(
            np.asarray(out, dtype=object).astype(str),
            None if not both_null.any() else ~both_null)
        col.type = t
        return col
    t = next((x for x in ts if x.id is dt.TypeId.ARRAY),
             dt.array_of(None))
    return FunctionResolution(t, impl)


@register("array_position")
def _array_position(ts):
    if len(ts) != 2 or not _stringish(ts[0]):
        return None

    def impl(cols, n):
        arrs = _array_rows(cols[0], n)
        vals = cols[1].to_pylist()
        out = np.zeros(n, dtype=np.int32)
        absent = np.zeros(n, dtype=bool)
        for i in range(n):
            a = arrs[i]
            needle = _json_scalar(vals, i)
            if a is not None and needle in a:
                out[i] = a.index(needle) + 1
            else:
                absent[i] = True
        return _result(dt.INT, out, cols, extra_invalid=absent)
    return FunctionResolution(dt.INT, impl)


@register("array_contains")
def _array_contains(ts):
    if len(ts) != 2 or not _stringish(ts[0]):
        return None

    def impl(cols, n):
        arrs = _array_rows(cols[0], n)
        vals = cols[1].to_pylist()
        data = np.asarray(
            [a is not None and _json_scalar(vals, i) in a
             for i, a in enumerate(arrs)])
        return _result(dt.BOOL, data, cols)
    return FunctionResolution(dt.BOOL, impl)


@register("string_to_array")
def _string_to_array(ts):
    if len(ts) != 2 or not all(_stringish(t) for t in ts):
        return None

    def impl(cols, n):
        s = string_values(cols[0])
        d = string_values(cols[1])
        d_null = (~cols[1].valid_mask() if cols[1].validity is not None
                  else np.zeros(n, dtype=bool))
        out = []
        for i in range(n):
            if d_null[i]:
                parts = list(s[i])        # PG: NULL delimiter → per char
            elif d[i] == "":
                parts = [s[i]]            # PG: '' delimiter → one element
            else:
                parts = s[i].split(d[i])
            out.append(json.dumps(parts))
        # NULL only when the input string is NULL (non-strict in delim)
        col = make_string_column(
            np.asarray(out, dtype=object).astype(str),
            propagate_nulls(cols[:1]))
        col.type = t
        return col
    t = dt.array_of(dt.VARCHAR)
    return FunctionResolution(t, impl)


@register("array_to_string")
def _array_to_string(ts):
    """array_to_string(arr, delim[, null_string]) — PG skips NULL
    elements unless a null replacement is given."""
    if len(ts) not in (2, 3) or not _stringish(ts[0]) or \
            not _stringish(ts[1]) or \
            (len(ts) == 3 and not (_stringish(ts[2]) or
                                   ts[2].id is dt.TypeId.NULL)):
        return None

    def impl(cols, n):
        arrs = _array_rows(cols[0], n)
        d = string_values(cols[1])
        nulls = _col_text_values(cols[2]) if len(cols) > 2 else None
        # PG: a NULL null_string means NULL elements are simply omitted
        # — it must NOT null the whole result
        nulls_ok = cols[2].valid_mask() if len(cols) > 2 else None
        out = []
        for i in range(n):
            a = arrs[i] or []
            parts = []
            for v in a:
                if v is None:
                    if nulls is not None and nulls_ok[i]:
                        parts.append(str(nulls[i]))
                    continue
                parts.append(v if isinstance(v, str)
                             else json.dumps(v)
                             if isinstance(v, (list, dict))
                             else _pg_text(v))
            out.append(d[i].join(parts))
        return make_string_column(
            np.asarray(out, dtype=object).astype(str),
            propagate_nulls(cols[:2]))
    return FunctionResolution(dt.VARCHAR, impl)


def _json_values(col) -> list:
    """Column → JSON-ready python values: temporal internals render as
    their PG text (PG to_json semantics), everything else passes
    through."""
    vals = col.to_pylist()
    if col.type.id in (dt.TypeId.DATE, dt.TypeId.TIMESTAMP,
                       dt.TypeId.INTERVAL):
        from ..columnar.pgcopy import _scalar_field_text
        return [None if v is None else _scalar_field_text(col.type, v)
                for v in vals]
    return vals


@register("json_build_object")
def _json_build_object(ts):
    """json_build_object(k1, v1, ...) — PG variadic builder."""
    if len(ts) % 2 != 0:
        return None

    def impl(cols, n):
        lists = [_json_values(c) for c in cols]
        out = []
        for i in range(n):
            obj = {}
            for k in range(0, len(lists), 2):
                key = lists[k][i]
                if key is None:
                    raise errors.SqlError(
                        "22004",
                        "null value not allowed for object key")
                obj[str(key)] = lists[k + 1][i]
            out.append(json.dumps(obj))
        return make_string_column(np.asarray(out, dtype=object), None)
    return FunctionResolution(dt.VARCHAR, impl)


@register("json_build_array")
def _json_build_array(ts):
    def impl(cols, n):
        lists = [_json_values(c) for c in cols]
        out = [json.dumps([lst[i] for lst in lists]) for i in range(n)]
        return make_string_column(np.asarray(out, dtype=object), None)
    return FunctionResolution(dt.VARCHAR, impl)


@register("json_typeof")
def _json_typeof(ts):
    if not ts or not _stringish(ts[0]):
        return None

    def impl(cols, n):
        docs = string_values(cols[0])
        valid = propagate_nulls(cols)
        out = []
        bad = np.zeros(n, dtype=bool)
        for i in range(n):
            if valid is not None and not valid[i]:
                out.append("")
                continue
            try:
                v = json.loads(docs[i])
            except json.JSONDecodeError:
                out.append("")
                bad[i] = True
                continue
            out.append("null" if v is None else
                       "boolean" if isinstance(v, bool) else
                       "number" if isinstance(v, (int, float)) else
                       "string" if isinstance(v, str) else
                       "array" if isinstance(v, list) else "object")
        col = make_string_column(np.asarray(out, dtype=object).astype(str),
                                 valid)
        if bad.any():
            v = col.valid_mask() & ~bad
            col = Column(dt.VARCHAR, col.data,
                         None if v.all() else v, col.dictionary)
        return col
    return FunctionResolution(dt.VARCHAR, impl)


@register("json_array_length")
def _json_array_length(ts):
    if not ts or not _stringish(ts[0]):
        return None

    def impl(cols, n):
        arrs = _array_rows(cols[0], n)
        data = np.asarray([len(a) if a is not None else 0 for a in arrs],
                          dtype=np.int32)
        return _result(dt.INT, data, cols)
    return FunctionResolution(dt.INT, impl)


@register("json_object_keys")
def _json_object_keys(ts):
    """Keys of a JSON object as a JSON array (PG's set-returning variant
    maps onto unnest(json_object_keys(x)))."""
    if not ts or not _stringish(ts[0]):
        return None

    def impl(cols, n):
        docs = string_values(cols[0])
        valid = propagate_nulls(cols)
        out = []
        for i in range(n):
            if valid is not None and not valid[i]:
                out.append("")
                continue
            try:
                v = json.loads(docs[i])
            except json.JSONDecodeError:
                raise errors.SqlError(
                    errors.INVALID_TEXT_REPRESENTATION,
                    f"invalid JSON: {docs[i][:40]!r}")
            if not isinstance(v, dict):
                raise errors.SqlError(
                    errors.INVALID_TEXT_REPRESENTATION,
                    "json_object_keys expects a JSON object")
            out.append(json.dumps(list(v.keys())))
        return make_string_column(
            np.asarray(out, dtype=object).astype(str), valid)
    return FunctionResolution(dt.VARCHAR, impl)


# PG system/introspection functions register themselves on import (kept in
# a separate module so the catalog surface doesn't bloat this file)
from . import pgsys  # noqa: E402,F401  (registration side effects)
# Geo shape functions (WKT/WKB/GeoJSON, predicates, measures) — same
# registration-on-import pattern
from . import geofns  # noqa: E402,F401  (registration side effects)
# Embedding provider layer (ai_embed + secrets)
from . import embedfns  # noqa: E402,F401  (registration side effects)


# -- ROW(...) anonymous composites (reference: server/pg/serialize.cpp
# record path; record values render as (f1,f2) text and the binary
# record format with per-field OIDs) --------------------------------------

@register("row")
def _row(ts):
    from ..columnar.pgcopy import field_oid
    oids = [field_oid(t) for t in ts]

    def impl(cols, n):
        # to_pylist() yields pure Python scalars (it .item()s numpy
        # values), so rows JSON-encode directly
        pylists = [c.to_pylist() for c in cols]
        out = []
        for i in range(n):
            out.append(json.dumps({"o": oids,
                                   "v": [pl[i] for pl in pylists]},
                                  separators=(",", ":")))
        col = make_string_column(np.asarray(out, dtype=object), None)
        return Column(dt.RECORD, col.data, col.validity, col.dictionary)

    return FunctionResolution(dt.RECORD, impl)
