"""Copied from serenedb_tpu/exec/window.py.

Window function execution.

Reference analog: DuckDB's physical window operator (the reference gets
window functions from its engine fork; SURVEY.md §1 L3). Semantics follow
PG: with ORDER BY the default frame is RANGE UNBOUNDED PRECEDING..CURRENT
ROW (running aggregates, ties share peaks), without ORDER BY aggregates
cover the whole partition.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column, concat_batches
from ..sql.expr import BoundExpr
from .plan import PlanNode

WINDOW_FUNCS = {"row_number", "rank", "dense_rank", "ntile",
                "lag", "lead", "first_value", "last_value",
                "count", "sum", "min", "max", "avg"}


@dataclass
class WindowSpec:
    func: str
    arg: Optional[BoundExpr]           # None for row_number/rank/...
    extra: Optional[int]               # lag/lead offset, ntile buckets
    partition_by: list[BoundExpr]
    order_by: list[tuple[BoundExpr, bool]]   # (expr, desc)
    type: dt.SqlType
    default: Optional[object] = None   # lag/lead 3rd arg (PG default NULL)
    #: ROWS frame (start_off, end_off), None member = unbounded; None =
    #: default frame (RANGE UNBOUNDED PRECEDING .. CURRENT ROW)
    frame: Optional[tuple] = None


def window_result_type(func: str, arg_type: Optional[dt.SqlType]) -> dt.SqlType:
    if func in ("row_number", "rank", "dense_rank", "ntile", "count"):
        return dt.BIGINT
    if func == "avg":
        return dt.DOUBLE
    if func == "sum":
        if arg_type is not None and arg_type.is_integer:
            return dt.BIGINT
        return dt.DOUBLE
    return arg_type or dt.BIGINT


class WindowNode(PlanNode):
    """Appends one #win{i} column per spec to the child's output."""

    def __init__(self, child: PlanNode, specs: list[WindowSpec]):
        self.child = child
        self.specs = specs
        self.names = list(child.names) + [f"#win{i}"
                                          for i in range(len(specs))]
        self.types = list(child.types) + [s.type for s in specs]

    def children(self):
        return [self.child]

    def label(self):
        return f"Window [{', '.join(s.func for s in self.specs)}]"

    def batches(self, ctx):
        full = concat_batches(list(self.child.batches(ctx)))
        n = full.num_rows
        out_cols = list(full.columns)
        for spec in self.specs:
            out_cols.append(self._compute(spec, full, n))
        yield Batch(list(self.names), out_cols)

    def _compute(self, spec: WindowSpec, full: Batch, n: int) -> Column:
        from ..ops.agg import factorize_keys
        if n == 0:
            return Column.from_pylist([], spec.type)
        if spec.partition_by:
            pcols = [e.eval(full) for e in spec.partition_by]
            codes, _, _ = factorize_keys([c.data for c in pcols],
                                         [c.validity for c in pcols])
        else:
            codes = np.zeros(n, dtype=np.int64)
        # rank each ORDER BY key once; reuse for sort keys AND peer groups
        key_ranks = []     # (ranks int64 with NULL=-1, desc)
        for e, desc in spec.order_by:
            c = e.eval(full)
            _, ranks = np.unique(c.data, return_inverse=True)
            ranks = np.where(c.valid_mask(), ranks.astype(np.int64), -1)
            key_ranks.append((ranks, desc))
        sort_keys = [np.arange(n)]  # final tiebreak: input order
        for ranks, desc in reversed(key_ranks):
            nulls = ranks < 0
            v = -ranks if desc else ranks
            sort_keys.append(np.where(nulls, 0, v))
            sort_keys.append(np.where(nulls, 1, -1) if not desc
                             else np.where(nulls, -1, 1))
        sort_keys.append(codes)
        order = np.lexsort(tuple(sort_keys))
        s_codes = codes[order]
        boundaries = np.concatenate(
            [[True], s_codes[1:] != s_codes[:-1]])
        part_start = np.maximum.accumulate(
            np.where(boundaries, np.arange(n), 0))
        idx_in_part = np.arange(n) - part_start

        # peer groups (ties) for rank/running aggregates with ORDER BY
        if spec.order_by:
            same_peer = np.ones(n, dtype=bool)
            if n:
                same_peer[0] = False
                for ranks, _ in key_ranks:
                    k = ranks[order]
                    same_peer[1:] &= k[1:] == k[:-1]
                same_peer[1:] &= ~boundaries[1:]
        else:
            same_peer = np.zeros(n, dtype=bool)

        vals = None
        valid = None
        if spec.arg is not None:
            c = spec.arg.eval(full)
            vals = c.data[order]
            valid = c.valid_mask()[order]
            arg_col = c
        result = np.zeros(n, dtype=np.float64)
        res_valid = np.ones(n, dtype=bool)

        f = spec.func
        if f == "row_number":
            result = idx_in_part + 1
        elif f in ("rank", "dense_rank"):
            if not spec.order_by:
                raise errors.SqlError("42P20",
                                      f"{f}() requires ORDER BY")
            rank = np.zeros(n, dtype=np.int64)
            dense = np.zeros(n, dtype=np.int64)
            for i in range(n):
                if boundaries[i]:
                    rank[i] = 1
                    dense[i] = 1
                elif same_peer[i]:
                    rank[i] = rank[i - 1]
                    dense[i] = dense[i - 1]
                else:
                    rank[i] = idx_in_part[i] + 1
                    dense[i] = dense[i - 1] + 1
            result = rank if f == "rank" else dense
        elif f == "ntile":
            buckets = max(spec.extra or 1, 1)
            # partition sizes → PG ntile: larger buckets first
            part_sizes = np.zeros(n, dtype=np.int64)
            ends = np.flatnonzero(np.concatenate([boundaries[1:], [True]]))
            starts = np.flatnonzero(boundaries)
            result = np.zeros(n, dtype=np.int64)
            for st, en in zip(starts, ends):
                size = en - st + 1
                base = size // buckets
                rem = size % buckets
                pos = 0
                for b in range(1, buckets + 1):
                    cnt = base + (1 if b <= rem else 0)
                    result[st + pos:st + pos + cnt] = b
                    pos += cnt
                    if pos >= size:
                        break
        elif f in ("lag", "lead"):
            off = 1 if spec.extra is None else spec.extra
            shift = -off if f == "lag" else off
            src_idx = np.arange(n) + shift
            ok = (src_idx >= 0) & (src_idx < n)
            same_part = np.zeros(n, dtype=bool)
            clipped = np.clip(src_idx, 0, max(n - 1, 0))
            if n:
                same_part = ok & (s_codes[clipped] == s_codes)
            fill = spec.default if spec.default is not None else 0
            result = np.where(same_part, vals[clipped] if vals is not None
                              else 0, fill)
            res_valid = same_part & (valid[clipped] if valid is not None
                                     else True)
            if spec.default is not None:
                # rows outside the partition take the default VALUE
                res_valid = res_valid | ~same_part
        elif f in ("first_value", "last_value") and spec.frame is not None:
            starts_f, ends_f = _frame_bounds(spec.frame, boundaries, n)
            empty = starts_f > ends_f
            pick = starts_f if f == "first_value" else ends_f
            pick = np.clip(pick, 0, max(n - 1, 0))
            result = vals[pick] if vals is not None else np.zeros(n)
            res_valid = (valid[pick] if valid is not None
                         else np.ones(n, dtype=bool)) & ~empty
        elif f in ("first_value", "last_value"):
            if f == "first_value":
                result = vals[part_start] if vals is not None else None
                res_valid = valid[part_start]
            else:
                # default frame: last_value = current row (with ORDER BY)
                if spec.order_by:
                    result = vals
                    res_valid = valid
                else:
                    part_end = np.zeros(n, dtype=np.int64)
                    ends = np.flatnonzero(
                        np.concatenate([boundaries[1:], [True]]))
                    starts = np.flatnonzero(boundaries)
                    for st, en in zip(starts, ends):
                        part_end[st:en + 1] = en
                    result = vals[part_end]
                    res_valid = valid[part_end]
        elif spec.frame is not None:  # framed count/sum/min/max/avg
            result, res_valid = _window_agg_framed(
                f, vals, valid, boundaries, spec.frame, n,
                integer=spec.type.is_integer)
        else:  # count/sum/min/max/avg, default frame
            running = bool(spec.order_by)
            result, res_valid = _window_agg(
                f, vals, valid, boundaries, same_peer, running, n,
                integer=spec.type.is_integer)

        # scatter back to original row order; integer window results stay
        # in int64 end-to-end (no 2^53 float63 rounding)
        t = spec.type
        result = np.asarray(result)
        dtype = np.int64 if (t.is_integer or t.is_string) else np.float64
        final = np.zeros(n, dtype=dtype)
        final_valid = np.ones(n, dtype=bool)
        final[order] = result.astype(dtype)
        final_valid[order] = res_valid
        if t.is_string and spec.arg is not None:
            # min/max/lag over strings: results are dictionary codes
            data = final.astype(np.int32)
            return Column(t, data,
                          None if final_valid.all() else final_valid,
                          arg_col.dictionary)
        data = final.astype(t.np_dtype)
        return Column(t, data, None if final_valid.all() else final_valid)


def _window_agg(f, vals, valid, boundaries, same_peer,
                running: bool, n: int, integer: bool = False):
    # python-int accumulation keeps integer sums exact past 2^53
    result = np.zeros(n, dtype=np.int64 if integer else np.float64)
    res_valid = np.ones(n, dtype=bool)
    acc_sum = 0 if integer else 0.0
    acc_cnt = 0
    acc_min = None
    acc_max = None
    for i in range(n):
        if boundaries[i]:
            acc_sum = 0 if integer else 0.0
            acc_cnt, acc_min, acc_max = 0, None, None
        if vals is not None and (valid is None or valid[i]):
            v = int(vals[i]) if integer else float(vals[i])
            acc_sum += v
            acc_cnt += 1
            acc_min = v if acc_min is None else min(acc_min, v)
            acc_max = v if acc_max is None else max(acc_max, v)
        elif vals is None:
            acc_cnt += 1
        if f == "count":
            result[i] = acc_cnt
        elif f == "sum":
            result[i] = acc_sum
            res_valid[i] = acc_cnt > 0
        elif f == "avg":
            result[i] = acc_sum / acc_cnt if acc_cnt else 0.0
            res_valid[i] = acc_cnt > 0
        elif f == "min":
            result[i] = acc_min if acc_min is not None else 0
            res_valid[i] = acc_min is not None
        elif f == "max":
            result[i] = acc_max if acc_max is not None else 0
            res_valid[i] = acc_max is not None
    if not running:
        # whole-partition value = the partition's last running value
        ends = np.flatnonzero(np.concatenate([boundaries[1:], [True]]))
        starts = np.flatnonzero(boundaries)
        for st, en in zip(starts, ends):
            result[st:en + 1] = result[en]
            res_valid[st:en + 1] = res_valid[en]
    else:
        # peers share the frame end (RANGE semantics): each peer group
        # takes its LAST member's running value (backward pass)
        i = n - 1
        while i > 0:
            if same_peer[i]:
                j = i
                while j > 0 and same_peer[j]:
                    j -= 1
                result[j:i] = result[i]
                res_valid[j:i] = res_valid[i]
                i = j - 1
            else:
                i -= 1
    return result, res_valid


def _frame_bounds(frame, boundaries, n):
    """Per-row inclusive [start, end] row indexes of a ROWS frame,
    clamped to the row's partition."""
    part_start = np.maximum.accumulate(
        np.where(boundaries, np.arange(n), 0))
    part_end = np.zeros(n, dtype=np.int64)
    ends = np.flatnonzero(np.concatenate([boundaries[1:], [True]]))
    starts = np.flatnonzero(boundaries)
    for st, en in zip(starts, ends):
        part_end[st:en + 1] = en
    idx = np.arange(n)
    s_off, e_off = frame
    lo = part_start if s_off is None else np.maximum(part_start,
                                                     idx + s_off)
    hi = part_end if e_off is None else np.minimum(part_end, idx + e_off)
    return lo, hi


def _window_agg_framed(f, vals, valid, boundaries, frame, n,
                       integer: bool = False):
    """ROWS-framed aggregates: prefix sums give count/sum/avg in O(n);
    min/max reduce each frame slice directly (frames are small in
    practice — bounded by the offsets)."""
    lo, hi = _frame_bounds(frame, boundaries, n)
    empty = lo > hi
    result = np.zeros(n, dtype=np.int64 if integer else np.float64)
    res_valid = np.ones(n, dtype=bool)
    if vals is None:    # count(*)
        result = np.where(empty, 0, hi - lo + 1)
        return result, res_valid
    v_ok = valid if valid is not None else np.ones(n, dtype=bool)
    if f in ("count", "sum", "avg"):
        acc = np.where(v_ok, vals, 0)
        ps = np.concatenate([[0], np.cumsum(
            acc.astype(np.int64 if integer else np.float64))])
        pc = np.concatenate([[0], np.cumsum(v_ok.astype(np.int64))])
        lo_c = np.clip(lo, 0, n)
        hi_c = np.clip(hi + 1, 0, n)
        cnt = np.where(empty, 0, pc[hi_c] - pc[lo_c])
        if f == "count":
            return cnt, res_valid
        ssum = np.where(empty, 0, ps[hi_c] - ps[lo_c])
        if f == "sum":
            return ssum, cnt > 0
        with np.errstate(invalid="ignore", divide="ignore"):
            av = np.where(cnt > 0, ssum / np.maximum(cnt, 1), 0.0)
        return av, cnt > 0
    # min/max. Unbounded sides use per-partition prefix/suffix scans
    # (O(n)); only genuinely bounded two-sided frames take the per-row
    # slice loop, whose width is capped by the constant offsets.
    s_off, e_off = frame
    if integer:   # int64 end-to-end: float64 would round past 2^53
        iv = vals.astype(np.int64)
        info = np.iinfo(np.int64)
        sent_min = np.where(v_ok, iv, info.max)
        sent_max = np.where(v_ok, iv, info.min)
    else:
        fv = vals.astype(np.float64)
        sent_min = np.where(v_ok, fv, np.inf)
        sent_max = np.where(v_ok, fv, -np.inf)
    pc = np.concatenate([[0], np.cumsum(v_ok.astype(np.int64))])
    lo_c = np.clip(lo, 0, n)
    hi_c = np.clip(hi + 1, 0, n)
    any_valid = (pc[hi_c] - pc[lo_c]) > 0
    res_valid = any_valid & ~empty

    def scan_fwd(a, op):
        out = a.copy()
        for i in range(1, n):
            if not boundaries[i]:
                out[i] = op(out[i], out[i - 1])
        return out

    def scan_bwd(a, op):
        out = a.copy()
        part_next = np.concatenate([boundaries[1:], [True]])
        for i in range(n - 2, -1, -1):
            if not part_next[i]:
                out[i] = op(out[i], out[i + 1])
        return out

    npop = np.minimum if f == "min" else np.maximum
    src = sent_min if f == "min" else sent_max
    if s_off is None and e_off is None:
        run = scan_fwd(src, npop)
        ends = np.flatnonzero(np.concatenate([boundaries[1:], [True]]))
        starts = np.flatnonzero(boundaries)
        for st, en in zip(starts, ends):
            run[st:en + 1] = run[en]
        result = run
    elif s_off is None:
        run = scan_fwd(src, npop)          # min/max from partition start
        result = run[np.clip(hi, 0, n - 1)]
    elif e_off is None:
        run = scan_bwd(src, npop)          # min/max to partition end
        result = run[np.clip(lo, 0, n - 1)]
    else:
        result = np.zeros(n, dtype=src.dtype)
        for i in range(n):
            if not res_valid[i]:
                continue
            sl = slice(int(lo[i]), int(hi[i]) + 1)
            result[i] = src[sl].min() if f == "min" else src[sl].max()
    result = np.where(res_valid, result, 0)
    if integer:
        result = result.astype(np.int64)
    return result, res_valid
