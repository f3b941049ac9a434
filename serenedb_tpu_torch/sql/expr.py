"""Copied from serenedb_tpu/sql/expr.py.

Bound (typed) expressions with CPU evaluation.

The CPU path is the exactness/parity oracle (PG three-valued NULL logic,
sorted-dictionary string comparisons); exec/device.py compiles the numeric
subset of the same IR to jnp for the TPU path, and test parity between the
two is part of the test strategy (SURVEY.md §4: `any/` files must match PG).

Evaluation operates on columnar.Batch and returns columnar.Column.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column, _encode_dictionary


class BoundExpr:
    type: dt.SqlType

    def eval(self, batch: Batch) -> Column:
        raise NotImplementedError

    def children(self) -> list["BoundExpr"]:
        return []

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()


@dataclass
class BoundLiteral(BoundExpr):
    value: Any
    type: dt.SqlType

    def eval(self, batch: Batch) -> Column:
        return Column.const(self.value, batch.num_rows, self.type)


@dataclass
class BoundColumn(BoundExpr):
    index: int
    type: dt.SqlType
    name: str

    def eval(self, batch: Batch) -> Column:
        return batch.columns[self.index]


@dataclass
class BoundFunc(BoundExpr):
    name: str
    args: list[BoundExpr]
    type: dt.SqlType
    fn: Callable  # (list[Column], Batch) -> Column

    def eval(self, batch: Batch) -> Column:
        return self.fn([a.eval(batch) for a in self.args], batch)

    def children(self):
        return self.args


@dataclass
class BoundCase(BoundExpr):
    branches: list[tuple[BoundExpr, BoundExpr]]
    else_: Optional[BoundExpr]
    type: dt.SqlType

    def eval(self, batch: Batch) -> Column:
        """Lazy, per-row-masked evaluation (PG semantics): a branch's
        condition runs only over still-undecided rows and its value only
        over the rows that branch selected, so errors in untaken branches
        never fire (CASE WHEN x <> 0 THEN y/x ... must not divide by the
        zeros)."""
        n = batch.num_rows
        decided = np.zeros(n, dtype=bool)
        result_vals: list = [None] * n
        for cond, val in self.branches:
            undecided = ~decided
            if not undecided.any():
                break
            all_rows = bool(undecided.all())
            sub = batch if all_rows else batch.filter(undecided)
            rows = np.flatnonzero(undecided)
            c = cond.eval(sub)
            hitl = c.valid_mask() & c.data.astype(bool)
            if hitl.any():
                hit_rows = rows[hitl]
                subhit = sub if hitl.all() else sub.filter(hitl)
                vals = val.eval(subhit).to_pylist()
                for j, i in enumerate(hit_rows):
                    result_vals[i] = vals[j]
                decided[hit_rows] = True
        if self.else_ is not None:
            rest = ~decided
            if rest.any():
                sub = batch if rest.all() else batch.filter(rest)
                vals = self.else_.eval(sub).to_pylist()
                for j, i in enumerate(np.flatnonzero(rest)):
                    result_vals[i] = vals[j]
        return Column.from_pylist(result_vals, self.type)

    def children(self):
        out = [c for b in self.branches for c in b]
        if self.else_ is not None:
            out.append(self.else_)
        return out


@dataclass
class BoundAggRef(BoundExpr):
    """Placeholder referencing the i-th aggregate result inside post-agg
    projections (HAVING / select exprs over aggregates)."""
    index: int
    type: dt.SqlType

    def eval(self, batch: Batch) -> Column:
        # post-aggregation batches carry agg results as columns named #agg{i}
        return batch.column(f"#agg{self.index}")


@dataclass
class AggSpec:
    """One aggregate computation: func over an argument expression."""
    func: str                      # count/sum/min/max/avg/count_star/...
    arg: Optional[BoundExpr]
    distinct: bool
    type: dt.SqlType
    sep: Optional[str] = None      # string_agg separator
    filter: Optional[BoundExpr] = None   # FILTER (WHERE ...) predicate
    order_by: Optional[list] = None      # [(BoundExpr, desc)] agg ORDER BY


# -- NULL-aware kernels used by the function library -----------------------

def kleene_and(cols: list[Column]) -> Column:
    """SQL three-valued AND: FALSE dominates NULL."""
    n = len(cols[0])
    any_false = np.zeros(n, dtype=bool)
    any_null = np.zeros(n, dtype=bool)
    for c in cols:
        v = c.data.astype(bool)
        cv = c.valid_mask()
        any_false |= cv & ~v
        any_null |= ~cv
    value = ~any_false
    valid = any_false | ~any_null
    return Column(dt.BOOL, value & valid, None if valid.all() else valid)


def kleene_or(cols: list[Column]) -> Column:
    """SQL three-valued OR: TRUE dominates NULL."""
    n = len(cols[0])
    any_true = np.zeros(n, dtype=bool)
    any_null = np.zeros(n, dtype=bool)
    for c in cols:
        v = c.data.astype(bool)
        cv = c.valid_mask()
        any_true |= cv & v
        any_null |= ~cv
    valid = any_true | ~any_null
    return Column(dt.BOOL, any_true, None if valid.all() else valid)


def propagate_nulls(cols: list[Column]) -> Optional[np.ndarray]:
    """Standard strict-function null propagation: NULL in → NULL out."""
    validity = None
    for c in cols:
        if c.validity is not None:
            validity = c.validity if validity is None else (validity & c.validity)
    return validity


def string_values(col: Column) -> np.ndarray:
    """Materialize VARCHAR column as numpy str array (CPU string ops)."""
    if col.dictionary is None:
        return col.data.astype(str)
    return col.dictionary.astype(str)[col.data]


def make_string_column(strs: np.ndarray, validity: Optional[np.ndarray]) -> Column:
    dictionary, codes = _encode_dictionary([str(s) for s in strs])
    return Column(dt.VARCHAR, codes, validity, dictionary)
