"""Copied from serenedb_tpu/sql/binder.py.

Name resolution and type checking: AST → bound expressions.

Reference analog: DuckDB's Binder (the reference's L3; SURVEY.md §3.2 —
"binding pins a catalog::Snapshot"). Here binding resolves against a Scope
of named/typed columns produced by the FROM clause, folds literals, resolves
functions through the registry, and rewrites aggregate calls into AggSpec +
BoundAggRef placeholders.
"""

from __future__ import annotations

import copy
import math
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Column
from ..functions import scalar as fnlib
from . import ast
from .expr import (AggSpec, BoundAggRef, BoundCase, BoundColumn, BoundExpr,
                   BoundFunc, BoundLiteral, kleene_and, kleene_or)

def _from_aliases(ref) -> set:
    """Aliases / table names a FROM clause introduces (lowercased)."""
    if ref is None:
        return set()
    if isinstance(ref, ast.JoinRef):
        return _from_aliases(ref.left) | _from_aliases(ref.right)
    if isinstance(ref, ast.NamedTable):
        return {(ref.alias or ref.parts[-1]).lower()}
    if isinstance(ref, (ast.TableFunction, ast.SubqueryRef)):
        name = ref.alias or getattr(ref, "name", None) or "subquery"
        return {str(name).lower()}
    return set()


def _subst_colrefs(node, mapping: dict):
    """Deep-copy an AST substituting ColumnRefs whose part-tuple matches
    `mapping` (case-insensitive exact match) with Literal values
    (correlated-subquery lowering). Descending into a nested SELECT whose
    FROM re-introduces an alias drops the qualified entries that alias
    shadows, so `... EXISTS (SELECT .. FROM t d WHERE d.x ..)` inside a
    correlated subquery binds to the INNER d."""

    def rec(n, mp):
        if isinstance(n, ast.ColumnRef):
            for k, v in mp.items():
                if len(k) == len(n.parts) and \
                        tuple(x.lower() for x in k) == \
                        tuple(x.lower() for x in n.parts):
                    return ast.Literal(v)
            return n
        if isinstance(n, (ast.Select, ast.SetOp)):
            shadowed = _from_aliases(getattr(n, "from_", None))
            inner_mp = {k: v for k, v in mp.items()
                        if len(k) < 2 or k[0].lower() not in shadowed}
            out = copy.copy(n)
            for f in n.__dataclass_fields__:
                setattr(out, f, rec(getattr(n, f), inner_mp))
            return out
        if isinstance(n, list):
            return [rec(x, mp) for x in n]
        if isinstance(n, tuple):
            return tuple(rec(x, mp) for x in n)
        if isinstance(n, dict):
            return {k: rec(v, mp) for k, v in n.items()}
        if isinstance(n, (ast.Expr, ast.Statement, ast.SelectItem,
                          ast.TableRef, ast.OrderItem)):
            out = copy.copy(n)
            for f in n.__dataclass_fields__:
                setattr(out, f, rec(getattr(n, f), mp))
            return out
        return n
    return rec(node, mapping)


AGG_FUNCS = {"count", "sum", "min", "max", "avg", "count_star",
             "stddev", "stddev_samp", "var_samp", "variance",
             "stddev_pop", "var_pop",
             "string_agg", "array_agg", "bool_and", "bool_or", "every"}
AGG_TWO_ARG = {"string_agg"}


@dataclass
class ScopeColumn:
    table: Optional[str]
    name: str
    type: dt.SqlType
    index: int
    #: JOIN USING merges key columns: the non-merged side's copy stays
    #: qualified-resolvable but is skipped for bare names and SELECT *
    hidden: bool = False


@dataclass
class Scope:
    columns: list[ScopeColumn] = field(default_factory=list)

    @staticmethod
    def of(names: list[str], types: list[dt.SqlType],
           table: Optional[str] = None) -> "Scope":
        return Scope([ScopeColumn(table, n, t, i)
                      for i, (n, t) in enumerate(zip(names, types))])

    def resolve(self, parts: list[str]) -> ScopeColumn:
        if len(parts) == 1:
            name = parts[0]
            matches = [c for c in self.columns
                       if c.name.lower() == name.lower() and not c.hidden]
            if not matches:   # only hidden copies exist: take the first
                matches = [c for c in self.columns
                           if c.name.lower() == name.lower()][:1]
        elif len(parts) == 2:
            tbl, name = parts
            matches = [c for c in self.columns
                       if c.name.lower() == name.lower()
                       and c.table and c.table.lower() == tbl.lower()]
        else:
            tbl, name = parts[-2], parts[-1]
            matches = [c for c in self.columns
                       if c.name.lower() == name.lower()
                       and c.table and c.table.lower() == tbl.lower()]
        if not matches:
            raise errors.SqlError(errors.UNDEFINED_COLUMN,
                                  f'column "{".".join(parts)}" does not exist')
        if len(matches) > 1:
            raise errors.SqlError(errors.AMBIGUOUS_COLUMN,
                                  f'column reference "{".".join(parts)}" is ambiguous')
        return matches[0]

    def star_columns(self, table: Optional[str] = None) -> list[ScopeColumn]:
        if table is None:
            return [c for c in self.columns if not c.hidden]
        out = [c for c in self.columns
               if c.table and c.table.lower() == table.lower()]
        if not out:
            raise errors.SqlError(errors.UNDEFINED_TABLE,
                                  f'missing FROM-clause entry for table "{table}"')
        return out


_LIT_TYPE = {bool: dt.BOOL, int: dt.BIGINT, float: dt.DOUBLE, str: dt.VARCHAR}


def literal_type(v) -> dt.SqlType:
    if v is None:
        return dt.NULLTYPE
    if isinstance(v, bool):
        return dt.BOOL
    if isinstance(v, int):
        return dt.INT if -2**31 <= v < 2**31 else dt.BIGINT
    return _LIT_TYPE.get(type(v), dt.VARCHAR)


class ExprBinder:
    """Binds expressions in a scope; collects aggregates when allowed.
    `planner` (when provided) enables uncorrelated subquery expressions."""

    def __init__(self, scope: Scope, params: Optional[list] = None,
                 allow_aggs: bool = False, planner=None):
        self.scope = scope
        self.params = params or []
        self.allow_aggs = allow_aggs
        self.planner = planner
        self.aggs: list[AggSpec] = []
        self._agg_keys: dict[str, int] = {}

    def bind(self, e: ast.Expr) -> BoundExpr:
        if isinstance(e, ast.Literal):
            return BoundLiteral(e.value, literal_type(e.value))
        if isinstance(e, ast.Param):
            if e.index > len(self.params):
                raise errors.SqlError("08P01",
                                      f"no value for parameter ${e.index}")
            v = self.params[e.index - 1]
            return BoundLiteral(v, literal_type(v))
        if isinstance(e, ast.ColumnRef):
            c = self.scope.resolve(e.parts)
            return BoundColumn(c.index, c.type, c.name)
        if isinstance(e, ast.BinaryOp):
            return self._bind_binary(e)
        if isinstance(e, ast.UnaryOp):
            if e.op == "NOT":
                arg = self.bind(e.operand)
                return self._call("opnot", [arg])
            if e.op == "-":
                return self._call("opneg", [self.bind(e.operand)])
            raise errors.unsupported(f"unary {e.op}")
        if isinstance(e, ast.Logical):
            args = [self.bind(a) for a in e.args]
            fn = kleene_and if e.op == "AND" else kleene_or
            def impl(cols, n, _fn=fn):
                return _fn(cols)
            return BoundFunc(e.op.lower(), args, dt.BOOL,
                             lambda cols, b, _fn=fn: _fn(cols))
        if isinstance(e, ast.IsNull):
            arg = self.bind(e.operand)
            neg = e.negated

            def impl(cols, batch, _neg=neg):
                c = cols[0]
                data = c.valid_mask() if _neg else ~c.valid_mask()
                return Column(dt.BOOL, data)
            # the name carries the negation: the device compiler keys on it
            return BoundFunc("is_not_null" if neg else "is_null",
                             [arg], dt.BOOL, impl)
        if isinstance(e, ast.InList):
            return self._bind_in(e)
        if isinstance(e, ast.Between):
            lo = ast.BinaryOp(">=", e.operand, e.low)
            hi = ast.BinaryOp("<=", e.operand, e.high)
            both: ast.Expr = ast.Logical("AND", [lo, hi])
            if e.negated:
                both = ast.UnaryOp("NOT", both)
            return self.bind(both)
        if isinstance(e, ast.Like):
            pattern = e.pattern
            esc = getattr(e, "escape", None)
            if esc is not None and isinstance(pattern, ast.Literal) \
                    and isinstance(pattern.value, str):
                pv = pattern.value
                if esc == "":
                    # ESCAPE '' disables escaping (PG): every character,
                    # including backslash, is literal to the impl
                    pattern = ast.Literal(pv.replace("\\", "\\\\"))
                else:
                    # normalize a custom ESCAPE char to the impl's backslash
                    out = []
                    i = 0
                    while i < len(pv):
                        ch = pv[i]
                        if ch == esc:
                            if i + 1 >= len(pv):
                                raise errors.SqlError(
                                    "22025", "LIKE pattern must not end "
                                    "with escape character")
                            out.append("\\" + pv[i + 1])
                            i += 2
                            continue
                        if ch == "\\":
                            out.append("\\\\")
                        else:
                            out.append(ch)
                        i += 1
                    pattern = ast.Literal("".join(out))
            elif esc is not None:
                raise errors.unsupported(
                    "ESCAPE with a non-constant pattern")
            args = [self.bind(e.operand), self.bind(pattern)]
            negated, ci = e.negated, e.case_insensitive

            def impl(cols, batch, _n=negated, _ci=ci):
                return fnlib.like_impl(cols, batch.num_rows, _n, _ci)
            return BoundFunc("like", args, dt.BOOL, impl)
        if isinstance(e, ast.FuncCall):
            return self._bind_func(e)
        if isinstance(e, ast.Cast):
            return self._bind_cast(e)
        if isinstance(e, ast.Case):
            return self._bind_case(e)
        if isinstance(e, ast.Subquery):
            return self._bind_scalar_subquery(e.query)
        if isinstance(e, ast.InSubquery):
            return self._bind_in_subquery(e)
        if isinstance(e, ast.Exists):
            return self._bind_exists(e)
        if isinstance(e, ast.ArraySubquery):
            return self._bind_array_subquery(e.query)
        if isinstance(e, ast.Star):
            raise errors.syntax("* not allowed here")
        raise errors.unsupported(f"expression {type(e).__name__}")

    def _bind_binary(self, e: ast.BinaryOp) -> BoundExpr:
        if e.op in ("##", "@@", "<->", "<#>", "<=>"):
            # full-text / vector operators — bound by the search layer
            from ..search import sqlfuncs
            return sqlfuncs.bind_operator(self, e)
        left = self.bind(e.left)
        right = self.bind(e.right)
        return self._call(f"op{e.op}", [left, right])

    def _bind_in(self, e: ast.InList) -> BoundExpr:
        operand = self.bind(e.operand)
        items = [self.bind(x) for x in e.items]
        # x IN (a,b,c) == (x=a OR x=b OR x=c) with PG null semantics
        cmps = [self._call("op=", [operand, it]) for it in items]
        if len(cmps) == 1:
            result = cmps[0]
        else:
            result = BoundFunc("or", cmps, dt.BOOL,
                               lambda cols, b: kleene_or(cols))
        if e.negated:
            result = self._call("opnot", [result])
        return result

    def _bind_func(self, e: ast.FuncCall) -> BoundExpr:
        name = e.name
        if name in AGG_FUNCS or (name == "count" and e.star):
            if not self.allow_aggs:
                raise errors.SqlError("42803",
                                      f"aggregate function {name} not allowed here")
            return self._bind_agg(e)
        if getattr(e, "filter", None) is not None:
            raise errors.SqlError(
                "42809",
                f"FILTER specified, but {name} is not an aggregate "
                "function")
        if getattr(e, "agg_order", None):
            raise errors.SqlError(
                "42809",
                f"ORDER BY specified, but {name} is not an ordered-set "
                "aggregate function")
        if name == "coalesce" and len(e.args) > 1:
            # short-circuit form (PG): later arguments must not be
            # evaluated on rows an earlier one already decided —
            # coalesce(x, 1/0) succeeds when x is never NULL
            bound = [self.bind(a) for a in e.args]
            t = dt.unify_all(b.type for b in bound)

            def notnull(b):
                def impl(cols, batch):
                    return Column(dt.BOOL, cols[0].valid_mask())
                return BoundFunc("is_not_null", [b], dt.BOOL, impl)
            return BoundCase([(notnull(b), b) for b in bound[:-1]],
                             bound[-1], t)
        from ..search import sqlfuncs
        if sqlfuncs.is_search_function(name):
            return sqlfuncs.bind_function(self, e)
        args = [self.bind(a) for a in e.args]
        return self._call(name, args)

    def _bind_agg(self, e: ast.FuncCall) -> BoundExpr:
        name = e.name
        if name == "every":   # SQL-standard alias of bool_and
            name = "bool_and"
        if e.star or (name == "count" and not e.args):
            spec = AggSpec("count_star", None, False, dt.BIGINT)
        elif name in AGG_TWO_ARG and len(e.args) == 2:
            arg = self.bind(e.args[0])
            sep_b = self.bind(e.args[1])
            if not isinstance(sep_b, BoundLiteral):
                raise errors.unsupported(
                    f"{name} separator must be a constant")
            out_t = _agg_result_type(name, arg.type)
            # PG: a NULL delimiter concatenates with no separator
            sep = "" if sep_b.value is None else str(sep_b.value)
            spec = AggSpec(name, arg, e.distinct, out_t, sep=sep)
        else:
            if len(e.args) != 1:
                raise errors.unsupported(f"{name} with {len(e.args)} args")
            arg = self.bind(e.args[0])
            out_t = _agg_result_type(name, arg.type)
            spec = AggSpec(name, arg, e.distinct, out_t)
        if getattr(e, "filter", None) is not None:
            spec.filter = self.bind(e.filter)
        if getattr(e, "agg_order", None):
            if name not in ("string_agg", "array_agg"):
                raise errors.unsupported(
                    f"ORDER BY inside {name}()")
            spec.order_by = [(self.bind(oi.expr), oi.desc,
                              oi.nulls_first)
                             for oi in e.agg_order]
        key = repr((spec.func, _expr_key(spec.arg), spec.distinct,
                    spec.sep, _expr_key(spec.filter),
                    tuple((_expr_key(k), d, nf)
                          for k, d, nf in (spec.order_by or []))))
        if key in self._agg_keys:
            idx = self._agg_keys[key]
            return BoundAggRef(idx, self.aggs[idx].type)
        self.aggs.append(spec)
        idx = len(self.aggs) - 1
        self._agg_keys[key] = idx
        return BoundAggRef(idx, spec.type)

    def _bind_cast(self, e: ast.Cast) -> BoundExpr:
        arg = self.bind(e.operand)
        try:
            target = dt.type_from_name(e.type_name)
        except (errors.SqlError, ValueError):
            # user-defined type (enum/domain): resolve via the planner's
            # database handle; enum casts validate labels (22P02)
            r = getattr(self.planner, "resolver", None) if self.planner \
                else None
            db = getattr(r, "db", None) or (r if hasattr(r, "types")
                                            else None)
            if db is None:
                raise
            target, labels = db.resolve_type_name(e.type_name)
            if labels is not None:
                lset = set(labels)
                tname = e.type_name.lower()

                def impl_enum(cols, batch, _t=target):
                    c = cast_column(cols[0], _t)
                    valid = c.valid_mask() if c.validity is not None \
                        else None
                    for i, v in enumerate(c.to_pylist()):
                        if v is None or (valid is not None
                                         and not valid[i]):
                            continue
                        if v not in lset:
                            raise errors.SqlError(
                                "22P02", "invalid input value for enum "
                                f'{tname}: "{v}"')
                    return c
                return BoundFunc("cast", [arg], target, impl_enum)

        def impl(cols, batch, _t=target):
            return cast_column(cols[0], _t)
        return BoundFunc("cast", [arg], target, impl)

    def _bind_case(self, e: ast.Case) -> BoundExpr:
        if e.operand is not None:
            branches = [(ast.BinaryOp("=", e.operand, cond), val)
                        for cond, val in e.branches]
        else:
            branches = e.branches
        bound = [(self.bind(c), self.bind(v)) for c, v in branches]
        else_b = self.bind(e.else_) if e.else_ is not None else None
        # result type unifies over EVERY branch INCLUDING ELSE (PG):
        # CASE WHEN .. THEN 1 ELSE 2.5 END is double precision, never a
        # truncating int
        arms = [v for _, v in bound] + ([else_b] if else_b is not None
                                        else [])
        t = dt.unify_all(v.type for v in arms)
        return BoundCase(bound, else_b, t)

    # -- subqueries --------------------------------------------------------
    # Uncorrelated: planned against their own scope, executed once per
    # statement and cached. Correlated (outer refs): lowered per outer
    # row by literal substitution with a per-key plan cache (below).

    def _subplan(self, query):
        if self.planner is None:
            raise errors.unsupported(
                "subqueries are not allowed in this context")
        return self.planner.plan_select(query)

    # -- correlated subqueries --------------------------------------------
    # The reference executes correlated subqueries via DuckDB's flattening;
    # here the correctness-first fallback is per-outer-row substitution of
    # the correlated column references, replanning the (cached-parse) AST
    # with literals. Uncorrelated subqueries never pay this cost.

    # the pattern matches Scope.resolve's message above — they live in
    # this same module, so wording changes must update both together
    _COLERR = re.compile(r'column "([^"]+)" does not exist')

    def _discover_correlation(self, query):
        """(outer_refs, trial_plan): iteratively plan the subquery,
        resolving each undefined column against the OUTER scope (inner
        scope wins by construction — only columns the inner plan cannot
        resolve are tried outside)."""
        outer_refs: list[list[str]] = []
        while True:
            trial = _subst_colrefs(query, {tuple(r): None
                                           for r in outer_refs})
            try:
                return outer_refs, self.planner.plan_select(trial)
            except errors.SqlError as e:
                if e.sqlstate != errors.UNDEFINED_COLUMN:
                    raise
                m = self._COLERR.search(e.message)
                if m is None:
                    raise
                parts = m.group(1).split(".")
                self.scope.resolve(parts)       # must exist OUTSIDE
                if parts in outer_refs:
                    raise                        # no progress — give up
                outer_refs.append(parts)

    def _correlated_rows(self, query, outer_refs, batch,
                         plan_cache: dict):
        """Execute the subquery once per outer row with the correlated
        refs substituted; yields (row_index, rows). plan_cache persists
        per bound expression so multi-batch execution and repeated keys
        pay one plan+execute per distinct key."""
        from ..exec.plan import ExecContext, check_cancel
        cols = {tuple(r): self.scope.resolve(r) for r in outer_refs}
        for i in range(batch.num_rows):
            check_cancel()
            key_vals = {}
            for parts, sc in cols.items():
                c = batch.columns[sc.index]
                v = None if (c.validity is not None and
                             not c.validity[i]) else c.decode(i)
                if isinstance(v, np.generic):
                    v = v.item()
                key_vals[parts] = v
            cache_key = tuple(sorted(key_vals.items()))
            rows = plan_cache.get(cache_key)
            if rows is None:
                sub = _subst_colrefs(query, key_vals)
                rows = self.planner.plan_select(sub).execute(
                    ExecContext()).rows()
                plan_cache[cache_key] = rows
            yield i, rows

    def _bind_scalar_subquery(self, query) -> BoundExpr:
        try:
            plan = self._subplan(query)
        except errors.SqlError as e:
            if e.sqlstate != errors.UNDEFINED_COLUMN:
                raise
            return self._bind_correlated_scalar(query)
        if len(plan.types) != 1:
            raise errors.SqlError("42601",
                                  "subquery must return only one column")
        t = plan.types[0]
        cache: list = []

        def impl(cols, batch, _plan=plan, _t=t, _cache=cache):
            if not _cache:
                from ..exec.plan import ExecContext
                rows = _plan.execute(ExecContext()).rows()
                if len(rows) > 1:
                    raise errors.SqlError(
                        "21000",
                        "more than one row returned by a subquery used as "
                        "an expression")
                _cache.append(rows[0][0] if rows else None)
            return Column.const(_cache[0], batch.num_rows, _t)
        return BoundFunc("scalar_subquery", [], t, impl)

    def _bind_array_subquery(self, query) -> BoundExpr:
        """ARRAY(SELECT ...) → JSON-array string (the array physical
        representation), correlated or not."""
        import json as _json
        try:
            plan = self._subplan(query)
        except errors.SqlError as e:
            if e.sqlstate != errors.UNDEFINED_COLUMN:
                raise
            outer_refs, trial = self._discover_correlation(query)
            if len(trial.types) != 1:
                raise errors.SqlError(
                    "42601", "subquery must return only one column")

            plan_cache: dict = {}

            def impl_corr(cols, batch, _q=query, _refs=outer_refs,
                          _pc=plan_cache):
                out = [None] * batch.num_rows
                for i, rows in self._correlated_rows(_q, _refs, batch, _pc):
                    out[i] = _json.dumps([r[0] for r in rows])
                from .expr import make_string_column
                return make_string_column(
                    np.asarray(out, dtype=object).astype(str), None)
            return BoundFunc("array_subquery", [], dt.VARCHAR, impl_corr)
        if len(plan.types) != 1:
            raise errors.SqlError("42601",
                                  "subquery must return only one column")
        cache: list = []

        def impl(cols, batch, _plan=plan, _cache=cache):
            if not _cache:
                from ..exec.plan import ExecContext
                rows = _plan.execute(ExecContext()).rows()
                _cache.append(_json.dumps([r[0] for r in rows]))
            return Column.const(_cache[0], batch.num_rows, dt.VARCHAR)
        return BoundFunc("array_subquery", [], dt.VARCHAR, impl)

    def _bind_correlated_scalar(self, query) -> BoundExpr:
        outer_refs, trial = self._discover_correlation(query)
        if len(trial.types) != 1:
            raise errors.SqlError("42601",
                                  "subquery must return only one column")
        t = trial.types[0]

        _pc: dict = {}

        def impl(cols, batch, _q=query, _refs=outer_refs, _t=t):
            out = []
            for i, rows in self._correlated_rows(_q, _refs, batch, _pc):
                if len(rows) > 1:
                    raise errors.SqlError(
                        "21000", "more than one row returned by a "
                        "subquery used as an expression")
                out.append(rows[0][0] if rows else None)
            return Column.from_pylist(out, _t)
        return BoundFunc("scalar_subquery", [], t, impl)

    def _bind_in_subquery(self, e) -> BoundExpr:
        try:
            plan = self._subplan(e.query)
        except errors.SqlError as err:
            if err.sqlstate != errors.UNDEFINED_COLUMN:
                raise
            return self._bind_correlated_in(e)
        if len(plan.types) != 1:
            raise errors.SqlError("42601",
                                  "subquery must return only one column")
        operand = self.bind(e.operand)
        negated = e.negated
        cache: list = []

        def impl(cols, batch, _plan=plan, _neg=negated, _cache=cache):
            if not _cache:
                from ..exec.plan import ExecContext
                vals = [r[0] for r in _plan.execute(ExecContext()).rows()]
                _cache.append((set(v for v in vals if v is not None),
                               any(v is None for v in vals)))
            values, has_null = _cache[0]
            x = cols[0]
            import numpy as np
            data = np.zeros(batch.num_rows, dtype=bool)
            valid = np.ones(batch.num_rows, dtype=bool)
            empty = not values and not has_null
            xv = x.to_pylist()
            for i, v in enumerate(xv):
                if v is None:
                    # NULL IN (empty set) is false — there is nothing to
                    # compare against; non-empty sets make it NULL
                    valid[i] = empty
                elif v in values:
                    data[i] = True
                elif has_null:
                    valid[i] = False   # x NOT IN set-with-null → NULL
            if _neg:
                data = ~data & valid
            else:
                data = data & valid
            return Column(dt.BOOL, data,
                          None if valid.all() else valid)
        return BoundFunc("in_subquery", [operand], dt.BOOL, impl)

    def _bind_correlated_in(self, e) -> BoundExpr:
        outer_refs, trial = self._discover_correlation(e.query)
        if len(trial.types) != 1:
            raise errors.SqlError("42601",
                                  "subquery must return only one column")
        operand = self.bind(e.operand)
        negated = e.negated

        _pc: dict = {}

        def impl(cols, batch, _q=e.query, _refs=outer_refs, _neg=negated):
            x = cols[0]
            xv = x.to_pylist()
            data = np.zeros(batch.num_rows, dtype=bool)
            valid = np.ones(batch.num_rows, dtype=bool)
            for i, rows in self._correlated_rows(_q, _refs, batch, _pc):
                vals = [r[0] for r in rows]
                if xv[i] is None:
                    valid[i] = not vals   # NULL IN (empty set) = false
                elif xv[i] in set(v for v in vals if v is not None):
                    data[i] = True
                elif any(v is None for v in vals):
                    valid[i] = False
            if _neg:
                data = ~data & valid
            return Column(dt.BOOL, data,
                          None if valid.all() else valid)
        return BoundFunc("in_subquery", [operand], dt.BOOL, impl)

    def _bind_correlated_exists(self, e) -> BoundExpr:
        outer_refs, _ = self._discover_correlation(e.query)

        _pc: dict = {}

        def impl(cols, batch, _q=e.query, _refs=outer_refs,
                 _neg=e.negated):
            data = np.zeros(batch.num_rows, dtype=bool)
            for i, rows in self._correlated_rows(_q, _refs, batch, _pc):
                data[i] = bool(rows)
            if _neg:
                data = ~data
            return Column(dt.BOOL, data)
        return BoundFunc("exists", [], dt.BOOL, impl)

    def _bind_exists(self, e) -> BoundExpr:
        try:
            plan = self._subplan(e.query)
        except errors.SqlError as err:
            if err.sqlstate != errors.UNDEFINED_COLUMN:
                raise
            return self._bind_correlated_exists(e)
        cache: list = []

        def impl(cols, batch, _plan=plan, _neg=e.negated, _cache=cache):
            if not _cache:
                from ..exec.plan import ExecContext
                _cache.append(_plan.execute(ExecContext()).num_rows > 0)
            v = _cache[0] != _neg
            return Column.const(v, batch.num_rows, dt.BOOL)
        return BoundFunc("exists", [], dt.BOOL, impl)

    #: comparison-family functions whose mixed text/typed operands
    #: coerce the TEXT side toward the typed side at BIND time (PG
    #: unknown-literal resolution). Binding once keeps every consumer —
    #: kernels, is_distinct/nullif, btree/PK/geo index claims — on the
    #: same coerced operand, and literal casts fold to typed literals.
    _COERCE_CMP = {"op=", "op<>", "op!=", "op<", "op<=", "op>", "op>=",
                   "is_distinct_from", "is_not_distinct_from", "nullif"}
    _COERCIBLE_IDS = (dt.TypeId.DATE, dt.TypeId.TIMESTAMP,
                      dt.TypeId.INTERVAL)

    def _call(self, name: str, args: list[BoundExpr]) -> BoundExpr:
        if name == "opnot":
            def impl(cols, batch):
                c = cols[0]
                return Column(dt.BOOL, ~c.data.astype(bool), c.validity)
            return BoundFunc("not", args, dt.BOOL, impl)
        if name in self._COERCE_CMP and len(args) == 2:
            a, b = args
            if a.type.is_string != b.type.is_string:
                typed = b if a.type.is_string else a
                if typed.type.is_numeric or typed.type.id in \
                        self._COERCIBLE_IDS:
                    def coerced(arg, _t=typed.type):
                        def impl(cols, batch):
                            return cast_column(cols[0], _t)
                        return _fold_if_const(
                            BoundFunc("cast", [arg], _t, impl))
                    if a.type.is_string:
                        args = [coerced(a), b]
                    else:
                        args = [a, coerced(b)]
        res = fnlib.resolve(name, [a.type for a in args])

        def impl2(cols, batch, _impl=res.impl):
            return _impl(cols, batch.num_rows)
        f = BoundFunc(name, args, res.result_type, impl2)
        return _fold_if_const(f)


from ..functions.volatility import (IMMUTABLE, VOLATILE,  # noqa: E402
                                    VOLATILE_FUNCS, volatility)

#: never constant-fold: each evaluation must run. Kept as a module
#: attribute because exec/plan.py and exec/morsel.py key off membership;
#: the classification itself lives in functions/volatility.py.
_VOLATILE_FUNCS = VOLATILE_FUNCS


def _fold_if_const(f: BoundFunc) -> BoundExpr:
    # STABLE folds here on purpose: binding happens once per statement,
    # so folding now() at bind time IS its statement-stability (PG
    # evaluates stable functions once per statement too)
    if volatility(f.name) is VOLATILE:
        return f
    if all(isinstance(a, BoundLiteral) for a in f.args):
        from ..columnar.column import Batch
        try:
            col = f.eval(Batch(["__one"], [Column.from_pylist([0])]))
            return BoundLiteral(col.decode(0), f.type)
        except Exception:
            # fold errors (1/0, sqrt(-1), ...) must NOT surface at bind
            # time: PG only raises if the row is actually evaluated —
            # CASE WHEN true THEN 1 ELSE 1/0 END returns 1
            return f
    return f


# -- interval extraction (zone-map predicate analysis) ----------------------
#
# exec/zonemap.py turns filter conjuncts into per-block verdicts; these
# helpers own the expression-shape side of that: recognizing a
# `column <cmp> constant` leaf and folding the constant side to a python
# value with the binder's own evaluation semantics.

#: comparison function names the interval analyzer understands, mapped to
#: their mirror when the column sits on the RIGHT (5 < x  ≡  x > 5)
_CMP_MIRROR = {"op=": "op=", "op<>": "op<>", "op!=": "op!=",
               "op<": "op>", "op<=": "op>=", "op>": "op<", "op>=": "op<="}

_CMP_CANON = {"op=": "=", "op<>": "<>", "op!=": "<>", "op<": "<",
              "op<=": "<=", "op>": ">", "op>=": ">="}

_NOT_CONST = object()


def fold_constant(e: BoundExpr):
    """Evaluate a column-free, non-volatile expression to its python
    value (None == SQL NULL). Returns the _NOT_CONST sentinel when the
    expression references columns/aggregates or isn't safely foldable."""
    if isinstance(e, BoundLiteral):
        return e.value
    for sub in e.walk():
        if isinstance(sub, (BoundColumn, BoundAggRef)):
            return _NOT_CONST
        # only IMMUTABLE folds during analysis: a STABLE value folded
        # here could disagree with the per-row evaluation (wall-clock
        # reads, subquery expressions over lazily-cached subplans)
        if isinstance(sub, BoundFunc) and \
                volatility(sub.name) is not IMMUTABLE:
            return _NOT_CONST
    from ..columnar.column import Batch
    try:
        col = e.eval(Batch(["__one"], [Column.from_pylist([0])]))
        if len(col.data) != 1:
            return _NOT_CONST
        return col.decode(0)
    except Exception:
        # fold errors (cast('x' as int), 1/0, ...) leave the leaf opaque
        return _NOT_CONST


def comparison_parts(e: BoundExpr):
    """(column_index, canonical_op, constant) for a comparison leaf of
    shape `column <cmp> constant` (either side), else None. The constant
    is a decoded python value in the column's PHYSICAL value space (str
    for VARCHAR, int days/micros for DATE/TIMESTAMP)."""
    if not isinstance(e, BoundFunc) or e.name not in _CMP_MIRROR or \
            len(e.args) != 2:
        return None
    a, b = e.args
    if isinstance(a, BoundColumn):
        v = fold_constant(b)
        if v is _NOT_CONST:
            return None
        return (a.index, _CMP_CANON[e.name], v)
    if isinstance(b, BoundColumn):
        v = fold_constant(a)
        if v is _NOT_CONST:
            return None
        return (b.index, _CMP_CANON[_CMP_MIRROR[e.name]], v)
    return None


def _agg_result_type(name: str, arg_t: dt.SqlType) -> dt.SqlType:
    if name == "count":
        return dt.BIGINT
    if name in ("sum", "avg", "stddev", "stddev_samp", "var_samp",
                "variance", "stddev_pop", "var_pop") and not (
            arg_t.is_numeric or arg_t.id is dt.TypeId.NULL):
        # without this, the engine would silently aggregate dictionary
        # CODES of a string column (PG: 42883 function sum(text)...)
        raise errors.SqlError(
            errors.UNDEFINED_FUNCTION,
            f"function {name}({arg_t.id.name.lower()}) does not exist")
    if name in ("sum",):
        if arg_t.is_integer:
            return dt.BIGINT
        return dt.DOUBLE if arg_t.id is not dt.TypeId.NULL else dt.DOUBLE
    if name in ("avg", "stddev", "stddev_samp", "var_samp", "variance",
                "stddev_pop", "var_pop"):
        return dt.DOUBLE
    if name in ("min", "max"):
        return arg_t
    if name in ("bool_and", "bool_or"):
        if arg_t.id not in (dt.TypeId.BOOL, dt.TypeId.NULL):
            raise errors.SqlError(
                errors.UNDEFINED_FUNCTION,
                f"function {name}({arg_t.id.name.lower()}) does not exist")
        return dt.BOOL
    if name == "string_agg":
        return dt.VARCHAR
    if name == "array_agg":
        return dt.array_of(arg_t)   # physically a JSON-text array
    raise errors.unsupported(f"aggregate {name}")


def _expr_key(e: Optional[BoundExpr]) -> str:
    if e is None:
        return "<star>"
    parts = []
    for node in e.walk():
        if isinstance(node, BoundColumn):
            parts.append(f"col{node.index}")
        elif isinstance(node, BoundLiteral):
            parts.append(f"lit{node.value!r}")
        elif isinstance(node, BoundFunc):
            parts.append(f"fn{node.name}")
        else:
            parts.append(type(node).__name__)
    return "/".join(parts)


_US_PER = {
    "microsecond": 1, "us": 1,
    "millisecond": 1000, "ms": 1000,
    "second": 1_000_000, "sec": 1_000_000, "s": 1_000_000,
    "minute": 60_000_000, "min": 60_000_000,
    "hour": 3_600_000_000, "h": 3_600_000_000, "hr": 3_600_000_000,
    "day": 86_400_000_000, "d": 86_400_000_000,
    "week": 604_800_000_000, "w": 604_800_000_000,
}
_IVAL_PAIR = re.compile(r"([+-]?\d+(?:\.\d+)?)\s*([a-zA-Z]+)")
_IVAL_CLOCK = re.compile(
    r"^([+-])?(\d+):([0-5]?\d)(?::([0-5]?\d)(\.\d+)?)?$")


def parse_interval(text: str) -> int:
    """'1 day 02:30:00', '90 minutes', '1.5 hours' → microseconds.
    Calendar units (month/year) have no fixed length and are rejected
    rather than silently approximated."""
    t = text.strip().lower()
    m = _IVAL_CLOCK.match(t)
    if m:
        sign = -1 if m.group(1) == "-" else 1
        us = (int(m.group(2)) * 3_600_000_000 +
              int(m.group(3)) * 60_000_000 +
              (int(m.group(4)) if m.group(4) else 0) * 1_000_000 +
              (int(round(float(m.group(5)) * 1e6))
               if m.group(5) else 0))
        return sign * us
    total = 0
    matched = 0
    pos = 0
    for m in _IVAL_PAIR.finditer(t):
        if t[pos:m.start()].strip(" ,"):
            raise ValueError(text)
        pos = m.end()
        qty, unit = float(m.group(1)), m.group(2).rstrip("s") \
            if m.group(2) not in ("s", "us", "ms") else m.group(2)
        if unit in ("month", "mon", "year", "yr", "y"):
            raise errors.unsupported(
                "calendar interval units (month/year) — use fixed units "
                "(days/hours/...)")
        if unit not in _US_PER:
            raise ValueError(text)
        # the remainder may be a clock part ('1 day 02:30:00')
        total += int(round(qty * _US_PER[unit]))
        matched += 1
    rest = t[pos:].strip(" ,")
    if rest:
        cm = _IVAL_CLOCK.match(rest)
        if cm is None:
            raise ValueError(text)
        total += parse_interval(rest)
        matched += 1
    if matched == 0:
        raise ValueError(text)
    return total


def format_interval(us: int) -> str:
    """PG-style rendering with PER-COMPONENT signs ('-1 days -02:30:00'):
    a text round-trip through parse_interval is value-preserving."""
    sign = "-" if us < 0 else ""
    us = abs(int(us))
    days, rem = divmod(us, 86_400_000_000)
    h, rem = divmod(rem, 3_600_000_000)
    mi, rem = divmod(rem, 60_000_000)
    se, frac = divmod(rem, 1_000_000)
    parts = []
    if days:
        # PG pluralizes negative day counts ('-1 days -02:00:00')
        parts.append(f"{sign}{days} day" +
                     ("s" if days != 1 or sign else ""))
    if h or mi or se or frac or not days:
        clock = f"{sign}{h:02d}:{mi:02d}:{se:02d}"
        if frac:
            clock += f".{frac:06d}".rstrip("0")
        parts.append(clock)
    return " ".join(parts)


def format_timestamp(us: int) -> str:
    """PG-style timestamp text: microseconds only when non-zero."""
    s = str(np.datetime64(int(us), "us")).replace("T", " ")
    if s.endswith(".000000"):
        return s[:-7]
    return s.rstrip("0") if "." in s else s


def _array_text_to_json(s: str) -> str:
    """Array text input → the physical JSON form. Accepts the JSON form
    itself and PG '{a,b}' literals (quotes, escapes, NULL, nesting);
    anything else is 22P02."""
    import json as _json
    t = s.strip()
    if t.startswith("["):
        try:
            v = _json.loads(t)
            if isinstance(v, list):
                return _json.dumps(v)
        except _json.JSONDecodeError:
            pass
        raise errors.SqlError("22P02", f"invalid array literal: {s!r}")
    if not t.startswith("{"):
        raise errors.SqlError("22P02", f"invalid array literal: {s!r}")

    pos = [0]

    def parse_list():
        assert t[pos[0]] == "{"
        pos[0] += 1
        out = []
        while True:
            while pos[0] < len(t) and t[pos[0]].isspace():
                pos[0] += 1
            if pos[0] >= len(t):
                raise errors.SqlError("22P02",
                                      f"invalid array literal: {s!r}")
            ch = t[pos[0]]
            if ch == "}":
                pos[0] += 1
                return out
            if ch == "{":
                out.append(parse_list())
            elif ch == '"':
                pos[0] += 1
                buf = []
                while pos[0] < len(t) and t[pos[0]] != '"':
                    if t[pos[0]] == "\\" and pos[0] + 1 < len(t):
                        pos[0] += 1
                    buf.append(t[pos[0]])
                    pos[0] += 1
                if pos[0] >= len(t):
                    raise errors.SqlError(
                        "22P02", f"invalid array literal: {s!r}")
                pos[0] += 1
                out.append("".join(buf))
            else:
                j = pos[0]
                while j < len(t) and t[j] not in ",}":
                    j += 1
                token = t[pos[0]:j].strip()
                pos[0] = j
                if token.upper() == "NULL":
                    out.append(None)
                else:
                    try:
                        out.append(int(token))
                    except ValueError:
                        try:
                            out.append(float(token))
                        except ValueError:
                            out.append(token)
            while pos[0] < len(t) and t[pos[0]].isspace():
                pos[0] += 1
            if pos[0] < len(t) and t[pos[0]] == ",":
                pos[0] += 1
            elif pos[0] < len(t) and t[pos[0]] == "}":
                continue
            elif pos[0] >= len(t):
                raise errors.SqlError("22P02",
                                      f"invalid array literal: {s!r}")

    v = parse_list()
    if t[pos[0]:].strip():
        raise errors.SqlError("22P02", f"invalid array literal: {s!r}")
    import json as _json
    return _json.dumps(v)


def cast_column(col: Column, target: dt.SqlType) -> Column:
    """PG-style CAST between supported types."""
    src = col.type
    if src == target:
        return col
    if dt.TypeId.INTERVAL in (src.id, target.id) and not (
            src.is_string or target.is_string or
            src.id is dt.TypeId.NULL):
        # PG: intervals cast only to/from text (42846) — reinterpreting
        # µs as days/epochs would produce silent garbage
        raise errors.SqlError(
            "42846", f"cannot cast type {src} to {target}")
    validity = col.validity
    _REG = (dt.TypeId.REGCLASS, dt.TypeId.REGTYPE, dt.TypeId.REGPROC,
            dt.TypeId.REGNAMESPACE)
    if target.id in _REG and src.is_string:
        # name → oid resolution against the live catalog ('t'::regclass)
        from ..pgcatalog import (current_db, resolve_namespace_oid,
                                 resolve_proc_oid, resolve_type_oid)
        db = current_db()
        vals = col.to_pylist()
        out = np.zeros(len(vals), dtype=np.int64)
        for i, v in enumerate(vals):
            if v is None:
                continue
            s = str(v).strip()
            if s.lstrip("-").isdigit():
                out[i] = int(s)
            elif target.id is dt.TypeId.REGTYPE:
                out[i] = resolve_type_oid(s)
            elif target.id is dt.TypeId.REGPROC:
                out[i] = resolve_proc_oid(s)
            elif target.id is dt.TypeId.REGNAMESPACE:
                out[i] = resolve_namespace_oid(db, s)
            else:
                if db is None:
                    raise errors.SqlError(errors.UNDEFINED_TABLE,
                                          f'relation "{s}" does not exist')
                out[i] = db.resolve_relation_oid(s)
        return Column(target, out, validity)
    if src.id in _REG and target.is_string:
        from ..pgcatalog import (current_db, namespace_render, proc_name_of,
                                 regclass_render, regtype_render)
        db = current_db()
        vals = col.to_pylist()
        out = []
        for v in vals:
            if v is None:
                out.append("")
            elif src.id is dt.TypeId.REGTYPE:
                out.append(regtype_render(int(v)))
            elif src.id is dt.TypeId.REGPROC:
                out.append(proc_name_of(v) or str(int(v)))
            elif src.id is dt.TypeId.REGNAMESPACE:
                out.append(namespace_render(db, int(v)))
            else:
                out.append(regclass_render(db, int(v)))
        from .expr import make_string_column
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  validity)
    if target.id is dt.TypeId.ARRAY:
        # array targets carry the ARRAY type (the generic to-string
        # branch below would degrade INT[] to VARCHAR on INSERT); text
        # input is normalized: PG '{...}' literals parse to the physical
        # JSON form, JSON arrays pass through, garbage raises 22P02
        if src.id is dt.TypeId.ARRAY:
            return Column(target, col.data, validity, col.dictionary)
        if src.is_string:
            from .expr import make_string_column, string_values
            vals = string_values(col)
            ok = col.valid_mask()
            out = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                out[i] = _array_text_to_json(str(v)) if ok[i] else ""
            c2 = make_string_column(out, validity)
            return Column(target, c2.data, validity, c2.dictionary)
        raise errors.SqlError(
            "42846", f"cannot cast type {src} to {target}")
    if target.is_string:
        if src.id is dt.TypeId.TIMESTAMP:
            out = [format_timestamp(v) for v in col.data]
            from .expr import make_string_column
            return make_string_column(
                np.asarray(out, dtype=object).astype(str), validity)
        if src.id is dt.TypeId.DATE:
            out = [str(np.datetime64(int(v), "D")) for v in col.data]
            from .expr import make_string_column
            return make_string_column(
                np.asarray(out, dtype=object).astype(str), validity)
        if src.id is dt.TypeId.INTERVAL:
            out = [format_interval(int(v)) for v in col.data]
            from .expr import make_string_column
            return make_string_column(
                np.asarray(out, dtype=object).astype(str), validity)
        vals = col.to_pylist()
        out = ["" if v is None else _cast_to_text(v, src) for v in vals]
        from .expr import make_string_column
        return make_string_column(np.asarray(out, dtype=object).astype(str),
                                  validity)
    if src.is_string:
        vals = col.to_pylist()
        out = []
        for v in vals:
            if v is None:
                out.append(None)
            else:
                out.append(_cast_text_to(v, target))
        return Column.from_pylist(out, target)
    if target.id is dt.TypeId.BOOL:
        return Column(target, col.data.astype(bool), validity)
    if target.is_integer:
        info = np.iinfo(target.np_dtype)
        if src.is_float:
            # PG rounds half away from zero (np.round is half-to-even).
            # Upper bound compares against max+1 (exactly representable in
            # float64): 'rounded > float(2**63-1)' would promote the bound
            # to 2.0**63 and let exactly-2**63 slip through and wrap
            x = col.data
            rounded = np.sign(x) * np.floor(np.abs(x) + 0.5)
            bad = (rounded < float(info.min)) | \
                (rounded >= float(info.max) + 1.0) | np.isnan(x)
            # zero out-of-range slots before astype: NULL rows may carry
            # arbitrary fill values that would wrap or warn
            data = np.where(bad | ~np.isfinite(rounded),
                            0.0, rounded).astype(target.np_dtype)
        else:
            x64 = col.data.astype(np.int64)
            bad = (x64 < info.min) | (x64 > info.max)
            data = x64.astype(target.np_dtype)
        if validity is not None:
            bad = bad & col.valid_mask()
        if bad.any():
            kind = {np.dtype(np.int16): "smallint",
                    np.dtype(np.int32): "integer"}.get(
                np.dtype(target.np_dtype), "bigint")
            raise errors.SqlError("22003", f"{kind} out of range")
        return Column(target, data, validity)
    if target.is_float:
        return Column(target, col.data.astype(target.np_dtype), validity)
    if src.id is dt.TypeId.DATE and target.id is dt.TypeId.TIMESTAMP:
        # days → µs at midnight (NOT a raw reinterpretation)
        data = col.data.astype(np.int64) * 86_400_000_000
        return Column(target, data, validity)
    if src.id is dt.TypeId.TIMESTAMP and target.id is dt.TypeId.DATE:
        # µs → days, flooring (negative timestamps floor toward -∞)
        data = np.floor_divide(col.data.astype(np.int64),
                               86_400_000_000).astype(np.int32)
        return Column(target, data, validity)
    if target.id in (dt.TypeId.TIMESTAMP, dt.TypeId.DATE,
                     dt.TypeId.INTERVAL):
        if src.id not in (dt.TypeId.TIMESTAMP, dt.TypeId.DATE,
                          dt.TypeId.INTERVAL, dt.TypeId.NULL):
            raise errors.SqlError(
                "42846", f"cannot cast type {src} to {target}")
        return Column(target, col.data.astype(target.np_dtype), validity)
    raise errors.unsupported(f"cast {src} -> {target}")


def _cast_to_text(v, src: dt.SqlType) -> str:
    if src.id is dt.TypeId.INTERVAL:
        return format_interval(int(v))
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        if v == int(v) and abs(v) < 1e15:
            return f"{v:.1f}" if "." not in repr(v) else repr(v)
        return repr(v)
    return str(v)


def _cast_text_to(v: str, target: dt.SqlType):
    s = v.strip()
    try:
        if target.id is dt.TypeId.BOOL:
            if s.lower() in ("t", "true", "yes", "on", "1"):
                return True
            if s.lower() in ("f", "false", "no", "off", "0"):
                return False
            raise ValueError(s)
        if target.is_integer:
            # PG: text→int accepts only an optional sign + digits; '2.7'
            # is 22P02, never a silent truncation
            if not re.fullmatch(r"[+-]?\d+", s):
                raise ValueError(s)
            return int(s)
        if target.is_float:
            return float(s)
        if target.id is dt.TypeId.TIMESTAMP:
            ts64 = np.datetime64(s)
            if np.isnat(ts64):
                raise ValueError(s)   # '' parses as NaT — PG: 22007
            return int(ts64.astype("datetime64[us]").astype(np.int64))
        if target.id is dt.TypeId.DATE:
            d64 = np.datetime64(s, "D")
            if np.isnat(d64):
                raise ValueError(s)
            return int(d64.astype(np.int64))
        if target.id is dt.TypeId.INTERVAL:
            return parse_interval(s)
    except ValueError:
        raise errors.SqlError(errors.INVALID_TEXT_REPRESENTATION,
                              f'invalid input syntax for type {target}: "{v}"')
    raise errors.unsupported(f"cast text -> {target}")
