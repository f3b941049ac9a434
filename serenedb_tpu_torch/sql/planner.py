"""Copied from serenedb_tpu/sql/planner.py.

Logical planning: bound SELECT → physical plan tree.

Reference analog: DuckDB planner/optimizer plus SereneDB's optimizer
extensions that claim WHERE conjuncts into the scan
(IResearchPushdownComplexFilter, reference:
server/connector/optimizer/iresearch_plan.cpp:1016-1058). Re-expressed here:
filter conjuncts land in ScanNode.filter (device compilation fuses them into
the scan program), projection pruning keeps the HBM working set minimal, and
ORDER BY / GROUP BY resolve select aliases and positions per PG scoping.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column
from ..exec.plan import (AggregateNode, DropColumnsNode, FilterNode, JoinNode,
                         LimitNode, PlanNode, ProjectNode, ScanNode, SortNode,
                         ValuesNode)
from ..exec.tables import TableProvider
from . import ast
from .binder import AGG_FUNCS, ExprBinder, Scope, ScopeColumn
from .expr import (BoundAggRef, BoundCase, BoundColumn, BoundExpr, BoundFunc,
                   BoundLiteral, kleene_and)


class TableResolver:
    """Interface the planner uses to find tables/table functions."""

    def resolve_table(self, parts: list[str]) -> TableProvider:
        raise NotImplementedError

    def resolve_table_function(self, name: str, args: list) -> TableProvider:
        raise NotImplementedError


@dataclass
class _GroupRef(BoundExpr):
    """Placeholder for a group-key column in post-aggregation expressions."""
    slot: int
    type: dt.SqlType


class PostAggBinder(ExprBinder):
    """Binds post-aggregation expressions (select items, HAVING, ORDER BY):
    group-expression matches become _GroupRef, aggregate calls become
    BoundAggRef (collected), any other bare column is a PG 42803 error."""

    def __init__(self, scope: Scope, params, group_asts: list[ast.Expr],
                 group_types: list[dt.SqlType]):
        super().__init__(scope, params, allow_aggs=True)
        self.group_asts = group_asts
        self.group_types = group_types
        self._in_agg = False

    def bind(self, e: ast.Expr) -> BoundExpr:
        if self._in_agg:
            # inside an aggregate argument: plain base-scope binding
            if isinstance(e, ast.FuncCall) and (e.name in AGG_FUNCS or e.star):
                raise errors.SqlError(
                    "42803", "aggregate function calls cannot be nested")
            return super().bind(e)
        for k, g in enumerate(self.group_asts):
            if _ast_eq(e, g):
                return _GroupRef(k, self.group_types[k])
        if isinstance(e, ast.FuncCall) and (e.name in AGG_FUNCS or e.star):
            self._in_agg = True
            try:
                return self._bind_agg(e)
            finally:
                self._in_agg = False
        if isinstance(e, ast.ColumnRef):
            raise errors.SqlError(
                "42803",
                f'column "{".".join(e.parts)}" must appear in the GROUP BY '
                "clause or be used in an aggregate function")
        return super().bind(e)


def _resolve_post(e: BoundExpr, n_groups: int,
                  out_types: list[dt.SqlType]) -> BoundExpr:
    """Rewrite _GroupRef/BoundAggRef placeholders into BoundColumns over the
    aggregate node's output (groups first, then aggs)."""
    if isinstance(e, _GroupRef):
        return BoundColumn(e.slot, e.type, f"#g{e.slot}")
    if isinstance(e, BoundAggRef):
        return BoundColumn(n_groups + e.index, e.type, f"#agg{e.index}")
    if isinstance(e, BoundFunc):
        e.args = [_resolve_post(a, n_groups, out_types) for a in e.args]
        return e
    if isinstance(e, BoundCase):
        e.branches = [(_resolve_post(c, n_groups, out_types),
                       _resolve_post(v, n_groups, out_types))
                      for c, v in e.branches]
        if e.else_ is not None:
            e.else_ = _resolve_post(e.else_, n_groups, out_types)
        return e
    return e


def _references_cte(node, key: str, depth: int = 0) -> bool:
    """Does the AST subtree reference table `key`? (Generic dataclass
    walk — used to decide whether a WITH RECURSIVE member actually
    iterates.) A nested WITH that rebinds the name shadows it."""
    import dataclasses
    if depth > 200 or node is None:
        return False
    if isinstance(node, ast.NamedTable):
        return len(node.parts) == 1 and node.parts[0].lower() == key
    if isinstance(node, (list, tuple)):
        return any(_references_cte(v, key, depth + 1) for v in node)
    if isinstance(node, dict):
        return any(_references_cte(v, key, depth + 1)
                   for v in node.values())
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        if key in {k.lower() for k in getattr(node, "ctes", {})}:
            return False      # shadowed by an inner WITH
        return any(_references_cte(getattr(node, f.name), key, depth + 1)
                   for f in dataclasses.fields(node))
    return False


@dataclass
class _RecursiveIterRef:
    """CTE-map marker: a self-reference inside a recursive step scans
    this iteration working table."""
    provider: "TableProvider"


class Planner:
    def __init__(self, resolver: TableResolver, params: Optional[list] = None):
        self.resolver = resolver
        self.params = params or []
        self.ctes: dict[str, ast.Select] = {}

    def _binder(self, scope: Scope, allow_aggs: bool = False) -> ExprBinder:
        return ExprBinder(scope, self.params, allow_aggs, planner=self)

    # -- FROM --------------------------------------------------------------

    def plan_select(self, sel) -> PlanNode:
        saved = dict(self.ctes)
        try:
            for name, q in getattr(sel, "ctes", {}).items():
                self.ctes[name] = q
            if isinstance(sel, ast.SetOp):
                return self._plan_setop(sel)
            values_rows = getattr(sel, "values_rows", None)
            if values_rows is not None:
                return self._plan_values(values_rows)
            if sel.from_ is None:
                plan: PlanNode = ValuesNode(
                    Batch(["__dummy"], [Column.from_pylist([0])]))
                scope = Scope([])
            else:
                plan, scope = self._plan_from(sel.from_)
            return self._plan_body(sel, plan, scope)
        finally:
            self.ctes = saved

    def _plan_setop(self, s: ast.SetOp) -> PlanNode:
        from ..exec.plan import LimitNode as _Limit
        from ..exec.plan import SetOpNode, SortNode as _Sort
        left = self.plan_select(s.left)
        right = self.plan_select(s.right)
        if len(left.types) != len(right.types):
            raise errors.SqlError(
                "42601", "each %s query must have the same number of "
                "columns" % s.op.upper())
        plan: PlanNode = SetOpNode(s.op, s.all, left, right)
        if s.order_by:
            indices, descs, nfs = [], [], []
            for oi in s.order_by:
                descs.append(oi.desc)
                nfs.append(oi.nulls_first)
                e = oi.expr
                if isinstance(e, ast.Literal) and isinstance(e.value, int):
                    if not (1 <= e.value <= len(plan.names)):
                        raise errors.SqlError(
                            "42P10",
                            f"ORDER BY position {e.value} is out of range")
                    indices.append(e.value - 1)
                elif isinstance(e, ast.ColumnRef) and len(e.parts) == 1 and \
                        e.parts[0].lower() in [n.lower() for n in plan.names]:
                    indices.append([n.lower() for n in plan.names]
                                   .index(e.parts[0].lower()))
                else:
                    raise errors.unsupported(
                        "ORDER BY over a set operation must use output "
                        "column names or positions")
            plan = _Sort(plan, indices, descs, nfs)
        if s.limit is not None or s.offset is not None:
            limit = _const_int(s.limit, self.params) \
                if s.limit is not None else None
            offset = _const_int(s.offset, self.params) \
                if s.offset is not None else 0
            plan = _Limit(plan, limit, offset)
        return plan

    def _plan_values(self, rows: list[list[ast.Expr]]) -> PlanNode:
        binder = self._binder(Scope([]))
        cols = []
        width = len(rows[0])
        one = Batch(["__dummy"], [Column.from_pylist([0])])
        from ..exec.plan import _unify_setop_type
        from .binder import cast_column
        for k in range(width):
            exprs = [binder.bind(r[k]) for r in rows]
            vals = [e.eval(one).decode(0) for e in exprs]
            # unify across ALL rows (PG: VALUES (1), (2.5) is numeric,
            # not the first row's int). A string literal mixed with one
            # typed row acts as PG's unknown literal: it coerces toward
            # the typed side instead of failing the unification.
            t = dt.NULLTYPE
            strings_seen = False
            for e in exprs:
                et = e.type
                if et.id is dt.TypeId.NULL:
                    continue
                if et.is_string and not (t.is_string or
                                         t.id is dt.TypeId.NULL):
                    strings_seen = True
                    continue
                if t.is_string and not et.is_string:
                    strings_seen = True
                    t = et
                    continue
                t = _unify_setop_type(t, et)
            if strings_seen and not t.is_string:
                col = Column.from_pylist(vals, dt.VARCHAR)
                cols.append(cast_column(col, t))
            else:
                cols.append(Column.from_pylist(vals, t))
        return ValuesNode(Batch([f"col{k}" for k in range(width)], cols))

    def _plan_cte_def(self, key: str, cte: ast.CteDef) -> PlanNode:
        """Plan a CTE with a column list and/or RECURSIVE semantics."""
        from ..exec.plan import RecursiveCteNode, RenameNode
        from ..exec.tables import MemTable
        # WITH RECURSIVE marks the whole WITH list; a member is only
        # iterated when it actually references itself
        if not cte.recursive or not _references_cte(cte.query, key):
            self.ctes.pop(key)
            try:
                inner = self.plan_select(cte.query)
            finally:
                self.ctes[key] = cte
            return RenameNode(inner, cte.cols) if cte.cols else inner
        body = cte.query
        if not isinstance(body, ast.SetOp) or body.op != "union":
            raise errors.SqlError(
                "42P19", f'recursive query "{key}" does not have the form '
                "non-recursive-term UNION [ALL] recursive-term")
        # base term: the CTE name must not be visible (self-reference in
        # the base term is 42P19 in PG; here it resolves to 42P01)
        self.ctes.pop(key)
        try:
            base = self.plan_select(body.left)
        finally:
            self.ctes[key] = cte
        names = cte.cols or list(base.names)
        if cte.cols and len(cte.cols) != len(base.names):
            raise errors.SqlError(
                "42P10", f'recursive query "{key}" column list does not '
                "match the number of output columns")
        work = MemTable(key, Batch(list(names),
                                   [Column.from_pylist([], t)
                                    for t in base.types]))
        saved = self.ctes[key]
        self.ctes[key] = _RecursiveIterRef(work)
        try:
            step = self.plan_select(body.right)
        finally:
            self.ctes[key] = saved
        if len(step.types) != len(base.types):
            raise errors.SqlError(
                "42601", "each UNION query must have the same number of "
                "columns")
        return RecursiveCteNode(names, base, step, work, body.all)

    def _scan_scope(self, provider: TableProvider, alias: str):
        scan = ScanNode(provider, list(provider.column_names), alias)
        scope = Scope([ScopeColumn(alias, n, t, i)
                       for i, (n, t) in enumerate(zip(scan.names, scan.types))])
        return scan, scope

    def _plan_from(self, ref: ast.TableRef) -> tuple[PlanNode, Scope]:
        if isinstance(ref, ast.NamedTable):
            if len(ref.parts) == 1 and ref.parts[0].lower() in self.ctes:
                key = ref.parts[0].lower()
                body = self.ctes[key]
                alias = ref.alias or ref.parts[0]
                if isinstance(body, _RecursiveIterRef):
                    # a self-reference inside a recursive step: scan the
                    # iteration's working table
                    return self._scan_scope(body.provider, alias)
                if isinstance(body, ast.CteDef):
                    inner = self._plan_cte_def(key, body)
                else:
                    # shadow the name while planning its body:
                    # non-recursive WITH must not see itself (PG resolves
                    # to 42P01 there)
                    self.ctes.pop(key)
                    try:
                        inner = self.plan_select(body)
                    finally:
                        self.ctes[key] = body
                scope = Scope([ScopeColumn(alias, n, t, i)
                               for i, (n, t) in enumerate(
                                   zip(inner.names, inner.types))])
                return inner, scope
            provider = self.resolver.resolve_table(ref.parts)
            return self._scan_scope(provider, ref.alias or ref.parts[-1])
        if isinstance(ref, ast.TableFunction):
            binder = self._binder(Scope([]))
            args = []
            for a in ref.args:
                b = binder.bind(a)
                if isinstance(b, BoundLiteral):
                    args.append(b.value)
                else:
                    # constant-fold column-free expressions (e.g.
                    # unnest(ARRAY[1,2,3])) on a one-row dummy batch
                    if _refs_columns(b):
                        raise errors.unsupported(
                            "table function arguments must be constants")
                    one_row = Batch(["__dummy"], [Column.const(0, 1)])
                    args.append(b.eval(one_row).decode(0))
            provider = self.resolver.resolve_table_function(ref.name, args)
            node, scope = self._scan_scope(
                provider, ref.alias or ref.name.split(".")[-1])
            if ref.col_aliases:
                # FROM fn(...) t(a, b): rename output columns (PG)
                if len(ref.col_aliases) > len(scope.columns):
                    raise errors.SqlError(
                        "42P10",
                        f"table function {ref.name} has "
                        f"{len(scope.columns)} columns available but "
                        f"{len(ref.col_aliases)} specified")
                cols2 = []
                exprs = []
                names = []
                for i, c in enumerate(scope.columns):
                    nm = ref.col_aliases[i] if i < len(ref.col_aliases) \
                        else c.name
                    cols2.append(ScopeColumn(c.table, nm, c.type, i))
                    exprs.append(BoundColumn(c.index, c.type, nm))
                    names.append(nm)
                scope = Scope(cols2)
                node = ProjectNode(node, exprs, names)
                return node, scope
            if ref.alias and ref.name in ("unnest", "generate_series") \
                    and len(scope.columns) == 1:
                # PG: an alias on a single-column table function renames
                # the column too (SELECT u FROM unnest(...) AS u)
                c = scope.columns[0]
                scope = Scope([ScopeColumn(c.table, ref.alias, c.type,
                                           c.index)])
                node = ProjectNode(node, [BoundColumn(c.index, c.type,
                                                      ref.alias)],
                                   [ref.alias])
            return node, scope
        if isinstance(ref, ast.SubqueryRef):
            inner = self.plan_select(ref.query)
            alias = ref.alias or "subquery"
            names = list(inner.names)
            if ref.col_aliases:
                if len(ref.col_aliases) > len(names):
                    raise errors.SqlError(
                        errors.SYNTAX_ERROR,
                        f"table \"{alias}\" has {len(names)} columns "
                        f"available but {len(ref.col_aliases)} specified")
                names[:len(ref.col_aliases)] = ref.col_aliases
                inner = ProjectNode(
                    inner, [BoundColumn(i, t, nm) for i, (nm, t) in
                            enumerate(zip(names, inner.types))], names)
            scope = Scope([ScopeColumn(alias, n, t, i)
                           for i, (n, t) in enumerate(
                               zip(names, inner.types))])
            return inner, scope
        if isinstance(ref, ast.JoinRef):
            return self._plan_join(ref)
        raise errors.unsupported(f"FROM {type(ref).__name__}")

    def _plan_join(self, ref: ast.JoinRef) -> tuple[PlanNode, Scope]:
        left, lscope = self._plan_from(ref.left)
        right, rscope = self._plan_from(ref.right)
        n_left = len(lscope.columns)
        combined = Scope(
            [ScopeColumn(c.table, c.name, c.type, c.index, c.hidden)
             for c in lscope.columns] +
            [ScopeColumn(c.table, c.name, c.type, c.index + n_left,
                         c.hidden)
             for c in rscope.columns])
        names = _dedup_names([c.name for c in combined.columns])
        types = [c.type for c in combined.columns]
        left_keys: list[BoundExpr] = []
        right_keys: list[BoundExpr] = []
        residual: Optional[BoundExpr] = None
        merge_pairs: list[tuple[int, int]] = []
        using = ref.using
        kind = ref.kind
        if using == ["*natural*"]:
            # NATURAL JOIN: USING over the column names both sides share,
            # in left-side order (PG). Resolved into LOCALS — the AST is
            # shared by views/prepared statements and must stay pristine
            # so each re-plan sees the current schemas. No shared
            # columns → cross join.
            rnames = {c.name.lower() for c in rscope.columns
                      if not c.hidden}
            shared = []
            seen = set()
            for c in lscope.columns:
                nl = c.name.lower()
                if not c.hidden and nl in rnames and nl not in seen:
                    shared.append(c.name)
                    seen.add(nl)
            using = shared or None
            if using is None:
                kind = "cross"
        if using:
            for col in using:
                lc = lscope.resolve([col])
                rc = rscope.resolve([col])
                left_keys.append(BoundColumn(lc.index, lc.type, lc.name))
                right_keys.append(BoundColumn(rc.index, rc.type, rc.name))
                # PG: USING merges the key column — hide the non-merged
                # side's copy from bare-name resolution and SELECT *
                # (right joins keep the right side, others the left). A
                # FULL join's merged key is COALESCE(l, r): the executor
                # overwrites the left copy with right values on
                # right-only rows (merge_pairs).
                hide_right = kind != "right"
                if kind == "full":
                    merge_pairs.append((lc.index, rc.index))
                for c in combined.columns:
                    if c.name.lower() != col.lower():
                        continue
                    if hide_right and c.index >= n_left:
                        c.hidden = True
                    elif not hide_right and c.index < n_left:
                        c.hidden = True
        elif ref.condition is not None:
            residual_parts = []
            for c in _split_conjuncts(ref.condition):
                pair = self._try_equi_key(c, lscope, rscope)
                if pair is not None:
                    left_keys.append(pair[0])
                    right_keys.append(pair[1])
                else:
                    residual_parts.append(c)
            if residual_parts:
                binder = self._binder(combined)
                bound = [binder.bind(p) for p in residual_parts]
                residual = bound[0] if len(bound) == 1 else BoundFunc(
                    "and", bound, dt.BOOL, lambda cols, b: kleene_and(cols))
        node = JoinNode(kind, left, right, left_keys, right_keys,
                        residual, names, types, merge_pairs=merge_pairs)
        return node, combined

    def _try_equi_key(self, e: ast.Expr, lscope: Scope, rscope: Scope):
        if not (isinstance(e, ast.BinaryOp) and e.op == "="):
            return None
        for a, b in ((e.left, e.right), (e.right, e.left)):
            try:
                lb = self._binder(lscope).bind(a)
                rb = self._binder(rscope).bind(b)
                return (lb, rb)
            except errors.SqlError:
                continue
        return None

    # -- SELECT body -------------------------------------------------------

    def _plan_body(self, sel: ast.Select, plan: PlanNode,
                   scope: Scope) -> PlanNode:
        if sel.where is not None:
            binder = self._binder(scope)
            pred = binder.bind(sel.where)
            plan = self._push_filter(plan, pred)

        # expand stars
        items: list[ast.SelectItem] = []
        for it in sel.items:
            if isinstance(it.expr, ast.Star):
                for c in scope.star_columns(it.expr.table):
                    items.append(ast.SelectItem(
                        ast.ColumnRef([c.table, c.name] if c.table else [c.name]),
                        c.name))
            else:
                items.append(it)
        out_names = _dedup_names(
            [it.alias or _default_name(it.expr) for it in items])

        # window functions: pull them out of the item trees first; they
        # evaluate over the (post-aggregate) input via a WindowNode
        window_asts: list[ast.WindowFunc] = []
        items = [ast.SelectItem(_extract_windows(it.expr, window_asts),
                                it.alias) for it in items]

        has_aggs = bool(sel.group_by) or sel.having is not None or \
            any(_contains_agg(it.expr) for it in items) or \
            any(_contains_agg_list(w.partition_by) or
                _contains_agg_list([oi.expr for oi in w.order_by])
                for w in window_asts)

        if has_aggs:
            # window-referencing items can't bind before the WindowNode
            # exists: swap a placeholder through the aggregate binder and
            # rebind the real expression afterwards (mixing aggregates and
            # window refs in ONE expression is not supported yet)
            for it in items:
                if _mentions_win(it.expr) and _contains_agg(it.expr):
                    raise errors.unsupported(
                        "mixing aggregate and window functions in one "
                        "expression")
            agg_items = [ast.SelectItem(ast.Literal(0), it.alias)
                         if _mentions_win(it.expr) else it for it in items]
            plan, exprs, bind_order = self._plan_aggregate(
                sel, agg_items, plan, scope)
        else:
            binder = self._binder(scope)
            exprs = [BoundLiteral(0, dt.INT) if _mentions_win(it.expr)
                     else binder.bind(it.expr) for it in items]

            def bind_order(e: ast.Expr) -> BoundExpr:
                return self._binder(scope).bind(e)

        if window_asts:
            plan, scope, exprs = self._plan_windows(
                sel, window_asts, plan, scope, items, exprs, bind_order,
                has_aggs)

        # ORDER BY: positions, select aliases, then arbitrary expressions
        sort_exprs: list[BoundExpr] = []
        descs: list[bool] = []
        nfs: list[Optional[bool]] = []
        for oi in sel.order_by:
            descs.append(oi.desc)
            nfs.append(oi.nulls_first)
            e = oi.expr
            if isinstance(e, ast.Literal) and isinstance(e.value, int):
                pos = e.value
                if not (1 <= pos <= len(exprs)):
                    raise errors.SqlError(
                        "42P10", f"ORDER BY position {pos} is out of range")
                sort_exprs.append(exprs[pos - 1])
                continue
            if isinstance(e, ast.ColumnRef) and len(e.parts) == 1:
                matches = [k for k, it in enumerate(items)
                           if it.alias and it.alias.lower() == e.parts[0].lower()]
                if matches:
                    sort_exprs.append(exprs[matches[0]])
                    continue
            # expression over select items (e.g. ORDER BY the same expr text)
            matched = None
            for k, it in enumerate(items):
                if _ast_eq(e, it.expr):
                    matched = exprs[k]
                    break
            sort_exprs.append(matched if matched is not None else bind_order(e))

        proj_exprs = list(exprs)
        proj_names = list(out_names)
        hidden = 0
        sort_indices = []
        for se in sort_exprs:
            found = next((k for k, pe in enumerate(proj_exprs) if pe is se),
                         None)
            if found is None:
                proj_exprs.append(se)
                proj_names.append(f"#sort{hidden}")
                found = len(proj_exprs) - 1
                hidden += 1
            sort_indices.append(found)

        on_indices: list[int] = []
        if sel.distinct_on:
            for e in sel.distinct_on:
                found = None
                for k, it in enumerate(items):
                    if _ast_eq(e, it.expr):
                        found = k
                        break
                if found is None and isinstance(e, ast.ColumnRef) and \
                        len(e.parts) == 1:
                    m = [k for k, it in enumerate(items)
                         if it.alias and
                         it.alias.lower() == e.parts[0].lower()]
                    if m:
                        found = m[0]
                if found is None:
                    proj_exprs.append(bind_order(e))
                    proj_names.append(f"#on{len(on_indices)}")
                    hidden += 1
                    found = len(proj_exprs) - 1
                on_indices.append(found)
            if sort_indices and sort_indices[:len(on_indices)] != on_indices:
                raise errors.SqlError(
                    "42P10", "SELECT DISTINCT ON expressions must match "
                    "initial ORDER BY expressions")

        plan = ProjectNode(plan, proj_exprs, _dedup_names(proj_names))
        if sel.distinct:
            if hidden:
                raise errors.unsupported(
                    "SELECT DISTINCT with ORDER BY on non-selected expression")
            plan = _distinct_node(plan, keep=len(out_names))
        if sort_indices:
            plan = SortNode(plan, sort_indices, descs, nfs)
        if on_indices:
            from ..exec.plan import DistinctOnNode
            plan = DistinctOnNode(plan, on_indices)
        if hidden:
            plan = DropColumnsNode(plan, len(out_names))

        if sel.limit is not None or sel.offset is not None:
            limit = _const_int(sel.limit, self.params) \
                if sel.limit is not None else None
            offset = _const_int(sel.offset, self.params) \
                if sel.offset is not None else 0
            plan = LimitNode(plan, limit, offset)
        return plan

    def _plan_windows(self, sel, window_asts, plan, scope, items, exprs,
                      bind_order, has_aggs):
        """Insert a WindowNode computing #winN columns over the current
        plan; rebind select items in the extended scope."""
        from ..exec.window import (WINDOW_FUNCS, WindowNode, WindowSpec,
                                   window_result_type)
        specs = []
        for w in window_asts:
            fname = w.func.name
            if fname not in WINDOW_FUNCS:
                raise errors.SqlError(
                    errors.UNDEFINED_FUNCTION,
                    f"window function {fname}() does not exist")
            arg = None
            extra = None
            default = None
            if fname == "ntile":
                if not w.func.args or not (
                        isinstance(w.func.args[0], ast.Literal) and
                        isinstance(w.func.args[0].value, int)):
                    raise errors.syntax(
                        "ntile requires a constant integer argument")
                extra = w.func.args[0].value
            elif fname in ("lag", "lead"):
                if not w.func.args:
                    raise errors.syntax(f"{fname} requires an argument")
                arg = bind_order(w.func.args[0])
                if len(w.func.args) > 1:
                    off = w.func.args[1]
                    if not (isinstance(off, ast.Literal) and
                            isinstance(off.value, int)):
                        raise errors.unsupported(
                            f"{fname} offset must be a constant")
                    extra = off.value
                if len(w.func.args) > 2:
                    dv = w.func.args[2]
                    neg = isinstance(dv, ast.UnaryOp) and dv.op == "-"
                    if neg:
                        dv = dv.operand
                    if not isinstance(dv, ast.Literal):
                        raise errors.unsupported(
                            f"{fname} default must be a constant")
                    default = -dv.value if neg else dv.value
                    if isinstance(default, str) or arg.type.is_string:
                        # a numeric default on a dictionary-coded string
                        # column would be injected as a raw code
                        raise errors.unsupported(
                            f"{fname} default over a text column is not "
                            "supported")
            elif fname in ("count",) and (w.func.star or not w.func.args):
                arg = None
            elif w.func.args:
                arg = bind_order(w.func.args[0])
            elif fname in ("sum", "min", "max", "avg", "first_value",
                           "last_value"):
                raise errors.syntax(f"{fname} requires an argument")
            partition = [bind_order(p) for p in w.partition_by]
            order = [(bind_order(oi.expr), oi.desc) for oi in w.order_by]
            specs.append(WindowSpec(
                fname, arg, extra, partition, order,
                window_result_type(fname, arg.type if arg else None),
                default=default, frame=w.frame))
        node = WindowNode(plan, specs)
        # preserve the child scope's table qualifiers; only the appended
        # #winN columns are unqualified
        base_cols = [ScopeColumn(c.table, c.name, c.type, c.index)
                     for c in scope.columns]
        win_cols = [ScopeColumn(None, f"#win{i}", s.type,
                                len(plan.names) + i)
                    for i, s in enumerate(specs)]
        new_scope = Scope(base_cols + win_cols)
        # rebind items: #winN refs now resolve; previous bound exprs for
        # non-window items are re-derived in the extended scope
        binder = self._binder(new_scope)
        new_exprs = []
        for it, old in zip(items, exprs):
            if _mentions_win(it.expr):
                new_exprs.append(binder.bind(it.expr))
            else:
                new_exprs.append(old)
        return node, new_scope, new_exprs

    def _push_filter(self, plan: PlanNode, pred: BoundExpr) -> PlanNode:
        """Claim the predicate into the scan when the input is a bare scan
        (the pushdown the reference does in its pre-optimizer pass)."""
        if isinstance(plan, ScanNode) and plan.filter is None:
            plan.filter = pred
            return plan
        return FilterNode(plan, pred)

    def _plan_aggregate(self, sel: ast.Select, items: list[ast.SelectItem],
                        plan: PlanNode, scope: Scope):
        base = self._binder(scope, allow_aggs=True)
        group_asts: list[ast.Expr] = []
        group_bound: list[BoundExpr] = []
        for g in sel.group_by:
            if isinstance(g, ast.Literal) and isinstance(g.value, int):
                pos = g.value
                if not (1 <= pos <= len(items)):
                    raise errors.SqlError("42P10",
                                          f"GROUP BY position {pos} out of range")
                g = items[pos - 1].expr
            elif isinstance(g, ast.ColumnRef) and len(g.parts) == 1:
                for it in items:
                    if it.alias and it.alias.lower() == g.parts[0].lower():
                        g = it.expr
                        break
            group_asts.append(g)
            group_bound.append(base.bind(g))

        post = PostAggBinder(scope, self.params, group_asts,
                             [b.type for b in group_bound])
        post.planner = self
        bound_items = [post.bind(it.expr) for it in items]
        having_b = post.bind(sel.having) if sel.having is not None else None

        ng = len(group_bound)
        agg_names = [f"#g{k}" for k in range(ng)] + \
                    [f"#agg{k}" for k in range(len(post.aggs))]
        agg_node: PlanNode = AggregateNode(plan, group_bound, post.aggs,
                                           agg_names)
        out_types = agg_node.types
        exprs = [_resolve_post(e, ng, out_types) for e in bound_items]
        if having_b is not None:
            agg_node = FilterNode(agg_node,
                                  _resolve_post(having_b, ng, out_types))

        def bind_order(e: ast.Expr) -> BoundExpr:
            return _resolve_post(post.bind(e), ng, out_types)

        return agg_node, exprs, bind_order


def _extract_windows(e: ast.Expr, out: list) -> ast.Expr:
    """Replace WindowFunc nodes with #winN column refs, collecting specs
    (deduplicated by syntactic equality)."""
    if isinstance(e, ast.WindowFunc):
        for k, w in enumerate(out):
            if _ast_eq(e, w):
                return ast.ColumnRef([f"#win{k}"])
        out.append(e)
        return ast.ColumnRef([f"#win{len(out) - 1}"])
    for attr in ("left", "right", "operand", "low", "high", "pattern"):
        v = getattr(e, attr, None)
        if isinstance(v, ast.Expr):
            setattr(e, attr, _extract_windows(v, out))
    if isinstance(e, ast.Logical):
        e.args = [_extract_windows(a, out) for a in e.args]
    if isinstance(e, ast.FuncCall):
        e.args = [_extract_windows(a, out) for a in e.args]
    if isinstance(e, ast.InList):
        e.items = [_extract_windows(i, out) for i in e.items]
    if isinstance(e, ast.Case):
        e.branches = [(_extract_windows(c, out), _extract_windows(v, out))
                      for c, v in e.branches]
        if e.else_ is not None:
            e.else_ = _extract_windows(e.else_, out)
    if isinstance(e, ast.Cast):
        e.operand = _extract_windows(e.operand, out)
    return e


def _mentions_win(e: ast.Expr) -> bool:
    if isinstance(e, ast.ColumnRef) and e.parts[-1].startswith("#win"):
        return True
    for attr in ("left", "right", "operand", "low", "high", "pattern"):
        v = getattr(e, attr, None)
        if isinstance(v, ast.Expr) and _mentions_win(v):
            return True
    for attr in ("args", "items"):
        for v in getattr(e, attr, []) or []:
            if isinstance(v, ast.Expr) and _mentions_win(v):
                return True
    if isinstance(e, ast.Case):
        parts = [x for br in e.branches for x in br]
        if e.operand:
            parts.append(e.operand)
        if e.else_:
            parts.append(e.else_)
        return any(_mentions_win(p) for p in parts)
    if isinstance(e, ast.Cast):
        return _mentions_win(e.operand)
    return False


def _contains_agg_list(exprs) -> bool:
    return any(_contains_agg(x) for x in exprs or [])


def _ast_eq(a: ast.Expr, b: ast.Expr) -> bool:
    return type(a) is type(b) and repr(a) == repr(b)


def _contains_agg(e: ast.Expr) -> bool:
    if isinstance(e, ast.FuncCall):
        if e.name in AGG_FUNCS or e.star:
            return True
        return any(_contains_agg(a) for a in e.args)
    for attr in ("left", "right", "operand", "low", "high", "pattern"):
        v = getattr(e, attr, None)
        if isinstance(v, ast.Expr) and _contains_agg(v):
            return True
    if isinstance(e, ast.Logical):
        return any(_contains_agg(a) for a in e.args)
    if isinstance(e, ast.InList):
        return _contains_agg(e.operand) or any(_contains_agg(i) for i in e.items)
    if isinstance(e, ast.Case):
        parts = [x for br in e.branches for x in br]
        if e.operand:
            parts.append(e.operand)
        if e.else_:
            parts.append(e.else_)
        return any(_contains_agg(p) for p in parts)
    if isinstance(e, ast.Cast):
        return _contains_agg(e.operand)
    return False


def _refs_columns(e: BoundExpr) -> bool:
    """True if the bound expression reads any batch column (i.e. is not a
    constant-foldable expression)."""
    if isinstance(e, (BoundColumn, BoundAggRef)):
        return True
    return any(_refs_columns(c) for c in e.children())


def _default_name(e: ast.Expr) -> str:
    if isinstance(e, ast.ColumnRef):
        return e.parts[-1]
    if isinstance(e, ast.FuncCall):
        return e.name
    if isinstance(e, ast.Cast):
        return _default_name(e.operand)
    return "?column?"


def _dedup_names(names: list[str]) -> list[str]:
    seen: dict[str, int] = {}
    out = []
    for n in names:
        if n in seen:
            seen[n] += 1
            out.append(f"{n}_{seen[n]}")
        else:
            seen[n] = 0
            out.append(n)
    return out


def _split_conjuncts(e: ast.Expr) -> list[ast.Expr]:
    if isinstance(e, ast.Logical) and e.op == "AND":
        out = []
        for a in e.args:
            out.extend(_split_conjuncts(a))
        return out
    return [e]


def _const_int(e: ast.Expr, params: list) -> int:
    binder = ExprBinder(Scope([]), params)
    b = binder.bind(e)
    if not isinstance(b, BoundLiteral) or not isinstance(b.value, (int, float)):
        raise errors.syntax("LIMIT/OFFSET must be a constant")
    return int(b.value)


def _distinct_node(plan: PlanNode, keep: int) -> PlanNode:
    """DISTINCT = group by all output columns, no aggregates."""
    exprs = [BoundColumn(i, t, n)
             for i, (n, t) in enumerate(zip(plan.names, plan.types))]
    return AggregateNode(plan, exprs[:keep], [], list(plan.names[:keep]))
