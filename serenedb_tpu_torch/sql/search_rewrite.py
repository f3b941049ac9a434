"""Copied from serenedb_tpu/sql/search_rewrite.py.

Post-planning rewrite: claim full-text predicates into index scans.

Reference analog: the pre-optimizer pass that claims WHERE conjuncts for
iresearch and pushes scorer calls into virtual score columns
(IResearchPushdownComplexFilter / PushdownScorerCall / score-column reuse in
ORDER BY — reference: server/connector/optimizer/iresearch_plan.cpp:
927-1108). Patterns:

1. Scan(filter with ts conjuncts on an indexed column) → SearchScanNode
   (Stream mode), remaining conjuncts as residual.
2. Limit(Sort desc by bm25(col))(Project(Scan(ts-only filter))) →
   SearchScanNode (TopK mode) with a #score output column; bm25()/tfidf()
   calls in the projection are rewired to that column.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..columnar import dtypes as dt
from ..exec.plan import (AggregateNode, DropColumnsNode, FilterNode, JoinNode,
                         LimitNode, PlanNode, ProjectNode, ScanNode, SortNode)
from ..exec.search_scan import SCORE_COL, SearchScanNode
from ..search.index import find_index
from ..search.query import QAnd, QNode, QPhrase, QTerm, parse_query
from .expr import BoundColumn, BoundExpr, BoundFunc, kleene_and

_TS_FUNCS = {"ts_phrase", "ts_query"}
_SCORER_FUNCS = {"bm25", "tfidf", "lm_dirichlet", "jelinek_mercer",
                 "dfi"}


def rewrite_search(plan: PlanNode) -> PlanNode:
    topk = _match_topk(plan)
    if topk is not None:
        return topk
    # Project-over-Scan must be matched BEFORE recursing, or the generic
    # ScanNode branch claims the scan without score wiring
    if isinstance(plan, ProjectNode) and isinstance(plan.child, ScanNode):
        new_child = _try_search_scan(plan.child,
                                     want_score=_has_scorer(plan.exprs),
                                     scorer=_scorer_name(plan.exprs))
        if new_child is not None:
            plan.child = new_child
            if new_child.with_score:
                _rewire_scorers(plan.exprs, new_child)
            return plan
        bt = _try_btree_scan(plan.child) or _try_pk_scan(plan.child) \
            or _try_geo_scan(plan.child)
        if bt is not None:
            plan.child = bt
            return plan
    _rewrite_children(plan)
    if isinstance(plan, ScanNode):
        replaced = _try_search_scan(plan, want_score=False)
        if replaced is None:
            replaced = _try_btree_scan(plan)
        if replaced is None:
            replaced = _try_pk_scan(plan)
        if replaced is None:
            replaced = _try_geo_scan(plan)
        if replaced is not None:
            return replaced
    return plan


def _rewrite_children(plan: PlanNode) -> None:
    for attr in ("child", "left", "right"):
        c = getattr(plan, attr, None)
        if isinstance(c, PlanNode):
            setattr(plan, attr, rewrite_search(c))


# -- pattern 2: scored top-k ----------------------------------------------

_VEC_FUNCS = {"vec_l2", "vec_ip", "vec_cos"}


def _match_topk(plan: PlanNode) -> Optional[PlanNode]:
    limit = plan if isinstance(plan, LimitNode) else None
    if limit is None or limit.limit is None:
        return None
    inner = limit.child
    drop = None
    if isinstance(inner, DropColumnsNode):
        drop = inner
        inner = inner.child
    if not isinstance(inner, SortNode):
        return None
    sort = inner
    if len(sort.key_indices) != 1:
        return None
    if not isinstance(sort.child, ProjectNode):
        return None
    proj = sort.child
    key_expr = proj.exprs[sort.key_indices[0]]
    if not sort.descs[0]:
        return _match_ann_topk(plan, limit, sort, proj, key_expr)
    claimed = _match_maxsim_topk(plan, limit, sort, proj, key_expr)
    if claimed is not None:
        return claimed
    if not (isinstance(key_expr, BoundFunc) and
            key_expr.name in _SCORER_FUNCS and key_expr.args and
            isinstance(key_expr.args[0], BoundColumn)):
        return None
    if not isinstance(proj.child, ScanNode):
        return None
    scan = proj.child
    search_col_idx = key_expr.args[0].index
    search_col = scan.columns[search_col_idx]
    qnode, residual = _claim_ts(scan, search_col)
    if qnode is None or residual is not None:
        # residual conjuncts would filter *after* top-k and break LIMIT
        return None
    k = limit.limit + limit.offset
    node = SearchScanNode(scan.provider, scan.columns, scan.alias,
                          search_col, qnode, None, k, with_score=True,
                          scorer=key_expr.name)
    _rewire_scorers(proj.exprs, node)
    proj.child = node
    return plan


def _match_ann_topk(plan: PlanNode, limit, sort, proj,
                    key_expr) -> Optional[PlanNode]:
    """ORDER BY vec_*(col, 'literal') ASC LIMIT k over an ivf-indexed
    column → IvfScanNode (reference: TryClaimAnnRange)."""
    from ..exec.search_scan import IvfScanNode
    from ..search.ivf import find_ivf_index, parse_vector
    from .expr import BoundLiteral
    if not (isinstance(key_expr, BoundFunc) and
            key_expr.name in _VEC_FUNCS and len(key_expr.args) == 2):
        return None
    col, lit = key_expr.args
    if not (isinstance(col, BoundColumn) and
            isinstance(lit, BoundLiteral) and isinstance(lit.value, str)):
        return None
    if not isinstance(proj.child, ScanNode):
        return None
    scan = proj.child
    if scan.filter is not None:
        return None  # predicate + ANN composition comes later
    vec_col = scan.columns[col.index]
    idx = find_ivf_index(scan.provider, vec_col)
    if idx is None:
        return None
    metric = {"vec_l2": "l2", "vec_ip": "ip", "vec_cos": "cos"}[key_expr.name]
    if idx.metric != metric:
        return None
    qvec = parse_vector(lit.value, idx.dim)
    k = limit.limit + limit.offset
    node = IvfScanNode(scan.provider, scan.columns, scan.alias, vec_col,
                       qvec, k)
    dist_ref = BoundColumn(len(node.columns), dt.DOUBLE, IvfScanNode.DIST_COL)

    def rec(e: BoundExpr) -> BoundExpr:
        if isinstance(e, BoundFunc):
            # only the ordering metric's own function maps to #dist —
            # vec_cos over an l2-ordered scan must keep its CPU value
            if e.name == key_expr.name and len(e.args) == 2 and \
                    isinstance(e.args[0], BoundColumn) and \
                    e.args[0].index == col.index and \
                    isinstance(e.args[1], BoundLiteral) and \
                    e.args[1].value == lit.value:
                return dist_ref
            e.args = [rec(a) for a in e.args]
        return e

    for i in range(len(proj.exprs)):
        proj.exprs[i] = rec(proj.exprs[i])
    proj.child = node
    return plan


def _match_maxsim_topk(plan: PlanNode, limit, sort, proj,
                       key_expr) -> Optional[PlanNode]:
    """ORDER BY vec_maxsim(col, 'literal') DESC LIMIT k over a
    maxsim-indexed column → MaxSimScanNode. The SortNode stays in the
    plan — its stable re-sort over #msim preserves the device's
    (score desc, doc asc) tie order for free."""
    from ..exec.search_scan import MaxSimScanNode
    from ..search.ivf import find_maxsim_index, parse_multi_vector
    from .expr import BoundLiteral
    if not (isinstance(key_expr, BoundFunc) and
            key_expr.name == "vec_maxsim" and len(key_expr.args) == 2):
        return None
    col, lit = key_expr.args
    if not (isinstance(col, BoundColumn) and
            isinstance(lit, BoundLiteral) and isinstance(lit.value, str)):
        return None
    if not isinstance(proj.child, ScanNode):
        return None
    scan = proj.child
    if scan.filter is not None:
        return None  # predicate + late-interaction composition later
    vec_col = scan.columns[col.index]
    idx = find_maxsim_index(scan.provider, vec_col)
    if idx is None:
        return None
    qtoks = parse_multi_vector(lit.value, idx.dim)
    if qtoks is None:
        return None  # empty query scores every doc 0 — not claimable
    k = limit.limit + limit.offset
    node = MaxSimScanNode(scan.provider, scan.columns, scan.alias,
                          vec_col, qtoks, k)
    score_ref = BoundColumn(len(node.columns), dt.DOUBLE,
                            MaxSimScanNode.SCORE_COL)

    def rec(e: BoundExpr) -> BoundExpr:
        if isinstance(e, BoundFunc):
            if e.name == "vec_maxsim" and len(e.args) == 2 and \
                    isinstance(e.args[0], BoundColumn) and \
                    e.args[0].index == col.index and \
                    isinstance(e.args[1], BoundLiteral) and \
                    e.args[1].value == lit.value:
                return score_ref
            e.args = [rec(a) for a in e.args]
        return e

    for i in range(len(proj.exprs)):
        proj.exprs[i] = rec(proj.exprs[i])
    proj.child = node
    return plan


def _has_scorer(exprs: list[BoundExpr]) -> bool:
    return any(isinstance(s, BoundFunc) and s.name in _SCORER_FUNCS
               for e in exprs for s in e.walk())


def _rewire_scorers(exprs: list[BoundExpr], node: SearchScanNode) -> None:
    """Replace calls of the scan's OWN scorer over the searched column with
    the #score output; a different scorer function (the scan computes only
    one) and scorers over other columns keep their default (0.0) — never
    alias one scorer's values onto another's column."""
    score_ref = BoundColumn(len(node.columns), dt.FLOAT, SCORE_COL)
    search_idx = node.columns.index(node.search_column)

    def rec(e: BoundExpr) -> BoundExpr:
        if isinstance(e, BoundFunc):
            if e.name == node.scorer and e.args and \
                    isinstance(e.args[0], BoundColumn) and \
                    e.args[0].index == search_idx:
                return score_ref
            e.args = [rec(a) for a in e.args]
        return e

    for i in range(len(exprs)):
        exprs[i] = rec(exprs[i])


# -- pattern 1: filter pushdown -------------------------------------------

def _scorer_name(exprs: list[BoundExpr]) -> str:
    for e in exprs:
        for s in e.walk():
            if isinstance(s, BoundFunc) and s.name in _SCORER_FUNCS:
                return s.name
    return "bm25"


def _try_btree_scan(scan: ScanNode):
    """col = constant conjunct over a btree-indexed column → point lookup
    (reference: PK lookup fast path)."""
    from ..exec.search_scan import BtreeScanNode
    from ..search.index import find_btree_index
    from .expr import BoundLiteral
    if scan.filter is None:
        return None
    conjuncts = _conjuncts(scan.filter)
    for k, c in enumerate(conjuncts):
        if not (isinstance(c, BoundFunc) and c.name == "op=" and
                len(c.args) == 2):
            continue
        for col, lit in ((c.args[0], c.args[1]), (c.args[1], c.args[0])):
            if not (isinstance(col, BoundColumn) and
                    isinstance(lit, BoundLiteral) and
                    lit.value is not None):
                continue
            col_name = scan.columns[col.index]
            idx = find_btree_index(scan.provider, col_name)
            if idx is None:
                continue
            value = lit.value
            if scan.provider.type_of(col_name).is_string:
                # equality on strings → dictionary code; an absent string
                # maps to the impossible code -1 (empty lookup)
                host = scan.provider.host_column(col_name)
                if host.dictionary is None:
                    continue
                import numpy as _np
                ds = host.dictionary.astype(str)
                pos = int(_np.searchsorted(ds, str(value)))
                value = pos if pos < len(ds) and ds[pos] == str(value) \
                    else -1
            residual = _and_conjuncts(conjuncts[:k] + conjuncts[k + 1:])
            return BtreeScanNode(scan.provider, scan.columns, scan.alias,
                                 col_name, value, residual)
    return None


_GEO_CLAIM_FNS = {"st_intersects", "st_contains", "st_within",
                  "st_covers", "st_coveredby", "st_dwithin"}


def _try_geo_scan(scan: ScanNode):
    """Geo conjunct over a geo-indexed column + a constant geometry →
    cell-term candidate scan with exact post-verification (reference:
    geo_filter_builder.cpp pushing GeoFilter into the inverted index).
    The claimed conjunct stays in the residual — the index only narrows
    the rows it is evaluated over."""
    from ..exec.search_scan import GeoScanNode
    from ..geo import cells as geo_cells
    from ..geo import shapes as geo_shapes
    from ..search.index import find_geo_index
    from .expr import BoundLiteral
    if scan.filter is None:
        return None
    conjuncts = _conjuncts(scan.filter)
    for c in conjuncts:
        if not (isinstance(c, BoundFunc) and c.name in _GEO_CLAIM_FNS
                and len(c.args) >= 2):
            continue
        radius = 0.0
        if c.name == "st_dwithin":
            if len(c.args) < 3 or not isinstance(c.args[2], BoundLiteral) \
                    or c.args[2].value is None:
                continue   # NULL/non-constant radius: unindexed path
            try:
                radius = float(c.args[2].value)
            except (TypeError, ValueError):
                continue
        for col, lit in ((c.args[0], c.args[1]), (c.args[1], c.args[0])):
            if not (isinstance(col, BoundColumn) and
                    isinstance(lit, BoundLiteral) and
                    isinstance(lit.value, str)):
                continue
            col_name = scan.columns[col.index]
            if find_geo_index(scan.provider, col_name) is None:
                continue
            try:
                probe = geo_cells.query_terms(
                    geo_shapes.parse_any(lit.value), radius)
            except Exception:
                continue
            # ALL conjuncts (incl. the claimed one) run over candidates
            return GeoScanNode(scan.provider, scan.columns, scan.alias,
                               col_name, probe, scan.filter)
    return None


_RANGE_OPS = {"op<": "lt", "op<=": "le", "op>": "gt", "op>=": "ge"}


def _try_pk_scan(scan: ScanNode):
    """PK-index claims (reference: key_encoding.cpp order-preserving PK
    terms): equality on EVERY PK column → point lookup; equality/range
    conjuncts on the LEADING PK column → key range scan."""
    from ..columnar import keyenc
    from ..exec.search_scan import PkScanNode
    from .expr import BoundLiteral
    if scan.filter is None:
        return None
    meta = getattr(scan.provider, "table_meta", None) or {}
    pk = meta.get("primary_key") or []
    if not pk:
        return None
    conjuncts = _conjuncts(scan.filter)
    # collect (col_name, op, literal) claims
    claims = []
    for k, c in enumerate(conjuncts):
        if not (isinstance(c, BoundFunc) and len(c.args) == 2 and
                (c.name == "op=" or c.name in _RANGE_OPS)):
            continue
        for a, b, flip in ((c.args[0], c.args[1], False),
                           (c.args[1], c.args[0], True)):
            if isinstance(a, BoundColumn) and isinstance(b, BoundLiteral) \
                    and b.value is not None:
                op = c.name
                if flip and op in _RANGE_OPS:
                    op = {"op<": "op>", "op<=": "op>=", "op>": "op<",
                          "op>=": "op<="}[op]
                claims.append((k, scan.columns[a.index], op, b.value))
                break

    def enc(col, v):
        t = scan.provider.type_of(col)
        try:
            if t.is_integer and not isinstance(v, (int, np.integer)):
                return None
            return keyenc.encode_value(v, t)
        except Exception:
            return None

    # point: one equality per PK column
    eqs = {col: (k, v) for k, col, op, v in claims if op == "op="}
    if all(c in eqs for c in pk):
        parts = []
        used = []
        for c in pk:
            k, v = eqs[c]
            e = enc(c, v)
            if e is None:
                break
            parts.append(e)
            used.append(k)
        else:
            residual = _and_conjuncts(
                [c for k, c in enumerate(conjuncts) if k not in used])
            return PkScanNode(scan.provider, scan.columns, scan.alias,
                              "point", b"".join(parts), None, residual)
    # range on the leading PK column
    lead = pk[0]
    lo = hi = None
    used = []
    for k, col, op, v in claims:
        if col != lead:
            continue
        e = enc(col, v)
        if e is None:
            continue
        if op == "op=":
            lo, hi = e, keyenc.prefix_upper_bound(e)
            used = [k]
            break
        if op in ("op>", "op>="):
            b = e if op == "op>=" else keyenc.prefix_upper_bound(e)
            if b is not None and (lo is None or b > lo):
                lo = b
                used.append(k)
        elif op in ("op<", "op<="):
            b = e if op == "op<" else keyenc.prefix_upper_bound(e)
            if b is not None and (hi is None or b < hi):
                hi = b
                used.append(k)
    if lo is None and hi is None:
        return None
    residual = _and_conjuncts(
        [c for k, c in enumerate(conjuncts) if k not in used])
    return PkScanNode(scan.provider, scan.columns, scan.alias, "range",
                      lo, hi, residual)


def _try_search_scan(scan: ScanNode, want_score: bool,
                     scorer: str = "bm25") -> Optional[SearchScanNode]:
    if scan.filter is None:
        return None
    # find an indexed column among the ts conjuncts
    for col_name in scan.columns:
        if find_index(scan.provider, col_name) is None:
            continue
        qnode, residual = _claim_ts(scan, col_name)
        if qnode is not None:
            return SearchScanNode(scan.provider, scan.columns, scan.alias,
                                  col_name, qnode, residual, None,
                                  with_score=want_score, scorer=scorer)
    return None


def _claim_ts(scan: ScanNode, col_name: str,
              ) -> tuple[Optional[QNode], Optional[BoundExpr]]:
    """Claim ts conjuncts on col_name from the scan filter. Returns
    (query node, residual predicate)."""
    if scan.filter is None:
        return None, None
    idx = find_index(scan.provider, col_name)
    if idx is None:
        return None, None
    col_idx = scan.columns.index(col_name)
    from ..search.analysis import get_analyzer
    an = get_analyzer(idx.analyzer_name_for(col_name))
    claimed: list[QNode] = []
    residual: list[BoundExpr] = []
    for c in _conjuncts(scan.filter):
        q = _to_qnode(c, col_idx, an)
        if q is not None:
            claimed.append(q)
        else:
            residual.append(c)
    if not claimed:
        return None, None
    qnode = claimed[0] if len(claimed) == 1 else QAnd(claimed)
    return qnode, _and_conjuncts(residual)


def _and_conjuncts(exprs: list[BoundExpr]) -> Optional[BoundExpr]:
    if not exprs:
        return None
    if len(exprs) == 1:
        return exprs[0]
    return BoundFunc("and", exprs, dt.BOOL,
                     lambda cols, b: kleene_and(cols))


def _conjuncts(e: BoundExpr) -> list[BoundExpr]:
    if isinstance(e, BoundFunc) and e.name == "and":
        out = []
        for a in e.args:
            out.extend(_conjuncts(a))
        return out
    return [e]


def _to_qnode(e: BoundExpr, col_idx: int, analyzer) -> Optional[QNode]:
    from .expr import BoundLiteral
    if isinstance(e, BoundFunc) and e.name == "or":
        # same-column disjunction of ts predicates claims as QOr (the ES
        # query_string path emits these; Lucene BooleanQuery SHOULD).
        # NULL-safe: a NULL document matches no branch under both the
        # index eval and SQL three-valued OR. Cross-column disjunctions
        # stay unclaimed (scoring would need multi-index evaluation).
        from ..search.query import QOr
        subs = [_to_qnode(a, col_idx, analyzer) for a in e.args]
        if subs and all(s is not None for s in subs):
            return QOr(subs)
        return None
    if not (isinstance(e, BoundFunc) and e.name in _TS_FUNCS and
            len(e.args) == 2):
        return None
    col, lit = e.args
    if not (isinstance(col, BoundColumn) and col.index == col_idx and
            isinstance(lit, BoundLiteral) and isinstance(lit.value, str)):
        return None
    if e.name == "ts_phrase":
        from ..search.query import QNothing, QOr, position_groups
        toks = analyzer.tokenize(lit.value)
        groups = position_groups(toks)
        if not groups:
            # zero analyzed terms match nothing (to_tsquery('')), and the
            # claim MUST happen: the brute fallback analyzes with the
            # default analyzer, not this column's dictionary
            return QNothing()
        if len(groups) == 1:
            alts = groups[0]
            return (QTerm(alts[0]) if len(alts) == 1
                    else QOr([QTerm(a) for a in alts]))
        return QPhrase([t.term for t in toks], groups)
    return parse_query(lit.value, analyzer)
