"""Stub of serenedb_tpu/sql/search_rewrite.py: full-text, vector, b-tree
and geo index scans are not reachable through SQL in the port yet.

`rewrite_search` returns a plan that holds no search predicate unchanged,
and raises FEATURE_NOT_SUPPORTED for one that does: a plan the reference
would hand to an index scan must not run here as something else.
"""

from __future__ import annotations

from .. import errors
from ..exec.plan import PlanNode
from .expr import AggSpec, BoundExpr, BoundFunc

#: the functions the reference's rewrite claims (search_rewrite.py:30-31,
#: :78) plus the MaxSim scorer
_SEARCH_FUNCS = {"ts_phrase", "ts_query", "bm25", "tfidf", "lm_dirichlet",
                 "jelinek_mercer", "dfi", "vec_l2", "vec_ip", "vec_cos",
                 "maxsim"}


def rewrite_search(plan: PlanNode) -> PlanNode:
    if _holds_search(plan):
        raise errors.unsupported("search through SQL is not ported yet")
    return plan


def _exprs_of(value):
    if isinstance(value, BoundExpr):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _exprs_of(v)
    elif isinstance(value, AggSpec):
        yield from _exprs_of([value.arg, value.filter])


def _holds_search(plan: PlanNode) -> bool:
    for value in vars(plan).values():
        for e in _exprs_of(value):
            if any(isinstance(s, BoundFunc) and s.name in _SEARCH_FUNCS
                   for s in e.walk()):
                return True
    return any(_holds_search(c) for c in plan.children())
