"""Stub of serenedb_tpu/search/sqlfuncs.py: the SQL surface of search
(`@@`, `##`, the vector distance operators, bm25() and the other ts_*
functions) is not ported yet. The binder asks `is_search_function` about
every function call, so the names stay recognised; binding one raises
FEATURE_NOT_SUPPORTED."""

from __future__ import annotations

from .. import errors

_SEARCH_FUNCS = {"ts_match", "bm25", "tfidf", "lm_dirichlet",
                 "jelinek_mercer", "dfi", "to_tsquery", "ts_offsets",
                 "ts_headline"}


def is_search_function(name: str) -> bool:
    return name in _SEARCH_FUNCS


def bind_operator(binder, e):
    raise errors.unsupported(
        f"search through SQL is not ported yet (operator {e.op})")


def bind_function(binder, e):
    raise errors.unsupported(
        f"search through SQL is not ported yet (function {e.name})")
