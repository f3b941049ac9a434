"""Copied from serenedb_tpu/search/sqlfuncs.py.

SQL surface of the search engine: ts_* functions and the ##/@@ operators.

Reference analog: server/connector/functions/ts_*.cpp + search.cpp:149-330
(phrase `##`, tsquery `@@`, scorer functions bm25()/tfidf(), ts_offsets,
highlights) and the vector distance operators `<->`/`<#>`/`<=>`
(functions/vector.cpp). Bound here; execution is CPU text-match for
un-indexed columns and is *claimed by the index pushdown optimizer* when the
scan has a search index (exec/pushdown.py), mirroring the reference's
IResearchPushdownComplexFilter (optimizer/iresearch_plan.cpp:1068-1097).

Phase-2 will replace the brute-force CPU fallbacks with segment scoring; the
semantics defined here are the contract.
"""

from __future__ import annotations

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Column

_SEARCH_FUNCS = {"ts_match", "bm25", "tfidf", "lm_dirichlet",
                 "jelinek_mercer", "dfi", "to_tsquery", "ts_offsets",
                 "ts_headline"}


def is_search_function(name: str) -> bool:
    return name in _SEARCH_FUNCS


def bind_operator(binder, e):
    """Bind `col ## 'phrase'` (phrase match) and `col @@ 'query'`."""
    from ..sql.expr import BoundFunc
    from .analysis import default_analyzer
    from .query import match_phrase_brute, match_query_brute

    if e.op in ("<->", "<#>", "<=>"):
        # vector distance operators → vec_* functions (CPU oracle; the
        # rewrite pass claims ORDER BY ... LIMIT k into the IVF index scan)
        fname = {"<->": "vec_l2", "<#>": "vec_ip", "<=>": "vec_cos"}[e.op]
        left = binder.bind(e.left)
        right = binder.bind(e.right)
        return binder._call(fname, [left, right])
    from ..sql import ast as _ast
    op = e.op
    right_ast = e.right
    # ts_phrase('...') inside @@ means phrase semantics
    # (reference demo0: text @@ ts_phrase('breathtaking cinematography'))
    if op == "@@" and isinstance(right_ast, _ast.FuncCall) and \
            right_ast.name == "ts_phrase" and len(right_ast.args) == 1:
        op = "##"
        right_ast = right_ast.args[0]
    left = binder.bind(e.left)
    right = binder.bind(right_ast)
    if not left.type.is_string:
        raise errors.SqlError(errors.DATATYPE_MISMATCH,
                              f"operator {op} requires a text column")
    fn = match_phrase_brute if op == "##" else match_query_brute

    def impl(cols, batch, _fn=fn):
        hay, needle = cols
        from ..sql.expr import propagate_nulls, string_values
        texts = string_values(hay)
        pats = string_values(needle)
        data = _fn(texts, pats)
        validity = propagate_nulls(cols)
        return Column(dt.BOOL, data, validity)

    name = "ts_phrase" if op == "##" else "ts_query"
    return BoundFunc(name, [left, right], dt.BOOL, impl)


def bind_function(binder, e):
    from ..sql.expr import BoundFunc
    name = e.name
    if name == "ts_match":
        rewritten = type(e)  # FuncCall
        if len(e.args) != 2:
            raise errors.syntax("ts_match(column, query) takes 2 arguments")
        import dataclasses
        from ..sql import ast as _ast
        return bind_operator(binder, _ast.BinaryOp("@@", e.args[0], e.args[1]))
    if name in ("bm25", "tfidf", "lm_dirichlet", "jelinek_mercer",
                "dfi"):
        # scorer over an indexed scan; meaningful only with pushdown — the
        # optimizer replaces it with the scan's score column. Unpushed use
        # yields 0.0 (reference: unscored context returns default score).
        args = [binder.bind(a) for a in e.args]

        def impl(cols, batch):
            return Column(dt.FLOAT, np.zeros(batch.num_rows, dtype=np.float32))
        return BoundFunc(name, args, dt.FLOAT, impl)
    if name == "to_tsquery":
        args = [binder.bind(a) for a in e.args]

        def impl(cols, batch):
            return cols[-1]
        return BoundFunc(name, args, dt.VARCHAR, impl)
    if name in ("ts_offsets", "ts_headline"):
        # reference: byte-range highlight via per-row re-analysis
        # (server/connector/highlight/memory_index.*)
        headline = name == "ts_headline"
        n_args = 3 if headline else 2
        if not 2 <= len(e.args) <= n_args:
            raise errors.syntax(
                f"{name}(column, query[, options]) takes "
                f"{n_args} arguments at most")
        args = [binder.bind(a) for a in e.args]

        def _hl_opts(spec: str) -> dict:
            # PG ts_headline options string: 'StartSel=[, StopSel=]'
            out = {}
            for part in spec.split(","):
                k, _, v = part.partition("=")
                out[k.strip().lower()] = v.strip()
            return out

        def impl(cols, batch, _headline=headline):
            import json
            from ..sql.expr import (make_string_column, propagate_nulls,
                                    string_values)
            from .analysis import default_analyzer
            from .highlight import headline as _hl
            from .highlight import match_offsets
            texts = string_values(cols[0])
            queries = string_values(cols[1])
            an = default_analyzer()
            valid = propagate_nulls(cols)
            # the query argument is almost always a constant column: parse
            # each distinct query string once, not once per row
            from .highlight import _positive_terms, token_matches
            from .query import parse_query as _pq
            qcache: dict[str, tuple] = {}

            def parsed(q: str):
                hit = qcache.get(q)
                if hit is None:
                    hit = qcache[q] = _positive_terms(_pq(q, an))
                return hit

            out = []
            for i in range(batch.num_rows):
                if valid is not None and not valid[i]:
                    out.append("")
                    continue
                terms, prefixes, fuzzies, regexes = parsed(queries[i])
                spans = [[t.start, t.end] for t in an.tokenize(texts[i])
                         if token_matches(t.term, terms, prefixes,
                                          fuzzies, regexes)]
                if _headline:
                    start_sel, stop_sel = "<b>", "</b>"
                    if len(cols) > 2:
                        opts = _hl_opts(string_values(cols[2])[i])
                        start_sel = opts.get("startsel", start_sel)
                        stop_sel = opts.get("stopsel", stop_sel)
                    out.append(_hl(an, texts[i], queries[i], spans=spans,
                                   start_sel=start_sel, stop_sel=stop_sel))
                else:
                    out.append(json.dumps(spans))
            col = make_string_column(
                np.asarray(out, dtype=object).astype(str), valid)
            return col
        return BoundFunc(name, args, dt.VARCHAR, impl)
    raise errors.unsupported(f"search function {name}")
