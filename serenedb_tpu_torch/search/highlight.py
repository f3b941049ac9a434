"""Copied from serenedb_tpu/search/highlight.py.

Highlighting: byte offsets of query matches + headline rendering.

Reference analog: server/connector/highlight/memory_index.* — highlights are
computed by re-analyzing the row's text against the query (SURVEY.md §2.5
"Highlight") rather than storing offsets in the index.
"""

from __future__ import annotations

from .query import (QAnd, QFuzzy, QNode, QNot, QOr, QPhrase, QPrefix, QRegex,
                    QTerm, edit_distance_at_most, parse_query)


def _positive_terms(node: QNode) -> tuple[set[str], set[str], list, list]:
    """(exact terms, prefixes, fuzzy specs, regexes) contributing to
    highlights."""
    terms: set[str] = set()
    prefixes: set[str] = set()
    fuzzies: list[tuple[str, int]] = []
    regexes: list[QRegex] = []

    def rec(nd):
        if isinstance(nd, QTerm):
            terms.add(nd.term)
        elif isinstance(nd, QPhrase):
            terms.update(nd.terms)
        elif isinstance(nd, QPrefix):
            prefixes.add(nd.prefix)
        elif isinstance(nd, QFuzzy):
            fuzzies.append((nd.term, nd.max_edits))
        elif isinstance(nd, QRegex):
            regexes.append(nd)
        elif isinstance(nd, (QAnd, QOr)):
            for a in nd.args:
                rec(a)
        # QNot: negated terms never highlight
    rec(node)
    return terms, prefixes, fuzzies, regexes


def token_matches(term: str, terms: set, prefixes: set, fuzzies: list,
                  regexes: list = ()) -> bool:
    return term in terms or \
        any(term.startswith(p) for p in prefixes) or \
        any(edit_distance_at_most(term, f, k) for f, k in fuzzies) or \
        any(r.matches(term) for r in regexes)


def match_offsets(analyzer, text: str, query: str) -> list[list[int]]:
    """[[start, end], ...] character ranges of matching tokens."""
    node = parse_query(query, analyzer)
    terms, prefixes, fuzzies, regexes = _positive_terms(node)
    out = []
    for tok in analyzer.tokenize(text):
        if token_matches(tok.term, terms, prefixes, fuzzies, regexes):
            out.append([tok.start, tok.end])
    return out


def headline(analyzer, text: str, query: str, start_sel: str = "<b>",
             stop_sel: str = "</b>", spans=None) -> str:
    """PG ts_headline-style rendering: matched tokens wrapped in markers.
    Pre-computed spans (from a cached parsed query) skip the re-parse."""
    if spans is None:
        spans = match_offsets(analyzer, text, query)
    if not spans:
        return text
    parts = []
    prev = 0
    for s, e in spans:
        parts.append(text[prev:s])
        parts.append(start_sel)
        parts.append(text[s:e])
        parts.append(stop_sel)
        prev = e
    parts.append(text[prev:])
    return "".join(parts)
