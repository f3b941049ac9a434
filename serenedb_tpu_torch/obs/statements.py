"""Copied from serenedb_tpu/obs/statements.py.

sdb_stat_statements: cumulative per-statement execution statistics.

Reference analog: PG's pg_stat_statements — statements aggregate under a
normalized query fingerprint (literals and bind parameters collapse to
`?`, keywords/identifiers lowercase, whitespace canonical), so
`SELECT * FROM t WHERE x = 5` and `select *  from T where x=$1` are one
entry. The registry is process-wide, capped by the
`serene_stat_statements_max` global with least-recently-executed
eviction, and surfaces as the `sdb_stat_statements` system view
(pgcatalog.py) and in the `/metrics` + `/_stats` HTTP exports.
"""

from __future__ import annotations

import functools
import hashlib
import threading
from collections import OrderedDict

from ..sql.lexer import T, tokenize
from ..utils.metrics import (HIST_BOUNDS_NS, hist_bucket_index,
                             hist_quantile_ns)


@functools.lru_cache(maxsize=512)
def normalize(sql: str) -> str:
    """Canonical fingerprint text: literals/params → `?`, identifiers and
    keywords lowercased, one space between tokens, no trailing `;`.
    Unlexable text falls back to lowercase whitespace collapse (the
    statement still aggregates, just less precisely)."""
    try:
        toks = tokenize(sql)
    except Exception:
        return " ".join(sql.lower().split()).rstrip(";").rstrip()
    parts: list[str] = []
    for t in toks:
        if t.kind is T.EOF:
            break
        if t.kind in (T.NUMBER, T.STRING, T.PARAM):
            parts.append("?")
        elif t.kind is T.IDENT:
            parts.append(t.value.lower())
        else:
            parts.append(t.value)
    while parts and parts[-1] == ";":
        parts.pop()
    return " ".join(parts)


def fingerprint(normalized: str) -> int:
    """Stable 63-bit query id of the normalized text (PG's queryid)."""
    h = hashlib.blake2b(normalized.encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") & ((1 << 63) - 1)


class StatementStore:
    """Fingerprint → cumulative stats, LRU-capped.

    One short critical section per statement END (never inside
    execution), so the store adds no contention to the operator hot
    path. Eviction order is last-execution recency: recording an
    existing entry refreshes it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: OrderedDict[int, dict] = OrderedDict()

    def record(self, query_text: str, elapsed_ns: int, rows: int,
               morsels_pruned: int, cap: int,
               cache_hit: bool = False, peak_bytes: int = 0) -> int:
        norm = normalize(query_text)
        qid = fingerprint(norm)
        ms = elapsed_ns / 1e6
        bucket = hist_bucket_index(elapsed_ns)
        peak = max(int(peak_bytes), 0)
        with self._lock:
            e = self._entries.get(qid)
            if e is None:
                while len(self._entries) >= max(int(cap), 1):
                    self._entries.popitem(last=False)
                hist = [0] * (len(HIST_BOUNDS_NS) + 1)
                hist[bucket] = 1
                self._entries[qid] = {
                    "queryid": qid, "query": norm, "calls": 1,
                    "total_ms": ms, "min_ms": ms, "max_ms": ms,
                    "rows": int(rows),
                    "morsels_pruned": int(morsels_pruned),
                    "cache_hits": int(bool(cache_hit)),
                    "peak_mem_bytes": peak,
                    "last_peak_mem_bytes": peak,
                    "hist": hist}
            else:
                self._entries.move_to_end(qid)
                e["calls"] += 1
                e["total_ms"] += ms
                e["min_ms"] = min(e["min_ms"], ms)
                e["max_ms"] = max(e["max_ms"], ms)
                e["rows"] += int(rows)
                e["morsels_pruned"] += int(morsels_pruned)
                # entries recorded before the cache subsystem existed in
                # this process lifetime may lack the key (same story for
                # the latency histogram and peak-memory columns below)
                e["cache_hits"] = e.get("cache_hits", 0) + \
                    int(bool(cache_hit))
                e["peak_mem_bytes"] = max(e.get("peak_mem_bytes", 0),
                                          peak)
                e["last_peak_mem_bytes"] = peak
                hist = e.setdefault("hist",
                                    [0] * (len(HIST_BOUNDS_NS) + 1))
                hist[bucket] += 1
        return qid

    def snapshot(self) -> list[dict]:
        """Point-in-time copy, most recently executed last. The raw
        per-entry latency histogram collapses into p50/p95/p99
        milliseconds (the per-fingerprint percentiles surfaced by
        sdb_stat_statements and /_stats)."""
        with self._lock:
            out = []
            for e in self._entries.values():
                d = dict(e)
                hist = d.pop("hist", None)
                if hist is not None:
                    d["p50_ms"] = round(
                        hist_quantile_ns(hist, 0.50) / 1e6, 3)
                    d["p95_ms"] = round(
                        hist_quantile_ns(hist, 0.95) / 1e6, 3)
                    d["p99_ms"] = round(
                        hist_quantile_ns(hist, 0.99) / 1e6, 3)
                out.append(d)
            return out

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: process-wide store (one per process, like the metrics registry)
STATEMENTS = StatementStore()
