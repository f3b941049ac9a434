"""Copied from serenedb_tpu/cache/fragments.py.

Tier 2: per-segment search fragment cache.

Reference analog: the ES shard request cache — per-shard filter and
aggregation fragments keyed by the request digest, valid while the
shard's segment set is unchanged. Here the unit is the SEGMENT
(search/searcher.SegmentSearcher), which is immutable by construction:

- filter fragments (sorted doc-id sets for one query node) are a pure
  function of the segment — valid for the segment's whole lifetime.
  Appends only create NEW segments, so existing fragments survive them;
  delete/update rebuilds replace the segment objects and the dead
  segments' entries are purged by their weakref finalizers.
- top-k fragments (one segment's scored collector output) additionally
  depend on GLOBAL collection statistics (idf/avgdl span every
  segment), so their key includes the whole segment-set signature — an
  append changes the signature and the fragment recomputes, exactly as
  scores require.

Keys are (segment uid, shape digest). Each segment gets a
process-unique uid on first touch (never an id() — addresses recycle);
query nodes digest structurally via `qnode_sig`, and an unknown node
type simply bypasses the cache. Cached arrays are returned as COPIES so
no caller can corrupt a shared fragment in place.

Gated per session by `serene_result_cache` (read off the executing
connection's settings when one is current, else the global default);
bytes-bounded by the `serene_fragment_cache_mb` global.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from collections import deque
from typing import Optional

import numpy as np

from ..utils import metrics
from ..utils.config import REGISTRY as _settings_registry
from .lru import BytesLRU

_uid_counter = itertools.count(1)
_uid_lock = threading.Lock()


def enabled() -> bool:
    """Session gate: the executing connection's serene_result_cache when
    a statement is running, else the global default."""
    from ..engine import CURRENT_CONNECTION
    conn = CURRENT_CONNECTION.get()
    try:
        if conn is not None:
            return bool(conn.settings.get("serene_result_cache"))
        return bool(_settings_registry.get_global("serene_result_cache"))
    except KeyError:                              # pragma: no cover
        return False


def qnode_sig(node) -> Optional[tuple]:
    """Structural, hashable signature of a query node; None for node
    types this walk does not know (those bypass the cache — default
    reprs are address-based and must never key anything)."""
    from ..search.query import (QAnd, QFuzzy, QNot, QNothing, QOr,
                                QPhrase, QPrefix, QRegex, QTerm)
    if isinstance(node, QTerm):
        return ("t", node.term)
    if isinstance(node, QPhrase):
        return ("p", tuple(tuple(g) for g in node.groups), node.slop)
    if isinstance(node, QPrefix):
        return ("pre", node.prefix)
    if isinstance(node, QFuzzy):
        return ("f", node.term, node.max_edits)
    if isinstance(node, QRegex):
        return ("re", node.pattern, getattr(node, "case_fold", False))
    if isinstance(node, QNothing):
        return ("0",)
    if isinstance(node, QNot):
        inner = qnode_sig(node.arg)
        return None if inner is None else ("!", inner)
    if isinstance(node, (QAnd, QOr)):
        parts = tuple(qnode_sig(a) for a in node.args)
        if any(p is None for p in parts):
            return None
        return ("&" if isinstance(node, QAnd) else "|",) + parts
    return None


def _copy_value(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, tuple):
        return tuple(_copy_value(x) for x in v)
    if isinstance(v, list):
        return [_copy_value(x) for x in v]
    return v


def _value_nbytes(v) -> int:
    if isinstance(v, np.ndarray):
        return int(v.nbytes)
    if isinstance(v, (list, tuple)):
        return sum(_value_nbytes(x) for x in v) + 16 * len(v)
    return 64


class FragmentCache:
    def __init__(self):
        self._lru = BytesLRU(on_evict=self._evicted)
        self._lock = threading.Lock()
        self._seg_keys: dict[int, set] = {}   # uid → live keys
        self._gauge_bytes = 0
        #: uids of dead segments awaiting reclaim. The weakref finalizer
        #: ONLY appends here: a finalizer runs at an arbitrary
        #: allocation/GC point — possibly on a thread that already holds
        #: `_lock` or the LRU's lock (observed: GC inside
        #: `_sync_bytes`'s `total_bytes` call) — so taking any lock in
        #: it deadlocks against the very frame it interrupted.
        #: deque.append is atomic under the GIL; the next cache
        #: operation drains the queue with normal locking.
        self._pending_drops: deque = deque()

    def _evicted(self, key, entry):
        # keep the per-segment key sets in step with LRU pressure —
        # without this they grow one dead tuple per evicted fragment
        # for the segment's whole lifetime
        with self._lock:
            keys = self._seg_keys.get(key[0])
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._seg_keys[key[0]]
        self._sync_bytes()

    def _sync_bytes(self):
        with self._lock:
            now = self._lru.total_bytes
            delta = now - self._gauge_bytes
            self._gauge_bytes = now
        if delta:
            metrics.FRAGMENT_CACHE_BYTES.add(delta)

    def segment_uid(self, seg) -> int:
        """Process-unique id for a segment searcher; registering a
        finalizer so a rebuilt/dropped segment's fragments are purged
        when the object dies (never reachable again anyway — the uid
        dies with it — but the bytes are reclaimed eagerly)."""
        uid = getattr(seg, "_frag_uid", None)
        if uid is None:
            with _uid_lock:
                uid = getattr(seg, "_frag_uid", None)
                if uid is None:
                    uid = next(_uid_counter)
                    seg._frag_uid = uid
                    weakref.finalize(seg, self.drop_segment, uid)
        return uid

    def drop_segment(self, uid: int) -> None:
        """Weakref finalizer target — lock-free by contract (see
        `_pending_drops`); the entries are unreachable the moment the
        segment dies (its uid dies with it), this only defers reclaiming
        their bytes."""
        self._pending_drops.append(uid)

    def _drain_drops(self) -> None:
        if not self._pending_drops:   # steady state: no raise/catch tax
            return
        while True:
            try:
                uid = self._pending_drops.popleft()
            except IndexError:
                return
            with self._lock:
                keys = self._seg_keys.pop(uid, None)
            if keys:
                for k in keys:
                    self._lru.remove(k)
                self._sync_bytes()

    def probe(self, seg, shape: Optional[tuple]):
        """Pure lookup: a copy of the cached value, or None. Bumps NO
        hit/miss gauges and never stores — the batcher's pre-batch probe
        runs ahead of the real lookup, and counting here would double-bill
        fragments the batch dispatch re-probes. Callers that commit to a
        probe's value report it via `count_hits`."""
        self._drain_drops()
        if shape is None or not enabled():
            return None
        hit = self._lru.get((self.segment_uid(seg), shape))
        return None if hit is None else _copy_value(hit)

    def count_hits(self, n: int) -> None:
        """Attribute `n` fragment servings discovered via `probe`."""
        metrics.FRAGMENT_CACHE_HITS.add(n)

    def cached_batch(self, seg, shapes: list, compute_batch) -> list:
        """Per-item memoization over ONE batched compute: probe every
        shape, call compute_batch(miss_indices) once for the misses (it
        must return one value per index, in order), store each under its
        own key. This is what lets a coalesced search batch reuse — and
        feed — the same per-query fragments as solo dispatches. shape=None
        items always compute."""
        self._drain_drops()
        n = len(shapes)
        if not enabled():
            return compute_batch(list(range(n)))
        uid = self.segment_uid(seg)
        results: list = [None] * n
        miss: list[int] = []
        for i, shape in enumerate(shapes):
            hit = self._lru.get((uid, shape)) if shape is not None else None
            if hit is not None:
                metrics.FRAGMENT_CACHE_HITS.add()
                results[i] = _copy_value(hit)
            else:
                if shape is not None:
                    metrics.FRAGMENT_CACHE_MISSES.add()
                miss.append(i)
        if not miss:
            return results
        computed = compute_batch(miss)
        cap = int(_settings_registry.get_global(
            "serene_fragment_cache_mb")) << 20
        stored = False
        for i, value in zip(miss, computed):
            shape = shapes[i]
            if shape is None:
                results[i] = value
                continue
            key = (uid, shape)
            if not self._lru.put(key, value, _value_nbytes(value), cap):
                results[i] = value    # refused (over cap): sole reference
                continue
            with self._lock:
                self._seg_keys.setdefault(uid, set()).add(key)
            stored = True
            results[i] = _copy_value(value)
        if stored:
            self._sync_bytes()
        return results

    def cached(self, seg, shape: Optional[tuple], compute):
        """compute() memoized under (segment uid, shape). shape=None ⇒
        uncacheable query shape ⇒ straight computation. The cache is
        consulted only when the session gate is on, but a fragment
        stored by one session is served to any other — fragments are
        pure functions of immutable segments."""
        self._drain_drops()   # reclaim dead-segment bytes even when gated off
        if shape is None or not enabled():
            return compute()
        uid = self.segment_uid(seg)
        key = (uid, shape)
        hit = self._lru.get(key)
        if hit is not None:
            metrics.FRAGMENT_CACHE_HITS.add()
            return _copy_value(hit)
        metrics.FRAGMENT_CACHE_MISSES.add()
        value = compute()
        cap = int(_settings_registry.get_global(
            "serene_fragment_cache_mb")) << 20
        if not self._lru.put(key, value, _value_nbytes(value), cap):
            return value              # refused (over cap): sole reference
        with self._lock:
            self._seg_keys.setdefault(uid, set()).add(key)
        self._sync_bytes()
        return _copy_value(value)

    def clear(self):
        self._pending_drops.clear()
        self._lru.clear()
        with self._lock:
            self._seg_keys.clear()
        self._sync_bytes()

    def snapshot(self) -> list[dict]:
        self._drain_drops()
        out = []
        for key, e in self._lru.items():
            uid, shape = key
            out.append({
                "tier": "fragment",
                "key": f"seg{uid}:{shape[0]}",
                "query": repr(shape)[:200],
                "queryid": 0,
                "bytes": e.nbytes,
                "hits": e.hits,
                "rows": 0,
                "objects": f"segment:{uid}",
            })
        return out

    def stats(self) -> dict:
        self._drain_drops()
        return {
            "entries": len(self._lru),
            "bytes": self._lru.total_bytes,
            "hits": metrics.FRAGMENT_CACHE_HITS.value,
            "misses": metrics.FRAGMENT_CACHE_MISSES.value,
        }


#: process-wide store (segments are process-wide objects)
FRAGMENTS = FragmentCache()
