"""Copied from serenedb_tpu/search/batcher.py.

Search query batcher: coalesce concurrent top-k queries into one
ragged scoring dispatch per (searcher, k, scorer, mesh) group.

Production search traffic is thousands of concurrent SMALL queries over
the SAME index data — each paying full scoring-dispatch overhead alone.
This module is the serving-side fix (ROADMAP "batched ragged search
serving"; the shape of Ragged Paged Attention's ragged-batch kernel and
GPUSparse's parallel inverted indices): queries arriving within a short
window fold into one `MultiSearcher.topk_batch` call, which scores them
in a single vectorized pass per segment over the shared postings/norms
(ragged per-query term lists — search/searcher._ragged_resolve on the
host backend, the batched plane kernel on devices). With
`serene_posting_pool` on, the coalesced dispatch is the one that never
leaves the device: page-resident batches score as ONE jitted
gather-and-accumulate program over the pool's HBM page tables
(search/posting_pool.py), and a warm repeat uploads zero posting bytes.

Coalescing is group-commit shaped, so an idle system never waits:

- a query that is the only active submitter of its group dispatches
  IMMEDIATELY (zero added latency for serial workloads — tier-1 runs
  with batching on and pays nothing);
- while a dispatch is in flight, arrivals queue behind it and fold into
  the next dispatch the moment it completes — the in-flight dispatch IS
  the batching window under sustained load;
- `serene_search_batch_window_ms` bounds how long a query may wait for
  company when other submitters are active but not yet queued, and
  `serene_search_batch_max` caps queries per dispatch.

Parity contract: per-query results are BIT-IDENTICAL to serial dispatch
(scores, doc ids, tie order) — per-query scoring is batch-composition-
independent in every kernel path (asserted by tests/test_search_batch.py
across batched on/off × workers × cache states), so `serene_search_batch
= off` remains a pure serial oracle, the serene_join_vectorized=off
pattern, and the setting stays OUT of the result cache's
RESULT_AFFECTING_SETTINGS digest.

Error isolation: a dispatch that raises marks every member for SERIAL
RETRY on its own submitter thread — a poisoned query fails only its own
caller (with its own context/cancellation), never its batch siblings.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from ..utils import metrics
from ..utils.config import REGISTRY as _settings_registry

#: process-wide dispatch sequence: every coalesced dispatch gets one id,
#: stamped into each member's batch_dispatch span so a timeline reader
#: (or test) can see WHICH queries shared a scoring pass
_DISPATCH_SEQ = itertools.count(1)


class _Entry:
    __slots__ = ("node", "done", "retry", "result", "n_batch",
                 "window_ns", "scoring_ns", "t_submit_ns", "trace")

    def __init__(self, node):
        self.node = node
        self.done = False
        self.retry = False
        self.result = None
        self.n_batch = 1
        self.window_ns = 0
        self.scoring_ns = 0
        self.t_submit_ns = time.perf_counter_ns()
        # the submitter's timeline (None when tracing is off): a
        # coalesced dispatch stamps its window/scoring spans under
        # EVERY member query's trace, so each member's timeline shows
        # both the wait it paid and the shared dispatch it rode
        from ..obs.trace import current_trace
        self.trace = current_trace()


class _Group:
    """Transient per-(searcher, k, scorer, mesh) coalescing state. Holds
    the searcher STRONGLY while live, so the id() in the group key can
    never alias a dead searcher's recycled address. Each group waits on
    its OWN condition (sharing the batcher lock), so a dispatch
    completing wakes only its group's waiters — with dozens of
    submitter threads a single shared condition turns every completion
    into an O(waiters) GIL stampede."""

    __slots__ = ("searcher", "queue", "dispatching", "active", "cv")

    def __init__(self, searcher, lock):
        self.searcher = searcher
        self.queue: list[_Entry] = []
        self.dispatching = False
        self.active = 0
        self.cv = threading.Condition(lock)


class SearchBatcher:
    def __init__(self):
        self._lock = threading.Lock()
        self._groups: dict[tuple, _Group] = {}

    def submit(self, searcher, node, k: int, scorer: str, mesh_n: int,
               window_s: float, batch_max: int,
               ) -> tuple[tuple, Optional[dict]]:
        """Coalesce-and-score one query; blocks until its result is ready.
        Returns ((scores, docs), stats) with stats carrying the batch
        span counters for the profiler."""
        key = (id(searcher), int(k), scorer, int(mesh_n))
        e = _Entry(node)
        deadline = time.monotonic() + window_s
        batch = None
        with self._lock:
            g = self._groups.get(key)
            if g is None or g.searcher is not searcher:
                g = self._groups[key] = _Group(searcher, self._lock)
            g.active += 1
            g.queue.append(e)
            try:
                while not e.done and not e.retry:
                    now = time.monotonic()
                    if not g.dispatching and (
                            len(g.queue) >= batch_max or
                            now >= deadline or
                            g.active <= len(g.queue)):
                        # claim the dispatch: this entry plus the oldest
                        # queued others (up to the cap) score in one
                        # ragged pass on THIS thread. Own entry ALWAYS
                        # rides its own claim — leaving it queued while
                        # falling back serially would orphan it (scored
                        # twice by a later claimer, or pinning the group
                        # forever if nobody else arrives).
                        g.queue.remove(e)
                        batch = [e] + g.queue[:batch_max - 1]
                        del g.queue[:batch_max - 1]
                        g.dispatching = True
                        break
                    # bounded waits only: re-check conditions even if a
                    # wakeup is lost, and honor the window deadline.
                    # The wait publishes live into the session's
                    # pg_stat_activity row (the batch_wait span's live
                    # counterpart).
                    from ..obs.resources import wait_scope
                    with wait_scope("IPC", "SearchBatchWait"):
                        if g.dispatching:
                            g.cv.wait(0.25)
                        else:
                            g.cv.wait(
                                min(max(deadline - now, 0.0002), 0.05))
            finally:
                if batch is None:
                    self._release(key, g)
        if batch is not None:
            try:
                self._dispatch(g, batch, k, scorer, mesh_n)
            finally:
                with self._lock:
                    self._release(key, g)
        if e.retry or (batch is not None and not e.done):
            # dispatch failed (every member lands here, each on its own
            # thread): serial fallback, so the caller's context/
            # cancellation apply and a poisoned sibling can't take this
            # query down
            out = searcher.topk_batch([node], k, scorer, mesh_n=mesh_n)[0]
            return out, {"queries": 1, "window_ns": 0, "scoring_ns": 0}
        return e.result, {"queries": e.n_batch, "window_ns": e.window_ns,
                          "scoring_ns": e.scoring_ns}

    def _release(self, key, g: _Group) -> None:
        """Caller MUST hold the lock: retire one submitter and drop the
        group when idle. Queued waiters' dispatch-eligibility may have
        changed (`active` shrank toward the queue length) — wake them;
        with nothing queued there is nobody to wake."""
        g.active -= 1
        if g.active <= 0 and not g.queue and not g.dispatching:
            cur = self._groups.get(key)
            if cur is g:
                del self._groups[key]
        elif g.queue:
            g.cv.notify_all()

    def _dispatch(self, g: _Group, batch: list[_Entry], k: int,
                  scorer: str, mesh_n: int) -> None:
        """Score one claimed batch and hand each member its result. On
        ANY failure every member retries serially on its own thread."""
        t0 = time.perf_counter_ns()
        outs = None
        try:
            outs = g.searcher.topk_batch([x.node for x in batch], k,
                                         scorer, mesh_n=mesh_n,
                                         ragged=True)
        except BaseException:
            outs = None   # members retry serially; the bad one re-raises
        t1 = time.perf_counter_ns()
        wait_ns = 0
        seq = next(_DISPATCH_SEQ) if outs is not None else 0
        with self._lock:
            g.dispatching = False
            for i, x in enumerate(batch):
                if outs is not None:
                    x.result = outs[i]
                    x.n_batch = len(batch)
                    x.window_ns = max(t0 - x.t_submit_ns, 0)
                    x.scoring_ns = t1 - t0
                    wait_ns += x.window_ns
                    if x.trace is not None:
                        # per-member timeline: how long THIS query
                        # waited queued, then the shared scoring
                        # dispatch it rode. Stamped from the
                        # dispatching thread BEFORE x.done releases the
                        # member — its statement cannot finalize its
                        # trace until these spans are in the rings
                        if x.window_ns:
                            x.trace.add("batch_wait", "search",
                                        x.t_submit_ns, t0)
                        x.trace.add("batch_dispatch", "search", t0, t1,
                                    queries=len(batch), dispatch=seq)
                    x.done = True
                else:
                    x.retry = True
            g.cv.notify_all()
        if outs is not None:
            metrics.SEARCH_BATCH_DISPATCHES.add()
            metrics.SEARCH_BATCH_QUERIES.add(len(batch))
            metrics.SEARCH_BATCH_WINDOW_WAIT_NS.add(wait_ns)
            if len(batch) > 1:
                metrics.SEARCH_BATCH_COALESCED.add(len(batch))
            for x in batch:
                metrics.SEARCH_BATCH_WINDOW_HIST.observe_ns(x.window_ns)


#: process-wide batcher (searcher groups are process-wide objects)
BATCHER = SearchBatcher()


def batched_topk(searcher, node, k: int, scorer: str = "bm25",
                 mesh_n: int = 0, settings=None,
                 ) -> tuple[tuple, Optional[dict]]:
    """Serving entry point for every top-k consumer (SQL `@@@`/bm25()
    scans, ES `_search`/`_msearch` via those scans): route one query
    through the batcher when `serene_search_batch` is on, else dispatch
    serially (the parity oracle). Fragment-cache hits are probed FIRST
    and returned immediately — a cached query never waits out a window or
    occupies a batch slot; misses store per-query after the batch scores.
    Returns ((scores, docs), batch-stats-or-None)."""
    try:
        if settings is not None:
            on = bool(settings.get("serene_search_batch"))
        else:
            on = bool(_settings_registry.get_global("serene_search_batch"))
    except KeyError:                                   # pragma: no cover
        on = False
    if not on:
        return searcher.topk(node, k, scorer, mesh_n=mesh_n), None
    hit = searcher.probe_topk(node, k, scorer, mesh_n)
    if hit is not None:
        return hit, None
    window_s = max(float(_settings_registry.get_global(
        "serene_search_batch_window_ms")), 0.0) / 1000.0
    batch_max = max(int(_settings_registry.get_global(
        "serene_search_batch_max")), 1)
    return BATCHER.submit(searcher, node, k, scorer, mesh_n, window_s,
                          batch_max)
