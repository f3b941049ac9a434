"""Copied from serenedb_tpu/obs/resources.py.

Resource observability: per-query memory accounting, live query
progress, and PG-style wait events (`serene_mem_account`).

The tracer gives every query a TIME axis (span timelines, latency
histograms); this module is the RESOURCE axis — the prerequisite for
admission control and `serene_work_mem` budgets: you cannot enforce a
memory ceiling you cannot observe.

Three facilities share one per-statement object:

- **MemoryAccountant** — live/peak byte accounting charged at the
  sites the profiler already instruments: operator batch
  materialization (`batch_nbytes`), join build/probe sides and pair
  arrays, sort buffers, morsel partials, device uploads (the
  DEVICE_CACHE byte math), result-cache stores. Accumulation is
  per-worker-thread and lock-free after first touch (the QueryProfile
  bucket pattern); the sink merge SUMS per-thread peaks, so the merged
  peak is a sound upper bound on the true simultaneous peak: at any
  instant t, total live = Σ_threads live_t(thread) ≤ Σ_threads
  max_t live(thread). Charging at materialization sites bounds the
  true peak because every byte a query holds was materialized at one
  of them.

- **Query progress** — the same per-thread buckets count rows/bytes
  processed and morsels scheduled/completed, and the accountant
  registers in the process-wide ACTIVE registry for its statement's
  lifetime, so `sdb_query_progress()` / `GET /progress` show a RUNNING
  6M-row aggregate advancing instead of a blank until it finishes
  (the pg_stat_progress_* analog).

- **Wait events** — `wait_scope()` feeds the executing session's
  pg_stat_activity row live from the blocking sites the timeline layer
  already stamps retrospectively (worker-pool task waits, search-batch
  coalescing waits, collective shard combines), PG's
  wait_event_type/wait_event shape.

Determinism contract (same as `serene_profile`/`serene_trace`):
accounting observes, never steers. No executor reads the accountant
back, so results are bit-identical with `serene_mem_account` on or off
at any worker/shard count — asserted by tests/test_resources.py's
parity matrix, and the setting is deliberately NOT in the result
cache's RESULT_AFFECTING_SETTINGS digest.

Propagation rides the existing CURRENT_TRACE machinery: the statement
publishes its accountant through the CURRENT_MEM contextvar, pool
tasks capture the submitter's context at submit time
(contextvars.copy_context in parallel/pool.py), so worker-thread
charges land in the right query's account with zero extra plumbing.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import Optional

from ..utils import metrics

#: the executing statement's MemoryAccountant (None outside an
#: accounted statement). Pool tasks capture the submitter's context at
#: submit time, so worker-thread charges land in the right query.
CURRENT_MEM: contextvars.ContextVar = contextvars.ContextVar(
    "sdb_current_mem", default=None)

_QUERY_IDS = itertools.count(1)


def current_accountant() -> Optional["MemoryAccountant"]:
    """The executing statement's accountant, or None (accounting off /
    outside a statement). One contextvar read — hot-path cheap."""
    return CURRENT_MEM.get()


class _MemBucket:
    """One thread's accumulation state: per-key [live, peak] pairs plus
    the thread-level live/peak roll-up and progress counters. Touched
    only by its owning thread (no lock after first touch)."""

    __slots__ = ("ops", "live", "peak", "rows", "bytes",
                 "morsels_done", "morsels_scheduled", "events")

    def __init__(self):
        self.ops: dict[object, list] = {}
        self.live = 0
        self.peak = 0
        self.rows = 0
        self.bytes = 0
        self.morsels_done = 0
        self.morsels_scheduled = 0
        self.events = 0


class MemoryAccountant:
    """Per-query live/peak byte accounting + progress counters.

    Charge/release are per-BATCH or per-morsel events (never per row),
    one thread-local dict access plus integer adds each — the same
    <3% budget as the profiler (mem_overhead bench shape). A release
    may land on a different thread than its charge (a coordinating
    thread retiring worker-produced partials): that thread's live goes
    negative, the SUMMED live stays exact, and per-thread peaks remain
    valid upper bounds on what each thread materialized.
    """

    __slots__ = ("query_id", "pid", "query", "t0_ns", "t0_epoch",
                 "current_op", "_register_lock", "_buckets", "_tl",
                 "_cv_token")

    def __init__(self, query_text: str = "", pid: int = 0):
        self.query_id = next(_QUERY_IDS)
        self.pid = pid
        self.query = (query_text or "")[:500]
        self.t0_ns = time.perf_counter_ns()
        self.t0_epoch = time.time()
        #: last operator label any thread stamped (single slot; racy
        #: writes are benign — any recently-active operator is a
        #: truthful answer to "what is it doing right now")
        self.current_op = ""
        self._register_lock = threading.Lock()
        self._buckets: list[_MemBucket] = []
        self._tl = threading.local()
        self._cv_token = None

    # -- accumulation (any thread) ----------------------------------------

    def _bucket(self) -> _MemBucket:
        b = getattr(self._tl, "b", None)
        if b is None:
            b = self._tl.b = _MemBucket()
            with self._register_lock:
                self._buckets.append(b)
        return b

    def charge(self, key, nbytes: int) -> None:
        """Materialization of `nbytes` attributed to operator `key`
        (id(plan node), or a string label for non-node sites)."""
        n = int(nbytes)
        b = self._bucket()
        e = b.ops.get(key)
        if e is None:
            e = b.ops[key] = [0, 0]
        e[0] += n
        if e[0] > e[1]:
            e[1] = e[0]
        b.live += n
        if b.live > b.peak:
            b.peak = b.live
        b.events += 1

    def release(self, key, nbytes: int) -> None:
        """The buffer charged to `key` was consumed/dropped."""
        n = int(nbytes)
        b = self._bucket()
        e = b.ops.get(key)
        if e is None:
            e = b.ops[key] = [0, 0]
        e[0] -= n
        b.live -= n
        b.events += 1

    def charge_once(self, key, nbytes: int) -> None:
        """A transient materialization (device upload, cache store)
        whose lifetime the query does not own: records the bytes in the
        key's and query's PEAK without leaving them live."""
        self.charge(key, nbytes)
        self.release(key, nbytes)

    def add_progress(self, rows: int = 0, nbytes: int = 0,
                     morsels: int = 0) -> None:
        b = self._bucket()
        b.rows += int(rows)
        b.bytes += int(nbytes)
        b.morsels_done += int(morsels)

    def add_morsels_scheduled(self, n: int) -> None:
        self._bucket().morsels_scheduled += int(n)

    def set_op(self, label: str) -> None:
        self.current_op = label

    # -- sink merge --------------------------------------------------------

    def merged(self) -> dict:
        """{key: (live, peak)} summed across thread buckets. Integer
        addition is order-free; per-key peak = Σ per-thread peaks (the
        upper-bound argument in the module docstring)."""
        with self._register_lock:
            buckets = list(self._buckets)
        out: dict = {}
        for b in buckets:
            for key, (live, peak) in b.ops.items():
                agg = out.get(key)
                if agg is None:
                    out[key] = [live, peak]
                else:
                    agg[0] += live
                    agg[1] += peak
        return {k: (v[0], v[1]) for k, v in out.items()}

    def totals(self) -> tuple[int, int]:
        """(live, peak) across all threads; peak is the query-level
        upper bound (Σ per-thread peaks)."""
        with self._register_lock:
            buckets = list(self._buckets)
        live = peak = 0
        for b in buckets:
            live += b.live
            peak += b.peak
        return live, peak

    def event_count(self) -> int:
        """Charge/release events recorded — the direct-decomposition
        input for the mem_overhead bench shape."""
        with self._register_lock:
            buckets = list(self._buckets)
        return sum(b.events for b in buckets)

    def progress(self) -> dict:
        """One live row for sdb_query_progress() / GET /progress."""
        with self._register_lock:
            buckets = list(self._buckets)
        rows = nbytes = done = sched = live = peak = 0
        for b in buckets:
            rows += b.rows
            nbytes += b.bytes
            done += b.morsels_done
            sched += b.morsels_scheduled
            live += b.live
            peak += b.peak
        return {"pid": self.pid, "query_id": self.query_id,
                "query": self.query[:200], "operator": self.current_op,
                "morsels_scheduled": sched, "morsels_done": done,
                "rows": rows, "bytes": nbytes,
                "live_bytes": live, "peak_bytes": peak,
                "elapsed_ms": round(
                    (time.perf_counter_ns() - self.t0_ns) / 1e6, 3)}

    # -- per-batch generator wrapper (exec/plan.py auto-wrap) --------------

    def wrap_batches(self, node, it):
        """Charge each batch an operator emits for exactly the window
        until its consumer pulls the next one (or the operator closes):
        the streaming tree's live set is then "one in-flight batch per
        operator", and peaks capture the widest batch each operator
        materialized. Also feeds rows/bytes progress and the
        current-operator label."""
        from .trace import batch_nbytes
        key = id(node)
        label = node.label()
        prev = 0
        try:
            for b in it:
                if prev:
                    self.release(key, prev)
                nb = batch_nbytes(b)
                self.charge(key, nb)
                prev = nb
                self.add_progress(rows=b.num_rows, nbytes=nb)
                self.current_op = label
                yield b
        finally:
            if prev:
                self.release(key, prev)
            close = getattr(it, "close", None)
            if close is not None:
                close()


# -- live-statement registry (sdb_query_progress / GET /progress) ------------


class ActiveQueries:
    """Process-wide registry of executing statements' accountants. One
    short lock per statement BEGIN/END (never inside execution);
    snapshots read each accountant's per-thread buckets live."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: dict[int, MemoryAccountant] = {}

    def register(self, acct: MemoryAccountant) -> None:
        with self._lock:
            self._active[acct.query_id] = acct

    def retire(self, acct: Optional[MemoryAccountant]) -> None:
        if acct is None:
            return
        with self._lock:
            self._active.pop(acct.query_id, None)

    def snapshot(self) -> list[dict]:
        """Progress rows of every running statement, oldest first."""
        with self._lock:
            accts = list(self._active.values())
        return [a.progress() for a in accts]


#: process-wide registry (one per process, like the flight recorder)
ACTIVE = ActiveQueries()


# -- wait events (pg_stat_activity) ------------------------------------------


class wait_scope:
    """Publish the executing session's current wait into its
    pg_stat_activity row (PG wait_event_type/wait_event) for the
    duration of a blocking section. Reads the connection from
    CURRENT_CONNECTION lazily; free when no session is executing.
    Nested scopes restore what they found. Plain class (not
    @contextmanager): the generator protocol costs a frame per entry
    and these sit on per-task wait paths."""

    __slots__ = ("etype", "event", "_sess", "_prev")

    def __init__(self, etype: str, event: str):
        self.etype = etype
        self.event = event
        self._sess = None
        self._prev = None

    def __enter__(self):
        from ..engine import CURRENT_CONNECTION
        conn = CURRENT_CONNECTION.get()
        if conn is not None:
            sess = conn.db.sessions.get(conn._session_id)
            if sess is not None:
                self._sess = sess
                self._prev = (sess.get("wait_event_type"),
                              sess.get("wait_event"))
                sess["wait_event_type"] = self.etype
                sess["wait_event"] = self.event
        return self

    def __exit__(self, *exc):
        sess = self._sess
        if sess is not None:
            sess["wait_event_type"], sess["wait_event"] = self._prev
            self._sess = None
        return False


# -- non-node charge sites (contextvar-routed) --------------------------------


def charge_device_upload(nbytes: int) -> None:
    """Device-cache upload attribution: the query that caused a
    host→device transfer records the bytes in its peak under the
    'device_upload' key (the upload outlives the query inside
    DEVICE_CACHE, so it is a charge_once — peak attribution, not a
    lasting live balance)."""
    acct = CURRENT_MEM.get()
    if acct is not None:
        acct.charge_once("device_upload", nbytes)


def charge_cache_store(nbytes: int) -> None:
    """Result-cache store attribution ('result_cache_store' key): the
    stored copy belongs to the cache, the store-time materialization
    belongs to this query's peak."""
    acct = CURRENT_MEM.get()
    if acct is not None:
        acct.charge_once("result_cache_store", nbytes)


# -- process-level gauges (RSS / uptime / GC) --------------------------------

#: process start reference for the uptime gauge
_PROCESS_T0 = time.monotonic()
_PAGE_SIZE: Optional[int] = None


def _page_size() -> int:
    global _PAGE_SIZE
    if _PAGE_SIZE is None:
        import os
        try:
            _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
        except (ValueError, OSError, AttributeError):
            _PAGE_SIZE = 4096
    return _PAGE_SIZE


def read_rss_bytes() -> int:
    """Resident set size from /proc/self/statm (field 2 × page size) —
    no psutil dependency; 0 on platforms without procfs."""
    try:
        with open("/proc/self/statm", "rb") as f:
            fields = f.read().split()
        return int(fields[1]) * _page_size()
    except (OSError, IndexError, ValueError):
        return 0


def sample_process_gauges() -> None:
    """Refresh the process-level gauges (RSS, uptime, GC collection
    counts). Called at scrape/render time (obs/export.py, the
    sdb_metrics view) and by the maintenance ticker — never on query
    hot paths."""
    import gc
    rss = read_rss_bytes()
    if rss:
        metrics.PROCESS_RSS_BYTES.set(rss)
    metrics.PROCESS_UPTIME_SECONDS.set(
        int(time.monotonic() - _PROCESS_T0))
    # socket write buffers (slow readers) across open front-door
    # connections — sampled here so /metrics and /_stats read fresh
    from ..sched.governor import CONNGATE
    CONNGATE.buffered_bytes()
    try:
        stats = gc.get_stats()
        gauges = (metrics.GC_GEN0_COLLECTIONS,
                  metrics.GC_GEN1_COLLECTIONS,
                  metrics.GC_GEN2_COLLECTIONS)
        for g, s in zip(gauges, stats):
            g.set(int(s.get("collections", 0)))
    except Exception:       # pragma: no cover — gc.get_stats is CPython
        pass


def fmt_kb(nbytes: int) -> str:
    """PG-style kB rendering for EXPLAIN ANALYZE Memory lines."""
    return f"{max(int(nbytes), 0) // 1024}kB"
