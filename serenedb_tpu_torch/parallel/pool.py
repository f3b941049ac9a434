"""Copied from serenedb_tpu/parallel/pool.py.

Shared morsel worker pool: one process-wide set of execution threads.

Reference analog: the reference runs ALL intra-node parallelism over shared
thread pools (DuckDB's TaskScheduler morsel workers plus the iresearch
search/consolidation pools; SURVEY.md §3.2). Concurrent sessions therefore
share ONE pool instead of spawning per-query threads and oversubscribing
the host — the same policy here: a lazily-started singleton sized by the
`serene_workers` global (default = CPU count).

Scheduling has two modes. With `serene_fair_share` OFF it is the
original work-stealing design scaled to morsel granularity: each worker
owns a deque, submissions land round-robin, and an idle worker steals
from the opposite end of a sibling's deque — global FIFO, so one heavy
statement's backlog runs entirely before every later statement's first
task. With `serene_fair_share` ON (the default) tagged tasks instead
land in per-STATEMENT queues and workers pick by stride scheduling:
each statement holds a pass value advanced by `stride = SCALE /
serene_priority` per task run, and the picker takes the head of the
lowest-pass queue — so a dashboard query arriving behind a 6M-row
aggregate waits ~one morsel, not the whole backlog, and a weight-2w
statement gets twice the pool share of a weight-w one. A newly arrived
statement joins at the current minimum pass (it inherits no credit and
owes no debt). Tasks capture the submitter's contextvars
(`contextvars.copy_context`), so executor-level facilities keyed on the
current connection — cooperative cancellation (`plan.check_cancel`),
statement-stable `now()` — keep working on worker threads exactly as
they do inline; the scheduling tag rides the same captured context
(sched.CURRENT_SCHED override, else the connection's per-statement
`_sched` pair).

Determinism contract: the pool never reorders RESULTS, in either mode.
`map_ordered` returns results in submission order and raises the
lowest-index failure after every submitted task has drained, so a
cancelled/failed query can never leave orphan morsels behind to poison
a later query. Fair-share picking therefore changes WHEN morsels run,
never what a query returns (ARCHITECTURE.md §25).
"""

from __future__ import annotations

import collections
import contextvars
import os
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Callable, Iterable, Optional, Sequence

from ..utils import metrics

_TRACE_VAR = None
_SCHED_VAR = None
_CONN_VAR = None


def _trace_var():
    """The obs-layer CURRENT_TRACE contextvar, imported once on first
    use (keeps pool importable without the obs package initialized)."""
    global _TRACE_VAR
    if _TRACE_VAR is None:
        from ..obs.trace import CURRENT_TRACE
        _TRACE_VAR = CURRENT_TRACE
    return _TRACE_VAR


def _sched_var():
    """The sched-layer CURRENT_SCHED override contextvar (lazy for the
    same import-order reason as _trace_var)."""
    global _SCHED_VAR
    if _SCHED_VAR is None:
        from ..sched.governor import CURRENT_SCHED
        _SCHED_VAR = CURRENT_SCHED
    return _SCHED_VAR


def _conn_var():
    global _CONN_VAR
    if _CONN_VAR is None:
        from ..engine import CURRENT_CONNECTION
        _CONN_VAR = CURRENT_CONNECTION
    return _CONN_VAR


def fair_share_enabled() -> bool:
    """The `serene_fair_share` global, read at submit time so a toggle
    applies to new submissions immediately (queued tasks drain from
    whichever structure they landed in)."""
    from ..utils.config import REGISTRY
    try:
        return bool(REGISTRY.get_global("serene_fair_share"))
    except KeyError:                    # pragma: no cover — always declared
        return False


class _Task:
    __slots__ = ("fn", "args", "future", "ctx", "t_submit_ns", "seq")

    def __init__(self, fn, args):
        self.fn = fn
        self.args = args
        self.future: Future = Future()
        self.ctx = contextvars.copy_context()
        self.t_submit_ns = time.perf_counter_ns()
        self.seq = 0                    # global submit order (set by pool)

    def sched(self) -> Optional[tuple]:
        """(tag, weight) scheduling identity from the captured context:
        the explicit CURRENT_SCHED override wins, else the submitting
        connection's per-statement `_sched` pair, else None (untagged —
        FIFO like before)."""
        s = self.ctx.get(_sched_var())
        if s is not None:
            return s
        conn = self.ctx.get(_conn_var())
        if conn is not None:
            return getattr(conn, "_sched", None)
        return None


#: stride scale: weights are clamped to 1..10000 (serene_priority), so
#: strides span SCALE/10000 .. SCALE with integer math throughout
_STRIDE_SCALE = 10_000_000


class _FairQueue:
    """One statement's queued tasks + stride state (guarded by the
    pool's lock)."""

    __slots__ = ("tasks", "pass_", "stride")

    def __init__(self, pass_: int, weight: int):
        self.tasks: collections.deque = collections.deque()
        self.pass_ = pass_
        self.stride = _STRIDE_SCALE // max(1, min(10000, int(weight)))


class WorkerPool:
    """Work-stealing thread pool; see module docstring for the contract."""

    def __init__(self, size: int):
        self.size = max(1, int(size))
        self._deques: list[collections.deque] = [
            collections.deque() for _ in range(self.size)]
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._threads: list[threading.Thread] = []
        self._worker_ids: set[int] = set()
        self._rr = 0
        self._seq = 0
        self._shutdown = False
        # fair-share state (serene_fair_share): per-statement-tag task
        # queues + stride bookkeeping, all under the pool lock. Tags
        # leave the dict the moment their queue drains; a returning tag
        # re-joins at the floor (the last dispatched pass), so pausing
        # between morsel windows accrues neither credit nor debt.
        self._fair: dict[object, _FairQueue] = {}
        self._fair_floor = 0

    # -- lifecycle ---------------------------------------------------------

    def ensure_started(self) -> "WorkerPool":
        with self._lock:
            if self._threads or self._shutdown:
                return self
            for wid in range(self.size):
                t = threading.Thread(target=self._worker, args=(wid,),
                                     name=f"sdb-morsel-{wid}", daemon=True)
                self._threads.append(t)
            for t in self._threads:
                t.start()
        return self

    def shutdown(self):
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    @property
    def in_worker(self) -> bool:
        """True when the calling thread IS a pool worker — nested fan-out
        must run inline (a saturated pool waiting on itself deadlocks)."""
        return threading.get_ident() in self._worker_ids

    # -- submission --------------------------------------------------------

    def submit(self, fn: Callable, *args) -> Future:
        task = _Task(fn, args)
        sched = task.sched() if fair_share_enabled() else None
        with self._cv:
            if self._shutdown:
                raise RuntimeError("worker pool is shut down")
            self._seq += 1
            task.seq = self._seq
            if sched is not None:
                self._fair_push(task, sched[0], sched[1])
            else:
                self._deques[self._rr % self.size].append(task)
                self._rr += 1
            metrics.POOL_QUEUE_DEPTH.add()
            self._cv.notify()
        if not self._threads:
            self.ensure_started()
        return task.future

    # -- fair-share structure (all under self._lock) -----------------------

    def _fair_push(self, task: _Task, tag, weight) -> None:
        q = self._fair.get(tag)
        if q is None:
            # join at the current minimum pass: the newcomer's next pick
            # competes on equal terms — no banked credit from having
            # been absent, no debt from others' progress
            base = min((fq.pass_ for fq in self._fair.values()),
                       default=self._fair_floor)
            q = self._fair[tag] = _FairQueue(base, weight)
        q.tasks.append(task)

    def _pop_fair(self) -> Optional[_Task]:
        """Stride pick: head of the lowest-pass queue (ties broken by
        the head task's global submit order — deterministic, and exact
        FIFO when every weight is equal and passes tie). Counts a
        preemption whenever the pick is NOT the FIFO-oldest queued
        task — each one is an interleave plain FIFO would not have
        done."""
        if not self._fair:
            return None
        best = None
        best_key = None
        fifo_seq = None
        for tag, q in self._fair.items():
            head_seq = q.tasks[0].seq
            key = (q.pass_, head_seq)
            if best_key is None or key < best_key:
                best_key, best = key, tag
            if fifo_seq is None or head_seq < fifo_seq:
                fifo_seq = head_seq
        q = self._fair[best]
        task = q.tasks.popleft()
        q.pass_ += q.stride
        self._fair_floor = q.pass_
        if not q.tasks:
            del self._fair[best]
        if task.seq != fifo_seq:
            metrics.SCHED_PREEMPTIONS.add()
        return task

    def map_ordered(self, fn: Callable, items: Sequence,
                    parallelism: Optional[int] = None) -> list:
        """Run fn over items on the pool; results in ITEM order.

        Every submitted task drains (runs or is cancelled-before-start)
        before this returns or raises; on failure the lowest-index
        exception is raised. parallelism bounds this CALL's in-flight
        tasks (per-session `serene_workers` cap) without resizing the
        shared pool.
        """
        items = list(items)
        cap = self.size if parallelism is None else min(parallelism, self.size)
        if len(items) <= 1 or cap <= 1 or self.in_worker:
            return [fn(it) for it in items]
        # window == cap: at most `cap` tasks in flight (queued + running),
        # so a session's serene_workers cap truly bounds its parallelism
        # even when more pool workers are idle
        window = cap
        futs: list[Optional[Future]] = [None] * len(items)
        results: list = [None] * len(items)
        first_exc: Optional[BaseException] = None
        submitted = 0

        def pump():
            nonlocal submitted
            while submitted < len(items) and first_exc is None and \
                    submitted - drained < window:
                futs[submitted] = self.submit(fn, items[submitted])
                submitted += 1

        drained = 0
        pump()
        while drained < submitted:
            f = futs[drained]
            try:
                if not f.done():
                    # live wait-event feed for pg_stat_activity: the
                    # session blocks here while its morsel tasks queue
                    # or run — the live counterpart of the queue_wait
                    # span the worker stamps retrospectively
                    from ..obs.resources import wait_scope
                    with wait_scope("IPC", "PoolTaskWait"):
                        results[drained] = f.result()
                else:
                    results[drained] = f.result()
            except CancelledError:
                pass  # cancelled after an earlier failure: already drained
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first_exc is None:
                    first_exc = e
                    for g in futs[drained + 1:submitted]:
                        if g is not None:
                            g.cancel()
            drained += 1
            pump()
        if first_exc is not None:
            raise first_exc
        return results

    # -- worker loop -------------------------------------------------------

    def _pop_task(self, wid: int) -> Optional[_Task]:
        task = None
        dq = self._deques[wid]
        if dq:
            task = dq.popleft()
        else:
            for off in range(1, self.size):
                other = self._deques[(wid + off) % self.size]
                if other:
                    task = other.pop()   # steal from the opposite end
                    metrics.POOL_STEALS.add()
                    break
        if task is None:
            # fair-share tier: tagged tasks live in per-statement
            # queues picked by stride, not in the worker deques (the
            # deques keep serving untagged/legacy submissions, and
            # drain a mid-toggle backlog either way)
            task = self._pop_fair()
        if task is not None:
            # the task left the queue (will run or was cancelled while
            # queued) — the live-depth gauge drops either way
            metrics.POOL_QUEUE_DEPTH.sub()
        return task

    def _worker(self, wid: int):
        self._worker_ids.add(threading.get_ident())
        while True:
            with self._cv:
                task = self._pop_task(wid)
                while task is None and not self._shutdown:
                    self._cv.wait()
                    task = self._pop_task(wid)
                if task is None:   # shutdown
                    return
            f = task.future
            if not f.set_running_or_notify_cancel():
                continue           # cancelled while queued: drained, no run
            t0 = time.perf_counter_ns()
            wait_ns = t0 - task.t_submit_ns
            metrics.POOL_QUEUE_WAIT_US.add(wait_ns // 1000)
            metrics.POOL_TASK_WAIT_NS.add(wait_ns)
            metrics.POOL_QUEUE_WAIT_HIST.observe_ns(wait_ns)
            # timeline attribution: the submitter's trace rides the
            # task's captured context — one mapping lookup per TASK
            # (morsel-sized, never per row), two span appends when a
            # traced statement submitted it
            trace = task.ctx.get(_trace_var())
            if trace is not None:
                trace.add("queue_wait", "pool", task.t_submit_ns, t0)
            metrics.POOL_RUNNING.add()
            try:
                result = task.ctx.run(task.fn, *task.args)
                exc = None
            except BaseException as e:  # noqa: BLE001 — delivered via future
                exc = e
            t1 = time.perf_counter_ns()
            metrics.POOL_RUNNING.sub()
            metrics.POOL_MORSELS.add()
            metrics.POOL_BUSY_US.add((t1 - t0) // 1000)
            # the task span MUST be in the ring before the future
            # resolves: delivering the result wakes the statement
            # thread, which may finalize the trace immediately — a span
            # stamped after that is lost (or outlives the timeline)
            if trace is not None:
                trace.add("task", "pool", t0, t1)
            if exc is not None:
                f.set_exception(exc)
            else:
                f.set_result(result)


# -- process-wide singleton -------------------------------------------------

_POOL: Optional[WorkerPool] = None
_POOL_LOCK = threading.Lock()


def default_workers() -> int:
    return os.cpu_count() or 1


def get_pool() -> WorkerPool:
    """The process-wide shared pool, sized from the `serene_workers`
    GLOBAL at first use (sessions cap their own parallelism per query via
    the session-scope value; the pool itself is shared and fixed).
    Floor of 2: a single-thread pool would silently disable every
    parallel tier even for sessions that raise their own
    serene_workers — on a 1-core host the GIL-releasing numpy morsel
    work still overlaps, and sessions that want inline execution say
    `SET serene_workers = 1`, which bypasses the pool entirely."""
    global _POOL
    pool = _POOL
    if pool is not None:
        return pool
    with _POOL_LOCK:
        if _POOL is None:
            from ..utils.config import REGISTRY
            try:
                size = int(REGISTRY.get_global("serene_workers"))
            except KeyError:
                size = default_workers()
            _POOL = WorkerPool(max(2, size))
        return _POOL


def session_workers(settings) -> int:
    """Per-query parallelism cap (>=1). settings=None → the executing
    connection's session settings when inside a statement, else the
    global default (library callers outside any session)."""
    if settings is None:
        from ..engine import CURRENT_CONNECTION
        conn = CURRENT_CONNECTION.get()
        if conn is not None:
            settings = conn.settings
    try:
        if settings is not None:
            w = int(settings.get("serene_workers"))
        else:
            from ..utils.config import REGISTRY
            w = int(REGISTRY.get_global("serene_workers"))
    except KeyError:
        w = default_workers()
    return max(1, w)


def parallel_map(settings, fn: Callable, items: Iterable) -> list:
    """map_ordered over the shared pool, capped by the session's
    `serene_workers`; runs inline when the cap (or item count) is 1."""
    items = list(items)
    cap = session_workers(settings)
    if cap <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    return get_pool().ensure_started().map_ordered(fn, items, cap)
