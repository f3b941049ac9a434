"""Copied from serenedb_tpu/obs/trace.py.

Lock-cheap per-query span/profile collector.

Reference analog: ClickHouse's per-query ProfileEvents and PG's
EXPLAIN ANALYZE instrumentation, re-expressed for the morsel/batch
executor: every PlanNode's batch generator is wrapped (exec/plan.py
auto-wraps subclasses), and the fused morsel pipeline stamps its stage
work directly (exec/morsel.py), so both the streaming operator tree and
the worker-pool path are covered by ONE collector.

Determinism contract: profiling observes, never steers. Each executing
thread accumulates into its own bucket (a thread-local dict — no lock on
the hot path after first touch); the sink merges buckets by summing
integer counters, so the merged numbers are independent of scheduling
order and the query result is bit-identical with profiling on or off at
any `serene_workers`. Wall/CPU nanoseconds in morsel pipelines are
summed per-worker task times (they can exceed elapsed wall clock on
purpose — that is the work the pool did).
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import OrderedDict
from typing import Iterator, Optional

from ..utils import metrics

#: additive per-operator counters (merge = sum; scheduling-order free)
_COUNTERS = ("wall_ns", "cpu_ns", "rows_out", "batches", "bytes_out",
             "loops", "morsels_scheduled", "morsels_pruned",
             "morsels_jf_pruned", "device_ns", "batch_queries",
             "batch_window_ns", "batch_scoring_ns", "shard_pipelines",
             "shard_pruned", "shard_collective",
             "device_prog_hits", "device_prog_misses")


class OpStats:
    """One operator's accumulated span counters (one bucket's view)."""

    __slots__ = _COUNTERS + ("first_ns", "device_declined")

    def __init__(self):
        for f in _COUNTERS:
            setattr(self, f, 0)
        #: the operator's accumulated wall ns at its FIRST emitted batch
        #: (PG "startup time"; merge = min, thread-order free)
        self.first_ns: Optional[int] = None
        #: fused-tier decline reason slug (non-additive: one execution
        #: declines for one reason; merge keeps any observed value)
        self.device_declined: Optional[str] = None

    def merge(self, other: "OpStats") -> None:
        for f in _COUNTERS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        if other.first_ns is not None:
            self.first_ns = other.first_ns if self.first_ns is None \
                else min(self.first_ns, other.first_ns)
        if other.device_declined is not None:
            self.device_declined = other.device_declined


def batch_nbytes(b) -> int:
    """Materialized bytes of a batch's physical arrays (dictionary pages
    are shared, not per-batch — excluded)."""
    return sum(int(c.data.nbytes) for c in b.columns)


class QueryProfile:
    """Per-query collector keyed by id(plan node).

    Hot-path cost is one thread-local dict lookup plus integer adds per
    BATCH (never per row); batches are morsel-sized, so the budget is
    <3% on the profile_overhead bench shape.
    """

    def __init__(self):
        self._register_lock = threading.Lock()
        self._buckets: list[dict[int, OpStats]] = []
        self._tl = threading.local()
        self.t0_ns = time.perf_counter_ns()

    # -- accumulation (any thread) ----------------------------------------

    def _bucket(self) -> dict[int, OpStats]:
        d = getattr(self._tl, "d", None)
        if d is None:
            d = self._tl.d = {}
            with self._register_lock:
                self._buckets.append(d)
        return d

    def stats(self, key: int) -> OpStats:
        d = self._bucket()
        s = d.get(key)
        if s is None:
            s = d[key] = OpStats()
        return s

    def add_scan_morsels(self, key: int, scheduled: int = 0,
                         pruned: int = 0, jf_pruned: int = 0) -> None:
        """Morsel scheduling outcome for one scan. The three counters are
        DISJOINT (scheduled + pruned + jf_pruned = blocks considered):
        `pruned` is zone-map-only pruning, `jf_pruned` join-filter
        pruning, a block both would skip counts once under the join
        filter — so roll-ups never double-count a block."""
        s = self.stats(key)
        s.morsels_scheduled += int(scheduled)
        s.morsels_pruned += int(pruned)
        s.morsels_jf_pruned += int(jf_pruned)

    def add_stage(self, key: int, rows_out: int, wall_ns: int,
                  cpu_ns: int = 0, bytes_out: int = 0) -> None:
        """Fused-pipeline stamp: one morsel's pass through one operator
        (the operator's own batches() never runs in the fused path)."""
        s = self.stats(key)
        s.rows_out += int(rows_out)
        s.wall_ns += int(wall_ns)
        s.cpu_ns += int(cpu_ns)
        s.bytes_out += int(bytes_out)
        s.batches += 1

    def add_device_ns(self, key: int, ns: int) -> None:
        self.stats(key).device_ns += int(ns)

    def add_search_batch(self, key: int, queries: int, window_ns: int,
                         scoring_ns: int) -> None:
        """Search-batcher span for one top-k scan: how many queries its
        dispatch carried (1 = no coalescing), how long this query waited
        queued, and the shared scoring time of the whole dispatch — so
        EXPLAIN ANALYZE attributes both the batching win and its latency
        cost."""
        s = self.stats(key)
        s.batch_queries += int(queries)
        s.batch_window_ns += int(window_ns)
        s.batch_scoring_ns += int(scoring_ns)

    def add_shards(self, key: int, pipelines: int, pruned: int = 0,
                   collective: int = 0) -> None:
        """Sharded-tier span for one operator: how many per-shard
        pipelines its execution fanned out into (serene_shards > 1),
        how many blocks the shard-to-shard join filter pruned, and how
        many of the pipelines were combined IN-PROGRAM by a collective
        shard_map dispatch (serene_shard_combine=device) — the
        `Shards:` EXPLAIN ANALYZE detail line's n=/pruned=/combine=.
        All three are additive ints, so the order-free sink merge
        applies unchanged."""
        s = self.stats(key)
        s.shard_pipelines += int(pipelines)
        s.shard_pruned += int(pruned)
        s.shard_collective += int(collective)

    def wrap_batches(self, node, fn, ctx) -> Iterator:
        """Instrumented drive of a node's raw batch generator: wall time
        accrues only while inside next() (inclusive of children, PG
        semantics), rows/bytes per emitted batch."""
        key = id(node)
        self.stats(key).loops += 1
        it = fn(node, ctx)
        try:
            while True:
                t0 = time.perf_counter_ns()
                c0 = time.thread_time_ns()
                try:
                    b = next(it)
                except StopIteration:
                    s = self.stats(key)
                    s.wall_ns += time.perf_counter_ns() - t0
                    s.cpu_ns += time.thread_time_ns() - c0
                    return
                t1 = time.perf_counter_ns()
                s = self.stats(key)
                s.wall_ns += t1 - t0
                s.cpu_ns += time.thread_time_ns() - c0
                if s.first_ns is None:
                    s.first_ns = s.wall_ns
                s.rows_out += b.num_rows
                s.batches += 1
                s.bytes_out += batch_nbytes(b)
                yield b
        finally:
            it.close()

    # -- sink merge (call after execution has drained) --------------------

    def merged(self) -> dict[int, OpStats]:
        """Deterministic sink merge: per-thread buckets sum into one map.
        Integer addition is order-free, so the result is identical for
        any scheduling of the same work."""
        with self._register_lock:
            buckets = list(self._buckets)
        out: dict[int, OpStats] = {}
        for d in buckets:
            for key, s in d.items():
                agg = out.get(key)
                if agg is None:
                    out[key] = agg = OpStats()
                agg.merge(s)
        return out

    def totals(self) -> OpStats:
        """Whole-query roll-up of the prune counters (stat_statements
        attribution); rows/time roll-ups are per-operator, not summed."""
        t = OpStats()
        for s in self.merged().values():
            t.morsels_scheduled += s.morsels_scheduled
            t.morsels_pruned += s.morsels_pruned
            t.morsels_jf_pruned += s.morsels_jf_pruned
            t.device_ns += s.device_ns
        return t


# -- timeline tracing (serene_trace) ------------------------------------------
#
# The QueryProfile above answers "how much" per operator; the timeline
# layer answers "WHEN": every query gets a trace id and timestamped span
# events — (name, category, begin ns, end ns, thread, detail) — recorded
# into per-thread rings (a plain-list append under the GIL, no lock on
# the hot path after first touch, the same bucket pattern QueryProfile
# uses), so the pool's queue waits, batcher coalescing windows, shard
# fan-outs and device dispatch phases become one Chrome-trace-loadable
# timeline. Spans propagate across the worker pool via the CURRENT_TRACE
# contextvar (pool tasks copy the submitter's context), and a coalesced
# search dispatch stamps its spans under EVERY member query's trace.
# Like the profiler, tracing observes only — results are bit-identical
# with it on or off at any worker/shard count.

#: per-thread span ring cap: a runaway span producer degrades to
#: counting drops instead of growing without bound
TRACE_RING_CAP = 8192

_TRACE_IDS = itertools.count(1)

#: the executing statement's QueryTrace (None outside a traced
#: statement). Pool tasks capture the submitter's context at submit
#: time, so worker-thread spans land in the right query's timeline.
CURRENT_TRACE: contextvars.ContextVar = contextvars.ContextVar(
    "sdb_current_trace", default=None)


def current_trace():
    """The executing statement's trace, or None (tracing off / outside
    a statement). One contextvar read — cheap enough for hot-ish paths."""
    return CURRENT_TRACE.get()


class _Ring:
    __slots__ = ("tid", "thread_name", "spans", "dropped")

    def __init__(self, tid: int, thread_name: str):
        self.tid = tid
        self.thread_name = thread_name
        self.spans: list[tuple] = []
        self.dropped = 0


class QueryTrace:
    """One query's span-event collector.

    Spans are recorded at END time with explicit (begin, end)
    perf_counter_ns stamps, so within a thread they nest properly by
    construction (a span closes only after every span it started inside
    it). `add` appends to the calling thread's ring; rings merge at
    `finish()` into one begin-ordered span list with ns offsets relative
    to the trace start."""

    __slots__ = ("trace_id", "query", "t0_ns", "t0_epoch_us", "end_ns",
                 "error", "_register_lock", "_rings", "_tl", "_cv_token")

    def __init__(self, query_text: str = ""):
        self.trace_id = next(_TRACE_IDS)
        self.query = query_text
        self.t0_ns = time.perf_counter_ns()
        self.t0_epoch_us = int(time.time() * 1e6)
        self.end_ns: Optional[int] = None
        self.error: Optional[str] = None
        self._register_lock = threading.Lock()
        self._rings: list[_Ring] = []
        self._tl = threading.local()
        self._cv_token = None

    def now(self) -> int:
        return time.perf_counter_ns()

    def add(self, name: str, cat: str, begin_ns: int, end_ns: int,
            **detail) -> None:
        """Record one span event from any thread. begin/end are
        perf_counter_ns stamps (end >= begin enforced); detail keys
        become Chrome trace `args`. Span names are free-form; the
        "device" category carries device_compile, collective_dispatch
        and the posting pool's posting_upload (staged page writes) /
        posting_dispatch (batched gather-accumulate scoring) spans,
        "search" the batcher's batch_wait / batch_dispatch pair."""
        r = getattr(self._tl, "r", None)
        if r is None:
            t = threading.current_thread()
            r = self._tl.r = _Ring(t.ident or 0, t.name)
            with self._register_lock:
                self._rings.append(r)
        if len(r.spans) >= TRACE_RING_CAP:
            r.dropped += 1
            return
        r.spans.append((name, cat, begin_ns, max(end_ns, begin_ns),
                        detail or None))

    def finish(self, error: Optional[str] = None) -> dict:
        """Close the trace: stamp the root `query` span, merge the
        per-thread rings into one begin-ordered span list (offsets
        relative to the trace start) and return the flight-recorder
        entry dict."""
        self.end_ns = time.perf_counter_ns()
        self.error = error
        dur = self.end_ns - self.t0_ns
        with self._register_lock:
            rings = list(self._rings)
        spans = [{"name": "query", "cat": "query", "tid": 0,
                  "thread": "query", "begin_ns": 0, "end_ns": dur,
                  "args": {"query": self.query[:500],
                           "trace_id": self.trace_id}}]
        dropped = 0
        for r in rings:
            dropped += r.dropped
            for name, cat, b, e, detail in r.spans:
                spans.append({"name": name, "cat": cat, "tid": r.tid,
                              "thread": r.thread_name,
                              "begin_ns": b - self.t0_ns,
                              "end_ns": e - self.t0_ns,
                              "args": detail})
        spans.sort(key=lambda s: (s["begin_ns"], -s["end_ns"]))
        if dropped:
            metrics.TRACE_SPANS_DROPPED.add(dropped)
        # statement text truncates at entry-build time: every consumer
        # (listing, /_stats, chrome otherData) shows <= 500 chars, and
        # the always-on ring must not pin multi-MB INSERT literals
        return {"trace_id": self.trace_id, "query": self.query[:500],
                "begin_epoch_us": self.t0_epoch_us,
                "duration_ns": dur, "error": error,
                "spans": spans, "spans_dropped": dropped,
                # stamped by the statement-end hook when
                # serene_mem_account ran (engine._finish_trace /
                # execute_streaming): the query's accounted peak bytes
                "peak_bytes": None}


class FlightRecorder:
    """Always-on bounded ring of the last N completed query timelines
    (`serene_flight_recorder_queries`, default 64): the slow-query log
    and error paths read a stall's timeline AFTER the fact instead of
    asking for a reproduction. One short lock per statement END."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, dict]" = OrderedDict()

    def _cap(self) -> int:
        from ..utils.config import REGISTRY
        try:
            return max(1, int(REGISTRY.get_global(
                "serene_flight_recorder_queries")))
        except KeyError:  # pragma: no cover — registry declares it
            return 64

    def record(self, entry: dict) -> dict:
        cap = self._cap()
        with self._lock:
            self._entries[entry["trace_id"]] = entry
            while len(self._entries) > cap:
                self._entries.popitem(last=False)   # oldest completes out
        metrics.TRACES_RECORDED.add()
        return entry

    def get(self, trace_id: int) -> Optional[dict]:
        with self._lock:
            return self._entries.get(int(trace_id))

    def last(self) -> Optional[dict]:
        with self._lock:
            if not self._entries:
                return None
            return next(reversed(self._entries.values()))

    def snapshot(self) -> list[dict]:
        """Newest-last entry list (shared references — treat as
        read-only)."""
        with self._lock:
            return list(self._entries.values())

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


#: process-wide flight recorder (one per process, like the metrics
#: registry)
FLIGHT = FlightRecorder()


def flight_summary(entry: dict) -> dict:
    """One flight entry as the compact listing dict — the single shape
    behind the GET /trace index and /_stats.traces, so the surfaces
    can't drift field by field."""
    return {"trace_id": entry["trace_id"],
            "query": entry["query"][:200],
            "duration_ms": round(entry["duration_ns"] / 1e6, 3),
            "spans": len(entry["spans"]),
            "spans_dropped": entry["spans_dropped"],
            "peak_bytes": entry.get("peak_bytes"),
            "error": entry["error"]}


def top_spans(entry: dict, n: int = 5) -> list[dict]:
    """The n widest non-root spans of a recorded timeline (slow-query
    log attachment)."""
    inner = [s for s in entry["spans"] if s["cat"] != "query"]
    inner.sort(key=lambda s: s["end_ns"] - s["begin_ns"], reverse=True)
    return inner[:n]


def format_top_spans(entry: dict, n: int = 5) -> list[str]:
    lines = [f"timeline: trace_id={entry['trace_id']} "
             f"duration={_ms(entry['duration_ns'])} ms "
             f"spans={len(entry['spans'])}"]
    for s in top_spans(entry, n):
        det = ""
        if s["args"]:
            det = " " + " ".join(f"{k}={v}" for k, v in s["args"].items())
        lines.append(
            f"  span {s['cat']}/{s['name']} "
            f"[{_ms(s['begin_ns'])}..{_ms(s['end_ns'])} ms] "
            f"thread={s['thread']}{det}")
    return lines


def chrome_trace(entry: dict) -> dict:
    """One flight-recorder entry as Chrome trace-event JSON (`ph: "X"`
    complete events, ts/dur in µs relative to the query start) —
    loadable in Perfetto / chrome://tracing as-is."""
    events: list[dict] = []
    tids = {0: "query"}
    for s in entry["spans"]:
        tids.setdefault(s["tid"], s["thread"])
        ev = {"name": s["name"], "cat": s["cat"], "ph": "X",
              "ts": s["begin_ns"] / 1e3,
              "dur": (s["end_ns"] - s["begin_ns"]) / 1e3,
              "pid": 1, "tid": s["tid"]}
        if s["args"]:
            ev["args"] = dict(s["args"])
        events.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": f"serenedb query {entry['trace_id']}"}}]
    for tid, tname in tids.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                     "tid": tid, "args": {"name": tname}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": entry["trace_id"],
                          "query": entry["query"][:500],
                          "begin_epoch_us": entry["begin_epoch_us"],
                          "duration_ms": entry["duration_ns"] / 1e6,
                          "error": entry["error"],
                          "peak_bytes": entry.get("peak_bytes"),
                          "spans_dropped": entry["spans_dropped"]}}


def _ms(ns: int) -> str:
    return f"{ns / 1e6:.3f}"


def annotate_plan(plan, profile: QueryProfile, mem=None) -> list[str]:
    """EXPLAIN ANALYZE rendering: the plan tree with PG-style
    `(actual time=first..total rows=N loops=L)` suffixes plus prune /
    device detail lines, and per-operator `Memory: peak=… live=…`
    lines when a MemoryAccountant ran (serene_mem_account). Nodes the
    executor fused away (device offload) render `(never executed)`
    like PG's unvisited branches."""
    from .resources import fmt_kb
    merged = profile.merged()
    mem_merged = mem.merged() if mem is not None else {}

    def mem_line(pad: str, node) -> list[str]:
        m = mem_merged.get(id(node))
        if m is None:
            return []
        live, peak = m
        return [f"{pad}Memory: peak={fmt_kb(peak)} "
                f"live={fmt_kb(max(live, 0))}"]

    def walk(node, depth: int) -> list[str]:
        pad = "  " * depth
        s = merged.get(id(node))
        if s is None:
            lines = [f"{pad}{node.label()} (never executed)"]
            lines.extend(mem_line(pad + "  ", node))
        else:
            first = s.first_ns if s.first_ns is not None else s.wall_ns
            lines = [f"{pad}{node.label()} "
                     f"(actual time={_ms(first)}..{_ms(s.wall_ns)} "
                     f"rows={s.rows_out} loops={max(s.loops, 1)})"]
            detail = pad + "  "
            if s.morsels_scheduled or s.morsels_pruned:
                jf = (f" join_filter_pruned={s.morsels_jf_pruned}"
                      if s.morsels_jf_pruned else "")
                lines.append(
                    f"{detail}Morsels: scheduled={s.morsels_scheduled} "
                    f"zonemap_pruned={s.morsels_pruned}{jf}")
            if s.device_ns or s.device_declined:
                comp = ""
                if s.device_prog_hits or s.device_prog_misses:
                    # any miss means this execution paid (at least one)
                    # XLA compile; all-hit means every program came
                    # from the ledger warm (obs/device.py)
                    comp = " compile=" + \
                        ("miss" if s.device_prog_misses else "hit")
                dec = (f" declined={s.device_declined}"
                       if s.device_declined else "")
                lines.append(
                    f"{detail}Device: time={_ms(s.device_ns)} "
                    f"ms{comp}{dec}")
            if s.batch_queries:
                lines.append(
                    f"{detail}Batch: queries={s.batch_queries} "
                    f"window={_ms(s.batch_window_ns)} ms "
                    f"shared_scoring={_ms(s.batch_scoring_ns)} ms")
            if s.shard_pipelines or s.shard_pruned:
                combine = "device" if s.shard_collective else "host"
                lines.append(f"{detail}Shards: n={s.shard_pipelines} "
                             f"pruned={s.shard_pruned} "
                             f"combine={combine}")
            lines.extend(mem_line(detail, node))
        for c in node.children():
            lines.extend(walk(c, depth + 1))
        return lines

    return walk(plan, 0)


def annotate_plan_json(plan, profile: Optional[QueryProfile],
                       mem=None) -> dict:
    """EXPLAIN (FORMAT JSON) rendering: the plan tree as a
    machine-readable object — PG's JSON key shapes where they map
    ("Node Type", "Actual Total Time", "Actual Rows", "Plans"), plus the
    engine's prune / device / batch / shard detail as flat keys instead
    of the text renderer's detail lines, and per-operator "Peak Memory
    Bytes" / "Live Memory Bytes" when a MemoryAccountant ran.
    profile=None renders structure only (plain EXPLAIN)."""
    merged = profile.merged() if profile is not None else {}
    mem_merged = mem.merged() if mem is not None else {}

    def stamp_mem(out: dict, node) -> None:
        m = mem_merged.get(id(node))
        if m is not None:
            out["Peak Memory Bytes"] = m[1]
            out["Live Memory Bytes"] = max(m[0], 0)

    def walk(node) -> dict:
        out: dict = {"Node Type": node.label()}
        if profile is not None:
            s = merged.get(id(node))
            if s is None:
                out["Never Executed"] = True
                stamp_mem(out, node)
            else:
                first = s.first_ns if s.first_ns is not None else s.wall_ns
                out["Actual Startup Time"] = round(first / 1e6, 3)
                out["Actual Total Time"] = round(s.wall_ns / 1e6, 3)
                out["Actual Rows"] = s.rows_out
                out["Actual Loops"] = max(s.loops, 1)
                if s.morsels_scheduled or s.morsels_pruned:
                    out["Morsels Scheduled"] = s.morsels_scheduled
                    out["Morsels Zonemap Pruned"] = s.morsels_pruned
                    if s.morsels_jf_pruned:
                        out["Morsels Join Filter Pruned"] = \
                            s.morsels_jf_pruned
                if s.device_ns:
                    out["Device Time"] = round(s.device_ns / 1e6, 3)
                    if s.device_prog_hits or s.device_prog_misses:
                        out["Device Compile"] = \
                            "miss" if s.device_prog_misses else "hit"
                if s.device_declined:
                    out["Device Declined"] = s.device_declined
                if s.batch_queries:
                    out["Batch Queries"] = s.batch_queries
                    out["Batch Window Time"] = \
                        round(s.batch_window_ns / 1e6, 3)
                    out["Batch Shared Scoring Time"] = \
                        round(s.batch_scoring_ns / 1e6, 3)
                if s.shard_pipelines or s.shard_pruned:
                    out["Shard Pipelines"] = s.shard_pipelines
                    out["Shard Morsels Pruned"] = s.shard_pruned
                    out["Shard Combine"] = \
                        "device" if s.shard_collective else "host"
                stamp_mem(out, node)
        kids = node.children()
        if kids:
            out["Plans"] = [walk(c) for c in kids]
        return out

    return walk(plan)
