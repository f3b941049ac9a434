"""Copied from serenedb_tpu/utils/config.py (serene_device takes auto|gpu|cpu).

Three-tier config system.

Reference analog (SURVEY.md §5.6): (1) process flags, (2) SQL-settable
session/global settings (`SET name = value` / `sdb_settings` introspection;
reference: server/query/config_variables.cpp), (3) per-object WITH options
(carried in the catalog, not here).

Settings are declared once in a registry with type/default/scope; sessions
hold sparse overrides over the global store.
"""

from __future__ import annotations

import enum
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class Scope(enum.Enum):
    SESSION = "session"   # settable per session (and globally as default)
    GLOBAL = "global"     # process-wide only


#: binary factors for PG-style memory-size literals ('64MB', '512kB');
#: PG's guc memory units are binary too (1MB = 1024kB)
_MEM_UNIT_FACTORS = {"b": 1, "kb": 1 << 10, "mb": 1 << 20,
                     "gb": 1 << 30, "tb": 1 << 40}
_MEM_RE = re.compile(r"^\s*(\d+)\s*([a-zA-Z]*)\s*$")


def parse_memory_bytes(value: Any) -> int:
    """PG-style memory-size parsing for byte-denominated settings
    (`SET serene_work_mem = '64MB'`): a plain integer is BYTES (every
    number the accounting layer reports is bytes, so the two compare
    without a unit hop), a string may carry a B/kB/MB/GB/TB suffix
    with binary factors. Rejects negatives (the regex) and unknown
    units loudly."""
    if isinstance(value, bool):
        raise ValueError(f"invalid memory value: {value!r}")
    if isinstance(value, (int, float)):
        return int(value)
    m = _MEM_RE.match(str(value))
    if not m:
        raise ValueError(f"invalid memory value: {value!r}")
    n, unit = m.groups()
    if not unit:
        return int(n)
    factor = _MEM_UNIT_FACTORS.get(unit.lower())
    if factor is None:
        raise ValueError(
            f"invalid memory unit in {value!r} (use B, kB, MB, GB or TB)")
    return int(n) * factor


@dataclass
class Setting:
    name: str
    default: Any
    type: type
    scope: Scope = Scope.SESSION
    description: str = ""
    validator: Optional[Callable[[Any], Any]] = None
    #: byte-denominated setting: coerce accepts PG-style unit strings
    #: ('64MB') as well as plain integers (bytes)
    memory: bool = False

    def coerce(self, value: Any) -> Any:
        if self.memory:
            value = parse_memory_bytes(value)
        elif self.type is bool and isinstance(value, str):
            v = value.strip().lower()
            if v in ("on", "true", "1", "yes"):
                value = True
            elif v in ("off", "false", "0", "no"):
                value = False
            else:
                raise ValueError(f"invalid boolean: {value!r}")
        else:
            value = self.type(value)
        if self.validator:
            value = self.validator(value)
        return value


class SettingsRegistry:
    def __init__(self):
        self._defs: dict[str, Setting] = {}
        self._global: dict[str, Any] = {}
        self._lock = threading.Lock()

    def register(self, s: Setting) -> Setting:
        self._defs[s.name] = s
        return s

    def definition(self, name: str) -> Setting:
        s = self._defs.get(name.lower())
        if s is None:
            raise KeyError(f'unrecognized configuration parameter "{name}"')
        return s

    def names(self) -> list[str]:
        return sorted(self._defs)

    def set_global(self, name: str, value: Any) -> None:
        s = self.definition(name)
        with self._lock:
            self._global[s.name] = s.coerce(value)

    def get_global(self, name: str) -> Any:
        s = self.definition(name)
        with self._lock:
            return self._global.get(s.name, s.default)


REGISTRY = SettingsRegistry()


def declare(name: str, default: Any, typ: type, description: str = "",
            scope: Scope = Scope.SESSION,
            validator: Optional[Callable] = None,
            memory: bool = False) -> Setting:
    return REGISTRY.register(
        Setting(name.lower(), default, typ, scope, description, validator,
                memory))


class SessionSettings:
    """Per-session sparse overrides over the global registry."""

    def __init__(self, registry: SettingsRegistry = REGISTRY):
        self._registry = registry
        self._local: dict[str, Any] = {}

    def get(self, name: str) -> Any:
        s = self._registry.definition(name)
        if s.name in self._local:
            return self._local[s.name]
        return self._registry.get_global(s.name)

    def set(self, name: str, value: Any) -> None:
        s = self._registry.definition(name)
        if s.scope is Scope.GLOBAL:
            raise ValueError(f'parameter "{name}" cannot be changed per session')
        self._local[s.name] = s.coerce(value)

    def reset(self, name: str) -> None:
        s = self._registry.definition(name)
        self._local.pop(s.name, None)

    def snapshot(self) -> dict[str, Any]:
        return {n: self.get(n) for n in self._registry.names()}


# -- core settings (mirroring the reference's knob names where they exist) --

declare("application_name", "", str, "client-supplied application name")
declare("extra_float_digits", 1, int, "float output precision adjustment")
declare("statement_timeout", 0, int, "ms; 0 disables")
declare("search_path", "main", str, "schema search path")
declare("sdb_faults", "", str, "comma list of armed fault points (+name/-name)")
declare("sdb_nprobe", 8, int, "IVF probes per vector query")
declare("sdb_rerank_factor", 4, int, "ANN rerank multiplier")
declare("sdb_scored_terms_limit", 128, int,
        "max scored terms for multi-term expansion (wildcard/fuzzy)")
declare("sdb_strict_ddl", False, bool, "reject unknown WITH options")
def _validate_device(v):
    v = str(v).strip().lower()
    if v not in ("auto", "gpu", "cpu"):
        raise ValueError(f"invalid serene_device: {v!r} (auto|gpu|cpu)")
    return v


declare("serene_device", "auto", str,
        "compute device policy: auto|gpu|cpu (gpu: the device tier on the "
        "database's device; auto: the device tier when the table is large "
        "enough; cpu: the host morsel path)",
        validator=_validate_device)
declare("serene_device_min_rows", 16384, int,
        "below this row count the CPU path is used even when device=auto")
declare("serene_device_chunk_rows", 1 << 21, int,
        "device aggregate dispatches split into row chunks of this size "
        "so cancel/statement_timeout fire between chunks (~one chunk's "
        "latency); 0 disables chunking")
declare("serene_device_fused", True, bool,
        "fused device relational pipelines (exec/device_pipeline.py): "
        "Scan→Filter→Join→Aggregate chains and filtered top-N compile "
        "into ONE jitted device program over publication-cached HBM "
        "columns instead of one host kernel per operator; anything the "
        "fused compiler can't prove exact falls back to the host path, "
        "which stays on as the bit-identical parity oracle — results "
        "are identical on or off at any serene_workers setting")
declare("serene_device_fused_ext", True, bool,
        "extended fused-tier admission: string aggregates via "
        "dictionary codes, FILTER aggregates as extra scatter masks, "
        "DISTINCT aggregates as presence grids, side-decomposable "
        "residual join predicates, LEFT/RIGHT/FULL outer joins, and "
        "the chained fused-aggregate→top-N device handoff. Off "
        "restores the earlier admission walls (those shapes decline to "
        "the host path) — the before/after lever of the "
        "fused_admission bench shape; results are bit-identical on or "
        "off because the host path is the oracle for every shape")
declare("serene_device_cache_trade", True, bool,
        "pressure-based budget trade between the device column cache "
        "(§19) and the posting pool (§27) inside the one "
        "serene_device_cache_mb envelope: the column cache's byte cap "
        "is the envelope minus the pool's LIVE page bytes (floored at "
        "a quarter of the envelope), so pool residency squeezes the "
        "cache instead of a static carve-out; and when the cache must "
        "evict, it first sheds the POOL's tail if that tail is colder "
        "(idle longer), which raises its own cap back. Off restores "
        "the static carve-out (serene_posting_pages bounds the pool; "
        "the column cache ignores pool occupancy)",
        scope=Scope.GLOBAL)
declare("serene_device_cache_mb", 256, int,
        "byte cap (MB) of the process-wide device column cache "
        "(exec/device_pipeline.DEVICE_CACHE): device-resident column "
        "tiles and join-code uploads keyed by publication tuples, so "
        "repeat queries over unchanged tables skip host→device "
        "transfer entirely; least-recently-used entries evict past the "
        "cap and superseded generations are swept eagerly on store",
        scope=Scope.GLOBAL, validator=lambda v: max(1, int(v)))
declare("serene_posting_pool", True, bool,
        "device-resident paged posting pool (search/posting_pool.py): "
        "the batched ragged search path uploads each (segment, term) "
        "posting list ONCE into a paged HBM region and scores "
        "page-resident coalesced batches as one jitted gather-and-"
        "accumulate program over page tables — zero host→device "
        "posting bytes on the warm path. Misses fall back per query to "
        "the host ragged path and partial residency merges host tails "
        "deterministically, so results are BIT-IDENTICAL on or off at "
        "any worker/shard/cache setting (off = the parity oracle) and "
        "the setting stays out of the result cache's settings digest",
        scope=Scope.GLOBAL)
declare("serene_posting_pages", 4096, int,
        "page budget of the posting pool's device region (pages of "
        "1024 postings; docs+tfs = 8 KiB/page, so the default 4096 is "
        "32 MiB of HBM). The region never exceeds the "
        "serene_device_cache_mb byte cap — the pool is carved out of "
        "the device-cache budget, not added to it. Least-recently-used "
        "terms evict past the budget; size from sdb_posting_pool() "
        "occupancy/hit rows",
        scope=Scope.GLOBAL, validator=lambda v: max(8, int(v)))
declare("serene_vector_pool", True, bool,
        "device-resident paged vector pool (search/vector_store.py): "
        "IVF and MaxSim indexes upload their cluster-major vector "
        "segments ONCE into a paged HBM region (16 KiB pages, LRU by "
        "segment) and warm coalesced knn batches run as ONE jitted "
        "centroid-probe → slotmap-gather → exact-rescore → top-k "
        "program with zero host→device vector bytes. Off (or under "
        "page starvation) every dispatch falls back to a per-call "
        "committed cold region running the SAME program, so results "
        "are bit-identical on or off and the setting stays out of the "
        "result cache's settings digest",
        scope=Scope.GLOBAL)
declare("serene_vector_pages", 4096, int,
        "page budget of the vector pool's device region (pages of "
        "4096 f32 = 16 KiB, so the default 4096 is 64 MiB of HBM). "
        "The region never exceeds the serene_device_cache_mb byte cap "
        "— the pool is carved out of the device-cache budget, not "
        "added to it. Whole segments evict LRU past the budget; size "
        "from sdb_vector_pool() residency/hit rows",
        scope=Scope.GLOBAL, validator=lambda v: max(4, int(v)))
declare("serene_nprobe", 0, int,
        "IVF clusters probed per vector query; 0 defers to the "
        "compat alias sdb_nprobe. More probes = higher recall and "
        "more work (nprobe = lists is exact brute force, the parity "
        "oracle). RESULT-AFFECTING: changes which rows a knn returns, "
        "so it is part of the result cache's settings digest",
        validator=lambda v: max(0, int(v)))
declare("serene_maxsim", True, bool,
        "serve vec_maxsim() late-interaction scoring on the device "
        "(dimension-tiled token-matrix MaxSim over the vector pool); "
        "off = exact float64 host oracle. RESULT-AFFECTING: device "
        "scores are f32, the host oracle is f64, so near-tied docs "
        "can order differently — part of the settings digest")
declare("serene_device_telemetry", True, bool,
        "device telemetry (obs/device.py): the XLA compile ledger "
        "(per-program-family compile counts/wall time, program-cache "
        "hit/miss gauges, recompile-storm warnings), host<->device "
        "transfer byte/time accounting and per-device dispatch counts "
        "+ HBM occupancy estimates, surfaced via sdb_device()/"
        "sdb_programs()/sdb_device_cache(), GET /device, /_stats and "
        "/metrics, plus device_compile trace spans and the EXPLAIN "
        "ANALYZE Device: compile=hit|miss key. Observation only: "
        "telemetry never changes which program runs — results are "
        "bit-identical on or off at any worker/shard/combine setting "
        "(<3% overhead budget, device_observe bench shape)",
        scope=Scope.GLOBAL)
declare("serene_program_cache_entries", 256, int,
        "entry cap of the process-wide compiled-program LRU "
        "(obs/device.py PROGRAMS — the _PROGRAM_CACHE successor): "
        "every jitted device program (fused pipelines, device "
        "aggregates/top-N, mesh/search programs) lives here keyed by "
        "(family, shape); least-recently-used executables evict past "
        "the cap instead of leaking one per novel query shape for "
        "process lifetime, and an evicted shape simply re-compiles on "
        "next use", scope=Scope.GLOBAL,
        validator=lambda v: max(1, int(v)))
declare("serene_mesh", 0, int,
        "shard device programs across an N-device jax mesh (0 = single "
        "device); grouped aggregates and BM25 top-k run as shard_map "
        "programs with psum/pmin/pmax merges over ICI")


def _cpu_count() -> int:
    import os
    return os.cpu_count() or 1


declare("serene_workers", _cpu_count(), int,
        "host worker-pool parallelism for morsel-driven execution "
        "(scans/aggregates, segment search, ingest parsing); the process "
        "pool is sized from the global value, sessions cap their own "
        "queries with SET serene_workers; 1 disables parallel scheduling "
        "(the same morsel plan runs inline — results are identical)",
        validator=lambda v: max(1, int(v)))
declare("serene_morsel_rows", 1 << 19, int,
        "rows per morsel for parallel host pipelines; the split is "
        "fixed-size and independent of worker count so partial-merge "
        "order (and thus every result bit) never depends on scheduling; "
        "large morsels amortize python dispatch overhead per task",
        validator=lambda v: max(1024, int(v)))
declare("serene_parallel_min_rows", 1 << 16, int,
        "below this input row count host pipelines stay single-threaded "
        "(morsel setup costs more than it buys)")
declare("serene_zonemap", True, bool,
        "zone maps: per-morsel block min/max/null statistics consulted "
        "before scanning — filter conjuncts that provably match no row "
        "of a block skip it entirely, conjuncts that provably match "
        "every row skip predicate evaluation, and the device paths "
        "shrink uploads to the surviving block range; off scans "
        "everything (results are identical either way)")
declare("serene_join_vectorized", True, bool,
        "vectorized relational tier: hash joins, set operations and "
        "DISTINCT ON run over dense int64 key codes with numpy array "
        "kernels (build-side offset index + morsel-parallel probe "
        "expansion on the shared worker pool); off interprets the same "
        "operators row-tuple-at-a-time in python (the parity oracle) — "
        "results are bit-identical either way")
declare("serene_join_filter", True, bool,
        "min/max sideways-information-passing join filter: after the "
        "build side of an inner/right hash join materializes, its key "
        "range is published to the zone-map analyzer so probe-side scan "
        "morsels whose block statistics prove no key can match are "
        "never enqueued; requires serene_zonemap, results are "
        "identical on or off")
declare("serene_profile", True, bool,
        "per-operator query profiling (obs/trace.py): every statement "
        "collects rows/time/morsel-prune spans per plan operator, feeds "
        "sdb_stat_statements, the slow-query log and pg_stat_activity "
        "query ids; results are bit-identical on or off (<3% overhead "
        "budget, profile_overhead bench shape)")
declare("serene_trace", True, bool,
        "query timeline tracing (obs/trace.py): every statement gets a "
        "trace id and timestamped span events — worker-pool queue waits, "
        "morsel pipeline fan-out, search-batcher coalescing windows, "
        "per-shard pipelines and device factorize/upload/dispatch "
        "phases — recorded into lock-free per-thread rings, finalized "
        "into the flight recorder ring, and served as Chrome "
        "trace-event JSON via sdb_trace(id) and GET /trace/<id>. "
        "Observation only: results are bit-identical on or off at any "
        "worker/shard count (<3% overhead budget, trace_overhead bench "
        "shape)")
declare("serene_mem_account", True, bool,
        "per-query resource accounting (obs/resources.py): every "
        "statement charges live/peak bytes at its materialization "
        "sites (operator batches, join build sides, sort buffers, "
        "morsel partials, device uploads, cache stores), feeds "
        "per-operator Memory lines in EXPLAIN ANALYZE, peak_mem "
        "columns in sdb_stat_statements, the QueryPeakBytes histogram, "
        "and registers live progress rows for sdb_query_progress() / "
        "GET /progress. Observation only: results are bit-identical "
        "on or off at any worker/shard count (<3% overhead budget, "
        "mem_overhead bench shape) — the prerequisite the "
        "admission-control / serene_work_mem roadmap item builds on")
declare("serene_flight_recorder_queries", 64, int,
        "size of the always-on flight recorder: the last N completed "
        "query timelines are kept in a bounded ring so the slow-query "
        "log and error paths can dump a stall's timeline after the "
        "fact; oldest entries evict past the cap",
        scope=Scope.GLOBAL, validator=lambda v: max(1, int(v)))
declare("serene_log_min_duration_ms", -1, int,
        "log statements running at least this many ms to the "
        "slow_query topic (profiled plan tree included when available); "
        "0 logs everything, -1 disables (PG log_min_duration_statement); "
        "requires serene_profile = on, like all of the obs subsystem")
declare("serene_stat_statements_max", 1000, int,
        "cap on distinct normalized statements tracked by "
        "sdb_stat_statements; least-recently-executed entries evict "
        "past the cap", scope=Scope.GLOBAL,
        validator=lambda v: max(1, int(v)))
declare("serene_result_cache", True, bool,
        "multi-tier query cache (cache/): tier 1 memoizes whole results "
        "of read-only statements whose plans touch only immutable "
        "expressions and catalog tables, keyed by (statement digest, "
        "parameter values, result-affecting settings digest, per-table "
        "publication tuples) — any write bumps a publication tuple, so "
        "a stale entry can never be returned; tier 2 caches per-segment "
        "search filter/top-k fragments (segments are immutable). "
        "Results are bit-identical on or off at any worker count; off "
        "disables both lookups and stores for this session")
declare("serene_result_cache_mb", 64, int,
        "byte cap (MB) of the process-wide result cache; entries evict "
        "least-recently-used past the cap and a single result larger "
        "than the cap is never stored", scope=Scope.GLOBAL,
        validator=lambda v: max(1, int(v)))
declare("serene_fragment_cache_mb", 32, int,
        "byte cap (MB) of the process-wide search fragment cache "
        "(per-segment filter doc sets and top-k collector outputs)",
        scope=Scope.GLOBAL, validator=lambda v: max(1, int(v)))
declare("serene_search_batch", True, bool,
        "batched ragged search serving (search/batcher.py): concurrent "
        "_search/@@@ top-k queries against the same index coalesce into "
        "ONE vectorized scoring dispatch over the shared postings, with "
        "ragged per-query term lists and per-query WAND thresholds "
        "preserved; per-query results are bit-identical to serial "
        "dispatch (scores, doc ids, tie order), so this setting is "
        "deliberately excluded from the result cache's settings digest; "
        "off dispatches every query alone (the parity oracle). A lone "
        "query never waits: coalescing only engages while other searches "
        "of the same (index, k, scorer) group are in flight")
declare("serene_search_batch_window_ms", 2.0, float,
        "upper bound (ms) a query waits to coalesce with concurrent "
        "arrivals when its group has other active-but-unqueued "
        "submitters; while a dispatch is in flight arrivals simply queue "
        "behind it (the dispatch IS the window under sustained load) and "
        "a query alone in its group dispatches immediately",
        scope=Scope.GLOBAL, validator=lambda v: max(0.0, float(v)))
declare("serene_search_batch_max", 128, int,
        "cap on queries per coalesced search scoring dispatch; overflow "
        "queries form the next dispatch", scope=Scope.GLOBAL,
        validator=lambda v: max(1, int(v)))
declare("serene_shards", 1, int,
        "sharded execution tier (exec/shard.py): table scans partition "
        "into N shards by round-robin morsel-block assignment and the "
        "morsel/fused pipelines run once per shard — as concurrent "
        "worker-pool tasks, with per-shard device programs pinned "
        "across jax.devices() when a multi-device mesh is present — "
        "while the deterministic merge sinks (ordered partial merge, "
        "single-heap top-k, partial-aggregate combine) act as the "
        "cross-shard combiners; the build side of a hash join publishes "
        "PER-SHARD key min/max so probe blocks outside every shard's "
        "range are pruned before any scan or device upload. Results are "
        "bit-identical at any shard count (1 = today's unsharded "
        "execution, the parity oracle), so this setting is deliberately "
        "excluded from the result cache's settings digest",
        validator=lambda v: max(1, int(v)))
def _validate_shard_combine(v):
    v = str(v).strip().lower()
    if v not in ("auto", "device", "host"):
        raise ValueError(
            f"invalid serene_shard_combine: {v!r} (auto|device|host)")
    return v


declare("serene_shard_combine", "auto", str,
        "where the sharded tier's cross-shard combine runs when "
        "serene_shards > 1: 'device' executes the fused join/aggregate "
        "as ONE shard_map-partitioned program over the mesh data axis "
        "with psum/pmin/pmax collectives reducing the integer "
        "accumulators in HBM (and merges sharded search top-k with an "
        "in-program per-shard sort + one all_gather hop); 'host' keeps "
        "the per-shard dispatches with the exact host-side integer "
        "combine (the oracle); 'auto' resolves to device when the "
        "process sees more than one jax device, else host. Every "
        "accumulator is an integer add or a min/max selection, so the "
        "combine is exact in any reduction order and results are "
        "BIT-identical across all three values — this setting is "
        "deliberately excluded from the result cache's settings digest",
        validator=_validate_shard_combine)
# -- workload governor (sched/governor.py) ----------------------------------

declare("serene_max_concurrent_statements", 0, int,
        "admission control (sched/governor.py): max statements EXECUTING "
        "process-wide; further statements wait in a bounded FIFO "
        "admission queue (pg_stat_activity state 'queued', wait event "
        "Admission/AdmissionQueue, queue time as a queue_wait trace "
        "span) until a running statement finishes. 0 disables admission "
        "entirely. Utility statements (SET/SHOW/txn control) and "
        "catalog-only introspection reads (pg_*/sdb_*/"
        "information_schema) are exempt, so an overloaded server can "
        "still be diagnosed. Scheduling only — results are bit-identical "
        "at any limit", scope=Scope.GLOBAL,
        validator=lambda v: max(0, int(v)))
declare("serene_admission_queue_depth", 64, int,
        "bound on the admission queue: statements arriving when "
        "serene_max_concurrent_statements are running AND this many are "
        "already queued are rejected immediately with SQLSTATE 53300 "
        "(backpressure instead of an unbounded convoy)",
        scope=Scope.GLOBAL, validator=lambda v: max(1, int(v)))
declare("serene_max_connections", 0, int,
        "socket-level admission (sched/governor.py ConnectionGate): max "
        "sockets open across BOTH front-door protocols; a connection "
        "past the limit is rejected at accept — pgwire clients get a "
        "clean 53300 error packet, HTTP clients a 429 with Retry-After "
        "— before a single byte of the session is parsed, so overload "
        "never reaches the engine. 0 = unlimited. The statement-level "
        "sibling is serene_max_concurrent_statements",
        scope=Scope.GLOBAL, validator=lambda v: max(0, int(v)))
declare("serene_frontdoor", True, bool,
        "serve HTTP/ES on the unified asyncio front door "
        "(server/frontdoor.py: one event loop for both protocols, "
        "connections as tasks not threads, socket-level admission, "
        "pause-reading backpressure, idle reaping). off = the legacy "
        "thread-per-connection ThreadingHTTPServer, kept one release "
        "as the bit-identity parity oracle (both paths share the same "
        "request->response route table)", scope=Scope.GLOBAL)
declare("serene_idle_conn_timeout_s", 0.0, float,
        "reap front-door connections (both protocols) that have sent "
        "no bytes for this many seconds — half-open clients and "
        "abandoned keep-alive sessions release their socket (and "
        "serene_max_connections slot) instead of holding it forever. "
        "0 disables. Applies while a connection is idle or mid-"
        "handshake, never to a statement in flight",
        scope=Scope.GLOBAL, validator=lambda v: max(0.0, float(v)))
declare("serene_conn_write_high_kb", 256, int,
        "per-connection transport write-buffer high-water mark in KiB "
        "(server/frontdoor.py): past it the session stops reading "
        "(transport.pause_reading) and stops producing until the "
        "client drains below the low-water mark, so a stalled reader "
        "never buffers unbounded result bytes",
        scope=Scope.GLOBAL, validator=lambda v: max(16, int(v)))
declare("serene_fair_share", True, bool,
        "fair-share morsel scheduling (parallel/pool.py): the shared "
        "worker pool picks queued tasks by per-statement stride "
        "scheduling (weights from serene_priority) instead of global "
        "FIFO, so a heavy scan's morsels INTERLEAVE with, rather than "
        "run entirely before, every later statement's — a dashboard "
        "query's tasks wait ~one morsel, not the heavy query's whole "
        "backlog. Scheduling only: the deterministic merge sinks make "
        "results bit-identical with it on or off (ARCHITECTURE.md §25)",
        scope=Scope.GLOBAL)
declare("serene_priority", 100, int,
        "this session's fair-share weight (1..10000, default 100): a "
        "statement with weight 2w is picked twice as often as one with "
        "weight w while both have queued tasks (stride scheduling, "
        "higher = more worker-pool share); has no effect on results, "
        "only on scheduling order",
        validator=lambda v: min(10000, max(1, int(v))))
declare("serene_work_mem", 0, int,
        "per-statement memory ceiling in BYTES (PG-style unit strings "
        "accepted: '64MB', '1GB'); when the statement's accounted live "
        "bytes (serene_mem_account, obs/resources.py) exceed it, the "
        "statement aborts with SQLSTATE 53200 at the next cooperative "
        "cancellation point — the same drain cancel and "
        "statement_timeout use, so no partial state survives. 0 "
        "disables; enforcement requires serene_mem_account = on",
        memory=True, validator=lambda v: max(0, int(v)))
declare("serene_statement_timeout_ms", 0, int,
        "engine-level statement timeout (ms; 0 disables): combines with "
        "the PG-compatible statement_timeout setting (the LOWER positive "
        "value wins) and fires through the same cooperative cancellation "
        "drain (SQLSTATE 57014), including while a statement is QUEUED "
        "for admission", validator=lambda v: max(0, int(v)))
# -- streaming ingest (write path) ------------------------------------------

declare("serene_parallel_ingest", True, bool,
        "parallel write-path analysis: segment builds chunk-split their "
        "document batches across the shared worker pool (per-chunk "
        "tokenization + postings build, merged with a deterministic "
        "base-row-ordered concat) and parquet column decoding builds "
        "columns concurrently; the merged segment is BIT-IDENTICAL to "
        "the serial build — postings order, norms, WAND block metadata "
        "and every score — so this setting stays out of the result "
        "cache's settings digest; off runs the serial single-pass "
        "builder (the parity oracle)")
declare("serene_ingest_chunk_docs", 4096, int,
        "documents per analysis chunk for parallel segment builds; a "
        "corpus smaller than two chunks builds serially (chunk setup "
        "costs more than it buys). The chunk split is fixed-size and "
        "independent of worker count, so the merged postings are "
        "identical at any parallelism", validator=lambda v: max(64, int(v)))
declare("serene_group_commit", True, bool,
        "ingest-side group-commit windows: the WAL leader re-drains the "
        "commit queue for late arrivals before its single fsync, and "
        "concurrent fast-path INSERTs of one table coalesce their "
        "in-memory publications into ONE batch concat + version bump "
        "per window (per-table cache invalidation per WINDOW, not per "
        "statement). Durability and replay order are unchanged — every "
        "frame is fsynced before its statement returns, publishes stay "
        "sequenced by WAL tick — so results are bit-identical on or "
        "off; off restores one publish per statement (the parity "
        "oracle)", scope=Scope.GLOBAL)
declare("serene_background_merge", True, bool,
        "background segment maintenance: query-path read-repair of a "
        "stale inverted index only builds the bounded delta tail (the "
        "rows appended since the last refresh) and never pays "
        "compaction; the maintenance ticker — woken by appends — runs "
        "the tiered merge ladder off the query path, publishing via "
        "the same build-new-then-swap snapshot. Scores use global "
        "collection stats, so results are bit-identical at ANY segment "
        "layout; off restores foreground compaction at the segment cap "
        "(the parity oracle)", scope=Scope.GLOBAL)
declare("serene_max_segments", 8, int,
        "per-field segment-count threshold of the tiered merge ladder: "
        "at or above it, maintenance (or foreground refresh with "
        "serene_background_merge off) merges the smallest adjacent run "
        "of segments — O(run docs), not a full rebuild — until back "
        "under the cap. Lower values merge more eagerly",
        scope=Scope.GLOBAL, validator=lambda v: max(2, int(v)))
declare("serene_zonemap_verify", False, bool,
        "debug assert mode: re-scan every zone-map-pruned block with "
        "the real predicate and fail the query loudly if any row "
        "matched (catches block-statistics/data divergence "
        "structurally; the tier-1 verify script arms this once)")
