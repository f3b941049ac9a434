"""Copied from serenedb_tpu/utils/metrics.py.

Fixed registry of atomic gauges, ClickHouse-CurrentMetrics style.

Reference analog: libs/basics/metrics.h:27-71 — relaxed-atomic gauges bumped
only at task/connection boundaries (never per row), surfaced via the
`sdb_metrics` system view. Python ints under a lock are cheap enough at those
boundaries.
"""

from __future__ import annotations

import bisect
import threading
from contextlib import contextmanager


class Gauge:
    __slots__ = ("name", "description", "_value", "_lock")

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def sub(self, n: int = 1) -> None:
        self.add(-n)

    def set(self, n: int) -> None:
        """Overwrite the level (byte-size gauges that track a cache's
        current footprint rather than accumulate a count)."""
        with self._lock:
            self._value = n

    def delta(self, baseline: int) -> int:
        """Current value minus a snapshot baseline (one atomic read) —
        the scrape-side pairing of Registry.snapshot()."""
        return self.value - baseline

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    @contextmanager
    def scoped(self, n: int = 1):
        self.add(n)
        try:
            yield
        finally:
            self.sub(n)


#: log-spaced histogram bucket upper bounds in NANOSECONDS: powers of two
#: from 1 µs to ~137 s (28 buckets) plus the implicit +Inf overflow slot.
#: Log spacing keeps relative quantile error bounded (one octave) across
#: six decades of latency with a fixed, tiny footprint — the Prometheus
#: classic-histogram shape, shared by the process-wide `Histogram` gauges
#: and the per-fingerprint latency sketches in obs/statements.py.
HIST_BOUNDS_NS: tuple[int, ...] = tuple(1000 * (1 << k) for k in range(28))


def hist_bucket_index(ns: int) -> int:
    """Bucket slot for one observation: the first bound >= ns, or the
    +Inf slot (len(HIST_BOUNDS_NS)) past the last finite bound."""
    return bisect.bisect_left(HIST_BOUNDS_NS, max(int(ns), 0))


def hist_quantile_ns(counts, q: float) -> float:
    """Quantile estimate from bucket counts (len = len(HIST_BOUNDS_NS)+1)
    by linear interpolation inside the target bucket — the same estimate
    Prometheus' histogram_quantile() would derive from the exported
    buckets, so /_stats and a real Prometheus agree. Observations in the
    +Inf bucket clamp to the largest finite bound. Returns ns (0.0 when
    the histogram is empty)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            if i >= len(HIST_BOUNDS_NS):      # +Inf bucket: clamp
                return float(HIST_BOUNDS_NS[-1])
            lo = float(HIST_BOUNDS_NS[i - 1]) if i else 0.0
            hi = float(HIST_BOUNDS_NS[i])
            return lo + (hi - lo) * ((target - cum) / c)
        cum += c
    return float(HIST_BOUNDS_NS[-1])


class Histogram:
    """Fixed log-spaced-bucket histogram (Prometheus classic histogram
    semantics: cumulative `le` buckets + sum + count).

    Observed at task/statement boundaries only — one bisect over 28
    bounds plus one locked triple update per observation, never per row —
    so p50/p95/p99 become derivable from `/metrics` and `/_stats`
    without any per-request allocation.

    `unit` is "s" (observations in NANOSECONDS, exported as seconds —
    the latency histograms) or "bytes" (observations in bytes, exported
    raw — the memory histograms). The log-spaced bounds read naturally
    in both: 1 µs..137 s, or 1 kB..137 GB."""

    __slots__ = ("name", "description", "unit", "_counts", "_sum_ns",
                 "_lock")

    def __init__(self, name: str, description: str = "", unit: str = "s"):
        self.name = name
        self.description = description
        self.unit = unit
        self._counts = [0] * (len(HIST_BOUNDS_NS) + 1)
        self._sum_ns = 0
        self._lock = threading.Lock()

    def observe_ns(self, ns: int) -> None:
        i = hist_bucket_index(ns)
        with self._lock:
            self._counts[i] += 1
            self._sum_ns += max(int(ns), 0)

    def snapshot(self) -> tuple[list[int], int]:
        """(per-bucket counts, sum ns) under one lock acquisition."""
        with self._lock:
            return list(self._counts), self._sum_ns

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    def quantile_ns(self, q: float) -> float:
        counts, _ = self.snapshot()
        return hist_quantile_ns(counts, q)

    def percentiles_ms(self) -> dict:
        """{count, p50_ms, p95_ms, p99_ms} for the /_stats JSON."""
        counts, _ = self.snapshot()
        return {"count": sum(counts),
                "p50_ms": round(hist_quantile_ns(counts, 0.50) / 1e6, 3),
                "p95_ms": round(hist_quantile_ns(counts, 0.95) / 1e6, 3),
                "p99_ms": round(hist_quantile_ns(counts, 0.99) / 1e6, 3)}

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(HIST_BOUNDS_NS) + 1)
            self._sum_ns = 0


class Registry:
    def __init__(self):
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def gauge(self, name: str, description: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, description)
        return g

    def histogram(self, name: str, description: str = "",
                  unit: str = "s") -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, description, unit)
        return h

    def all(self) -> list[Gauge]:
        return [self._gauges[k] for k in sorted(self._gauges)]

    def all_histograms(self) -> list[Histogram]:
        return [self._hists[k] for k in sorted(self._hists)]

    def snapshot(self) -> dict[str, int]:
        """One point-in-time {name: value} map for scrapes and tests:
        every gauge is read exactly once (each read atomic under its own
        lock), so a consumer iterating the result never races the
        per-gauge locks mid-scrape or sees a gauge twice at two
        values."""
        return {g.name: g.value for g in self.all()}


REGISTRY = Registry()

PG_CONNECTIONS = REGISTRY.gauge("PgConnections", "open PG wire connections")
HTTP_CONNECTIONS = REGISTRY.gauge("HttpConnections", "open HTTP connections")
QUERIES_ACTIVE = REGISTRY.gauge("QueriesActive", "queries currently executing")
REFRESH_ACTIVE = REGISTRY.gauge("RefreshActive", "running refresh tasks")
REFRESH_PENDING = REGISTRY.gauge("RefreshPending", "queued refresh tasks")
COMPACTION_ACTIVE = REGISTRY.gauge("CompactionActive", "running compactions")
COMPACTION_PENDING = REGISTRY.gauge("CompactionPending", "queued compactions")
CLEANUP_ACTIVE = REGISTRY.gauge("CleanupActive", "running cleanup tasks")
DEVICE_OFFLOADS = REGISTRY.gauge("DeviceOffloads", "batches dispatched to TPU")
DEVICE_BYTES = REGISTRY.gauge("DeviceBytesMoved", "bytes copied host->device")
DEVICE_CACHE_HITS = REGISTRY.gauge(
    "DeviceCacheHits",
    "device column cache probes served from HBM-resident uploads "
    "(host->device transfer skipped)")
DEVICE_CACHE_MISSES = REGISTRY.gauge(
    "DeviceCacheMisses",
    "device column cache probes that had to upload from host")
DEVICE_CACHE_EVICTIONS = REGISTRY.gauge(
    "DeviceCacheEvictions",
    "device column cache entries dropped (LRU past the byte cap or a "
    "superseded publication swept on store)")
DEVICE_CACHE_BYTES = REGISTRY.gauge(
    "DeviceCacheBytes",
    "current bytes held by the device column cache")
DEVICE_PROGRAMS_COMPILED = REGISTRY.gauge(
    "DeviceProgramsCompiled",
    "jitted device programs built by the compile ledger "
    "(obs/device.py) — each is one XLA trace+compile on first dispatch")
DEVICE_PROGRAM_HITS = REGISTRY.gauge(
    "DeviceProgramCacheHits",
    "compile-ledger probes served by an already-compiled program "
    "(no retrace, no recompile)")
DEVICE_PROGRAM_MISSES = REGISTRY.gauge(
    "DeviceProgramCacheMisses",
    "compile-ledger probes that had to build a new program")
DEVICE_PROGRAM_EVICTIONS = REGISTRY.gauge(
    "DeviceProgramCacheEvictions",
    "compiled programs dropped by the bounded program LRU "
    "(serene_program_cache_entries); an evicted shape re-compiles on "
    "next use")
DEVICE_PROGRAM_ENTRIES = REGISTRY.gauge(
    "DeviceProgramCacheEntries",
    "compiled programs currently held by the program LRU (live)")
DEVICE_RECOMPILE_STORMS = REGISTRY.gauge(
    "DeviceRecompileStorms",
    "recompile-storm warnings fired: one program family compiled more "
    "than RECOMPILE_STORM_PER_MIN new shapes within a minute — repeat "
    "queries are not reusing cached executables")
DEVICE_TRANSFERS_UP = REGISTRY.gauge(
    "DeviceTransfersUp",
    "host->device transfers recorded by the device telemetry ledger "
    "(column uploads, code/rowmask tiles, stacked mesh commits, "
    "cached build-output commits)")
DEVICE_FETCH_BYTES = REGISTRY.gauge(
    "DeviceBytesFetched",
    "bytes copied device->host fetching program outputs (the "
    "readback sibling of DeviceBytesMoved)")
WAL_COMMITS = REGISTRY.gauge("WalCommits", "search WAL commit records written")
WAL_FSYNCS = REGISTRY.gauge(
    "WalFsyncs", "WAL group-commit fsync calls (commits per fsync = "
    "WalCommits / WalFsyncs — the group-commit amortization ratio)")
INGEST_DOCS = REGISTRY.gauge(
    "IngestDocs", "rows appended through the write path (INSERT/COPY)")
INGEST_BYTES = REGISTRY.gauge(
    "IngestBytes", "columnar bytes appended through the write path")
INGEST_BATCHES = REGISTRY.gauge(
    "IngestBatches", "write-path append batches (statements or COPY "
    "chunks; IngestDocs / IngestBatches = mean batch size)")
SEGMENT_BUILDS = REGISTRY.gauge(
    "SegmentBuilds", "inverted-index field segments built (initial "
    "builds + delta tails)")
SEGMENT_MERGES = REGISTRY.gauge(
    "SegmentMerges", "tiered segment merges (adjacent runs compacted "
    "into one segment)")
POOL_MORSELS = REGISTRY.gauge("PoolMorselsExecuted",
                              "morsel tasks executed by the worker pool")
POOL_QUEUE_WAIT_US = REGISTRY.gauge("PoolQueueWaitUs",
                                    "cumulative µs tasks waited queued")
POOL_BUSY_US = REGISTRY.gauge("PoolBusyUs",
                              "cumulative µs workers spent running tasks")
POOL_STEALS = REGISTRY.gauge("PoolSteals",
                             "tasks stolen from a sibling worker's deque")
ZONEMAP_PRUNED = REGISTRY.gauge(
    "ZonemapMorselsPruned",
    "scan/aggregate morsels skipped because block statistics proved no "
    "row could match")
ZONEMAP_SCANNED = REGISTRY.gauge(
    "ZonemapMorselsScanned",
    "morsels that passed zone-map analysis and were actually scanned")
JOIN_FILTER_PRUNED = REGISTRY.gauge(
    "JoinFilterMorselsPruned",
    "probe-side scan morsels skipped because the build side's published "
    "key range proved no row of the block could find a join partner")
JOIN_FILTER_SCANNED = REGISTRY.gauge(
    "JoinFilterMorselsScanned",
    "probe-side morsels that passed the join-filter key-range analysis "
    "and were actually scanned")
ZONEMAP_STALE_REBUILDS = REGISTRY.gauge(
    "ZonemapStaleRebuilds",
    "zone-map column stats rebuilt from scratch after a non-append "
    "mutation invalidated the cached version")
QUERIES_EXECUTED = REGISTRY.gauge(
    "QueriesExecuted", "statements completed (success) since start")
QUERY_TIME_NS = REGISTRY.gauge(
    "QueryTimeNs", "cumulative ns spent executing completed statements")
SLOW_QUERIES = REGISTRY.gauge(
    "SlowQueries",
    "statements that exceeded serene_log_min_duration_ms and were "
    "written to the slow-query log")
RESULT_CACHE_HITS = REGISTRY.gauge(
    "ResultCacheHits",
    "statements served from the result cache without executing")
RESULT_CACHE_MISSES = REGISTRY.gauge(
    "ResultCacheMisses",
    "cacheable statements that executed because no entry matched")
RESULT_CACHE_EVICTIONS = REGISTRY.gauge(
    "ResultCacheEvictions",
    "result-cache entries evicted (LRU byte pressure or a superseded "
    "publication swept)")
RESULT_CACHE_BYTES = REGISTRY.gauge(
    "ResultCacheBytes", "bytes currently held by the result cache")
FRAGMENT_CACHE_HITS = REGISTRY.gauge(
    "FragmentCacheHits",
    "per-segment search fragments (filter doc sets / top-k outputs) "
    "served from the fragment cache")
FRAGMENT_CACHE_MISSES = REGISTRY.gauge(
    "FragmentCacheMisses",
    "per-segment search fragments computed because no entry matched")
FRAGMENT_CACHE_BYTES = REGISTRY.gauge(
    "FragmentCacheBytes", "bytes currently held by the fragment cache")
SEARCH_BATCH_DISPATCHES = REGISTRY.gauge(
    "SearchBatchDispatches",
    "coalesced search scoring dispatches executed by the query batcher "
    "(each scores one or more top-k queries in one vectorized pass)")
SEARCH_BATCH_QUERIES = REGISTRY.gauge(
    "SearchBatchQueries",
    "top-k queries scored through batcher dispatches (QUERIES / "
    "DISPATCHES = mean batch size)")
SEARCH_BATCH_WINDOW_WAIT_NS = REGISTRY.gauge(
    "SearchBatchWindowWaitNs",
    "cumulative ns queries spent queued in the batcher before their "
    "dispatch started (coalescing latency cost)")
SEARCH_BATCH_COALESCED = REGISTRY.gauge(
    "SearchBatchCoalesced",
    "queries that shared their scoring dispatch with at least one other "
    "query (the batching win; singleton dispatches don't count)")
POSTING_POOL_HITS = REGISTRY.gauge(
    "PostingPoolHits",
    "posting-pool term lookups served by pages already resident in the "
    "device region (search/posting_pool.py) — each hit is one term's "
    "postings the batched ragged path did NOT re-upload")
POSTING_POOL_MISSES = REGISTRY.gauge(
    "PostingPoolMisses",
    "posting-pool term lookups that allocated and wrote fresh pages "
    "(first touch of a (segment, term) key, or re-entry after eviction)")
POSTING_POOL_EVICTIONS = REGISTRY.gauge(
    "PostingPoolEvictions",
    "resident terms evicted LRU from the posting pool to make room "
    "under the serene_posting_pages budget")
POSTING_POOL_PAGES_USED = REGISTRY.gauge(
    "PostingPoolPagesUsed",
    "pages of the device posting region currently holding resident "
    "terms (live; budget is serene_posting_pages)")
POSTING_POOL_BYTES = REGISTRY.gauge(
    "PostingPoolBytes",
    "bytes of the device posting region currently occupied by resident "
    "terms (live; PagesUsed x page size x docs+tfs)")
POSTING_POOL_DEVICE_QUERIES = REGISTRY.gauge(
    "PostingPoolDeviceQueries",
    "batched ragged queries scored fully on device because every slice "
    "was page-resident (final top-k left the device sorted)")
POSTING_POOL_PARTIAL = REGISTRY.gauge(
    "PostingPoolPartialQueries",
    "batched ragged queries whose resident prefix scored on device "
    "with the host merging the non-resident tail slices (deterministic "
    "same-order f32 adds — bit-identical to the all-host path)")
VECTOR_SEARCH_QUERIES = REGISTRY.gauge(
    "VectorSearchQueries",
    "knn / MaxSim queries scored by the vector subsystem "
    "(search/vector_store.py) — each member of a coalesced batch "
    "counts once")
VECTOR_SEARCH_DISPATCHES = REGISTRY.gauge(
    "VectorSearchDispatches",
    "jitted vector programs dispatched (probe, brute-oracle and MaxSim "
    "batches each count one; a warm coalesced batch is exactly one)")
VECTOR_PROBED_CLUSTERS = REGISTRY.gauge(
    "VectorProbedClusters",
    "IVF cluster lists probed across all vector queries (queries x "
    "effective nprobe) — the work that scales with nprobe, not N")
VECTOR_BYTES_RESIDENT = REGISTRY.gauge(
    "VectorBytesResident",
    "bytes of the device vector region currently occupied by resident "
    "segments (live pages x page size; budget is serene_vector_pages)")
VECTOR_POOL_HITS = REGISTRY.gauge(
    "VectorPoolHits",
    "vector-pool segment lookups served by pages already resident in "
    "the device region — a hit means the batch re-scored vectors "
    "without re-uploading them")
VECTOR_POOL_MISSES = REGISTRY.gauge(
    "VectorPoolMisses",
    "vector-pool segment lookups that allocated and wrote fresh pages "
    "(first touch of a segment, or re-entry after eviction)")
VECTOR_POOL_EVICTIONS = REGISTRY.gauge(
    "VectorPoolEvictions",
    "resident vector segments evicted LRU from the vector pool to make "
    "room under the serene_vector_pages budget")
SHARD_PIPELINES = REGISTRY.gauge(
    "ShardPipelines",
    "per-shard pipeline executions launched by the sharded execution "
    "tier (serene_shards > 1): each morsel group, fused device dispatch "
    "or segment-set search run over one shard counts once")
SHARD_MORSELS_PRUNED = REGISTRY.gauge(
    "ShardMorselsPruned",
    "probe-side blocks pruned by the shard-to-shard join filter: the "
    "build side's PER-SHARD key min/max ranges proved no row of the "
    "block can find a partner in any build shard")
SHARD_BYTES_SKIPPED = REGISTRY.gauge(
    "ShardBytesSkipped",
    "host->device upload bytes skipped because per-shard pruning "
    "proved a probe shard's blocks partner-less before any transfer")
COLLECTIVE_DISPATCHES = REGISTRY.gauge(
    "CollectiveDispatches",
    "shard_map-partitioned collective dispatches executed by the "
    "sharded tier with serene_shard_combine=device: each fused "
    "join/aggregate (psum/pmin/pmax cross-shard reduction) or search "
    "top-k merge (per-shard sort + all_gather) over the mesh data axis "
    "counts once — the single dispatch that replaces build+N probe "
    "dispatches plus the host-side numpy combine")
COLLECTIVE_COMBINE_NS = REGISTRY.gauge(
    "CollectiveCombineNs",
    "cumulative ns spent inside collective shard-combine dispatches "
    "(the in-program psum/pmin/pmax/all_gather sections, wall time of "
    "the whole one-dispatch program)")
POOL_QUEUE_DEPTH = REGISTRY.gauge(
    "PoolQueueDepth",
    "tasks currently queued in the worker pool (submitted, not yet "
    "picked up) — the live backpressure signal admission control reads")
POOL_RUNNING = REGISTRY.gauge(
    "PoolRunningTasks",
    "tasks currently executing on worker-pool threads")
POOL_TASK_WAIT_NS = REGISTRY.gauge(
    "PoolTaskWaitNs",
    "cumulative ns tasks spent queued before a worker picked them up "
    "(the ns-precision sibling of PoolQueueWaitUs)")
ADMISSION_QUEUED = REGISTRY.gauge(
    "AdmissionQueued",
    "statements that had to WAIT in the admission queue before "
    "executing (cumulative; sched/governor.py)")
ADMISSION_REJECTED = REGISTRY.gauge(
    "AdmissionRejected",
    "statements rejected with SQLSTATE 53300 because the admission "
    "queue was already serene_admission_queue_depth deep")
ADMISSION_WAIT_NS = REGISTRY.gauge(
    "AdmissionWaitNs",
    "cumulative ns statements spent queued for admission before "
    "starting (the statement-level sibling of PoolTaskWaitNs)")
ADMISSION_QUEUE_DEPTH = REGISTRY.gauge(
    "AdmissionQueueDepth",
    "statements currently waiting in the admission queue (live)")
CONNECTIONS_OPEN = REGISTRY.gauge(
    "ConnectionsOpen",
    "sockets currently open on the serving front door, both protocols "
    "(sched/governor.py ConnectionGate; server/frontdoor.py)")
CONNECTIONS_IDLE = REGISTRY.gauge(
    "ConnectionsIdle",
    "front-door connections waiting for the client's next request / "
    "command (live)")
CONNECTIONS_ACTIVE = REGISTRY.gauge(
    "ConnectionsActive",
    "front-door connections with a request or handshake in flight "
    "(live)")
CONNECTIONS_REJECTED = REGISTRY.gauge(
    "ConnectionsRejected",
    "connections rejected at the accept gate because "
    "serene_max_connections sockets were already open (cumulative; "
    "pgwire clients get a clean 53300 error packet, HTTP clients a "
    "429, both before a single byte of the session is parsed)")
SOCKET_BYTES_BUFFERED = REGISTRY.gauge(
    "SocketBytesBuffered",
    "bytes sitting in front-door transport write buffers (slow "
    "readers), sampled at scrape time; bounded per connection by "
    "serene_conn_write_high_kb + pause_reading")
SCHED_PREEMPTIONS = REGISTRY.gauge(
    "SchedPreemptions",
    "fair-share pool picks that ran a later-submitted statement's task "
    "ahead of the FIFO-oldest queued task (each one is an interleave "
    "plain FIFO would not have done; serene_fair_share)")
TRACES_RECORDED = REGISTRY.gauge(
    "TracesRecorded",
    "query timelines finalized into the flight recorder since start")
TRACE_SPANS_DROPPED = REGISTRY.gauge(
    "TraceSpansDropped",
    "span events dropped because a per-thread trace ring hit its cap "
    "(the timeline stays bounded; widest spans are still present)")
MEM_ACCOUNT_EVENTS = REGISTRY.gauge(
    "MemAccountEvents",
    "charge/release events recorded by per-query memory accounting "
    "(serene_mem_account) — the direct-decomposition input for the "
    "mem_overhead bench shape")
PROCESS_RSS_BYTES = REGISTRY.gauge(
    "ProcessRssBytes",
    "resident set size of this process (/proc/self/statm), sampled at "
    "scrape time and by the maintenance ticker")
PROCESS_UPTIME_SECONDS = REGISTRY.gauge(
    "ProcessUptimeSeconds",
    "seconds since this process initialized the metrics registry")
GC_GEN0_COLLECTIONS = REGISTRY.gauge(
    "GcGen0Collections", "CPython gc generation-0 collections")
GC_GEN1_COLLECTIONS = REGISTRY.gauge(
    "GcGen1Collections", "CPython gc generation-1 collections")
GC_GEN2_COLLECTIONS = REGISTRY.gauge(
    "GcGen2Collections", "CPython gc generation-2 collections")

#: latency histograms (log-spaced buckets; Prometheus histogram series
#: in /metrics, p50/p95/p99 in /_stats). Observed at statement / task /
#: dispatch boundaries only.
QUERY_LATENCY_HIST = REGISTRY.histogram(
    "QueryLatency",
    "end-to-end statement latency (success paths)")
POOL_QUEUE_WAIT_HIST = REGISTRY.histogram(
    "PoolQueueWait",
    "per-task worker-pool queue wait (submit -> pickup)")
ACCEPT_QUEUE_WAIT_HIST = REGISTRY.histogram(
    "AcceptQueueWait",
    "per-connection wait between the OS handing the front door a "
    "socket and the session coroutine starting to serve it (event-loop "
    "accept backlog; server/frontdoor.py)")
SEARCH_BATCH_WINDOW_HIST = REGISTRY.histogram(
    "SearchBatchWindow",
    "per-query search-batcher coalescing wait (submit -> dispatch "
    "start)")
DEVICE_DISPATCH_HIST = REGISTRY.histogram(
    "DeviceDispatch",
    "per-offload device execution time: the fused pipeline observes "
    "the dispatch section (post-upload; first call includes jit "
    "compile), device aggregates and top-N observe the whole offload "
    "(upload + compile-cache lookup + dispatch + readback)")
DEVICE_COMPILE_HIST = REGISTRY.histogram(
    "DeviceCompile",
    "first-dispatch latency of each jitted device program (XLA "
    "trace + compile + the first execution — the compile-stall a "
    "cold query pays; warm dispatches land in DeviceDispatch)")
WAL_FSYNC_HIST = REGISTRY.histogram(
    "WalFsync",
    "WAL group-commit flush+fsync latency (one observation per fsync, "
    "however many commit frames it covered)")
QUERY_PEAK_BYTES_HIST = REGISTRY.histogram(
    "QueryPeakBytes",
    "per-statement accounted peak memory (serene_mem_account): the "
    "sum of per-thread peak live bytes charged at materialization "
    "sites — an upper bound on the statement's true simultaneous peak",
    unit="bytes")
