"""Copied from serenedb_tpu/obs/export.py.

Prometheus-text `/metrics` and JSON `/_stats` payload rendering.

Reference analog: the reference's monitoring endpoint surface — here the
fixed gauge registry (utils/metrics.py) plus the statement store render
into the Prometheus exposition format (text/plain; version=0.0.4) and a
JSON object the ES-compatible `/_stats` route merges in.
"""

from __future__ import annotations

import re

from ..utils import metrics as _metrics
from .statements import STATEMENTS

_CAMEL = re.compile(r"(?<=[a-z0-9])(?=[A-Z])")


def _prom_name(gauge_name: str) -> str:
    return "serenedb_" + _CAMEL.sub("_", gauge_name).lower()


def _label_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text() -> str:
    """The whole registry as Prometheus gauges (one consistent
    Registry.snapshot(), not per-gauge reads mid-scrape), the latency
    histograms as classic-histogram series (cumulative `le` buckets in
    seconds + _sum/_count — p50/p99 derivable with
    histogram_quantile()), plus per-statement call/time/row series
    labeled by queryid."""
    from .resources import sample_process_gauges
    sample_process_gauges()
    lines: list[str] = []
    snap = _metrics.REGISTRY.snapshot()
    descs = {g.name: g.description for g in _metrics.REGISTRY.all()}
    for name in sorted(snap):
        pname = _prom_name(name)
        if descs.get(name):
            lines.append(f"# HELP {pname} {descs[name]}")
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {snap[name]}")
    for h in _metrics.REGISTRY.all_histograms():
        # latency histograms observe ns and export as seconds; byte
        # histograms observe bytes and export raw (the shared
        # log-spaced bounds read as 1 kB..137 GB there)
        seconds = h.unit == "s"
        pname = _prom_name(h.name) + ("_seconds" if seconds else "")
        scale = 1e9 if seconds else 1.0
        counts, sum_raw = h.snapshot()
        if h.description:
            lines.append(f"# HELP {pname} {h.description}")
        lines.append(f"# TYPE {pname} histogram")
        cum = 0
        for bound, c in zip(_metrics.HIST_BOUNDS_NS, counts):
            cum += c
            lines.append(
                f'{pname}_bucket{{le="{bound / scale:.6g}"}} {cum}')
        cum += counts[-1]
        lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{pname}_sum {sum_raw / scale:.9g}")
        lines.append(f"{pname}_count {cum}")
    stmts = STATEMENTS.snapshot()
    if stmts:
        for series, key in (("statement_calls", "calls"),
                            ("statement_total_ms", "total_ms"),
                            ("statement_rows", "rows"),
                            ("statement_cache_hits", "cache_hits")):
            pname = f"serenedb_{series}"
            lines.append(f"# TYPE {pname} counter")
            for e in stmts:
                q = _label_escape(e["query"][:200])
                lines.append(
                    f'{pname}{{queryid="{e["queryid"]}",query="{q}"}} '
                    f"{e.get(key, 0)}")
    return "\n".join(lines) + "\n"


def _bytes_percentiles(h) -> dict:
    """{count, p50/p95/p99_bytes} for a byte-unit histogram."""
    counts, _ = h.snapshot()
    q = _metrics.hist_quantile_ns
    return {"count": sum(counts),
            "p50_bytes": int(q(counts, 0.50)),
            "p95_bytes": int(q(counts, 0.95)),
            "p99_bytes": int(q(counts, 0.99))}


def stats_json() -> dict:
    """Gauge snapshot + latency percentiles + statement stats + cache
    tier summaries + flight-recorder summary + the memory section
    (query-peak percentiles, process RSS/uptime/GC, live query
    progress) for the JSON `/_stats` route."""
    from ..cache.fragments import FRAGMENTS
    from ..cache.result import RESULT_CACHE
    from ..sched.governor import GOVERNOR
    from . import device as _device
    from .resources import ACTIVE, read_rss_bytes, sample_process_gauges
    from .trace import FLIGHT, flight_summary
    sample_process_gauges()
    snap = _metrics.REGISTRY.snapshot()
    from ..sched.governor import CONNGATE
    return {"metrics": snap,
            # workload governor: live running/queued counts + limits +
            # cumulative admission totals (sched/governor.py)
            "admission": GOVERNOR.snapshot(),
            # socket layer: open/idle/active connection counts against
            # serene_max_connections, accept-gate rejections,
            # pause-reading events and buffered write bytes
            # (sched/governor.py ConnectionGate; server/frontdoor.py)
            "connections": CONNGATE.snapshot(),
            # device telemetry: per-device dispatch/transfer/HBM rows,
            # the compile ledger, cache summaries (obs/device.py)
            "device": _device.stats_section(),
            "latency": {h.name: h.percentiles_ms()
                        for h in _metrics.REGISTRY.all_histograms()
                        if h.unit == "s"},
            # write path: append/segment/fsync counters + the group-commit
            # amortization signals (commits per fsync, fsync latency)
            "ingest": {
                "docs": snap.get("IngestDocs", 0),
                "bytes": snap.get("IngestBytes", 0),
                "batches": snap.get("IngestBatches", 0),
                "segment_builds": snap.get("SegmentBuilds", 0),
                "segment_merges": snap.get("SegmentMerges", 0),
                "wal_commits": snap.get("WalCommits", 0),
                "wal_fsyncs": snap.get("WalFsyncs", 0),
                "wal_fsync": _metrics.WAL_FSYNC_HIST.percentiles_ms()},
            "statements": STATEMENTS.snapshot(),
            "cache": {"result": RESULT_CACHE.stats(),
                      "fragments": FRAGMENTS.stats()},
            "traces": [flight_summary(e) for e in FLIGHT.snapshot()],
            "memory": {
                "query_peak": _bytes_percentiles(
                    _metrics.QUERY_PEAK_BYTES_HIST),
                "process": {
                    "rss_bytes": read_rss_bytes(),
                    "uptime_seconds": snap.get("ProcessUptimeSeconds", 0),
                    "gc_collections": [
                        snap.get("GcGen0Collections", 0),
                        snap.get("GcGen1Collections", 0),
                        snap.get("GcGen2Collections", 0)]},
                "progress": ACTIVE.snapshot()}}
