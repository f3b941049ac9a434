"""Copied from serenedb_tpu/obs/__init__.py.

Query observability: per-operator profiling, timeline tracing,
statement statistics, metrics export.

The instrument panel for every later perf change: `obs.trace` collects
per-operator spans (rows, wall+CPU time, morsel prune counters, bytes,
device time) with per-worker-thread accumulation and a deterministic
sink merge, AND the per-query timeline layer (trace ids, timestamped
span events in per-thread rings, the always-on flight recorder, Chrome
trace export); `obs.statements` keeps the `sdb_stat_statements`
registry keyed by normalized query fingerprint (with per-fingerprint
latency percentiles); `obs.device` is the device tier's nervous system:
the XLA compile ledger every `jax.jit` site routes through
(bounded program LRU, per-family compile stats, recompile-storm
detection), host↔device transfer accounting and per-device dispatch /
HBM attribution, surfaced via `sdb_device()`/`sdb_programs()`/
`sdb_device_cache()` and `GET /device`; `obs.export` renders the
Prometheus `/metrics` (gauges + latency histograms) and JSON `/_stats`
payloads. Profiling is gated by `serene_profile`, timelines by
`serene_trace`, device telemetry by `serene_device_telemetry` (all
default on) and all observe only — results are bit-identical with them
on or off, at any worker/shard count.
"""
