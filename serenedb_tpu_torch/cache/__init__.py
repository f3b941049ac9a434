"""Copied from serenedb_tpu/cache/__init__.py.

Multi-tier query cache.

Reference analog: the layered read caches a search engine serves
repeated dashboard/search traffic from — the shard request cache
(per-segment filter/agg fragments, valid while the segment set is
unchanged) and reused whole-request results. ColBERT-serve (PAPERS.md)
shows the same move at model-serving scale: keep hot query state
resident instead of recomputing the multi-stage pipeline.

Two tiers, two invalidation disciplines:

- `cache.result` — whole-statement result memoization. The key embeds
  every input the result is a function of: the statement's canonical
  AST digest, bound parameter values, a digest of result-affecting
  session settings, and the (publication-token, data_version,
  mutation_epoch) tuple of every table the plan scans. Writes bump the
  publication tuple, so a stale entry's key simply never matches again
  — invalidation is implicit and exact.
- `cache.fragments` — per-segment search fragments (filter doc sets,
  top-k collector outputs). Segments are immutable, so a fragment is
  valid for the segment's whole lifetime; appends add segments without
  touching existing entries (the shard-request-cache analog), while
  delete/update rebuilds replace the segment objects and their entries
  die with them.

Both tiers are process-wide bytes-bounded LRUs (`cache.lru.BytesLRU`),
surfaced through the `sdb_cache()` table function, ResultCache*/
FragmentCache* gauges, `/metrics`, `/_stats` and the `cache_hits`
column of `sdb_stat_statements`. `SET serene_result_cache = off`
disables both for a session; results are bit-identical either way.
"""

from .lru import BytesLRU  # noqa: F401
