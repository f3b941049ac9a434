"""Copied from serenedb_tpu/exec/search_scan.py.

Index-driven scan: the TPU analog of the reference's IResearch scan modes.

Reference analog: IResearchScanInitGlobal / DecideScanMode — Stream (filter
→ doc ids → materialize) and TopK (scored collectors)
(reference: server/connector/duckdb_search_full_scan.hpp:54-76).

Two modes:
- filter: evaluate the ts-predicate on the index (CPU doc-set algebra with
  device disjunction bitmaps), materialize matching rows, apply residual
  predicates.
- topk: BM25 block scoring + top-k on device (ops/bm25.py); emits rows in
  score order plus a `#score` float column the planner wires into bm25()
  calls and ORDER BY.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column
from ..search.query import QNode
from ..sql.expr import BoundExpr
from .plan import PlanNode
from .tables import TableProvider

SCORE_COL = "#score"


class SearchScanNode(PlanNode):
    def __init__(self, provider: TableProvider, columns: list[str],
                 alias: str, search_column: str, qnode: QNode,
                 residual: Optional[BoundExpr], topk: Optional[int],
                 with_score: bool, scorer: str = "bm25"):
        self.provider = provider
        self.columns = columns
        self.alias = alias
        self.search_column = search_column
        self.qnode = qnode
        self.residual = residual
        self.topk = topk
        self.with_score = with_score
        self.scorer = scorer
        self.names = list(columns) + ([SCORE_COL] if with_score else [])
        self.types = [provider.type_of(c) for c in columns] + \
            ([dt.FLOAT] if with_score else [])

    def children(self):
        return []

    def label(self):
        mode = f"TopK k={self.topk}" if self.topk is not None else "Stream"
        return (f"SearchScan {self.provider.name}.{self.search_column} "
                f"mode={mode}")

    def _searcher(self):
        from ..search.index import find_index
        idx = find_index(self.provider, self.search_column)
        if idx is None:
            return None
        return idx.searcher(self.search_column)

    def _matching_docs(self, searcher) -> np.ndarray:
        """Doc selection with PG NULL semantics: a predicate over a NULL
        text value is NULL, never true — negation queries must not surface
        NULL rows. The count fast path shares this exact logic."""
        docs = searcher.eval_filter(self.qnode)
        col = self.provider.host_column(self.search_column)
        if col.validity is not None:
            docs = docs[col.validity[docs]]
        return docs

    def count_matching(self):
        """Row count without materialization (reference: ScanMode::Count);
        None when not applicable (top-k or residual present)."""
        if self.residual is not None or self.topk is not None:
            return None
        searcher = self._searcher()
        if searcher is None:
            return None
        return len(self._matching_docs(searcher))

    def batches(self, ctx):
        from .plan import check_cancel
        check_cancel()
        searcher = self._searcher()
        if searcher is None:
            raise RuntimeError("search index disappeared under the plan "
                               "(stale rewrite)")
        # ONE publication observation: the batch being materialized and
        # the zone-map verdicts pruning its candidate docs must come
        # from the same pin, or a racing publish could prune docs whose
        # values in the batch actually being scanned still match
        pin = self.provider.try_pin()
        if pin is not None and all(c in pin[0] for c in self.columns):
            full = Batch(list(self.columns),
                         [pin[0].column(c) for c in self.columns])
        else:
            full = self.provider.full_batch(self.columns)
        mesh_n = int(ctx.settings.get("serene_mesh") or 0)
        # stamp the scan's publication identity onto the searcher's
        # segments so posting-pool pages written for them report which
        # table/version/epoch they serve (sdb_posting_pool rows)
        from ..search import posting_pool
        posting_pool.note_publication(searcher, self.provider, pin)
        if self.topk is not None:
            # all serving paths (SQL @@@/bm25 scans, ES _search/_msearch)
            # funnel through this scan — the batcher coalesces concurrent
            # sessions' top-k dispatches here (serene_search_batch=off
            # dispatches serially, the parity oracle)
            from ..search.batcher import batched_topk
            (scores, docs), bstats = batched_topk(
                searcher, self.qnode, self.topk, self.scorer, mesh_n,
                ctx.settings)
            self._stamp_batch(ctx, bstats)
            self._stamp_shards(ctx, searcher)
            out = full.take(docs.astype(np.int64))
            if self.with_score:
                out = Batch(list(self.names),
                            out.columns + [Column(dt.FLOAT,
                                                  scores.astype(np.float32))])
            if self.residual is not None:
                c = self.residual.eval(out)
                out = out.filter(c.data.astype(bool) & c.valid_mask())
            yield out
            return
        docs = self._matching_docs(searcher)
        # the score pass ranks ALL index matches (it knows nothing of
        # the residual), so k must cover the PRE-prune candidate count —
        # otherwise pruned high-score docs would occupy the k slots and
        # surviving docs would read 0.0 off the score map
        n_candidates = len(docs)
        # zone maps on the column-filter side: candidate docs landing in
        # blocks the residual provably can't match are dropped BEFORE
        # materialization, and residual evaluation is skipped entirely
        # when every surviving doc sits in an all-match block (stream
        # mode only — top-k applies its residual after ranking)
        docs, residual_decided = self._prune_docs_by_zones(ctx, full, docs,
                                                           pin)
        out = full.take(docs.astype(np.int64))
        if self.with_score:
            from ..search.batcher import batched_topk
            (scores, sdocs), bstats = batched_topk(
                searcher, self.qnode, max(n_candidates, 1), self.scorer,
                mesh_n, ctx.settings)
            self._stamp_batch(ctx, bstats)
            self._stamp_shards(ctx, searcher)
            smap = np.zeros(max(searcher.num_docs, 1), dtype=np.float32)
            smap[sdocs] = scores
            out = Batch(list(self.names),
                        out.columns + [Column(dt.FLOAT, smap[docs])])
        if self.residual is not None and not residual_decided:
            c = self.residual.eval(out)
            out = out.filter(c.data.astype(bool) & c.valid_mask())
        yield out

    def _stamp_batch(self, ctx, bstats) -> None:
        """Profiler attribution of one batcher round trip (None when the
        query was served from the fragment cache or dispatched serially)."""
        prof = getattr(ctx, "profile", None)
        if prof is not None and bstats is not None:
            prof.add_search_batch(id(self), queries=bstats["queries"],
                                  window_ns=bstats["window_ns"],
                                  scoring_ns=bstats["scoring_ns"])

    def _stamp_shards(self, ctx, searcher) -> None:
        """`Shards:` attribution for a sharded multi-segment search:
        the segment set partitioned into min(serene_shards, segments)
        per-shard collector groups (searcher._run_segment_shards)."""
        from . import shard as shard_mod
        n = shard_mod.shard_count(ctx.settings)
        nseg = len(getattr(searcher, "segments", ()) or ())
        if n > 1 and nseg > 1:
            shard_mod.stamp_profile(ctx, id(self), min(n, nseg))

    def _prune_docs_by_zones(self, ctx, full: Batch, docs: np.ndarray,
                             pin) -> tuple[np.ndarray, bool]:
        """(surviving docs, residual_decided). residual_decided is True
        when zone maps proved the residual holds for every survivor.
        `pin` is the SAME publication observation `full` was built from."""
        if self.residual is None or not len(docs):
            return docs, False
        from . import zonemap
        block_rows = int(ctx.settings.get("serene_morsel_rows"))
        verdicts = zonemap.block_verdicts(
            self.provider, ctx.settings, [self.residual], self.columns,
            block_rows, pin)
        if verdicts is None:
            return docs, False
        bidx = docs // block_rows
        # an index refreshed past the pinned publication can hold docs
        # beyond the stats tail: treat those as must-scan
        v = np.where(bidx < len(verdicts),
                     verdicts[np.minimum(bidx, len(verdicts) - 1)],
                     np.int8(zonemap.SCAN))
        keep = v != zonemap.SKIP
        if not keep.all():
            from ..utils import metrics
            scanned_blocks = np.unique(bidx[keep])
            pruned_blocks = np.setdiff1d(np.unique(bidx[~keep]),
                                         scanned_blocks)
            metrics.ZONEMAP_PRUNED.add(len(pruned_blocks))
            metrics.ZONEMAP_SCANNED.add(len(scanned_blocks))
            prof = getattr(ctx, "profile", None)
            if prof is not None:
                prof.add_scan_morsels(id(self),
                                      scheduled=len(scanned_blocks),
                                      pruned=len(pruned_blocks))
            if zonemap.verify_enabled(ctx.settings):
                dropped = full.take(docs[~keep].astype(np.int64))
                c = self.residual.eval(dropped)
                if (c.data.astype(bool) & c.valid_mask()).any():
                    raise AssertionError(
                        "serene_zonemap_verify: zone map dropped a "
                        f"matching candidate doc in search scan of "
                        f"{self.provider.name}")
            docs = docs[keep]
            v = v[keep]
        return docs, bool(len(v)) and bool((v == zonemap.ALL).all())


class IvfScanNode(PlanNode):
    """ANN top-k scan: rows in ascending distance order + a `#dist` column.

    Reference analog: the ANN claim path (TryClaimAnnRange,
    optimizer/iresearch_plan.cpp:927-1015) feeding the IVF index."""

    DIST_COL = "#dist"

    def __init__(self, provider: TableProvider, columns: list[str],
                 alias: str, vector_column: str, query_vec, topk: int):
        self.provider = provider
        self.columns = columns
        self.alias = alias
        self.vector_column = vector_column
        self.query_vec = query_vec
        self.topk = topk
        self.names = list(columns) + [self.DIST_COL]
        self.types = [provider.type_of(c) for c in columns] + [dt.DOUBLE]

    def children(self):
        return []

    def label(self):
        return (f"IvfScan {self.provider.name}.{self.vector_column} "
                f"k={self.topk}")

    def batches(self, ctx):
        from .plan import check_cancel
        check_cancel()
        from ..search import vector_store
        from ..search.ivf import find_ivf_index
        idx = find_ivf_index(self.provider, self.vector_column)
        if idx is None:
            raise RuntimeError("ivf index disappeared under the plan")
        pin = self.provider.try_pin()
        # stamp the publication identity onto the index so vector-pool
        # pages written for its segments report which table/version they
        # serve (sdb_vector_pool rows)
        vector_store.note_publication(idx, self.provider, pin)
        nprobe = vector_store.effective_nprobe(ctx.settings)
        rerank = int(ctx.settings.get("sdb_rerank_factor"))
        mesh_n = int(ctx.settings.get("serene_mesh") or 0)
        # knn dispatches coalesce through the same batcher as BM25 —
        # the probe knobs ride in the scorer string, so queries with
        # different (k, nprobe, rerank) never share a stacked dispatch
        from ..search.batcher import batched_topk
        (dists, rows), bstats = batched_topk(
            idx, np.ascontiguousarray(self.query_vec, np.float32),
            self.topk, f"knn:{nprobe}:{rerank}", mesh_n, ctx.settings)
        prof = getattr(ctx, "profile", None)
        if prof is not None and bstats is not None:
            prof.add_search_batch(id(self), queries=bstats["queries"],
                                  window_ns=bstats["window_ns"],
                                  scoring_ns=bstats["scoring_ns"])
        keep = np.isfinite(dists)
        d, r = dists[keep], rows[keep]
        full = self.provider.full_batch(self.columns)
        out = full.take(r.astype(np.int64))
        yield Batch(list(self.names),
                    out.columns + [Column(dt.DOUBLE, d.astype(np.float64))])


class MaxSimScanNode(PlanNode):
    """Late-interaction top-k scan: rows in DESCENDING MaxSim-score
    order + a `#msim` column. Docs without tokens (NULL / empty) never
    match. `serene_maxsim = off` serves the exact float64 host oracle
    instead of the device program (FLASH-MAXSIM's reference check)."""

    SCORE_COL = "#msim"

    def __init__(self, provider: TableProvider, columns: list[str],
                 alias: str, vector_column: str, query_toks, topk: int):
        self.provider = provider
        self.columns = columns
        self.alias = alias
        self.vector_column = vector_column
        self.query_toks = query_toks
        self.topk = topk
        self.names = list(columns) + [self.SCORE_COL]
        self.types = [provider.type_of(c) for c in columns] + [dt.DOUBLE]

    def children(self):
        return []

    def label(self):
        return (f"MaxSimScan {self.provider.name}.{self.vector_column} "
                f"k={self.topk}")

    def batches(self, ctx):
        from .plan import check_cancel
        check_cancel()
        from ..search import vector_store
        from ..search.ivf import find_maxsim_index
        idx = find_maxsim_index(self.provider, self.vector_column)
        if idx is None:
            raise RuntimeError("maxsim index disappeared under the plan")
        pin = self.provider.try_pin()
        vector_store.note_publication(idx, self.provider, pin)
        q = np.ascontiguousarray(self.query_toks, np.float32)
        if vector_store.maxsim_device(ctx.settings):
            mesh_n = int(ctx.settings.get("serene_mesh") or 0)
            from ..search.batcher import batched_topk
            (keys, rows), bstats = batched_topk(
                idx, q, self.topk, "maxsim", mesh_n, ctx.settings)
            prof = getattr(ctx, "profile", None)
            if prof is not None and bstats is not None:
                prof.add_search_batch(id(self), queries=bstats["queries"],
                                      window_ns=bstats["window_ns"],
                                      scoring_ns=bstats["scoring_ns"])
            keep = np.isfinite(keys)
            scores = -keys[keep].astype(np.float64)
            r = rows[keep]
        else:
            hs = idx.host_scores(q)
            order = np.lexsort((idx.doc_rows, -hs))[:self.topk]
            scores = hs[order]
            r = idx.doc_rows[order]
        full = self.provider.full_batch(self.columns)
        out = full.take(r.astype(np.int64))
        yield Batch(list(self.names),
                    out.columns + [Column(dt.DOUBLE, scores)])


class BtreeScanNode(PlanNode):
    """Point/range lookup through a btree index (reference: PK lookup
    fast path, scripts/perf/bench_pk_lookup.sh)."""

    def __init__(self, provider: TableProvider, columns: list[str],
                 alias: str, index_column: str, eq_value, residual):
        self.provider = provider
        self.columns = columns
        self.alias = alias
        self.index_column = index_column
        self.eq_value = eq_value
        self.residual = residual
        self.names = list(columns)
        self.types = [provider.type_of(c) for c in columns]

    def children(self):
        return []

    def label(self):
        return f"BtreeScan {self.provider.name}.{self.index_column} eq"

    def count_matching(self):
        if self.residual is not None:
            return None
        from ..search.index import find_btree_index
        idx = find_btree_index(self.provider, self.index_column)
        if idx is None:
            return None
        return len(idx.lookup_eq(self.eq_value))

    def batches(self, ctx):
        from .plan import check_cancel
        check_cancel()
        from ..search.index import find_btree_index
        idx = find_btree_index(self.provider, self.index_column)
        if idx is None:
            raise RuntimeError("btree index disappeared under the plan")
        rows = idx.lookup_eq(self.eq_value)
        out = self.provider.full_batch(self.columns).take(rows)
        if self.residual is not None:
            c = self.residual.eval(out)
            out = out.filter(c.data.astype(bool) & c.valid_mask())
        yield out


class PkScanNode(PlanNode):
    """Primary-key scan through the sorted memcomparable key index
    (reference: PK point lookups + PK RANGE scans enabled by
    key_encoding.cpp order-preserving terms). Two modes:

    - "point": equality on EVERY PK column → at most one row
    - "range": bounds on the LEADING PK column → contiguous key slice
    """

    def __init__(self, provider: TableProvider, columns: list[str],
                 alias: str, mode: str, lo, hi, residual):
        self.provider = provider
        self.columns = columns
        self.alias = alias
        self.mode = mode
        self.lo = lo            # encoded key bytes (point: exact key)
        self.hi = hi            # range: exclusive upper bound or None
        self.residual = residual
        self.names = list(columns)
        self.types = [provider.type_of(c) for c in columns]

    def children(self):
        return []

    def label(self):
        return f"PkScan {self.provider.name} {self.mode}"

    def count_matching(self):
        if self.residual is not None:
            return None
        rows = self._rows()
        return None if rows is None else len(rows)

    def _rows(self):
        from ..search.pkindex import pk_index
        idx = pk_index(self.provider)
        if idx is None:
            return None
        if self.mode == "point":
            r = idx.get(self.lo)
            return np.asarray([r] if r >= 0 else [], dtype=np.int64)
        return idx.range_rows(self.lo, self.hi)

    def batches(self, ctx):
        from .plan import check_cancel
        check_cancel()
        rows = self._rows()
        if rows is None:
            raise RuntimeError("PK index disappeared under the plan")
        out = self.provider.full_batch(self.columns).take(rows)
        if self.residual is not None:
            c = self.residual.eval(out)
            out = out.filter(c.data.astype(bool) & c.valid_mask())
        yield out


class GeoScanNode(PlanNode):
    """Geo-predicate scan through the cell-term index: candidate rows
    from the posting lists of the query's probe terms, exact-verified by
    re-evaluating the ORIGINAL predicates over just the candidates
    (reference: GeoFilter candidate iteration + exact S2 verification,
    geo_filter_builder.cpp). Rows whose geometry text failed to parse at
    index build are not candidates."""

    def __init__(self, provider: TableProvider, columns: list[str],
                 alias: str, index_column: str, probe_terms: list,
                 residual):
        self.provider = provider
        self.columns = columns
        self.alias = alias
        self.index_column = index_column
        self.probe_terms = list(probe_terms)
        self.residual = residual
        self.names = list(columns)
        self.types = [provider.type_of(c) for c in columns]

    def children(self):
        return []

    def label(self):
        return (f"GeoScan {self.provider.name}.{self.index_column} "
                f"probes={len(self.probe_terms)}")

    def batches(self, ctx):
        from .plan import check_cancel
        check_cancel()
        from ..search.index import find_geo_index
        idx = find_geo_index(self.provider, self.index_column)
        if idx is None:
            raise RuntimeError("geo index disappeared under the plan")
        rows = idx.candidates(self.probe_terms)
        out = self.provider.full_batch(self.columns).take(rows)
        if self.residual is not None:
            c = self.residual.eval(out)
            out = out.filter(c.data.astype(bool) & c.valid_mask())
        yield out
