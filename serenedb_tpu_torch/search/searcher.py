"""Index-backed query evaluation: filters on CPU set algebra, scoring on
the card.

Port of serenedb_tpu/search/searcher.py. Term dictionary lookups and
boolean doc-set algebra stay on the host (memoized in the fragment cache,
cache/fragments.py); BM25 scoring + top-k run as the hand kernels of
ops/bm25_kernels.py on the searcher's device (`cuda:0` unless the caller
passes `device="cpu"`). `MultiSearcher` (segments under global
collection statistics, merged by one host heap), `SearchIndex` and the
segment-shard driver are copies.

Scoring semantics: a document's score is the sum of BM25 contributions of
every positive leaf term of the query (phrase members and prefix expansions
included); NOT-subtrees and phrase adjacency affect *matching* only.

`topk_batch(ragged=True)` (the batched-serving path, search/batcher.py)
takes `_ragged_resolve` on any device, under the reference's other
conditions (a bm25/tfidf scorer, avgdl > 0, the entry cap, not the dense
regime): the reference takes it only on its host backend
(`_host_backend`), yet its paged-search bench expects the posting pool to
serve on a device, and the pool is that path's device tier. Results are
bit for bit those of the plane kernel, by the reference's contract
(`contrib()` in csrc/contrib.cuh is the one expression of all three).

With `serene_shards > 1` and `serene_shard_combine = device`, the
cross-shard merge of a multi-segment searcher is one `merge_topk` launch
(ops/merge_kernels.py) on the searcher's device, after the card's top-k
or the host WAND alike; on a mesh wider than one device each mesh
device merges its shards' stack, and the first merges their results.

`topk_batch(mesh_n=M)` takes the mesh branch where the reference does: M
> 1, at least M mesh devices (parallel/mesh.py) and require-free queries.
The posting-row sections shard over the mesh, `bm25_accumulate` runs once
a shard into its own plane, and the planes sum in shard order
(`mesh_combine`) before one `topk_rows`. With fewer devices the
single-device kernels run, as the reference's do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, device_scope, resolve_device
from ..ops import bm25 as bm25_ops
from . import posting_pool
from .analysis import Analyzer
from .automaton import intersect_sorted, levenshtein_nfa
from .query import (QAnd, QFuzzy, QNode, QNot, QNothing, QOr, QPhrase,
                    QPrefix, QRegex, QTerm)
from .segment import FieldIndex

K1 = 1.2
B = 0.75  # reference defaults: libs/iresearch/search/bm25.hpp


class _RaggedSlice(NamedTuple):
    """One (plane, term) slice of an admitted ragged query, in the
    plane kernel's flatten order: the KEPT postings (docs/tfs), the
    term weight, and enough provenance — term id, full posting range,
    within-term kept positions — for the posting pool to key pages and
    build page-table gather slots. `idx` is None when every posting of
    the term survives (light tails, unpruned heavy planes)."""

    docs: np.ndarray
    tfs: np.ndarray
    w: float
    tid: int
    s: int
    e: int
    idx: Optional[np.ndarray]


def _maxscore_split(plan) -> set:
    """Non-essential terms of a WandPlan: the ascending-maxscore prefix
    whose cumulative sum stays below θ — docs containing only those terms
    can never reach the top-k. Shared by the device candidate generation
    and the CPU WAND baseline so the split rule cannot diverge."""
    cum = 0.0
    non_ess = set()
    for tid, ms in sorted(plan.maxscore.items(), key=lambda t: t[1]):
        if cum + ms < plan.theta:
            cum += ms
            non_ess.add(tid)
        else:
            break
    return non_ess



class SegmentSearcher:
    def __init__(self, index: FieldIndex, analyzer: Analyzer, num_docs: int,
                 device: DeviceLike = None):
        self.index = index
        self.analyzer = analyzer
        self.num_docs = num_docs
        self.device = resolve_device(device)
        self._dev = None

    # -- device posting store (lazy, cached) ------------------------------

    def _device_store(self) -> bm25_ops.BlockStore:
        if self._dev is None:
            self._dev = bm25_ops.build_block_store(
                self.index.offsets, self.index.post_docs,
                self.index.post_tfs, self.index.doc_freq,
                self.index.norms, self.num_docs, device=self.device)
        return self._dev


    def _dense_store(self, scorer: str,
                     avgdl: float) -> bm25_ops.DenseStore:
        """Dense saturation matrix for the small-corpus matmul path,
        cached per (scorer shape, avgdl) — segments are immutable, and
        avgdl only drifts when collection stats change."""
        cache = getattr(self, "_dense_cache", None)
        if cache is None:
            cache = self._dense_cache = {}
        # tfidf's S (sqrt tf) is avgdl-independent — don't rebuild it when
        # collection stats drift
        key = ("tfidf",) if scorer == "tfidf" \
            else ("bm25", round(avgdl, 6))
        hit = cache.get(key)
        if hit is None:
            if len(cache) >= 2:   # S is the dominant HBM tenant — keep ≤2
                cache.clear()
            hit = cache[key] = bm25_ops.build_dense_store(
                self._device_store(), self.index.doc_freq, avgdl, K1, B,
                scorer)
        return hit

    # -- filter evaluation (CPU doc-set algebra) --------------------------

    def eval_filter(self, node: QNode) -> np.ndarray:
        """Sorted doc ids matching the query node. Memoized in the
        process-wide fragment cache (cache/fragments.py): segments are
        immutable, so a filter doc set is valid for this object's whole
        lifetime — the ES shard-request-cache analog. Recursive
        sub-nodes memoize individually, so `a AND b` reuses a cached
        `a`. Unknown node shapes and `serene_result_cache = off`
        sessions compute straight through."""
        from ..cache.fragments import FRAGMENTS, qnode_sig
        sig = qnode_sig(node)
        return FRAGMENTS.cached(
            self, None if sig is None else ("filter", sig),
            lambda: self._eval_filter_uncached(node))

    def _eval_filter_uncached(self, node: QNode) -> np.ndarray:
        if isinstance(node, QTerm):
            tid = self.index.term_id(node.term)
            if tid < 0:
                return np.empty(0, dtype=np.int32)
            return self.index.postings(tid)[0]
        if isinstance(node, QPrefix):
            return self._union_postings(self.index.prefix_term_ids(
                node.prefix))
        if isinstance(node, QFuzzy):
            return self._union_postings(self._fuzzy_term_ids(node))
        if isinstance(node, QRegex):
            return self._union_postings(self._regex_term_ids(node))
        if isinstance(node, QPhrase):
            return self._eval_phrase(node.groups, node.slop)
        if isinstance(node, QNothing):
            return np.empty(0, dtype=np.int32)
        if isinstance(node, QAnd):
            if not node.args:
                return np.empty(0, dtype=np.int32)
            pos = [a for a in node.args if not isinstance(a, QNot)]
            neg = [a for a in node.args if isinstance(a, QNot)]
            if pos:
                acc = self.eval_filter(pos[0])
                for a in pos[1:]:
                    acc = np.intersect1d(acc, self.eval_filter(a),
                                         assume_unique=True)
            else:
                acc = np.arange(self.num_docs, dtype=np.int32)
            for a in neg:
                acc = np.setdiff1d(acc, self.eval_filter(a.arg),
                                   assume_unique=True)
            return acc
        if isinstance(node, QOr):
            parts = [self.eval_filter(a) for a in node.args]
            return np.unique(np.concatenate(parts)) if parts \
                else np.empty(0, dtype=np.int32)
        if isinstance(node, QNot):
            inner = self.eval_filter(node.arg)
            return np.setdiff1d(np.arange(self.num_docs, dtype=np.int32),
                                inner, assume_unique=True)
        return np.empty(0, dtype=np.int32)

    def _union_postings(self, tids) -> np.ndarray:
        """Sorted unique doc ids across the postings of several terms
        (multi-term leaves: prefix / fuzzy / regex expansions)."""
        parts = [self.index.postings(t)[0] for t in tids]
        return np.unique(np.concatenate(parts)) if parts \
            else np.empty(0, dtype=np.int32)

    def _eval_phrase(self, groups: list[list[str]],
                     slop: int = 0) -> np.ndarray:
        """Phrase over per-position alternative groups: each slot is the
        union of its alternatives' postings (synonym expansions), slots
        must land on consecutive doc positions — or, with slop > 0, in
        order with total extra gap <= slop (Lucene `"..."~N`, minus its
        bounded-reorder allowance; same contract as query._sloppy_match)."""
        if not groups:
            return np.empty(0, dtype=np.int32)
        gtids = [[t for t in (self.index.term_id(a) for a in g) if t >= 0]
                 for g in groups]
        if any(not g for g in gtids):
            return np.empty(0, dtype=np.int32)
        cand = self._union_postings(gtids[0])
        for g in gtids[1:]:
            cand = np.intersect1d(cand, self._union_postings(g),
                                  assume_unique=True)
        if len(groups) == 1 or len(cand) == 0:
            return cand
        # doc → union of positions across the group's alternatives
        pos_maps = []
        for g in gtids:
            merged: dict[int, set] = {}
            for t in g:
                for d, ps in self.index.positions_of(t, cand).items():
                    merged.setdefault(int(d), set()).update(
                        int(p) for p in ps)
            pos_maps.append(merged)
        from .query import _sloppy_match
        out = []
        for d in cand:
            d = int(d)
            first = pos_maps[0].get(d)
            if first is None:
                continue
            rest = [pm.get(d) for pm in pos_maps[1:]]
            if any(r is None for r in rest):
                continue
            if slop > 0:
                hit = _sloppy_match(first, rest, slop)
            else:
                hit = any(all((p + k1) in rs
                              for k1, rs in enumerate(rest, 1))
                          for p in first)
            if hit:
                out.append(d)
        return np.asarray(out, dtype=np.int32)

    def _fuzzy_term_ids(self, node: QFuzzy) -> list[int]:
        """Edit-distance expansion over the term dictionary (reference:
        levenshtein parametric automata over the burst trie; here a
        length-banded numpy prefilter + banded edit distance). Uncapped —
        indexed results must equal brute-force evaluation. Memoized per
        (term, edits) while the segment is alive (segments are
        immutable)."""
        cache = getattr(self, "_fuzzy_cache", None)
        if cache is None:
            cache = self._fuzzy_cache = {}
        key = (node.term, node.max_edits)
        hit = cache.get(key)
        if hit is not None:
            return hit
        start, end = levenshtein_nfa(node.term, node.max_edits)
        out = intersect_sorted(start, end, self.index.terms_str)
        cache[key] = out
        return out

    def _regex_term_ids(self, node: QRegex) -> list[int]:
        """Full-term regex expansion over the term dictionary (reference:
        by_regexp runs an automaton over the burst trie; here a linear scan
        of the sorted dictionary — segments are immutable, so memoized)."""
        cache = getattr(self, "_regex_cache", None)
        if cache is None:
            cache = self._regex_cache = {}
        hit = cache.get(node.pattern)
        if hit is not None:
            return hit
        rx = node.compiled
        out = intersect_sorted(rx.start, rx.end, self.index.terms_str)
        cache[node.pattern] = out
        return out

    # -- scoring (device) --------------------------------------------------

    def scoring_terms(self, node: QNode) -> list[int]:
        """Positive leaf term ids contributing to the score."""
        out: list[int] = []

        def rec(nd):
            if isinstance(nd, QTerm):
                t = self.index.term_id(nd.term)
                if t >= 0:
                    out.append(t)
            elif isinstance(nd, QPhrase):
                for term in nd.terms:
                    t = self.index.term_id(term)
                    if t >= 0:
                        out.append(t)
            elif isinstance(nd, QPrefix):
                out.extend(int(t) for t in
                           self.index.prefix_term_ids(nd.prefix))
            elif isinstance(nd, QFuzzy):
                out.extend(self._fuzzy_term_ids(nd))
            elif isinstance(nd, QRegex):
                out.extend(self._regex_term_ids(nd))
            elif isinstance(nd, (QAnd, QOr)):
                for a in nd.args:
                    rec(a)
            # QNot: no score contribution
        rec(node)
        seen = set()
        uniq = []
        for t in out:
            if t not in seen:
                seen.add(t)
                uniq.append(t)
        return uniq

    def _query_shape(self, node: QNode) -> tuple[list[int], int, bool, bool]:
        """(scoring term ids, require_all, needs_exact_mask, always_empty).

        always_empty: a pure conjunction containing a term absent from the
        index can never match (scoring_terms silently drops absent terms, so
        require_all alone would degrade the AND)."""
        tids = self.scoring_terms(node)
        require_all = 0
        needs_mask = False
        empty = False
        if isinstance(node, (QTerm, QPrefix, QFuzzy, QRegex)):
            pass
        elif isinstance(node, QOr) and all(
                isinstance(a, QTerm) for a in node.args):
            pass
        elif isinstance(node, QAnd) and all(
                isinstance(a, QTerm) for a in node.args):
            require_all = len(tids)
            if any(self.index.term_id(a.term) < 0 for a in node.args):
                empty = True
        else:
            needs_mask = True
        return tids, require_all, needs_mask, empty

    def _wand_plan_cached(self, store, tids, k: int, avgdl: float,
                          scorer: str, idf_of):
        """wand_plan with a per-store memo — segments are immutable, and
        batched QPS workloads repeat query shapes."""
        tid_arr = np.asarray(tids, dtype=np.int64)
        if idf_of is not None:
            idf = np.asarray(idf_of(tid_arr), dtype=np.float32)
        else:
            idf = bm25_ops.idf_for(scorer, self.num_docs,
                                   self.index.doc_freq[tid_arr])
        cache = getattr(store, "_plan_cache", None)
        if cache is None:
            cache = store._plan_cache = {}
        if len(cache) > 8192:  # stale stats (avgdl/idf drift) accumulate keys
            cache.clear()
        key = (tuple(int(t) for t in tids), k, round(avgdl, 6), scorer,
               idf.tobytes())
        if key in cache:
            return cache[key]
        plan = bm25_ops.wand_plan(store, tids, idf, k, avgdl, K1, B, scorer)
        cache[key] = plan
        return plan

    # candidate cap for the sparse MaxScore path: above this, the dense
    # device kernel amortizes better than host gather-scoring
    MAXSCORE_CAND_CAP = 4096

    def _maxscore_candidates(self, plan, tids, k: int) -> Optional[np.ndarray]:
        """MaxScore essential-list split: if the non-essential terms' max
        scores sum below θ, docs containing ONLY non-essential terms can
        never reach the top-k, so the candidate set is the union of the
        essential terms' postings. Returns sorted candidate doc ids when
        the sparse path applies (small enough and ≥ k docs), else None.

        Reference analog: the max-score optimization of
        block_disjunction.hpp / max_score_iterator."""
        non_ess = _maxscore_split(plan)
        if not non_ess:
            return None
        ess = [t for t in tids if int(t) not in non_ess]
        if not ess:
            return None
        fi = self.index
        total = sum(int(fi.doc_freq[int(t)]) for t in ess)
        if total > self.MAXSCORE_CAND_CAP:
            return None
        parts = [fi.postings(int(t))[0] for t in ess]
        cand = np.unique(np.concatenate(parts)) if parts else None
        if cand is None or len(cand) < k:
            return None  # too few candidates to fill k exact slots
        return cand.astype(np.int32)

    def topk(self, node: QNode, k: int, scorer: str = "bm25",
             mesh_n: int = 0) -> tuple[np.ndarray, np.ndarray]:
        return self.topk_batch([node], k, scorer, mesh_n=mesh_n)[0]

    # cap on per-dispatch accumulator entries (B × ndocs_pad f32): bounds
    # HBM at large corpora — the batch splits into query chunks instead of
    # materializing (256, 8.8M) at MS-MARCO scale
    ACC_ENTRY_CAP = 128 * 1024 * 1024

    #: `ragged_admits`' cost model, from each query timed alone and in
    #: batches of 8 and 64 on both routes on an NVIDIA H100 80GB HBM3 at
    #: 700 W (chip_smoke.py phases 4 and 15: bm25_8m, paged_search):
    #: - the posting pool's route (one pool_score launch) beat the score
    #:   planes at every size measured, to 2,240,896 kept postings (0.74
    #:   against 1.24 ms alone; 3.2 against 5.1 ms for 64 queries): it
    #:   takes a query up to RAGGED_ENTRY_CAP, that largest size timed;
    #: - the host ragged route (contrib_flat, numpy accumulate) costs
    #:   about HOST_BASE_MS + HOST_MS_PER_ENTRY a kept posting a call, the
    #:   planes about PLANE_BASE_MS + PLANE_MS_PER_QUERY a query of the
    #:   batch: a query takes the host route while its postings cost less
    #:   than its share of the planes (alone: to ~11,600 postings; in 64:
    #:   to ~1,800). The host constants were kept when that route's call
    #:   became one packed upload and one readback: ten least-squares fits
    #:   over phase 15's 73 groups (scripts/pool_shapes.py) gave a base of
    #:   0.222-0.515 ms (median 0.385) and 2.7e-5-4.9e-5 ms a posting,
    #:   against 0.349-0.665 (0.469) and 2.9e-5-6.2e-5 before; the change
    #:   is smaller than either's spread between runs.
    RAGGED_ENTRY_CAP = 2_240_896
    HOST_BASE_MS, HOST_MS_PER_ENTRY = 0.45, 4e-5
    PLANE_BASE_MS, PLANE_MS_PER_QUERY = 0.85, 0.066

    def ragged_admits(self, entries: int, batch: int) -> bool:
        """Whether a query of `entries` kept postings, in a batch of
        `batch` queries, takes `_ragged_resolve` rather than the planes."""
        if entries > self.RAGGED_ENTRY_CAP:
            return False
        if posting_pool.enabled():
            return True
        plane_ms = self.PLANE_BASE_MS + self.PLANE_MS_PER_QUERY * batch
        return entries * self.HOST_MS_PER_ENTRY * batch <= \
            plane_ms - self.HOST_BASE_MS

    def topk_batch(self, nodes: list[QNode], k: int, scorer: str = "bm25",
                   idf_of=None, avgdl_override=None, mesh_n: int = 0,
                   ragged: bool = False,
                   ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Top-k (scores, doc ids) for a batch of queries in ONE device
        dispatch (amortizes dispatch latency — the QPS regime). Pure term
        disjunctions/conjunctions run fully on device; other shapes get an
        exact-match CPU mask applied to the device scores.

        ragged=True (the batched-serving path, search/batcher.py) admits
        pure disjunctions to `_ragged_resolve` on any device: WAND-kept
        postings flatten into ragged (contribution, query-offset) arrays,
        score in one `contrib_flat` launch (or, page-resident, in the
        posting pool's `pool_score`), and top-k on the candidate sets —
        bit-identical to the score-plane kernel by the contrib()
        contract. Never taken when this store would use the dense matmul
        path, so ragged on/off can't change a single result bit there
        either. mesh_n > 1 asks for the mesh-sharded branch, which needs
        that many devices: on the port's one card the single-device
        kernels run, as the reference's do with fewer devices."""
        if self.num_docs == 0:
            return [(np.empty(0, dtype=np.float32),
                     np.empty(0, dtype=np.int32))] * len(nodes)
        if scorer in bm25_ops.LM_SCORERS and idf_of is None:
            # LM-family weights are collection probabilities, not idf
            ctf, total = self.index.ctf, float(self.index.total_tokens)

            def idf_of(tids, _ctf=ctf, _tot=total):
                return bm25_ops.term_weight_for(
                    scorer, self.num_docs, None, _ctf[tids], _tot)
        store = self._device_store()
        max_b = max(1, self.ACC_ENTRY_CAP // store.ndocs_pad)
        if len(nodes) > max_b:
            out = []
            for i in range(0, len(nodes), max_b):
                out.extend(self.topk_batch(nodes[i:i + max_b], k, scorer,
                                           idf_of, avgdl_override, mesh_n,
                                           ragged))
            return out
        nd_pad = store.ndocs_pad
        shapes = [self._query_shape(n) for n in nodes]
        queries = [(np.asarray(tids, dtype=np.int64) if not empty
                    else np.empty(0, dtype=np.int64), req)
                   for tids, req, _, empty in shapes]
        # pad the query axis to a power of two with no-op empties, as the
        # reference does (its kernels are compiled per n_queries). Empty
        # pads scatter nothing and their accumulator rows are never read
        # back, so real queries' bits are untouched.
        for _ in range(bm25_ops._pow2(len(queries), 1) - len(queries)):
            queries.append((np.empty(0, dtype=np.int64), 0))
        # block-max WAND applies to pure disjunctions whose device top-k is
        # final (no exact-match mask re-ranking a subset afterwards); the
        # LM scorers don't decompose as w·sat, so their bounds don't hold
        prunable = [req == 0 and not needs_mask and not empty and
                    scorer not in bm25_ops.LM_SCORERS
                    for _, req, needs_mask, empty in shapes]
        avgdl = (avgdl_override if avgdl_override is not None
                 else self.index.avgdl)
        k_true = min(max(k, 1), max(self.num_docs, 1))
        from ..parallel import mesh as mesh_mod
        if mesh_n > 1 and mesh_mod.device_count(store.norms.device) >= \
                mesh_n and not any(req for _, req in queries):
            # mesh-sharded scoring: the posting-row sections shard across
            # the mesh devices, the score planes sum on the first
            # (require-free shapes only; _finish_batch applies
            # exact-match masks as usual)
            qb = bm25_ops.assemble_query_batch(
                store, self.num_docs, queries, self.index.doc_freq,
                scorer, idf_of=idf_of)
            kk = min(bm25_ops.pad_k(k_true), nd_pad)
            if any(len(q[0]) > 0 for q in queries):
                vals, docs = bm25_ops.score_topk_mesh(
                    store, qb, nd_pad, kk, mesh_n,
                    bm25_ops.scorer_param(scorer, K1), B, avgdl, scorer)
                vals, docs = vals.cpu().numpy(), docs.cpu().numpy()
            else:
                vals = np.zeros((qb.n_queries, kk), dtype=np.float32)
                docs = np.zeros((qb.n_queries, kk), dtype=np.int32)
            return self._finish_batch(nodes, shapes, vals, docs, {}, k,
                                      scorer, idf_of, avgdl_override,
                                      nd_pad)
        plans: list = [None] * len(queries)
        host_results: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        use_dense = (scorer not in bm25_ops.LM_SCORERS and
                     (scorer == "tfidf" or avgdl > 0.0) and
                     bm25_ops.dense_fits(store.ndocs_pad,
                                         len(self.index.doc_freq)))
        if use_dense:
            # small-corpus matmul path: one dispatch, no host WAND
            # planning needed (the dense kernel is not scatter-bound)
            ds = self._dense_store(scorer, avgdl)
            W, require_arr, _ = bm25_ops.assemble_dense_weights(
                ds.v_pad, queries, self.num_docs, self.index.doc_freq,
                scorer, idf_of)
            kk = min(bm25_ops.pad_k(k_true), store.ndocs_pad)
            vals, docs = bm25_ops.dense_topk(
                ds.S, self._upload(W), self._upload(require_arr), kk,
                bool(require_arr.any()))
            vals, docs = vals.cpu().numpy(), docs.cpu().numpy()
            return self._finish_batch(nodes, shapes, vals, docs,
                                      host_results, k, scorer, idf_of,
                                      avgdl_override, store.ndocs_pad)
        if store.norms_host is not None and \
                (scorer == "tfidf" or avgdl > 0.0):
            for qi, (tids, req, needs_mask, empty) in enumerate(shapes):
                if not (prunable[qi] and tids):
                    continue
                plan = self._wand_plan_cached(store, tids, k_true, avgdl,
                                              scorer, idf_of)
                if plan is None:
                    continue
                plans[qi] = plan
                cand = self._maxscore_candidates(plan, tids, k_true)
                if cand is not None:
                    host_results[qi] = self._cpu_score(
                        cand, tids, k, scorer, idf_of, avgdl_override)
                    queries[qi] = (np.empty(0, dtype=np.int64), 0)
        # the reference's host-backend rule, on any device: its
        # paged-search bench expects the pool to serve on a device
        if ragged and (scorer == "tfidf" or avgdl > 0.0) and \
                store.norms_host is not None:
            todo = [qi for qi in range(len(shapes))
                    if prunable[qi] and shapes[qi][0] and
                    qi not in host_results]
            if todo:
                for qi, res in self._ragged_resolve(
                        store, todo, shapes, plans, k, scorer, idf_of,
                        avgdl).items():
                    host_results[qi] = res
                    queries[qi] = (np.empty(0, dtype=np.int64), 0)
        qb = bm25_ops.assemble_query_batch(store, self.num_docs, queries,
                                           self.index.doc_freq, scorer,
                                           idf_of=idf_of, plans=plans)
        kk = bm25_ops.pad_k(k_true)
        kk = min(kk, nd_pad)
        nq = qb.n_queries
        if any(len(q[0]) > 0 for q in queries):
            ints, floats, nb, nr, tt, nq = bm25_ops.pack_query_batch(qb)
            vals, docs = bm25_ops.score_topk_packed(
                store.block_base, store.block_gaps, store.block_tfs8,
                store.raw_docs, store.raw_tfs, store.norms,
                self._upload(ints), self._upload(floats), nb, nr, tt,
                nd_pad, kk, nq, bool(qb.require.any()),
                bm25_ops.scorer_param(scorer, K1), B, avgdl, scorer)
            vals, docs = vals.cpu().numpy(), docs.cpu().numpy()
        else:  # every query resolved host-side — skip the dispatch entirely
            vals = np.zeros((nq, kk), dtype=np.float32)
            docs = np.zeros((nq, kk), dtype=np.int32)
        return self._finish_batch(nodes, shapes, vals, docs, host_results,
                                  k, scorer, idf_of, avgdl_override, nd_pad)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    #: byte budget for the ragged memo caches hung off plans and stores
    #: (_ragged_slices masked copies, _ragged_accum candidate tables,
    #: the posting pool's batch descriptor memo): past this EVERY memo
    #: clears — the bounded-cache discipline applied to programs,
    #: here for the one-entry-per-novel-query-shape growth class
    RAGGED_MEMO_BYTES_CAP = 64 << 20

    @staticmethod
    def _ragged_memo_charge(store, nbytes: int) -> None:
        """Account freshly-memoized ragged bytes against the store's
        running total; crossing the cap clears every ragged memo (they
        are pure recomputable functions of plan + store, so clearing is
        always safe — the next query repays the arithmetic once)."""
        total = getattr(store, "_ragged_memo_bytes", 0) + int(nbytes)
        if total > SegmentSearcher.RAGGED_MEMO_BYTES_CAP:
            for plan in getattr(store, "_plan_cache", {}).values():
                if plan is None:
                    continue
                for attr in ("_ragged_slices", "_ragged_accum"):
                    if hasattr(plan, attr):
                        delattr(plan, attr)
            cache = getattr(store, "_ragged_plain", None)
            if cache:
                cache.clear()
            memo = getattr(store, "_pool_batch_memo", None)
            if memo:
                memo.clear()
            total = int(nbytes)
        store._ragged_memo_bytes = total

    def _ragged_candidates(self, store, plan, slices):
        """Sorted candidate-doc union + per-slice scatter indices for
        one admitted query — a pure function of the plan's kept
        postings, memoized on the plan so repeat queries pay only the
        f32 adds + top-k. Shared VERBATIM by the host accumulate and
        the posting pool's device descriptors, so their per-doc scatter
        targets cannot diverge."""
        pre = getattr(plan, "_ragged_accum", None) \
            if plan is not None else None
        if pre is not None:
            return pre
        cand = np.unique(np.concatenate([sl.docs for sl in slices]))
        ixs = [np.searchsorted(cand, sl.docs).astype(np.int32)
               for sl in slices]
        if plan is not None:
            plan._ragged_accum = (cand, ixs)
            self._ragged_memo_charge(
                store, cand.nbytes + sum(ix.nbytes for ix in ixs))
        return cand, ixs

    def _ragged_resolve(self, store, qis, shapes, plans, k: int,
                        scorer: str, idf_of, avgdl,
                        ) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """Batched ragged top-k for pure-disjunction queries.

        Every admitted query's postings — WAND-kept block rows of heavy
        terms plus light-term tails, exactly the entries the plane kernel
        would scatter — flatten into one (contribution, query-offset)
        ragged array set. ONE elementwise `contrib_flat` dispatch scores
        all postings of all queries; accumulation then runs per query as
        ordered slice adds over its sorted candidate set (each term
        touches a doc at most once, so `acc[ix] += c` per slice replays
        the scatter's per-doc f32 addition order bit-for-bit), and
        `topk_tie_exact` makes the same (score desc, doc asc) selection
        as lax.top_k. Queries `ragged_admits` declines stay on the device
        dispatch.

        Device tier (serene_posting_pool, search/posting_pool.py):
        queries whose terms are page-resident in the pool's HBM region
        never flatten on the host at all — one `pool_score` launch
        (gather, contrib, accumulate, top-k) over page tables scores them with the SAME
        contrib expression tree and candidate tables, so the host path
        here remains the bit-identical parity oracle. Partial residency
        scores the resident slice PREFIX on device and adds the suffix
        slices below in the same order — an identical f32 addition
        sequence."""
        fi = self.index
        per_q: list[tuple[int, object, list]] = []
        for qi in qis:
            tids = shapes[qi][0]
            plan = plans[qi]
            tid_arr = np.asarray(tids, dtype=np.int64)
            if idf_of is not None:
                idf = np.asarray(idf_of(tid_arr), dtype=np.float32)
            else:
                idf = bm25_ops.idf_for(scorer, self.num_docs,
                                       fi.doc_freq[tid_arr])
            slices: list[_RaggedSlice] = []
            entries = 0
            for plane in (0, 1, 2):
                for j, tid in enumerate(tids):
                    tid = int(tid)
                    s, e = int(store.offsets[tid]), int(store.offsets[tid + 1])
                    if e <= s:
                        continue
                    heavy = bool(store.heavy[tid])
                    if heavy == (plane == 2):
                        continue   # heavy → tile planes, light → tails
                    w = float(idf[j])
                    if not heavy:
                        d, t, idx = (store.flat_docs[s:e],
                                     store.flat_tfs[s:e], None)
                    else:
                        d, t, idx = self._ragged_tile_slice(store, plan,
                                                            tid, plane, s, e)
                        if d is None:
                            continue
                    slices.append(_RaggedSlice(d, t, w, tid, s, e, idx))
                    entries += len(d)
            if not self.ragged_admits(entries, len(shapes)):
                continue   # the planes cost less for this query
            per_q.append((qi, plan, slices))
        if not per_q:
            return {}
        out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        pool_hits: dict = {}
        if posting_pool.enabled():
            pool_hits = posting_pool.POOL.score_queries(
                self, store, per_q, k, scorer, avgdl, K1, B,
                self._ragged_candidates)
        flat_d, flat_t, flat_w = [], [], []
        work = []   # (qi, spans, slice scatter ixs, device acc0, cand)
        pos = 0
        for qi, plan, slices in per_q:
            hit = pool_hits.get(qi)
            if hit is not None and hit[0] == "full":
                out[qi] = (hit[1], hit[2])
                continue
            if not slices:
                out[qi] = (np.empty(0, dtype=np.float32),
                           np.empty(0, dtype=np.int32))
                continue
            cand, ixs = self._ragged_candidates(store, plan, slices)
            if hit is not None:
                # partial residency: the device already accumulated the
                # resident slice prefix — continue from its accumulator
                acc0, n0 = hit[1], hit[2]
                use, use_ix = slices[n0:], ixs[n0:]
            else:
                acc0, use, use_ix = None, slices, ixs
            spans = []
            for sl in use:
                flat_d.append(sl.docs)
                flat_t.append(sl.tfs)
                flat_w.append(np.full(len(sl.docs), sl.w,
                                      dtype=np.float32))
                spans.append((pos, pos + len(sl.docs)))
                pos += len(sl.docs)
            work.append((qi, spans, use_ix, acc0, cand))
        if not work:
            return out
        if flat_d:
            # doc ids go up; the kernel gathers each dl from the resident
            # norms (the same int32 values as norms_host)
            contribs = bm25_ops.ragged_contribs(
                np.concatenate(flat_t), np.concatenate(flat_d),
                np.concatenate(flat_w), K1, B, avgdl, scorer,
                norms=store.norms)
        else:
            contribs = np.empty(0, dtype=np.float32)
        for qi, spans, use_ix, acc0, cand in work:
            acc = acc0 if acc0 is not None \
                else np.zeros(len(cand), dtype=np.float32)
            for ix, (a, b) in zip(use_ix, spans):
                acc[ix] += contribs[a:b]
            out[qi] = bm25_ops.topk_tie_exact(acc, cand, k)
        return out

    @staticmethod
    def _ragged_tile_slice(store, plan, tid: int, plane: int, s: int,
                           e: int):
        """(docs, tfs, kept_positions) of one heavy term's postings
        surviving the plan's kept-row pruning on one tile plane, or
        (None, None, None). kept_positions is None when every posting
        survives (the slice IS the full term range), else the
        within-term indices of the survivors — the posting pool expands
        them into page-table gather slots. Memoized on the plan (plans
        are memoized per query shape, so repeat queries skip the mask
        arithmetic) or, plan-free, on the store; masked copies charge
        RAGGED_MEMO_BYTES_CAP. Cached arrays are read-only by
        convention — accumulation never writes through them."""
        cache = None
        if plan is not None:
            cache = getattr(plan, "_ragged_slices", None)
            if cache is None:
                cache = plan._ragged_slices = {}
        else:
            cache = getattr(store, "_ragged_plain", None)
            if cache is None:
                cache = store._ragged_plain = {}
            if len(cache) > 4096:   # vocab-sized growth bound
                cache.clear()
        hit = cache.get((plane, tid))
        if hit is not None:
            return hit
        b0 = int(store.block_offsets[tid])
        rowof = b0 + np.arange(e - s, dtype=np.int64) // bm25_ops.BLOCK
        m = store.row_plane[rowof] == plane
        if plan is not None:
            kept = plan.kept[tid]
            if len(kept) == 0:
                m = np.zeros_like(m)
            else:
                ix = np.searchsorted(kept, rowof)
                np.clip(ix, 0, len(kept) - 1, out=ix)
                m &= kept[ix] == rowof
        if not m.any():
            out = (None, None, None)
        elif m.all():
            out = (store.flat_docs[s:e], store.flat_tfs[s:e], None)
        else:
            idx = np.flatnonzero(m)
            out = (store.flat_docs[s:e][m], store.flat_tfs[s:e][m], idx)
            SegmentSearcher._ragged_memo_charge(
                store, out[0].nbytes + out[1].nbytes + idx.nbytes)
        cache[(plane, tid)] = out
        return out

    def _finish_batch(self, nodes, shapes, vals, docs, host_results, k,
                      scorer, idf_of, avgdl_override, nd_pad,
                      ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Shared device-result postprocessing: host-resolved queries,
        always-empty conjunctions, zero-score matches, exact-match mask
        application (with CPU rescore when a non-match cracked the
        device top-k)."""
        out = []
        for qi, (node, (tids, req, needs_mask, empty)) in enumerate(
                zip(nodes, shapes)):
            if qi in host_results:
                scores, dd = host_results[qi]
                keep = scores > 0.0
                out.append((scores[keep][:k], dd[keep][:k]))
                continue
            scores, dd = vals[qi], docs[qi]
            if empty:
                out.append((np.empty(0, dtype=np.float32),
                            np.empty(0, dtype=np.int32)))
                continue
            if not tids:
                # no scoring terms (e.g. pure negation): matches exist but
                # all score 0 — return the first k matches with zero scores
                match = self.eval_filter(node)[:k]
                out.append((np.zeros(len(match), dtype=np.float32),
                            match.astype(np.int32)))
                continue
            if needs_mask:
                match = self.eval_filter(node)
                mset = np.zeros(nd_pad, dtype=bool)
                mset[match] = True
                ok = mset[dd]
                if (~ok[scores > 0.0]).any() and len(match) > 0:
                    # a non-match made device top-k → the survivors may not
                    # be the true top-k of the match set; exact CPU rescore
                    scores, dd = self._cpu_score(match, tids, k, scorer,
                                                 idf_of, avgdl_override)
                else:
                    scores, dd = scores[ok], dd[ok]
            keep = scores > 0.0
            scores, dd = scores[keep], dd[keep]
            out.append((scores[:k], dd[:k]))
        return out

    def cpu_topk_wand(self, tids: list[int], k: int, scorer: str = "bm25",
                      idf_of=None, avgdl_override=None,
                      require_all: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Host top-k with block-max WAND + MaxScore pruning — the honest
        CPU competitor (reference: search/block_disjunction.hpp +
        max_score_iterator; Lucene/Tantivy-class baselines implement the
        same family). Numpy-vectorized block-at-a-time variant:

        1. champion pass → θ, a lower bound on the k-th score (exact
           scoring of the best upper-bound block rows + light tails);
        2. MaxScore split: terms whose max scores cumulatively stay below
           θ are non-essential — their postings alone can't lift a doc
           into the top-k, so candidates come from essential terms only;
        3. block-max pruning: essential heavy terms drop whole 128-doc
           blocks whose own upper bound plus the OTHER terms' maxscore sum
           cannot reach θ;
        4. exact scoring of the surviving candidates over all terms.

        Exact top-k: every dropped doc is provably below θ ≤ true k-th
        score. Falls back to exhaustive scoring when no safe θ exists.
        Conjunctions (require_all=N) intersect postings first — WAND is a
        disjunction optimization (reference: conjunction.hpp is a
        separate, already-selective iterator)."""
        store = self._device_store()
        fi = self.index
        avgdl = max(avgdl_override if avgdl_override is not None
                    else fi.avgdl, 1e-9)
        if require_all > 0:
            docs = None
            for tid in tids:
                pd = fi.postings(int(tid))[0]
                docs = pd if docs is None else \
                    np.intersect1d(docs, pd, assume_unique=True)
            if docs is None:
                docs = np.empty(0, dtype=np.int32)
            return self._cpu_score(docs, tids, k, scorer, idf_of,
                                   avgdl_override)
        plan = None
        if scorer not in bm25_ops.LM_SCORERS:
            plan = self._wand_plan_cached(store, tids, min(k, max(
                self.num_docs, 1)), avgdl, scorer, idf_of)
        if plan is None:
            # no safe threshold (tiny result set / LM scorer): exhaustive
            docs = self._union_postings([int(t) for t in tids])
            return self._cpu_score(docs, tids, k, scorer, idf_of,
                                   avgdl_override)
        theta = plan.theta
        non_ess = _maxscore_split(plan)
        ess = [int(t) for t in tids if int(t) not in non_ess]
        if not ess:
            ess = [int(t) for t in tids]
        parts = []
        for tid in ess:
            if store.heavy[tid] and tid in plan.kept:
                # block-max pruning: plan.kept already dropped rows that
                # can't reach θ together with the other terms' bounds
                s = int(store.offsets[tid])
                b0 = int(store.block_offsets[tid])
                e = int(store.offsets[tid + 1])
                loc = plan.kept[tid] - b0
                if len(loc) == 0:
                    continue
                spans = [store.flat_docs[s + i * bm25_ops.BLOCK:
                                         min(s + (i + 1) * bm25_ops.BLOCK, e)]
                         for i in loc]
                parts.append(np.concatenate(spans))
            else:
                pd = fi.postings(tid)[0]
                parts.append(pd)
        cand = np.unique(np.concatenate(parts)) if parts \
            else np.empty(0, dtype=np.int32)
        scores, dd = self._cpu_score(cand, tids, k, scorer, idf_of,
                                     avgdl_override)
        keep = scores > 0.0
        return scores[keep][:k], dd[keep][:k]

    def _cpu_score(self, docs: np.ndarray, tids: list[int], k: int,
                   scorer: str = "bm25", idf_of=None,
                   avgdl_override=None) -> tuple[np.ndarray, np.ndarray]:
        scores = np.zeros(len(docs), dtype=np.float64)
        tid_arr = np.asarray(tids, dtype=np.int64)
        if idf_of is not None:
            idf = idf_of(tid_arr)
        elif scorer in bm25_ops.LM_SCORERS:
            idf = bm25_ops.term_weight_for(
                scorer, self.num_docs, None, self.index.ctf[tid_arr],
                float(self.index.total_tokens))
        else:
            idf = bm25_ops.idf_for(scorer, self.num_docs,
                                   self.index.doc_freq[tid_arr])
        dl = self.index.norms[docs].astype(np.float64)
        avgdl = max(avgdl_override if avgdl_override is not None
                    else self.index.avgdl, 1e-9)
        for qi, tid in enumerate(tids):
            pd, pt = self.index.postings(tid)
            ix = np.searchsorted(pd, docs)
            ix = np.clip(ix, 0, max(len(pd) - 1, 0))
            hit = (len(pd) > 0) & (pd[ix] == docs)
            tf = np.where(hit, pt[np.clip(ix, 0, max(len(pd) - 1, 0))],
                          0).astype(np.float64)
            w = float(idf[qi])
            if scorer == "tfidf":
                scores += w * np.sqrt(tf)
            elif scorer == "lm_dirichlet":
                mu = bm25_ops.LM_MU
                c = np.log1p(tf / (mu * w)) + np.log(mu / (dl + mu))
                scores += np.where(
                    tf > 0, np.maximum(c, 0.0) + bm25_ops.MATCH_EPS, 0.0)
            elif scorer == "jelinek_mercer":
                lam = bm25_ops.JM_LAMBDA
                scores += np.log1p(((1 - lam) * tf / np.maximum(dl, 1.0)) /
                                   (lam * w))
            elif scorer == "dfi":
                e = w * dl
                excess = (tf - e) / np.sqrt(np.maximum(e, 1e-9))
                scores += np.where(
                    tf > 0,
                    np.where(tf > e, np.log2(1.0 + excess), 0.0) +
                    bm25_ops.MATCH_EPS, 0.0)
            else:
                denom = tf + K1 * (1 - B + B * dl / avgdl)
                scores += w * (K1 + 1) * tf / np.maximum(denom, 1e-9)
        order = np.argsort(-scores, kind="stable")[:k]
        return (scores[order].astype(np.float32),
                docs[order].astype(np.int32))


def _run_segment_shards(run_segment, segments: list, cap: int) -> list:
    """Drive the per-segment collectors, one result per segment in
    SEGMENT ORDER. With `serene_shards` > 1 the segment set partitions
    round-robin into per-shard groups (exec/shard.py's partitioning
    function) and each shard's group runs as ONE pool task — the
    sharded-tier unit of work — otherwise each segment is its own task.
    Either way the caller's single-heap merge consumes the identical
    per-segment outputs, so results are bit-identical at any shard or
    worker count."""
    from ..exec import shard as shard_mod
    from ..parallel.pool import get_pool
    if cap <= 1 or len(segments) <= 1:
        return [run_segment(sb) for sb in segments]
    n_shards = shard_mod.shard_count(None)
    if n_shards > 1:
        groups = shard_mod.group_round_robin(
            list(enumerate(segments)), n_shards)

        def run_group(entries):
            # the shard task's kernels launch on its segments' device
            with device_scope(entries[0][1][0].device):
                return [(i, run_segment(sb)) for i, sb in entries]

        parts = shard_mod.run_shard_tasks(None, run_group, groups)
        outs: list = [None] * len(segments)
        for chunk in parts:
            for i, out in chunk:
                outs[i] = out
        return outs
    return get_pool().ensure_started().map_ordered(
        run_segment, list(segments), cap)


def merge_segment_topk(seg_outs: list, bases: list[int], n_queries: int,
                       k: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Single-heap merge of per-segment top-k collector outputs.

    seg_outs[si][qi] = (scores, local doc ids) for segment si. Ordering
    is (score desc, global doc id asc) — the doc-id tie-break makes the
    merged ranking a pure function of the data, independent of segment
    count, arrival order, or worker scheduling."""
    import heapq
    results = []
    for qi in range(n_queries):
        entries: list[tuple[float, int]] = []
        for out, base in zip(seg_outs, bases):
            sc, dd = out[qi]
            entries.extend(zip(sc.tolist(),
                               (dd.astype(np.int64) + base).tolist()))
        cand = heapq.nlargest(k, entries, key=lambda t: (t[0], -t[1]))
        results.append((
            np.asarray([c[0] for c in cand], dtype=np.float32),
            np.asarray([c[1] for c in cand], dtype=np.int64)))
    return results


def _combine_topk(seg_outs: list, bases: list[int], n_queries: int,
                  k: int, device: DeviceLike = None,
                  ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Cross-segment top-k combine dispatcher: the host single-heap
    merge (the parity oracle), or — when the sharded tier is active
    with `serene_shard_combine` resolving to device — the device merge:
    the shards' candidate sets (exec/shard.py's round-robin segment
    grouping) meet in one `merge_topk` launch on `device` (the
    searcher's). Selection is a pure (score desc, doc asc) order on the
    candidate union, so both combines pick the identical entries in the
    identical order — bit-identity by construction."""
    from ..exec import shard as shard_mod
    if len(seg_outs) > 1 and k > 0 and n_queries > 0:
        n_shards = shard_mod.shard_count(None)
        if n_shards > 1 and shard_mod.combine_mode(None) == "device":
            out = _device_merge_topk(seg_outs, bases, n_queries, k,
                                     n_shards, device)
            if out is not None:
                return out
    return merge_segment_topk(seg_outs, bases, n_queries, k)


#: padding doc sentinel: sorts after every real doc at equal score and
#: is trimmed host-side; real global doc ids must stay below it
_PAD_DOC = (1 << 31) - 1


def _device_merge_topk(seg_outs: list, bases: list[int], n_queries: int,
                       k: int, n_shards: int, device: DeviceLike = None):
    """The sharded top-k merge — the WHOLE query batch in one
    `merge_topk` launch over the (shard, query, lane) candidates, sized
    exactly (the reference pads L, k and Q to powers of two for XLA's
    compile cache), where the reference's `data_mesh(S)` has width 1;
    at width M > 1 one launch a mesh device over its S/M shards and one
    over the M results on the first. None → the
    caller takes the host heap, under the reference's admission: doc ids
    at or past the int32 padding sentinel, NaN scores, a single shard
    group, no candidates at all. Nothing else takes the heap: a kernel
    that fails to build or launch raises. `device` is the searcher's
    (the executing connection's outside a searcher)."""
    import time

    from ..columnar.device import commit_host_array
    from ..device import current_device
    from ..exec import shard as shard_mod
    from ..obs import device as obs_device
    from ..obs.resources import wait_scope
    from ..obs.trace import current_trace
    from ..ops.merge_kernels import merge_topk
    from ..parallel import mesh as mesh_mod
    from ..utils import metrics

    groups = shard_mod.group_round_robin(
        list(range(len(seg_outs))), n_shards)
    if len(groups) <= 1:
        return None
    # admission: every global doc id must fit below the int32 padding
    # sentinel, and scores must be NaN-free (NaN breaks the sort/heap
    # order equivalence)
    for out, base in zip(seg_outs, bases):
        for sc, dd in out:
            if len(dd) and int(np.asarray(dd).max()) + base >= _PAD_DOC:
                return None
            if len(sc) and np.isnan(np.asarray(sc)).any():
                return None
    S = len(groups)
    # per-(shard, query) candidate lists, one shared width
    cands: list[list[tuple[np.ndarray, np.ndarray]]] = []
    lmax = 0
    for idxs in groups:
        row = []
        for qi in range(n_queries):
            sc = np.concatenate(
                [np.asarray(seg_outs[si][qi][0], dtype=np.float32)
                 for si in idxs])
            dd = np.concatenate(
                [np.asarray(seg_outs[si][qi][1]).astype(np.int64) +
                 bases[si] for si in idxs])
            lmax = max(lmax, len(sc))
            row.append((sc, dd))
        cands.append(row)
    if lmax == 0:
        return [(np.empty(0, dtype=np.float32),
                 np.empty(0, dtype=np.int64))] * n_queries
    scores = np.full((S, n_queries, lmax), -np.inf, dtype=np.float32)
    docs = np.full((S, n_queries, lmax), _PAD_DOC, dtype=np.int32)
    for i, row in enumerate(cands):
        for qi, (sc, dd) in enumerate(row):
            scores[i, qi, :len(sc)] = sc
            docs[i, qi, :len(dd)] = dd.astype(np.int32)
    dev = resolve_device(device) if device is not None else current_device()
    mesh = mesh_mod.data_mesh(S, base=dev)
    M = mesh.size
    t_d = time.perf_counter_ns()
    metrics.DEVICE_OFFLOADS.add()
    metrics.COLLECTIVE_DISPATCHES.add()
    with wait_scope("Device", "CollectiveCombine"):
        # the candidate planes bypass DEVICE_CACHE (per-dispatch data):
        # commit_host_array keeps their transfer bytes in the ledger
        if M == 1:
            vals, out_docs = merge_topk(commit_host_array(scores, dev),
                                        commit_host_array(docs, dev), k)
        else:
            # each mesh device merges its shards' (S/M, Q, L) stack (pad
            # shards are all (-inf, PAD_DOC)), the first merges the M
            # results: the reference's per-shard top-k, all_gather and
            # final selection
            spd = -(-S // M)
            scores = np.concatenate([scores, np.full(
                (spd * M - S, n_queries, lmax), -np.inf, np.float32)])
            docs = np.concatenate([docs, np.full(
                (spd * M - S, n_queries, lmax), _PAD_DOC, np.int32)])
            parts = []
            for j in range(M):
                with mesh.shard(j):
                    v, d = merge_topk(
                        commit_host_array(scores[j * spd:(j + 1) * spd],
                                          mesh.devices[j]),
                        commit_host_array(docs[j * spd:(j + 1) * spd],
                                          mesh.devices[j]), k)
                parts.append((v.to(mesh.first), d.to(mesh.first)))
            vals, out_docs = merge_topk(
                torch.stack([v for v, _ in parts]),
                torch.stack([d for _, d in parts]), k)
        ss, dd2 = obs_device.fetch_all([vals, out_docs])
    dt = time.perf_counter_ns() - t_d
    metrics.COLLECTIVE_COMBINE_NS.add(dt)
    metrics.DEVICE_DISPATCH_HIST.observe_ns(dt)
    trace = current_trace()
    if trace is not None:
        trace.add("collective_dispatch", "device", t_d,
                  time.perf_counter_ns(), shards=S, op="topk_merge",
                  queries=n_queries)
    results = []
    for qi in range(n_queries):
        sq, dq = ss[qi][:k], dd2[qi][:k]
        real = dq != _PAD_DOC
        results.append((sq[real].astype(np.float32),
                        dq[real].astype(np.int64)))
    return results


class MultiSearcher:
    """Searches across immutable segments of one column (reference:
    DirectoryReader over segment readers, SURVEY.md §2.7). Doc ids are
    global row indices (segment base + local id); scoring uses GLOBAL
    collection statistics so multi-segment scores equal a single-segment
    build of the same data."""

    def __init__(self, analyzer: Analyzer):
        self.analyzer = analyzer
        self.segments: list[tuple[SegmentSearcher, int]] = []  # (seg, base)

    def add_segment(self, searcher: SegmentSearcher, base_row: int):
        self.segments.append((searcher, base_row))

    @property
    def device(self) -> Optional[torch.device]:
        """The segments' device (the cross-shard merge runs there); None
        before the first segment."""
        return self.segments[0][0].device if self.segments else None

    @property
    def num_docs(self) -> int:
        return sum(s.num_docs for s, _ in self.segments)

    @property
    def global_avgdl(self) -> float:
        total_tokens = sum(s.index.total_tokens for s, _ in self.segments)
        n = self.num_docs
        return (total_tokens / n) if n else 0.0

    def _global_df(self, term: str) -> int:
        df = 0
        for s, _ in self.segments:
            tid = s.index.term_id(term)
            if tid >= 0:
                df += int(s.index.doc_freq[tid])
        return df

    def _global_ctf(self, term: str) -> int:
        ctf = 0
        for s, _ in self.segments:
            tid = s.index.term_id(term)
            if tid >= 0:
                ctf += int(s.index.ctf[tid])
        return ctf

    def eval_filter(self, node: QNode) -> np.ndarray:
        parts = []
        for s, base in self.segments:
            local = s.eval_filter(node)
            if len(local):
                parts.append(local.astype(np.int64) + base)
        return np.concatenate(parts).astype(np.int64) if parts \
            else np.empty(0, dtype=np.int64)

    def topk(self, node: QNode, k: int, scorer: str = "bm25",
             mesh_n: int = 0) -> tuple[np.ndarray, np.ndarray]:
        return self.topk_batch([node], k, scorer, mesh_n=mesh_n)[0]

    def topk_batch(self, nodes: list[QNode], k: int, scorer: str = "bm25",
                   mesh_n: int = 0, ragged: bool = False,
                   ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Fragments memoize PER QUERY (cache/fragments.cached_batch): a
        coalesced batch probes each member's own (sig, k, scorer) key, the
        misses score together in one segment dispatch, and each result
        stores back under its own key — so a fragment computed inside any
        batch serves the same query arriving alone later and vice versa
        (sound because per-query results are batch-composition-independent,
        the serving parity contract). `ragged` never keys a fragment: the
        ragged host path is bit-identical to the device dispatch by
        construction, same reason serene_search_batch stays out of the
        result cache's settings digest."""
        from ..cache.fragments import FRAGMENTS, qnode_sig
        sigs = [qnode_sig(n) for n in nodes]
        if len(self.segments) == 1:
            seg, base = self.segments[0]
            # single segment: local stats ARE the global stats — the
            # fragment is a pure function of the segment alone
            shapes = [None if s is None else ("topk1", s, k, scorer, mesh_n)
                      for s in sigs]
            out = FRAGMENTS.cached_batch(
                seg, shapes,
                lambda idxs: seg.topk_batch([nodes[i] for i in idxs], k,
                                            scorer, mesh_n=mesh_n,
                                            ragged=ragged))
            return [(s, d.astype(np.int64) + base) for s, d in out]
        idf_factory = self._segment_idf_factory(nodes, scorer)
        avgdl = self.global_avgdl
        # a segment's scored output depends on GLOBAL collection stats
        # (idf/avgdl span every segment), which are a pure function of
        # the segment SET — key the whole membership, so an append
        # recomputes scores exactly as correctness requires while
        # filter fragments (above) survive it
        segset = tuple(FRAGMENTS.segment_uid(s) for s, _ in self.segments)

        def run_segment(seg_base):
            seg, _base = seg_base
            shapes = [None if s is None else ("topk", s, k, scorer, mesh_n,
                                              segset) for s in sigs]
            return FRAGMENTS.cached_batch(
                seg, shapes,
                lambda idxs: seg.topk_batch([nodes[i] for i in idxs], k,
                                            scorer,
                                            idf_of=idf_factory(seg),
                                            avgdl_override=avgdl,
                                            mesh_n=mesh_n, ragged=ragged))

        # segments are independent top-k collectors: search them on the
        # shared worker pool (reference: parallel scored collectors over
        # the search thread pool). With a device mesh active the mesh IS
        # the parallelism — keep the segment loop serial then.
        from ..parallel.pool import get_pool, session_workers
        cap = 1 if mesh_n > 1 else session_workers(None)
        seg_outs = _run_segment_shards(run_segment, self.segments, cap)
        return _combine_topk(seg_outs,
                             [b for _, b in self.segments],
                             len(nodes), k, self.device)

    def probe_topk(self, node: QNode, k: int, scorer: str = "bm25",
                   mesh_n: int = 0,
                   ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Pure fragment-cache probe: the merged top-k iff EVERY segment's
        fragment for this query is already cached, else None — no scoring,
        no stores. The batcher consults this BEFORE enqueueing so cache
        hits never wait out a coalescing window or occupy a batch slot.
        Hit gauges bump only on full success; partial probes stay silent
        (the batch dispatch re-probes those segments and counts them
        once)."""
        from ..cache.fragments import FRAGMENTS, enabled, qnode_sig
        if not enabled() or not self.segments:
            return None
        sig = qnode_sig(node)
        if sig is None:
            return None
        if len(self.segments) == 1:
            seg, base = self.segments[0]
            hit = FRAGMENTS.probe(seg, ("topk1", sig, k, scorer, mesh_n))
            if hit is None:
                return None
            FRAGMENTS.count_hits(1)
            s, d = hit
            return s, d.astype(np.int64) + base
        segset = tuple(FRAGMENTS.segment_uid(s) for s, _ in self.segments)
        outs = []
        for seg, _base in self.segments:
            hit = FRAGMENTS.probe(seg, ("topk", sig, k, scorer, mesh_n,
                                        segset))
            if hit is None:
                return None
            outs.append([hit])
        FRAGMENTS.count_hits(len(self.segments))
        return merge_segment_topk(outs, [b for _, b in self.segments],
                                  1, k)[0]

    def _segment_idf_factory(self, nodes: list[QNode], scorer: str):
        """seg → idf_of closure over GLOBAL collection stats. One pass:
        global df per query term STRING (terms have different ids per
        segment), shared by every segment's closure."""
        n_total = max(self.num_docs, 1)
        term_strings: set[str] = set()
        for node in nodes:
            for seg, _ in self.segments:
                ts = seg.index.terms_str
                term_strings.update(str(ts[t])
                                    for t in seg.scoring_terms(node))
        global_df = {s: self._global_df(s) for s in term_strings}
        lm = scorer in bm25_ops.LM_SCORERS
        global_ctf = ({s: self._global_ctf(s) for s in term_strings}
                      if lm else {})
        total_tokens = (float(sum(s.index.total_tokens
                                  for s, _ in self.segments)) if lm else 0.0)

        def factory(seg):
            terms_str = seg.index.terms_str

            def idf_of(tids, _ts=terms_str):
                if lm:
                    ctfs = np.asarray(
                        [global_ctf[str(_ts[t])] for t in tids],
                        dtype=np.int64)
                    return bm25_ops.term_weight_for(
                        scorer, n_total, None, ctfs, total_tokens)
                dfs = np.asarray([global_df[str(_ts[t])] for t in tids],
                                 dtype=np.int64)
                return bm25_ops.idf_for(scorer, n_total, dfs)

            return idf_of
        return factory

    def cpu_topk(self, node: QNode, k: int, scorer: str = "bm25",
                 ) -> tuple[np.ndarray, np.ndarray]:
        """Host-only top-k: block-max WAND per segment on the worker
        pool, merged by one heap — the multi-segment analog of
        SegmentSearcher.cpu_topk_wand (reference: ScanMode::TopK parallel
        scored collectors). Exact-match-mask shapes score their match set
        directly; pure negations return zero-scored matches."""
        idf_factory = self._segment_idf_factory([node], scorer)
        avgdl = self.global_avgdl
        from ..cache.fragments import FRAGMENTS, qnode_sig
        sig = qnode_sig(node)
        segset = tuple(FRAGMENTS.segment_uid(s) for s, _ in self.segments)

        def run_segment(seg_base):
            seg, _base = seg_base

            def compute():
                idf_of = idf_factory(seg)
                tids, req, needs_mask, empty = seg._query_shape(node)
                if empty:
                    return (np.empty(0, dtype=np.float32),
                            np.empty(0, dtype=np.int32))
                if not tids:
                    match = seg.eval_filter(node)[:k]
                    return (np.zeros(len(match), dtype=np.float32),
                            match.astype(np.int32))
                if needs_mask:
                    match = seg.eval_filter(node)
                    sc, dd = seg._cpu_score(match, tids, k, scorer,
                                            idf_of, avgdl)
                    keep = sc > 0.0
                    return (sc[keep][:k], dd[keep][:k])
                return seg.cpu_topk_wand(tids, k, scorer, idf_of=idf_of,
                                         avgdl_override=avgdl,
                                         require_all=req)

            shape = None if sig is None else ("wand", sig, k, scorer,
                                              segset)
            return FRAGMENTS.cached(seg, shape, compute)

        from ..parallel.pool import session_workers
        cap = session_workers(None)
        outs = _run_segment_shards(run_segment, self.segments, cap)
        return _combine_topk([[o] for o in outs],
                             [b for _, b in self.segments], 1, k,
                             self.device)[0]


@dataclass
class SearchIndex:
    """A built index over one or more text columns of a table provider.
    Each column holds a MultiSearcher over immutable segments; appends add
    segments (incremental refresh), row mutations force full rebuilds."""

    columns: list[str]
    using: str
    options: dict
    analyzer_name: str
    searchers: dict[str, MultiSearcher]   # column → multi-segment searcher
    data_version: int
    mutation_epoch: int = 0
    indexed_rows: int = 0

    def searcher(self, column: str) -> Optional[MultiSearcher]:
        return self.searchers.get(column)

    def analyzer_name_for(self, column: str) -> str:
        """The column's own tokenizer (multi-column indexes may configure
        one per column — reference: USING inverted(text imdb_en, label))."""
        col_toks = (self.options or {}).get("column_tokenizers", {}) or {}
        return col_toks.get(column, self.analyzer_name)
