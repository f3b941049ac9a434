"""Copied from serenedb_tpu/search/ivf.py (the indexes carry the device
they were built on; k-means and the assignment run on the vector
kernels).

IVF vector index and MaxSim late-interaction index over table columns.

Reference analog: the IVF ANN index (IvfBuilder/centroids/quantizer,
libs/iresearch/formats/ivf/ivf_writer.hpp:44-100) with the session knobs
sdb_nprobe / sdb_rerank_factor (reference: config_variables.cpp), plus a
ColBERT-style multi-vector MaxSim index (FLASH-MAXSIM kernel shape).

Vectors live in a VARCHAR column as JSON arrays ('[0.1, 0.2, ...]'; a
MaxSim column holds '[[...], [...]]' token matrices). The index parses
them once at build into immutable CLUSTER-MAJOR segments — `VecSegment`
slabs sorted (cluster asc, row asc) — which the device vector pool
(search/vector_store.py) pages into HBM. Queries batch through the
pool's probe/maxsim programs; `nprobe=lists` is bit-identical to the
host brute-force oracle (ops/vector.host_dist + exact two-key
selection).

Write handling (the orphaning fix): a pure append assigns ONLY the tail
rows to the existing centroids and publishes a new tail segment (the
zone-map tail trick — base segments stay resident); destructive
mutations log a rebuild-reason on the maintenance topic and leave the
rebuild to the ticker.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from .. import errors
from ..columnar.device import commit_host_array
from ..device import current_device, resolve_device
from ..ops import vector as vops
from ..utils import log
from .vector_store import VPOOL

DEFAULT_LISTS = 64
KMEANS_ITERS = 8

#: tail-segment cap: one more pure append past this forces a logged
#: full rebuild (re-clustering) instead of growing the segment chain
MAX_VEC_SEGMENTS = 8

#: per-index fragment-probe memo entries (batcher probe_topk)
_FRAG_CAP = 64


def parse_vector(text: Optional[str], dim: Optional[int] = None,
                 ) -> Optional[np.ndarray]:
    if text is None:
        return None
    try:
        v = np.asarray(json.loads(text), dtype=np.float32)
    except (json.JSONDecodeError, ValueError):
        raise errors.SqlError(errors.INVALID_TEXT_REPRESENTATION,
                              f"invalid vector literal: {text[:40]!r}")
    if v.ndim != 1:
        raise errors.SqlError(errors.INVALID_TEXT_REPRESENTATION,
                              "vector literal must be a flat array")
    if dim is not None and len(v) != dim:
        raise errors.SqlError(errors.DATATYPE_MISMATCH,
                              f"expected {dim} dimensions, got {len(v)}")
    return v


def parse_multi_vector(text: Optional[str], dim: Optional[int] = None,
                       ) -> Optional[np.ndarray]:
    """A MaxSim document: '[[...], [...]]' → (T, dim) f32 token matrix
    (a flat '[...]' is accepted as a single token). None / empty → None
    (the doc simply has no tokens to score)."""
    if text is None:
        return None
    try:
        raw = json.loads(text)
        v = np.asarray(raw, dtype=np.float32)
    except (json.JSONDecodeError, ValueError):
        raise errors.SqlError(errors.INVALID_TEXT_REPRESENTATION,
                              f"invalid multi-vector literal: {text[:40]!r}")
    if v.ndim == 1:
        if v.size == 0:
            return None
        v = v.reshape(1, -1)
    if v.ndim != 2:
        raise errors.SqlError(errors.INVALID_TEXT_REPRESENTATION,
                              "multi-vector literal must be a 2-D array")
    if v.shape[0] == 0:
        return None
    if dim is not None and v.shape[1] != dim:
        raise errors.SqlError(errors.DATATYPE_MISMATCH,
                              f"expected {dim} dimensions, got {v.shape[1]}")
    return v


class VecSegment:
    """One immutable cluster-major slab: `vals[i]` is the vector at
    segment-local position i, `rows[i]` its table row, `codes[i]` its
    cluster — sorted (cluster asc, row asc). The device pool keys page
    residency on the segment OBJECT (weakref-reclaimed), so appends
    that reuse base segments keep their pages hot."""

    __slots__ = ("vals", "rows", "codes", "counts", "__weakref__",
                 "_vpool_uid")

    def __init__(self, vals: np.ndarray, rows: np.ndarray,
                 codes: np.ndarray, lists: int):
        order = np.lexsort((rows, codes))
        self.vals = np.ascontiguousarray(vals[order], dtype=np.float32)
        self.rows = np.ascontiguousarray(rows[order], dtype=np.int32)
        self.codes = np.ascontiguousarray(codes[order], dtype=np.int32)
        self.counts = np.bincount(self.codes, minlength=lists)[:lists] \
            .astype(np.int64)


class _VecIndexBase:
    """Shared layout/pool plumbing + the SearchBatcher adapter contract
    (`topk` / `topk_batch` / `probe_topk`)."""

    def __init__(self):
        self._layout = None
        self._hostmat = None
        self._frag: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._frag_lock = threading.Lock()

    # -- layout -----------------------------------------------------------

    def layout(self) -> dict:
        """Cluster-major logical layout across segments (cluster c =
        seg₀'s c-rows ++ seg₁'s c-rows ++ …): per-cluster offsets and
        counts, per-position row ids and (segment, within) coordinates
        for the pool's slot map. Cached; the index is immutable."""
        lay = self._layout
        if lay is None:
            nl = self.nlists()
            if self.segs:
                counts = np.zeros(nl, np.int64)
                for s in self.segs:
                    counts += s.counts
                all_codes = np.concatenate([s.codes for s in self.segs])
                all_seg = np.concatenate(
                    [np.full(len(s.codes), si, np.int32)
                     for si, s in enumerate(self.segs)])
                all_within = np.concatenate(
                    [np.arange(len(s.codes), dtype=np.int32)
                     for s in self.segs])
                all_rows = np.concatenate([s.rows for s in self.segs])
                order = np.lexsort((all_within, all_seg, all_codes))
            else:
                counts = np.zeros(nl, np.int64)
                order = np.zeros(0, np.int64)
                all_seg = all_within = all_rows = np.zeros(0, np.int32)
            offsets = np.zeros(nl + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            lay = {"ntot": int(counts.sum()),
                   "nlists": nl,
                   "offsets": offsets[:-1],
                   "counts": counts,
                   "max_count": int(counts.max(initial=0)),
                   "seg_of": all_seg[order] if len(order) else all_seg,
                   "within": all_within[order] if len(order)
                   else all_within,
                   "rowids": all_rows[order] if len(order) else all_rows}
            lay.update(self._layout_extra(lay))
            self._layout = lay
        return lay

    def _layout_extra(self, lay) -> dict:
        return {}

    def host_logical(self) -> np.ndarray:
        """The logical-order (ntot, dim) f32 matrix — the cold path's
        temporary region and the brute oracle's corpus. Cached."""
        mat = self._hostmat
        if mat is None:
            lay = self.layout()
            mat = np.zeros((max(lay["ntot"], 1), self.dim), np.float32)
            for si, seg in enumerate(self.segs):
                mask = lay["seg_of"] == si
                if mask.any():
                    mat[np.nonzero(mask)[0]] = seg.vals[
                        lay["within"][mask]]
            self._hostmat = mat
        return mat

    # -- SearchBatcher adapter --------------------------------------------

    def topk(self, node, k: int, scorer: str, mesh_n: int = 0):
        return self.topk_batch([node], k, scorer, mesh_n=mesh_n)[0]

    def probe_topk(self, node, k: int, scorer: str, mesh_n: int):
        """Fragment probe: a repeated (query, k, scorer) pair returns
        its cached per-query result without occupying a batch slot."""
        key = self._frag_key(node, k, scorer)
        with self._frag_lock:
            hit = self._frag.get(key)
            if hit is not None:
                self._frag.move_to_end(key)
            return hit

    def _frag_store(self, node, k: int, scorer: str, result) -> None:
        key = self._frag_key(node, k, scorer)
        with self._frag_lock:
            self._frag[key] = result
            while len(self._frag) > _FRAG_CAP:
                self._frag.popitem(last=False)

    def _frag_key(self, node, k: int, scorer: str) -> tuple:
        a = np.ascontiguousarray(node, np.float32)
        return (a.shape, a.tobytes(), int(k), scorer)


class IvfIndex(_VecIndexBase):
    using = "ivf"

    def __init__(self, *, column: str, dim: int, lists: int, metric: str,
                 centroids: np.ndarray, segs: list, num_rows: int,
                 data_version: int, mutation_epoch: int = 0,
                 options: dict = None, quantized: bool = False,
                 host_vectors=None, sq8_lo=None, sq8_scale=None,
                 device=None):
        super().__init__()
        #: where the pool pages this index and its kernels run
        self.device = resolve_device(device)
        self.column = column
        self.dim = dim
        self.lists = lists
        self.metric = metric
        self.centroids = centroids
        self.segs = list(segs)
        self.num_rows = num_rows
        self.data_version = data_version
        self.mutation_epoch = mutation_epoch
        self.columns = (column,)
        self.options = dict(options or {})
        self.quantized = quantized
        # SQ8: HBM pages hold the dequantized f32; originals stay
        # host-side for the exact rerank; lo/scale are FROZEN at build
        # so existing rows' dequantized bits never change across appends
        self.host_vectors = host_vectors
        self.sq8_lo = sq8_lo
        self.sq8_scale = sq8_scale

    def nlists(self) -> int:
        return self.lists

    # -- search -----------------------------------------------------------

    def search(self, queries: np.ndarray, k: int, nprobe: int,
               rerank_factor: int = 4) -> tuple[np.ndarray, np.ndarray]:
        """Batched: queries (Q, dim) → (distances (Q, kk), row ids
        (Q, kk)); dead lanes carry (+inf, pad) — callers filter
        non-finite distances."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        lay = self.layout()
        ntot = lay["ntot"]
        if ntot == 0:
            return (np.full((len(q), 1), np.inf, np.float32),
                    np.zeros((len(q), 1), np.int64))
        kk = min(max(k, 1), ntot)
        if not self.quantized:
            d, r = VPOOL.search(self, q, kk, nprobe)
            return d, r.astype(np.int64)
        # SQ8: over-fetch in the dequantized space, exact-rerank the
        # candidates against the host originals
        fetch = min(kk * max(rerank_factor, 1), ntot)
        d, r = VPOOL.search(self, q, fetch, nprobe)
        out_d = np.full((len(q), kk), np.inf, dtype=np.float32)
        out_i = np.zeros((len(q), kk), dtype=np.int64)
        for qi in range(len(q)):
            cand = r[qi][np.isfinite(d[qi])].astype(np.int64)
            if not len(cand):
                continue
            vecs = self.host_vectors[cand]
            qv = q[qi]
            if self.metric == "l2":
                dd = ((vecs - qv) ** 2).sum(axis=1)
            elif self.metric == "ip":
                dd = -(vecs @ qv)
            else:
                nv = np.linalg.norm(vecs, axis=1)
                dd = 1.0 - (vecs @ qv) / np.maximum(
                    nv * max(np.linalg.norm(qv), 1e-9), 1e-9)
            order = np.argsort(dd, kind="stable")[:kk]
            out_d[qi, :len(order)] = dd[order]
            out_i[qi, :len(order)] = cand[order]
        return out_d, out_i

    def brute_search(self, queries: np.ndarray, k: int):
        """Device brute-force oracle (test/bench surface): same program
        body and distance bits as the probe path, one all-rows list."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        return VPOOL.brute(self, q, k)

    # -- batcher adapter ---------------------------------------------------

    def topk_batch(self, nodes, k: int, scorer: str, mesh_n: int = 0,
                   ragged: bool = False):
        nprobe, rerank = _parse_knn_scorer(scorer)
        q = np.stack([np.ascontiguousarray(n, np.float32)
                      for n in nodes])
        d, r = self.search(q, k, nprobe, rerank)
        outs = [(d[i], r[i]) for i in range(len(nodes))]
        for node, out in zip(nodes, outs):
            self._frag_store(node, k, scorer, out)
        return outs


def _parse_knn_scorer(scorer: str) -> tuple[int, int]:
    """'knn:<nprobe>:<rerank>' → (nprobe, rerank). The settings ride in
    the scorer string so the batcher's (searcher, k, scorer, mesh)
    group key keeps queries with different knobs in separate
    dispatches."""
    try:
        _, a, b = scorer.split(":")
        return max(1, int(a)), max(1, int(b))
    except ValueError:
        return 8, 4


class MaxSimIndex(_VecIndexBase):
    using = "maxsim"
    metric = "maxsim"
    quantized = False

    def __init__(self, *, column: str, dim: int, segs: list,
                 doc_rows: np.ndarray, num_rows: int, data_version: int,
                 mutation_epoch: int = 0, options: dict = None,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.column = column
        self.dim = dim
        self.segs = list(segs)
        #: table row of each doc ordinal (docs = rows with ≥1 token)
        self.doc_rows = doc_rows.astype(np.int32)
        self.num_rows = num_rows
        self.data_version = data_version
        self.mutation_epoch = mutation_epoch
        self.columns = (column,)
        self.options = dict(options or {})

    def nlists(self) -> int:
        return len(self.doc_rows)

    def _layout_extra(self, lay) -> dict:
        return {"cluster_rowids": self.doc_rows}

    def search(self, qtoks: np.ndarray, k: int):
        """One query's MaxSim top-k: (scores desc (kk,), rows (kk,)).
        qtoks: (S, dim) f32."""
        keys, rows = self.search_batch(qtoks[None, ...], k)
        return -keys[0], rows[0]

    def search_batch(self, qtoks: np.ndarray, k: int):
        """Batched: qtoks (B, S, dim) → (keys = NEGATED scores
        (B, kk), rows (B, kk)); dead lanes carry (+inf, pad)."""
        ndocs = len(self.doc_rows)
        if ndocs == 0 or self.layout()["ntot"] == 0:
            return (np.full((len(qtoks), 1), np.inf, np.float32),
                    np.zeros((len(qtoks), 1), np.int32))
        return VPOOL.maxsim_search(self, qtoks, k)

    def host_scores(self, qtoks: np.ndarray) -> np.ndarray:
        """f64 host oracle (the `serene_maxsim = off` path): exact
        Σ_s max_t <q_s, d_t> per doc, in float64."""
        lay = self.layout()
        mat = self.host_logical().astype(np.float64)
        q = np.asarray(qtoks, np.float64)
        out = np.zeros(len(self.doc_rows), np.float64)
        for di in range(len(self.doc_rows)):
            a = int(lay["offsets"][di])
            b = a + int(lay["counts"][di])
            sim = q @ mat[a:b].T                  # (S, T)
            out[di] = sim.max(axis=1).sum()
        return out

    # -- batcher adapter ---------------------------------------------------

    def topk_batch(self, nodes, k: int, scorer: str, mesh_n: int = 0,
                   ragged: bool = False):
        s_max = max(n.shape[0] for n in nodes)
        q = np.zeros((len(nodes), s_max, self.dim), np.float32)
        for i, n in enumerate(nodes):
            q[i, :n.shape[0]] = n
        keys, rows = self.search_batch(q, k)
        outs = [(keys[i], rows[i]) for i in range(len(nodes))]
        for node, out in zip(nodes, outs):
            self._frag_store(node, k, scorer, out)
        return outs


# -- builders -----------------------------------------------------------------


def _parse_column(provider, column: str, dim, parse):
    col = provider.full_batch([column]).column(column)
    if not col.type.is_string:
        raise errors.SqlError(errors.DATATYPE_MISMATCH,
                              "vector index requires a JSON-array vector "
                              "column")
    texts = col.to_pylist()
    vecs, rows = [], []
    for i, t in enumerate(texts):
        v = parse(t, dim) if t is not None else None
        if v is not None:
            if dim is None:
                dim = v.shape[-1]
            vecs.append(v)
            rows.append(i)
    return texts, vecs, np.asarray(rows, np.int64), dim


def build_ivf_index(provider, column: str, options: dict) -> IvfIndex:
    dim = int(options.get("dim", 0)) or None
    texts, vecs, rows, dim = _parse_column(provider, column, dim,
                                           parse_vector)
    n = len(texts)
    dim = dim or 1
    nv = len(vecs)
    mat = np.stack(vecs).astype(np.float32) if nv \
        else np.zeros((0, dim), np.float32)
    lists = int(options.get("lists", options.get("nlist", DEFAULT_LISTS)))
    lists = max(1, min(lists, max(nv, 1)))
    metric = str(options.get("metric", "l2")).lower()
    if metric not in ("l2", "ip", "cos"):
        raise errors.unsupported(f"ivf metric {metric}")
    train = mat if nv else np.zeros((1, dim), np.float32)
    init = vops.init_centroids(train, lists)
    dev = current_device()
    centroids = vops.kmeans_fit(
        commit_host_array(vops.pad_rows(train), dev),
        commit_host_array(init, dev), lists, KMEANS_ITERS).cpu().numpy()
    host = np.zeros((max(n, 1), dim), np.float32)
    if nv:
        host[rows] = mat
    quant = str(options.get("quantization",
                            options.get("quantizer", ""))).lower()
    quantized = quant in ("sq8", "int8")
    lo = scale = None
    vals = mat
    if quantized:
        # per-dim affine SQ8: stats come from the VALID rows at build
        # time and stay FROZEN across appends; pages hold the
        # dequantized f32, originals stay host-side for exact rerank
        stats_src = mat if nv else np.zeros((1, dim), np.float32)
        _, lo, scale = vops.sq8_quantize(stats_src)
        q8 = np.clip(np.round((mat - lo) / scale * 255.0),
                     0, 255).astype(np.uint8)
        vals = vops.sq8_dequantize(q8, lo, scale)
    segs = []
    if nv:
        codes = vops.assign_clusters(
            commit_host_array(vops.pad_rows(mat), dev),
            commit_host_array(centroids, dev)).cpu().numpy()[:nv]
        segs.append(VecSegment(vals, rows, codes, lists))
    return IvfIndex(
        column=column, dim=dim, lists=lists, metric=metric,
        centroids=centroids, segs=segs, num_rows=n,
        data_version=provider.data_version,
        mutation_epoch=getattr(provider, "mutation_epoch", 0),
        options=dict(options), quantized=quantized,
        host_vectors=host if quantized else None,
        sq8_lo=lo, sq8_scale=scale, device=dev)


def build_maxsim_index(provider, column: str, options: dict,
                       ) -> MaxSimIndex:
    dim = int(options.get("dim", 0)) or None
    texts, vecs, rows, dim = _parse_column(provider, column, dim,
                                           parse_multi_vector)
    n = len(texts)
    dim = dim or 1
    if vecs:
        vals = np.concatenate(vecs, axis=0).astype(np.float32)
        codes = np.concatenate(
            [np.full(len(v), di, np.int32) for di, v in enumerate(vecs)])
        tok_rows = np.concatenate(
            [np.full(len(v), i, np.int32)
             for v, i in zip(vecs, np.arange(len(vecs)))])
        segs = [VecSegment(vals, tok_rows, codes, len(vecs))]
    else:
        segs = []
    return MaxSimIndex(
        column=column, dim=dim, segs=segs,
        doc_rows=rows.astype(np.int32), num_rows=n,
        data_version=provider.data_version,
        mutation_epoch=getattr(provider, "mutation_epoch", 0),
        options=dict(options), device=current_device())


# -- refresh / lookup ---------------------------------------------------------


def refresh_ivf_index(provider, idx: IvfIndex) -> IvfIndex:
    """The ticker/read-repair leg for IVF: pure appends assign ONLY the
    tail rows to the existing centroids and publish one new tail
    segment; everything else (mutation, shrink, segment-cap overflow)
    is a logged full rebuild (re-clustering)."""
    n_rows = provider.row_count()
    epoch = getattr(provider, "mutation_epoch", 0)
    reason = None
    if idx.mutation_epoch != epoch:
        reason = "mutation epoch advanced (delete/update/truncate)"
    elif n_rows < idx.num_rows:
        reason = (f"row count shrank ({n_rows} < {idx.num_rows}) "
                  "without an epoch bump (truncate/rollback)")
    elif len(idx.segs) >= MAX_VEC_SEGMENTS and n_rows > idx.num_rows:
        reason = (f"tail-segment cap reached ({len(idx.segs)} >= "
                  f"{MAX_VEC_SEGMENTS}); re-clustering")
    if reason is not None:
        log.info("maintenance",
                 f"full ivf rebuild on \"{provider.name}\" "
                 f"({idx.column}): {reason}")
        return build_ivf_index(provider, idx.column, idx.options)
    if n_rows == idx.num_rows:
        return _clone_ivf(idx, n_rows, epoch)
    # pure append: parse the tail only, keep centroids and segments
    col = provider.full_batch([idx.column]).column(idx.column)
    texts = col.slice(idx.num_rows, n_rows).to_pylist()
    vecs, rows = [], []
    for i, t in enumerate(texts):
        v = parse_vector(t, idx.dim) if t is not None else None
        if v is not None:
            vecs.append(v)
            rows.append(idx.num_rows + i)
    new = _clone_ivf(idx, n_rows, epoch)
    if vecs:
        mat = np.stack(vecs).astype(np.float32)
        rows = np.asarray(rows, np.int64)
        vals = mat
        if idx.quantized:
            q8 = np.clip(np.round((mat - idx.sq8_lo) / idx.sq8_scale
                                  * 255.0), 0, 255).astype(np.uint8)
            vals = vops.sq8_dequantize(q8, idx.sq8_lo, idx.sq8_scale)
            host = np.zeros((n_rows, idx.dim), np.float32)
            host[:len(idx.host_vectors)] = idx.host_vectors
            host[rows] = mat
            new.host_vectors = host
        codes = vops.assign_clusters(
            commit_host_array(vops.pad_rows(mat), idx.device),
            commit_host_array(idx.centroids, idx.device)
        ).cpu().numpy()[:len(mat)]
        new.segs.append(VecSegment(vals, rows, codes, idx.lists))
    return new


def _clone_ivf(idx: IvfIndex, n_rows: int, epoch: int) -> IvfIndex:
    return IvfIndex(
        column=idx.column, dim=idx.dim, lists=idx.lists,
        metric=idx.metric, centroids=idx.centroids, segs=idx.segs,
        num_rows=n_rows, data_version=idx.data_version,
        mutation_epoch=epoch, options=idx.options,
        quantized=idx.quantized, host_vectors=idx.host_vectors,
        sq8_lo=idx.sq8_lo, sq8_scale=idx.sq8_scale, device=idx.device)


def find_ivf_index(provider, column: str) -> Optional[IvfIndex]:
    """Current IVF index for the column, read-repairing pure appends
    in place (incremental tail segment). Destructive mutations return
    None — the knn degrades to a scored scan — but LOG the reason once
    per stale index so the degradation is diagnosable; the maintenance
    ticker rebuilds it."""
    for name, idx in getattr(provider, "indexes", {}).items():
        if not (isinstance(idx, IvfIndex) and idx.column == column):
            continue
        if idx.data_version == provider.data_version:
            return idx
        epoch = getattr(provider, "mutation_epoch", 0)
        n_rows = provider.row_count()
        if idx.mutation_epoch == epoch and n_rows >= idx.num_rows \
                and len(idx.segs) < MAX_VEC_SEGMENTS:
            from .index import _repair
            return _repair(provider, name, idx,
                           lambda cur: refresh_ivf_index(provider, cur))
        if not getattr(idx, "_orphan_logged", False):
            idx._orphan_logged = True
            why = ("mutation epoch advanced"
                   if idx.mutation_epoch != epoch else
                   "row count shrank" if n_rows < idx.num_rows else
                   "tail-segment cap reached")
            log.info("maintenance",
                     f"ivf index on \"{provider.name}\" ({column}) "
                     f"stale ({why}); queries fall back to a scored "
                     "scan until the maintenance ticker rebuilds it")
        return None
    return None


def find_maxsim_index(provider, column: str) -> Optional[MaxSimIndex]:
    for idx in getattr(provider, "indexes", {}).values():
        if isinstance(idx, MaxSimIndex) and idx.column == column and \
                idx.data_version == provider.data_version:
            return idx
    return None
