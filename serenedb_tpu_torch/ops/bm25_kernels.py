"""Wrappers of the BM25 CUDA kernels (`csrc/bm25.cu`) and their plain
PyTorch versions.

Each wrapper launches its kernel for tensors on a CUDA device and counts
every launch in `device.LAUNCHES` under its own name; for tensors on the
CPU it calls the plain version (counted under `<name>.plain`). There is no
other path: a wrapper never falls back from the card to the plain version.
The plain versions compute the same function with the same arithmetic in
the same order (sqrt and the logs rounded from f64, see `_f64`); the CPU
tests hold them against the JAX package and
`chip_smoke.py` holds each kernel against its plain version on the card.

- `bm25_accumulate` ← serenedb_tpu/ops/bm25.py `_accumulate_scores`
  (`_decode_rows`, `contrib_of`): score planes of a query batch.
- `build_dense` ← `_build_dense`: the dense saturation matrix.
- `topk_rows` ← the `lax.top_k` of `_score_topk` / `dense_topk`, with the
  conjunction mask fused in: per-row top-k by (score desc, index asc); one
  read of the plane up to TOPK_ONE_MAX, the radix regime above it.
- `contrib_flat` ← `contrib_flat` (`contrib_expr` over flat arrays): the
  per-posting contributions of the host ragged path; its plain version is
  `contrib_plain`, the formula every plain version here shares.
- `match_bitmap` ← `match_bitmap`: the disjunctive match bitmap of the
  packed rows, raw rows and tails of an unscored filter; one launch a
  call, which zeroes the bitmap itself.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import LAUNCHES
from . import _build

SCORERS = {"bm25": 0, "tfidf": 1, "lm_dirichlet": 2, "jelinek_mercer": 3,
           "dfi": 4}
MATCH_EPS = 1e-6
#: the largest k that topk_rows selects in its one-read regime (at most
#: 8,192, csrc/bm25.cu TK_ONE_LIMIT); above it, the radix regime. Set from
#: card timings (scripts/topk_shapes.py, PERF.md): the one read is the
#: faster at k = 1,024 on both main-path planes, the radix regime from
#: 2,048.
TOPK_ONE_MAX = 1024


def _is_cuda(*ts) -> bool:
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {devs}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _require(t: torch.Tensor, dtype: torch.dtype, name: str,
             align: int = 4) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.numel() and t.data_ptr() % align:
        raise ValueError(f"{name}: must be {align}-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


_EPS_DL = float(np.float32(1e-9))


def _avg(avgdl: float) -> float:
    """max(f32(avgdl), 1e-9) as the kernels receive it (on Python floats
    that hold f32 values: a torch op costs more than the small kernel
    calls it precedes; a NaN stays NaN, as torch.maximum keeps it)."""
    return max(float(np.float32(avgdl)), _EPS_DL)


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for f32 x, evaluated in f64 and rounded to f32. On the CPU,
    torch's f32 sqrt/log go through MKL's vector math, which is not
    correctly rounded and now and then returns a chunk of a tensor with
    ~2^-12 relative error; via f64 the result is the nearest f32 (for
    sqrt exactly the card's sqrtf)."""
    return fn(x.to(torch.float64)).to(torch.float32)


# ------------------------------------------------------------ contribution

def contrib_plain(scorer: str, tf: torch.Tensor, dl: torch.Tensor,
                  w: torch.Tensor, k1: float, b: float,
                  avg: float) -> torch.Tensor:
    """Per-posting contribution (reference `contrib_of`) in f32, in the
    kernel's order of operations; sqrt and the logs round from f64
    (`_f64`). tf, dl: f32; w: f32."""
    k1t, bt, avgt = _f32(k1).to(tf.device), _f32(b).to(tf.device), \
        _f32(avg).to(tf.device)
    if scorer == "tfidf":
        return w * _f64(torch.sqrt, tf)
    if scorer == "lm_dirichlet":
        mu = k1t
        c = _f64(torch.log1p, tf / (mu * w)) + \
            _f64(torch.log, mu / (dl + mu))
        return torch.clamp(c, min=0.0) + MATCH_EPS
    if scorer == "jelinek_mercer":
        lam = k1t
        return _f64(torch.log1p, ((1.0 - lam) * tf /
                                  torch.clamp(dl, min=1.0)) / (lam * w))
    if scorer == "dfi":
        e = w * dl
        excess = (tf - e) / _f64(torch.sqrt, torch.clamp(e, min=1e-9))
        return torch.where(tf > e, _f64(torch.log2, 1.0 + excess),
                           torch.zeros_like(tf)) + MATCH_EPS
    if scorer != "bm25":
        raise ValueError(f"unknown scorer {scorer!r}")
    denom = tf + k1t * (1.0 - bt + bt * dl / avgt)
    return w * (k1t + 1.0) * tf / torch.clamp(denom, min=1e-9)


def decode_rows_plain(block_base: torch.Tensor, block_gaps: torch.Tensor,
                      block_tfs8: torch.Tensor, row_idx: torch.Tensor,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed rows → (docs, tfs) int32 (reference `_decode_rows`): docs =
    base + lane prefix sum of the uint16 gaps, -1 where tf is 0."""
    ri = row_idx.long()
    # torch gathers no uint16 on the card: gather the bits as int16, then
    # widen to int32 before any arithmetic
    gaps = block_gaps.view(torch.int16)[ri].to(torch.int32) & 0xFFFF
    docs = block_base[ri][:, None] + torch.cumsum(gaps, dim=1,
                                                  dtype=torch.int32)
    tfs = block_tfs8[ri].to(torch.int32)
    return torch.where(tfs > 0, docs, torch.full_like(docs, -1)), tfs


# --------------------------------------------------------- bm25_accumulate

def _layer_counts(*ranks: torch.Tensor) -> list[int]:
    """Number of (plane, rank) layers per plane: 1 + its largest rank."""
    tops = [r.max() if r.numel() else torch.tensor(-1, device=r.device)
            for r in ranks]
    return [int(x) + 1 for x in torch.stack(tops).tolist()]


def bm25_accumulate_plain(block_base, block_gaps, block_tfs8, raw_docs,
                          raw_tfs, norms, row_idx, row_w, row_qid, row_rank,
                          raw_idx, raw_w, raw_qid, raw_rank, tail_docs,
                          tail_tfs, tail_w, tail_qid, tail_rank,
                          ndocs_pad: int, n_queries: int, with_hits: bool,
                          k1: float, b: float, avgdl: float,
                          scorer: str = "bm25"):
    """Plain version of `bm25_accumulate`: the same layers in the same
    order, each added with index_add_ (no two entries of a layer share a
    cell)."""
    LAUNCHES.bump("bm25_accumulate.plain")
    dev = norms.device
    avg = _avg(avgdl)
    scores = torch.zeros(n_queries * ndocs_pad, dtype=torch.float32,
                         device=dev)
    hits = torch.zeros(n_queries * ndocs_pad, dtype=torch.int32,
                       device=dev) if with_hits else None
    pdocs, ptfs = decode_rows_plain(block_base, block_gaps, block_tfs8,
                                    row_idx)
    rdocs = raw_docs[raw_idx.long()]
    rtfs = raw_tfs[raw_idx.long()]
    planes = [(pdocs, ptfs, row_w[:, None], row_qid[:, None],
               row_rank[:, None]),
              (rdocs, rtfs, raw_w[:, None], raw_qid[:, None],
               raw_rank[:, None]),
              (tail_docs, tail_tfs, tail_w, tail_qid, tail_rank)]
    n_layers = _layer_counts(row_rank, raw_rank, tail_rank)
    for (docs, tfs, w, qid, rank), layers in zip(planes, n_layers):
        valid = (docs >= 0) & (tfs > 0)
        safe = torch.where(valid, docs, torch.zeros_like(docs))
        dl = norms[safe.long()].to(torch.float32)
        c = contrib_plain(scorer, tfs.to(torch.float32), dl,
                          w.expand_as(dl), k1, b, avg)
        cell = qid.long() * ndocs_pad + safe.long()
        for layer in range(layers):
            sel = valid & (rank == layer)
            idx = cell.expand_as(sel)[sel]
            scores.index_add_(0, idx, c[sel])
            if hits is not None:
                hits.index_add_(0, idx, torch.ones_like(idx,
                                                        dtype=torch.int32))
    scores = scores.view(n_queries, ndocs_pad)
    return scores, (hits.view(n_queries, ndocs_pad)
                    if hits is not None else None)


def bm25_accumulate(block_base, block_gaps, block_tfs8, raw_docs, raw_tfs,
                    norms, row_idx, row_w, row_qid, row_rank, raw_idx, raw_w,
                    raw_qid, raw_rank, tail_docs, tail_tfs, tail_w, tail_qid,
                    tail_rank, ndocs_pad: int, n_queries: int,
                    with_hits: bool, k1: float, b: float, avgdl: float,
                    scorer: str = "bm25",
                    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, ndocs_pad) f32 score plane (and i32 hit plane when with_hits)
    of one query batch. One kernel launch per (plane, rank) layer, planes
    in the reference's order: packed rows, raw rows, light tails."""
    args = (block_base, block_gaps, block_tfs8, raw_docs, raw_tfs, norms,
            row_idx, row_w, row_qid, row_rank, raw_idx, raw_w, raw_qid,
            raw_rank, tail_docs, tail_tfs, tail_w, tail_qid, tail_rank)
    if not _is_cuda(*args):
        return bm25_accumulate_plain(*args, ndocs_pad, n_queries, with_hits,
                                     k1, b, avgdl, scorer)
    _require(block_base, torch.int32, "block_base")
    _require(block_gaps, torch.uint16, "block_gaps", 16)
    _require(block_tfs8, torch.uint8, "block_tfs8", 16)
    _require(raw_docs, torch.int32, "raw_docs", 16)
    _require(raw_tfs, torch.int32, "raw_tfs", 16)
    _require(norms, torch.int32, "norms")
    for name, t, dt in (("row_idx", row_idx, torch.int32),
                        ("row_w", row_w, torch.float32),
                        ("row_qid", row_qid, torch.int32),
                        ("row_rank", row_rank, torch.int32),
                        ("raw_idx", raw_idx, torch.int32),
                        ("raw_w", raw_w, torch.float32),
                        ("raw_qid", raw_qid, torch.int32),
                        ("raw_rank", raw_rank, torch.int32),
                        ("tail_docs", tail_docs, torch.int32),
                        ("tail_tfs", tail_tfs, torch.int32),
                        ("tail_w", tail_w, torch.float32),
                        ("tail_qid", tail_qid, torch.int32),
                        ("tail_rank", tail_rank, torch.int32)):
        _require(t, dt, name)
    dev = norms.device
    lib = _build.load("bm25")
    sc = SCORERS[scorer]
    avg = _avg(avgdl)
    scores = torch.zeros((n_queries, ndocs_pad), dtype=torch.float32,
                         device=dev)
    hits = torch.zeros((n_queries, ndocs_pad), dtype=torch.int32,
                       device=dev) if with_hits else None
    stream = _stream(norms)
    n_pk, n_raw, n_tail = _layer_counts(row_rank, raw_rank, tail_rank)
    for layer in range(n_pk):
        _build.check(lib.bm25_accumulate_rows(
            1, _ptr(block_base), _ptr(block_gaps), _ptr(block_tfs8), None,
            None, _ptr(norms), _ptr(row_idx), _ptr(row_w), _ptr(row_qid),
            _ptr(row_rank), row_idx.numel(), layer, _ptr(scores),
            _ptr(hits), ndocs_pad, sc, k1, b, avg, stream),
            "bm25_accumulate (packed)")
        LAUNCHES.bump("bm25_accumulate")
    for layer in range(n_raw):
        _build.check(lib.bm25_accumulate_rows(
            0, None, None, None, _ptr(raw_docs), _ptr(raw_tfs), _ptr(norms),
            _ptr(raw_idx), _ptr(raw_w), _ptr(raw_qid), _ptr(raw_rank),
            raw_idx.numel(), layer, _ptr(scores), _ptr(hits), ndocs_pad, sc,
            k1, b, avg, stream), "bm25_accumulate (raw)")
        LAUNCHES.bump("bm25_accumulate")
    for layer in range(n_tail):
        _build.check(lib.bm25_accumulate_tail(
            _ptr(tail_docs), _ptr(tail_tfs), _ptr(tail_w), _ptr(tail_qid),
            _ptr(tail_rank), tail_docs.numel(), layer, _ptr(norms),
            _ptr(scores), _ptr(hits), ndocs_pad, sc, k1, b, avg, stream),
            "bm25_accumulate (tails)")
        LAUNCHES.bump("bm25_accumulate")
    return scores, hits


# ------------------------------------------------------------ contrib_flat

#: the scorers `contrib_flat` takes: the reference's `contrib_expr` states
#: bm25 and tfidf only (the LM family never takes the ragged path)
FLAT_SCORERS = ("bm25", "tfidf")


def contrib_flat(tfs: torch.Tensor, dls: torch.Tensor, w: torch.Tensor,
                 k1: float, b: float, avgdl: float, scorer: str = "bm25",
                 norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-posting contribution w·sat(tf, dl) over flat int32 tfs, int32
    dls and f32 w of one length: one launch, four postings a thread,
    through the plane kernels' own `contrib()`. With `norms` (int32, the
    resident doc lengths) `dls` holds doc ids and dl is norms[doc].
    Padding (tf 0, w 0) gives 0.0."""
    if scorer not in FLAT_SCORERS:
        raise ValueError(f"contrib_flat takes {FLAT_SCORERS}, not {scorer!r}")
    if not (tfs.shape == dls.shape == w.shape) or tfs.dim() != 1:
        raise ValueError("tfs, dls and w must be flat arrays of one length")
    if not _is_cuda(tfs, dls, w, norms):
        LAUNCHES.bump("contrib_flat.plain")
        dl = dls if norms is None else norms[dls.long()]
        return contrib_plain(scorer, tfs.to(torch.float32),
                             dl.to(torch.float32), w, k1, b, _avg(avgdl))
    _require(tfs, torch.int32, "tfs")
    _require(dls, torch.int32, "dls")
    _require(w, torch.float32, "w")
    if norms is not None:
        _require(norms, torch.int32, "norms")
    out = torch.empty_like(w)
    _build.check(_build.load("bm25").contrib_flat(
        _ptr(tfs), _ptr(dls), _ptr(w), _ptr(norms), tfs.numel(),
        SCORERS[scorer], k1, b, _avg(avgdl), _ptr(out), _stream(w)),
        "contrib_flat")
    LAUNCHES.bump("contrib_flat")
    return out


# ------------------------------------------------------------ match_bitmap

def match_bitmap_plain(block_base, block_gaps, block_tfs8, row_idx,
                       raw_docs, raw_idx, tail_docs,
                       ndocs_pad: int) -> torch.Tensor:
    """Plain version of `match_bitmap`: each plane's live docs set their
    slot; docs past the bitmap are dropped."""
    LAUNCHES.bump("match_bitmap.plain")
    out = torch.zeros(ndocs_pad, dtype=torch.bool, device=raw_docs.device)
    pdocs, _ = decode_rows_plain(block_base, block_gaps, block_tfs8,
                                 row_idx)
    for d in (pdocs.reshape(-1), raw_docs[raw_idx.long()].reshape(-1),
              tail_docs.reshape(-1)):
        d = d.long()
        out[d[(d >= 0) & (d < ndocs_pad)]] = True
    return out


def match_bitmap(block_base: torch.Tensor, block_gaps: torch.Tensor,
                 block_tfs8: torch.Tensor, row_idx: torch.Tensor,
                 raw_docs: torch.Tensor, raw_idx: torch.Tensor,
                 tail_docs: torch.Tensor, ndocs_pad: int) -> torch.Tensor:
    """bool[ndocs_pad]: True for every live doc of the packed rows
    `row_idx`, the raw rows `raw_idx` and the flat `tail_docs`."""
    args = (block_base, block_gaps, block_tfs8, row_idx, raw_docs, raw_idx,
            tail_docs)
    if not _is_cuda(*args):
        return match_bitmap_plain(*args, ndocs_pad)
    _require(block_base, torch.int32, "block_base")
    _require(block_gaps, torch.uint16, "block_gaps", 16)
    _require(block_tfs8, torch.uint8, "block_tfs8", 16)
    _require(raw_docs, torch.int32, "raw_docs", 16)
    for name, t in (("row_idx", row_idx), ("raw_idx", raw_idx),
                    ("tail_docs", tail_docs)):
        _require(t, torch.int32, name)
    # the kernel zeroes it
    out = torch.empty(ndocs_pad, dtype=torch.bool, device=raw_docs.device)
    _build.check(_build.load("bm25").match_bitmap(
        _ptr(block_base), _ptr(block_gaps), _ptr(block_tfs8), _ptr(row_idx),
        row_idx.numel(), _ptr(raw_docs), _ptr(raw_idx), raw_idx.numel(),
        _ptr(tail_docs), tail_docs.numel(), ndocs_pad, _ptr(out),
        _stream(raw_docs)), "match_bitmap")
    LAUNCHES.bump("match_bitmap")
    return out


# ------------------------------------------------------------- build_dense

def saturation_plain(scorer: str, tf: torch.Tensor, dl: torch.Tensor,
                     k1: float, b: float, avg: float) -> torch.Tensor:
    if scorer == "tfidf":
        return _f64(torch.sqrt, tf)
    k1t, bt, avgt = (_f32(x).to(tf.device) for x in (k1, b, avg))
    alpha = k1t * (1.0 - bt + bt * dl / avgt)
    return (k1t + 1.0) * tf / torch.clamp(tf + alpha, min=1e-9)


def build_dense_plain(block_base, block_gaps, block_tfs8, pk_tid, raw_docs,
                      raw_tfs, raw_tid, light_docs, light_tfs, light_tid,
                      norms, ndocs_pad: int, v_pad: int, k1: float, b: float,
                      avgdl: float, scorer: str) -> torch.Tensor:
    """Plain version of `build_dense`: every valid posting's saturation
    set into its own cell of a zeroed (ndocs_pad, v_pad) matrix."""
    LAUNCHES.bump("build_dense.plain")
    dev = norms.device
    avg = _avg(avgdl)
    S = torch.zeros(ndocs_pad * v_pad, dtype=torch.float32, device=dev)
    all_rows = torch.arange(block_base.shape[0], dtype=torch.int32,
                            device=dev)
    pdocs, ptfs = decode_rows_plain(block_base, block_gaps, block_tfs8,
                                    all_rows)
    for docs, tfs, tid in ((pdocs, ptfs, pk_tid[:, None].expand_as(pdocs)),
                           (raw_docs, raw_tfs,
                            raw_tid[:, None].expand_as(raw_docs)),
                           (light_docs, light_tfs, light_tid)):
        sel = (docs >= 0) & (tfs > 0)
        d = docs[sel].long()
        sat = saturation_plain(scorer, tfs[sel].to(torch.float32),
                               norms[d].to(torch.float32), k1, b, avg)
        S[d * v_pad + tid[sel].long()] = sat
    return S.view(ndocs_pad, v_pad)


def build_dense(block_base, block_gaps, block_tfs8, pk_tid, raw_docs,
                raw_tfs, raw_tid, light_docs, light_tfs, light_tid, norms,
                ndocs_pad: int, v_pad: int, k1: float, b: float,
                avgdl: float, scorer: str) -> torch.Tensor:
    """(ndocs_pad, v_pad) f32 saturation matrix S[doc, term]. Three
    launches: packed rows, raw rows, light tails."""
    args = (block_base, block_gaps, block_tfs8, pk_tid, raw_docs, raw_tfs,
            raw_tid, light_docs, light_tfs, light_tid, norms)
    if not _is_cuda(*args):
        return build_dense_plain(*args, ndocs_pad, v_pad, k1, b, avgdl,
                                 scorer)
    _require(block_base, torch.int32, "block_base")
    _require(block_gaps, torch.uint16, "block_gaps", 16)
    _require(block_tfs8, torch.uint8, "block_tfs8", 16)
    _require(raw_docs, torch.int32, "raw_docs", 16)
    _require(raw_tfs, torch.int32, "raw_tfs", 16)
    for name, t in (("pk_tid", pk_tid), ("raw_tid", raw_tid),
                    ("light_docs", light_docs), ("light_tfs", light_tfs),
                    ("light_tid", light_tid), ("norms", norms)):
        _require(t, torch.int32, name)
    if pk_tid.numel() != block_base.numel() or \
            raw_tid.numel() != raw_docs.shape[0]:
        raise ValueError("pk_tid/raw_tid must hold one term id per row")
    lib = _build.load("bm25")
    sc = SCORERS[scorer]
    avg = _avg(avgdl)
    S = torch.zeros((ndocs_pad, v_pad), dtype=torch.float32,
                    device=norms.device)
    stream = _stream(norms)
    _build.check(lib.build_dense_rows(
        1, _ptr(block_base), _ptr(block_gaps), _ptr(block_tfs8), None, None,
        _ptr(pk_tid), block_base.numel(), _ptr(norms), _ptr(S), v_pad, sc,
        k1, b, avg, stream), "build_dense (packed)")
    LAUNCHES.bump("build_dense")
    _build.check(lib.build_dense_rows(
        0, None, None, None, _ptr(raw_docs), _ptr(raw_tfs), _ptr(raw_tid),
        raw_docs.shape[0], _ptr(norms), _ptr(S), v_pad, sc, k1, b, avg,
        stream), "build_dense (raw)")
    LAUNCHES.bump("build_dense")
    _build.check(lib.build_dense_tail(
        _ptr(light_docs), _ptr(light_tfs), _ptr(light_tid),
        light_docs.numel(), _ptr(norms), _ptr(S), v_pad, sc, k1, b, avg,
        stream), "build_dense (tails)")
    LAUNCHES.bump("build_dense")
    return S


# --------------------------------------------------------------- topk_rows

def _masked(scores: torch.Tensor, hits: Optional[torch.Tensor],
            require: Optional[torch.Tensor]) -> torch.Tensor:
    """Scores with the conjunction mask applied and -0.0 made +0.0."""
    s = scores
    if hits is not None:
        need = require[:, None]
        thr = need.to(hits.dtype)
        s = torch.where((need <= 0) | (hits >= thr), s,
                        torch.zeros_like(s))
    return torch.where(s == 0, torch.zeros_like(s), s)


def _score_image(s: torch.Tensor) -> torch.Tensor:
    """The order-preserving u32 image of each f32 (in int64): the float
    order, with a NaN placed by its sign bit, above +inf or below -inf —
    the order `lax.top_k` and the kernel's key give NaN."""
    u = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def topk_rows_plain(scores: torch.Tensor, k: int,
                    hits: Optional[torch.Tensor] = None,
                    require: Optional[torch.Tensor] = None,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `topk_rows`: a stable descending sort of the
    scores' images keeps equal scores in index order, so the first k are
    (score desc, index asc)."""
    LAUNCHES.bump("topk_rows.plain")
    s = _masked(scores, hits, require)
    order = torch.sort(_score_image(s), dim=1, descending=True,
                       stable=True).indices[:, :k]
    return (torch.gather(s, 1, order).contiguous(),
            order.to(torch.int32).contiguous())


def topk_rows(scores: torch.Tensor, k: int,
              hits: Optional[torch.Tensor] = None,
              require: Optional[torch.Tensor] = None,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of a (rows, n) f32 plane by (score desc, index asc) —
    the order `jax.lax.top_k` gives — after zeroing the scores whose row
    has require > 0 and hits < require. hits: int32 or float32 counts of
    the plane's shape, or None. Returns (vals (rows, k) f32, idx (rows, k)
    int32)."""
    if (hits is None) != (require is None):
        raise ValueError("hits and require go together")
    if scores.dim() != 2:
        raise ValueError("scores must be (rows, n)")
    rows, n = scores.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside 1..{n}")
    if not _is_cuda(scores, hits, require):
        return topk_rows_plain(scores, k, hits, require)
    _require(scores, torch.float32, "scores")
    hits_kind = 0
    if hits is not None:
        if hits.shape != scores.shape:
            raise ValueError("hits must have the shape of scores")
        hits_kind = {torch.int32: 1, torch.float32: 2}.get(hits.dtype)
        if hits_kind is None:
            raise TypeError(f"hits: int32 or float32, got {hits.dtype}")
        _require(hits, hits.dtype, "hits")
        _require(require, torch.int32, "require")
        if require.shape != (rows,):
            raise ValueError("require must hold one count per row")
    if rows == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=scores.device),
                torch.empty((0, k), dtype=torch.int32, device=scores.device))
    lib = _build.load("bm25")
    one = int(k <= TOPK_ONE_MAX)
    buf = torch.empty(lib.topk_bytes(rows, n, k, one), dtype=torch.uint8,
                      device=scores.device)
    _build.check(lib.topk_rows(
        _ptr(scores), rows, n, _ptr(hits), hits_kind, _ptr(require), k, one,
        _ptr(buf), _stream(scores)), "topk_rows")
    LAUNCHES.bump("topk_rows")
    m = rows * k * 4
    return (buf[:m].view(torch.float32).view(rows, k),
            buf[m:2 * m].view(torch.int32).view(rows, k))
