"""Wrapper of the posting-pool CUDA kernel (`csrc/pool.cu`) and its plain
PyTorch version.

`pool_score` ← serenedb_tpu/search/posting_pool.py `_pool_program` (full
mode: page-table gather → `contrib_expr` → per-lane accumulate in slice
order → exact (score desc, doc asc) top-k) and `_pool_partial_program`
(partial mode: the raw accumulator). On a CUDA tensor it launches the
kernel and counts the launch in `device.LAUNCHES` under `pool_score`; on a
CPU tensor it calls `pool_score_plain` (counted as `pool_score.plain`).
There is no other path: a build or launch failure raises.

The batch descriptor (search/posting_pool.py `_dispatch` builds it):
- `si` (qp, ep) int32: region slot of each kept posting, each query's
  entries in the slice order of the host ragged path;
- `w` (qp, ep) f32: the entry's term weight;
- `lane` (qp, ep) int32: the candidate lane the entry adds into;
- `soff` (qp, tp + 1) int32: slice t of query q is entries
  soff[q, t] .. soff[q, t + 1];
- `slice_max`: per slice index, the longest such slice of any query;
- full mode only: `cand` (qp, cp) int32 candidate docs (ascending, pads
  0x7FFFFFFF), `nc` (qp,) int32 live lanes, and `kk` <= cp.

Two regimes, a function of (cp, kk) alone (`pool_regime`, mirroring
csrc/pool.cu's two caps; the C entry refuses a disagreement). ROW, the
main path's: one launch, a cluster of blocks a query (its size chosen by
the C entry from the batch and the card), each holding its share of the
query's lanes in shared memory, the top-k selected in the cluster; the
call allocates its outputs only. LARGE, past the caps: a launch a slice
into a zeroed accumulator in device memory, then a key array and
select.cuh's levels.
"""

from __future__ import annotations

import torch

from ..device import LAUNCHES
from . import _build, select
from .bm25_kernels import (FLAT_SCORERS, SCORERS, _avg, _is_cuda, _ptr,
                           _require, _stream, contrib_plain)

#: doc-id sentinel of dead lanes (the reference's `_PAD_DOC`)
PAD_DOC = (1 << 31) - 1
#: smallest tile of the selection levels (csrc/pool.cu POOL_SORT_FLOOR)
POOL_SORT_FLOOR = 32
#: most queries one launch takes (CUDA grid y limit)
POOL_MAX_ROWS = 65535
#: the ROW regime's caps (csrc/pool.cu POOL_ROW_KK and POOL_ROW_LANES,
#: both from card timings): the most kk a row selects, and the most lanes
#: a row may have
POOL_ROW_KK = 32
POOL_ROW_LANES = 56_048
#: blocks a query in a ROW launch; 0 leaves the choice to the C entry
#: (csrc/pool.cu `row_cluster`). Card tests and scripts/pool_shapes.py
#: --sweep set 1, 2, 4 or 8.
ROW_CLUSTER = 0


def pool_regime(cp: int, kk: int) -> str:
    """The regime of a batch of cp lanes a row at kk (0: partial mode):
    "row" (one launch, a cluster of blocks a query) or "large" (a launch
    a slice, the accumulator and the keys in device memory)."""
    return "row" if 0 < cp <= POOL_ROW_LANES and 0 <= kk <= POOL_ROW_KK \
        else "large"


def _select_plain(acc: torch.Tensor, cand: torch.Tensor, nc: torch.Tensor,
                  kk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row the kk best lanes by (score desc, doc asc); dead lanes at
    -inf with the PAD_DOC sentinel, after every live lane."""
    cp = acc.shape[1]
    live = torch.arange(cp, device=acc.device)[None, :] < nc[:, None].long()
    sc = torch.where(live, acc, torch.full_like(acc, float("-inf")))
    sc = torch.where(sc == 0, torch.zeros_like(sc), sc)   # -0.0 as +0.0
    dk = torch.where(live, cand, torch.full_like(cand, PAD_DOC))
    by_doc = torch.sort(dk, dim=1, stable=True).indices
    order = torch.sort(torch.gather(sc, 1, by_doc), dim=1, descending=True,
                       stable=True).indices
    sel = torch.gather(by_doc, 1, order[:, :kk])
    return (torch.gather(sc, 1, sel).contiguous(),
            torch.gather(dk, 1, sel).contiguous())


def pool_score_plain(docs_pg, tfs_pg, norms, si, w, lane, soff, slice_max,
                     cp: int, k1: float, b: float, avgdl: float,
                     scorer: str, cand=None, nc=None, kk: int = 0):
    """Plain version of `pool_score`: slice t of every query at a time, in
    slice order, each lane added once a slice (no two entries of a slice
    share a lane)."""
    LAUNCHES.bump("pool_score.plain")
    qp, ep = si.shape
    tp = soff.shape[1] - 1
    avg = _avg(avgdl)
    acc = torch.zeros(qp * cp, dtype=torch.float32, device=si.device)
    pos = torch.arange(ep, device=si.device)[None, :]
    rows = torch.arange(qp, device=si.device)[:, None].expand(qp, ep)
    docs_flat, tfs_flat = docs_pg.reshape(-1), tfs_pg.reshape(-1)
    for t in range(tp):
        if slice_max[t] <= 0:
            continue
        m = (pos >= soff[:, t:t + 1].long()) & \
            (pos < soff[:, t + 1:t + 2].long())
        slot = si[m].long()
        d = docs_flat[slot].long()
        c = contrib_plain(scorer, tfs_flat[slot].to(torch.float32),
                          norms[d].to(torch.float32), w[m], k1, b, avg)
        cell = rows[m].long() * cp + lane[m].long()
        acc[cell] = acc[cell] + c
    acc = acc.view(qp, cp)
    if kk <= 0:
        return acc
    return _select_plain(acc, cand, nc, kk)


def pool_score(docs_pg: torch.Tensor, tfs_pg: torch.Tensor,
               norms: torch.Tensor, si: torch.Tensor, w: torch.Tensor,
               lane: torch.Tensor, soff: torch.Tensor, slice_max,
               cp: int, k1: float, b: float, avgdl: float,
               scorer: str = "bm25", cand=None, nc=None, kk: int = 0):
    """Score one batch descriptor over the paged region. kk > 0 (full
    mode): returns (vals (qp, kk) f32, docs (qp, kk) int32), each row by
    (score desc, doc asc); kk == 0 (partial mode): returns the (qp, cp)
    f32 accumulator. `slice_max` is a host sequence of tp ints."""
    if scorer not in FLAT_SCORERS:
        raise ValueError(f"pool_score takes {FLAT_SCORERS}, not {scorer!r}")
    qp, ep = si.shape
    tp = soff.shape[1] - 1
    if w.shape != si.shape or lane.shape != si.shape or \
            soff.shape[0] != qp or len(slice_max) != tp:
        raise ValueError("inconsistent pool descriptor shapes")
    full = kk > 0
    if full and (cand is None or nc is None or cand.shape != (qp, cp)
                 or nc.shape != (qp,) or kk > cp):
        raise ValueError("full mode needs cand (qp, cp), nc (qp,), kk <= cp")
    args = (docs_pg, tfs_pg, norms, si, w, lane, soff, cand, nc)
    if not _is_cuda(*args):
        return pool_score_plain(docs_pg, tfs_pg, norms, si, w, lane, soff,
                                slice_max, cp, k1, b, avgdl, scorer, cand,
                                nc, kk)
    if qp > POOL_MAX_ROWS:
        raise ValueError(f"pool_score takes at most {POOL_MAX_ROWS} queries")
    for name, t in (("docs_pg", docs_pg), ("tfs_pg", tfs_pg),
                    ("norms", norms), ("si", si), ("lane", lane),
                    ("soff", soff)):
        _require(t, torch.int32, name)
    _require(w, torch.float32, "w")
    dev = si.device
    if full:
        _require(cand, torch.int32, "cand")
        _require(nc, torch.int32, "nc")
    row = pool_regime(cp, kk if full else 0) == "row"
    vals = docs = acc = keys = buf_b = smax = None
    cap_a = cap_b = 0
    if full:
        vals = torch.empty((qp, kk), dtype=torch.float32, device=dev)
        docs = torch.empty((qp, kk), dtype=torch.int32, device=dev)
    if row:
        if not full:
            acc = torch.empty((qp, cp), dtype=torch.float32, device=dev)
    else:
        smax = torch.tensor([int(x) for x in slice_max], dtype=torch.int64)
        acc = torch.zeros((qp, cp), dtype=torch.float32, device=dev)
        if full:
            cap_a, cap_b = select.scratch(qp, cp, 1, kk, POOL_SORT_FLOOR)
            keys = torch.empty(cap_a, dtype=torch.int64, device=dev)
            buf_b = torch.empty(cap_b, dtype=torch.int64, device=dev)
    _build.check(_build.load("pool").pool_score(
        _ptr(docs_pg), _ptr(tfs_pg), _ptr(norms), _ptr(si), _ptr(w),
        _ptr(lane), _ptr(soff), None if smax is None else smax.data_ptr(),
        qp, ep, tp, cp, SCORERS[scorer], k1, b, _avg(avgdl), _ptr(acc),
        _ptr(cand), _ptr(nc), kk if full else 0, _ptr(keys), cap_a,
        _ptr(buf_b), cap_b, _ptr(vals), _ptr(docs), int(row), ROW_CLUSTER,
        _stream(si)), "pool_score")
    LAUNCHES.bump("pool_score")
    return (vals, docs) if full else acc
