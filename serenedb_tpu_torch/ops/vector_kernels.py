"""Wrappers of the vector CUDA kernels (`csrc/vector.cu`) and their plain
PyTorch versions.

- `ivf_probe` ← serenedb_tpu/ops/vector.py `probe_program` (:204, with
  `dist_tail_expr` :75, `_chain_sum` :58 and `_merge_topk` :134): the
  nprobe nearest lists of each query, then the exact top-kkp by
  (distance asc, row asc) over the lanes of the probe grid. With one
  all-rows list it is the brute oracle (search/vector_store.py:454).
- `maxsim` ← `maxsim_program` (:272): per query and doc Σ_s max_t
  <q_s, x_t>, dims in tiles of `tile`; key = -score + 0.0; the same
  selection.
- `kmeans_assign` ← `_assign_program` (:187) and the argmin step of
  `_kmeans_program` (:157), given the x·cᵀ product.
- `kmeans_update` ← the centroid update of `_kmeans_program`: per-cluster
  sums in a fixed order (each cluster's rows in row order, in chunks of
  KMEANS_CHUNK, the chunk sums in order) and counts, then sum / count, the
  old centroid where count is 0.

The plain versions compute the same functions in the kernels' order: every
distance chain is a Python loop of separate `*` and `+` (elementwise over
the batch, so each step rounds to f32 as the kernel's does), the selection
a sort of the same unique 64-bit keys. Kernel and plain version agree bit
for bit. The CPU path runs them when the caller's tensors lie on the CPU;
on a CUDA tensor a wrapper launches its kernel or raises.

Each wrapper counts its launch in `device.LAUNCHES` (the plain versions
under `<name>.plain`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import errors
from ..device import LAUNCHES
from . import _build, select
from .agg_kernels import _is_cuda, _stream

#: row-id of dead lanes; the (+inf, _PAD_ROW) key sorts behind every row
PAD_ROW = (1 << 31) - 1
METRICS = {"l2": 0, "ip": 1, "cos": 2}
#: the smallest tile of the selection levels (csrc/vector.cu STAGE_FLOOR)
STAGE_FLOOR = 2048
#: the widest padded token row `maxsim` admits on the card (ROADMAP's
#: standing ruling on `vec_maxsim`'s width); the kernel itself streams any
#: width in dim slabs
MAXSIM_MAX_WIDTH = 50_687
#: the bytes of (doc lane, pair) maxima a `maxsim` call keeps at once: the
#: kernels run over ranges of lanes that fit it (at least MAXSIM_LANES)
MAXSIM_SCRATCH_BYTES = 256 << 20
MAXSIM_LANES = 32


def maxsim_scratch_lanes(nlanes: int, npairs: int) -> int:
    """The doc lanes whose (lane, pair) maxima `maxsim` keeps at once: as
    many whole groups of MAXSIM_LANES as MAXSIM_SCRATCH_BYTES holds (one
    group at least), and no more than the call's lanes."""
    lanes = MAXSIM_SCRATCH_BYTES // (npairs * 4)
    lanes = max(MAXSIM_LANES, lanes - lanes % MAXSIM_LANES)
    return min(lanes, max(nlanes, 1))


# -- the keys -----------------------------------------------------------------

def asc_image(v: torch.Tensor) -> torch.Tensor:
    """The ascending order-preserving u32 image (in int64) of f32 values:
    -0.0 ties +0.0, every NaN one value above +inf."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, torch.zeros_like(b), b)
    nan = ((b & 0x7F800000) == 0x7F800000) & ((b & 0x7FFFFF) != 0)
    b = torch.where(nan, torch.full_like(b, 0x7FC00000), b)
    return torch.where(b >= 0x80000000, (~b) & 0xFFFFFFFF, b | 0x80000000)


def _key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi << 32 | lo) less 2^63, so int64 order is the unsigned order."""
    return (hi - 2**31) * 2**32 + (lo.to(torch.int64) & 0xFFFFFFFF)


_DEAD = (0xFF800000 - 2**31) * 2**32 + PAD_ROW


def _unkey(keys: torch.Tensor):
    """(f32 values, i32 rows) of sorted keys, keys past the dead key
    written as the dead key (the reference's carry starts with K dead
    entries, so nothing behind them is ever selected)."""
    keys = torch.minimum(keys, torch.full_like(keys, _DEAD))
    hi = (keys >> 32) + 2**31
    lo = keys & 0xFFFFFFFF
    bits = torch.where(hi >= 0x80000000, hi & 0x7FFFFFFF, (~hi) & 0xFFFFFFFF)
    bits = bits - (bits >= 2**31).to(torch.int64) * 2**32   # as int32
    return bits.to(torch.int32).view(torch.float32), lo.to(torch.int32)


def _smallest(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest keys of each row, ascending (rows padded with the
    dead key when shorter than k)."""
    if keys.shape[1] < k:
        pad = torch.full((keys.shape[0], k - keys.shape[1]), _DEAD,
                         dtype=torch.int64, device=keys.device)
        keys = torch.cat([keys, pad], dim=1)
    return torch.sort(keys, dim=1).values[:, :k]


# -- the distance chain (plain) ----------------------------------------------

def dist_chain(x: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """`dist_tail_expr` over the last axis, then + 0.0: a left-to-right f32
    chain of separate products and sums."""
    d = x.shape[-1]
    if metric == "l2":
        dv = x - q
        acc = dv[..., 0] * dv[..., 0]
        for j in range(1, d):
            acc = acc + dv[..., j] * dv[..., j]
        return acc + 0.0
    if metric == "ip":
        acc = x[..., 0] * q[..., 0]
        for j in range(1, d):
            acc = acc + x[..., j] * q[..., j]
        return -acc + 0.0
    xx = x[..., 0] * x[..., 0]
    qq = q[..., 0] * q[..., 0]
    dot = x[..., 0] * q[..., 0]
    for j in range(1, d):
        xx = xx + x[..., j] * x[..., j]
        qq = qq + q[..., j] * q[..., j]
        dot = dot + x[..., j] * q[..., j]
    # sqrt and / taken in f64 and rounded once to f32: that is the
    # correctly rounded f32 result (53 >= 2 * 24 + 2 bits), whatever a
    # torch build's own f32 kernels round to
    nxq = _f64_round(torch.sqrt, xx) * _f64_round(torch.sqrt, qq)
    den = torch.maximum(nxq, torch.tensor(1e-9, dtype=torch.float32,
                                          device=x.device))
    return (1.0 - _f64_round(torch.div, dot, den)) + 0.0


def _f64_round(fn, *args) -> torch.Tensor:
    return fn(*(a.to(torch.float64) for a in args)).to(torch.float32)


# -- ivf_probe ----------------------------------------------------------------

def _check_probe(region, slotmap, offsets, counts, rowids, cents, queries,
                 tmap, jmap, metric, l_real, nprobe, kkp) -> None:
    if metric not in METRICS:
        raise ValueError(f"ivf_probe: metric {metric!r}")
    for name, t, dtype in (("region", region, torch.float32),
                           ("cents", cents, torch.float32),
                           ("queries", queries, torch.float32),
                           ("slotmap", slotmap, torch.int32),
                           ("offsets", offsets, torch.int32),
                           ("counts", counts, torch.int32),
                           ("rowids", rowids, torch.int32),
                           ("tmap", tmap, torch.int32),
                           ("jmap", jmap, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"ivf_probe: {name} must be contiguous {dtype}")
    dp = queries.shape[1]
    if cents.dim() != 2 or cents.shape[1] != dp or \
            offsets.shape != counts.shape or \
            offsets.shape[0] != cents.shape[0] or \
            region.numel() % dp or tmap.shape != jmap.shape:
        raise ValueError("ivf_probe: inconsistent shapes")
    if not 1 <= nprobe <= l_real <= cents.shape[0]:
        raise ValueError(f"ivf_probe: nprobe {nprobe}, l_real {l_real}, "
                         f"lists {cents.shape[0]}")
    if kkp < 1:
        raise ValueError(f"ivf_probe: kkp {kkp}")


def probe_lists_plain(cents, queries, metric: str, l_real: int,
                      nprobe: int) -> torch.Tensor:
    """The nprobe nearest lists of each query, in `lax.top_k(-d)` order:
    NaN first, then distance asc, list asc; lists >= l_real read +inf."""
    lp = cents.shape[0]
    qd = dist_chain(queries[:, None, :], cents[None, :, :], metric)
    lid = torch.arange(lp, device=cents.device)
    qd = torch.where(lid[None, :] < l_real, qd,
                     torch.tensor(float("inf"), device=cents.device))
    hi = torch.where(torch.isnan(qd), torch.zeros_like(qd, dtype=torch.int64),
                     asc_image(qd))
    keys = _key(hi, lid[None, :].expand(qd.shape))
    return (torch.sort(keys, dim=1).values[:, :nprobe] & 0xFFFFFFFF).to(
        torch.int64)


def ivf_probe_plain(region, slotmap, offsets, counts, rowids, cents, queries,
                    tmap, jmap, *, metric: str, l_real: int, nprobe: int,
                    kkp: int, lane_chunk: int = 0):
    """Plain version of `ivf_probe`. Lanes are scored `lane_chunk` at a time
    (the selection is exact, so the chunking never moves a bit)."""
    LAUNCHES.bump("ivf_probe.plain")
    _check_probe(region, slotmap, offsets, counts, rowids, cents, queries,
                 tmap, jmap, metric, l_real, nprobe, kkp)
    dp = queries.shape[1]
    rg = region.reshape(-1, dp)
    probe = probe_lists_plain(cents, queries, metric, l_real, nprobe)
    tm = tmap.reshape(-1).to(torch.int64)
    jm = jmap.reshape(-1).to(torch.int64)
    qp = queries.shape[0]
    if lane_chunk <= 0:
        lane_chunk = max(1, (1 << 26) // max(qp * dp, 1))
    best = torch.full((qp, 0), _DEAD, dtype=torch.int64,
                      device=queries.device)
    for a in range(0, tm.numel(), lane_chunk):
        t, j = tm[a:a + lane_chunk], jm[a:a + lane_chunk]
        cl = probe[:, t]                                     # (Q, L)
        live = j[None, :] < counts.to(torch.int64)[cl]
        pos = torch.where(live, offsets.to(torch.int64)[cl] + j[None, :], 0)
        slot = slotmap.to(torch.int64)[pos]
        d = dist_chain(rg[slot], queries[:, None, :], metric)
        keys = torch.where(live, _key(asc_image(d), rowids[pos]),
                           torch.full_like(pos, _DEAD))
        best = _smallest(torch.cat([best, keys], dim=1), kkp)
    return _unkey(_smallest(best, kkp))


#: kernels a call launches on the card while both of its stages are fused
#: (`probe_plan`): the main path's calls
PROBE_CALL_KERNELS = 2
#: csrc/vector.cu's probe blocks: rows a tile (and threads), the keys a
#: block keeps over two or more tiles, the keys one block merges, the
#: blocks a stage 2 group merges at most
PROBE_TILE = 128
PROBE_KEEP_MAX = 256
PROBE_MERGE_CAP = 4096
PROBE_GROUP = 32
#: stage 2's blocks a call, about: a query's blocks take its tiles in turn
PROBE_TARGET = 2048


def merge_span(nruns: int, run: int, k: int) -> int:
    """The most keys one of the two buffers of a block's merge holds, for
    nruns sorted runs of `run` keys merged pairwise, each cut to k
    (csrc/vector.cu `merge_span`)."""
    most = nruns * run
    while nruns > 1:
        nruns = (nruns + 1) // 2
        run = min(2 * run, k)
        most = max(most, nruns * run)
    return most


@dataclass(frozen=True)
class StagePlan:
    """One stage of `ivf_probe`: block j of `blocks` a query takes the
    query's tiles j, j + blocks, ... (at most `tpb`), keeping its `keep`
    smallest keys. Fused: one block merges them (stage 1), or the last
    block of each `group` merges its group's and the last group's merger
    the `groups` group runs (stage 2); else (one tile a block)
    select.cuh's levels take them."""
    fused: bool
    tpb: int
    keep: int
    group: int
    blocks: int
    groups: int


def stage_plan(n: int, k: int, qp: int) -> StagePlan:
    """The stage over n rows a query keeping k (csrc/vector.cu
    `stage_plan`). Stage 1 (qp 0): the fewest blocks whose keys one block
    merges. Stage 2: blocks enough for PROBE_TARGET a call (no more than
    the tiles), halved while the merges do not fit one block."""
    b = -(-max(n, 1) // PROBE_TILE)
    nb = min(-(-PROBE_TARGET // qp), b) if qp else b
    while True:
        tpb = -(-b // nb)
        keep = min(k, PROBE_TILE * tpb)
        if tpb > 1 and keep > PROBE_KEEP_MAX:
            break
        g, ng = nb, 1
        if qp:
            g = PROBE_GROUP
            while g > 1 and merge_span(g, keep, k) > PROBE_MERGE_CAP:
                g >>= 1
            g = min(g, nb)
            ng = -(-nb // g)
        if merge_span(g, keep, k) <= PROBE_MERGE_CAP and \
                merge_span(ng, k, k) <= PROBE_MERGE_CAP:
            return StagePlan(True, tpb, keep, g, nb, ng)
        if nb == 1:
            break
        nb = -(-nb // 2)
    return StagePlan(False, 1, min(k, PROBE_TILE), 1, b, 1)


@dataclass(frozen=True)
class ProbePlan:
    """A call's two stages, its scratch bytes and the kernels it
    launches."""
    lists: StagePlan
    rows: StagePlan
    bytes: int
    kernels: int


def _align16(b: int) -> int:
    return -(-b // 16) * 16


@functools.lru_cache(maxsize=512)
def probe_plan(qp: int, lp: int, nprobe: int, nlanes: int,
               kkp: int) -> ProbePlan:
    """The plan of an `ivf_probe` call (csrc/vector.cu `probe_layout`):
    stage 1 over the lp lists keeping nprobe, stage 2 over at most nlanes
    rows a query keeping kkp. Scratch: stage 1's candidates (the levels'
    first buffer when it is not fused), stage 2's, the levels' second
    buffer, the probe table when stage 1 takes the levels, stage 2's
    group runs and its tickets (a query's groups' and its own)."""
    s1 = stage_plan(lp, nprobe, 0)
    s2 = stage_plan(nlanes, kkp, qp)
    kernels = 2
    caps = []
    for st, k in ((s1, nprobe), (s2, kkp)):
        n = st.blocks * st.keep
        if st.fused:
            caps.append((qp * n, 0))
        else:
            caps.append(select.scratch(qp, n, st.keep, k, STAGE_FLOOR))
            # the levels, then the finishing kernel
            kernels += len(select.level_sizes(n, st.keep, k,
                                              STAGE_FLOOR)) - 1 + 1
    (a1, b1), (a2, b2) = caps
    table = 0 if s1.fused else qp * nprobe
    grp = qp * s2.groups * kkp if s2.fused and s2.groups > 1 else 0
    off = _align16(a1 * 8)
    off = _align16(off + a2 * 8)
    off = _align16(off + max(b1, b2) * 8)
    off = _align16(off + table * 4)
    off = _align16(off + ((table + qp) if table else 0) * 8)
    off = _align16(off + grp * 8)
    return ProbePlan(s1, s2, _align16(off + qp * (s2.groups + 1) * 4),
                     kernels)


def ivf_probe(region, slotmap, offsets, counts, rowids, cents, queries,
              tmap, jmap, *, metric: str, l_real: int, nprobe: int,
              kkp: int):
    """The exact top-kkp of each query over the lanes of the (nchunks, mc)
    probe grid of its nprobe nearest lists: region (pages, 4096) or
    (rows, dp) f32; slotmap, rowids (npos_pad,), offsets, counts (lp,),
    tmap, jmap (nchunks, mc) i32 (`ops.vector.chunk_maps` for this
    nprobe and an m at least every list's count, as the callers build
    them: the grid then holds each row of each probed list once); cents
    (lp, dp), queries (qp, dp) f32.
    Returns (distances (qp, kkp) f32, rows (qp, kkp) i32); dead lanes read
    (+inf, 2^31 - 1).

    On the card the kernels walk each probed list's rows and leave the
    maps unread (the grid's lanes bound a query's rows); one scratch
    buffer and one output buffer a call, `probe_plan(...).kernels`
    launches (PROBE_CALL_KERNELS on the main path), no copy in."""
    tensors = (region, slotmap, offsets, counts, rowids, cents, queries,
               tmap, jmap)
    if not all(t.is_cuda for t in tensors) and not _is_cuda(*tensors):
        return ivf_probe_plain(region, slotmap, offsets, counts, rowids, cents,
                               queries, tmap, jmap, metric=metric,
                               l_real=l_real, nprobe=nprobe, kkp=kkp)
    _check_probe(region, slotmap, offsets, counts, rowids, cents, queries,
                 tmap, jmap, metric, l_real, nprobe, kkp)
    qp, dp = queries.shape
    lp = cents.shape[0]
    nlanes = tmap.numel()
    plan = probe_plan(qp, lp, nprobe, nlanes, kkp)
    dev = queries.device
    buf = torch.empty(plan.bytes, dtype=torch.uint8, device=dev)
    out = torch.empty((2, qp, kkp), dtype=torch.int32, device=dev)
    dist, rows = out[0].view(torch.float32), out[1]
    lib = _build.load("vector")
    LAUNCHES.bump("ivf_probe")
    _build.check(lib.ivf_probe(
        region.data_ptr(), slotmap.data_ptr(), offsets.data_ptr(),
        counts.data_ptr(), rowids.data_ptr(), cents.data_ptr(),
        queries.data_ptr(), qp, dp, lp, l_real, nprobe, nlanes, kkp,
        METRICS[metric], buf.data_ptr(), plan.bytes, dist.data_ptr(),
        rows.data_ptr(), _stream(queries)), "ivf_probe")
    return dist, rows


# -- maxsim -------------------------------------------------------------------

def _check_maxsim(region, slotmap, offsets, counts, rowids, queries, dmap,
                  tile, kkp) -> None:
    for name, t, dtype in (("region", region, torch.float32),
                           ("queries", queries, torch.float32),
                           ("slotmap", slotmap, torch.int32),
                           ("offsets", offsets, torch.int32),
                           ("counts", counts, torch.int32),
                           ("rowids", rowids, torch.int32),
                           ("dmap", dmap, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"maxsim: {name} must be contiguous {dtype}")
    if queries.dim() != 3:
        raise ValueError("maxsim: queries (bp, sp, dp)")
    dp = queries.shape[2]
    if tile < 1 or dp % tile or region.numel() % dp or \
            offsets.shape != counts.shape or rowids.shape != counts.shape:
        raise ValueError("maxsim: inconsistent shapes")
    if kkp < 1:
        raise ValueError(f"maxsim: kkp {kkp}")


def maxsim_keys_plain(region, slotmap, offsets, counts, rowids, queries,
                      docs, *, tile: int, tcap: int) -> torch.Tensor:
    """The (bp, len(docs)) keys (-score + 0.0, row) of the given doc ids."""
    _bp, sp, dp = queries.shape
    rg = region.reshape(-1, dp)
    cnt = counts.to(torch.int64)[docs]                           # (D,)
    t = torch.arange(max(tcap, 1), device=queries.device)
    live = t[None, :] < cnt[:, None]                             # (D, T)
    pos = torch.where(live, offsets.to(torch.int64)[docs][:, None] + t, 0)
    x = rg[slotmap.to(torch.int64)[pos]]                         # (D, T, dp)
    xe = x[None, :, :, None, :]                                  # 1,D,T,1,dp
    qe = queries[:, None, None, :, :]                            # B,1,1,S,dp
    sim = torch.zeros((), dtype=torch.float32, device=queries.device)
    for i0 in range(0, dp, tile):
        part = xe[..., i0] * qe[..., i0]
        for d in range(i0 + 1, i0 + tile):
            part = part + xe[..., d] * qe[..., d]
        sim = sim + part                                         # B,D,T,S
    sim = torch.where(live[None, :, :, None], sim,
                      torch.tensor(float("-inf"), device=queries.device))
    if tcap == 0:
        m = torch.full(sim.shape[:2] + (sp,), float("-inf"),
                       device=queries.device)
    else:
        m = torch.amax(sim, dim=2)                               # B,D,S
    score = torch.zeros(m.shape[:2], dtype=torch.float32,
                        device=queries.device)
    for s in range(sp):
        score = score + m[..., s]
    key = -score + 0.0
    return _key(asc_image(key), rowids[docs][None, :].expand(key.shape))


def maxsim_plain(region, slotmap, offsets, counts, rowids, queries, dmap, *,
                 tile: int, tcap: int, kkp: int, doc_chunk: int = 0):
    """Plain version of `maxsim`, docs scored `doc_chunk` at a time."""
    LAUNCHES.bump("maxsim.plain")
    _check_maxsim(region, slotmap, offsets, counts, rowids, queries, dmap,
                  tile, kkp)
    bp, sp, dp = queries.shape
    docs = dmap.reshape(-1).to(torch.int64)
    if doc_chunk <= 0:
        doc_chunk = max(1, (1 << 25) // max(bp * sp * max(tcap, 1), 1))
    best = torch.full((bp, 0), _DEAD, dtype=torch.int64,
                      device=queries.device)
    for a in range(0, docs.numel(), doc_chunk):
        keys = maxsim_keys_plain(region, slotmap, offsets, counts, rowids,
                                 queries, docs[a:a + doc_chunk], tile=tile,
                                 tcap=tcap)
        best = _smallest(torch.cat([best, keys], dim=1), kkp)
    return _unkey(_smallest(best, kkp))


def maxsim(region, slotmap, offsets, counts, rowids, queries, dmap, *,
           tile: int, tcap: int, kkp: int):
    """The exact top-kkp docs of each query by MaxSim: queries (bp, sp,
    dp) f32 (zero token rows add exactly 0); dmap (nchunks, dc) i32 doc
    ids, pads naming a zero-count doc; rowids (lp,) each doc's row; tcap
    at least every doc's token count (the plain version pads docs to it;
    the kernel streams any number of tokens). Returns (keys = negated scores (bp,
    kkp) f32, rows (bp, kkp) i32); empty and pad docs read +inf."""
    tensors = [region, slotmap, offsets, counts, rowids, queries, dmap]
    if not _is_cuda(*tensors):
        return maxsim_plain(region, slotmap, offsets, counts, rowids, queries,
                            dmap, tile=tile, tcap=tcap, kkp=kkp)
    _check_maxsim(region, slotmap, offsets, counts, rowids, queries, dmap,
                  tile, kkp)
    bp, sp, dp = queries.shape
    if dp > MAXSIM_MAX_WIDTH:
        raise errors.unsupported(
            f"vec_maxsim on the card at width {dp} is not supported yet: "
            f"the widest token it takes is {MAXSIM_MAX_WIDTH} floats")
    nlanes = dmap.numel()
    cap_a, cap_b = select.scratch(bp, nlanes, 1, kkp, STAGE_FLOOR)
    dev = queries.device
    # the (doc lane, pair) maxima that the score kernel sums, for a range
    # of mlanes lanes at a time
    mlanes = maxsim_scratch_lanes(nlanes, bp * sp)
    maxima = torch.empty(mlanes * bp * sp, dtype=torch.float32, device=dev)
    keys = torch.empty(cap_a, dtype=torch.int64, device=dev)
    buf_b = torch.empty(cap_b, dtype=torch.int64, device=dev)
    out_k = torch.empty((bp, kkp), dtype=torch.float32, device=dev)
    out_r = torch.empty((bp, kkp), dtype=torch.int32, device=dev)
    lib = _build.load("vector")
    LAUNCHES.bump("maxsim")
    _build.check(lib.maxsim(
        region.data_ptr(), slotmap.data_ptr(), offsets.data_ptr(),
        counts.data_ptr(), rowids.data_ptr(), queries.data_ptr(),
        dmap.data_ptr(), nlanes, bp, sp, dp, tile, kkp, maxima.data_ptr(),
        mlanes, keys.data_ptr(),
        cap_a, buf_b.data_ptr(), cap_b, out_k.data_ptr(), out_r.data_ptr(),
        _stream(queries)), "maxsim")
    return out_k, out_r


# -- k-means ------------------------------------------------------------------

def _check_kmeans(x, c) -> None:
    for name, t in (("x", x), ("centroids", c)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"k-means: {name} must be contiguous (n, d) f32")
    if x.shape[1] != c.shape[1] or x.shape[0] < 1 or c.shape[0] < 1:
        raise ValueError("k-means: x and centroids differ in width")


def sq_norms_plain(a: torch.Tensor) -> torch.Tensor:
    acc = a[:, 0] * a[:, 0]
    for j in range(1, a.shape[1]):
        acc = acc + a[:, j] * a[:, j]
    return acc


def kmeans_assign_plain(x, c, xc) -> torch.Tensor:
    """Plain version of `kmeans_assign`."""
    LAUNCHES.bump("kmeans_assign.plain")
    _check_kmeans(x, c)
    d = (sq_norms_plain(x)[:, None] - 2.0 * xc) + sq_norms_plain(c)[None, :]
    # jnp.argmin: the first NaN, else the lowest index of the minimum
    nan = torch.isnan(d)
    first_nan = torch.argmax(nan.to(torch.int8), dim=1)
    k = d.shape[1]
    idx = torch.arange(k, device=d.device)
    dmin = torch.amin(torch.where(nan, torch.tensor(float("inf"),
                                                    device=d.device), d),
                      dim=1, keepdim=True)
    at_min = torch.where((d == dmin) & ~nan, idx[None, :],
                         torch.full_like(idx[None, :], k))
    best = torch.amin(at_min, dim=1)
    best = torch.where(best == k, torch.zeros_like(best), best)
    return torch.where(nan.any(dim=1), first_nan, best).to(torch.int32)


def kmeans_assign(x: torch.Tensor, c: torch.Tensor,
                  xc: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row, from xc = x·cᵀ (n, k): argmin of
    (‖x‖² − 2·xc) + ‖c‖², lowest index on ties, the first NaN winning.
    Returns (n,) i32."""
    if not _is_cuda(x, c, xc):
        return kmeans_assign_plain(x, c, xc)
    _check_kmeans(x, c)
    n, k = xc.shape
    if n != x.shape[0] or k != c.shape[0] or xc.dtype != torch.float32 or \
            not xc.is_contiguous():
        raise ValueError("kmeans_assign: xc must be contiguous (n, k) f32")
    dev = x.device
    x2 = torch.empty(n, dtype=torch.float32, device=dev)
    c2 = torch.empty(k, dtype=torch.float32, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _build.load("vector")
    LAUNCHES.bump("kmeans_assign")
    _build.check(lib.kmeans_assign(
        x.data_ptr(), c.data_ptr(), xc.data_ptr(), n, k, x.shape[1],
        x2.data_ptr(), c2.data_ptr(), out.data_ptr(), _stream(x)),
        "kmeans_assign")
    return out


#: sorted rows one chunk of `kmeans_update` sums (csrc/vector.cu KM_CHUNK).
#: The sums' bits depend on it, so both versions take it from here.
KMEANS_CHUNK = 128


def kmeans_update_plain(x, assign, c) -> torch.Tensor:
    """Plain version of `kmeans_update`, in the kernel's add order: each
    cluster's rows in row order, cut into chunks of KMEANS_CHUNK; a chunk
    sums its rows in order from +0.0; a cluster sums its chunk sums in
    chunk order."""
    LAUNCHES.bump("kmeans_update.plain")
    _check_kmeans(x, c)
    n, d = x.shape
    k = c.shape[0]
    C = KMEANS_CHUNK
    dev = x.device
    a64 = assign.to(torch.int64)
    order = torch.sort(a64, stable=True).indices
    cnt = torch.bincount(a64, minlength=k)[:k]
    start = torch.cumsum(cnt, 0) - cnt
    ca = a64[order]
    rank = torch.arange(n, device=dev) - start[ca]
    nch = (cnt + C - 1) // C
    cstart = torch.cumsum(nch, 0) - nch
    chunk = cstart[ca] + rank // C
    pos = rank % C
    part = torch.zeros((int(nch.sum()), d), dtype=torch.float32, device=dev)
    for j in range(C):
        at = pos == j
        if not bool(at.any()):
            break
        g = chunk[at]
        part[g] = part[g] + x[order[at]]
    s = torch.zeros((k, d), dtype=torch.float32, device=dev)
    for j in range(int(nch.max())):
        cl = torch.nonzero(nch > j).squeeze(1)
        s[cl] = s[cl] + part[cstart[cl] + j]
    new = _f64_round(torch.div, s,
                     torch.clamp(cnt, min=1).to(torch.float32)[:, None])
    return torch.where(cnt[:, None] > 0, new, c)


def kmeans_update(x: torch.Tensor, assign: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """New centroids from the assignment: per-cluster sums (chunks of
    KMEANS_CHUNK of the cluster's rows in row order, the chunk sums in
    order) over the count; the old centroid where a cluster is empty."""
    if not _is_cuda(x, assign, c):
        return kmeans_update_plain(x, assign, c)
    _check_kmeans(x, c)
    n, d = x.shape
    k = c.shape[0]
    if assign.dtype != torch.int32 or assign.shape != (n,) or \
            not assign.is_contiguous():
        raise ValueError("kmeans_update: assign must be contiguous (n,) i32")
    if n >= 2**31:
        raise ValueError("kmeans_update: more than 2^31 - 1 rows")
    dev = x.device
    lib = _build.load("vector")
    buf = torch.empty(lib.kmeans_bytes(n, k, d), dtype=torch.uint8,
                      device=dev)
    out = torch.empty((k, d), dtype=torch.float32, device=dev)
    LAUNCHES.bump("kmeans_update")
    _build.check(lib.kmeans_update(
        x.data_ptr(), assign.data_ptr(), c.data_ptr(), n, k, d,
        buf.data_ptr(), out.data_ptr(), _stream(x)), "kmeans_update")
    return out
