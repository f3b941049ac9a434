#!/usr/bin/env python3
"""Drive the port's BM25 search, SQL analytics, top-N and fused-join paths
on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card: name, count, and `nvidia-smi` name and power limit;
  2. build the CUDA kernels with nvcc (one process per source, started
     together) and print the build seconds and ptxas register/spill lines;
  3. dense regime end to end: the `bm25` shape (100,000 docs, 2,000-term
     vocabulary, 256 queries, k=10) through SegmentSearcher.topk_batch,
     held to the port's cpu_topk_wand on a spanning sample;
  4. packed regime end to end: the `bm25_8m` shape (8,000,000 docs,
     200,000 terms, 120M sampled postings, 96 queries, k=10), same check,
     plus two consecutive calls that must agree bit for bit;
  5. each search kernel against its plain PyTorch version on the card, on
     the inputs the main path gave it in phases 3-4 (recorded as it ran),
     and topk_rows also on a plane full of ties: bm25_accumulate and
     build_dense within rtol 1e-5, atol 1e-6; topk_rows bit for bit;
  6. `q1` (bench.py's generator and three queries, seed 0) at 100,000,000
     rows through Database.execute: serene_device='cpu' (the host oracle),
     then 'gpu' cold and warm; the three must agree tuple for tuple and
     agg_scan must launch for every query; then three ORDER BY ... LIMIT
     queries on the same table (T1 unfiltered, T2 filtered with a
     projection and OFFSET, T3 at k = 8192) through topn_scan;
  7. `hits` (bench.py's generator and six queries, seed 3, 10,000,000
     rows): the same checks, over direct-coded, dictionary and
     host-factorized group keys, and T4 (ClickBench Q25's shape: a
     dictionary-string predicate, ORDER BY ... DESC LIMIT 10);
  8. float aggregates (10,000,000 rows, DOUBLE columns with NULLs and
     NaNs, 200 and ~1,000,000 groups, and no GROUP BY): 'gpu' within rel
     1e-4 / abs 1e-4 of 'cpu', NaN meeting NaN, two runs bit-identical,
     and agg_fold launched;
  9. joins at TPC-H SF1 cardinalities (seed 0: 150,000 customers,
     1,500,000 orders, ~6,000,000 lineitems, dbgen's distributions): J1
     a two-sided filtered join aggregate with exact sums and a DISTINCT
     grid, J2 the chained top-N over 10,001 group slots, J3 orders LEFT
     JOIN lineitem, J4 customer LEFT JOIN orders (TPC-H Q13's join: a
     third of the customers null-extend), J5 orders RIGHT JOIN customer
     (those customers reduce into the all-NULL group through
     join_unmatched); rows equal to the host path's
     cold and warm, agg_scan + join_probe (+ chain_topn for J2,
     join_unmatched for J5) launched,
     no fused decline, and J2's warm repeat uploads 0 bytes;
 10. agg_scan, agg_fold, topn_scan, chain_topn and join_probe against
     their plain versions on inputs recorded from phases 6-9 (integer
     outputs and selected indices equal, f32 within rtol 1e-5), with their
     times, bounds and torch yardsticks, and the two f32 GEMMs of
     dense_topk timed against their FLOP bound;
 11. one JSON line per kernel, the card line, then the device line.

Launch counts are zeroed just before each main-path phase and read just
after it; the comparisons of phases 5 and 10 run outside those windows.
The result cache is off in phases 6-9, so every statement executes, and
the device column cache's cap is raised to 32 GiB, as a deployment on an
80 GB card would set it. The script imports the port
(`serenedb_tpu_torch`) and neither JAX nor the JAX package; corpora and
tables are rebuilt here from seeds, as bench.py builds them.
"""

from __future__ import annotations

import json
import math
import struct
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12             # H100 SXM f32 rate outside the tensor cores
ATOL, RTOL = 1e-6, 1e-5       # kernel vs plain version, f32 scores
PARITY_RTOL, PARITY_ATOL = 2e-3, 1e-3   # device vs cpu_topk_wand (bench.py)
SQL_REL, SQL_ABS = 1e-4, 1e-4  # device vs host floats (test_device_agg.py)

REPLACES = {
    "bm25_accumulate": "serenedb_tpu/ops/bm25.py:627",
    "build_dense": "serenedb_tpu/ops/bm25.py:828",
    "topk_rows": "serenedb_tpu/ops/bm25.py:724",
    "agg_scan": "serenedb_tpu/exec/device_agg.py:251",
    "agg_fold": "serenedb_tpu/ops/agg.py:117",
    "topn_scan": "serenedb_tpu/exec/device_topn.py:111",
    "chain_topn": "serenedb_tpu/exec/device_pipeline.py:2810",
    "join_probe": "serenedb_tpu/exec/device_pipeline.py:1243",
}
SOURCES = {"bm25_accumulate": "serenedb_tpu_torch/ops/csrc/bm25.cu",
           "build_dense": "serenedb_tpu_torch/ops/csrc/bm25.cu",
           "topk_rows": "serenedb_tpu_torch/ops/csrc/bm25.cu",
           "agg_scan": "serenedb_tpu_torch/ops/csrc/agg.cu",
           "agg_fold": "serenedb_tpu_torch/ops/csrc/agg.cu",
           "topn_scan": "serenedb_tpu_torch/ops/csrc/topn.cu",
           "chain_topn": "serenedb_tpu_torch/ops/csrc/topn.cu",
           "join_probe": "serenedb_tpu_torch/ops/csrc/join.cu"}
#: the device column cache's cap in the SQL phases (MiB)
DEVICE_CACHE_MB = 32768

AGG, TOPN = ("agg_scan",), ("topn_scan",)
JOIN, CHAIN = ("agg_scan", "join_probe"), \
    ("agg_scan", "join_probe", "chain_topn")
OUTER_RIGHT = ("agg_scan", "join_probe", "join_unmatched")

Q1_QUERIES = [
    "SELECT count(*) FROM hits WHERE adv <> 0",
    "SELECT count(*), sum(x) FROM hits WHERE adv <> 0 AND x < 90000",
    "SELECT region, count(*), sum(x) FROM hits GROUP BY region",
]
Q1_TOPN = [
    # T1: unfiltered (device_topn)
    "SELECT * FROM hits ORDER BY x DESC LIMIT 10",
    # T2: filtered, a projection, OFFSET (the fused top-N)
    "SELECT region, x FROM hits WHERE adv = 1 AND region < 50 "
    "ORDER BY x LIMIT 100 OFFSET 10",
    # T3: k = MAX_TOPN_K
    "SELECT * FROM hits WHERE region = 7 ORDER BY x DESC LIMIT 8192",
]
HITS_TOPN = [
    # T4: ClickBench Q25's shape (ResolutionWidth for EventTime)
    "SELECT SearchPhrase, ResolutionWidth FROM hits "
    "WHERE SearchPhrase <> '' ORDER BY ResolutionWidth DESC LIMIT 10",
]
# the dates are untyped literals, which the binder coerces to DATE: the
# reference's device tier declines a typed DATE '...' literal
# (compile_expr: "string literal outside comparison"), and so does the port
TPCH_QUERIES = [
    # J1: predicates on both sides, exact sums past int32, a DISTINCT
    # grid of 12 x 16,384 cells
    "SELECT l_returnflag, l_linestatus, count(*), sum(l_quantity), "
    "sum(l_extendedprice), count(DISTINCT l_suppkey), min(o_orderdate), "
    "max(o_totalprice) FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
    "WHERE o_orderdate < '1995-03-15' AND l_shipdate > '1995-03-15' "
    "GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus",
    # J2: the chained top-N over 10,001 group slots, full of ties
    "SELECT l_suppkey, count(*) AS n, sum(l_quantity) FROM lineitem "
    "JOIN orders ON l_orderkey = o_orderkey WHERE o_orderdate >= "
    "'1996-01-01' GROUP BY l_suppkey ORDER BY n DESC LIMIT 10",
    # J3: LEFT join, 6.0M + 1.5M worst-case pairs
    "SELECT o_orderpriority, count(*), count(l_quantity), sum(l_quantity), "
    "max(l_extendedprice) FROM orders LEFT JOIN lineitem "
    "ON o_orderkey = l_orderkey GROUP BY o_orderpriority "
    "ORDER BY o_orderpriority",
    # J4: TPC-H Q13's join: customers without orders null-extend
    "SELECT c_mktsegment, count(*), count(o_orderkey), sum(o_totalprice), "
    "max(o_orderdate) FROM customer LEFT JOIN orders ON c_custkey = "
    "o_custkey GROUP BY c_mktsegment ORDER BY c_mktsegment",
    # J5: RIGHT join: the customers without orders (a third) reduce into
    # the all-NULL group, build-side aggregates included (join_unmatched)
    "SELECT o_orderpriority, count(*), count(o_orderkey), sum(o_totalprice), "
    "max(o_orderdate), count(c_custkey), max(c_custkey) FROM orders RIGHT "
    "JOIN customer ON o_custkey = c_custkey GROUP BY o_orderpriority "
    "ORDER BY o_orderpriority",
]
HITS_QUERIES = [
    # Q8: low-card direct-coded key
    "SELECT AdvEngineID, count(*) AS c FROM hits WHERE AdvEngineID <> 0 "
    "GROUP BY AdvEngineID ORDER BY c DESC, AdvEngineID",
    # Q10-shape (no distinct): region rollup
    "SELECT RegionID, sum(AdvEngineID), count(*) AS c, "
    "avg(ResolutionWidth) FROM hits GROUP BY RegionID "
    "ORDER BY c DESC, RegionID LIMIT 10",
    # Q13: dictionary string key
    "SELECT SearchPhrase, count(*) AS c FROM hits "
    "WHERE SearchPhrase <> '' GROUP BY SearchPhrase "
    "ORDER BY c DESC, SearchPhrase LIMIT 10",
    # Q15: composite key beyond the direct code space → factorize
    "SELECT SearchEngineID, SearchPhrase, count(*) AS c FROM hits "
    "WHERE SearchPhrase <> '' GROUP BY SearchEngineID, SearchPhrase "
    "ORDER BY c DESC, SearchEngineID, SearchPhrase LIMIT 10",
    # Q16: full-range int64 key → factorize
    "SELECT UserID, count(*) AS c FROM hits GROUP BY UserID "
    "ORDER BY c DESC, UserID LIMIT 10",
    # Q17: wide composite key → factorize
    "SELECT UserID, SearchPhrase, count(*) AS c FROM hits "
    "GROUP BY UserID, SearchPhrase ORDER BY c DESC, UserID, "
    "SearchPhrase LIMIT 10",
]
FLOAT_QUERIES = [
    "SELECT k, sum(f), avg(f), min(g), max(g) FROM fl GROUP BY k",
    "SELECT k2, sum(f), avg(f), min(g), max(g) FROM fl GROUP BY k2",
    "SELECT sum(f), avg(f), min(g), max(g), count(g) FROM fl",
]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ------------------------------------------------------------ the corpora

def dense_corpus(n_docs: int = 100_000, vocab_n: int = 2000, seed: int = 1):
    """The `bm25` shape (bench.py bench_bm25): zipf(1.3) over a 2,000-word
    vocabulary, docs of 8-40 tokens, and 128 single terms + 64
    disjunctions + 64 conjunctions."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(vocab_n)]
    zipf = rng.zipf(1.3, size=40 * n_docs) % len(vocab)
    lens = rng.integers(8, 40, n_docs)
    docs, pos = [], 0
    for ln in lens:
        docs.append(" ".join(vocab[z] for z in zipf[pos:pos + ln]))
        pos += ln
    idxs = [1 + 3 * i for i in range(128)]
    qterms = [vocab[i % vocab_n] for i in idxs]
    qs = (qterms + [f"{a} | {b}" for a, b in zip(qterms[:64],
                                                 qterms[64:][::-1])] +
          [f"{a} & {b}" for a, b in zip(qterms[1::2], qterms[::2])])
    return docs, qs


def synth_posting_index(n_docs: int, vocab: int, total_postings: int,
                        seed: int, device):
    """bench.py `_synth_posting_index`: a FieldIndex straight from a zipf
    document-frequency profile (no tokenization), tfs zipf(1.7) capped at
    64, norms the per-doc tf sums. The same arrays, except that the sorted
    unique of the 120M sampled (term, doc) keys runs on `device`
    (torch.unique gives np.unique's sorted result; np.unique took minutes
    on the card's host)."""
    import torch

    from serenedb_tpu_torch.search.segment import FieldIndex, _add_block_max

    rng = np.random.default_rng(seed)
    raw = 1.0 / np.arange(1, vocab + 1) ** 0.9
    df_target = np.maximum((raw / raw.sum() * total_postings), 1.0)
    df_target = np.minimum(df_target, n_docs * 0.8).astype(np.int64)
    terms_rep = np.repeat(np.arange(vocab, dtype=np.int64), df_target)
    docs_rnd = rng.integers(0, n_docs, len(terms_rep), dtype=np.int64)
    keys = terms_rep * n_docs + docs_rnd
    del terms_rep, docs_rnd
    # sorted by (term, doc); drops dup samples
    keys = torch.unique(torch.from_numpy(keys).to(device)).cpu().numpy()
    post_terms = (keys // n_docs).astype(np.int64)
    post_docs = (keys % n_docs).astype(np.int32)
    del keys
    post_tfs = np.minimum(rng.zipf(1.7, len(post_docs)), 64).astype(np.int32)
    doc_freq = np.bincount(post_terms, minlength=vocab).astype(np.int32)
    del post_terms
    offsets = np.zeros(vocab + 1, dtype=np.int64)
    np.cumsum(doc_freq, out=offsets[1:])
    norms = np.bincount(post_docs, weights=post_tfs,
                        minlength=n_docs).astype(np.int32)
    fi = FieldIndex(
        terms=np.asarray([f"w{i:07d}" for i in range(vocab)], dtype=object),
        doc_freq=doc_freq, offsets=offsets, post_docs=post_docs,
        post_tfs=post_tfs,
        pos_offsets=np.zeros(len(post_docs) + 1, dtype=np.int64),
        positions=np.empty(0, dtype=np.int32), norms=norms,
        block_max_tf=np.empty(0, dtype=np.int32),
        block_offsets=np.zeros(vocab + 1, dtype=np.int64),
        total_tokens=int(post_tfs.sum()))
    _add_block_max(fi)
    return fi


def packed_queries(n_single: int = 48) -> list[str]:
    """bench.py bench_bm25_8m's mix: 48 single terms, 24 disjunctions,
    24 conjunctions."""
    qterms = [f"w{1 + 97 * i:07d}" for i in range(n_single)]
    half = n_single // 2
    return (qterms + [f"{a} | {b}" for a, b in zip(qterms[:half],
                                                   qterms[half:][::-1])] +
            [f"{a} & {b}" for a, b in zip(qterms[1::2], qterms[::2])])


# ------------------------------------------------------------ measurement

def timed_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of fn() after one warm-up call, from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / reps


def nbytes(*ts) -> int:
    """Bytes of the distinct tensors among ts: a tensor passed twice (a
    column's mask that is also the row mask) is read once."""
    seen = {}
    for t in ts:
        if t is not None:
            key = (t.data_ptr(), t.numel() * t.element_size())
            seen[key] = key[1]
    return sum(seen.values())


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


class Recorder:
    """Wraps a kernel wrapper of ops/bm25_kernels.py so the main path's own
    arguments can be replayed against the plain version afterwards. It
    keeps the first call whose `pick` accepts the arguments."""

    def __init__(self, module, name: str, pick=lambda a, kw: True):
        self.module, self.name, self.pick = module, name, pick
        self.orig = getattr(module, name)
        self.args = None

    def __enter__(self):
        def wrapper(*args, **kw):
            if self.args is None and self.pick(args, kw):
                self.args = (args, kw)
            return self.orig(*args, **kw)
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def parity(searcher, nodes, out, step: int, k: int = 10) -> int:
    """bench.py's rule: on every step-th query, the device top-k holds the
    same number of results as cpu_topk_wand, scores agree within rtol 2e-3
    / atol 1e-3, and doc ids differ only where scores tie."""
    checked = 0
    for si in range(0, len(nodes), step):
        tids, req, _, _ = searcher._query_shape(nodes[si])
        ref_s, ref_d = searcher.cpu_topk_wand(tids, k, require_all=req)
        dev_s, dev_d = out[si]
        if len(dev_s) != min(k, len(ref_s)):
            fail(f"query {si}: {len(dev_s)} results, expected "
                 f"{min(k, len(ref_s))}")
        np.testing.assert_allclose(dev_s, ref_s[:len(dev_s)],
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL)
        for j, (dd, rd) in enumerate(zip(dev_d.tolist(), ref_d.tolist())):
            if dd != rd and abs(float(ref_s[j]) - float(dev_s[j])) >= 1e-3:
                fail(f"query {si} rank {j}: doc {dd} != {rd}")
        if not np.isfinite(dev_s).all():
            fail(f"query {si}: non-finite scores")
        checked += 1
    return checked


# ------------------------------------------------------------ the phases

def phase_dense(device, n_docs=100_000, reps=20) -> dict:
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.ops import bm25 as bm25_ops
    from serenedb_tpu_torch.ops import bm25_kernels as kern
    from serenedb_tpu_torch.search.analysis import get_analyzer
    from serenedb_tpu_torch.search.query import parse_query
    from serenedb_tpu_torch.search.searcher import SegmentSearcher
    from serenedb_tpu_torch.search.segment import build_field_index

    t0 = time.perf_counter()
    docs, qs = dense_corpus(n_docs)
    an = get_analyzer("simple")
    fi = build_field_index(docs, an)
    del docs
    build_s = time.perf_counter() - t0
    searcher = SegmentSearcher(fi, an, n_docs, device=device)
    nodes = [parse_query(q, an) for q in qs]
    store = searcher._device_store()
    if not bm25_ops.dense_fits(store.ndocs_pad, len(fi.doc_freq)):
        fail("the dense shape does not fit the dense budget")

    LAUNCHES.reset()
    with Recorder(kern, "build_dense") as rec_bd, \
            Recorder(kern, "topk_rows") as rec_tk, \
            Recorder(bm25_ops, "dense_topk") as rec_gemm:
        t0 = time.perf_counter()
        out = searcher.topk_batch(nodes, 10)          # cold: builds S
        sync(device)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            searcher.topk_batch(nodes, 10)
        sync(device)
        warm_s = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    for name in ("build_dense", "topk_rows"):
        if not launches.get(name):
            fail(f"dense phase: {name} never launched ({launches})")
    checked = parity(searcher, nodes, out, step=7)
    return {"qps": reps * len(nodes) / warm_s, "cold_s": cold_s,
            "index_build_s": build_s, "n_queries": len(nodes),
            "parity_checked": checked, "launches": launches,
            "ndocs_pad": store.ndocs_pad, "v_pad": int(
                (len(fi.doc_freq) + 127) // 128 * 128),
            "build_dense_args": rec_bd.args, "topk_args": rec_tk.args,
            "gemm_args": rec_gemm.args}


def phase_packed(device, n_docs=8_000_000, vocab=200_000,
                 postings=120_000_000, reps=3) -> dict:
    import torch

    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.ops import bm25 as bm25_ops
    from serenedb_tpu_torch.ops import bm25_kernels as kern
    from serenedb_tpu_torch.search.analysis import get_analyzer
    from serenedb_tpu_torch.search.query import parse_query
    from serenedb_tpu_torch.search.searcher import SegmentSearcher

    t0 = time.perf_counter()
    fi = synth_posting_index(n_docs, vocab, postings, seed=9, device=device)
    index_s = time.perf_counter() - t0
    an = get_analyzer("simple")
    searcher = SegmentSearcher(fi, an, n_docs, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    store = searcher._device_store()
    sync(device)
    store_s = time.perf_counter() - t0
    if bm25_ops.dense_fits(store.ndocs_pad, len(fi.doc_freq)):
        fail("the packed shape fits the dense budget")
    nodes = [parse_query(q, an) for q in packed_queries()]

    def with_hits(args, kw):
        return bool(args[21])        # with_hits: a conjunction chunk

    def masked(args, kw):
        return kw.get("hits") is not None

    LAUNCHES.reset()
    with Recorder(kern, "bm25_accumulate", with_hits) as rec_acc, \
            Recorder(kern, "topk_rows", masked) as rec_tk:
        t0 = time.perf_counter()
        out = searcher.topk_batch(nodes, 10)          # cold: WAND plans
        sync(device)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            again = searcher.topk_batch(nodes, 10)
        sync(device)
        warm_s = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    for name in ("bm25_accumulate", "topk_rows"):
        if not launches.get(name):
            fail(f"packed phase: {name} never launched ({launches})")
    for qi, ((s1, d1), (s2, d2)) in enumerate(zip(out, again)):
        if s1.tobytes() != s2.tobytes() or d1.tobytes() != d2.tobytes():
            fail(f"packed phase: query {qi} differs between two calls")
    checked = parity(searcher, nodes, out, step=6)
    peak = torch.cuda.max_memory_allocated(device)
    return {"qps": reps * len(nodes) / warm_s, "cold_s": cold_s,
            "index_build_s": index_s, "store_build_s": store_s,
            "n_queries": len(nodes), "parity_checked": checked,
            "launches": launches, "tile_bytes": store.hbm_bytes,
            "peak_bytes": peak, "ndocs_pad": store.ndocs_pad,
            "postings": int(len(fi.post_docs)),
            "acc_args": rec_acc.args, "topk_args": rec_tk.args}


def sync(device) -> None:
    import torch
    torch.cuda.synchronize(device)


def check_accumulate(device, args, reps=5) -> dict:
    """bm25_accumulate against its plain version on one main-path
    dispatch's inputs; two launches must agree bit for bit."""
    import torch

    from serenedb_tpu_torch.ops import bm25_kernels as kern
    a, kw = args
    got_s, got_h = kern.bm25_accumulate(*a, **kw)
    again_s, again_h = kern.bm25_accumulate(*a, **kw)
    ref_s, ref_h = kern.bm25_accumulate_plain(*a, **kw)
    sync(device)
    torch.testing.assert_close(got_s, ref_s, rtol=RTOL, atol=ATOL)
    if not torch.equal(got_h, ref_h):
        fail("bm25_accumulate: hit counts differ from the plain version")
    if not (torch.equal(got_s, again_s) and torch.equal(got_h, again_h)):
        fail("bm25_accumulate: two launches differ")
    err = float((got_s - ref_s).abs().max())
    ms = timed_ms(lambda: kern.bm25_accumulate(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: kern.bm25_accumulate_plain(*a, **kw), reps,
                        device)
    # bytes the function must move: the rows and tails it gathers, the
    # norms, and the planes it writes
    (block_base, block_gaps, block_tfs8, raw_docs, raw_tfs, norms, row_idx,
     row_w, row_qid, row_rank, raw_idx, raw_w, raw_qid, raw_rank, tail_docs,
     tail_tfs, tail_w, tail_qid, tail_rank) = a[:19]
    n_pk, n_raw = row_idx.numel(), raw_idx.numel()
    moved = (n_pk * (4 + 128 * 2 + 128) + n_raw * 128 * 8 +
             nbytes(row_idx, row_w, row_qid, row_rank, raw_idx, raw_w,
                    raw_qid, raw_rank, tail_docs, tail_tfs, tail_w,
                    tail_qid, tail_rank, norms, got_s, got_h))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": None,
            "shape": f"B={got_s.shape[0]} ndocs_pad={got_s.shape[1]} "
                     f"packed_rows={n_pk} raw_rows={n_raw} "
                     f"tail={tail_docs.numel()}"}


def check_build_dense(device, args, reps=3) -> dict:
    import torch

    from serenedb_tpu_torch.ops import bm25_kernels as kern
    a, kw = args
    got = kern.build_dense(*a, **kw)
    ref = kern.build_dense_plain(*a, **kw)
    sync(device)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    err = float((got - ref).abs().max())
    del ref
    ms = timed_ms(lambda: kern.build_dense(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: kern.build_dense_plain(*a, **kw), reps,
                        device)
    (block_base, block_gaps, block_tfs8, pk_tid, raw_docs, raw_tfs, raw_tid,
     light_docs, light_tfs, light_tid, norms) = a[:11]
    moved = nbytes(block_base, block_gaps, block_tfs8, pk_tid, raw_docs,
                   raw_tfs, raw_tid, light_docs, light_tfs, light_tid,
                   norms, got)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": None, "shape": f"S={tuple(got.shape)}"}


def check_topk(device, args, reps=5) -> dict:
    """topk_rows against its plain version bit for bit, torch.topk timed
    on the same plane as a yardstick (the port never calls it)."""
    import torch

    from serenedb_tpu_torch.ops import bm25_kernels as kern
    a, kw = args
    scores, k = a[0], a[1]
    hits, require = kw.get("hits"), kw.get("require")
    vals, idx = kern.topk_rows(scores, k, hits=hits, require=require)
    ref_v, ref_i = kern.topk_rows_plain(scores, k, hits=hits,
                                        require=require)
    sync(device)
    if not torch.equal(idx, ref_i) or \
            not torch.equal(vals.view(torch.int32), ref_v.view(torch.int32)):
        fail(f"topk_rows differs from its plain version at "
             f"{tuple(scores.shape)} k={k}")
    ms = timed_ms(lambda: kern.topk_rows(scores, k, hits=hits,
                                         require=require), reps, device)
    plain_ms = timed_ms(lambda: kern.topk_rows_plain(
        scores, k, hits=hits, require=require), reps, device)
    library_ms = timed_ms(lambda: torch.topk(scores, k, dim=1), reps, device)
    moved = nbytes(scores, hits, require, vals, idx)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"{tuple(scores.shape)} k={k} "
                     f"masked={hits is not None}"}


def check_topk_ties(device, rows: int, n: int) -> None:
    """topk_rows on planes full of ties (and -0.0), bit for bit."""
    import torch

    from serenedb_tpu_torch.ops import bm25_kernels as kern
    rng = np.random.default_rng(0)
    plane = rng.choice(np.float32([0.0, -0.0, 1.5, 3.25]), size=(rows, n))
    plane[0] = 0.0
    scores = torch.from_numpy(plane).to(device)
    for k in (10, 100, 1000):
        vals, idx = kern.topk_rows(scores, k)
        ref_v, ref_i = kern.topk_rows_plain(scores, k)
        sync(device)
        if not torch.equal(idx, ref_i) or not torch.equal(
                vals.view(torch.int32), ref_v.view(torch.int32)):
            fail(f"topk_rows differs on the tie plane at k={k}")


# ------------------------------------------------------------ analytics

def q1_columns(n: int) -> dict:
    """bench.py bench_q1's table (seed 0)."""
    from serenedb_tpu_torch.columnar.column import Column
    rng = np.random.default_rng(0)
    return {
        "adv": Column.from_numpy(
            rng.choice(np.array([0, 0, 0, 0, 1, 2, 3], dtype=np.int32), n)),
        "region": Column.from_numpy(rng.integers(0, 200, n).astype(np.int32)),
        "x": Column.from_numpy(
            rng.integers(0, 100000, n).astype(np.int32)),
    }


def hits_columns(n: int) -> dict:
    """bench.py bench_hits's table (seed 3): full-range int64 UserID with
    zipf user activity, skewed RegionID, mostly-zero AdvEngineID, mostly
    empty SearchPhrase, SearchEngineID, ResolutionWidth."""
    from serenedb_tpu_torch.columnar.column import Column
    rng = np.random.default_rng(3)
    n_users = 500_000
    user_hashes = rng.integers(0, 1 << 62, n_users, dtype=np.int64)
    uid = user_hashes[rng.zipf(1.4, n).astype(np.int64) % n_users]
    region = (rng.zipf(1.5, n) % 9000).astype(np.int32)
    adv = np.where(rng.random(n) < 0.96, 0,
                   rng.integers(1, 64, n)).astype(np.int32)
    n_phrases = 100_000
    phrase_pool = np.asarray([""] + [f"phrase {i}" for i in range(n_phrases)],
                             dtype=object)
    pid = np.where(rng.random(n) < 0.7, 0,
                   1 + rng.zipf(1.3, n) % n_phrases).astype(np.int64)
    seid = (rng.zipf(1.6, n) % 100).astype(np.int32)
    width = rng.integers(0, 4000, n).astype(np.int32)
    return {
        "UserID": Column.from_numpy(uid),
        "RegionID": Column.from_numpy(region),
        "AdvEngineID": Column.from_numpy(adv),
        "SearchPhrase": Column.from_numpy(phrase_pool[pid]),
        "SearchEngineID": Column.from_numpy(seid),
        "ResolutionWidth": Column.from_numpy(width),
    }


def float_columns(n: int) -> dict:
    """An int key of 200 groups, an int key over 0..999,999 (direct-coded,
    ~1M groups), `f` uniform in [0, 1000) and `g` normal with ~0.1% NaN,
    both DOUBLE with ~5% NULLs (seed 8)."""
    from serenedb_tpu_torch.columnar import dtypes as dt
    from serenedb_tpu_torch.columnar.column import Column
    rng = np.random.default_rng(8)
    g = rng.normal(size=n)
    g[rng.random(n) < 0.001] = np.nan
    return {
        "k": Column.from_numpy(rng.integers(0, 200, n).astype(np.int32)),
        "k2": Column.from_numpy(rng.integers(0, 1_000_000, n)
                                .astype(np.int32)),
        "f": Column(dt.DOUBLE, rng.random(n) * 1000, rng.random(n) > 0.05),
        "g": Column(dt.DOUBLE, g, rng.random(n) > 0.05),
    }


class FirstCalls:
    """Wraps a kernel wrapper and keeps the first call made under each
    value of `current` (set by the caller), for replay in phase 10."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.current = None
        self.calls: dict = {}

    def __enter__(self):
        def wrapper(*args, **kw):
            if self.current is not None and self.current not in self.calls:
                self.calls[self.current] = (args, kw)
            return self.orig(*args, **kw)
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _same_float(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= SQL_ABS + SQL_REL * abs(a)


def _bits(rows) -> list:
    """Rows with every float as its bit pattern (NaN, -0.0 kept apart)."""
    return [tuple(struct.pack("<d", v) if isinstance(v, float) else v
                  for v in r) for r in rows]


#: the kernel wrappers whose first main-path call per query is recorded
RECORDED = (("agg", "agg_scan"), ("agg", "agg_fold"), ("topn", "topn_scan"),
            ("topn", "chain_topn"), ("join", "join_probe"))


def phase_sql(device, label: str, tables: dict, queries: list,
              exact: bool, runs: int = 2) -> dict:
    """Tables through Database.execute: the host oracle
    (serene_device='cpu'), then `runs` device runs ('gpu'; the first is
    cold). queries: (sql, kernels that must launch for it). exact: cpu ==
    every device run tuple for tuple (bench.py's rule); else floats within
    SQL_REL/SQL_ABS of cpu and the device runs bit-identical to each
    other. No fused-tier decline may be counted during the device runs."""
    import torch

    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES, UPLOADS
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.obs import device as obs_device
    from serenedb_tpu_torch.ops import agg_kernels, join_kernels, \
        topn_kernels
    modules = {"agg": agg_kernels, "topn": topn_kernels,
               "join": join_kernels}

    db = Database(device=device)
    c = db.connect()
    c.execute("SET serene_result_cache = off")
    provs = []
    for name, columns in tables.items():
        t = MemTable(name, Batch.from_pydict(columns))
        db.schemas["main"].tables[name] = t
        provs.append(t)
    c.execute("SET serene_device = 'cpu'")
    t0 = time.perf_counter()
    cpu, cpu_ms = [], []
    for q, _k in queries:
        tq = time.perf_counter()
        cpu.append(c.execute(q).rows())
        cpu_ms.append((time.perf_counter() - tq) * 1e3)
    cpu_s = time.perf_counter() - t0

    c.execute("SET serene_device = 'gpu'")
    torch.cuda.reset_peak_memory_stats(device)
    declines0 = obs_device.fused_declines()
    LAUNCHES.reset()
    dev_runs, run_s, per_query_ms, up_bytes = [], [], [], []
    recs = [FirstCalls(modules[m], n) for m, n in RECORDED]
    for rec in recs:
        rec.__enter__()
    try:
        for r in range(runs):
            out, ms, ups = [], [], []
            t0 = time.perf_counter()
            for qi, (q, kernels) in enumerate(queries):
                for rec in recs:
                    rec.current = (label, qi) if r == 0 else None
                before = {k: LAUNCHES.get(k) for k in kernels}
                up0 = UPLOADS.get("bytes")
                tq = time.perf_counter()
                out.append(c.execute(q).rows())
                sync(device)
                ms.append((time.perf_counter() - tq) * 1e3)
                ups.append(UPLOADS.get("bytes") - up0)
                for k in kernels:
                    if LAUNCHES.get(k) <= before[k]:
                        fail(f"{label}: {k} did not launch for {q!r}")
            run_s.append(time.perf_counter() - t0)
            dev_runs.append(out)
            per_query_ms.append(ms)
            up_bytes.append(ups)
    finally:
        for rec in recs:
            rec.__exit__()
    launches = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated(device)
    if obs_device.fused_declines() != declines0:
        fail(f"{label}: fused declines {declines0} -> "
             f"{obs_device.fused_declines()}")

    for qi, (q, _k) in enumerate(queries):
        for r, out in enumerate(dev_runs):
            got, ref = out[qi], cpu[qi]
            if exact:
                if got != ref:
                    fail(f"{label}: device run {r} differs from the host "
                         f"path on {q!r}")
                continue
            if len(got) != len(ref):
                fail(f"{label}: {len(got)} rows, host {len(ref)}: {q!r}")
            for rg, rr in zip(got, ref):
                for a, b in zip(rr, rg):
                    ok = _same_float(a, b) if isinstance(a, float) or \
                        isinstance(b, float) else a == b
                    if not ok:
                        fail(f"{label}: {rg} vs host {rr} on {q!r}")
        if not exact and any(_bits(out[qi]) != _bits(dev_runs[0][qi])
                             for out in dev_runs[1:]):
            fail(f"{label}: two device runs differ on {q!r}")

    comp = raw = masks = 0
    for t in provs:
        for entry in getattr(t, "_device_cache", {}).values():
            dc = entry[1]
            comp += dc.data.numel() * dc.data.element_size()
            raw += dc.data.numel() * 4
            masks += dc.mask.numel()
    from serenedb_tpu_torch.exec.device_pipeline import DEVICE_CACHE
    calls = {rec.name: rec.calls for rec in recs}
    return {"cpu_s": cpu_s, "cpu_ms": cpu_ms, "cold_s": run_s[0],
            "warm_s": run_s[-1], "warm_ms": per_query_ms[-1],
            "cold_ms": per_query_ms[0], "warm_upload_bytes": up_bytes[-1],
            "cold_upload_bytes": up_bytes[0],
            "launches": launches, "peak_bytes": peak,
            "tile_bytes": comp, "tile_bytes_raw_int32": raw,
            "mask_bytes": masks,
            "fused_cache_bytes": DEVICE_CACHE.stats()["bytes"],
            "rows": {n: len(next(iter(cols.values())))
                     for n, cols in tables.items()},
            "calls": calls}


def _chunk_codes_values(args):
    """The group index and an int64 value per row of a recorded agg_scan
    launch, for the index_add_ yardstick: the factorized codes, the
    direct key plans' codes, or group 0; the first input column's
    decoded values (ones when there is none)."""
    import torch

    from serenedb_tpu_torch.ops import agg_kernels as K
    (spec, cols, rowmask, codes, t0, t1), _kw = args
    n = (t1 - t0) * 128
    dev = rowmask.device
    env = [(K.decode_plain(k, off, d[t0:t1].reshape(-1)),
            m[t0:t1].reshape(-1))
           for (d, m), k, off in zip(cols, spec.col_kinds, spec.col_offsets)]
    if spec.factorized:
        idx = codes[t0:t1].reshape(-1).to(torch.int64)
    else:
        idx = torch.zeros(n, dtype=torch.int64, device=dev)
        for kind, slot, lo, size in spec.keys:
            data, ok = env[slot]
            cc = data.to(torch.int64) - (lo if kind == K.KEY_INT else 0)
            cc = torch.where(ok, cc, torch.full_like(cc, size - 1))
            idx = idx * size + cc.clamp(0, size - 1)
    vals = env[0][0].to(torch.int64) if env and \
        env[0][0].dtype != torch.float32 else \
        torch.ones(n, dtype=torch.int64, device=dev)
    return idx.contiguous(), vals.contiguous(), spec.G


def _raw_tensors(raw) -> list:
    rowcount, outs = raw
    return [rowcount] + [t for o in outs for t in o]


def check_agg_scan(device, args, reps=10) -> dict:
    """agg_scan against its plain version on one recorded launch:
    integer outputs equal, f32 partial planes within rtol 1e-5; two
    launches bit-identical."""
    import torch

    from serenedb_tpu_torch.ops import agg_kernels as K
    a, kw = args
    got = _raw_tensors(K.agg_scan(*a, **kw))
    again = _raw_tensors(K.agg_scan(*a, **kw))
    ref = _raw_tensors(K.agg_scan_plain(*a, **kw))
    sync(device)
    err = 0.0
    for g, g2, r in zip(got, again, ref):
        if g.dtype == torch.float32:
            torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL,
                                       equal_nan=True)
            fin = torch.isfinite(r)
            if fin.any():
                err = max(err, float((g[fin] - r[fin]).abs().max()))
            if not torch.equal(g.view(torch.int32), g2.view(torch.int32)):
                fail("agg_scan: two launches differ")
        elif not (torch.equal(g, r) and torch.equal(g, g2)):
            fail(f"agg_scan differs from its plain version "
                 f"({g.dtype}, {tuple(g.shape)})")
    ms = timed_ms(lambda: K.agg_scan(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: K.agg_scan_plain(*a, **kw), 2, device)
    spec, cols, rowmask, codes, t0, t1 = a
    rows = (t1 - t0) * 128
    moved = nbytes(*[t[t0:t1] for pair in cols for t in pair],
                   rowmask[t0:t1],
                   codes[t0:t1] if spec.factorized else None, *got)
    idx, vals, G = _chunk_codes_values(args)

    def library():
        torch.zeros(G, dtype=torch.int64, device=device).index_add_(
            0, idx, vals)
    library_ms = timed_ms(library, reps, device)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"rows={rows} cols={len(cols)} G={spec.G} "
                     f"aggs={[x.kind for x in spec.aggs]} "
                     f"factorized={spec.factorized}"}


def check_agg_fold(device, args, reps=10) -> dict:
    """agg_fold against its plain version (both add p in order: equal)."""
    import torch

    from serenedb_tpu_torch.ops import agg_kernels as K
    a, kw = args
    plane, G = a[0], a[1]
    got = K.agg_fold(*a, **kw)
    ref = K.agg_fold_plain(*a, **kw)
    sync(device)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL,
                               equal_nan=True)
    fin = torch.isfinite(ref)
    err = float((got[fin] - ref[fin]).abs().max()) if fin.any() else 0.0
    ms = timed_ms(lambda: K.agg_fold(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: K.agg_fold_plain(*a, **kw), 1, device)
    library_ms = timed_ms(lambda: plane.view(-1, G).sum(0), reps, device)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes(plane, got)), "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"P={plane.numel() // G} G={G}"}


def _topn_keys(spec, cols, rowmask):
    """The transformed sort value of each row (sentinel where the mask
    or a predicate drops it), as topn_scan orders them: the input of the
    torch.topk yardstick."""
    import torch

    from serenedb_tpu_torch.ops import agg_kernels as K
    n = rowmask.numel()
    env = [(K.decode_plain(k, off, d.reshape(-1)), m.reshape(-1))
           for (d, m), k, off in zip(cols, spec.col_kinds,
                                     spec.col_offsets)]
    m = rowmask.reshape(-1).clone()
    for ops in spec.preds:
        v, ok = K.eval_plain(ops, env, n)
        m &= (v != 0) & ok
    v = env[spec.key_slot][0]
    if spec.is_float:
        kv = v if spec.desc else -v
        return torch.where(m, kv, torch.full_like(kv, -math.inf))
    kv = v if spec.desc else ~v
    return torch.where(m, kv, torch.full_like(kv, -2**31))


def check_topn(device, args, reps=10) -> dict:
    """topn_scan against its plain version: indices and survivor count
    equal; torch.topk on the same transformed keys timed beside it."""
    import torch

    from serenedb_tpu_torch.ops import topn_kernels as TK
    a, kw = args
    spec, cols, rowmask, k = a
    idx, nsurv = TK.topn_scan(*a, **kw)
    ref_idx, ref_n = TK.topn_scan_plain(*a, **kw)
    sync(device)
    if not (torch.equal(idx, ref_idx) and torch.equal(nsurv, ref_n)):
        fail(f"topn_scan differs from its plain version (k={k})")
    ms = timed_ms(lambda: TK.topn_scan(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: TK.topn_scan_plain(*a, **kw), 2, device)
    keys = _topn_keys(spec, cols, rowmask)
    library_ms = timed_ms(lambda: torch.topk(keys, k), reps, device)
    moved = nbytes(*[t for pair in cols for t in pair], rowmask, idx, nsurv)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"rows={rowmask.numel()} cols={len(cols)} k={k} "
                     f"preds={len(spec.preds)} survivors={int(ref_n[0])}"}


def check_chain(device, args, reps=10) -> dict:
    """chain_topn against its plain version: slots, present count and
    every gathered output equal; torch.topk on the slots' transformed
    values timed beside it."""
    import torch

    from serenedb_tpu_torch.ops import topn_kernels as TK
    a, kw = args
    rowcount, src, stride, size, desc, k, outs = a
    got = TK.chain_topn(*a, **kw)
    ref = TK.chain_topn_plain(*a, **kw)
    sync(device)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]) and
            all(torch.equal(x, y) for x, y in zip(got[2], ref[2]))):
        fail("chain_topn differs from its plain version")
    ms = timed_ms(lambda: TK.chain_topn(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: TK.chain_topn_plain(*a, **kw), 2, device)
    G = rowcount.numel()
    v = src.to(torch.int32) if src is not None else \
        ((torch.arange(G, device=device) // stride) % size).to(torch.int32)
    sv = torch.where(rowcount > 0, v if desc else ~v,
                     torch.full_like(v, -2**31))
    library_ms = timed_ms(lambda: torch.topk(sv, k), reps, device)
    # reads rowcount and src whole (src may be rowcount itself) and the k
    # picked rows of every other output; writes the slots, the count and
    # the picked rows
    whole = {t.data_ptr() for t in (rowcount, src) if t is not None}
    moved = nbytes(rowcount, src, got[0], got[1], *got[2]) + \
        sum(nbytes(p) for o, p in zip(outs, got[2])
            if o.data_ptr() not in whole)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"G={G} k_pad={k} outputs={len(outs)} "
                     f"present={int(ref[1][0])}"}


def check_join_probe(device, args, reps=10) -> dict:
    """join_probe against its plain version: every output equal;
    index_add_ of int64 values into the same group codes timed beside
    it."""
    import torch

    from serenedb_tpu_torch.ops import agg_kernels as K
    from serenedb_tpu_torch.ops import join_kernels as J
    a, kw = args
    spec, cols, rowmask, codes, cnt_code = a[:5]
    right = a[5] if len(a) > 5 else kw.get("right")
    got = J.join_probe(*a, **kw)
    ref = J.join_probe_plain(*a, **kw)
    sync(device)
    for g_, r_ in zip(_raw_tensors(got), _raw_tensors(ref)):
        if not torch.equal(g_, r_):
            fail(f"join_probe differs from its plain version "
                 f"({g_.dtype}, {tuple(g_.shape)})")
    ms = timed_ms(lambda: J.join_probe(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: J.join_probe_plain(*a, **kw), 2, device)
    n = rowmask.numel()
    env = [(K.decode_plain(k, off, d.reshape(-1)), m.reshape(-1))
           for (d, m), k, off in zip(cols, spec.col_kinds,
                                     spec.col_offsets)]
    gc = torch.zeros(n, dtype=torch.int64, device=device)
    for kind, slot, lo, size in spec.keys:
        data, ok = env[slot]
        cc = data.to(torch.int64) - (lo if kind == K.KEY_INT else 0)
        cc = torch.where(ok, cc, torch.full_like(cc, size - 1))
        gc = gc * size + cc.clamp(0, size - 1)
    vals = env[0][0].to(torch.int64) if env else \
        torch.ones(n, dtype=torch.int64, device=device)

    def library():
        torch.zeros(spec.G, dtype=torch.int64, device=device).index_add_(
            0, gc, vals)
    library_ms = timed_ms(library, reps, device)
    ins = [t for pair in cols for t in pair] + [rowmask, codes, cnt_code] + \
        [t for x in spec.aggs for t in x.src if t is not None]
    if right is not None:
        _u, bcols, brow, bcodes = right
        ins += [t for pair in bcols for t in pair] + [brow, bcodes]
    moved = nbytes(*ins, *_raw_tensors(got))
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"probe rows={n} G={spec.G} g={spec.g} "
                     f"entries={[x.kind for x in spec.aggs]} "
                     f"right={right is not None}"}


def time_dense_gemms(device, args, reps=5) -> dict:
    """The two f32 products of dense_topk (TF32 off) on the dense phase's
    S and W, against 2 x 2*B*V*nd FLOP at the f32 rate."""
    import torch
    a, kw = args
    S, W = a[0], a[1]
    Wi, Si = (W > 0).to(torch.float32), (S > 0).to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        score_ms = timed_ms(lambda: torch.matmul(W.t(), S.t()), reps, device)
        hits_ms = timed_ms(lambda: torch.matmul(Wi.t(), Si.t()), reps,
                           device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    flop = 2 * 2 * W.shape[1] * W.shape[0] * S.shape[0]
    return {"score_ms": score_ms, "hits_ms": hits_ms,
            "bound_ms": flop / F32_FLOPS * 1e3, "gflop": flop / 1e9,
            "shape": f"({W.shape[1]} x {W.shape[0]}) . ({S.shape[1]} x "
                     f"{S.shape[0]})"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a card",
              file=sys.stderr)
        return 2
    try:
        from serenedb_tpu_torch.bench.tpch import tpch_tables
        from serenedb_tpu_torch.device import resolve_device
        from serenedb_tpu_torch.ops import _build
    except ImportError as e:
        print(f"the port is not importable here: {e}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = resolve_device(None)

    # 1. the card
    card_name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"[1] device: {card_name} x{count}; nvidia-smi: {card}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[2] nvcc build: {time.perf_counter() - t0:.2f} s wall", flush=True)
    for lib, rec in logs.items():
        print(f"    {lib}: {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                print("    " + line.strip())

    # 3. dense regime
    dense = phase_dense(device)
    print(f"[3] dense: {dense['n_queries']} queries, QPS "
          f"{dense['qps']:.1f} (warm), cold first call "
          f"{dense['cold_s']:.3f} s, index build {dense['index_build_s']:.1f}"
          f" s, parity on {dense['parity_checked']} queries ok, launches "
          f"{dense['launches']}", flush=True)

    # 4. packed regime
    packed = phase_packed(device)
    print(f"[4] packed: {packed['n_queries']} queries over "
          f"{packed['postings']} postings, QPS {packed['qps']:.2f} (warm), "
          f"cold first call {packed['cold_s']:.2f} s, host index build "
          f"{packed['index_build_s']:.1f} s, block store build "
          f"{packed['store_build_s']:.1f} s, tiles "
          f"{packed['tile_bytes'] / 2**20:.1f} MiB, peak device memory "
          f"{packed['peak_bytes'] / 2**30:.2f} GiB, parity on "
          f"{packed['parity_checked']} queries ok, two calls bit-identical, "
          f"launches {packed['launches']}", flush=True)

    # 5. kernels against their plain versions on the main path's inputs
    if packed["acc_args"] is None or dense["build_dense_args"] is None or \
            dense["topk_args"] is None or packed["topk_args"] is None:
        fail("a kernel's main-path inputs were not recorded")
    results = {
        "bm25_accumulate": check_accumulate(device, packed.pop("acc_args")),
        "build_dense": check_build_dense(device,
                                         dense.pop("build_dense_args")),
        "topk_rows": check_topk(device, packed.pop("topk_args")),
    }
    dense_topk = check_topk(device, dense.pop("topk_args"))
    check_topk_ties(device, 16, packed["ndocs_pad"])
    for kname, r in results.items():
        print(f"[5] {kname} ({r['shape']}): kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms, "
              f"library {r['library_ms']}, max |err| {r['max_abs_err']:.3g}",
              flush=True)
    print(f"[5] topk_rows ({dense_topk['shape']}): kernel "
          f"{dense_topk['ms']:.3f} ms, plain {dense_topk['plain_ms']:.3f} ms,"
          f" bound {dense_topk['bound_ms']:.3f} ms, torch.topk "
          f"{dense_topk['library_ms']:.3f} ms; tie planes bit-exact",
          flush=True)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 6-9. the SQL paths through Database.execute
    from serenedb_tpu_torch.utils.config import REGISTRY as settings
    settings.set_global("serene_device_cache_mb", DEVICE_CACHE_MB)
    sql = {}
    for label, tables, queries, exact in (
            ("q1", lambda: {"hits": q1_columns(100_000_000)},
             [(q, AGG) for q in Q1_QUERIES] + [(q, TOPN) for q in Q1_TOPN],
             True),
            ("hits", lambda: {"hits": hits_columns(10_000_000)},
             [(q, AGG) for q in HITS_QUERIES] +
             [(q, TOPN) for q in HITS_TOPN], True),
            ("float", lambda: {"fl": float_columns(10_000_000)},
             [(q, AGG) for q in FLOAT_QUERIES], False),
            ("tpch", tpch_tables,
             [(q, {1: CHAIN, 4: OUTER_RIGHT}.get(qi, JOIN))
              for qi, q in enumerate(TPCH_QUERIES)], True)):
        t0 = time.perf_counter()
        cols = tables()
        gen_s = time.perf_counter() - t0
        r = phase_sql(device, label, cols, queries, exact)
        del cols
        r["gen_s"] = gen_s
        sql[label] = r
        phase = {"q1": 6, "hits": 7, "float": 8, "tpch": 9}[label]
        rule = "cpu == cold == warm" if exact else \
            f"within rel {SQL_REL} / abs {SQL_ABS} of cpu, runs bit-identical"
        print(f"[{phase}] {label}: rows {r['rows']} (generated in "
              f"{gen_s:.1f} s); cpu {r['cpu_s']:.3f} s, cold "
              f"{r['cold_s']:.3f} s, warm {r['warm_s']:.3f} s; cpu ms per "
              f"query {[round(x, 3) for x in r['cpu_ms']]}; warm ms "
              f"{[round(x, 3) for x in r['warm_ms']]}; cold ms "
              f"{[round(x, 3) for x in r['cold_ms']]}; uploaded bytes cold "
              f"{r['cold_upload_bytes']} warm {r['warm_upload_bytes']}; "
              f"tiles {r['tile_bytes']} B (raw int32 "
              f"{r['tile_bytes_raw_int32']} B, masks {r['mask_bytes']} B), "
              f"fused-tier cache {r['fused_cache_bytes']} B; peak device "
              f"memory {r['peak_bytes']} B; {rule}; every query's kernels "
              f"launched, no fused decline; launches {r['launches']}",
              flush=True)
    if not sql["float"]["launches"].get("agg_fold"):
        fail("float phase: agg_fold never launched")
    if sql["tpch"]["warm_upload_bytes"][1] != 0:
        fail(f"J2's warm repeat uploaded "
             f"{sql['tpch']['warm_upload_bytes'][1]} bytes")

    # 10. the analytics, top-N and join kernels against their plain versions
    calls = {}
    for r in sql.values():
        for wrapper, by_query in r.pop("calls").items():
            calls.setdefault(wrapper, {}).update(by_query)

    def recorded(wrapper, key, what):
        if key not in calls.get(wrapper, {}):
            fail(f"{wrapper}'s inputs for {what} were not recorded")
        return calls[wrapper][key]

    picks = {"q1 GROUP BY region": ("q1", 2), "hits Q16": ("hits", 4),
             "float GROUP BY k": ("float", 0),
             "float GROUP BY k2": ("float", 1), "float scalar": ("float", 2),
             "J1 build": ("tpch", 0)}
    checks = {}
    for what, key in picks.items():
        checks[what] = check_agg_scan(device,
                                      recorded("agg_scan", key, what))
    checks["agg_fold"] = check_agg_fold(
        device, recorded("agg_fold", ("float", 0), "float GROUP BY k"))
    checks["T1 topn_scan"] = check_topn(
        device, recorded("topn_scan", ("q1", 3), "T1"))
    checks["T2 topn_scan"] = check_topn(
        device, recorded("topn_scan", ("q1", 4), "T2"))
    checks["J2 chain_topn"] = check_chain(
        device, recorded("chain_topn", ("tpch", 1), "J2"))
    checks["J1 join_probe"] = check_join_probe(
        device, recorded("join_probe", ("tpch", 0), "J1"))
    checks["J4 join_probe"] = check_join_probe(
        device, recorded("join_probe", ("tpch", 3), "J4"))
    j5 = recorded("join_probe", ("tpch", 4), "J5")
    if (j5[0][5] if len(j5[0]) > 5 else j5[1].get("right")) is None:
        fail("J5 (RIGHT JOIN) did not reach join_unmatched")
    checks["J5 join_probe + join_unmatched"] = check_join_probe(device, j5)
    for what, r in checks.items():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"[10] {what} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms, "
              f"library {lib}, max |err| {r['max_abs_err']:.3g}",
              flush=True)
    if dense.get("gemm_args") is None:
        fail("dense_topk's inputs were not recorded")
    gemm = time_dense_gemms(device, dense.pop("gemm_args"))
    print(f"[10] dense_topk GEMMs {gemm['shape']}, TF32 off: scores "
          f"{gemm['score_ms']:.3f} ms, hits {gemm['hits_ms']:.3f} ms, bound "
          f"{gemm['bound_ms']:.3f} ms for both ({gemm['gflop']:.1f} GFLOP at "
          f"{F32_FLOPS / 1e12:.0f} TFLOP/s)", flush=True)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 11. result lines
    launches = {}
    for window in (dense["launches"], packed["launches"],
                   *(r["launches"] for r in sql.values())):
        for kname, n in window.items():
            launches[kname] = launches.get(kname, 0) + n
    results["agg_scan"] = checks["q1 GROUP BY region"]
    results["agg_fold"] = checks["agg_fold"]
    results["topn_scan"] = checks["T1 topn_scan"]
    results["chain_topn"] = checks["J2 chain_topn"]
    results["join_probe"] = checks["J1 join_probe"]
    kernels = []
    for kname, r in results.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches.get(kname, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
