#!/usr/bin/env python3
"""Drive the port's BM25 search, SQL analytics, top-N, fused-join, vector,
serving, sharded, durable and mesh paths on one CUDA card and check them.

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
     plus two consecutive calls that must agree bit for bit; then the
     same mix through topk_batch(ragged=True) with the posting pool on
     (65,536 pages inside the device cache's cap), bit-equal to the plane
     results, its QPS against the planes' as medians of three alternating
     passes; then every query alone on each route (pool, host ragged,
     planes, the ragged routes admitting every query), one line per
     route of (kept postings, ms);
  5. each search kernel against its plain PyTorch version on the card, on
     the inputs the main path gave it in phases 3-4 (recorded as it ran),
     and topk_rows also on a plane full of ties, an all-zero row and a
     row of NaNs in both of its regimes: bm25_accumulate and build_dense
     within rtol 1e-5, atol 1e-6; topk_rows bit for bit, at most 5
     kernels and no copy in a call, with its device ms by kernel;
  6. `q1` (bench.py's generator and three queries, seed 0) at 100,000,000
     rows through Database.execute: serene_device='cpu' (the host oracle),
     then 'gpu' cold and warm; the three must agree tuple for tuple and
     agg_scan must launch for every query; then three ORDER BY ... LIMIT
     queries on the same table (T1 unfiltered, T2 filtered with a
     projection and OFFSET, T3 at k = 8192) through topn_scan; then W1,
     a top-N whose filter is 12 deep (past the scan kernels' stack of 8:
     one scan_eval launch writes a derived tile, then topn_scan). In
     phases 6-9 every
     device run of every statement launches exactly `SQL_LAUNCHES`
     (those that fit one launch as before statements split), and no
     `.plain` version;
  7. `hits` (bench.py's generator and six queries, seed 3, 10,000,000
     rows): the same checks, over direct-coded, dictionary and
     host-factorized group keys, and T4 (ClickBench Q25's shape: a
     dictionary-string predicate, ORDER BY ... DESC LIMIT 10); then W2,
     ClickBench's queries.sql line 30 (90 sums: six agg_scan a chunk),
     and W3, a WHERE 12 deep under 17 sums (one scan_eval a chunk, its
     derived value read by its mask pass, and two agg_scan a chunk),
     each with its cpu, cold and warm ms;
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
     no fused decline, and J2's warm repeat uploads 0 bytes; then J6, a
     probe side of 18 aggregates under a probe predicate 12 deep (one
     scan_eval: a derived value and a mask pass; two join_probe);
 10. agg_scan, agg_fold, topn_scan (T1-T4), chain_topn (J2) and
     join_probe against their plain versions on inputs recorded from
     phases 6-9 (integer outputs and selected indices equal, agg_scan's
     and agg_fold's f32 outputs bit for bit), with their times, bounds
     and torch yardsticks; each top-N call's kernels and copies in
     counted at the end of the run from a captured CUDA graph (topn_scan
     at most 5 kernels and no copy, chain_topn one kernel under its
     one-block cap); join_probe
     (J1, J4, J5 with join_unmatched) bit for bit, a warm call exactly
     its init + probe (+ unmatched) kernels with no copy in (device ms by
     kernel), and returning at once behind ~25 ms of queued device work
     (no stream sync);
     agg_fold also on a seeded (8,192 x 201) plane; scan_eval on W1's
     prepare over q1's 100,000,768 rows, W3's over a 2,097,152-row chunk
     and J6's, every tile and the mask bit for bit, each whole call
     (timed_ms) and its device time (queued_ms) beside the bound and
     the parent's figures (its library time null: no one call runs an
     expression program); and
     the two f32 GEMMs of dense_topk timed against their FLOP bound;
 11. `sift`: IVF through SQL at sift-128-euclidean's shape (1,000,000 x
     128 integers in [0, 255] around a 16-dimensional subspace, from a
     seed, JSON text in a
     VARCHAR column): CREATE INDEX ... USING ivf WITH (lists = 1024) (8
     k-means iterations on the card), 64 `ORDER BY v <-> '[..]' LIMIT
     10` statements at nprobe 16 (the first cold), IvfIndex.search over
     1,024 queries at batch 1, 64 and 1,024; nprobe = 1024 equal bit for
     bit to the brute kernel and to host_dist's (distance, row)
     selection over all rows on 64 queries, recall@10 at nprobe 16 at
     least 0.3, two calls bit-identical, a warm statement uploading only
     its query block;
 12. `colbert`: MaxSim at ColBERTv2's widths (128-d unit tokens,
     passages of 32-180 tokens, queries of 32) over 50,000 passages
     (~5.3M tokens; cut from 100,000 to hold the script's time; built as
     a MaxSimIndex from the matrices: their JSON would be 0.7 billion
     numbers), batches of 16 queries; 4 queries
     against the f64 host oracle (rtol/atol 1e-5, rows equal but for
     near-ties); then 2,000 of the passages as JSON through CREATE INDEX
     ... USING maxsim and one vec_maxsim statement, against the same
     statement under serene_maxsim = off; and indexes of 300-token
     passages with every 7th a 1,030-token page, at 128 and 768 dims,
     against the f64 oracle (docs longer than one token tile);
 13. `bm25_sql`: the `bm25` shape's corpus (100,000 docs) through SQL:
     CREATE INDEX ... USING inverted (built by the native indexer, which
     the phase requires), the 256-query mix as @@ + bm25() statements,
     an INSERT of 10,000 docs (a second segment), the mix again; rows
     held to the port's host WAND (bench.py's rule);
 14. ivf_probe (nprobe 16 at batch 64 and at batch 1, and the brute
     layout; each call exactly its two kernels, lists then rows, and no
     copy in, device ms by kernel), maxsim (one 16-query batch, bit for
     bit and against a second launch, device ms by kernel, its bound at
     two FP32 instructions a multiply-add), kmeans_assign and
     kmeans_update (one
     k-means iteration, and
     the same rows with >= 90 % of them in one cluster) against their
     plain versions on inputs recorded from phases 11-12, bit for bit,
     with their times, bounds and yardsticks (kmeans_update: 4 kernels
     and no copy in a call, device ms by kernel); and ivf_probe
     on float data at 100,000 x 768 for l2, ip and cos, bit-equal to its
     plain version and to host_dist;
 15. `paged_search` (bench.py bench_paged_search): 1,000,000 docs, 30,000
     terms, 12M sampled postings (seed 7), 64 two-term disjunctions, k =
     10, at batches of 1, 8 and 64 with the posting pool on (pool_score),
     off (the host ragged path, contrib_flat) and ragged=False (the
     plane): every query bit-equal across the three, QPS per mode and
     batch; each group of 1, 8 and 64 queries on each route, one line
     per route and batch of (kept postings, ms); a warm repeat of the
     64-batch uploads 0 bytes and launches pool_score once; a starved
     budget of 64 pages stays bit-equal;
 16. serving: 200,000 docs from bench_bm25_1m's generator (cut from 1M
     for the script's time; still the packed regime; the index's
     tokenizer 'simple', as phase 13's) as an ES document table (`_id`,
     `_source`, `body`) with an inverted index (built by the native
     indexer, which the phase requires), behind one
     FrontDoor serving HTTP and the PG wire; one _msearch of 64 two-term
     match items cold, twice warm and once with the pool off, each item
     equal to its _search run serially with serene_search_batch = off, a
     mean coalesced batch above 1, pool_score and contrib_flat launched;
     one @@ statement over the PG wire equal to execute;
 17. the sharded tier (bench.py bench_multichip's shapes): its join
     (1,000,000 probe rows, 200,000 build rows, seed 53; and 10x that,
     the largest multiple the fused tier admits) at serene_shards 1/2/4 x
     serene_shard_combine host/device, cold and warm, rows equal to
     shards = 1 (and at 1x to the host path), a warm device combine one
     offload and one join_probe launch, a warm host combine one per
     shard; its search leg (4 segments of 250,000 docs, 16 two-term
     disjunctions, k = 10) through MultiSearcher.topk_batch and cpu_topk,
     bit-equal to shards = 1, merge_topk launched on every device-combine
     call, and each disjunction's match bitmap (match_bitmap) equal to
     eval_filter; and phase 13's table with two more INSERTs (4
     segments), its 256 statements at serene_shards = 4 under both
     combines, bit-equal;
 18. pool_score (full and partial mode) and contrib_flat (dl gathered
     from the resident norms) against their plain versions, bit for bit,
     on the 64-batch inputs recorded in phase 15 (checked as soon as
     phase 15 ends), with their times and bounds, and the host route's
     whole ragged_contribs call (one upload a call) beside contrib_flat;
     pool_score in both regimes: the recorded batch (ROW) and one
     synthetic query of 600,000 lanes (LARGE, bit-equal to the plain
     version), each with its device ms by kernel (torch.profiler, right
     after phase 15) and, last of all (after a graph capture no profiled
     window runs), its kernels a call and device ms a call from a
     captured CUDA graph (ROW: one kernel, no copy in, no memset);
 19. merge_topk (on phase 17's recorded 16-query merge and a crafted
     batch of ties, -0.0, pads and k past any shard's candidates; a call
     one kernel and no copy in, device ms; torch.topk over the same plane
     as its yardstick) and match_bitmap (on a recorded phase 17 launch,
     and on a disjunction of the packed corpus, an 8,000,512-doc bitmap;
     one launch a call, its kernel's device ms from torch.profiler)
     against their plain versions bit for bit, with their times and
     bounds; K12's one-card
     form: join_probe at phase 17's collective shape (4 shards, device
     combine, 1x) against its plain version, with its bound, an
     index_add_ yardstick and phase 10's launch and sync checks; the K13
     entries of ops/agg.py (masked count,
     sum, min/max, the one-hot chunk counts, group_count) on agg_scan
     against their plain versions on the card, bit for bit;
 20. the durable tier: phase 7's `hits` table (10,000,000 rows, seed 3)
     and phase 13's 100,000-doc corpus put into durable tables of a fresh
     data directory through SQL (CREATE TABLE, INSERT ... SELECT, VACUUM,
     CREATE INDEX ... USING inverted); close(), reopen on the card;
     INSERT 10,000 docs and 1,000 `hits` rows, acknowledged, then crash()
     (no flush) and reopen again. After each reopen: phase 7's six
     queries and T4 on 'gpu' equal to 'cpu' and to an in-memory database
     built from the same rows (agg_scan and topn_scan launched); every
     acknowledged row read back; the 256-query @@ + bm25() mix bit-equal
     to the in-memory database's and held to the host WAND. It prints
     the seconds of the write, the checkpoint, the close and each
     recovery, the directory's bytes and the native indexer's seconds;
     the native indexer must build every index here, as in phases 13 and
     16 (pyarrow is needed: the script fails without it);
 21. the device mesh: a 4-wide virtual mesh over the card (the host's
     cards where it has 4; torch.cuda.device_count() printed): phase 6's
     q1 (100M rows; its scalar and GROUP BY queries, T1) and phase 7's
     hits (T4) at serene_mesh = 4, rows equal to serene_mesh = 0 on the
     card, agg_scan once a shard a chunk with one mesh_combine launch a
     chunk and topn_scan once a shard; the packed corpus's 64
     require-free queries in batches of 16 through topk_batch(mesh_n =
     4), top-10 within rtol 2e-3 / atol 1e-3 of the single device (a
     shard's plane each, read where it lies by one mesh_combine: the
     combine step's ms and the batches' peak device memory printed);
     phase 17's join (1x) at shards 4 with the device
     combine over the mesh (a join_probe a mesh device) and its search
     merge at shards 4 (a merge_topk a mesh device and one over them),
     both equal to shards = 1; the reference's three builders
     (sharded_agg_step on q1's 100M-row column, sharded_bm25_topk on four
     terms' postings, sharded_query_step over all 120M postings) exact
     or within rtol 1e-5 / atol 1e-6 of a one-device mesh; then
     mesh_combine, mesh_agg_partials and mesh_score_blocks (its BM25 and
     its saturation call) against their plain versions bit for bit on
     recorded calls, with their times and byte bounds (mesh_combine's:
     every part read once, the output written once), and mesh_combine
     beside the library's stack.sum(0), amin(0) and amax(0) on the same
     parts stacked (a yardstick: they promise no shard order); the device
     count
     and the 'auto' combine restored;
 22. SQL over the PG wire: the port's PgServer (behind FrontDoor)
     serves card databases of phase 6, 7 and 9's tables, rebuilt from
     their seeds; q1's three queries and T1-T3, hits' six queries and T4
     and J1-J5 run in simple, extended text and extended binary mode
     (portal chunks of 65,536 rows), each statement's decoded rows equal
     to Connection.execute's on the same database and its kernels
     launched as often as in process; q1's GROUP BY region once as a
     prepared statement with a $1 predicate bound at Bind (whether the
     device tier took it printed); T3 and 1,000,000 streamed hits rows
     over extended binary in chunks; a CancelRequest during a chunked
     device aggregate on q1's table (57014, its latency, the next
     statement correct); COPY FROM STDIN in text and binary of 1,000,000
     hits rows (a cut for the run's time), hits' six queries over the
     wire on each equal to an in-process table of those rows;
 Last of all (no profiled window runs after a graph capture): phase
     10's top-N counts, and any call of phases 5-19 whose profiled
     windows never showed its kernels complete, from captured graphs
     (the kernels and copies in a call, held to the same counts); the
     recorded mesh calls' kernels, memsets and device ms from graphs
     (mesh_agg_partials one kernel, mesh_score_blocks at most three,
     neither a memset), with their scratch bytes;
 23. one JSON line per kernel, the card line, then the device line.

Launch counts are zeroed just before each main-path phase and read just
after it (phase 20 counts its durable database's launches only, not
the in-memory one it is held against; phase 21 zeroes them before each
of its mesh runs and sums what each read, so its single-device
comparisons stay out); the comparisons of phases 5, 10, 14, 18, 19 and
21 run outside those windows.
The result cache is off in phases 6-9 and 22, so every statement
executes, and the device column cache's cap is raised to 32 GiB, as a
deployment on an 80 GB card would set it. The script imports the port
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
#: FP32 instructions a second outside the tensor cores (132 SMs x 128
#: lanes x 1.98 GHz): the rate of a product and a sum kept apart, as
#: maxsim's -fmad=false build computes them
F32_INSTR = 132 * 128 * 1.98e9
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
    "ivf_probe": "serenedb_tpu/ops/vector.py:204",
    "maxsim": "serenedb_tpu/ops/vector.py:272",
    "kmeans_assign": "serenedb_tpu/ops/vector.py:187",
    "kmeans_update": "serenedb_tpu/ops/vector.py:157",
    "contrib_flat": "serenedb_tpu/ops/bm25.py:991",
    "pool_score": "serenedb_tpu/search/posting_pool.py:155",
    "merge_topk": "serenedb_tpu/search/searcher.py:1019",
    "match_bitmap": "serenedb_tpu/ops/bm25.py:1035",
    "mesh_combine": "serenedb_tpu/parallel/mesh.py:110",
    "mesh_agg_partials": "serenedb_tpu/parallel/mesh.py:188",
    "mesh_score_blocks": "serenedb_tpu/parallel/mesh.py:224",
    # no kernel of its own in the reference: XLA traces any expression
    # into K5/K6/K8's one program (compile_expr)
    "scan_eval": "serenedb_tpu/exec/device.py:60",
}
SOURCES = {"bm25_accumulate": "serenedb_tpu_torch/ops/csrc/bm25.cu",
           "build_dense": "serenedb_tpu_torch/ops/csrc/bm25.cu",
           "topk_rows": "serenedb_tpu_torch/ops/csrc/bm25.cu",
           "agg_scan": "serenedb_tpu_torch/ops/csrc/agg.cu",
           "agg_fold": "serenedb_tpu_torch/ops/csrc/agg.cu",
           "topn_scan": "serenedb_tpu_torch/ops/csrc/topn.cu",
           "chain_topn": "serenedb_tpu_torch/ops/csrc/topn.cu",
           "join_probe": "serenedb_tpu_torch/ops/csrc/join.cu",
           "ivf_probe": "serenedb_tpu_torch/ops/csrc/vector.cu",
           "maxsim": "serenedb_tpu_torch/ops/csrc/vector.cu",
           "kmeans_assign": "serenedb_tpu_torch/ops/csrc/vector.cu",
           "kmeans_update": "serenedb_tpu_torch/ops/csrc/vector.cu",
           "contrib_flat": "serenedb_tpu_torch/ops/csrc/bm25.cu",
           "pool_score": "serenedb_tpu_torch/ops/csrc/pool.cu",
           "merge_topk": "serenedb_tpu_torch/ops/csrc/merge.cu",
           "match_bitmap": "serenedb_tpu_torch/ops/csrc/bm25.cu",
           "mesh_combine": "serenedb_tpu_torch/ops/csrc/mesh.cu",
           "mesh_agg_partials": "serenedb_tpu_torch/ops/csrc/mesh.cu",
           "mesh_score_blocks": "serenedb_tpu_torch/ops/csrc/mesh.cu",
           "scan_eval": "serenedb_tpu_torch/ops/csrc/scan.cu"}
#: the device column cache's cap in the SQL phases (MiB)
DEVICE_CACHE_MB = 32768
#: the vector pool's pages in phases 11-12 (16 KiB each: 6.1 GiB, room for
#: the 1M x 128 SIFT corpus and the ColBERT region together)
VECTOR_PAGES = 400_000

AGG, TOPN = ("agg_scan",), ("topn_scan",)
JOIN, CHAIN = ("agg_scan", "join_probe"), \
    ("agg_scan", "join_probe", "chain_topn")
OUTER_RIGHT = ("agg_scan", "join_probe", "join_unmatched")
SPLIT = "scan_eval"


def rnest(terms, op: str = "+") -> str:
    """t0 op (t1 op (t2 ...)): a stack entry deeper a level."""
    out = terms[-1]
    for t in reversed(terms[:-1]):
        out = f"{t} {op} ({out})"
    return out

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
# statements past one scan launch, split across launches
# (exec/device_split.py), with the kernels each launches a chunk
Q1_WIDE = [
    # W1: a fused top-N whose filter is 12 deep (a scan_eval writing a
    # derived tile, then topn_scan)
    ("SELECT region, x FROM hits WHERE " +
     rnest(["x", "region", "adv"] * 4) + " > 399000 ORDER BY x DESC "
     "LIMIT 100", ("topn_scan", SPLIT)),
]
HITS_WIDE = [
    # W2: ClickBench's queries.sql line 30: 90 sums, six agg_scan a chunk
    ("SELECT " + ", ".join(["SUM(ResolutionWidth)"] + [
        f"SUM(ResolutionWidth + {i})" for i in range(1, 90)]) +
     " FROM hits;", AGG),
    # W3: a WHERE 12 deep under 17 sums (a scan_eval of a derived value
    # and a mask pass, two agg_scan a chunk)
    ("SELECT count(*), " + ", ".join(
        f"sum(ResolutionWidth + RegionID * {i})" for i in range(17)) +
     " FROM hits WHERE " + rnest(["RegionID", "AdvEngineID",
                                  "ResolutionWidth", "SearchEngineID"] * 3) +
     " > 3000", ("agg_scan", SPLIT)),
]
TPCH_WIDE = [
    # J6: a probe side of 18 aggregates and a probe predicate 12 deep (a
    # scan_eval of a derived value and a mask pass, two join_probe)
    ("SELECT l_returnflag, count(*), " + ", ".join(
        f"sum(l_quantity * {i + 1} + l_suppkey)" for i in range(9)) + ", " +
     ", ".join(f"max(l_extendedprice - l_quantity * {i})"
               for i in range(9)) +
     " FROM lineitem JOIN orders ON l_orderkey = o_orderkey WHERE " +
     rnest(["l_quantity", "l_suppkey", "l_extendedprice"] * 4) +
     " > 30000000 GROUP BY l_returnflag ORDER BY l_returnflag",
     ("agg_scan", "join_probe", SPLIT)),
]
#: per phase and query (each list, then its statements past one launch),
#: the launches of each device run by kernel: what the port launched
#: for the lists before statements split across launches (on an H100,
#: cold and warm alike), and for W1-W3 and J6 their split's launches a
#: chunk times the chunks (q1 48, hits and float 5, a join 1)
_AGG48, _AGG5, _TOPN = {"agg_scan": 48}, {"agg_scan": 5}, {"topn_scan": 1}
_JOIN = {"agg_scan": 1, "join_probe": 1}
SQL_LAUNCHES = {
    "q1": [_AGG48] * 3 + [_TOPN] * 3 + [{"topn_scan": 1, "scan_eval": 1}],
    "hits": [_AGG5] * 6 + [_TOPN] + [{"agg_scan": 30},
                                     {"agg_scan": 10, "scan_eval": 5}],
    "float": [{"agg_scan": 5, "agg_fold": 10}, _AGG5,
              {"agg_scan": 5, "agg_fold": 10}],
    "tpch": [_JOIN, dict(_JOIN, chain_topn=1), _JOIN, _JOIN,
             dict(_JOIN, join_unmatched=1),
             {"agg_scan": 1, "scan_eval": 1, "join_probe": 2}],
}
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


def queued_ms(fn, calls: int, device) -> float:
    """Device ms a call with the host's time kept out: a spin kernel holds
    the stream while the host queues `calls` calls between two CUDA
    events, so the events time the calls' kernels back to back (the
    wrapper must not synchronise). The spin is lengthened until it
    outlasts the host's queueing."""
    import torch
    fn()
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 21
    for _ in range(12):
        s0 = torch.cuda.Event(enable_timing=True)
        s0.record()
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize(device)
        if s0.elapsed_time(a) > 1.5 * host_ms:
            return a.elapsed_time(b) / calls
        cycles *= 2
    fail("queued_ms: the spin never outlasted the host's queueing")


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


def margin(session: int) -> None:
    """Idle host time at each end of a profiled window, growing with the
    session (2 ms, doubling to 0.2 s): a short window's device events can
    go missing from the profiler's results (a one-kernel call showed none
    in ten sessions late in a run, and one in each of ten when run alone),
    which an idle margin around the calls is meant to prevent."""
    time.sleep(min(0.002 * 2 ** session, 0.2))


#: calls whose kernels a call are read from captured CUDA graphs at the
#: end of the run, after the last profiled window (no profiled window
#: runs after a graph capture): (what, fn, ok(kernels, copies), want)
GRAPH_COUNTS = []


def count_by_graph(what: str, fn, ok, want: str) -> None:
    """Defers one call's count of kernels and copies in to `graph_counts`:
    a graph holds every launch, where torch.profiler can drop all of a
    short call's events late in a long run (chain_topn's one kernel once
    showed in none of ten profiled sessions)."""
    GRAPH_COUNTS.append((what, fn, ok, want))


def graph_counts() -> list:
    """The deferred counts: each call captured in a CUDA graph, its kernel
    and memcpy nodes held to its `ok`; fails where one is off. Returns
    (what, kernels, copies, device ms a call from graph replays)."""
    out = []
    for what, fn, ok, want in GRAPH_COUNTS:
        (kernels, copies, _), g = graph_nodes(fn)
        if not ok(kernels, copies):
            fail(f"{what} issued {kernels} kernels and {copies} copies "
                 f"(want {want}; graph nodes)")
        out.append((what, kernels, copies, graph_ms(g)))
        del g
    return out


#: the kernels one call launches, by wrapper (topk_rows in its one-read
#: regime, k <= TOPK_ONE_MAX)
TOPK_ONE_KERNELS = ("topk_pass0_kernel", "topk_take_kernel")
KMEANS_KERNELS = ("km_hist_kernel", "km_prefix_kernel", "km_scatter_kernel",
                  "km_chunk_kernel")
#: maxsim at the colbert batch (16 x 32 pairs, 50,048 lanes: one range of
#: the scratch), its selection two levels of tile_kernel
MAXSIM_KERNELS = {"maxsim_tiles_kernel": 1, "maxsim_score_kernel": 1,
                  "tile_kernel": 2, "keys_finish_kernel": 1}
#: ivf_probe on the main path (both stages fused: the lists, then the rows)
IVF_KERNELS = ("ivf_lists_kernel", "ivf_rows_kernel")
#: merge_topk up to its one-block cap: one kernel a call, by the lanes a
#: query (S * L) up to 32 and past it
MERGE_KERNELS = {True: ("merge_warp_kernel",), False: ("merge_block_kernel",)}


def launch_profile(fn, expect, calls: int = 5) -> tuple:
    """(host-to-device copies a call, device ms a call by kernel) of fn(),
    from torch.profiler over a window of `calls` calls after a warm-up
    call. `expect` names the kernels of one call (a tuple: once each; a
    dict: name -> launches a call). A window counts only where it shows
    each kernel of `expect` exactly that many times `calls` (the profiler
    can drop an event, never add one): the first of up to ten such
    windows gives the numbers. Fails on a kernel outside `expect`;
    None when no window is complete."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = {}
    for window in range(10):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            margin(window)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            margin(window)
        counts, ms, copies = {}, {}, 0
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA or \
                    ev.name.startswith("Memset"):
                continue
            if ev.name.startswith("Memcpy"):
                copies += "HtoD" in ev.name
                continue
            m = re.search(r"(\w+_kernel)", ev.name)
            name = m.group(1) if m else ev.name[:40]
            if name not in expect:
                fail(f"a call launched {name}, outside its kernels {expect}")
            t = getattr(ev, "device_time_total", 0) or \
                getattr(ev, "cuda_time_total", 0)
            counts[name] = counts.get(name, 0) + 1
            ms[name] = ms.get(name, 0.0) + t / 1e3 / calls
        per = expect if isinstance(expect, dict) else dict.fromkeys(expect, 1)
        if all(counts.get(name) == calls * n for name, n in per.items()):
            return copies / calls, ms
    return None


def activity_note(fn, expect) -> str:
    """A call's kernels, copies in and device ms by kernel, as a note;
    fails where the call launches other kernels than `expect` or copies
    anything in from the host. Where no profiled window is complete, the
    count of kernels and copies is left to a captured graph at the end of
    the run (`count_by_graph`) and the ms by kernel are not measured."""
    n = sum(expect.values()) if isinstance(expect, dict) else len(expect)
    got = launch_profile(fn, expect)
    if got is None:
        count_by_graph(f"a call of {', '.join(expect)}", fn,
                       lambda k, c: k == n and not c,
                       f"{n} kernels, no copy in")
        return (f"a call: {n} kernels, 0 copies in, checked at the end of "
                f"the run from a captured graph; device ms by kernel not "
                f"measured (no complete profiled window)")
    copies, by = got
    if copies:
        fail(f"a call made {copies} host-to-device copies (none allowed)")
    return (f"a call: {n} kernels, 0 copies in; device ms "
            + ", ".join(f"{k} {by[k]:.4f}" for k in expect)
            + f" (sum {sum(by.values()):.4f})")


class Recorder:
    """Wraps a kernel wrapper of ops/bm25_kernels.py so the main path's own
    arguments can be replayed against the plain version afterwards. It
    keeps the first call whose `pick` accepts the arguments."""

    def __init__(self, module, name: str, pick=lambda a, kw: True):
        self.module, self.name, self.pick = module, name, pick
        self.args = None

    def __enter__(self):
        # taken here, not in __init__: two recorders of one wrapper chain
        # (exit them in reverse order)
        self.orig = getattr(self.module, self.name)

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
    ragged = ragged_leg(device, searcher, nodes, out)
    return {"qps": reps * len(nodes) / warm_s, "cold_s": cold_s,
            "ragged": ragged,
            "index_build_s": index_s, "store_build_s": store_s,
            "n_queries": len(nodes), "parity_checked": checked,
            "launches": launches, "tile_bytes": store.hbm_bytes,
            "peak_bytes": peak, "ndocs_pad": store.ndocs_pad,
            "postings": int(len(fi.post_docs)),
            "acc_args": rec_acc.args, "topk_args": rec_tk.args,
            "searcher": searcher, "nodes": nodes}


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
    if k > kern.TOPK_ONE_MAX:
        fail(f"the main path's top-k (k={k}) left the one-read regime")
    note = activity_note(lambda: kern.topk_rows(
        scores, k, hits=hits, require=require), TOPK_ONE_KERNELS)
    # the hit plane is read only in the rows that have require > 0
    masked = int((require > 0).sum()) if hits is not None else 0
    moved = nbytes(scores, require, vals, idx)
    if masked:
        moved += masked * scores.shape[1] * hits.element_size()
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"{tuple(scores.shape)} k={k}, {masked} rows "
                     f"masked; {note}"}


def check_topk_ties(device, rows: int, n: int) -> None:
    """topk_rows on planes full of ties (and -0.0, an all-zero row and a
    row of positive and negative NaNs), in both regimes, bit for bit."""
    import torch

    from serenedb_tpu_torch.ops import bm25_kernels as kern
    rng = np.random.default_rng(0)
    plane = rng.choice(np.float32([0.0, -0.0, 1.5, 3.25]), size=(rows, n))
    plane[0] = 0.0
    plane[1, ::5] = np.nan
    plane[1, 2::5] = -np.nan  # below -inf, as lax.top_k orders it
    scores = torch.from_numpy(plane).to(device)
    # both regimes: k = TOPK_ONE_MAX + 1 takes the radix one
    for k in (10, 100, 1000, kern.TOPK_ONE_MAX + 1):
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
    value of `current` (set by the caller), for replay in phase 10; with
    `kind`, the first call of each kind(args) under it."""

    def __init__(self, module, name: str, kind=None):
        self.module, self.name, self.kind = module, name, kind
        self.orig = getattr(module, name)
        self.current = None
        self.calls: dict = {}

    def __enter__(self):
        def wrapper(*args, **kw):
            key = self.current
            if key is not None and self.kind is not None:
                key = key + (self.kind(args),)
            if key is not None and key not in self.calls:
                self.calls[key] = (args, kw)
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
            ("topn", "chain_topn"), ("join", "join_probe"),
            ("scan", "scan_eval"))


def phase_sql(device, label: str, tables: dict, queries: list,
              exact: bool, runs: int = 2, expect=None) -> dict:
    """Tables through Database.execute: the host oracle
    (serene_device='cpu'), then `runs` device runs ('gpu'; the first is
    cold). queries: (sql, kernels that must launch for it). exact: cpu ==
    every device run tuple for tuple (bench.py's rule); else floats within
    SQL_REL/SQL_ABS of cpu and the device runs bit-identical to each
    other. No fused-tier decline may be counted during the device runs.
    expect: per query the launches of each device run by kernel, which
    must be exactly these (no .plain launch is allowed in any case)."""
    import torch

    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES, UPLOADS
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.obs import device as obs_device
    from serenedb_tpu_torch.ops import agg_kernels, join_kernels, \
        scan_kernels, topn_kernels
    modules = {"agg": agg_kernels, "topn": topn_kernels,
               "join": join_kernels, "scan": scan_kernels}

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
    per_query_launches = []
    recs = [FirstCalls(modules[m], n) for m, n in RECORDED]
    for rec in recs:
        rec.__enter__()
    try:
        for r in range(runs):
            out, ms, ups, nl = [], [], [], []
            t0 = time.perf_counter()
            for qi, (q, kernels) in enumerate(queries):
                for rec in recs:
                    rec.current = (label, qi) if r == 0 else None
                before = LAUNCHES.snapshot()
                up0 = UPLOADS.get("bytes")
                tq = time.perf_counter()
                out.append(c.execute(q).rows())
                sync(device)
                ms.append((time.perf_counter() - tq) * 1e3)
                ups.append(UPLOADS.get("bytes") - up0)
                after = LAUNCHES.snapshot()
                delta = {k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)}
                nl.append(delta)
                for k in kernels:
                    if not delta.get(k):
                        fail(f"{label}: {k} did not launch for {q!r}")
                if any(k.endswith(".plain") for k in delta) or (
                        expect is not None and delta != expect[qi]):
                    fail(f"{label}: run {r} launched {delta} for {q!r}, "
                         f"not {None if expect is None else expect[qi]}")
            run_s.append(time.perf_counter() - t0)
            dev_runs.append(out)
            per_query_ms.append(ms)
            up_bytes.append(ups)
            per_query_launches.append(nl)
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
            "query_launches": per_query_launches,
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


def same_f32(a, b) -> bool:
    """Bit for bit, NaN meeting NaN (the card's NaN is canonical, a CPU
    keeps the payload)."""
    import torch
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def check_agg_scan(device, args, reps=10) -> dict:
    """agg_scan against its plain version on one recorded launch: every
    output equal, f32 partial planes and sums bit for bit; two launches
    bit-identical."""
    import torch

    from serenedb_tpu_torch.ops import agg_kernels as K
    a, kw = args
    got = _raw_tensors(K.agg_scan(*a, **kw))
    again = _raw_tensors(K.agg_scan(*a, **kw))
    ref = _raw_tensors(K.agg_scan_plain(*a, **kw))
    sync(device)
    for g, g2, r in zip(got, again, ref):
        if g.dtype == torch.float32:
            if not same_f32(g, r):
                fail(f"agg_scan's f32 sums differ from its plain version "
                     f"({tuple(g.shape)})")
            if not torch.equal(g.view(torch.int32), g2.view(torch.int32)):
                fail("agg_scan: two launches differ")
        elif not (torch.equal(g, r) and torch.equal(g, g2)):
            fail(f"agg_scan differs from its plain version "
                 f"({g.dtype}, {tuple(g.shape)})")
    err = 0.0
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
    sp = K.split(spec, rows)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"rows={rows} cols={len(cols)} G={spec.G} "
                     f"aggs={[x.kind for x in spec.aggs]} "
                     f"factorized={spec.factorized} regime={sp.regime} "
                     f"blocks={sp.blocks}"}


def check_agg_fold(device, args, reps=10) -> dict:
    """agg_fold against its plain version, bit for bit (NaN meeting NaN);
    `plane.view(P, G).sum(0)` timed beside it."""
    from serenedb_tpu_torch.ops import agg_kernels as K
    a, kw = args
    plane, G = a[0], a[1]
    got = K.agg_fold(*a, **kw)
    again = K.agg_fold(*a, **kw)
    ref = K.agg_fold_plain(*a, **kw)
    sync(device)
    if not same_f32(got, ref) or not same_f32(got, again):
        fail(f"agg_fold differs from its plain version or between two "
             f"launches (P={plane.numel() // G}, G={G})")
    ms = timed_ms(lambda: K.agg_fold(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: K.agg_fold_plain(*a, **kw), 1, device)
    library_ms = timed_ms(lambda: plane.view(-1, G).sum(0), reps, device)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes(plane, got)), "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"P={plane.numel() // G} G={G}"}


def fold_plane(device, P: int, G: int):
    """A seeded (P x G) f32 plane with NaN and -0.0 cells, as agg_fold's
    arguments."""
    import torch
    rng = np.random.default_rng(P + G)
    plane = (rng.standard_normal(P * G) * 100).astype(np.float32)
    plane[rng.random(P * G) < 1e-4] = np.nan
    plane[::977] = -0.0
    return ((torch.from_numpy(plane).to(device), G), {})


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


def check_topn(device, args, what, reps=10) -> dict:
    """topn_scan against its plain version: indices and survivor count
    equal; torch.topk on the same transformed keys timed beside it; its
    kernels a call (at most 5, no copy in) counted at the end of the run
    from a captured graph."""
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
    count_by_graph(f"{what} (k={k})", lambda: TK.topn_scan(*a, **kw),
                   lambda n, c: 1 <= n <= 5 and not c,
                   "1 to 5 kernels, no copy in")
    keys = _topn_keys(spec, cols, rowmask)
    library_ms = timed_ms(lambda: torch.topk(keys, k), reps, device)
    moved = nbytes(*[t for pair in cols for t in pair], rowmask, idx, nsurv)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": f"rows={rowmask.numel()} cols={len(cols)} k={k} "
                     f"preds={len(spec.preds)} survivors={int(ref_n[0])}"}


def check_chain(device, args, what, reps=100) -> dict:
    """chain_topn against its plain version: slots, present count and
    every gathered output equal; torch.topk on the slots' transformed
    values timed beside it. Both calls are tens of microseconds of host
    work: 100 calls each, so the host's jitter averages out. Its kernels
    a call (one under the one-block cap, no copy in) are counted at the
    end of the run from a captured graph."""
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
    one = G <= TK.CHAIN_ONE_MAX
    count_by_graph(f"{what} (G={G})", lambda: TK.chain_topn(*a, **kw),
                   lambda n, c: not c and (n == 1 if one else n >= 1),
                   ("1 kernel" if one else "kernels") + ", no copy in")
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
    # a warm call: init, probe (+ unmatched), no copy in; and no stream
    # sync: behind ~25 ms of queued device work the call returns at once
    regime = J.probe_regime(spec)
    expect = ("join_init_kernel", "join_small_kernel"
              if regime == J.REGIME_SMALL else "join_large_kernel") + \
        (("join_unmatched_kernel",) if right is not None else ())
    if len(expect) != J.CALL_LAUNCHES[right is not None]:
        fail("join_probe: the kernels a call launches and CALL_LAUNCHES "
             "disagree")
    note = activity_note(lambda: J.join_probe(*a, **kw), expect)
    sync(device)
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    J.join_probe(*a, **kw)
    busy_ms = (time.perf_counter() - t0) * 1e3
    sync(device)
    if busy_ms > 5.0:
        fail(f"join_probe waited {busy_ms:.2f} ms for the stream")
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
                     f"right={right is not None} regime "
                     f"{('SMALL', 'LARGE')[regime]}; {note}; host "
                     f"{busy_ms:.3f} ms behind queued work (no sync)"}


#: scan_eval's whole calls on the parent tree (PERF.md section 6, NVIDIA
#: H100 80GB HBM3 at 700.00 W): a derive and a mask pass a chunk, each a
#: launch of its own; W1's was not recorded
SCAN_PARENT = {"W1": "not recorded",
               "W3": "0.0933 ms derive + 0.0873 ms mask pass",
               "J6": "0.2151 ms derive + a mask pass not timed"}


def check_scan_eval(device, args, what: str, reps=10) -> dict:
    """scan_eval against its plain version on one recorded prepare: every
    stored tile (f32 bit for bit) and its validity, and the mask, equal;
    two launches equal. The whole call (timed_ms) and its device time
    (queued_ms). No one PyTorch call computes it (it runs expression
    programs), so library_ms is null."""
    import torch

    from serenedb_tpu_torch.ops import scan_kernels as S
    a, kw = args
    spec, cols, rowmask = a

    def flat(out):
        tiles, mask = out
        return [t for pair in tiles if pair is not None for t in pair] + \
            ([mask] if spec.preds else [])
    got, again, ref = (flat(o) for o in (
        S.scan_eval(*a, **kw), S.scan_eval(*a, **kw),
        S.scan_eval_plain(*a, **kw)))
    sync(device)
    for g, g2, r in zip(got, again, ref):
        same = same_f32 if g.dtype == torch.float32 else torch.equal
        if not (same(g, r) and same(g, g2)):
            fail(f"scan_eval differs from its plain version on {what} "
                 f"({g.dtype}, {tuple(g.shape)})")
    if len(got) != len(ref):
        fail(f"scan_eval: {len(got)} outputs on {what}, plain {len(ref)}")
    ms = timed_ms(lambda: S.scan_eval(*a, **kw), reps, device)
    device_ms = queued_ms(lambda: S.scan_eval(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: S.scan_eval_plain(*a, **kw), 2, device)
    moved = nbytes(*[t for pair in cols for t in pair],
                   rowmask if spec.preds else None, *got)
    n_ops = sum(map(len, [d.prog for d in spec.derived] + spec.preds))
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms(moved),
            "bound_by": "bytes", "library_ms": None,
            "parent": SCAN_PARENT[what],
            "shape": f"{what}: rows={rowmask.numel()} inputs={len(cols)} "
                     f"derived={len(spec.derived)} (stored "
                     f"{sum(d.stored for d in spec.derived)}) "
                     f"masks={len(spec.preds)} ops={n_ops} "
                     f"stages={spec.plan.n_stages}"}


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


# ------------------------------------------------------------ vector phases

#: recall@10 at nprobe 16 on the sift corpus must reach this (the
#: reference bench's floor is 0.3)
SIFT_RECALL_FLOOR = 0.85


def sift_corpus(n: int = 1_000_000, dim: int = 128, n_queries: int = 1024,
                seed: int = 11):
    """An integer corpus at sift-128-euclidean's shape: values in [0, 255]
    drawn around a random 16-dimensional subspace (128 + z·A, z normal,
    A scaled so a coordinate spreads about 40) plus noise of 4, rounded and
    clipped; queries drawn the same way. Descriptors of real images fill
    such a low-dimensional spread rather than well-separated clumps, so
    nearest neighbours straddle the IVF lists and recall at nprobe 16 is
    below 1 (about 0.6-0.85 predicted from smaller runs of the same
    generator). Every squared l2 distance is an exact integer below
    2^24."""
    rng = np.random.default_rng(seed)
    rank = 16
    basis = rng.standard_normal((rank, dim)) * 40.0 / np.sqrt(rank)

    def draw(m):
        out = np.empty((m, dim), np.uint8)
        for a in range(0, m, 1 << 17):
            b = min(m, a + (1 << 17))
            v = 128.0 + rng.standard_normal((b - a, rank)) @ basis + \
                rng.normal(0.0, 4.0, (b - a, dim))
            out[a:b] = np.clip(np.rint(v), 0, 255).astype(np.uint8)
        return out
    return draw(n), draw(n_queries)


def json_rows(mat: np.ndarray) -> list:
    """'[  7, 12,255]'-style JSON text per row of a uint8 matrix, built
    with numpy (fixed-width fields; JSON allows the blanks)."""
    n, d = mat.shape
    buf = np.full((n, d, 4), ord(" "), np.uint8)
    v = mat.astype(np.int16)
    h, t, o = v // 100, (v // 10) % 10, v % 10
    buf[:, :, 0] = np.where(h > 0, 48 + h, 32)
    buf[:, :, 1] = np.where((h > 0) | (t > 0), 48 + t, 32)
    buf[:, :, 2] = 48 + o
    buf[:, :, 3] = ord(",")
    buf[:, -1, 3] = ord("]")
    flat = np.concatenate([np.full((n, 1), ord("["), np.uint8),
                           buf.reshape(n, -1)], axis=1)
    width = flat.shape[1]
    raw = flat.tobytes().decode("ascii")
    return [raw[i * width:(i + 1) * width] for i in range(n)]


def exact_l2_select(x: np.ndarray, q: np.ndarray, k: int):
    """The (distance asc, row asc) top-k by exact integer arithmetic. Every
    squared distance of these integer vectors is an integer below 2^24, so
    each f32 partial sum of `host_dist` is exact and this equals
    host_dist's selection bit for bit (host_dist itself is run on a few
    queries to show it)."""
    xf = x.astype(np.float64)
    x2 = (xf * xf).sum(1)
    out_d, out_r = [], []
    for a in range(0, len(q), 16):
        qb = q[a:a + 16].astype(np.float64)
        d = x2[None, :] - 2.0 * (qb @ xf.T) + (qb * qb).sum(1)[:, None]
        for row in d:
            kth = np.partition(row, k - 1)[k - 1]
            cand = np.flatnonzero(row <= kth)
            order = cand[np.lexsort((cand, row[cand]))][:k]
            out_d.append(row[order].astype(np.float32))
            out_r.append(order)
    return np.stack(out_d), np.stack(out_r)


def _vec_literal(v) -> str:
    return "[" + ",".join(str(int(a)) for a in v) + "]"


def phase_sift(device, n=1_000_000, lists=1024, nprobe=16) -> dict:
    """IVF through SQL at sift-128-euclidean's shape, then IvfIndex.search
    over 1,024 queries at batch 1, 64 and 1,024."""
    import torch

    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES, UPLOADS
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.ops import vector as vops
    from serenedb_tpu_torch.ops import vector_kernels as vk
    from serenedb_tpu_torch.search import ivf
    from serenedb_tpu_torch.search.vector_store import VPOOL

    t0 = time.perf_counter()
    x, qs = sift_corpus(n)
    texts = json_rows(x)
    table = MemTable("sift", Batch.from_pydict(
        {"id": np.arange(n, dtype=np.int64), "v": texts}))
    del texts
    gen_s = time.perf_counter() - t0
    db = Database(device=device)
    c = db.connect()
    c.execute("SET serene_result_cache = off")
    db.schemas["main"].tables["sift"] = table
    split = {}

    def timed(module, name):
        orig = getattr(module, name)

        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = orig(*a, **kw)
            sync(device)
            split[name] = split.get(name, 0.0) + time.perf_counter() - t
            return out
        setattr(module, name, wrapper)
        return orig

    saved = [(m, nm, timed(m, nm)) for m, nm in
             ((ivf, "_parse_column"), (vops, "kmeans_fit"),
              (vops, "assign_clusters"), (VPOOL, "_write"))]
    launches_window = {}
    from serenedb_tpu_torch.search import vector_store
    recs = {"assign": Recorder(vk, "kmeans_assign"),
            "update": Recorder(vk, "kmeans_update"),
            "write": Recorder(vector_store, "_write_program"),
            "probe": Recorder(vk, "ivf_probe",
                              lambda a, kw: kw["nprobe"] == nprobe and
                              a[6].shape[0] == 64),
            "probe1": Recorder(vk, "ivf_probe",
                               lambda a, kw: kw["nprobe"] == nprobe and
                               a[6].shape[0] == 1)}
    try:
        for r in recs.values():
            r.__enter__()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        c.execute(f"CREATE INDEX sv ON sift USING ivf (v) WITH "
                  f"(lists = {lists})")
        sync(device)
        build_s = time.perf_counter() - t0
        c.execute(f"SET serene_nprobe = {nprobe}")
        stmt = ("SELECT id, v <-> '{q}' AS d FROM sift ORDER BY "
                "v <-> '{q}' LIMIT 10")
        ms, rows, ups = [], [], []
        for qi in range(64):          # 0-31 first pass (cold), 32-63 warm
            lit = _vec_literal(qs[qi])
            u0 = UPLOADS.get("bytes")
            t = time.perf_counter()
            rows.append(c.execute(stmt.format(q=lit)).rows())
            sync(device)
            ms.append((time.perf_counter() - t) * 1e3)
            ups.append(UPLOADS.get("bytes") - u0)
        idx = table.indexes["sv"]
        qf = qs.astype(np.float32)
        qps = {}
        for bs in (1, 64, 1024):
            t = time.perf_counter()
            outs = [idx.search(qf[a:a + bs], 10, nprobe)
                    for a in range(0, len(qf), bs)]
            sync(device)
            qps[bs] = len(qf) / (time.perf_counter() - t)
        launches_window = LAUNCHES.snapshot()
    finally:
        for r in reversed(list(recs.values())):
            r.__exit__()
        for m, nm, orig in saved:
            setattr(m, nm, orig)
    for name in ("ivf_probe", "kmeans_assign", "kmeans_update"):
        if not launches_window.get(name):
            fail(f"sift: {name} never launched ({launches_window})")
    ivf_d = np.concatenate([o[0] for o in outs])
    ivf_r = np.concatenate([o[1] for o in outs])
    # the SQL rows are IvfIndex.search's rows at batch 1
    for qi in range(64):
        got = [r[0] for r in rows[qi]]
        want = idx.search(qf[qi:qi + 1], 10, nprobe)[1][0].tolist()
        if got != want:
            fail(f"sift: statement {qi} rows {got} != search {want}")
    warm_up = ups[1:]
    q_block = _pow2(1) * 128 * 4
    if any(u != q_block for u in warm_up):
        fail(f"sift: a warm statement uploaded {max(warm_up)} bytes, more "
             f"than its {q_block}-byte query block")
    # full probe = brute kernel = host selection, on 64 queries
    q64 = qf[:64]
    full_d, full_r = idx.search(q64, 10, lists)
    with Recorder(vk, "ivf_probe",
                  lambda a, kw: kw["l_real"] == 1 and
                  a[6].shape[0] == 16) as rec_brute:
        br = [idx.brute_search(q64[a:a + 16], 10) for a in range(0, 64, 16)]
    b_d = np.concatenate([b[0] for b in br])
    b_r = np.concatenate([b[1] for b in br])
    t0 = time.perf_counter()
    h_d, h_r = exact_l2_select(x, qs[:64], 10)
    hd4 = vops.host_dist(x.astype(np.float32), qf[:4, None, :], "l2")
    for qi in range(4):
        if not np.array_equal(hd4[qi][h_r[qi]].view(np.int32),
                              h_d[qi].view(np.int32)):
            fail("sift: host_dist differs from the exact integer distances")
    oracle_s = time.perf_counter() - t0
    for name, (d, r) in (("brute_search", (b_d, b_r)),
                         ("host_dist", (h_d, h_r))):
        if not np.array_equal(full_d.view(np.int32), d.view(np.int32)) or \
                not np.array_equal(full_r, r):
            fail(f"sift: nprobe = {lists} differs from {name}")
    again_d, again_r = idx.search(q64, 10, nprobe)
    first_d, first_r = ivf_d[:64], ivf_r[:64]
    if not (np.array_equal(again_d.view(np.int32), first_d.view(np.int32))
            and np.array_equal(again_r, first_r)):
        fail("sift: two calls differ")
    # recall@10 at nprobe 16 against the exact top-10 (the brute kernel)
    truth = np.concatenate([idx.brute_search(qf[a:a + 64], 10)[1]
                            for a in range(0, len(qf), 64)])
    recall = float(np.mean([len(set(a) & set(b)) / 10.0
                            for a, b in zip(ivf_r.tolist(),
                                            truth.tolist())]))
    if recall < SIFT_RECALL_FLOOR:
        fail(f"sift: recall@10 {recall:.4f} under the floor "
             f"{SIFT_RECALL_FLOOR}")
    seg = idx.segs[0]
    return {"gen_s": gen_s, "build_s": build_s, "split": split,
            "cold_ms": ms[0], "first_pass_ms": ms[:32],
            "warm_ms": float(np.mean(ms[32:])), "warm_ms_all": ms[32:],
            "cold_upload": ups[0], "warm_upload": warm_up[0],
            "qps": qps, "recall": recall, "oracle_s": oracle_s,
            "launches": launches_window, "max_list": int(
                np.bincount(seg.codes, minlength=lists).max()),
            "calls": {"kmeans_assign": recs["assign"].args,
                      "kmeans_update": recs["update"].args,
                      "ivf_probe": recs["probe"].args,
                      "ivf_probe_1": recs["probe1"].args,
                      "ivf_brute": rec_brute.args,
                      "page_write": recs["write"].args}}


def unit_rows(rng, n: int, dim: int) -> np.ndarray:
    out = rng.standard_normal((n, dim), dtype=np.float32)
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    return out


def json_tokens(mat: np.ndarray) -> str:
    """'[[ 0.123456,-0.654321,...],...]' for a matrix of |values| < 1,
    fixed-width fields built with numpy."""
    n, d = mat.shape
    v = np.rint(np.clip(mat, -0.999999, 0.999999) * 1e6).astype(np.int64)
    buf = np.empty((n, d, 10), np.uint8)
    buf[:, :, 0] = np.where(v < 0, ord("-"), ord(" "))
    buf[:, :, 1] = ord("0")
    buf[:, :, 2] = ord(".")
    a = np.abs(v)
    for i in range(6):
        buf[:, :, 8 - i] = 48 + (a // 10 ** i) % 10
    buf[:, :, 9] = ord(",")
    buf[:, -1, 9] = ord("]")
    rows = np.concatenate([np.full((n, 1), ord("["), np.uint8),
                           buf.reshape(n, -1)], axis=1)
    rows = np.concatenate([rows, np.full((n, 1), ord(","), np.uint8)],
                          axis=1)
    body = rows.tobytes().decode("ascii")[:-1]
    return "[" + body + "]"


def maxsim_oracle_check(idx, queries, res, label: str) -> int:
    """Each query's MaxSim top-10 against the f64 host oracle: scores
    within rtol/atol 1e-5, rows equal but for near-ties (counted)."""
    near_ties = 0
    for b in range(len(queries)):
        hs = idx.host_scores(queries[b])
        order = np.lexsort((idx.doc_rows, -hs))[:10]
        got = -res[0][b].astype(np.float64)
        if not np.allclose(got, hs[order], rtol=1e-5, atol=1e-5):
            fail(f"{label}: query {b} scores off the f64 oracle")
        for j in np.flatnonzero(res[1][b] != idx.doc_rows[order]):
            if np.sum(np.isclose(hs, hs[order[j]], rtol=1e-5,
                                 atol=1e-5)) < 2:
                fail(f"{label}: query {b} rank {j} differs off a tie")
            near_ties += 1
    return near_ties


def phase_colbert(device, n_docs=50_000, dim=128, q_tokens=32, batch=16,
                  n_batches=4, sql_docs=2000,
                  long_shapes=((128, 1000), (768, 200))) -> dict:
    """MaxSim at ColBERTv2's widths: passages of 32-180 unit 128-d tokens
    as a MaxSimIndex (50,000 of them: the corpus is cut from 100,000 to
    hold the script's time), batches of 16 queries of 32 tokens; then a
    2,000-passage table through CREATE INDEX ... USING maxsim."""
    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.ops import vector_kernels as vk
    from serenedb_tpu_torch.search.ivf import MaxSimIndex, VecSegment

    rng = np.random.default_rng(12)
    t0 = time.perf_counter()
    lens = rng.integers(32, 181, n_docs)
    tok = unit_rows(rng, int(lens.sum()), dim)
    codes = np.repeat(np.arange(n_docs, dtype=np.int32), lens)
    seg = VecSegment(tok, codes.astype(np.int64), codes, n_docs)
    del tok                   # the segment holds its own (same-order) copy
    idx = MaxSimIndex(column="c", dim=dim, segs=[seg],
                      doc_rows=np.arange(n_docs, dtype=np.int32),
                      num_rows=n_docs, data_version=0, device=device)
    idx.layout()
    gen_s = time.perf_counter() - t0
    queries = np.stack([unit_rows(rng, q_tokens, dim)
                        for _ in range(batch * (n_batches + 1))])
    LAUNCHES.reset()
    with Recorder(vk, "maxsim", lambda a, kw: a[5].shape[0] == batch) \
            as rec:
        t0 = time.perf_counter()
        first = idx.search_batch(queries[:batch], 10)    # cold: pages
        sync(device)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for b in range(1, n_batches + 1):
            idx.search_batch(queries[b * batch:(b + 1) * batch], 10)
        sync(device)
        warm_s = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    if not launches.get("maxsim"):
        fail(f"colbert: maxsim never launched ({launches})")
    again = idx.search_batch(queries[:batch], 10)
    if not (np.array_equal(first[0].view(np.int32),
                           again[0].view(np.int32)) and
            np.array_equal(first[1], again[1])):
        fail("colbert: two calls differ")
    t0 = time.perf_counter()
    near_ties = maxsim_oracle_check(idx, queries[:4], first, "colbert")
    oracle_s = time.perf_counter() - t0
    # docs past one token tile of the kernel: 300-token passages (the
    # doc_maxlen ColBERTv2 indexes MS MARCO with) and every 7th a
    # 1,030-token page (ColPali), at 128 and at 768 dims
    long_docs = {}
    for ldim, nld in long_shapes:
        llens = np.full(nld, 300)
        llens[::7] = 1030
        ltok = unit_rows(rng, int(llens.sum()), ldim)
        lcodes = np.repeat(np.arange(nld, dtype=np.int32), llens)
        lidx = MaxSimIndex(
            column="c", dim=ldim,
            segs=[VecSegment(ltok, lcodes.astype(np.int64), lcodes, nld)],
            doc_rows=np.arange(nld, dtype=np.int32), num_rows=nld,
            data_version=0, device=device)
        lq = np.stack([unit_rows(rng, q_tokens, ldim) for _ in range(2)])
        before = LAUNCHES.get("maxsim")
        lres = lidx.search_batch(lq, 10)
        if LAUNCHES.get("maxsim") != before + 1:
            fail(f"colbert: the {ldim}-d long-doc search did not launch "
                 "maxsim once")
        long_docs[ldim] = {"docs": nld, "max_tokens": int(llens.max()),
                           "near_ties": maxsim_oracle_check(
                               lidx, lq, lres, f"colbert {ldim}-d long")}
    # the SQL leg: 2,000 of the passages as JSON text
    t0 = time.perf_counter()
    offs = np.concatenate([[0], np.cumsum(lens)])
    texts = [json_tokens(seg.vals[offs[i]:offs[i + 1]])
             for i in range(sql_docs)]
    db = Database(device=device)
    c = db.connect()
    c.execute("SET serene_result_cache = off")
    db.schemas["main"].tables["passages"] = MemTable(
        "passages", Batch.from_pydict(
            {"id": np.arange(sql_docs, dtype=np.int64), "c": texts}))
    c.execute("CREATE INDEX pc ON passages USING maxsim (c)")
    sql_build_s = time.perf_counter() - t0
    lit = json_tokens(queries[-1])
    stmt = (f"SELECT id, vec_maxsim(c, '{lit}') AS s FROM passages ORDER BY "
            f"vec_maxsim(c, '{lit}') DESC LIMIT 10")
    before = LAUNCHES.get("maxsim")
    t0 = time.perf_counter()
    dev_rows = c.execute(stmt).rows()
    sql_ms = (time.perf_counter() - t0) * 1e3
    if LAUNCHES.get("maxsim") <= before:
        fail("colbert: the SQL statement did not launch maxsim")
    launches["maxsim"] = launches.get("maxsim", 0) + \
        LAUNCHES.get("maxsim") - before
    c.execute("SET serene_maxsim = off")          # the f64 host oracle
    host_rows = c.execute(stmt).rows()
    if len(dev_rows) != len(host_rows) or not np.allclose(
            [r[1] for r in dev_rows], [r[1] for r in host_rows],
            rtol=1e-5, atol=1e-5):
        fail(f"colbert: SQL rows {dev_rows[:3]} vs host {host_rows[:3]}")
    return {"gen_s": gen_s, "tokens": int(lens.sum()), "docs": n_docs,
            "region_bytes": int(lens.sum()) * dim * 4, "cold_s": cold_s,
            "qps": n_batches * batch / warm_s, "near_ties": near_ties,
            "oracle_s": oracle_s, "sql_build_s": sql_build_s,
            "sql_ms": sql_ms, "launches": launches, "args": rec.args,
            "long_docs": long_docs,
            "sql_ids_equal": [r[0] for r in dev_rows] ==
            [r[0] for r in host_rows]}


def wand_parity(label: str, ms, qs: list, rows: list, step: int = 4) -> int:
    """Every `step`-th statement's rows (id, score) held to the host WAND
    (cpu_topk) by bench.py's rule: scores within PARITY_RTOL/ATOL, ids
    equal but where scores tie within 1e-3. Returns the count checked."""
    from serenedb_tpu_torch.search.query import parse_query
    checked = 0
    for qi in range(0, len(qs), step):
        ref_s, ref_d = ms.cpu_topk(parse_query(qs[qi], ms.analyzer), 10)
        got = rows[qi]
        if len(got) != len(ref_s):
            fail(f"{label} query {qi}: {len(got)} rows, host {len(ref_s)}")
        gs = np.asarray([r[1] for r in got], np.float64)
        if not np.allclose(gs, ref_s, rtol=PARITY_RTOL, atol=PARITY_ATOL):
            fail(f"{label} query {qi}: scores {gs} vs host {ref_s}")
        for j, (g, d) in enumerate(zip(got, ref_d.tolist())):
            if g[0] != d and abs(gs[j] - float(ref_s[j])) >= 1e-3:
                fail(f"{label} query {qi} rank {j}: doc {g[0]} != {d}")
        checked += 1
    return checked


def native_build(label: str, fn) -> tuple:
    """Run fn (a CREATE INDEX, a durable database's boot) and require
    that every field index it built took the native indexer; returns
    fn's result and the native build seconds."""
    from serenedb_tpu_torch.native import BUILDS
    before = BUILDS.snapshot()
    result = fn()
    after = BUILDS.snapshot()
    native = after.get("native", 0) - before.get("native", 0)
    python = after.get("python", 0) - before.get("python", 0)
    if native < 1 or python:
        fail(f"{label}: {native} native and {python} Python index builds; "
             "the native indexer must build every one")
    return result, (after.get("native_ns", 0) -
                    before.get("native_ns", 0)) / 1e9


def phase_bm25_sql(device, n_docs=100_000, append=10_000) -> dict:
    """The `bm25` shape's corpus through SQL: CREATE INDEX ... USING
    inverted, the 256-query mix as @@ + bm25() statements, then an INSERT
    of 10,000 docs (a second segment) and the mix again."""
    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.search.index import find_index

    docs, qs = dense_corpus(n_docs + append)
    db = Database(device=device)
    c = db.connect()
    c.execute("SET serene_result_cache = off")
    table = MemTable("docs", Batch.from_pydict(
        {"id": np.arange(n_docs, dtype=np.int64), "body": docs[:n_docs]}))
    db.schemas["main"].tables["docs"] = table
    stmt = ("SELECT id, bm25(body) AS s FROM docs WHERE body @@ '{q}' "
            "ORDER BY s DESC LIMIT 10")
    # the same with a tie-break: a stream scan that scores every match
    # (topk_rows at k = the match count)
    stream = ("SELECT id, bm25(body) AS s FROM docs WHERE body @@ '{q}' "
              "ORDER BY s DESC, id LIMIT 10")
    out = {}
    LAUNCHES.reset()
    t0 = time.perf_counter()
    _, out["native_s"] = native_build("bm25_sql", lambda: c.execute(
        "CREATE INDEX db ON docs USING inverted (body) WITH "
        "(tokenizer = 'simple')"))
    out["build_s"] = time.perf_counter() - t0
    runs, checked = [], 0
    for label in ("one segment", "two segments"):
        if label == "two segments":
            t0 = time.perf_counter()
            c.execute("INSERT INTO docs VALUES " + ", ".join(
                f"({n_docs + i}, '{d}')"
                for i, d in enumerate(docs[n_docs:])))
            out["insert_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = [c.execute(stmt.format(q=q)).rows() for q in qs]
        sync(device)
        runs.append(time.perf_counter() - t0)
        plan = str(c.execute("EXPLAIN " + stmt.format(q=qs[0])).rows())
        if "mode=TopK k=10" not in plan:
            fail(f"bm25_sql: the statement is not a top-k scan: {plan}")
        for qi in range(128, 256, 16):
            if c.execute(stream.format(q=qs[qi])).rows() != rows[qi]:
                fail(f"bm25_sql {label} query {qi}: the stream scan's rows "
                     "differ from the top-k scan's")
        ms = find_index(table, "body").searcher("body")
        if len(ms.segments) != len(runs):
            fail(f"bm25_sql: {len(ms.segments)} segments in the {label} run")
        checked += wand_parity(f"bm25_sql {label}", ms, qs, rows)
    launches = LAUNCHES.snapshot()
    for name in ("build_dense", "topk_rows"):
        if not launches.get(name):
            fail(f"bm25_sql: {name} never launched ({launches})")
    out.update({"launches": launches, "checked": checked,
                "ms_per_statement": [s / len(qs) * 1e3 for s in runs],
                "n_queries": len(qs),
                # the sharded phase appends to this table
                "conn": c, "table": table, "stmt": stmt, "queries": qs,
                "next_id": n_docs + append})
    return out


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _probe_bound(args) -> tuple:
    """(bytes, flops) an ivf_probe call must move and do: the distinct
    region rows its queries' probed lists hold (each read once), the
    centroids, queries, descriptor entries of those rows and the outputs;
    3 f32 operations a dimension (sub, mul, add) for every live lane and
    every (query, list) centroid distance."""
    import torch

    from serenedb_tpu_torch.ops import vector_kernels as vk
    a, kw = args
    region, slotmap, offsets, counts, rowids, cents, queries = a[:7]
    dp = queries.shape[1]
    probe = vk.probe_lists_plain(cents, queries, kw["metric"],
                                 kw["l_real"], kw["nprobe"])
    cnt = counts.to(torch.int64)[probe]
    live = int(cnt.sum())
    lists = torch.unique(probe)
    rows = int(counts.to(torch.int64)[lists].sum())
    per_op = 3 if kw["metric"] != "cos" else 6
    flops = per_op * dp * (live + queries.shape[0] * cents.shape[0])
    moved = rows * (dp * 4 + 8) + nbytes(cents, queries, offsets, counts) \
        + queries.shape[0] * kw["kkp"] * 8
    return moved, flops


def check_ivf_probe(device, args, reps=5) -> dict:
    """ivf_probe against its plain version on one recorded launch, bit for
    bit; two launches bit-identical; a call exactly IVF_KERNELS with no
    copy in (device ms by kernel)."""
    from serenedb_tpu_torch.ops import vector_kernels as vk
    a, kw = args
    d, r = vk.ivf_probe(*a, **kw)
    d2, r2 = vk.ivf_probe(*a, **kw)
    pd, pr = vk.ivf_probe_plain(*a, **kw)
    sync(device)
    for name, (x, y) in (("the plain version", (pd, pr)),
                         ("a second launch", (d2, r2))):
        if not (np.array_equal(d.cpu().numpy().view(np.int32),
                               x.cpu().numpy().view(np.int32)) and
                np.array_equal(r.cpu().numpy(), y.cpu().numpy())):
            fail(f"ivf_probe differs from {name} ({kw})")
    ms = timed_ms(lambda: vk.ivf_probe(*a, **kw), reps, device)
    note = activity_note(lambda: vk.ivf_probe(*a, **kw), IVF_KERNELS)
    t = time.perf_counter()
    vk.ivf_probe_plain(*a, **kw)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    moved, flops = _probe_bound(args)
    b_bytes, b_ops = bound_ms(moved), flops / F32_FLOPS * 1e3
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": None, "note": note,
            "shape": f"{kw['metric']} q={a[6].shape[0]} dp={a[6].shape[1]} "
                     f"lists={kw['l_real']} nprobe={kw['nprobe']} "
                     f"kkp={kw['kkp']} lanes={a[7].numel()}"}


def check_float_probe(device, n=100_000, dim=768, lists=64, nprobe=8,
                      nq=16) -> dict:
    """ivf_probe on float (non-grid) data at 100,000 x 768 for l2, ip and
    cos: bit-equal to its plain version, and each returned distance equal
    to numpy host_dist on its row (the padded dims 768..1023 add exactly
    0)."""
    import torch

    from serenedb_tpu_torch.ops import vector as vops
    from serenedb_tpu_torch.ops import vector_kernels as vk
    rng = np.random.default_rng(13)
    x = rng.standard_normal((n, dim), dtype=np.float32)
    q = rng.standard_normal((nq, dim), dtype=np.float32)
    dp = _pow2(dim)
    codes = rng.integers(0, lists, n)
    order = np.lexsort((np.arange(n), codes))
    counts = np.bincount(codes, minlength=lists).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    region = np.zeros((n, dp), np.float32)
    region[:, :dim] = x[order]
    cents = np.zeros((lists, dp), np.float32)
    cents[:, :dim] = np.stack([x[codes == c].mean(0) for c in range(lists)])
    qp = np.zeros((nq, dp), np.float32)
    qp[:, :dim] = q
    m = int(counts.max())
    tm, jm = vops.chunk_maps(nprobe, m, min(1024, _pow2(m)))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    args = [t(region), t(np.arange(n, dtype=np.int32)), t(offsets),
            t(counts), t(order.astype(np.int32)), t(cents), t(qp), t(tm),
            t(jm)]
    done = []
    for metric in ("l2", "ip", "cos"):
        kw = dict(metric=metric, l_real=lists, nprobe=nprobe, kkp=16)
        d, r = vk.ivf_probe(*args, **kw)
        pd, pr = vk.ivf_probe_plain(*args, **kw)
        sync(device)
        d, r = d.cpu().numpy(), r.cpu().numpy()
        if not (np.array_equal(d.view(np.int32),
                               pd.cpu().numpy().view(np.int32)) and
                np.array_equal(r, pr.cpu().numpy())):
            fail(f"float ivf_probe ({metric}) differs from its plain version")
        for qi in range(nq):
            h = vops.host_dist(x[r[qi]], q[qi][None, :], metric)
            if not np.array_equal(h.view(np.int32), d[qi].view(np.int32)):
                fail(f"float ivf_probe ({metric}) differs from host_dist")
        done.append(metric)
    return {"metrics": done, "shape": f"{n} x {dim} (dp {dp}), {lists} "
                                      f"lists, nprobe {nprobe}, {nq} queries"}


def check_maxsim(device, args, reps=3) -> dict:
    """maxsim against its plain version on one recorded 16-query batch,
    bit for bit; two launches bit-identical."""
    import torch

    from serenedb_tpu_torch.ops import vector_kernels as vk
    a, kw = args
    k, r = vk.maxsim(*a, **kw)
    k2, r2 = vk.maxsim(*a, **kw)
    pk, pr = vk.maxsim_plain(*a, **kw)
    sync(device)
    for name, (x, y) in (("the plain version", (pk, pr)),
                         ("a second launch", (k2, r2))):
        if not (torch.equal(k.view(torch.int32), x.view(torch.int32)) and
                torch.equal(r, y)):
            fail(f"maxsim differs from {name}")
    ms = timed_ms(lambda: vk.maxsim(*a, **kw), reps, device)
    note = activity_note(lambda: vk.maxsim(*a, **kw), MAXSIM_KERNELS)
    t = time.perf_counter()
    vk.maxsim_plain(*a, **kw)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    region, slotmap, offsets, counts, rowids, queries, dmap = a
    bp, sp, dp = queries.shape
    ntok = int(counts.to(torch.int64).sum())
    # a multiply-add is two FP32 instructions here (-fmad=false: the
    # product and the sum round apart), so the FMA rate does not apply
    instr = 2 * bp * sp * ntok * dp
    moved = ntok * (dp * 4 + 4) + nbytes(queries, offsets, counts, rowids,
                                         dmap) + bp * kw["kkp"] * 8
    b_bytes, b_ops = bound_ms(moved), instr / F32_INSTR * 1e3
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": None,
            "shape": f"B={bp} S={sp} dp={dp} docs={dmap.numel()} "
                     f"tokens={ntok} kkp={kw['kkp']}; {note}"}


def time_page_write(device, args, reps=5) -> dict:
    """The vector pool's page write (the reference's `_write_program`, one
    `index_copy_` here) replayed on the `sift` upload's own arguments: it
    writes the same pages with the same rows again."""
    from serenedb_tpu_torch.search import vector_store
    if args is None:
        fail("the vector pool's page write was not recorded")
    a, kw = args
    region, slots, stage = a
    ms = timed_ms(lambda: vector_store._write_program(*a, **kw), reps,
                  device)
    # the staged rows read once, the same bytes written, the slots read
    moved = 2 * nbytes(stage) + nbytes(slots)
    return {"ms": ms, "bound_ms": bound_ms(moved),
            "shape": f"{stage.shape[0]} pages x {stage.shape[1]} f32 into "
                     f"{region.shape[0]}"}


def check_kmeans(device, assign_args, update_args, reps=5) -> dict:
    """kmeans_assign and kmeans_update against their plain versions on one
    k-means iteration's recorded inputs, bit for bit; index_add_ timed as
    kmeans_update's yardstick (the per-cluster sums in one call); then
    kmeans_update on the same rows with >= 90 % of them in one cluster."""
    import torch

    from serenedb_tpu_torch.ops import vector_kernels as vk
    (x, c, xc), _kw = assign_args
    a = vk.kmeans_assign(x, c, xc)
    pa = vk.kmeans_assign_plain(x, c, xc)
    sync(device)
    if not torch.equal(a, pa):
        fail("kmeans_assign differs from its plain version")
    ua, ukw = update_args
    ux, uassign, uc = ua[:3]
    new = vk.kmeans_update(*ua, **ukw)
    new2 = vk.kmeans_update(*ua, **ukw)
    pnew = vk.kmeans_update_plain(*ua, **ukw)
    sync(device)
    if not (torch.equal(new.view(torch.int32), pnew.view(torch.int32)) and
            torch.equal(new.view(torch.int32), new2.view(torch.int32))):
        fail("kmeans_update differs from its plain version or itself")
    out = {}
    ms = timed_ms(lambda: vk.kmeans_assign(x, c, xc), reps, device)
    t = time.perf_counter()
    vk.kmeans_assign_plain(x, c, xc)
    sync(device)
    out["kmeans_assign"] = {
        "max_abs_err": 0.0, "ms": ms,
        "plain_ms": (time.perf_counter() - t) * 1e3,
        "bound_ms": bound_ms(nbytes(x, c, xc, a)), "bound_by": "bytes",
        "library_ms": None,
        "shape": f"N={x.shape[0]} K={c.shape[0]} D={x.shape[1]}"}
    ms = timed_ms(lambda: vk.kmeans_update(*ua, **ukw), reps, device)
    t = time.perf_counter()
    vk.kmeans_update_plain(*ua, **ukw)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    def library(assign):
        idx64 = assign.to(torch.int64)
        sums = torch.zeros_like(uc).index_add_(0, idx64, ux)
        torch.zeros(uc.shape[0], device=ux.device).index_add_(
            0, idx64, torch.ones(ux.shape[0], device=ux.device))
        return sums
    library_ms = timed_ms(lambda: library(uassign), reps, device)
    note = activity_note(
        lambda: vk.kmeans_update(*ua, **ukw), KMEANS_KERNELS)
    out["kmeans_update"] = {
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms(nbytes(ux, uassign, uc, new)),
        "bound_by": "bytes", "library_ms": library_ms,
        "shape": f"N={ux.shape[0]} K={uc.shape[0]} D={ux.shape[1]}; "
                 f"{note}"}
    # skewed: >= 90 % of the rows in one cluster (a seeded draw)
    g = torch.Generator(device=ux.device)
    g.manual_seed(5)
    skew = torch.where(torch.rand(ux.shape[0], generator=g,
                                  device=ux.device) < 0.93,
                       torch.full_like(uassign, 5), uassign).contiguous()
    largest = int(torch.bincount(skew.to(torch.int64)).max())
    if largest < 0.9 * ux.shape[0]:
        fail("the skewed k-means draw holds under 90 % in one cluster")
    new = vk.kmeans_update(ux, skew, uc)
    new2 = vk.kmeans_update(ux, skew, uc)
    t = time.perf_counter()
    pnew = vk.kmeans_update_plain(ux, skew, uc)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    if not (torch.equal(new.view(torch.int32), pnew.view(torch.int32)) and
            torch.equal(new.view(torch.int32), new2.view(torch.int32))):
        fail("kmeans_update (skewed) differs from its plain version or "
             "itself")
    ms = timed_ms(lambda: vk.kmeans_update(ux, skew, uc), reps, device)
    library_ms = timed_ms(lambda: library(skew), reps, device)
    note = activity_note(
        lambda: vk.kmeans_update(ux, skew, uc), KMEANS_KERNELS)
    out["kmeans_update skewed"] = {
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms(nbytes(ux, skew, uc, new)),
        "bound_by": "bytes", "library_ms": library_ms,
        "shape": f"N={ux.shape[0]} K={uc.shape[0]} D={ux.shape[1]}, "
                 f"{largest} rows in one cluster; {note}"}
    return out


# ------------------------------------------------------------ serving

#: the posting pool's page budget in the ragged leg, `paged_search` and
#: the serving phase (8 KiB a page: 512 MiB, inside the device cache's cap)
POSTING_PAGES = 65_536


def _same_bits(a, b) -> bool:
    return a[0].tobytes() == b[0].tobytes() and \
        a[1].tobytes() == b[1].tobytes()


def route_times(searcher, nodes, batch: int, reps: int = 3) -> list:
    """Each group of `batch` consecutive queries through topk_batch on
    the three routes — the posting pool (`pool_score`), the host ragged
    path (`contrib_flat`) and the score planes — with the ragged routes
    admitting every query. Returns per group its queries' kept postings
    (the `entries` that `ragged_admits` reads; none for a query the
    ragged path never takes) and the median ms of `reps` warm calls per
    route."""
    from serenedb_tpu_torch.utils.config import REGISTRY as settings
    seen: list = []

    def admit_all(entries, batch_size):
        seen.append(entries)
        return True
    searcher.ragged_admits = admit_all
    out = []
    try:
        for i in range(0, len(nodes), batch):
            group = nodes[i:i + batch]
            ms = {}
            for route, pool, ragged in (("pool", True, True),
                                        ("host", False, True),
                                        ("plane", True, False)):
                settings.set_global("serene_posting_pool", pool)
                del seen[:]
                searcher.topk_batch(group, 10, ragged=ragged)
                entries = list(seen)    # the cold call's admissions
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    searcher.topk_batch(group, 10, ragged=ragged)
                    times.append((time.perf_counter() - t0) * 1e3)
                ms[route] = float(np.median(times))
                if route == "host":
                    kept = entries
            out.append({"entries": kept, "batch": len(group), "ms": ms})
    finally:
        del searcher.ragged_admits
        settings.set_global("serene_posting_pool", True)
    return out


def print_routes(phase: int, label: str, rows: list) -> None:
    """One line per route and batch size: each group's kept postings
    (summed over its queries) and its ms, in order of postings."""
    for batch in sorted({r["batch"] for r in rows}):
        sel = sorted((sum(r["entries"]), r["ms"]) for r in rows
                     if r["batch"] == batch and r["entries"])
        for route in ("pool", "host", "plane"):
            pts = " ".join(f"{e}:{ms[route]:.3f}" for e, ms in sel)
            print(f"[{phase}] {label} route {route}, batch {batch} "
                  f"(kept postings:ms) {pts}", flush=True)


def ragged_leg(device, searcher, nodes, plane_out, reps=3) -> dict:
    """Phase 4's mix again through `topk_batch(ragged=True)` with the
    posting pool on, on the same searcher: every query bit-equal to the
    plane results of phase 4; QPS against the planes' as the median of
    three alternating passes each; then each query alone on every route
    (`route_times`)."""
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.search.posting_pool import POOL
    from serenedb_tpu_torch.utils import metrics
    from serenedb_tpu_torch.utils.config import REGISTRY as settings

    settings.set_global("serene_posting_pool", True)
    settings.set_global("serene_posting_pages", POSTING_PAGES)
    POOL.clear()
    d0 = metrics.POSTING_POOL_DEVICE_QUERIES.value
    LAUNCHES.reset()
    t0 = time.perf_counter()
    out = searcher.topk_batch(nodes, 10, ragged=True)
    sync(device)
    cold_s = time.perf_counter() - t0
    passes = {True: [], False: []}
    for _ in range(reps):
        for ragged in (False, True):
            t0 = time.perf_counter()
            again = searcher.topk_batch(nodes, 10, ragged=ragged)
            sync(device)
            passes[ragged].append(len(nodes) /
                                  (time.perf_counter() - t0))
            if ragged:
                for qi in range(len(nodes)):
                    if not _same_bits(again[qi], plane_out[qi]):
                        fail(f"ragged leg: query {qi} differs from the "
                             "plane result")
    launches = LAUNCHES.snapshot()
    if not launches.get("pool_score"):
        fail(f"ragged leg: pool_score never launched ({launches})")
    for qi in range(len(nodes)):
        if not _same_bits(out[qi], plane_out[qi]):
            fail(f"ragged leg: query {qi} differs from the plane result")
    st = POOL.stats()
    pool_q = metrics.POSTING_POOL_DEVICE_QUERIES.value - d0
    routes = route_times(searcher, nodes, 1)
    POOL.clear()
    qps = float(np.median(passes[True]))
    plane_qps = float(np.median(passes[False]))
    return {"qps": qps, "plane_qps": plane_qps, "ratio": qps / plane_qps,
            "passes": passes, "cold_s": cold_s, "routes": routes,
            "launches": launches, "pages_used": st["pages_used"],
            "pool_queries": pool_q}


def phase_paged(device, n_docs=1_000_000, vocab=30_000,
                postings=12_000_000, reps=3) -> dict:
    """The reference's `paged_search` cell (bench.py bench_paged_search):
    1,000,000 docs, 30,000 terms, 12M sampled postings (seed 7), 64
    two-term disjunctions, k = 10, batches of 1, 8 and 64, through
    `topk_batch` with the pool on, off (host ragged, contrib_flat) and
    `ragged=False` (the plane), every query bit-equal across modes; a
    warm repeat uploads 0 bytes and launches pool_score once; a starved
    budget of 64 pages stays bit-equal."""
    from serenedb_tpu_torch.device import LAUNCHES, UPLOADS
    from serenedb_tpu_torch.ops import bm25 as bm25_ops
    from serenedb_tpu_torch.ops import bm25_kernels as kern
    from serenedb_tpu_torch.ops import pool_kernels
    from serenedb_tpu_torch.search.analysis import get_analyzer
    from serenedb_tpu_torch.search.posting_pool import POOL
    from serenedb_tpu_torch.search.query import parse_query
    from serenedb_tpu_torch.search.searcher import SegmentSearcher
    from serenedb_tpu_torch.utils import metrics
    from serenedb_tpu_torch.utils.config import REGISTRY as settings

    t0 = time.perf_counter()
    fi = synth_posting_index(n_docs, vocab, postings, seed=7, device=device)
    an = get_analyzer("simple")
    seg = SegmentSearcher(fi, an, n_docs, device=device)
    seg._device_store()
    sync(device)
    build_s = time.perf_counter() - t0
    terms = [f"w{100 + 13 * i:07d}" for i in range(128)]
    nodes = [parse_query(f"{terms[2 * i]} | {terms[2 * i + 1]}", an)
             for i in range(64)]
    modes = {"pool": (True, True), "host": (False, True),
             "plane": (True, False)}

    def run(batch, mode):
        pool, ragged = modes[mode]
        settings.set_global("serene_posting_pool", pool)
        res = []
        for i in range(0, len(nodes), batch):
            res.extend(seg.topk_batch(nodes[i:i + batch], 10,
                                      ragged=ragged))
        return res

    def same(res, base, what):
        for qi, (a, b) in enumerate(zip(res, base)):
            if not _same_bits(a, b):
                fail(f"paged_search: {what} query {qi} differs from the "
                     "plane result")

    settings.set_global("serene_posting_pages", POSTING_PAGES)
    POOL.clear()
    d0 = metrics.POSTING_POOL_DEVICE_QUERIES.value
    LAUNCHES.reset()
    base = None
    # the first full-mode pool_score and the first contrib_flat are the
    # batch-64 ones: batch 64 runs first
    with Recorder(pool_kernels, "pool_score",
                  lambda a, kw: a[15] > 0) as rec_p, \
            Recorder(kern, "contrib_flat") as rec_c, \
            Recorder(bm25_ops, "ragged_contribs") as rec_r:
        t0 = time.perf_counter()
        for batch in (64, 8, 1):      # cold, then every bucket warm once
            for mode in ("plane", "pool", "host"):
                res = run(batch, mode)
                base = base or res
                same(res, base, f"{mode} at batch {batch} (first pass)")
        first_s = time.perf_counter() - t0
        qps = {m: {} for m in modes}
        for batch in (1, 8, 64):
            for mode in ("pool", "host", "plane", "host", "pool"):
                t0 = time.perf_counter()
                for _ in range(reps):
                    res = run(batch, mode)
                dt = time.perf_counter() - t0
                qps[mode].setdefault(batch, []).append(
                    reps * len(nodes) / dt)
                same(res, base, f"{mode} at batch {batch}")
        settings.set_global("serene_posting_pool", True)
        seg.topk_batch(nodes, 10, ragged=True)
        b0, l0 = UPLOADS.get("bytes"), LAUNCHES.get("pool_score")
        again = seg.topk_batch(nodes, 10, ragged=True)
        warm_bytes = UPLOADS.get("bytes") - b0
        warm_launches = LAUNCHES.get("pool_score") - l0
        same(again, base, "warm repeat")
        if warm_bytes or warm_launches != 1:
            fail(f"paged_search: a warm repeat uploaded {warm_bytes} B in "
                 f"{warm_launches} pool_score launches (want 0 B, 1)")
        stats = POOL.stats()
        # the per-route sweep admits every query: its launches are not
        # the main path's, so the counts go back to what they were
        counted = LAUNCHES.snapshot()
        routes = [r for batch in (1, 8, 64)
                  for r in route_times(seg, nodes, batch)]
        LAUNCHES.reset()
        for name, n in counted.items():
            LAUNCHES.bump(name, n)
        settings.set_global("serene_posting_pages", 64)
        POOL.clear()
        e0 = metrics.POSTING_POOL_EVICTIONS.value
        p0 = metrics.POSTING_POOL_PARTIAL.value
        for batch in (64, 8):
            same(run(batch, "pool"), base, f"64 pages, batch {batch}")
        starved = {"evictions": metrics.POSTING_POOL_EVICTIONS.value - e0,
                   "partial": metrics.POSTING_POOL_PARTIAL.value - p0}
        if not (starved["evictions"] or starved["partial"]):
            fail(f"paged_search: 64 pages neither evicted nor split a "
                 f"query ({starved})")
    settings.set_global("serene_posting_pages", POSTING_PAGES)
    POOL.clear()
    launches = LAUNCHES.snapshot()
    for name in ("pool_score", "contrib_flat", "bm25_accumulate",
                 "topk_rows"):
        if not launches.get(name):
            fail(f"paged_search: {name} never launched ({launches})")
    pool_q = metrics.POSTING_POOL_DEVICE_QUERIES.value - d0
    if pool_q <= 0:
        fail("paged_search: the pool served no query")
    if rec_p.args is None or rec_c.args is None or rec_r.args is None:
        fail("paged_search: pool_score's, contrib_flat's or "
             "ragged_contribs' inputs were not recorded")
    return {"build_s": build_s, "first_s": first_s,
            "qps": {m: {b: sorted(v)[len(v) // 2] for b, v in d.items()}
                    for m, d in qps.items()},
            "launches": launches, "pool_queries": pool_q, "starved": starved,
            "pool": stats, "postings": int(len(fi.post_docs)),
            "routes": routes,
            "pool_args": rec_p.args, "flat_args": rec_c.args,
            "ragged_args": rec_r.args}


def serving_corpus(n_docs: int, seed: int = 5) -> list:
    """bench.py bench_bm25_1m's generator: a 30,000-word vocabulary,
    zipf(1.25), docs of 8-40 words."""
    rng = np.random.default_rng(seed)
    vocab = np.asarray([f"w{i}" for i in range(30_000)], dtype=object)
    lens = rng.integers(8, 40, n_docs)
    zipf = rng.zipf(1.25, size=int(lens.sum())) % len(vocab)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    words = vocab[zipf]
    return [" ".join(words[bounds[i]:bounds[i + 1]])
            for i in range(n_docs)]


def phase_serving(device, n_docs=200_000, n_items=64) -> dict:
    """The serving path on the card: an ES document table of n_docs text
    docs (bench_bm25_1m's generator) with an inverted index, behind one
    FrontDoor serving HTTP and the PG wire. One `_msearch` of n_items
    two-term `match` items cold, twice warm, and once with the posting
    pool off; each item's hits equal the same `_search` run serially
    with serene_search_batch = off; then one `@@` statement over the PG
    wire equal to `execute`."""
    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.server.frontdoor import FrontDoor
    from serenedb_tpu_torch.server.pgwire import PgServer
    from serenedb_tpu_torch.utils import metrics
    from serenedb_tpu_torch.utils.config import REGISTRY as settings
    from serenedb_tpu_torch.server.client import http as _http
    from serenedb_tpu_torch.server.client import pg_rows

    t0 = time.perf_counter()
    docs = serving_corpus(n_docs)
    db = Database(device=device)
    db.schemas["main"].tables["books"] = MemTable("books", Batch.from_pydict(
        {"_id": [str(i) for i in range(n_docs)],
         "_source": [json.dumps({"body": d}) for d in docs],
         "body": docs}))
    del docs
    gen_s = time.perf_counter() - t0
    c = db.connect()
    t0 = time.perf_counter()
    _, native_s = native_build("serving", lambda: c.execute(
        'CREATE INDEX ON books USING inverted ("body") WITH '
        "(tokenizer = 'simple')"))
    build_s = time.perf_counter() - t0
    qterms = [f"w{1 + 9 * i}" for i in range(2 * n_items)]
    items = [{"query": {"match": {"body": f"{qterms[2 * i]} "
                                          f"{qterms[2 * i + 1]}"}},
              "size": 10} for i in range(n_items)]
    body = "".join(json.dumps({"index": "books"}) + "\n" + json.dumps(it)
                   + "\n" for it in items)
    settings.set_global("serene_result_cache", False)
    settings.set_global("serene_posting_pool", True)
    pg = PgServer(db, "127.0.0.1", 0)
    front = FrontDoor(db, http_port=0, pg=pg)
    front.start()
    out = {"gen_s": gen_s, "build_s": build_s, "native_s": native_s,
           "ms": {}, "docs": n_docs}
    try:
        q0 = metrics.SEARCH_BATCH_QUERIES.value
        b0 = metrics.SEARCH_BATCH_DISPATCHES.value
        LAUNCHES.reset()
        got = {}
        for run in ("cold", "warm", "warm2", "pool off"):
            settings.set_global("serene_posting_pool", run != "pool off")
            t0 = time.perf_counter()
            got[run] = _http(front.port, "POST", "/_msearch", body, True)
            out["ms"][run] = (time.perf_counter() - t0) * 1e3
        settings.set_global("serene_posting_pool", True)
        launches = LAUNCHES.snapshot()
        queries = metrics.SEARCH_BATCH_QUERIES.value - q0
        dispatches = metrics.SEARCH_BATCH_DISPATCHES.value - b0
        # where a warm _msearch goes: the same body in process (no HTTP),
        # and the items' top-k statements alone, one after another
        from serenedb_tpu_torch.server.es_api import EsApi
        api = EsApi(db)
        api.msearch(body)
        t0 = time.perf_counter()
        api.msearch(body)
        out["ms"]["in process"] = (time.perf_counter() - t0) * 1e3
        topk = [f"SELECT \"_id\", bm25(body) AS s FROM books WHERE body @@ "
                f"'{qterms[2 * i]} | {qterms[2 * i + 1]}' ORDER BY s DESC "
                f"LIMIT 10" for i in range(n_items)]
        for q in topk:
            c.execute(q)
        t0 = time.perf_counter()
        for q in topk:
            c.execute(q)
        out["ms"]["top-k statements"] = (time.perf_counter() - t0) * 1e3
        settings.set_global("serene_search_batch", False)
        try:
            t0 = time.perf_counter()
            serial = [_http(front.port, "POST", "/books/_search", it)
                      for it in items]
            out["ms"]["serial _search"] = (time.perf_counter() - t0) * 1e3
        finally:
            settings.set_global("serene_search_batch", True)
        for run, resp in got.items():
            for i, r in enumerate(resp["responses"]):
                if r.get("status") != 200 or \
                        r["hits"] != serial[i]["hits"]:
                    fail(f"serving: _msearch ({run}) item {i} differs from "
                         "its serial _search")
        if not any(r["hits"]["hits"] for r in got["cold"]["responses"]):
            fail("serving: no item found a hit")
        sql = (f"SELECT \"_id\", bm25(body) AS s FROM books WHERE body @@ "
               f"'{qterms[2]} | {qterms[3]}' ORDER BY s DESC LIMIT 10")
        wire = pg_rows(pg.port, sql)
        direct = c.execute(sql).rows()
        if [r[0] for r in wire] != [r[0] for r in direct] or any(
                np.float32(float(w[1])) != np.float32(d[1])
                for w, d in zip(wire, direct)) or not wire:
            fail(f"serving: the PG wire's rows {wire[:3]} differ from "
                 f"execute's {direct[:3]}")
    finally:
        front.stop()
        settings.set_global("serene_result_cache", True)
    for name in ("pool_score", "contrib_flat"):
        if not launches.get(name):
            fail(f"serving: {name} never launched ({launches})")
    mean_batch = queries / max(dispatches, 1)
    if mean_batch <= 1:
        fail(f"serving: no coalescing ({queries} queries in {dispatches} "
             "dispatches)")
    out.update({"launches": launches, "mean_batch": mean_batch,
                "dispatches": dispatches, "queries": queries,
                "pg_rows": len(wire)})
    return out


def check_contrib_flat(device, args, reps=20) -> dict:
    """contrib_flat against its plain version (contrib_plain over each
    posting's dl: with `norms`, the resident norm of the doc the second
    array names) bit for bit, on a main-path launch's inputs."""
    import torch

    from serenedb_tpu_torch.ops import bm25_kernels as kern
    a, kw = args
    tfs, dls, w, k1, b, avgdl = a[:6]
    scorer = a[6] if len(a) > 6 else kw.get("scorer", "bm25")
    norms = a[7] if len(a) > 7 else kw.get("norms")
    dl = dls if norms is None else norms[dls.long()]

    def plain():
        return kern.contrib_plain(scorer, tfs.to(torch.float32),
                                  dl.to(torch.float32), w, k1, b,
                                  kern._avg(avgdl))
    got = kern.contrib_flat(*a, **kw)
    ref = plain()
    sync(device)
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        fail("contrib_flat differs from its plain version")
    ms = timed_ms(lambda: kern.contrib_flat(*a, **kw), reps, device)
    plain_ms = timed_ms(plain, reps, device)
    # ragged_contribs sizes the postings exactly (no pad): every posting
    # is real; with norms each also reads its doc's 4-byte norm
    n = tfs.numel()
    per = tfs.element_size() + dls.element_size() + w.element_size() + \
        got.element_size() + (0 if norms is None else norms.element_size())
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(n * per), "bound_by": "bytes",
            "library_ms": None,
            "shape": f"n={n} {scorer}"
                     + ("" if norms is None else ", dl from the norms")}


def check_ragged_contribs(device, args, reps=20) -> dict:
    """The host ragged route's whole `ragged_contribs` call (one packed
    upload, the contrib_flat launch, one readback and its sync) on a
    main-path call's inputs: host ms a call (it ends in a sync), its
    uploads a call, and finite values of the right length."""
    from serenedb_tpu_torch.device import UPLOADS
    from serenedb_tpu_torch.ops import bm25 as bm25_ops
    a, kw = args
    bm25_ops.ragged_contribs(*a, **kw)
    t0, u0 = time.perf_counter(), UPLOADS.get("transfers")
    for _ in range(reps):
        got = bm25_ops.ragged_contribs(*a, **kw)
    ms = (time.perf_counter() - t0) / reps * 1e3
    uploads = (UPLOADS.get("transfers") - u0) / reps
    if got.shape != (len(a[0]),) or not np.isfinite(got).all():
        fail("ragged_contribs gave a wrong shape or non-finite values")
    if uploads != 1:
        fail(f"ragged_contribs made {uploads} uploads a call (want 1)")
    return {"ms": ms, "uploads": uploads, "n": len(a[0])}


def check_pool_score(device, args, reps=20) -> dict:
    """pool_score against its plain version bit for bit on a main-path
    batch, full mode and partial mode."""
    import torch

    from serenedb_tpu_torch.ops import pool_kernels
    a, kw = args
    vals, docs = pool_kernels.pool_score(*a, **kw)
    acc = pool_kernels.pool_score(*a[:13])
    ref_v, ref_d = pool_kernels.pool_score_plain(*a, **kw)
    ref_acc = pool_kernels.pool_score_plain(*a[:13])
    sync(device)
    if not torch.equal(docs, ref_d) or not torch.equal(
            vals.view(torch.int32), ref_v.view(torch.int32)):
        fail("pool_score (full) differs from its plain version")
    if not torch.equal(acc.view(torch.int32), ref_acc.view(torch.int32)):
        fail("pool_score (partial) differs from its plain version")
    ms = timed_ms(lambda: pool_kernels.pool_score(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: pool_kernels.pool_score_plain(*a, **kw),
                        reps, device)
    soff, cand, nc = a[6], a[13], a[14]
    kept = int(soff[:, -1].sum())
    live = int(nc.sum())
    # each kept posting: its slot, weight and lane, the (doc, tf) pair it
    # gathers and its doc's norm; each live lane's candidate doc (dead
    # lanes read none); the offsets, live counts and top-k
    moved = kept * (12 + 8 + 4) + live * cand.element_size() + \
        nbytes(soff, nc, vals, docs)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": None,
            "shape": f"qp={cand.shape[0]} cp={cand.shape[1]} live={live} "
                     f"kept={kept} kk={vals.shape[1]}"}


def graph_nodes(fn) -> tuple:
    """(kernels, host-to-device copies, memsets) of one fn(), from the
    nodes of a CUDA graph that captures it after a warm-up call
    (libcuda's cuGraphGetNodes and cuGraphNodeGetType): a graph holds
    every launch, where a profiled window can drop events. Returns the
    graph too, for `graph_ms`."""
    import ctypes

    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if drv.cuGraphGetNodes(graph, None, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    drv.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    # CU_GRAPH_NODE_TYPE_KERNEL = 0, _MEMCPY = 1, _MEMSET = 2
    return (kinds.count(0), kinds.count(1), kinds.count(2)), g


def graph_ms(g, reps: int = 50) -> float:
    """Device ms of one call: `reps` replays of its captured graph between
    CUDA events (the kernels back to back, no host time between)."""
    import torch
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_split(fn, calls: int = 5) -> dict:
    """Device ms a call by kernel name (torch.profiler, the mean over
    `calls` calls after a warm-up); the profiler can drop events, so the
    graph's node count and replay time stand beside it."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        margin(0)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        margin(0)
    ms = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.name.startswith("Mem"):
            continue
        m = re.search(r"(\w+_kernel)", ev.name)
        name = m.group(1) if m else ev.name[:40]
        t = getattr(ev, "device_time_total", 0) or \
            getattr(ev, "cuda_time_total", 0)
        ms[name] = ms.get(name, 0.0) + t / 1e3 / calls
    return ms


def synth_pool_row(device, cp: int, seed: int = 3, pages: int = 1024):
    """One query of cp live lanes over a random region of `pages` pages:
    two slices, each over every lane in a random order, k 10 (the
    candidates ascend, as `_ragged_candidates` makes them)."""
    import torch
    rng = np.random.default_rng(seed)
    ep = 2 * cp

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    args = (t(rng.integers(0, 1_000_000, (pages, 1024)).astype(np.int32)),
            t(rng.integers(1, 20, (pages, 1024)).astype(np.int32)),
            t(rng.integers(5, 300, 1_000_000).astype(np.int32)),
            t(rng.integers(0, pages * 1024, (1, ep)).astype(np.int32)),
            t(np.repeat(np.float32([1.5, 2.25]), cp)[None, :]),
            t(np.concatenate([rng.permutation(cp), rng.permutation(cp)]
                             ).astype(np.int32)[None, :]),
            t(np.int32([[0, cp, ep]])), [cp, cp], cp, 1.2, 0.75, 150.0,
            "bm25",
            t(np.sort(rng.choice(1 << 30, cp, replace=False)).astype(
                np.int32)[None, :]),
            t(np.int32([cp])), 10)
    return args, {}


def pool_regime_calls(device, args) -> dict:
    """pool_score's two calls that phase 18 reads in both regimes: the
    recorded phase 15 batch (ROW) and one synthetic query of 600,000
    lanes, past the ROW cap (LARGE; bit-equal to the plain version
    here). Each with its device ms by kernel from torch.profiler, read
    now, right after phase 15: the profiler drops kernel events late in a
    long process (ROW: a complete window of `launch_profile`, one
    pool_row_kernel a call)."""
    import torch

    from serenedb_tpu_torch.ops import pool_kernels
    out = {}
    big = synth_pool_row(device, 600_000)
    for what, want, (a, kw) in (("recorded batch", "row", args),
                                ("600,000 lanes", "large", big)):
        regime = pool_kernels.pool_regime(a[8], a[15])
        if regime != want:
            fail(f"pool_score's {what} took the {regime} regime")

        def call(a=a, kw=kw):
            return pool_kernels.pool_score(*a, **kw)
        if regime == "large":
            got, ref = call(), pool_kernels.pool_score_plain(*a, **kw)
            sync(device)
            if not (torch.equal(got[1], ref[1]) and torch.equal(
                    got[0].view(torch.int32), ref[0].view(torch.int32))):
                fail("pool_score (LARGE) differs from its plain version")
            split = kernel_split(call)
        else:
            got = launch_profile(call, {"pool_row_kernel": 1})
            split = got[1] if got else {}
        out[what] = {"call": call, "regime": regime, "by_kernel": split,
                     "shape": f"qp={a[13].shape[0]} cp={a[8]} kk={a[15]} "
                              f"kept={int(a[6][:, -1].sum())}"}
    return out


def pool_graphs(device, calls: dict) -> dict:
    """Each of `pool_regime_calls`' calls from a captured CUDA graph: its
    kernels, copies in and memsets (graph nodes) and its device ms (graph
    replays), and the wrapper's whole call (CUDA events). A ROW call must
    be one kernel with no copy and no memset. Run last: no profiled
    window runs after a graph capture."""
    out = {}
    for what, r in calls.items():
        (kern_n, copies, memsets), g = graph_nodes(r["call"])
        if r["regime"] == "row" and (kern_n, copies, memsets) != (1, 0, 0):
            fail(f"a ROW pool_score call issued {kern_n} kernels, {copies} "
                 f"copies in, {memsets} memsets (want 1, 0, 0)")
        out[what] = dict(r, kernels=kern_n, copies=copies, memsets=memsets,
                         device_ms=graph_ms(g),
                         call_ms=timed_ms(r["call"], 20, device))
        del g
    return out


# ------------------------------------------------------ the sharded tier

#: bench_multichip's query: count/sum ride the per-shard int64 adds,
#: min/max the elementwise combine
SHARD_QUERY = ("SELECT g, count(*), sum(v), sum(w), min(w), max(v) FROM sp "
               "JOIN sb ON sp.jk = sb.k WHERE v > 0 GROUP BY g ORDER BY g")
#: multiples of bench_multichip's shape (1M probe rows, 200,000 build rows,
#: keyspace 400,000): 1x, and 10x, the largest the fused tier admits — at
#: 16x the two sides hold 6,137,597 distinct keys, past the reference's
#: MAX_CODE_SPACE (4,194,304), so both packages decline it to the host
SHARD_SCALES = (1, 10)
#: (shards, combine) cells of the sharded phase, shards = 1 first
SHARD_CELLS = ((1, "host"), (2, "host"), (2, "device"), (4, "host"),
               (4, "device"))


def shard_tables(m: int, seed: int = 53) -> dict:
    """bench_multichip's generator at m times its size: sp (jk BIGINT in
    [0, 400,000 m), g INT in [0, 16), v BIGINT in [-1000, 1000)) and sb (k
    a permutation of [0, 200,000 m), w BIGINT in [0, 100))."""
    rng = np.random.default_rng(seed)
    npr, nb, keyspace = 1_000_000 * m, 200_000 * m, 400_000 * m
    sp = {"jk": rng.integers(0, keyspace, npr, dtype=np.int64),
          "g": rng.integers(0, 16, npr).astype(np.int32),
          "v": rng.integers(-1000, 1000, npr, dtype=np.int64)}
    sb = {"k": rng.permutation(np.arange(nb, dtype=np.int64)),
          "w": rng.integers(0, 100, nb, dtype=np.int64)}
    return {"sp": sp, "sb": sb}


def shard_relational(device, m: int) -> dict:
    """SHARD_QUERY over shard_tables(m) through Database.execute at
    serene_shards 1/2/4 x serene_shard_combine host/device (morsels of
    131,072 rows, 4 workers, result cache off), each cell cold then warm
    (the median of three): rows equal to shards = 1 on the card (and, at
    1x, to the host path); every warm device-combine execution is exactly
    one offload and one join_probe launch, a warm host-combine one per
    shard."""
    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.obs import device as obs_device
    from serenedb_tpu_torch.ops import join_kernels
    from serenedb_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    tables = shard_tables(m)
    out = {"gen_s": time.perf_counter() - t0,
           "rows": len(tables["sp"]["jk"]), "cells": {}}
    db = Database(device=device)
    c = db.connect()
    for name, cols in tables.items():
        db.schemas["main"].tables[name] = MemTable(name,
                                                   Batch.from_pydict(cols))
    del tables
    for s in ("SET serene_result_cache = off", "SET serene_device_fused = on",
              "SET serene_morsel_rows = 131072", "SET serene_workers = 4"):
        c.execute(s)
    host = None
    if m == 1:
        c.execute("SET serene_device = 'cpu'")
        t0 = time.perf_counter()
        host = c.execute(SHARD_QUERY).rows()
        out["host_ms"] = (time.perf_counter() - t0) * 1e3
    c.execute("SET serene_device = 'gpu'")
    declines0 = obs_device.fused_declines()

    def run(shards, combine):
        c.execute(f"SET serene_shards = {shards}")
        c.execute(f"SET serene_shard_combine = {combine}")
        o0 = metrics.DEVICE_OFFLOADS.value
        p0 = LAUNCHES.get("join_probe")
        t0 = time.perf_counter()
        rows = c.execute(SHARD_QUERY).rows()
        sync(device)
        return (rows, (time.perf_counter() - t0) * 1e3,
                metrics.DEVICE_OFFLOADS.value - o0,
                LAUNCHES.get("join_probe") - p0)

    ref = None
    for shards, combine in SHARD_CELLS:
        # K12's one-card form: the first launch of the device combine at
        # 4 shards, at 1x, for phase 19
        rec = Recorder(join_kernels, "join_probe") \
            if m == 1 and (shards, combine) == (4, "device") else None
        if rec is not None:
            with rec:
                cold_rows, cold_ms, _o, _p = run(shards, combine)
            out["collective_args"] = rec.args
        else:
            cold_rows, cold_ms, _o, _p = run(shards, combine)
        if ref is None:
            ref = cold_rows
            if host is not None and ref != host:
                fail(f"sharded tier {m}x: the card's rows differ from the "
                     "host path's")
        # one probe a shard that holds a block (131,072 rows a block)
        want = 1 if shards == 1 or combine == "device" else \
            min(shards, -(-out["rows"] // 131072))
        warm = []
        for _ in range(3):
            rows, warm_ms, off, probes = run(shards, combine)
            if cold_rows != ref or rows != ref:
                fail(f"sharded tier {m}x: shards={shards} combine="
                     f"{combine} differs from shards = 1")
            if off != want or probes != want:
                fail(f"sharded tier {m}x shards={shards} combine={combine}:"
                     f" a warm execution took {off} offloads and {probes} "
                     f"join_probe launches, expected {want}")
            warm.append(warm_ms)
        out["cells"][(shards, combine)] = (cold_ms, float(np.median(warm)),
                                           want)
    if obs_device.fused_declines() != declines0:
        fail(f"sharded tier {m}x: fused declines {declines0} -> "
             f"{obs_device.fused_declines()}")
    out["groups"] = len(ref)
    return out


def shard_search(device, seg_docs=250_000, vocab=20_000,
                 postings=3_000_000) -> dict:
    """bench_multichip's search leg: four segments of 250,000 docs
    (`synth_posting_index`, 20,000 terms, 3,000,000 sampled postings,
    seeds 11-14, bases 0/250k/500k/750k) and 16 two-term disjunctions,
    k = 10, through MultiSearcher.topk_batch and cpu_topk at shards 1/2/4
    x combine host/device: scores (as uint32) and ids equal to shards =
    1, merge_topk launched once a call under the device combine and never
    under the host's. Then each disjunction's unscored match bitmap on
    every segment (`ops.bm25.match_bitmap` over the query batch's rows),
    equal to the segment's eval_filter."""
    import torch

    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.ops import bm25 as bm25_ops
    from serenedb_tpu_torch.ops import bm25_kernels, merge_kernels
    from serenedb_tpu_torch.search.analysis import get_analyzer
    from serenedb_tpu_torch.search.query import parse_query
    from serenedb_tpu_torch.search.searcher import (MultiSearcher,
                                                    SegmentSearcher)
    from serenedb_tpu_torch.utils.config import REGISTRY as settings

    an = get_analyzer("simple")
    ms = MultiSearcher(an)
    t0 = time.perf_counter()
    for si in range(4):
        fi = synth_posting_index(seg_docs, vocab, postings, 11 + si, device)
        ms.add_segment(SegmentSearcher(fi, an, seg_docs, device=device),
                       si * seg_docs)
    out = {"build_s": time.perf_counter() - t0, "cells": {},
           "postings": sum(len(s.index.post_docs) for s, _ in ms.segments)}
    terms = [f"w{100 + 13 * i:07d}" for i in range(32)]
    nodes = [parse_query(f"{terms[2 * i]} | {terms[2 * i + 1]}", an)
             for i in range(16)]
    names = ("serene_shards", "serene_shard_combine", "serene_result_cache")
    prior = {n: settings.get_global(n) for n in names}
    # the fragment tier off: every call scores and merges
    settings.set_global("serene_result_cache", False)
    rec = Recorder(merge_kernels, "merge_topk",
                   pick=lambda a, kw: tuple(a[0].shape[:2]) ==
                   (4, len(nodes)))

    def once(shards, combine):
        settings.set_global("serene_shards", shards)
        settings.set_global("serene_shard_combine", combine)
        m0 = LAUNCHES.get("merge_topk")
        t0 = time.perf_counter()
        batch = ms.topk_batch(nodes, 10)
        sync(device)
        t1 = time.perf_counter()
        wand = [ms.cpu_topk(n, 10) for n in nodes]
        t2 = time.perf_counter()
        merges = LAUNCHES.get("merge_topk") - m0
        want = 1 + len(nodes) if combine == "device" else 0
        if merges != want:
            fail(f"shard search shards={shards} combine={combine}: "
                 f"{merges} merge_topk launches, expected {want}")
        return list(batch) + wand, (t1 - t0) * 1e3, \
            (t2 - t1) * 1e3 / len(nodes)

    try:
        with rec:
            # the cold pass builds the segments' block stores
            ref, out["cold_ms"], _w = once(1, "host")
            if any(not len(s) for s, _d in ref):
                fail("shard search: a query found nothing")
            times = {cell: ([], []) for cell in SHARD_CELLS}
            for _ in range(3):          # the cells in turn, three rounds
                for shards, combine in SHARD_CELLS:
                    got, b_ms, w_ms = once(shards, combine)
                    for (s, d), (rs, rd) in zip(got, ref):
                        if not (np.array_equal(s.view(np.uint32),
                                               rs.view(np.uint32)) and
                                np.array_equal(d, rd)):
                            fail(f"shard search shards={shards} combine="
                                 f"{combine} differs from shards = 1")
                    times[(shards, combine)][0].append(b_ms)
                    times[(shards, combine)][1].append(w_ms)
            out["cells"] = {cell: (float(np.median(b)), float(np.median(w)))
                            for cell, (b, w) in times.items()}
    finally:
        for n, v in prior.items():
            settings.set_global(n, v)
    out["merge_args"] = rec.args

    bm = Recorder(bm25_kernels, "match_bitmap",
                  pick=lambda a, kw: a[3].numel() > 0)
    n_checked = 0
    with bm:
        for seg, _base in ms.segments:
            store = seg._device_store()
            for node in nodes:
                tids, _req, _mask, _empty = seg._query_shape(node)
                qb = bm25_ops.assemble_query_batch(
                    store, seg.num_docs,
                    [(np.asarray(tids, dtype=np.int64), 0)],
                    seg.index.doc_freq)

                def t(a):
                    return torch.from_numpy(np.ascontiguousarray(
                        a, dtype=np.int32)).to(device)
                bits = bm25_ops.match_bitmap(
                    store.block_base, store.block_gaps, store.block_tfs8,
                    t(qb.row_idx), store.raw_docs, t(qb.raw_idx),
                    t(qb.tail_docs), store.ndocs_pad)
                got = torch.nonzero(bits).flatten().cpu().numpy()
                if not np.array_equal(got, seg.eval_filter(node)):
                    fail("match_bitmap differs from eval_filter")
                n_checked += 1
    out["bitmap_args"] = bm.args
    out["bitmaps"] = n_checked
    return out


def shard_search_sql(device, bsql: dict, append: int = 10_000) -> dict:
    """The bm25_sql phase's table (100,000 docs and one INSERT of 10,000)
    with two more INSERTs of 10,000 docs (the same generator, seed 2): at
    least four segments. Its 256-query mix at serene_shards = 4 under the
    host and the device combine: rows equal bit for bit to each other and
    to shards = 1; merge_topk launched under the device combine only."""
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.search.index import find_index

    c, table, stmt, qs = bsql.pop("conn"), bsql.pop("table"), \
        bsql.pop("stmt"), bsql.pop("queries")
    extra, _ = dense_corpus(2 * append, seed=2)
    base = bsql["next_id"]
    t0 = time.perf_counter()
    for j in range(2):
        c.execute("INSERT INTO docs VALUES " + ", ".join(
            f"({base + j * append + i}, '{d}')"
            for i, d in enumerate(extra[j * append:(j + 1) * append])))
        c.execute(stmt.format(q=qs[0]))       # the new segment
    out = {"insert_s": time.perf_counter() - t0}
    segs = len(find_index(table, "body").searcher("body").segments)
    if segs < 4:
        fail(f"shard search through SQL: {segs} segments")
    out["segments"] = segs
    cells = ((1, "host"), (4, "host"), (4, "device"))
    ref, times = None, {cell: [] for cell in cells}
    for _ in range(3):                  # the cells in turn, three rounds
        for shards, combine in cells:
            c.execute(f"SET serene_shards = {shards}")
            c.execute(f"SET serene_shard_combine = {combine}")
            m0 = LAUNCHES.get("merge_topk")
            t0 = time.perf_counter()
            got = [c.execute(stmt.format(q=q)).rows() for q in qs]
            sync(device)
            times[(shards, combine)].append(
                (time.perf_counter() - t0) / len(qs) * 1e3)
            merges = LAUNCHES.get("merge_topk") - m0
            # a statement whose shards hold no candidate takes no merge
            if (merges > 0) != (combine == "device") or merges > len(qs):
                fail(f"shard search through SQL, shards={shards} combine="
                     f"{combine}: {merges} merge_topk launches")
            got = [_bits(r) for r in got]
            if ref is None:
                ref = got
            elif got != ref:
                fail(f"shard search through SQL, shards={shards} combine="
                     f"{combine}: rows differ from shards = 1")
    c.execute("SET serene_shards = 1")
    out["ms"] = {cell: float(np.median(t)) for cell, t in times.items()}
    out["statements"] = len(qs)
    return out


def phase_shards(device, bsql: dict) -> dict:
    """The sharded tier's three legs in one launch window."""
    from serenedb_tpu_torch.device import LAUNCHES
    LAUNCHES.reset()
    out = {"relational": {m: shard_relational(device, m)
                          for m in SHARD_SCALES},
           "search": shard_search(device),
           "search_sql": shard_search_sql(device, bsql)}
    out["launches"] = LAUNCHES.snapshot()
    for name in ("agg_scan", "join_probe", "merge_topk", "match_bitmap"):
        if not out["launches"].get(name):
            fail(f"sharded tier: {name} never launched")
    return out


def crafted_merge(device):
    """A batch of ties: equal scores across shards, a -0.0 / +0.0 pair,
    pads, -inf, and k past any shard's candidates."""
    import torch

    from serenedb_tpu_torch.ops.merge_kernels import PAD_DOC
    rng = np.random.default_rng(3)
    S, Q, L = 4, 8, 12
    scores = rng.choice(np.asarray([2.5, 2.5, 1.25, 0.0, -0.0, 3.75,
                                    -np.inf], dtype=np.float32), (S, Q, L))
    docs = np.empty((S, Q, L), dtype=np.int32)
    for q in range(Q):
        docs[:, q] = rng.choice(50 * S, S * L, replace=False).reshape(S, L)
    pads = rng.random((S, Q, L)) < 0.3
    scores[pads], docs[pads] = -np.inf, PAD_DOC
    return ((torch.from_numpy(scores).to(device),
             torch.from_numpy(docs).to(device), 20), {})


def check_merge_topk(device, args, reps=20) -> dict:
    """merge_topk against its plain version bit for bit; a call one kernel
    (MERGE_KERNELS) with no copy in (device ms); `torch.topk` over the
    same (Q, S * L) plane as its yardstick (it has no tie order: a
    yardstick of time only)."""
    import torch

    from serenedb_tpu_torch.ops import merge_kernels as mk
    a, kw = args
    vals, docs = mk.merge_topk(*a, **kw)
    ref_v, ref_d = mk.merge_topk_plain(*a, **kw)
    sync(device)
    if not torch.equal(docs, ref_d) or not torch.equal(
            vals.view(torch.int32), ref_v.view(torch.int32)):
        fail("merge_topk differs from its plain version")
    ms = timed_ms(lambda: mk.merge_topk(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: mk.merge_topk_plain(*a, **kw), reps, device)
    scores, dd = a[0], a[1]
    S, Q, L = scores.shape
    note = activity_note(lambda: mk.merge_topk(*a, **kw),
                         MERGE_KERNELS[S * L <= 32])
    plane = scores.permute(1, 0, 2).reshape(Q, S * L).contiguous()
    kk = min(a[2], S * L)
    lib_ms = timed_ms(lambda: torch.topk(plane, kk), reps, device)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes(scores, dd, vals, docs)),
            "bound_by": "bytes", "library_ms": lib_ms, "note": note,
            "shape": f"(S, Q, L)={tuple(scores.shape)} k={a[2]}"}


def packed_bitmap_args(device, searcher, nodes):
    """match_bitmap's arguments for the first `a | b` item of phase 4's
    mix over the packed corpus (8,000,512 docs), as phase 17 builds its
    calls."""
    import torch

    from serenedb_tpu_torch.ops import bm25 as bm25_ops
    node = nodes[len(packed_queries()) // 2]      # the first disjunction
    store = searcher._device_store()
    tids = searcher._query_shape(node)[0]
    qb = bm25_ops.assemble_query_batch(
        store, searcher.num_docs, [(np.asarray(tids, dtype=np.int64), 0)],
        searcher.index.doc_freq)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.int32)).to(device)
    return ((store.block_base, store.block_gaps, store.block_tfs8,
             t(qb.row_idx), store.raw_docs, t(qb.raw_idx), t(qb.tail_docs),
             store.ndocs_pad), {})


def check_match_bitmap(device, args, reps=20) -> dict:
    """match_bitmap against its plain version bit for bit; one launch a
    call; its kernel's device ms (`queued_ms`: the calls queued behind a
    spin, so no host time) beside the wrapper's whole call."""
    import torch

    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.ops import bm25_kernels as kern
    a, kw = args
    before = LAUNCHES.get("match_bitmap")
    got = kern.match_bitmap(*a, **kw)
    if LAUNCHES.get("match_bitmap") != before + 1:
        fail("a match_bitmap call is not one launch")
    ref = kern.match_bitmap_plain(*a, **kw)
    sync(device)
    if not torch.equal(got, ref):
        fail("match_bitmap differs from its plain version")
    ms = timed_ms(lambda: kern.match_bitmap(*a, **kw), reps, device)
    dev_ms = queued_ms(lambda: kern.match_bitmap(*a, **kw), reps, device)
    plain_ms = timed_ms(lambda: kern.match_bitmap_plain(*a, **kw), reps,
                        device)
    _b, _g, _t, row_idx, _raw, raw_idx, tail, ndocs_pad = a
    # each selected packed row: its base, 128 gaps and tfs, its index;
    # each raw row: 128 docs and its index; each tail doc; the bitmap
    moved = row_idx.numel() * (4 + 128 * 3 + 4) + \
        raw_idx.numel() * (128 * 4 + 4) + tail.numel() * 4 + ndocs_pad
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(moved), "bound_by": "bytes",
            "library_ms": None, "device_ms": dev_ms,
            "shape": f"packed rows={row_idx.numel()} raw rows="
                     f"{raw_idx.numel()} tails={tail.numel()} "
                     f"ndocs_pad={ndocs_pad}"}


def check_k13_aggs(device, reps=10) -> dict:
    """The K13 entries of ops/agg.py on the relational leg's 1x probe
    columns (g as codes, v, the rows with v > 0 as the mask): each entry
    through agg_scan (and agg_fold for the f32 sum) against the same entry
    with those wrappers' plain versions swapped in, both on the card:
    integers equal, the f32 sum bit for bit; and
    group_count equal to numpy's count. Returns per entry its agg_scan
    call's ms, the whole entry's, the plain version's and its bound
    (bytes: the tiles it reads once, its outputs written once), and under
    "index_add_" the yardstick: one `index_add_` of v into the 16 groups."""
    import torch

    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.ops import agg
    from serenedb_tpu_torch.ops import agg_kernels as K
    sp = shard_tables(1)["sp"]
    n = len(sp["g"])
    rows = -(-n // 128)

    def tiles(a, dtype):
        t = np.zeros(rows * 128, dtype=dtype)
        t[:n] = a
        return torch.from_numpy(t.reshape(rows, 128)).to(device)
    v = sp["v"].astype(np.int32)
    d = {"codes": tiles(sp["g"], np.int32), "mask": tiles(v > 0, bool),
         "v": tiles(v, np.int32), "f": tiles(v / 7.0, np.float32)}
    entries = {     # entry, the tiles it reads
        "masked_count": (lambda: agg.masked_count(d["mask"]), ("mask",)),
        "masked_sum_float": (lambda: agg.masked_sum_float(d["f"],
                                                          d["mask"]),
                             ("f", "mask")),
        "masked_minmax min": (lambda: agg.masked_minmax(d["v"], d["mask"],
                                                        "min"),
                              ("v", "mask")),
        "masked_minmax max": (lambda: agg.masked_minmax(d["f"], d["mask"],
                                                        "max"),
                              ("f", "mask")),
        "group_count_onehot": (lambda: agg.group_count_onehot(
            d["codes"], d["mask"], 16), ("codes", "mask")),
    }
    kernels = (K.agg_scan, K.agg_fold)

    def plain(fn):
        K.agg_scan, K.agg_fold = K.agg_scan_plain, K.agg_fold_plain
        try:
            return fn()
        finally:
            K.agg_scan, K.agg_fold = kernels
    out = {}
    for name, (fn, reads) in entries.items():
        l0 = LAUNCHES.get("agg_scan")
        with FirstCalls(K, "agg_scan") as rec:
            rec.current = name
            got = fn()
        ref = plain(fn)
        sync(device)
        if LAUNCHES.get("agg_scan") <= l0:
            fail(f"{name} did not launch agg_scan")
        if name == "masked_sum_float":
            if not same_f32(got, ref):
                fail("masked_sum_float differs from its plain version")
        elif not torch.equal(got, ref):
            fail(f"{name} differs from its plain version")
        a, kw = rec.calls[name]
        out[name] = {"ms": timed_ms(lambda: K.agg_scan(*a, **kw), reps,
                                    device),
                     "entry_ms": timed_ms(fn, reps, device),
                     "plain_ms": timed_ms(lambda: plain(fn), reps, device),
                     "bound_ms": bound_ms(nbytes(*(d[t] for t in reads),
                                                 got))}
    idx = d["codes"].reshape(-1).to(torch.int64)
    vals = d["v"].reshape(-1).to(torch.int64)

    def library():
        torch.zeros(16, dtype=torch.int64, device=device).index_add_(
            0, idx, vals)
    out["index_add_"] = timed_ms(library, reps, device)
    counts = agg.group_count(d["codes"], d["mask"], 16)
    if not np.array_equal(counts, np.bincount(sp["g"][sp["v"] > 0],
                                              minlength=16)):
        fail("group_count differs from the host count")
    return out


# ------------------------------------------------------------ the durable tier

HITS_DDL = ("CREATE TABLE hits (UserID BIGINT, RegionID INT, "
            "AdvEngineID INT, SearchPhrase TEXT, SearchEngineID INT, "
            "ResolutionWidth INT)")
#: the digest of every `hits` row the durable phase reads back
HITS_DIGEST = ("SELECT count(*), sum(RegionID), sum(AdvEngineID), "
               "sum(SearchEngineID), sum(ResolutionWidth), min(UserID), "
               "max(UserID), count(DISTINCT SearchPhrase) FROM hits")


def extra_hits_columns(n: int) -> dict:
    """n more `hits` rows (seed 4) in hits_columns' layout, with
    ResolutionWidth in [5000, 6000): past every generated row's, so T4's
    ten rows after the crash are acknowledged ones."""
    from serenedb_tpu_torch.columnar.column import Column
    rng = np.random.default_rng(4)
    phrases = np.asarray([f"phrase {i}" for i in range(1, 100)],
                         dtype=object)
    return {
        "UserID": Column.from_numpy(rng.integers(0, 1 << 62, n,
                                                 dtype=np.int64)),
        "RegionID": Column.from_numpy(
            rng.integers(0, 9000, n).astype(np.int32)),
        "AdvEngineID": Column.from_numpy(
            rng.integers(0, 64, n).astype(np.int32)),
        "SearchPhrase": Column.from_numpy(phrases[rng.integers(0, 99, n)]),
        "SearchEngineID": Column.from_numpy(
            rng.integers(0, 100, n).astype(np.int32)),
        "ResolutionWidth": Column.from_numpy(
            rng.integers(5000, 6000, n).astype(np.int32)),
    }


def dir_bytes(path: str) -> int:
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def durable_check(device, db, hits, docs, qs, label: str, window) -> dict:
    """A reopened durable database against an in-memory one built from
    the same rows: phase 7's six queries and T4 on 'gpu' equal to 'cpu'
    on the recovered tables and to the in-memory database's, agg_scan
    and topn_scan launched; every row read back (the digest, the rows
    past the generated ones); the 256-query @@ + bm25() mix bit-equal to
    the in-memory database's and held to the host WAND (bench.py's
    rule). `window` counts the durable database's launches only."""
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.search.index import find_index

    mem = Database(device=device)
    mem.schemas["main"].tables["hits"] = MemTable("hits", hits)
    mem.schemas["main"].tables["docs"] = MemTable("docs", docs)
    mc = mem.connect()
    _, native_s = native_build(
        f"durable {label} (in memory)", lambda: mc.execute(
            "CREATE INDEX db ON docs USING inverted (body) WITH "
            "(tokenizer = 'simple')"))
    c, cs = db.connect(), db.connect()
    for conn in (c, mc):
        conn.execute("SET serene_result_cache = off")
    reads = [HITS_DIGEST,
             "SELECT * FROM hits WHERE ResolutionWidth >= 4000",
             "SELECT count(*), min(id), max(id) FROM docs"]
    for q in reads:
        got, want = c.execute(q).rows(), mc.execute(q).rows()
        if got != want:
            fail(f"durable {label}: {got[:3]} read back, {want[:3]} "
                 f"acknowledged: {q!r}")
    queries = [(q, AGG) for q in HITS_QUERIES] + \
        [(q, TOPN) for q in HITS_TOPN]
    c.execute("SET serene_device = 'cpu'")
    t0 = time.perf_counter()
    cpu = [c.execute(q).rows() for q, _k in queries]
    cpu_s = time.perf_counter() - t0
    c.execute("SET serene_device = 'gpu'")
    mc.execute("SET serene_device = 'gpu'")
    gpu_ms = []
    for (q, kernels), want in zip(queries, cpu):
        before = {k: LAUNCHES.get(k) for k in kernels}
        t0 = time.perf_counter()
        got = window(lambda: c.execute(q).rows())
        sync(device)
        gpu_ms.append((time.perf_counter() - t0) * 1e3)
        for k in kernels:
            if LAUNCHES.get(k) <= before[k]:
                fail(f"durable {label}: {k} did not launch for {q!r}")
        if got != want:
            fail(f"durable {label}: 'gpu' differs from 'cpu' on {q!r}")
        if mc.execute(q).rows() != want:
            fail(f"durable {label}: the in-memory database differs on {q!r}")
    stmt = ("SELECT id, bm25(body) AS s FROM docs WHERE body @@ '{q}' "
            "ORDER BY s DESC LIMIT 10")
    t0 = time.perf_counter()
    rows = window(lambda: [cs.execute(stmt.format(q=q)).rows() for q in qs])
    sync(device)
    search_ms = (time.perf_counter() - t0) / len(qs) * 1e3
    mrows = [mc.execute(stmt.format(q=q)).rows() for q in qs]
    if rows != mrows:
        bad = next(i for i, (a, b) in enumerate(zip(rows, mrows)) if a != b)
        fail(f"durable {label}: query {bad}'s rows {rows[bad][:3]} differ "
             f"from the in-memory database's {mrows[bad][:3]}")
    table = db.schemas["main"].tables["docs"]
    checked = wand_parity(f"durable {label}", find_index(
        table, "body").searcher("body"), qs, rows)
    mem.close()
    return {"cpu_s": cpu_s, "gpu_ms": gpu_ms, "search_ms": search_ms,
            "checked": checked, "mem_native_s": native_s,
            "rows": hits.num_rows}


def phase_durable(device, n_hits=10_000_000, n_docs=100_000,
                  append=10_000, n_extra=1_000) -> dict:
    """The durable tier on the card, in a fresh data directory removed at
    the end: phase 7's `hits` table (10,000,000 rows, seed 3) and phase
    13's corpus (100,000 docs) put into durable tables through SQL
    (CREATE TABLE, INSERT ... SELECT from registered in-memory tables,
    VACUUM, CREATE INDEX ... USING inverted); close(), reopen on the
    card; INSERT 10,000 docs and 1,000 `hits` rows, acknowledged, then
    crash() (no flush); reopen again. Each reopen is held by
    durable_check. The native indexer builds every index."""
    import shutil
    import tempfile

    from serenedb_tpu_torch.columnar.column import Batch, concat_batches
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.native import BUILDS

    launches = {}

    def window(fn):
        """fn() with its launches added to the phase's count."""
        before = LAUNCHES.snapshot()
        out = fn()
        for k, n in LAUNCHES.snapshot().items():
            if n - before.get(k, 0):
                launches[k] = launches.get(k, 0) + n - before.get(k, 0)
        return out

    t0 = time.perf_counter()
    hits = Batch.from_pydict(hits_columns(n_hits))
    more = Batch.from_pydict(extra_hits_columns(n_extra))
    texts, qs = dense_corpus(n_docs + append)
    docs = Batch.from_pydict({"id": np.arange(n_docs + append,
                                              dtype=np.int64),
                              "body": texts})
    out = {"gen_s": time.perf_counter() - t0, "s": {}, "bytes": {},
           "checks": {}}
    s = out["s"]
    native0 = BUILDS.get("native_ns")
    LAUNCHES.reset()
    datadir = tempfile.mkdtemp(prefix="serenedb_durable_")
    try:
        db = Database(datadir, device=device)
        c = db.connect()
        src = db.schemas["main"].tables
        src["hits_src"] = MemTable("hits_src", hits)
        src["docs_src"] = MemTable("docs_src", docs.slice(0, n_docs))
        t0 = time.perf_counter()
        window(lambda: [c.execute(q) for q in (
            HITS_DDL, "INSERT INTO hits SELECT * FROM hits_src",
            "CREATE TABLE docs (id BIGINT, body TEXT)",
            "INSERT INTO docs SELECT * FROM docs_src")])
        s["write"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        c.execute("VACUUM hits")
        c.execute("VACUUM docs")
        s["checkpoint"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        native_build("durable CREATE INDEX", lambda: window(lambda: c.execute(
            "CREATE INDEX db ON docs USING inverted (body) WITH "
            "(tokenizer = 'simple')")))
        s["create index"] = time.perf_counter() - t0
        del src["hits_src"], src["docs_src"]
        t0 = time.perf_counter()
        db.close()
        s["close"] = time.perf_counter() - t0
        out["bytes"]["after close"] = dir_bytes(datadir)

        t0 = time.perf_counter()
        db, _ = native_build("durable recovery 1", lambda: window(
            lambda: Database(datadir, device=device)))
        s["recover 1"] = time.perf_counter() - t0
        out["checks"]["after close"] = durable_check(
            device, db, hits, docs.slice(0, n_docs), qs, "after close",
            window)

        c = db.connect()
        src = db.schemas["main"].tables
        src["hits_more"] = MemTable("hits_more", more)
        src["docs_more"] = MemTable("docs_more", docs.slice(n_docs,
                                                            n_docs + append))
        t0 = time.perf_counter()
        window(lambda: [c.execute(q) for q in (
            "INSERT INTO docs SELECT * FROM docs_more",
            "INSERT INTO hits SELECT * FROM hits_more")])
        s["acknowledged writes"] = time.perf_counter() - t0
        del src["hits_more"], src["docs_more"]
        db.crash()
        out["bytes"]["after crash"] = dir_bytes(datadir)

        t0 = time.perf_counter()
        db, _ = native_build("durable recovery 2", lambda: window(
            lambda: Database(datadir, device=device)))
        s["recover 2"] = time.perf_counter() - t0
        out["checks"]["after crash"] = durable_check(
            device, db, concat_batches([hits, more]), docs, qs,
            "after crash", window)
        db.close()
    finally:
        shutil.rmtree(datadir, ignore_errors=True)
    for k in ("agg_scan", "topn_scan"):
        if not launches.get(k):
            fail(f"durable: {k} never launched ({launches})")
    out["native_s"] = (BUILDS.get("native_ns") - native0) / 1e9
    out["launches"] = launches
    return out


#: the mesh width of phase 21: a virtual mesh over cuda:0 unless the
#: host has this many cards
MESH_WIDTH = 4


def _mesh_bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def check_mesh_kernel(device, name: str, args, reps: int = 10) -> dict:
    """One recorded call of a mesh kernel against its plain version on the
    card: bit for bit, its time and the plain version's (CUDA events),
    and its byte bound (each input read once, each output written once;
    for mesh_score_blocks the valid entries' gathers)."""
    import torch

    from serenedb_tpu_torch.ops import mesh_kernels as MK
    a, kw = args
    kern, plain = getattr(MK, name), getattr(MK, name + "_plain")
    got, ref = kern(*a, **kw), plain(*a, **kw)
    sync(device)
    got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
    ref = tuple(ref) if isinstance(ref, (tuple, list)) else (ref,)
    if len(got) != len(ref):
        fail(f"{name}: {len(got)} outputs, the plain version {len(ref)}")
    err = 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape or not _mesh_bits_equal(g, r):
            fail(f"{name} differs from its plain version")
        if g.dtype.is_floating_point:
            err = max(err, float((g - r).abs().nan_to_num().max()))
    if name == "mesh_combine":
        parts = list(a[0])
        moved = nbytes(*parts) + nbytes(parts[0])
        shape = (f"M={len(parts)} parts of N={parts[0].numel()} "
                 f"{parts[0].dtype} {a[1]}, read where they lie")
    elif name == "mesh_combine_many":
        segs = MK._segments(a[0])
        moved = sum(nbytes(*parts) + nbytes(parts[0])
                    for parts, _op, _u in segs)
        kinds: dict = {}
        for parts, op, u in segs:
            k = (f"{str(parts[0].dtype).split('.')[-1]} "
                 f"{op}{' as u32' if u else ''}")
            kinds[k] = kinds.get(k, 0) + 1
        shape = (f"{len(segs)} segments of M={len(segs[0][0])} parts, N "
                 f"{min(p[0].numel() for p, _o, _u in segs)}-"
                 f"{max(p[0].numel() for p, _o, _u in segs)}: " +
                 ", ".join(f"{n} x {k}" for k, n in kinds.items()) +
                 f"; {len(MK.combine_launches(segs))} launch(es)")
    elif name == "mesh_agg_partials":
        vals, mask = a[0], a[1]
        moved = nbytes(vals, mask) + (1 + 2 * vals.shape[0]) * 4
        shape = f"R={vals.shape[0]} x 128"
    else:
        gidx, nd = a[3], a[7]
        valid = int((gidx >= 0).sum())
        per = 12 if a[8] == "bm25" else 8
        moved = nbytes(gidx) + valid * per + nd * 4 + \
            (nbytes(a[4]) if a[4] is not None else 0)
        shape = (f"entries={gidx.numel()} valid={valid} ndocs={nd} "
                 f"mode={a[8]}, scratch "
                 f"{MK.score_plan(gidx.numel(), nd).bytes} bytes a call")
    out = {"ms": timed_ms(lambda: kern(*a, **kw), reps, device),
           "plain_ms": timed_ms(lambda: plain(*a, **kw), max(1, reps // 5),
                                device),
           "bound_ms": bound_ms(moved), "bound_by": "bytes",
           "library_ms": None, "max_abs_err": err, "shape": shape}
    if name == "mesh_combine":
        # the library's reductions over the same values stacked (M, N): a
        # yardstick that promises no shard order (the kernel folds in
        # shard order). The two are a few µs apart on a ~0.8 ms call, and
        # a window of back-to-back calls also holds its first call's host
        # time (the wrapper's ~0.1 ms is ~1 % of a 10-call window), so
        # the kernel and the library's reduction of its op take turns in
        # MESH_ROUNDS rounds, each timed as whole calls (timed_ms) and on
        # the card alone (queued_ms), and each reports its median round
        stack = torch.stack([p.reshape(-1) for p in parts])
        lib = {"sum": lambda: stack.sum(0), "min": lambda: stack.amin(0),
               "max": lambda: stack.amax(0)}
        rounds = {"kernel": [], "library": [], "kernel device": [],
                  "library device": []}
        for _ in range(MESH_ROUNDS):
            for what, f in (("kernel", lambda: kern(*a, **kw)),
                            ("library", lib[a[1]])):
                rounds[what].append(timed_ms(f, reps, device))
                rounds[what + " device"].append(queued_ms(f, reps, device))
        out["rounds"] = rounds
        med = {k: float(np.median(v)) for k, v in rounds.items()}
        out["ms"], out["device_ms"] = med["kernel"], med["kernel device"]
        out["library_device_ms"] = med["library device"]
        out["library_all"] = {op: timed_ms(f, reps, device)
                              for op, f in lib.items() if op != a[1]}
        out["library_all"][a[1]] = med["library"]
        out["library_ms"] = out["library_all"][a[1]]
        del stack
    return out


#: rounds of mesh_combine's kernel and library timings, taken in turn
MESH_ROUNDS = 7


def _mesh_window(window: dict, launches: dict) -> None:
    for k, v in launches.items():
        window[k] = window.get(k, 0) + v


def mesh_sql(device, width: int, window: dict, n_q1: int = 100_000_000,
             n_hits: int = 10_000_000, rec=None) -> dict:
    """Phase 6's q1 (100M rows: its two scalar and its GROUP BY queries,
    T1) and phase 7's hits (T4) at serene_mesh = width against
    serene_mesh = 0 on the card: rows equal (integers); agg_scan a
    multiple of `width` launches a query (one a shard a chunk) with
    mesh_combine, topn_scan `width` for T1. `rec` (a Recorder) is
    entered around the first mesh run of q1's GROUP BY query."""
    import contextlib

    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable

    out = {"ms": {}, "single_ms": {}}
    t0 = time.perf_counter()
    legs = (("q1", q1_columns(n_q1),
             [(q, "agg") for q in Q1_QUERIES] + [(Q1_TOPN[0], "topn")]),
            ("hits", hits_columns(n_hits), [(HITS_TOPN[0], "fused")]))
    out["gen_s"] = time.perf_counter() - t0
    for label, cols, queries in legs:
        db = Database(device=device)
        db.schemas["main"].tables["hits"] = MemTable(
            "hits", Batch.from_pydict(cols))
        c = db.connect()
        c.execute("SET serene_result_cache = off")
        c.execute("SET serene_device = 'gpu'")
        for q, kind in queries:
            c.execute("SET serene_mesh = 0")
            c.execute(q).rows()                        # cold: uploads
            t0 = time.perf_counter()
            single = c.execute(q).rows()
            sync(device)
            out["single_ms"][(label, q)] = (time.perf_counter() - t0) * 1e3
            c.execute(f"SET serene_mesh = {width}")
            LAUNCHES.reset()
            with (rec if rec is not None and (label, q) ==
                  ("q1", Q1_QUERIES[2]) else contextlib.nullcontext()):
                c.execute(q).rows()
            t0 = time.perf_counter()
            got = c.execute(q).rows()
            sync(device)
            out["ms"][(label, q)] = (time.perf_counter() - t0) * 1e3
            d = LAUNCHES.snapshot()
            _mesh_window(window, d)
            if got != single:
                fail(f"mesh {label}: serene_mesh = {width} differs from "
                     f"serene_mesh = 0 on {q!r}")
            # a chunk: an agg_scan a shard and one mesh_combine launch
            if kind == "agg" and (not d.get("agg_scan") or
                                  d["agg_scan"] % width or
                                  d.get("mesh_combine", 0) * width !=
                                  d["agg_scan"]):
                fail(f"mesh {label}: {q!r} launched {d}")
            if kind == "topn" and d.get("topn_scan") != 2 * width:
                fail(f"mesh {label}: T1 launched {d}")
        c.execute("SET serene_mesh = 0")
        del db, c
    return out


def mesh_search(device, searcher, nodes, width: int, window: dict) -> dict:
    """The packed corpus (phase 4's searcher) through topk_batch(mesh_n =
    width): its require-free queries in batches of 16, top-10 within
    rtol 2e-3 / atol 1e-3 of the single-device result, ids differing only
    on ties; each batch width bm25_accumulate calls (a shard's plane
    each) and one mesh_combine; the batches' peak device memory, and the
    most one batch took above what was allocated before it (the
    recorder around this leg holds the first batch's planes, so a peak
    over all the batches above one base would count them twice)."""
    import torch

    from serenedb_tpu_torch.device import LAUNCHES
    free = [n for n in nodes if not searcher._query_shape(n)[1]][:64]
    batches = [free[i:i + 16] for i in range(0, len(free), 16)]
    single = [searcher.topk_batch(b, 10) for b in batches]
    out = {"queries": len(free), "batches": len(batches)}
    LAUNCHES.reset()
    sync(device)
    got, ms, peaks = [], 0.0, []
    for b in batches:
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        got.append(searcher.topk_batch(b, 10, mesh_n=width))
        sync(device)
        ms += time.perf_counter() - t0
        top = torch.cuda.max_memory_allocated(device)
        peaks.append((top, top - base))
    out["ms"] = ms * 1e3 / len(batches)
    out["peak_bytes"] = max(p[0] for p in peaks)
    out["peak_over_base"] = max(p[1] for p in peaks)
    d = LAUNCHES.snapshot()
    _mesh_window(window, d)
    if d.get("mesh_combine") != len(batches) or \
            d.get("topk_rows") != len(batches) or \
            d.get("bm25_accumulate", 0) < width * len(batches):
        fail(f"mesh search: launches {d}")
    ties = 0
    for bs, bg in zip(single, got):
        for (s1, d1), (s2, d2) in zip(bs, bg):
            if len(s1) != len(s2):
                fail("mesh search: result lengths differ")
            np.testing.assert_allclose(s2, s1, rtol=PARITY_RTOL,
                                       atol=PARITY_ATOL)
            for j in np.flatnonzero(d1 != d2):
                if not np.isclose(s1, s1[j], rtol=PARITY_RTOL,
                                  atol=PARITY_ATOL).sum() > 1:
                    fail("mesh search: ids differ off a tie")
                ties += 1
    out["tie_swaps"] = ties
    t0 = time.perf_counter()
    for b in batches:
        searcher.topk_batch(b, 10)
    sync(device)
    out["single_ms"] = (time.perf_counter() - t0) * 1e3 / len(batches)
    return out


def mesh_shards(device, width: int, window: dict, m: int = 1,
                seg_docs: int = 250_000, vocab: int = 20_000,
                postings: int = 3_000_000, rec=None) -> dict:
    """Phase 17's join (1x) at serene_shards = width with the device
    combine, now over a mesh of `width`: rows equal to shards = 1, a warm
    execution one join_probe a mesh device and mesh_combine; its search
    leg (4 x 250,000 docs) at shards = width, device combine: a merge a
    mesh device and one over their results, bit-equal to shards = 1.
    `rec` (a Recorder) is entered around the join's cold execution."""
    import contextlib
    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.search.analysis import get_analyzer
    from serenedb_tpu_torch.search.query import parse_query
    from serenedb_tpu_torch.search.searcher import (MultiSearcher,
                                                    SegmentSearcher)
    from serenedb_tpu_torch.utils.config import REGISTRY as settings

    db = Database(device=device)
    for name, cols in shard_tables(m).items():
        db.schemas["main"].tables[name] = MemTable(name,
                                                   Batch.from_pydict(cols))
    c = db.connect()
    for s in ("SET serene_result_cache = off", "SET serene_device_fused = on",
              "SET serene_morsel_rows = 131072", "SET serene_workers = 4",
              "SET serene_device = 'gpu'"):
        c.execute(s)
    ref = c.execute(SHARD_QUERY).rows()
    c.execute(f"SET serene_shards = {width}")
    c.execute("SET serene_shard_combine = device")
    LAUNCHES.reset()
    with rec if rec is not None else contextlib.nullcontext():
        cold = c.execute(SHARD_QUERY).rows()
    t0 = time.perf_counter()
    warm = c.execute(SHARD_QUERY).rows()
    sync(device)
    out = {"join_ms": (time.perf_counter() - t0) * 1e3}
    d = LAUNCHES.snapshot()
    _mesh_window(window, d)
    if cold != ref or warm != ref:
        fail(f"mesh join: shards {width} over the mesh differs from "
             "shards = 1")
    # cold and warm: a join_probe a mesh device and one combine launch
    if d.get("join_probe") != 2 * width or d.get("mesh_combine") != 2:
        fail(f"mesh join: launches {d}")
    out["groups"] = len(ref)

    an = get_analyzer("simple")
    ms = MultiSearcher(an)
    for si in range(4):
        fi = synth_posting_index(seg_docs, vocab, postings, 11 + si, device)
        ms.add_segment(SegmentSearcher(fi, an, seg_docs, device=device),
                       si * seg_docs)
    terms = [f"w{100 + 13 * i:07d}" for i in range(32)]
    nodes = [parse_query(f"{terms[2 * i]} | {terms[2 * i + 1]}", an)
             for i in range(16)]
    names = ("serene_shards", "serene_shard_combine", "serene_result_cache")
    prior = {n: settings.get_global(n) for n in names}
    try:
        settings.set_global("serene_result_cache", False)
        settings.set_global("serene_shards", 1)
        ref = ms.topk_batch(nodes, 10)
        settings.set_global("serene_shards", width)
        settings.set_global("serene_shard_combine", "device")
        ms.topk_batch(nodes, 10)
        LAUNCHES.reset()
        t0 = time.perf_counter()
        got = ms.topk_batch(nodes, 10)
        sync(device)
        out["merge_ms"] = (time.perf_counter() - t0) * 1e3
        d = LAUNCHES.snapshot()
        _mesh_window(window, d)
    finally:
        for n, v in prior.items():
            settings.set_global(n, v)
    if d.get("merge_topk") != width + 1:
        fail(f"mesh merge: launches {d}")
    for (s, dd), (rs, rd) in zip(got, ref):
        if not (np.array_equal(s.view(np.uint32), rs.view(np.uint32)) and
                np.array_equal(dd, rd)):
            fail("mesh merge: differs from shards = 1")
    return out


def mesh_builders(device, searcher, width: int, window: dict, recs: dict,
                  n: int = 100_000_000) -> dict:
    """The reference's three builders over the mesh: sharded_agg_step on
    phase 6's 100M-row column, sharded_bm25_topk on the packed corpus's
    postings of four of its terms, sharded_query_step over all its
    postings with q1's columns as values and groups; each against a
    one-device mesh and exact numpy answers."""
    import torch

    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.ops import bm25 as bm25_ops
    from serenedb_tpu_torch.ops import mesh_kernels as MK
    from serenedb_tpu_torch.parallel import mesh as pmesh

    cols = q1_columns(n)
    x, region = cols["x"].data, cols["region"].data
    del cols
    rows = -(-n // 128)
    rows += (-rows) % width

    def tiles(a, fill=0):
        t = np.full(rows * 128, fill, dtype=a.dtype)
        t[:n] = a
        return torch.from_numpy(t.reshape(rows, 128)).to(device)
    vals, codes = tiles(x), tiles(region)
    valid = np.zeros(rows * 128, dtype=bool)
    valid[:n] = True
    mask = torch.from_numpy(valid.reshape(rows, 128)).to(device)
    fi, store = searcher.index, searcher._device_store()
    flat_docs = torch.from_numpy(fi.post_docs.astype(np.int32)).to(device)
    flat_tfs = torch.from_numpy(fi.post_tfs.astype(np.int32)).to(device)
    tids = [1 + 97 * i for i in range(4)]
    g_rows, bt = [], []
    for j, t in enumerate(tids):
        r = np.arange(fi.offsets[t], fi.offsets[t + 1], dtype=np.int64)
        r = np.concatenate([r, np.full((-len(r)) % 128, -1)])
        g_rows.append(r.reshape(-1, 128))
        bt.append(np.full(len(r) // 128, j, dtype=np.int32))
    g = np.concatenate(g_rows).astype(np.int32)
    bt = np.concatenate(bt)
    pad = (-len(g)) % width
    g = np.concatenate([g, np.full((pad, 128), -1, np.int32)])
    bt = np.concatenate([bt, np.zeros(pad, np.int32)])
    gidx = torch.from_numpy(g).to(device)
    block_term = torch.from_numpy(bt).to(device)
    idf = torch.from_numpy(bm25_ops.idf_lucene(
        searcher.num_docs, fi.doc_freq[tids]).astype(np.float32)).to(device)
    avgdl = float(fi.avgdl)
    P = flat_docs.numel()
    ga = np.arange(P + (-P) % (128 * width), dtype=np.int64)
    ga[P:] = -1
    gall = torch.from_numpy(ga.astype(np.int32).reshape(-1, 128)).to(device)
    ball = torch.zeros(gall.shape[0], dtype=torch.int32, device=device)
    lo, hi = 1000, 90_000

    def run(m):
        mesh = pmesh.make_mesh(m, base=device)
        a = pmesh.sharded_agg_step(mesh)(vals, mask, lo, hi)
        b = pmesh.sharded_bm25_topk(mesh, store.ndocs_pad, 10)(
            flat_docs, flat_tfs, store.norms, gidx, block_term, idf, avgdl)
        q = pmesh.sharded_query_step(mesh, 200)(
            vals, mask, codes, flat_docs, flat_tfs, gall, ball)
        sync(device)
        return a, b, q

    LAUNCHES.reset()
    with recs["mesh_agg_partials"], recs["mesh_score_blocks"], \
            recs["mesh_score_blocks saturation"]:
        t0 = time.perf_counter()
        a, b, q = run(width)
        out = {"ms": (time.perf_counter() - t0) * 1e3}
    d = LAUNCHES.snapshot()
    _mesh_window(window, d)
    if d.get("mesh_agg_partials") != width or \
            d.get("mesh_score_blocks") != 2 * width or \
            d.get("mesh_combine") != 3:
        fail(f"mesh builders: launches {d}")
    t0 = time.perf_counter()
    a1, b1, q1 = run(1)
    out["single_ms"] = (time.perf_counter() - t0) * 1e3
    sel = valid[:n] & (x >= lo) & (x < hi)
    want = int(x[sel].astype(np.int64).sum())
    got = pmesh.combine_agg_partials(a[1])
    if int(a[0]) != int(sel.sum()) or got != want or \
            got != pmesh.combine_agg_partials(a1[1]) or \
            int(a1[0]) != int(a[0]):
        fail("mesh builders: sharded_agg_step differs from the exact sum")
    np.testing.assert_allclose(b[0].cpu().numpy(), b1[0].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    s1 = b1[0].cpu().numpy()
    for j in np.flatnonzero(b[1].cpu().numpy() != b1[1].cpu().numpy()):
        if not np.isclose(s1, s1[j], rtol=RTOL, atol=ATOL).sum() > 1:
            fail("mesh builders: sharded_bm25_topk ids differ off a tie")
    sel = x >= 0
    counts = np.bincount(region[sel], minlength=200)
    sums = np.bincount(region[sel], weights=x[sel].astype(np.float64),
                       minlength=200)
    if not np.array_equal(q[0].cpu().numpy(), counts.astype(np.float32)):
        fail("mesh builders: sharded_query_step counts differ")
    np.testing.assert_allclose(q[1].cpu().numpy(), sums, rtol=SQL_REL)
    np.testing.assert_allclose(q[2].cpu().numpy(), q1[2].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    out["postings"] = int((gidx >= 0).sum())
    out["all_postings"] = P
    out["top1"] = float(s1[0])
    return out


def phase_mesh(device, searcher, nodes, width: int = MESH_WIDTH,
               sizes: dict = None) -> dict:
    """Phase 21: the mesh on the card. A `width`-wide virtual mesh over
    the card (or the host's cards where it has `width`): the SQL, search
    and sharded legs and the three builders, then each new kernel against
    its plain version on a recorded call; the device count and the
    'auto' combine restored afterwards."""
    import contextlib

    import torch

    from serenedb_tpu_torch.exec import shard as pshard
    from serenedb_tpu_torch.ops import mesh_kernels as MK
    from serenedb_tpu_torch.parallel import mesh as pmesh
    from serenedb_tpu_torch.utils.config import REGISTRY as settings

    sizes = sizes or {}
    real = torch.cuda.device_count() >= width
    plane = 16 * searcher._device_store().ndocs_pad
    before = (pmesh.device_count_if_initialized(),
              pshard.combine_mode(None))
    window: dict = {}
    recs = {"mesh_combine": Recorder(
                MK, "mesh_combine",
                pick=lambda a, kw: len(a[0]) == width and
                a[0][0].numel() == plane),
            "mesh_agg_partials": Recorder(MK, "mesh_agg_partials"),
            "mesh_score_blocks": Recorder(
                MK, "mesh_score_blocks", pick=lambda a, kw: a[8] == "bm25"),
            "mesh_score_blocks saturation": Recorder(
                MK, "mesh_score_blocks",
                pick=lambda a, kw: a[8] == "saturation"),
            # apply_axis_combines' calls of more than one output: a q1
            # GROUP BY chunk's and the collective join's
            "mesh_combine_many q1 GROUP BY chunk": Recorder(
                MK, "mesh_combine_many", pick=lambda a, kw: len(a[0]) > 1),
            "mesh_combine_many join": Recorder(
                MK, "mesh_combine_many", pick=lambda a, kw: len(a[0]) > 1)}
    scope = contextlib.nullcontext() if real else \
        pmesh.virtual_devices(width)
    out = {"placement": f"{width} cards" if real else
           f"a virtual mesh of {width} over {device}"}
    prior = settings.get_global("serene_shard_combine")
    with scope:
        if pmesh.device_count(device) < width:
            fail(f"mesh: {pmesh.device_count(device)} devices")
        out["sql"] = mesh_sql(device, width, window,
                              rec=recs["mesh_combine_many q1 GROUP BY "
                                       "chunk"], **sizes.get("sql", {}))
        with recs["mesh_combine"]:
            out["search"] = mesh_search(device, searcher, nodes, width,
                                        window)
        out["shards"] = mesh_shards(device, width, window,
                                    rec=recs["mesh_combine_many join"],
                                    **sizes.get("shards", {}))
        out["builders"] = mesh_builders(device, searcher, width, window,
                                        recs, **sizes.get("builders", {}))
    settings.set_global("serene_shard_combine", "auto")
    after = (pmesh.device_count_if_initialized(), pshard.combine_mode(None))
    settings.set_global("serene_shard_combine", prior)
    before_auto = before[1] if prior == "auto" else None
    if after[0] != before[0] or (before_auto and after[1] != before_auto):
        fail(f"mesh: the device count or the auto combine not restored "
             f"({before} -> {after})")
    out["restored"] = after
    out["launches"] = window
    for name in ("mesh_combine", "mesh_agg_partials", "mesh_score_blocks"):
        if not window.get(name):
            fail(f"mesh: {name} never launched")
    for name, rec in recs.items():
        if rec.args is None:
            fail(f"mesh: {name}'s inputs were not recorded")
    # the kernels line takes the BM25 call; the saturation call, the
    # builders' other mesh_score_blocks shape, is checked and timed beside
    # it (and read from a graph at the end, with the others)
    out["checks"] = {name: check_mesh_kernel(device, name, recs[name].args)
                     for name in ("mesh_combine", "mesh_agg_partials",
                                  "mesh_score_blocks")}
    out["sat_check"] = check_mesh_kernel(
        device, "mesh_score_blocks",
        recs["mesh_score_blocks saturation"].args)
    # mesh_combine's many-output calls of the main path, beside the search
    # leg's one-output call of the kernels line
    out["many_checks"] = {
        what: check_mesh_kernel(device, "mesh_combine_many", recs[what].args)
        for what in ("mesh_combine_many q1 GROUP BY chunk",
                     "mesh_combine_many join")}
    out["recorded"] = {name: recs[name].args for name in (
        "mesh_agg_partials", "mesh_score_blocks",
        "mesh_score_blocks saturation", "mesh_combine_many q1 GROUP BY chunk",
        "mesh_combine_many join")}
    return out


#: kernels a call at most, by mesh wrapper: mesh_agg_partials is one
#: kernel, mesh_score_blocks two (three allowed), mesh_combine_many one
#: under its caps (phase 21's calls are); none sets memory
MESH_GRAPH_KERNELS = {"mesh_agg_partials": 1, "mesh_score_blocks": 3,
                      "mesh_combine_many": 1}


def mesh_graphs(device, recorded: dict) -> dict:
    """Each recorded mesh call from a captured CUDA graph: its kernels,
    copies in and memsets (graph nodes), its device ms (graph replays) and
    the wrapper's whole call (CUDA events). Fails on a memset or a copy
    in, or past MESH_GRAPH_KERNELS. Run last: no profiled window runs
    after a graph capture."""
    from serenedb_tpu_torch.ops import mesh_kernels as MK
    out = {}
    for what, (a, kw) in recorded.items():
        name = what.split()[0]
        fn = getattr(MK, name)

        def call():
            return fn(*a, **kw)
        (kern_n, copies, memsets), g = graph_nodes(call)
        if kern_n > MESH_GRAPH_KERNELS[name] or copies or memsets:
            fail(f"a {what} call issued {kern_n} kernels, {copies} copies "
                 f"in, {memsets} memsets (want at most "
                 f"{MESH_GRAPH_KERNELS[name]}, 0, 0)")
        scratch = MK.score_plan(a[3].numel(), a[7]).bytes \
            if name == "mesh_score_blocks" else 0
        out[what] = {"kernels": kern_n, "copies": copies, "memsets": memsets,
                     "device_ms": graph_ms(g),
                     "call_ms": timed_ms(call, 20, device),
                     "scratch": scratch}
        del g
    return out


#: the wire modes of phase 22 (tests/test_sqllogic_wire.py's three)
WIRE_MODES = ("simple", "extended", "extended-binary")
#: the rows an Execute asks for in phase 22's extended modes
WIRE_CHUNK = 65_536


def _py(rows) -> list:
    """Rows with numpy scalars as Python values, floats as bit patterns."""
    out = []
    for r in rows:
        vals = []
        for v in r:
            if isinstance(v, np.generic):
                v = v.item()
            vals.append(struct.pack("<d", v) if isinstance(v, float) else v)
        out.append(tuple(vals))
    return out


class _Served:
    """A port `PgServer` on 127.0.0.1 behind `FrontDoor`, serving `db`
    for the block: `port` is its PG port."""

    def __init__(self, db):
        from serenedb_tpu_torch.server.frontdoor import FrontDoor
        from serenedb_tpu_torch.server.pgwire import PgServer
        self.pg = PgServer(db, "127.0.0.1", 0)
        self.front = FrontDoor(db, http_port=0, pg=self.pg)

    def __enter__(self):
        self.front.start()
        self.port = self.pg.port
        return self

    def __exit__(self, *exc):
        self.front.stop()


def _wire_client(port):
    from serenedb_tpu_torch.server.client import PgClient
    cl = PgClient(port, timeout=600)
    cl.rows("SET serene_device = 'gpu'")
    return cl


def wire_run(cl, mode: str, sql: str, params=(), chunk: int = WIRE_CHUNK):
    """One statement over the wire in `mode`: (rows, Execute messages)."""
    if mode == "simple":
        return cl.typed_rows(sql), 1
    return cl.extended(sql, params, binary=mode == "extended-binary",
                       chunk=chunk)


#: the runs of each statement in each mode in phase 22 (its ms the median)
WIRE_REPS = 5
#: a result of fewer rows is small: the wire's cost on it is summarised
WIRE_SMALL = 1_000


def wire_statements(device, label: str, db, queries: list) -> dict:
    """`queries` ((sql, kernels)) on `db` through `Connection.execute` and
    over the wire in each mode, WIRE_REPS runs each, the modes taking
    turns: every run's rows equal to execute's and its kernels launched
    as often as in process; ms per statement per mode the median run."""
    from serenedb_tpu_torch.device import LAUNCHES
    c = db.connect()
    c.execute("SET serene_device = 'gpu'")
    out = {"ms": {}, "launches": {}, "rows": {}}
    with _Served(db) as srv:
        clients = {m: _wire_client(srv.port) for m in WIRE_MODES}
        try:
            for q, kernels in queries:
                want = _py(c.execute(q).rows())        # cold: caches fill
                runs = {r: [] for r in ("execute",) + WIRE_MODES}
                for _rep in range(WIRE_REPS):
                    for run in runs:
                        before = LAUNCHES.snapshot()
                        t0 = time.perf_counter()
                        if run == "execute":
                            rows = c.execute(q).rows()
                            sync(device)
                        else:
                            rows, _n = wire_run(clients[run], run, q)
                        ms = (time.perf_counter() - t0) * 1e3
                        after = LAUNCHES.snapshot()
                        d = {k: after.get(k, 0) - before.get(k, 0)
                             for k in kernels}
                        if _py(rows) != want:
                            fail(f"wire {label} ({run}): rows differ from "
                                 f"execute's on {q!r}")
                        if not all(d.values()):
                            fail(f"wire {label} ({run}): {d} launched for "
                                 f"{q!r}")
                        runs[run].append((ms, d))
                first = runs["execute"][0][1]
                if any(d != first for rs in runs.values() for _ms, d in rs):
                    fail(f"wire {label}: launches differ from execute's on "
                         f"{q!r}: {runs}")
                out["ms"][q] = {r: float(np.median([ms for ms, _d in rs]))
                                for r, rs in runs.items()}
                out["launches"][q] = first
                out["rows"][q] = len(want)
        finally:
            for cl in clients.values():
                cl.close()
    return out


def wire_prepared(device, db, sql: str, literal: str, value) -> dict:
    """`sql` with a `$1` predicate prepared and bound at Bind (extended
    binary) against `literal` through execute: rows equal; whether
    agg_scan launched, and the fused declines the statement added."""
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.obs import device as obs_device
    c = db.connect()
    c.execute("SET serene_device = 'gpu'")
    want = _py(c.execute(literal).rows())
    with _Served(db) as srv:
        cl = _wire_client(srv.port)
        try:
            declines0 = obs_device.fused_declines()
            n0 = LAUNCHES.get("agg_scan")
            t0 = time.perf_counter()
            rows, _n = cl.extended(sql, (value,), binary=True)
            ms = (time.perf_counter() - t0) * 1e3
            took = LAUNCHES.get("agg_scan") - n0
            declines = {k: v - declines0.get(k, 0) for k, v in
                        obs_device.fused_declines().items()
                        if v != declines0.get(k, 0)}
        finally:
            cl.close()
    if _py(rows) != want:
        fail(f"wire prepared: rows differ from execute's on {literal!r}")
    return {"ms": ms, "agg_scan": took, "declines": declines}


def wire_stream(device, db, sql: str, n: int = None) -> dict:
    """`sql` (n rows, where given) over extended binary in portal chunks
    of WIRE_CHUNK rows: equal to execute, one Execute a chunk."""
    c = db.connect()
    c.execute("SET serene_device = 'gpu'")
    want = _py(c.execute(sql).rows())
    n = len(want) if n is None else n
    with _Served(db) as srv:
        cl = _wire_client(srv.port)
        try:
            t0 = time.perf_counter()
            rows, executes = cl.extended(sql, binary=True, chunk=WIRE_CHUNK)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            cl.close()
    if len(rows) != n or _py(rows) != want:
        fail(f"wire stream: {len(rows)} rows, {n} wanted, or rows differ "
             f"from execute's on {sql!r}")
    if executes != -(-n // WIRE_CHUNK):
        fail(f"wire stream: {executes} Executes for {n} rows")
    return {"ms": ms, "rows": n, "executes": executes}


def wire_cancel(device, db, sql: str, min_s: float = 1.5) -> dict:
    """A CancelRequest while `sql`, a chunked device aggregate, runs: the
    chunk is halved from 2^18 rows until the statement takes at least
    `min_s` in process, the cancel is sent a third of the way in; the
    client gets 57014, and the next statement answers as execute."""
    from serenedb_tpu_torch.server.client import PgError
    c = db.connect()
    c.execute("SET serene_device = 'gpu'")
    want = _py(c.execute(sql).rows())
    chunk = 1 << 18
    while True:
        c.execute(f"SET serene_device_chunk_rows = {chunk}")
        t0 = time.perf_counter()
        c.execute(sql)
        run_s = time.perf_counter() - t0
        if run_s >= min_s or chunk <= 1 << 12:
            break
        chunk //= 2
    with _Served(db) as srv:
        cl = _wire_client(srv.port)
        try:
            cl.rows(f"SET serene_device_chunk_rows = {chunk}")
            cl.send_query(sql)
            time.sleep(run_s / 3)
            t_cancel = time.perf_counter()
            cl.cancel()
            state, latency = None, None
            while True:
                kind, payload = cl.read()
                if kind == b"E" and state is None:
                    latency = (time.perf_counter() - t_cancel) * 1e3
                    state = PgError(payload).sqlstate
                if kind == b"Z":
                    break
            if state != "57014":
                fail(f"wire cancel: SQLSTATE {state}, 57014 wanted "
                     f"(statement {run_s:.2f} s at chunk {chunk})")
            cl.rows("SET serene_device_chunk_rows = DEFAULT")
            after = _py(cl.typed_rows(sql))
        finally:
            cl.close()
    if after != want:
        fail("wire cancel: the statement after the cancel differs from "
             "execute's")
    return {"latency_ms": latency, "run_s": run_s, "chunk": chunk}


def copy_text(cols: dict, names: list) -> bytes:
    """PG text COPY of the columns (no tab, newline or backslash in
    them): tab-separated, \\N for NULL."""
    lists = [cols[n].to_pylist() for n in names]
    return "".join("\t".join("\\N" if v is None else str(v) for v in row)
                   + "\n" for row in zip(*lists)).encode()


def copy_binary(cols: dict, names: list) -> bytes:
    """PG binary COPY of the columns: int64 and int32 as 8 and 4 bytes,
    strings as UTF-8."""
    from serenedb_tpu_torch.columnar import dtypes as dt
    lists = [cols[n].to_pylist() for n in names]
    packers = []
    for n in names:
        tid = cols[n].type.id
        packers.append(
            (lambda v: struct.pack("!iq", 8, v)) if tid is dt.TypeId.BIGINT
            else (lambda v: struct.pack("!ii", 4, v))
            if tid is dt.TypeId.INT else
            (lambda v: struct.pack("!i", len(b := v.encode())) + b))
    null = struct.pack("!i", -1)
    head = struct.pack("!h", len(names))
    body = b"".join(head + b"".join(
        null if v is None else p(v) for p, v in zip(packers, row))
        for row in zip(*lists))
    return b"PGCOPY\n\xff\r\n\x00" + struct.pack("!ii", 0, 0) + body + \
        struct.pack("!h", -1)


HITS_DDL = ("CREATE TABLE hits (UserID BIGINT, RegionID INT, AdvEngineID "
            "INT, SearchPhrase VARCHAR, SearchEngineID INT, "
            "ResolutionWidth INT)")


def wire_copy(device, cols: dict) -> dict:
    """The `hits` rows in `cols` loaded by COPY FROM STDIN in text and in
    binary into card databases over the wire; hits' six queries over
    the wire (extended binary) on each equal to the same queries on an
    in-process table of those rows."""
    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    names = list(cols)
    n = len(cols[names[0]])
    mem = Database(device=device)
    mem.schemas["main"].tables["hits"] = MemTable(
        "hits", Batch.from_pydict(cols))
    mc = mem.connect()
    mc.execute("SET serene_device = 'gpu'")
    want = [_py(mc.execute(q).rows()) for q in HITS_QUERIES]
    out = {"rows": n, "rows_per_s": {}, "encode_s": {}}
    for fmt, encode in (("text", copy_text), ("binary", copy_binary)):
        t0 = time.perf_counter()
        data = encode(cols, names)
        out["encode_s"][fmt] = time.perf_counter() - t0
        db = Database(device=device)
        with _Served(db) as srv:
            cl = _wire_client(srv.port)
            try:
                cl.rows(HITS_DDL)
                t0 = time.perf_counter()
                tag = cl.copy_in(
                    "COPY hits FROM STDIN" +
                    (" WITH (FORMAT binary)" if fmt == "binary" else ""),
                    data)
                out["rows_per_s"][fmt] = n / (time.perf_counter() - t0)
                if tag != f"COPY {n}":
                    fail(f"wire COPY ({fmt}): tag {tag!r}")
                for q, w in zip(HITS_QUERIES, want):
                    a0 = LAUNCHES.get("agg_scan")
                    rows, _n = cl.extended(q, binary=True)
                    if _py(rows) != w:
                        fail(f"wire COPY ({fmt}): {q!r} differs from the "
                             "in-process table's")
                    if LAUNCHES.get("agg_scan") == a0:
                        fail(f"wire COPY ({fmt}): agg_scan did not launch "
                             f"for {q!r}")
            finally:
                cl.close()
        del data, db
    return out


def phase_wire(device, sizes: dict = None) -> dict:
    """Phase 22: SQL over the port's PG wire on the card, at phase 6, 7
    and 9's sizes, with the result cache off (every statement runs)."""
    from serenedb_tpu_torch.bench.tpch import tpch_tables
    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.device import LAUNCHES
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.utils.config import REGISTRY as settings
    sizes = {"q1": 100_000_000, "hits": 10_000_000, "orders": 1_500_000,
             "copy": 1_000_000, "stream": 1_000_000, **(sizes or {})}
    t_phase = time.perf_counter()
    out = {"statements": {}, "gen_s": 0.0}

    def card_db(tables: dict):
        db = Database(device=device)
        for name, columns in tables.items():
            db.schemas["main"].tables[name] = MemTable(
                name, Batch.from_pydict(columns))
        return db

    def generated(make):
        t0 = time.perf_counter()
        tables = make()
        out["gen_s"] += time.perf_counter() - t0
        return tables

    settings.set_global("serene_result_cache", False)
    LAUNCHES.reset()
    try:
        db = card_db(generated(lambda: {"hits": q1_columns(sizes["q1"])}))
        out["statements"]["q1"] = wire_statements(
            device, "q1", db,
            [(q, AGG) for q in Q1_QUERIES] + [(q, TOPN) for q in Q1_TOPN])
        out["prepared"] = wire_prepared(
            device, db,
            "SELECT region, count(*), sum(x) FROM hits WHERE x < $1 "
            "GROUP BY region",
            "SELECT region, count(*), sum(x) FROM hits WHERE x < 90000 "
            "GROUP BY region", 90000)
        out["t3"] = wire_stream(device, db, Q1_TOPN[2],
                                8192 if sizes["q1"] >= 10_000_000 else None)
        out["cancel"] = wire_cancel(device, db, Q1_QUERIES[2])
        del db
        hits = generated(lambda: hits_columns(sizes["hits"]))
        db = card_db({"hits": hits})
        out["statements"]["hits"] = wire_statements(
            device, "hits", db,
            [(q, AGG) for q in HITS_QUERIES] + [(q, TOPN) for q in HITS_TOPN])
        out["stream"] = wire_stream(
            device, db, f"SELECT * FROM hits LIMIT {sizes['stream']}",
            sizes["stream"])
        del db
        cut = {k: v.slice(0, sizes["copy"]) for k, v in hits.items()}
        del hits
        out["copy"] = wire_copy(device, cut)
        del cut
        db = card_db(generated(lambda: tpch_tables(sizes["orders"])))
        out["statements"]["tpch"] = wire_statements(
            device, "tpch", db,
            [(q, {1: CHAIN, 4: OUTER_RIGHT}.get(qi, JOIN))
             for qi, q in enumerate(TPCH_QUERIES)])
        del db
    finally:
        settings.set_global("serene_result_cache", True)
    out["launches"] = LAUNCHES.snapshot()
    out["s"] = time.perf_counter() - t_phase
    return out


def print_wire(wire: dict) -> None:
    """Phase 22's lines."""
    for label, r in wire["statements"].items():
        for q, ms in r["ms"].items():
            print(f"[22] wire {label} {q[:60]!r}: median ms of "
                  f"{WIRE_REPS} runs " + ", ".join(
                f"{run} {v:.2f}" for run, v in ms.items()) +
                f"; rows equal to execute in every mode; launches a run "
                f"{r['launches'][q]} in each", flush=True)
    small = [ms[m] - ms["execute"] for r in wire["statements"].values()
             for q, ms in r["ms"].items() if r["rows"][q] < WIRE_SMALL
             for m in WIRE_MODES]
    q = np.percentile(small, [0, 25, 50, 75, 100])
    print(f"[22] wire: the wire's cost on the statements of fewer than "
          f"{WIRE_SMALL} rows ({len(small) // len(WIRE_MODES)} statements x "
          f"{len(WIRE_MODES)} modes; a mode's median ms less execute's): "
          f"median {q[2]:.2f} ms, quartiles {q[1]:.2f} and {q[3]:.2f}, "
          f"range {q[0]:.2f} to {q[4]:.2f}", flush=True)
    pr, cn, st, t3, cp = wire["prepared"], wire["cancel"], \
        wire["stream"], wire["t3"], wire["copy"]
    took = "took it" if pr["agg_scan"] else \
        f"declined it (fused declines {pr['declines']})"
    print(f"[22] wire: q1's GROUP BY region prepared with a $1 predicate "
          f"bound at Bind (extended binary): {pr['ms']:.2f} ms, equal to "
          f"execute; the device tier {took} (agg_scan launches "
          f"{pr['agg_scan']}); T3 over extended binary {t3['ms']:.2f} ms "
          f"({t3['rows']} rows, {t3['executes']} Execute); {st['rows']} "
          f"hits rows streamed over extended binary in chunks of "
          f"{WIRE_CHUNK}: {st['ms']:.1f} ms ({st['executes']} Executes, "
          f"{st['rows'] / st['ms'] * 1e3:.0f} rows/s), equal to execute; "
          f"a CancelRequest during q1's GROUP BY at serene_device_chunk_rows"
          f" = {cn['chunk']} ({cn['run_s']:.2f} s in process): 57014 after "
          f"{cn['latency_ms']:.1f} ms, the next statement equal to execute",
          flush=True)
    print(f"[22] wire COPY FROM STDIN: {cp['rows']} hits rows (a cut of the "
          f"10,000,000 made for the run's time): text "
          f"{cp['rows_per_s']['text']:.0f} rows/s, binary "
          f"{cp['rows_per_s']['binary']:.0f} rows/s (client encoding "
          f"{cp['encode_s']['text']:.1f} / {cp['encode_s']['binary']:.1f} "
          f"s); hits' six queries over the wire on each equal to an "
          f"in-process table of those rows; phase {wire['s']:.1f} s "
          f"(tables generated {wire['gen_s']:.1f} s); launches "
          f"{wire['launches']}", flush=True)


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

    # the device column cache's cap (the posting pool's region is carved
    # out of it) as a deployment on an 80 GB card would set it
    from serenedb_tpu_torch.utils.config import REGISTRY as settings
    settings.set_global("serene_device_cache_mb", DEVICE_CACHE_MB)

    # 3. dense regime
    dense = phase_dense(device)
    print(f"[3] dense: {dense['n_queries']} queries, QPS "
          f"{dense['qps']:.1f} (warm), cold first call "
          f"{dense['cold_s']:.3f} s, index build {dense['index_build_s']:.1f}"
          f" s, parity on {dense['parity_checked']} queries ok, launches "
          f"{dense['launches']}", flush=True)

    # 4. packed regime (its searcher kept for phase 21)
    packed = phase_packed(device)
    packed_searcher, packed_nodes = packed.pop("searcher"), \
        packed.pop("nodes")
    print(f"[4] packed: {packed['n_queries']} queries over "
          f"{packed['postings']} postings, QPS {packed['qps']:.2f} (warm), "
          f"cold first call {packed['cold_s']:.2f} s, host index build "
          f"{packed['index_build_s']:.1f} s, block store build "
          f"{packed['store_build_s']:.1f} s, tiles "
          f"{packed['tile_bytes'] / 2**20:.1f} MiB, peak device memory "
          f"{packed['peak_bytes'] / 2**30:.2f} GiB, parity on "
          f"{packed['parity_checked']} queries ok, two calls bit-identical, "
          f"launches {packed['launches']}", flush=True)
    rg = packed["ragged"]
    print(f"[4] packed, ragged=True with the posting pool on: QPS "
          f"{rg['qps']:.2f} against the planes' {rg['plane_qps']:.2f} "
          f"(medians of 3 alternating passes: ragged "
          f"{[round(x, 1) for x in rg['passes'][True]]}, planes "
          f"{[round(x, 1) for x in rg['passes'][False]]}; ratio "
          f"{rg['ratio']:.3f}), cold first call {rg['cold_s']:.2f} s, "
          f"{rg['pages_used']} pages resident, {rg['pool_queries']} queries "
          f"served by the pool; every query bit-equal to the plane result; "
          f"launches {rg['launches']}", flush=True)
    print_routes(4, "bm25_8m", rg.pop("routes"))

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

    # 6-9. the SQL paths through Database.execute; the statements past one
    # launch (Q1_WIDE, HITS_WIDE, TPCH_WIDE) after the others
    sql = {}
    for label, tables, queries, exact in (
            ("q1", lambda: {"hits": q1_columns(100_000_000)},
             [(q, AGG) for q in Q1_QUERIES] + [(q, TOPN) for q in Q1_TOPN] +
             Q1_WIDE, True),
            ("hits", lambda: {"hits": hits_columns(10_000_000)},
             [(q, AGG) for q in HITS_QUERIES] +
             [(q, TOPN) for q in HITS_TOPN] + HITS_WIDE, True),
            ("float", lambda: {"fl": float_columns(10_000_000)},
             [(q, AGG) for q in FLOAT_QUERIES], False),
            ("tpch", tpch_tables,
             [(q, {1: CHAIN, 4: OUTER_RIGHT}.get(qi, JOIN))
              for qi, q in enumerate(TPCH_QUERIES)] + TPCH_WIDE, True)):
        t0 = time.perf_counter()
        cols = tables()
        gen_s = time.perf_counter() - t0
        r = phase_sql(device, label, cols, queries, exact,
                      expect=SQL_LAUNCHES[label])
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
              f"launched, as many times as SQL_LAUNCHES holds, no fused "
              f"decline; launches {r['launches']}", flush=True)
        names = {"q1": ["W1"], "hits": ["W2", "W3"],
                 "tpch": ["J6"]}.get(label, [])
        for name, qi in zip(names, range(len(queries) - len(names),
                                         len(queries))):
            print(f"[{phase}] {label} {name}: {queries[qi][0][:70]!r}... "
                  f"cpu {r['cpu_ms'][qi]:.3f} ms, cold "
                  f"{r['cold_ms'][qi]:.3f} ms, warm {r['warm_ms'][qi]:.3f} "
                  f"ms, launches a run {r['query_launches'][0][qi]}; rows "
                  f"equal to cpu", flush=True)
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
    checks["agg_fold (8,192 x 201)"] = check_agg_fold(
        device, fold_plane(device, 8192, 201))
    checks["T1 topn_scan"] = check_topn(
        device, recorded("topn_scan", ("q1", 3), "T1"), "T1 topn_scan")
    checks["T2 topn_scan"] = check_topn(
        device, recorded("topn_scan", ("q1", 4), "T2"), "T2 topn_scan")
    checks["T3 topn_scan"] = check_topn(
        device, recorded("topn_scan", ("q1", 5), "T3"), "T3 topn_scan")
    checks["T4 topn_scan"] = check_topn(
        device, recorded("topn_scan", ("hits", 6), "T4"), "T4 topn_scan")
    checks["J2 chain_topn"] = check_chain(
        device, recorded("chain_topn", ("tpch", 1), "J2"), "J2 chain_topn")
    checks["J1 join_probe"] = check_join_probe(
        device, recorded("join_probe", ("tpch", 0), "J1"))
    checks["J4 join_probe"] = check_join_probe(
        device, recorded("join_probe", ("tpch", 3), "J4"))
    j5 = recorded("join_probe", ("tpch", 4), "J5")
    if (j5[0][5] if len(j5[0]) > 5 else j5[1].get("right")) is None:
        fail("J5 (RIGHT JOIN) did not reach join_unmatched")
    checks["J5 join_probe + join_unmatched"] = check_join_probe(device, j5)
    n_hits = len(HITS_QUERIES) + len(HITS_TOPN)
    for what, key in (("W1", ("q1", len(Q1_QUERIES) + len(Q1_TOPN))),
                      ("W3", ("hits", n_hits + 1)),
                      ("J6", ("tpch", len(TPCH_QUERIES)))):
        checks[f"scan_eval ({what})"] = check_scan_eval(
            device, recorded("scan_eval", key, f"{what}'s prepare"), what)
    for what, r in checks.items():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        dev = f" (device {r['device_ms']:.4f} ms, parent {r['parent']})" \
            if "device_ms" in r else ""
        print(f"[10] {what} ({r['shape']}): kernel {r['ms']:.4f} ms{dev}, "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms, "
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

    # 11-13. search and vector search through SQL
    settings.set_global("serene_vector_pages", VECTOR_PAGES)
    sift = phase_sift(device)
    sp = sift["split"]
    print(f"[11] sift: 1,000,000 x 128 generated and loaded as JSON text in "
          f"{sift['gen_s']:.1f} s; CREATE INDEX ... USING ivf (lists 1024) "
          f"{sift['build_s']:.2f} s (JSON parse "
          f"{sp.get('_parse_column', 0):.2f} s, k-means "
          f"{sp.get('kmeans_fit', 0):.2f} s, assign "
          f"{sp.get('assign_clusters', 0):.2f} s), page upload "
          f"{sp.get('_write', 0):.2f} s (in the first statement); largest "
          f"list {sift['max_list']} rows; statements at nprobe 16: cold "
          f"{sift['cold_ms']:.2f} ms ({sift['cold_upload']} B uploaded), "
          f"warm {sift['warm_ms']:.3f} ms mean ({sift['warm_upload']} B, "
          f"the query block); first pass ms "
          f"{[round(v, 2) for v in sift['first_pass_ms'][:8]]}...; "
          f"IvfIndex.search QPS batch 1 {sift['qps'][1]:.1f}, 64 "
          f"{sift['qps'][64]:.1f}, 1024 {sift['qps'][1024]:.1f}; "
          f"recall@10 {sift['recall']:.4f}; nprobe 1024 == brute kernel "
          f"== host_dist selection on 64 queries (oracle "
          f"{sift['oracle_s']:.1f} s); two calls bit-identical; launches "
          f"{sift['launches']}", flush=True)
    colbert = phase_colbert(device)
    print(f"[12] colbert: {colbert['docs']} passages (cut from 100,000 to "
          f"hold the script's time), {colbert['tokens']} tokens "
          f"({colbert['region_bytes']} B of f32) built as a MaxSimIndex "
          f"from the matrices in {colbert['gen_s']:.1f} s (cut: not through "
          f"JSON); cold first batch "
          f"{colbert['cold_s']:.2f} s, warm {colbert['qps']:.1f} QPS at "
          f"batch 16; 4 queries within rtol/atol 1e-5 of host_scores (f64, "
          f"{colbert['oracle_s']:.1f} s), {colbert['near_ties']} rank(s) "
          f"differing on near-ties; SQL leg: 2,000 passages as JSON, CREATE "
          f"INDEX ... USING maxsim + load {colbert['sql_build_s']:.1f} s, "
          f"statement {colbert['sql_ms']:.1f} ms, scores within 1e-5 of "
          f"serene_maxsim = off, ids equal {colbert['sql_ids_equal']}; "
          f"long docs (300 tokens, every 7th 1,030) within 1e-5 of "
          f"host_scores: {colbert['long_docs']}; "
          f"launches {colbert['launches']}", flush=True)
    bsql = phase_bm25_sql(device)
    print(f"[13] bm25_sql: 100,000 docs, CREATE INDEX ... USING inverted "
          f"{bsql['build_s']:.1f} s (native indexer "
          f"{bsql['native_s']:.2f} s); {bsql['n_queries']} statements, ms per "
          f"statement one segment {bsql['ms_per_statement'][0]:.3f}, after "
          f"the INSERT of 10,000 docs ({bsql['insert_s']:.1f} s) two "
          f"segments {bsql['ms_per_statement'][1]:.3f}; {bsql['checked']} "
          f"statements held to the host WAND; launches "
          f"{bsql['launches']}", flush=True)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 14. the vector kernels against their plain versions
    vcalls = sift.pop("calls")
    for name in ("ivf_probe", "ivf_probe_1", "ivf_brute", "kmeans_assign",
                 "kmeans_update"):
        if vcalls[name] is None:
            fail(f"{name}'s main-path inputs were not recorded")
    if colbert["args"] is None:
        fail("maxsim's main-path inputs were not recorded")
    vchecks = {"ivf_probe nprobe 16": check_ivf_probe(device,
                                                      vcalls["ivf_probe"]),
               "ivf_probe nprobe 16 batch 1": check_ivf_probe(
                   device, vcalls["ivf_probe_1"], reps=20),
               "ivf_probe brute": check_ivf_probe(device,
                                                  vcalls["ivf_brute"]),
               "maxsim": check_maxsim(device, colbert.pop("args"))}
    vchecks.update(check_kmeans(device, vcalls["kmeans_assign"],
                                vcalls["kmeans_update"]))
    for what, r in vchecks.items():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        note = f"; {r['note']}" if "note" in r else ""
        print(f"[14] {what} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {lib}, bit-equal{note}",
              flush=True)
    pw = time_page_write(device, vcalls["page_write"])
    print(f"[14] vector pool page write ({pw['shape']}, one index_copy_): "
          f"{pw['ms']:.4f} ms, bound {pw['bound_ms']:.4f} ms (bytes)",
          flush=True)
    fp = check_float_probe(device)
    print(f"[14] ivf_probe on float data ({fp['shape']}): {fp['metrics']} "
          f"bit-equal to the plain version and to host_dist", flush=True)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 15. paged_search, the reference's serving cell
    paged = phase_paged(device)
    q = paged["qps"]
    print(f"[15] paged_search: 1,000,000 docs, {paged['postings']} postings "
          f"(index + block store {paged['build_s']:.1f} s), 64 two-term "
          f"disjunctions, k = 10; first pass over every mode and batch "
          f"{paged['first_s']:.2f} s; QPS (median of 2-3 alternating runs) "
          f"pool / host ragged / plane at batch 1: {q['pool'][1]:.1f} / "
          f"{q['host'][1]:.1f} / {q['plane'][1]:.1f}, batch 8: "
          f"{q['pool'][8]:.1f} / {q['host'][8]:.1f} / {q['plane'][8]:.1f}, "
          f"batch 64: {q['pool'][64]:.1f} / {q['host'][64]:.1f} / "
          f"{q['plane'][64]:.1f}; every query bit-equal across the modes; "
          f"warm repeat 0 B uploaded, one pool_score launch; 64 pages: "
          f"{paged['starved']} and bit-equal; pool {paged['pool']}, "
          f"{paged['pool_queries']} queries served by the pool; launches "
          f"{paged['launches']}", flush=True)
    print_routes(15, "paged_search", paged.pop("routes"))
    # the kernels against their plain versions now, while the region the
    # recorded batch reads holds what it held
    pool_args = paged.pop("pool_args")
    serve_checks = {"pool_score": check_pool_score(device, pool_args),
                    "contrib_flat": check_contrib_flat(
                        device, paged.pop("flat_args"))}
    ragged_call = check_ragged_contribs(device, paged.pop("ragged_args"))
    pool_calls = pool_regime_calls(device, pool_args)

    # 16. serving: _msearch and the PG wire through the front door
    serving = phase_serving(device)
    ms = serving["ms"]
    print(f"[16] serving: {serving['docs']} docs as an ES document table "
          f"(generated {serving['gen_s']:.1f} s, CREATE INDEX "
          f"{serving['build_s']:.1f} s, native indexer "
          f"{serving['native_s']:.2f} s) behind FrontDoor; _msearch of 64 "
          f"two-term match items: cold {ms['cold']:.1f} ms, warm "
          f"{ms['warm']:.1f} / {ms['warm2']:.1f} ms, pool off "
          f"{ms['pool off']:.1f} ms, warm in process (no HTTP) "
          f"{ms['in process']:.1f} ms; the 64 top-k statements alone, "
          f"serially {ms['top-k statements']:.1f} ms; 64 serial _search "
          f"requests (batching off) {ms['serial _search']:.1f} ms; mean "
          f"coalesced batch "
          f"{serving['mean_batch']:.2f} ({serving['queries']} queries in "
          f"{serving['dispatches']} dispatches); every item equal to its "
          f"serial _search; a @@ statement over the PG wire equal to "
          f"execute ({serving['pg_rows']} rows); launches "
          f"{serving['launches']}", flush=True)

    # 17. the sharded tier
    shards = phase_shards(device, bsql)
    for m, r in shards["relational"].items():
        cells = "; ".join(
            f"shards {sh} {cb}: cold {c_ms:.1f} ms, warm {w_ms:.1f} ms "
            f"(median of 3), {off} offload(s)"
            for (sh, cb), (c_ms, w_ms, off) in r["cells"].items())
        host = f", host path {r['host_ms']:.1f} ms" if "host_ms" in r \
            else ""
        print(f"[17] sharded join {m}x: {r['rows']} probe rows (generated "
              f"{r['gen_s']:.1f} s){host}; {cells}; {r['groups']} groups "
              f"equal in every cell", flush=True)
    sr = shards["search"]
    cells = "; ".join(f"shards {sh} {cb}: topk_batch {b_ms:.2f} ms, "
                      f"cpu_topk {w_ms:.2f} ms a query"
                      for (sh, cb), (b_ms, w_ms) in sr["cells"].items())
    print(f"[17] sharded search: 4 x 250,000 docs, {sr['postings']} "
          f"postings (built {sr['build_s']:.1f} s), 16 two-term "
          f"disjunctions, k = 10; cold topk_batch {sr['cold_ms']:.1f} ms; "
          f"medians of 3 rounds: {cells}; bit-equal to shards = 1; "
          f"{sr['bitmaps']} match bitmaps equal to eval_filter", flush=True)
    ss = shards["search_sql"]
    print(f"[17] sharded search through SQL: {ss['segments']} segments "
          f"(two INSERTs of 10,000 docs {ss['insert_s']:.1f} s), "
          f"{ss['statements']} statements, ms per statement (median of 3 "
          f"rounds) "
          + ", ".join(f"shards {sh} {cb} {v:.3f}"
                      for (sh, cb), v in ss["ms"].items())
          + f"; rows bit-equal across the combines; launches "
          f"{shards['launches']}", flush=True)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 18. the serving kernels against their plain versions
    for what, r in serve_checks.items():
        print(f"[18] {what} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library null, bit-equal", flush=True)
    print(f"[18] ragged_contribs, the host route's whole call on the same "
          f"{ragged_call['n']} postings: {ragged_call['ms']:.4f} ms (host "
          f"clock, its readback's sync included; the contrib_flat wrapper "
          f"above {serve_checks['contrib_flat']['ms']:.4f} ms), "
          f"{ragged_call['uploads']:.0f} upload a call", flush=True)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 19. the sharded tier's kernels and the K13 entries against their
    # plain versions
    if sr["merge_args"] is None or sr["bitmap_args"] is None:
        fail("merge_topk's or match_bitmap's inputs were not recorded")
    shard_checks = {"merge_topk": check_merge_topk(device,
                                                   sr.pop("merge_args")),
                    "merge_topk crafted": check_merge_topk(
                        device, crafted_merge(device)),
                    "match_bitmap": check_match_bitmap(
                        device, sr.pop("bitmap_args")),
                    "match_bitmap packed": check_match_bitmap(
                        device, packed_bitmap_args(device, packed_searcher,
                                                   packed_nodes))}
    for what, r in shard_checks.items():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms (torch.topk)"
        note = f"; {r['note']}" if "note" in r else ""
        if "device_ms" in r:
            note += (f"; one launch a call; device {r['device_ms']:.5f} ms "
                     f"a call (calls queued behind a spin)")
        print(f"[19] {what} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {lib}, bit-equal{note}",
              flush=True)
    coll = shards["relational"][1].pop("collective_args", None)
    if coll is None:
        fail("the device combine's join_probe inputs were not recorded")
    k12 = check_join_probe(device, coll)
    print(f"[19] K12 one card: join_probe at phase 17's collective shape "
          f"(shards 4, device combine, 1x; {k12['shape']}): kernel "
          f"{k12['ms']:.4f} ms, plain {k12['plain_ms']:.3f} ms, bound "
          f"{k12['bound_ms']:.4f} ms (bytes), index_add_ "
          f"{k12['library_ms']:.4f} ms, equal", flush=True)
    k13 = check_k13_aggs(device)
    k13_lib = k13.pop("index_add_")
    print("[19] K13 entries on agg_scan (1,000,000 rows, 16 groups), equal "
          "to their plain versions on the card: " + "; ".join(
              f"{k} kernel {r['ms']:.4f} ms (the entry's whole call "
              f"{r['entry_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms, bytes)" for k, r in k13.items()) +
          f"; index_add_ into the 16 groups {k13_lib:.4f} ms", flush=True)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 20. the durable tier on the card
    dur = phase_durable(device)
    print(f"[20] durable: hits ({dur['checks']['after crash']['rows']} rows "
          f"after the crash) and the bm25_sql corpus in a data directory "
          f"(generated {dur['gen_s']:.1f} s); seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in dur["s"].items())
          + f"; data directory {dur['bytes']['after close']} B after the "
          f"close, {dur['bytes']['after crash']} B after the crash; native "
          f"indexer {dur['native_s']:.2f} s in all; launches "
          f"{dur['launches']}", flush=True)
    for label, r in dur["checks"].items():
        print(f"[20] durable, reopened {label}: cpu {r['cpu_s']:.3f} s for "
              f"the 7 queries, 'gpu' ms {[round(x, 3) for x in r['gpu_ms']]}"
              f" (cold), equal to 'cpu' and to an in-memory database of the "
              f"same rows; every acknowledged row read back; 256 @@ + bm25() "
              f"statements {r['search_ms']:.3f} ms each, bit-equal to the "
              f"in-memory database's, {r['checked']} held to the host WAND",
              flush=True)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 21. the device mesh
    mesh = phase_mesh(device, packed_searcher, packed_nodes)
    del packed_searcher, packed_nodes
    ms_sql, ms_s, ms_sh, ms_b = mesh["sql"], mesh["search"], \
        mesh["shards"], mesh["builders"]
    print(f"[21] mesh: {mesh['placement']} (torch.cuda.device_count() "
          f"{torch.cuda.device_count()}); SQL at serene_mesh = "
          f"{MESH_WIDTH} (tables generated {ms_sql['gen_s']:.1f} s), warm "
          f"ms " + ", ".join(
              f"{label} {q[:40]!r} {v:.2f} (serene_mesh = 0 "
              f"{ms_sql['single_ms'][(label, q)]:.2f})"
              for (label, q), v in ms_sql["ms"].items())
          + "; rows equal to serene_mesh = 0", flush=True)
    print(f"[21] mesh search: {ms_s['queries']} require-free queries of the "
          f"packed corpus in {ms_s['batches']} batches of 16 through "
          f"topk_batch(mesh_n={MESH_WIDTH}): {ms_s['ms']:.2f} ms a batch "
          f"(single device {ms_s['single_ms']:.2f} ms), top-10 within rtol "
          f"{PARITY_RTOL} / atol {PARITY_ATOL} of the single device, "
          f"{ms_s['tie_swaps']} id swap(s) on ties; the combine step (one "
          f"mesh_combine call on the four planes where they lie, no "
          f"staging copy) {mesh['checks']['mesh_combine']['ms']:.4f} ms; "
          f"peak device memory over the batches {ms_s['peak_bytes']} B; a "
          f"batch's peak at most {ms_s['peak_over_base']} B above what was "
          f"allocated before it", flush=True)
    print(f"[21] mesh sharded tier: phase 17's join (1x) at shards "
          f"{MESH_WIDTH}, device combine over the mesh: warm "
          f"{ms_sh['join_ms']:.2f} ms, {ms_sh['groups']} groups equal to "
          f"shards = 1; its search merge at shards {MESH_WIDTH}: "
          f"{ms_sh['merge_ms']:.2f} ms for 16 queries, bit-equal to shards "
          f"= 1", flush=True)
    print(f"[21] mesh builders: sharded_agg_step (100,000,000 rows), "
          f"sharded_bm25_topk ({ms_b['postings']} postings of 4 terms, top "
          f"score {ms_b['top1']:.4f}), sharded_query_step "
          f"({ms_b['all_postings']} postings, 200 groups) in "
          f"{ms_b['ms']:.1f} ms over the mesh, {ms_b['single_ms']:.1f} ms "
          f"on one device; exact counts and sums, planes and scores within "
          f"rtol {RTOL} / atol {ATOL} of one device; device count and the "
          f"auto combine restored {mesh['restored']}; launches "
          f"{mesh['launches']}", flush=True)
    for what, r in [*mesh["checks"].items(),
                    ("mesh_score_blocks saturation", mesh["sat_check"]),
                    *mesh["many_checks"].items()]:
        lib = "null" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} ms (" + ", ".join(
                f"stack.{'sum' if op == 'sum' else 'a' + op}(0) {v:.4f}"
                for op, v in r["library_all"].items()) +
            "; no shard order promised)")
        turns = "" if "rounds" not in r else (
            f"; on the card alone (calls queued behind a spin) kernel "
            f"{r['device_ms']:.4f} ms, library {r['library_device_ms']:.4f}"
            f" ms; medians of {MESH_ROUNDS} rounds in turn: " + "; ".join(
                f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                for k, v in r["rounds"].items()))
        print(f"[21] {what} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {lib}, bit-equal{turns}",
              flush=True)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 22. SQL over the PG wire
    wire = phase_wire(device)
    print_wire(wire)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # measured last (after a graph capture no profiled window runs): the
    # kernels a call of phase 10's top-N calls (and of any call whose
    # profiled windows were incomplete), and pool_score in both regimes,
    # from captured graphs
    for what, kernels, copies, dev_ms in graph_counts():
        print(f"[graph] {what}: a call {kernels} kernels, {copies} copies "
              f"in (graph nodes); device {dev_ms:.4f} ms a call (graph "
              f"replays)", flush=True)
    for what, r in mesh_graphs(device, mesh.pop("recorded")).items():
        print(f"[21] {what}: a call {r['kernels']} kernels, {r['copies']} "
              f"copies in, {r['memsets']} memsets (graph nodes); device "
              f"{r['device_ms']:.4f} ms a call (graph replays); the "
              f"wrapper's call {r['call_ms']:.4f} ms; scratch "
              f"{r['scratch']} bytes a call", flush=True)
    for what, r in pool_graphs(device, pool_calls).items():
        by = ", ".join(f"{k} {v:.4f}" for k, v in r["by_kernel"].items()) \
            or "not measured (no complete profiled window)"
        print(f"[18] pool_score, {what} ({r['shape']}), {r['regime']} "
              f"regime: a call {r['kernels']} kernels, {r['copies']} copies "
              f"in, {r['memsets']} memsets (graph nodes); device "
              f"{r['device_ms']:.4f} ms a call (graph replays); by kernel "
              f"(torch.profiler) {by}; the wrapper's call "
              f"{r['call_ms']:.4f} ms", flush=True)
    print(f"    total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 23. result lines
    launches = {}
    for window in (dense["launches"], packed["launches"],
                   packed["ragged"]["launches"],
                   *(r["launches"] for r in sql.values()),
                   sift["launches"], colbert["launches"],
                   bsql["launches"], paged["launches"],
                   serving["launches"], shards["launches"],
                   dur["launches"], mesh["launches"], wire["launches"]):
        for kname, n in window.items():
            launches[kname] = launches.get(kname, 0) + n
    results["agg_scan"] = checks["q1 GROUP BY region"]
    results["agg_fold"] = checks["agg_fold"]
    results["topn_scan"] = checks["T1 topn_scan"]
    results["chain_topn"] = checks["J2 chain_topn"]
    results["join_probe"] = checks["J1 join_probe"]
    results["scan_eval"] = checks["scan_eval (W3)"]
    results["ivf_probe"] = vchecks["ivf_probe nprobe 16"]
    for name in ("maxsim", "kmeans_assign", "kmeans_update"):
        results[name] = vchecks[name]
    results.update(serve_checks)
    results["merge_topk"] = shard_checks["merge_topk"]
    results["match_bitmap"] = shard_checks["match_bitmap"]
    results.update(mesh["checks"])
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
