"""Time `pool_score` and the host ragged route (`ragged_contribs`, its
`contrib_flat` launch) at the main path's shapes through this checkout's
wrappers, on one card.

The corpus is chip_smoke.py phase 15's (`paged_search`: 1,000,000 docs,
30,000 terms, 12M sampled postings, seed 7) with its 64 two-term
disjunctions, k = 10. The pool route runs at batches 64, 8 and 1 and the
first full-mode `pool_score` call of each batch size is recorded; the
host route (pool off) at batch 64 records its `ragged_contribs` call and
that call's `contrib_flat` launch. Beside them, synthetic single-query
rows (random region, two slices over every lane) at 19,048 lanes, at
ROW_CAP (56,048, the ROW regime's cap) and past it, and at 19,048 lanes
with kk 1,000 and 8,192 (the ROW regime's kk cap). For each `pool_score`
call:

- `call_ms`: the whole wrapper call, REPS calls between CUDA events;
- `host_ms`: the host's wall time of one call, the stream idle before it;
- `device_ms`: its kernels' device time by name, and the kernels and
  host-to-device copies of one call (torch.profiler);
- `equal`: the outputs bit for bit against a second call and the plain
  version.

Then: `ragged_contribs`' whole call (host clock: it ends in a sync) and
the `contrib_flat` wrapper (CUDA events) on their recorded inputs;
chip_smoke.py's `route_times` at batches 1, 8 and 64 (each group on the
pool, host ragged and plane routes: kept postings and median ms), a
least-squares fit of the host route's ms against its kept postings (the
`HOST_BASE_MS` / `HOST_MS_PER_ENTRY` of `SegmentSearcher.ragged_admits`);
and the warm pool route's QPS at each batch (the median of seven passes
over the 64 queries). With `--sweep` (a checkout whose wrapper has
`ROW_CLUSTER`) it also times every recorded and synthetic ROW-regime
call at each cluster size, beside the entry's own choice. Every result carries the
card's `nvidia-smi` name and power limit.

Run it from the root of the checkout; to compare two checkouts on one
card, copy this script into the other's `scripts/` and run both in turns:

    python3 scripts/pool_shapes.py [--sweep] [--out FILE]
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke  # noqa: E402
from probe_shapes import events_ms, host_ms, profiled, same  # noqa: E402
from serenedb_tpu_torch.ops import bm25 as bm25_ops  # noqa: E402
from serenedb_tpu_torch.ops import bm25_kernels as kern  # noqa: E402
from serenedb_tpu_torch.ops import pool_kernels as pk  # noqa: E402

ROW_CAP = 56_048
SYNTH_LANES = (19_048, ROW_CAP, 100_000, 600_000)
SYNTH_KK = (1000, 8192)


def paged_corpus(dev):
    """phase_paged's searcher and its 64 disjunctions."""
    from serenedb_tpu_torch.search.analysis import get_analyzer
    from serenedb_tpu_torch.search.query import parse_query
    from serenedb_tpu_torch.search.searcher import SegmentSearcher
    fi = chip_smoke.synth_posting_index(1_000_000, 30_000, 12_000_000,
                                        seed=7, device=dev)
    an = get_analyzer("simple")
    seg = SegmentSearcher(fi, an, 1_000_000, device=dev)
    seg._device_store()
    terms = [f"w{100 + 13 * i:07d}" for i in range(128)]
    nodes = [parse_query(f"{terms[2 * i]} | {terms[2 * i + 1]}", an)
             for i in range(64)]
    return seg, nodes


def run_batches(seg, nodes, batch):
    out = []
    for i in range(0, len(nodes), batch):
        out.extend(seg.topk_batch(nodes[i:i + batch], 10, ragged=True))
    return out


def record_calls(seg, nodes):
    """{batch: (args, kw)} of the first full-mode pool_score call at each
    batch size, and the ragged_contribs and contrib_flat calls of the host
    route at batch 64."""
    from serenedb_tpu_torch.search.posting_pool import POOL
    from serenedb_tpu_torch.utils.config import REGISTRY as settings
    settings.set_global("serene_posting_pages", chip_smoke.POSTING_PAGES)
    POOL.clear()
    settings.set_global("serene_posting_pool", True)
    calls = {}
    for batch in (64, 8, 1):
        with chip_smoke.Recorder(pk, "pool_score",
                                 lambda a, kw: a[15] > 0) as rec:
            run_batches(seg, nodes, batch)
        calls[batch] = rec.args
    settings.set_global("serene_posting_pool", False)
    with chip_smoke.Recorder(bm25_ops, "ragged_contribs") as rr, \
            chip_smoke.Recorder(kern, "contrib_flat") as rc:
        run_batches(seg, nodes, 64)
    settings.set_global("serene_posting_pool", True)
    return calls, rr.args, rc.args


def synth_row(dev, cp, seed=3, pages=1024, kk=10):
    """One query of cp live lanes over a random region of `pages` pages:
    two slices, each over every lane in a random order, top kk."""
    rng = np.random.default_rng(seed)
    docs_pg = rng.integers(0, 1_000_000, (pages, 1024)).astype(np.int32)
    tfs_pg = rng.integers(1, 20, (pages, 1024)).astype(np.int32)
    norms = rng.integers(5, 300, 1_000_000).astype(np.int32)
    ep = 2 * cp
    si = rng.integers(0, pages * 1024, (1, ep)).astype(np.int32)
    w = np.repeat(np.float32([1.5, 2.25]), cp)[None, :]
    lane = np.concatenate([rng.permutation(cp), rng.permutation(cp)]
                          ).astype(np.int32)[None, :]
    soff = np.int32([[0, cp, ep]])
    cand = np.sort(rng.choice(1 << 30, cp, replace=False)).astype(
        np.int32)[None, :]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (t(docs_pg), t(tfs_pg), t(norms), t(si), t(w), t(lane), t(soff),
            [cp, cp], cp, 1.2, 0.75, 150.0, "bm25", t(cand),
            t(np.int32([cp])), kk)
    return args, {}


def measure(fn, plain, reps=20) -> dict:
    first = fn()
    again = fn()
    ref = plain()
    torch.cuda.synchronize()
    row = {"equal": same(first, again) and same(first, ref),
           "call_ms": round(events_ms(fn), 5),
           "host_ms": round(host_ms(fn), 5)}
    row.update(profiled(fn, reps))
    return row


def pool_row(a, kw) -> dict:
    row = measure(lambda: pk.pool_score(*a, **kw),
                  lambda: pk.pool_score_plain(*a, **kw))
    cand, nc = a[13], a[14]
    row["shape"] = {"qp": int(cand.shape[0]), "cp": int(cand.shape[1]),
                    "live": int(nc.sum()), "kept": int(a[6][:, -1].sum()),
                    "kk": int(a[15])}
    return row


def cluster_sweep(calls: dict) -> dict:
    """{call: {blocks a query: ms}} with the ROW launch's cluster forced
    to 1, 2, 4 and 8 (bit-equal to the plain version at each), beside the
    entry's own choice ("auto")."""
    out = {}
    try:
        for what, (a, kw) in calls.items():
            if pk.pool_regime(a[8], a[15]) != "row":
                continue
            ref = pk.pool_score_plain(*a, **kw)
            row = {}
            for c in (0, 1, 2, 4, 8):
                pk.ROW_CLUSTER = c
                got = pk.pool_score(*a, **kw)
                row[str(c) if c else "auto"] = {
                    "equal": same(got, ref),
                    "call_ms": round(events_ms(
                        lambda: pk.pool_score(*a, **kw)), 5),
                    "device_ms": profiled(lambda: pk.pool_score(*a, **kw),
                                          20)["device_sum_ms"]}
            out[what] = row
    finally:
        pk.ROW_CLUSTER = 0
    return out


def ragged_rows(rr, rc) -> dict:
    a, kw = rr
    reps = 20
    bm25_ops.ragged_contribs(*a, **kw)
    t0 = time.perf_counter()
    for _ in range(reps):
        got = bm25_ops.ragged_contribs(*a, **kw)
    whole = (time.perf_counter() - t0) / reps * 1e3
    ca, ckw = rc
    wrap = events_ms(lambda: kern.contrib_flat(*ca, **ckw))
    return {"postings": int(len(a[0])), "whole_call_ms": round(whole, 5),
            "contrib_flat_ms": round(wrap, 5),
            "contrib_flat_device": profiled(
                lambda: kern.contrib_flat(*ca, **ckw), 20),
            "finite": bool(np.isfinite(got).all())}


def host_fit(routes) -> dict:
    """Least squares of the host route's ms on its group's kept postings,
    over every group of every batch size."""
    pts = [(sum(r["entries"]), r["ms"]["host"]) for r in routes
           if r["entries"]]
    x = np.array([p[0] for p in pts], dtype=np.float64)
    y = np.array([p[1] for p in pts], dtype=np.float64)
    slope, base = np.polyfit(x, y, 1)
    return {"HOST_BASE_MS": float(base), "HOST_MS_PER_ENTRY": float(slope),
            "groups": len(pts)}


def pool_qps(seg, nodes, reps=7) -> dict:
    out = {}
    for batch in (1, 8, 64):
        run_batches(seg, nodes, batch)
        passes = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_batches(seg, nodes, batch)
            torch.cuda.synchronize()
            passes.append(len(nodes) / (time.perf_counter() - t0))
        out[str(batch)] = round(float(np.median(passes)), 1)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pool_shapes.py measures on a card")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    out = {"card": card}
    from serenedb_tpu_torch.utils.config import REGISTRY as settings
    settings.set_global("serene_device_cache_mb", chip_smoke.DEVICE_CACHE_MB)
    t0 = time.perf_counter()
    seg, nodes = paged_corpus(dev)
    out["build_s"] = round(time.perf_counter() - t0, 1)
    calls, rr, rc = record_calls(seg, nodes)
    for batch, args in calls.items():
        row = pool_row(*args)
        row["card"] = card
        out[f"pool_score batch {batch}"] = row
        print(f"pool_score batch {batch}", json.dumps(row), flush=True)
    synth = {f"one row of {cp} lanes": synth_row(dev, cp)
             for cp in SYNTH_LANES}
    for kk in SYNTH_KK:
        synth[f"one row of 19048 lanes, kk {kk}"] = synth_row(dev, 19_048,
                                                             kk=kk)
    for what, args in synth.items():
        row = pool_row(*args)
        row["card"] = card
        out[f"pool_score {what}"] = row
        print(f"pool_score {what}", json.dumps(row), flush=True)
    if opts.sweep:
        named = {f"batch {b}": a for b, a in calls.items()}
        named.update(synth)
        out["cluster sweep"] = cluster_sweep(named)
        print("cluster sweep", json.dumps(out["cluster sweep"]), card,
              flush=True)
        del named
    row = ragged_rows(rr, rc)
    row["card"] = card
    out["ragged_contribs batch 64"] = row
    print("ragged_contribs batch 64", json.dumps(row), flush=True)
    routes = [r for b in (1, 8, 64)
              for r in chip_smoke.route_times(seg, nodes, b)]
    out["routes"] = routes
    out["host_fit"] = host_fit(routes)
    out["pool_qps"] = pool_qps(seg, nodes)
    for what in ("host_fit", "pool_qps"):
        print(what, json.dumps(out[what]), card, flush=True)
    for b in (1, 8, 64):
        ms = {k: round(float(np.median([r["ms"][k] for r in routes
                                        if r["batch"] == b])), 4)
              for k in ("pool", "host", "plane")}
        out[f"route median ms batch {b}"] = ms
        print(f"route median ms batch {b}", json.dumps(ms), card, flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "routes"}))


if __name__ == "__main__":
    main()
