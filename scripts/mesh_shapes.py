"""Time `mesh_agg_partials`, `mesh_score_blocks` and the search leg's
`mesh_combine` step at chip_smoke.py phase 21's shapes on one card, this
checkout's kernels beside another checkout's.

The shapes are phase 21's builders' (`chip_smoke.mesh_builders`) at mesh
width 4, shard 0 of each:

- `mesh_agg_partials`: a quarter of q1's 100M-row column (195,313 x 128
  rows, seed 0), every row lane set, lo 1,000, hi 90,000;
- `mesh_score_blocks` bm25: the postings of four terms of the packed
  corpus (8M docs, 200,000 terms, 120M sampled postings, seed 9), a
  quarter of their 128-wide rows (~600,000 entries) over the
  8,000,512-doc plane;
- `mesh_score_blocks` saturation: a quarter of all the corpus's postings
  (~29.4M entries) over a plane of one slot a posting (~117.4M);
- the combine step of `ops/bm25.py` `score_topk_mesh` on the four
  shards' score planes of a 16-query batch of the packed corpus's
  require-free queries at mesh_n = 4 (4 x 16 x 8,000,512 f32), recorded
  from this checkout's `topk_batch`: handed to `mesh_combine` as parts,
  or (`--stacked`, for a checkout whose `mesh_combine` takes a stack
  only) as that checkout's step did it, each plane copied into an (M, N)
  stack first; its call ms and the peak device bytes it allocates;
- that batch's whole `score_topk_mesh` call, the recorded arguments
  handed to each checkout's function: the peak device bytes above what
  was allocated before it, and what was allocated before and after each
  of its `bm25_accumulate`, `mesh_combine` and `topk_rows` calls with the
  peak so far (where the peak is reached, and what it holds); and this checkout's whole `topk_batch` call
  of the batch, as chip_smoke.py phase 21 measures its batches;
- q1's three aggregate statements (phase 6's table, cut to 8,388,608
  rows: four 2,097,152-row chunks) at serene_mesh = 4, warm: each one's
  device operations (kernels, copies, memsets; torch.profiler) and
  `agg_scan` launches, so a chunk's operations read as the total over
  the chunks (the operations a statement pays once included).

For each call: the wrapper's whole call (CUDA events over REPS calls,
after a warm-up), its kernels, host-to-device copies and memsets and its
device ms from a captured CUDA graph (graph replays), its scratch bytes,
and its result bit for bit against the plain version. Then the three
builders over a 4-wide virtual mesh on the card, host clock around a
synchronised run.

With `--other DIR` (the root of another checkout, such as the parent
unpacked by `git archive` into a git-ignored directory) that checkout's
package is loaded beside this one under another name, its results are
held bit for bit against this one's, and each measurement alternates
between the two in `--pairs` pairs (other, this, this, other, ...), in
one process on one card. Every result carries the card's nvidia-smi name
and power limit. Run from the root of this checkout:

    python3 scripts/mesh_shapes.py [--other DIR [--stacked]] [--pairs 10] [--out FILE]

(--out: all results as JSON, each pair's times included.)
"""

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import serenedb_tpu_torch  # noqa: E402

REPS = 20
WIDTH = 4


def load_other(root: str):
    """The package of the checkout at `root`, imported as `other_sdb`."""
    init = os.path.join(root, "serenedb_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        "other_sdb", init, submodule_search_locations=[os.path.dirname(init)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_sdb"] = mod
    spec.loader.exec_module(mod)
    return mod


def shapes(dev) -> dict:
    """name -> (wrapper name, args) at phase 21's shard 0."""
    from serenedb_tpu_torch.ops import bm25 as bm25_ops
    from serenedb_tpu_torch.parallel import mesh as pmesh
    from serenedb_tpu_torch.search.analysis import get_analyzer
    from serenedb_tpu_torch.search.searcher import SegmentSearcher

    n = 100_000_000
    x = chip_smoke.q1_columns(n)["x"].data
    rows = -(-n // 128)
    rows += (-rows) % WIDTH
    a, b = pmesh.shard_slices(rows, WIDTH)[0]
    t = np.zeros(rows * 128, np.int32)
    t[:n] = x
    vals = torch.from_numpy(t.reshape(rows, 128)[a:b].copy()).to(dev)
    valid = np.zeros(rows * 128, bool)
    valid[:n] = True
    mask = torch.from_numpy(valid.reshape(rows, 128)[a:b].copy()).to(dev)
    del x, t, valid

    fi = chip_smoke.synth_posting_index(8_000_000, 200_000, 120_000_000, 9,
                                        dev)
    searcher = SegmentSearcher(fi, get_analyzer("simple"), 8_000_000,
                               device=dev)
    store = searcher._device_store()
    flat_docs = torch.from_numpy(fi.post_docs.astype(np.int32)).to(dev)
    flat_tfs = torch.from_numpy(fi.post_tfs.astype(np.int32)).to(dev)
    tids = [1 + 97 * i for i in range(4)]
    g_rows, bt = [], []
    for j, tid in enumerate(tids):
        r = np.arange(fi.offsets[tid], fi.offsets[tid + 1], dtype=np.int64)
        r = np.concatenate([r, np.full((-len(r)) % 128, -1)])
        g_rows.append(r.reshape(-1, 128))
        bt.append(np.full(len(r) // 128, j, dtype=np.int32))
    g = np.concatenate(g_rows).astype(np.int32)
    bt = np.concatenate(bt)
    pad = (-len(g)) % WIDTH
    g = np.concatenate([g, np.full((pad, 128), -1, np.int32)])
    bt = np.concatenate([bt, np.zeros(pad, np.int32)])
    a, b = pmesh.shard_slices(len(g), WIDTH)[0]
    gidx = torch.from_numpy(g[a:b].copy()).to(dev)
    block_term = torch.from_numpy(bt[a:b].copy()).to(dev)
    idf = torch.from_numpy(bm25_ops.idf_lucene(
        searcher.num_docs, fi.doc_freq[tids]).astype(np.float32)).to(dev)
    P = flat_docs.numel()
    ga = np.arange(P + (-P) % (128 * WIDTH), dtype=np.int64)
    ga[P:] = -1
    ga = ga.astype(np.int32).reshape(-1, 128)
    a, b = pmesh.shard_slices(len(ga), WIDTH)[0]
    gall = torch.from_numpy(ga[a:b].copy()).to(dev)
    planes, mesh_args, batch_peak = search_planes(searcher, dev)
    return {
        "combine step": planes,
        "batch memory": (mesh_args, batch_peak),
        "mesh_agg_partials": ("mesh_agg_partials",
                              (vals, mask, 1000, 90_000)),
        "mesh_score_blocks bm25": ("mesh_score_blocks", (
            flat_docs, flat_tfs, store.norms, gidx, block_term, idf,
            float(fi.avgdl), store.ndocs_pad, "bm25")),
        "mesh_score_blocks saturation": ("mesh_score_blocks", (
            flat_docs, flat_tfs, None, gall, None, None, 1.0, P,
            "saturation")),
        "builders": (vals, mask, flat_docs, flat_tfs, store, g, bt, idf,
                     float(fi.avgdl), ga),
    }


def search_planes(searcher, dev) -> tuple:
    """The four score planes `score_topk_mesh` hands `mesh_combine` for
    the first 16 require-free queries of phase 4's mix at mesh_n = 4, the
    arguments of that `score_topk_mesh` call, and the peak device bytes
    of the whole `topk_batch` call above what was allocated before it."""
    from serenedb_tpu_torch.ops import bm25 as bm25_ops
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    from serenedb_tpu_torch.parallel import mesh as pmesh
    from serenedb_tpu_torch.search.query import parse_query
    nodes = [parse_query(q, searcher.analyzer)
             for q in chip_smoke.packed_queries()]
    free = [n for n in nodes if not searcher._query_shape(n)[1]][:16]
    with pmesh.virtual_devices(WIDTH), \
            chip_smoke.Recorder(mk, "mesh_combine") as rec, \
            chip_smoke.Recorder(bm25_ops, "score_topk_mesh") as rec_s:
        searcher.topk_batch(free, 10, mesh_n=WIDTH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        searcher.topk_batch(free, 10, mesh_n=WIDTH)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
    return list(rec.args[0][0]), rec_s.args, peak


def batch_memory(pkg, args, dev) -> dict:
    """One `score_topk_mesh` call of `pkg` on the recorded arguments: the
    peak device bytes above what was allocated before it, and for each of
    its kernel wrappers' calls the bytes allocated before and after it
    and the peak so far, each above that base."""
    bm = importlib.import_module(f"{pkg.__name__}.ops.bm25")
    bk = importlib.import_module(f"{pkg.__name__}.ops.bm25_kernels")
    mk = importlib.import_module(f"{pkg.__name__}.ops.mesh_kernels")
    pm = importlib.import_module(f"{pkg.__name__}.parallel.mesh")
    steps = []

    def traced(mod, name):
        orig = getattr(mod, name)

        def call(*a, **kw):
            before = torch.cuda.memory_allocated(dev)
            r = orig(*a, **kw)
            steps.append((name, before, torch.cuda.memory_allocated(dev),
                          torch.cuda.max_memory_allocated(dev)))
            return r
        return orig, call
    wrapped = [(mod, name, *traced(mod, name)) for mod, name in (
        (bk, "bm25_accumulate"), (mk, "mesh_combine"), (bk, "topk_rows"))]
    a, kw = args
    with pm.virtual_devices(WIDTH):
        bm.score_topk_mesh(*a, **kw)
        torch.cuda.synchronize()
        for mod, name, _orig, call in wrapped:
            setattr(mod, name, call)
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            bm.score_topk_mesh(*a, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
        finally:
            for mod, name, orig, _call in wrapped:
                setattr(mod, name, orig)
    return {"peak_over_base": peak,
            "steps": [(n, b0 - base, b1 - base, top - base)
                      for n, b0, b1, top in steps]}


def combine_step(mk, planes: list, stacked: bool):
    """The search leg's combine step: the planes as parts, or (stacked)
    copied into an (M, N) stack first, as a checkout whose `mesh_combine`
    takes a stack only did it."""
    if not stacked:
        return mk.mesh_combine(planes, "sum")
    stack = torch.empty((len(planes), planes[0].numel()),
                        dtype=planes[0].dtype, device=planes[0].device)
    for s, p in enumerate(planes):
        stack[s].copy_(p.reshape(-1))
    return mk.mesh_combine(stack, "sum").view(planes[0].shape)


def measure_step(pkgs: dict, planes: list, stacked: bool, pairs: int,
                 dev) -> dict:
    mods = {k: importlib.import_module(f"{p.__name__}.ops.mesh_kernels")
            for k, p in pkgs.items()}
    fns = {k: (lambda mk=mk, st=(stacked and k == "other"):
               combine_step(mk, planes, st)) for k, mk in mods.items()}
    out, got = {}, {}
    for k, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        got[k] = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        out[k] = {"stacked": stacked and k == "other", "peak_bytes": peak,
                  "equal_plain": same(got[k], mods["this"].mesh_combine_plain(
                      planes, "sum")), "equal_again": same(got[k], fn()),
                  "call_ms": []}
    if len(mods) > 1:
        out["equal_other"] = same(got["this"], got["other"])
    del got
    for i in range(pairs):
        order = list(fns) if i % 2 == 0 else list(fns)[::-1]
        for k in order:
            out[k]["call_ms"].append(chip_smoke.timed_ms(fns[k], REPS, dev))
    for k in fns:
        out[k]["call_ms_median"] = statistics.median(out[k]["call_ms"])
    return out


def chunk_ops(pkg, dev, n: int = 4 * 2_097_152) -> dict:
    """Per q1 aggregate statement at serene_mesh = WIDTH, warm: device
    operations by kind over one execution (torch.profiler) and the
    chunks (`agg_scan` launches / WIDTH), through `pkg`'s engine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mods = {m: importlib.import_module(f"{pkg.__name__}.{m}") for m in (
        "engine", "columnar.column", "exec.tables", "parallel.mesh",
        "device")}
    Column = mods["columnar.column"].Column
    rng = np.random.default_rng(0)
    cols = {"adv": Column.from_numpy(rng.choice(np.array(
                [0, 0, 0, 0, 1, 2, 3], dtype=np.int32), n)),
            "region": Column.from_numpy(rng.integers(0, 200, n)
                                        .astype(np.int32)),
            "x": Column.from_numpy(rng.integers(0, 100000, n)
                                   .astype(np.int32))}
    out = {}
    with mods["parallel.mesh"].virtual_devices(WIDTH):
        db = mods["engine"].Database(device=dev)
        db.schemas["main"].tables["hits"] = mods["exec.tables"].MemTable(
            "hits", mods["columnar.column"].Batch.from_pydict(cols))
        c = db.connect()
        for st in ("SET serene_result_cache = off",
                   "SET serene_device = 'gpu'",
                   f"SET serene_mesh = {WIDTH}"):
            c.execute(st)
        for q in chip_smoke.Q1_QUERIES:
            c.execute(q).rows()
            torch.cuda.synchronize()
            L = mods["device"].LAUNCHES
            a0 = L.get("agg_scan")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                c.execute(q).rows()
                torch.cuda.synchronize()
            ops = {"kernels": 0, "copies": 0, "memsets": 0}
            for ev in prof.events():
                if ev.device_type != DeviceType.CUDA:
                    continue
                kind = "memsets" if ev.name.startswith("Memset") else \
                    "copies" if ev.name.startswith("Memcpy") else "kernels"
                ops[kind] += 1
            chunks = (L.get("agg_scan") - a0) // WIDTH
            out[q] = {"chunks": chunks, "ops": ops,
                      "ops_a_chunk": sum(ops.values()) / max(chunks, 1)}
    return out


def bits(out) -> list:
    out = out if isinstance(out, tuple) else (out,)
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in out]


def same(x, y) -> bool:
    return all(torch.equal(a, b) for a, b in zip(bits(x), bits(y)))


def scratch(mk, name: str, args) -> int:
    if name == "mesh_agg_partials":
        return 0
    E, nd = args[3].numel(), args[7]
    if hasattr(mk, "score_plan"):
        return mk.score_plan(E, nd).bytes
    return int(mk._build.load("mesh").score_bytes(E, nd))


def measure_call(pkgs: dict, name: str, args, pairs: int, dev) -> dict:
    mods = {k: importlib.import_module(f"{p.__name__}.ops.mesh_kernels")
            for k, p in pkgs.items()}
    out = {}
    for k, mk in mods.items():
        fn = getattr(mk, name)
        got, again = fn(*args), fn(*args)
        ref = getattr(mk, name + "_plain")(*args)
        torch.cuda.synchronize()
        (kern_n, copies, memsets), g = chip_smoke.graph_nodes(
            lambda: fn(*args))
        out[k] = {"equal_plain": same(got, ref), "equal_again": same(got,
                                                                     again),
                  "kernels": kern_n, "copies": copies, "memsets": memsets,
                  "device_ms": chip_smoke.graph_ms(g),
                  "scratch": scratch(mk, name, args), "call_ms": []}
        out[k]["_got"] = got
        del g
    if len(mods) > 1:
        out["equal_other"] = same(out["this"]["_got"], out["other"]["_got"])
    for k in mods:
        out[k].pop("_got")
    for i in range(pairs):
        order = list(mods) if i % 2 == 0 else list(mods)[::-1]
        for k in order:
            fn = getattr(mods[k], name)
            out[k]["call_ms"].append(
                chip_smoke.timed_ms(lambda: fn(*args), REPS, dev))
    for k in mods:
        out[k]["call_ms_median"] = statistics.median(out[k]["call_ms"])
    return out


def measure_builders(pkgs: dict, data, pairs: int, dev) -> dict:
    vals_s, mask_s, flat_docs, flat_tfs, store, g, bt, idf, avgdl, ga = data
    del vals_s, mask_s
    n = 100_000_000
    cols = chip_smoke.q1_columns(n)
    x, region = cols["x"].data, cols["region"].data
    del cols
    rows = -(-n // 128)
    rows += (-rows) % WIDTH

    def tiles(arr):
        t = np.zeros(rows * 128, dtype=arr.dtype)
        t[:n] = arr
        return torch.from_numpy(t.reshape(rows, 128)).to(dev)
    vals, codes = tiles(x), tiles(region)
    valid = np.zeros(rows * 128, bool)
    valid[:n] = True
    mask = torch.from_numpy(valid.reshape(rows, 128)).to(dev)
    gidx = torch.from_numpy(g).to(dev)
    block_term = torch.from_numpy(bt).to(dev)
    gall = torch.from_numpy(ga).to(dev)
    ball = torch.zeros(gall.shape[0], dtype=torch.int32, device=dev)
    runs = {}
    for k, p in pkgs.items():
        pm = importlib.import_module(f"{p.__name__}.parallel.mesh")

        def run(pm=pm):
            with pm.virtual_devices(WIDTH):
                m = pm.make_mesh(WIDTH, base=dev)
                a = pm.sharded_agg_step(m)(vals, mask, 1000, 90_000)
                b = pm.sharded_bm25_topk(m, store.ndocs_pad, 10)(
                    flat_docs, flat_tfs, store.norms, gidx, block_term, idf,
                    avgdl)
                q = pm.sharded_query_step(m, 200)(
                    vals, mask, codes, flat_docs, flat_tfs, gall, ball)
                torch.cuda.synchronize()
            return a, b, q
        run()
        runs[k] = run
    out = {k: {"ms": []} for k in runs}
    for i in range(pairs):
        order = list(runs) if i % 2 == 0 else list(runs)[::-1]
        for k in order:
            t0 = time.perf_counter()
            runs[k]()
            out[k]["ms"].append((time.perf_counter() - t0) * 1e3)
    for k in runs:
        out[k]["ms_median"] = statistics.median(out[k]["ms"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=None)
    ap.add_argument("--stacked", action="store_true",
                    help="the other checkout's combine step stacks first")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default=None, help="write the results here "
                    "as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: mesh_shapes.py runs on a card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    pkgs = {"this": serenedb_tpu_torch}
    if args.other:
        pkgs = {"other": load_other(os.path.abspath(args.other)),
                "this": serenedb_tpu_torch}
    res = {"card": chip_smoke.card_line(),
           "torch": torch.__version__, "pairs": args.pairs, "calls": {}}
    t0 = time.perf_counter()
    data = shapes(dev)
    res["setup_s"] = time.perf_counter() - t0
    for label, item in data.items():
        if label == "builders":
            continue
        if label == "batch memory":
            r = {k: batch_memory(p, item[0], dev) for k, p in pkgs.items()}
            r["this topk_batch peak_over_base"] = item[1]
            res["batch_memory"] = r
            print(label, json.dumps(r), flush=True)
            continue
        if label == "combine step":
            r = measure_step(pkgs, item, args.stacked, args.pairs, dev)
        else:
            r = measure_call(pkgs, item[0], item[1], args.pairs, dev)
        res["calls"][label] = r
        print(label, json.dumps({k: (v if not isinstance(v, dict) else {
            kk: vv for kk, vv in v.items() if kk != "call_ms"})
            for k, v in r.items()}), flush=True)
    res["chunk_ops"] = {k: chunk_ops(p, dev) for k, p in pkgs.items()}
    print("chunk_ops", json.dumps(res["chunk_ops"]), flush=True)
    res["builders"] = measure_builders(pkgs, data["builders"], args.pairs,
                                       dev)
    print("builders", json.dumps({k: v["ms_median"] for k, v in
                                  res["builders"].items()}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(res["card"])
    ok = all(r[k]["equal_plain"] and r[k]["equal_again"]
             for r in res["calls"].values() for k in pkgs) and \
        all(r.get("equal_other", True) for r in res["calls"].values())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
