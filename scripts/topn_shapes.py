"""Time `topn_scan` and `chain_topn` at the main path's shapes through this
checkout's wrappers, on one card.

The top-N statements of chip_smoke.py run once through `Database.execute`
on its tables (seeds as there): T1-T3 on `q1` at 100,000,000 rows, T4 on
`hits` at 10,000,000, J2 (the chained top-N) on TPC-H SF1. Each one's
first `topn_scan` / `chain_topn` call is recorded and replayed REPS times:
the whole wrapper call between CUDA events; its kernels' device time by
name, and the kernels and host-to-device copies of one call, from
torch.profiler; and `torch.topk` of the same transformed keys, the
one-call yardstick. Where the checkout has `CHAIN_ONE_MAX`, chain_topn is
also timed on seeded slots at G = 4,096 ... 131,072 with the one-block
path and with the passes, the timings that set the cap. The last line is
one JSON object.

Run it from the root of the checkout to measure; to compare two
checkouts on one card, copy this script into the other's `scripts/` and
run both in turns:

    python3 scripts/topn_shapes.py
"""

import json
import os
import re
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from serenedb_tpu_torch.bench.tpch import tpch_tables  # noqa: E402
from serenedb_tpu_torch.columnar.column import Batch  # noqa: E402
from serenedb_tpu_torch.engine import Database  # noqa: E402
from serenedb_tpu_torch.exec.tables import MemTable  # noqa: E402
from serenedb_tpu_torch.ops import topn_kernels as TK  # noqa: E402

REPS = 20
SHAPES = {
    "T1": ("q1", chip_smoke.Q1_TOPN[0]),
    "T2": ("q1", chip_smoke.Q1_TOPN[1]),
    "T3": ("q1", chip_smoke.Q1_TOPN[2]),
    "T4": ("hits", chip_smoke.HITS_TOPN[0]),
    "J2": ("tpch", chip_smoke.TPCH_QUERIES[1]),
}


def tables(which: str) -> dict:
    if which == "q1":
        return {"hits": chip_smoke.q1_columns(100_000_000)}
    if which == "hits":
        return {"hits": chip_smoke.hits_columns(10_000_000)}
    return tpch_tables()


def record(dev) -> dict:
    """Each shape's first topn_scan or chain_topn call."""
    calls, current = {}, [None]
    orig = {"topn_scan": TK.topn_scan, "chain_topn": TK.chain_topn}

    def wrap(name):
        def wrapper(*a, **kw):
            if current[0] is not None and current[0] not in calls:
                calls[current[0]] = (name, a, kw)
            return orig[name](*a, **kw)
        return wrapper
    TK.topn_scan, TK.chain_topn = wrap("topn_scan"), wrap("chain_topn")
    try:
        by_table: dict = {}
        for what, (t, q) in SHAPES.items():
            by_table.setdefault(t, []).append((what, q))
        for t, items in by_table.items():
            db = Database(device=dev)
            c = db.connect()
            c.execute("SET serene_result_cache = off")
            for name, cols in tables(t).items():
                db.schemas["main"].tables[name] = MemTable(
                    name, Batch.from_pydict(cols))
            c.execute("SET serene_device = 'gpu'")
            for what, q in items:
                current[0] = what
                c.execute(q).rows()
                current[0] = None
    finally:
        TK.topn_scan, TK.chain_topn = orig["topn_scan"], orig["chain_topn"]
    return calls


def events_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def profiled(fn) -> dict:
    """Device ms per kernel name over one fn() (the mean of REPS calls),
    and the kernels and host-to-device copies one call issues."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    by_name, kernels, copies = {}, 0, 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        if ev.name.startswith("Memcpy"):
            copies += "HtoD" in ev.name
            continue
        if ev.name.startswith("Memset"):
            continue
        kernels += 1
        m = re.search(r"(\w+_kernel)", ev.name)
        name = m.group(1) if m else ev.name[:40]
        t = getattr(ev, "device_time_total", 0) or \
            getattr(ev, "cuda_time_total", 0)
        by_name[name] = by_name.get(name, 0.0) + t / REPS / 1e3
    return {"device_ms": by_name, "kernels_per_call": kernels / REPS,
            "htod_copies_per_call": copies / REPS}


def chain_keys(a) -> torch.Tensor:
    rowcount, src, stride, size, desc, k, _outs = a
    G = rowcount.numel()
    v = src.to(torch.int32) if src is not None else \
        ((torch.arange(G, device=rowcount.device) // stride) % size).to(
            torch.int32)
    return torch.where(rowcount > 0, v if desc else ~v,
                       torch.full_like(v, -2**31))


def cap_sweep(dev) -> dict:
    """chain_topn's call and device ms at k_pad 16 on seeded slots
    (J2-like counts, ties and a fifth absent), one-block path against the
    passes."""
    rng = np.random.default_rng(11)
    out = {}
    saved = TK.CHAIN_ONE_MAX
    try:
        for G in (4096, 10_001, 16_384, 32_768, 65_536, 131_072):
            counts = np.where(rng.random(G) < 0.2, 0,
                              rng.integers(1, 40, G))
            rowcount = torch.from_numpy(counts).to(dev)
            outs = [rowcount, torch.from_numpy(
                rng.integers(0, 9, 2 * G).astype(np.int64)).to(dev)]
            row = {}
            for path, cap in (("one_block", G), ("passes", 0)):
                if path == "one_block" and G > 32_768:
                    continue
                TK.CHAIN_ONE_MAX = cap

                def call():
                    TK.chain_topn(rowcount, rowcount, 1, 1, True, 16, outs)
                row[path] = {"call_ms": events_ms(call), "device_ms": sum(
                    profiled(call)["device_ms"].values())}
            out[str(G)] = row
    finally:
        TK.CHAIN_ONE_MAX = saved
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("topn_shapes.py measures on a card")
    dev = torch.device("cuda", 0)
    out = {"card": chip_smoke.card_line()}
    calls = record(dev)
    for what, (name, a, kw) in calls.items():
        fn = getattr(TK, name)

        def call():
            fn(*a, **kw)
        row = {"kernel": name, "call_ms": events_ms(call)}
        row.update(profiled(call))
        if name == "topn_scan":
            keys = chip_smoke._topn_keys(a[0], a[1], a[2])
            k = a[3]
        else:
            keys, k = chain_keys(a), a[5]
        row["torch_topk_ms"] = events_ms(lambda: torch.topk(keys, k))
        out[what] = row
        print(what, json.dumps(row), flush=True)
    if hasattr(TK, "CHAIN_ONE_MAX"):
        out["chain_cap_sweep"] = cap_sweep(dev)
        print("cap", json.dumps(out["chain_cap_sweep"]), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
