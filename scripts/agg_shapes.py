"""Time `agg_scan` and `agg_fold` at the analytics path's chunk shapes
through this checkout's wrappers, on one card.

Each statement below runs once through `Database.execute` on tables of
one 2,097,152-row chunk (the q1, hits and float generators of
chip_smoke.py, seeds as there; TPC-H SF1 for the J1 join's build), and
its first `agg_scan` call (and the float GROUP BY k's first `agg_fold`
call, and agg_fold on a seeded 8,192 x 201 plane) is recorded and
replayed REPS times: the whole wrapper call, as the path makes it,
between CUDA events, and the device time of its kernels (output zeroing
included) from torch.profiler, by kernel name; beside agg_fold,
`plane.view(P, G).sum(0)` the same two ways. The last line is one JSON
object: per shape its ms.

Run it from the root of the checkout to measure; to compare two
checkouts on one card, copy this script into the other's `scripts/` and
run both in turns:

    python3 scripts/agg_shapes.py
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
from serenedb_tpu_torch.ops import agg_kernels as K  # noqa: E402

ROWS, REPS = 2_097_152, 20
SHAPES = {
    "q1 GROUP BY region": ("q1", "SELECT region, count(*), sum(x) FROM hits "
                                 "GROUP BY region"),
    "hits Q16": ("hits", chip_smoke.HITS_QUERIES[4]),
    "float GROUP BY k": ("float", chip_smoke.FLOAT_QUERIES[0]),
    "float GROUP BY k2": ("float", chip_smoke.FLOAT_QUERIES[1]),
    "float scalar": ("float", chip_smoke.FLOAT_QUERIES[2]),
    "J1 build": ("tpch", chip_smoke.TPCH_QUERIES[0]),
}


def tables(which: str) -> dict:
    if which == "q1":
        return {"hits": chip_smoke.q1_columns(ROWS)}
    if which == "hits":
        return {"hits": chip_smoke.hits_columns(ROWS)}
    if which == "float":
        return {"fl": chip_smoke.float_columns(ROWS)}
    return tpch_tables()


def record(dev) -> dict:
    """Each shape's first agg_scan call (and the float k's agg_fold)."""
    calls, current = {}, [None]
    orig = {"agg_scan": K.agg_scan, "agg_fold": K.agg_fold}

    def wrap(name):
        def wrapper(*a, **kw):
            key = (name, current[0])
            if current[0] is not None and key not in calls:
                calls[key] = (a, kw)
            return orig[name](*a, **kw)
        return wrapper
    K.agg_scan, K.agg_fold = wrap("agg_scan"), wrap("agg_fold")
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
        K.agg_scan, K.agg_fold = orig["agg_scan"], orig["agg_fold"]
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


def device_ms(fn) -> dict:
    """Device ms of one fn() per kernel name, from torch.profiler over
    REPS calls; empty where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or \
            getattr(ev, "cuda_time_total", 0)
        if t:
            m = re.search(r"(\w+_kernel)", ev.key)
            name = m.group(1) if m else ev.key[:40]
            out[name] = out.get(name, 0.0) + t / REPS / 1e3
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("agg_shapes.py measures on a card")
    dev = torch.device("cuda", 0)
    out = {"card": chip_smoke.card_line()}
    calls = record(dev)
    # and agg_fold on a seeded plane of 8,192 rows of 201 groups
    plane = np.random.default_rng(0).standard_normal(8192 * 201)
    calls[("agg_fold", "plane (8,192 x 201)")] = (
        (torch.from_numpy(plane.astype(np.float32)).to(dev), 201), {})
    for (name, what), (a, kw) in calls.items():
        fn = getattr(K, name)

        def call():
            fn(*a, **kw)
        row = {"call_ms": events_ms(call), "device_ms": device_ms(call)}
        if name == "agg_fold":     # the one-call yardstick
            plane, G = a

            def library():
                plane.view(-1, G).sum(0)
            row["library_ms"] = events_ms(library)
            row["library_device_ms"] = device_ms(library)
        out[f"{name} {what}"] = row
        print(f"{name} {what}: {row}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
