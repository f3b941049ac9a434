"""Time `join_probe` (with `join_unmatched`) at the main path's shapes
through this checkout's wrapper, on one card.

J1, J4 and J5 of chip_smoke.py run once through `Database.execute` on
TPC-H SF1 (`tpch_tables`), and the sharded tier's collective shape (phase
17: `SHARD_QUERY` over `shard_tables(1)` at 4 shards, device combine)
once more; each one's first `join_probe` call is recorded and replayed:

- `call_ms`: the whole wrapper call, REPS calls between CUDA events;
- `host_ms`: the host's wall time of one call, the stream idle before it
  (what the caller waits before it can go on), and `host_split`: the
  wrapper's own functions and the torch calls it makes, by cumulative
  host ms a call (cProfile over REPS calls);
- `device_ms`: its kernels' device time by name, and the kernels and
  host-to-device copies of one call (torch.profiler);
- `index_add_ms`: `index_add_` of int64 values into the same G group
  codes, the one-call yardstick chip_smoke.py times;
- `warm_statement_ms`: the statement itself through `Database.execute`,
  warm (the median of WARM runs after the recorded one), end to end.

Run it from the root of the checkout to measure; to compare two
checkouts on one card, copy this script into the other's `scripts/` and
run both in turns:

    python3 scripts/join_shapes.py
"""

import cProfile
import json
import os
import pstats
import re
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from serenedb_tpu_torch.bench.tpch import tpch_tables  # noqa: E402
from serenedb_tpu_torch.columnar.column import Batch  # noqa: E402
from serenedb_tpu_torch.engine import Database  # noqa: E402
from serenedb_tpu_torch.exec.tables import MemTable  # noqa: E402
from serenedb_tpu_torch.ops import agg_kernels as K  # noqa: E402
from serenedb_tpu_torch.ops import join_kernels as J  # noqa: E402

REPS = 50
WARM = 7
TPCH = {"J1": chip_smoke.TPCH_QUERIES[0], "J4": chip_smoke.TPCH_QUERIES[3],
        "J5": chip_smoke.TPCH_QUERIES[4]}


def warm_ms(c, q) -> float:
    """The median host ms of WARM executions of q (rows fetched)."""
    times = []
    for _ in range(WARM):
        t0 = time.perf_counter()
        c.execute(q).rows()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[WARM // 2]


def record(dev) -> tuple:
    """Each shape's first join_probe call, and its statement's warm ms."""
    calls, current, warm = {}, [None], {}
    orig = J.join_probe

    def wrapper(*a, **kw):
        if current[0] is not None and current[0] not in calls:
            calls[current[0]] = (a, kw)
        return orig(*a, **kw)
    J.join_probe = wrapper
    try:
        db = Database(device=dev)
        c = db.connect()
        c.execute("SET serene_result_cache = off")
        for name, cols in tpch_tables().items():
            db.schemas["main"].tables[name] = MemTable(
                name, Batch.from_pydict(cols))
        c.execute("SET serene_device = 'gpu'")
        for what, q in TPCH.items():
            current[0] = what
            c.execute(q).rows()
            current[0] = None
            warm[what] = warm_ms(c, q)
        db = Database(device=dev)
        c = db.connect()
        for name, cols in chip_smoke.shard_tables(1).items():
            db.schemas["main"].tables[name] = MemTable(
                name, Batch.from_pydict(cols))
        for s in ("SET serene_result_cache = off",
                  "SET serene_device_fused = on",
                  "SET serene_morsel_rows = 131072",
                  "SET serene_workers = 4", "SET serene_device = 'gpu'",
                  "SET serene_shards = 4",
                  "SET serene_shard_combine = device"):
            c.execute(s)
        current[0] = "phase 17 collective"
        c.execute(chip_smoke.SHARD_QUERY).rows()
        current[0] = None
        warm["phase 17 collective"] = warm_ms(c, chip_smoke.SHARD_QUERY)
    finally:
        J.join_probe = orig
    return calls, warm


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


def host_ms(fn) -> float:
    """Mean host wall ms of one fn(), the stream drained before each."""
    fn()
    total = 0.0
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / REPS * 1e3


def host_split(fn) -> dict:
    """Cumulative host ms a call of the join and scan wrappers' own
    functions and of the torch calls they make (cProfile)."""
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(REPS):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    out = {}
    for (path, _line, name), row in pstats.Stats(prof).stats.items():
        cum = row[3]
        if path.endswith(("join_kernels.py", "agg_kernels.py",
                          "_build.py")):
            key = f"{os.path.basename(path)}:{name}"
        elif path == "~" and any(w in name for w in (
                "torch", "numpy", "Tensor", "from_numpy", "zeros",
                "full", "empty", "to'", "copy", "ctypes")):
            key = name
        else:
            continue
        out[key] = out.get(key, 0.0) + cum / REPS * 1e3
    return {k: round(v, 5) for k, v in sorted(out.items(),
                                               key=lambda kv: -kv[1])[:16]}


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


def index_add_ms(dev, a) -> float:
    """index_add_ of int64 values into the spec's G groups on the same
    direct codes (chip_smoke.check_join_probe's yardstick)."""
    spec, cols = a[0], a[1]
    n = a[2].numel()
    env = [(K.decode_plain(k, off, d.reshape(-1)), m.reshape(-1))
           for (d, m), k, off in zip(cols, spec.col_kinds,
                                     spec.col_offsets)]
    gc = torch.zeros(n, dtype=torch.int64, device=dev)
    for kind, slot, lo, size in spec.keys:
        data, ok = env[slot]
        cc = data.to(torch.int64) - (lo if kind == K.KEY_INT else 0)
        cc = torch.where(ok, cc, torch.full_like(cc, size - 1))
        gc = gc * size + cc.clamp(0, size - 1)
    vals = env[0][0].to(torch.int64) if env else \
        torch.ones(n, dtype=torch.int64, device=dev)
    return events_ms(lambda: torch.zeros(
        spec.G, dtype=torch.int64, device=dev).index_add_(0, gc, vals))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("join_shapes.py measures on a card")
    dev = torch.device("cuda", 0)
    out = {"card": chip_smoke.card_line()}
    calls, warm = record(dev)
    for what, (a, kw) in calls.items():
        def call():
            J.join_probe(*a, **kw)
        spec = a[0]
        right = a[5] if len(a) > 5 else kw.get("right")
        row = {"rows": a[2].numel(), "G": spec.G, "g": spec.g,
               "entries": [x.kind for x in spec.aggs],
               "right": right is not None,
               "call_ms": events_ms(call), "host_ms": host_ms(call),
               "host_split": host_split(call)}
        row.update(profiled(call))
        row["index_add_ms"] = index_add_ms(dev, a)
        row["warm_statement_ms"] = warm[what]
        out[what] = row
        print(what, json.dumps(row), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
