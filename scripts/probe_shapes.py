"""Time `ivf_probe` and `merge_topk` at the main path's shapes through this
checkout's wrappers, on one card.

`ivf_probe` runs on a synthetic skewed IVF layout at `sift`'s widths:
1,000,000 rows of 128 integer-valued floats in [0, 255] around 1,024
centroids, list sizes drawn from a lognormal (sigma 0.6: the largest list
several times the mean), cluster-major in the region as the vector pool
keeps them. Its calls are phase 14's: nprobe 16 and kkp 16 at batch 1 and
64, and the brute layout (every row in one list) at 16 queries.
`merge_topk` runs at phase 17's shape, (S, Q, L) = (4, 16, 10) and k 10,
and on chip_smoke.py's crafted batch of ties. For each call:

- `call_ms`: the whole wrapper call, REPS calls between CUDA events;
- `host_ms`: the host's wall time of one call, the stream idle before it;
- `device_ms`: its kernels' device time by name, and the kernels and
  host-to-device copies of one call (torch.profiler);
- `equal`: the outputs bit for bit against a second call and the plain
  version;
- `topk_ms` (merge only): `torch.topk` over the same (Q, S·L) plane, the
  yardstick chip_smoke.py reports.

With `--e2e` it also runs chip_smoke.py's `phase_sift` (the `sift` warm
statement in ms and `IvfIndex.search` QPS at batch 1) and
`shard_search` (the sharded search leg: `topk_batch` ms per shards and
combine).

Run it from the root of the checkout to measure; to compare two
checkouts on one card, copy this script into the other's `scripts/` and
run both in turns:

    python3 scripts/probe_shapes.py [--e2e] [--out FILE]
"""

import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from serenedb_tpu_torch.ops import merge_kernels as mk  # noqa: E402
from serenedb_tpu_torch.ops import vector as vops  # noqa: E402
from serenedb_tpu_torch.ops import vector_kernels as vk  # noqa: E402

REPS = 50
N, DIM, LISTS, NPROBE, KKP = 1_000_000, 128, 1024, 16, 16


def skewed_layout(dev, seed=11):
    """(region, slotmap, offsets, counts, rowids, cents) of the synthetic
    layout on `dev`, the rows' codes, and the host rows."""
    rng = np.random.default_rng(seed)
    w = rng.lognormal(0.0, 0.6, LISTS)
    codes = rng.choice(LISTS, N, p=w / w.sum())
    codes[:LISTS] = np.arange(LISTS)              # no list is empty
    cents = rng.integers(0, 256, (LISTS, DIM)).astype(np.float32)
    x = cents[codes]
    x += rng.integers(-24, 25, (N, DIM), dtype=np.int16)
    np.clip(x, 0, 255, out=x)
    order = np.argsort(codes, kind="stable")
    counts = np.bincount(codes, minlength=LISTS).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lay = (t(x[order]), t(np.arange(N, dtype=np.int32)), t(offsets),
           t(counts), t(order.astype(np.int32)), t(cents))
    return lay, counts, x


def probe_calls(dev):
    """name -> (args, kw) of the three ivf_probe calls."""
    lay, counts, x = skewed_layout(dev)
    rng = np.random.default_rng(12)
    qs = (x[rng.choice(N, 64, replace=False)] +
          rng.integers(-8, 9, (64, DIM), dtype=np.int16)).astype(np.float32)
    m = int(counts.max())
    tm, jm = vops.chunk_maps(NPROBE, m, min(1024, chip_smoke._pow2(m)))
    tm, jm = torch.from_numpy(tm).to(dev), torch.from_numpy(jm).to(dev)
    kw = dict(metric="l2", l_real=LISTS, nprobe=NPROBE, kkp=KKP)
    calls = {}
    for b in (1, 64):
        q = torch.from_numpy(qs[:b]).to(dev)
        calls[f"ivf_probe batch {b}"] = ((*lay, q, tm, jm), kw)
    # the brute layout: one list of every row, 16 queries
    btm, bjm = vops.chunk_maps(1, N, 1024)
    brute = (lay[0], lay[1], torch.zeros(1, dtype=torch.int32, device=dev),
             torch.tensor([N], dtype=torch.int32, device=dev), lay[4],
             torch.zeros((1, DIM), dtype=torch.float32, device=dev),
             torch.from_numpy(qs[:16]).to(dev),
             torch.from_numpy(btm).to(dev), torch.from_numpy(bjm).to(dev))
    calls["ivf_probe brute 16"] = (brute, dict(metric="l2", l_real=1,
                                               nprobe=1, kkp=KKP))
    return calls, {"max_list": m, "mean_list": N / LISTS,
                   "lanes": int(tm.numel())}


def merge_calls(dev):
    """name -> (args, kw) of the two merge_topk calls."""
    from serenedb_tpu_torch.ops.merge_kernels import PAD_DOC
    rng = np.random.default_rng(17)
    S, Q, L = 4, 16, 10
    scores = np.sort(rng.standard_normal((S, Q, L)).astype(np.float32) * 4,
                     axis=2)[:, :, ::-1].copy()
    docs = np.empty((S, Q, L), dtype=np.int32)
    for q in range(Q):
        docs[:, q] = (rng.choice(250_000, (S, L), replace=False) +
                      np.arange(S)[:, None] * 250_000)
    scores[3, :2, 7:] = -np.inf                   # a shard short of k
    docs[3, :2, 7:] = PAD_DOC
    return {"merge_topk (4, 16, 10)": (
                (torch.from_numpy(scores).to(dev),
                 torch.from_numpy(docs).to(dev), 10), {}),
            "merge_topk crafted": chip_smoke.crafted_merge(dev)}


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


def profiled(fn, reps) -> dict:
    """Device ms per kernel name over one fn() (the mean of reps calls),
    and the kernels and host-to-device copies one call issues."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.01)
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
        by_name[name] = by_name.get(name, 0.0) + t / reps / 1e3
    return {"device_ms": {k: round(v, 5) for k, v in by_name.items()},
            "device_sum_ms": round(sum(by_name.values()), 5),
            "kernels_per_call": kernels / reps,
            "htod_copies_per_call": copies / reps}


def same(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


def measure(fn, plain, reps) -> dict:
    first = fn()
    again = fn()
    ref = plain()
    torch.cuda.synchronize()
    row = {"equal": same(first, again) and same(first, ref),
           "call_ms": round(events_ms(fn), 5),
           "host_ms": round(host_ms(fn), 5)}
    row.update(profiled(fn, reps))
    return row


def e2e(dev) -> dict:
    """phase_sift's warm statement and batch-1 QPS, and the sharded
    search leg's topk_batch ms per (shards, combine)."""
    from serenedb_tpu_torch.utils.config import REGISTRY as settings
    settings.set_global("serene_device_cache_mb", chip_smoke.DEVICE_CACHE_MB)
    settings.set_global("serene_vector_pages", chip_smoke.VECTOR_PAGES)
    sift = chip_smoke.phase_sift(dev)
    shard = chip_smoke.shard_search(dev)
    return {"sift_warm_ms_mean": sift["warm_ms"],
            "sift_warm_ms_median": float(np.median(sift["warm_ms_all"])),
            "sift_qps": {str(k): v for k, v in sift["qps"].items()},
            "sift_recall": sift["recall"], "max_list": sift["max_list"],
            "shard_search_ms": {f"{s} {c}": v[0] for (s, c), v in
                                shard["cells"].items()}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--out")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_shapes.py measures on a card")
    dev = torch.device("cuda", 0)
    out = {"card": chip_smoke.card_line()}
    calls, out["layout"] = probe_calls(dev)
    for what, (a, kw) in calls.items():
        reps = 5 if "brute" in what else 20
        row = measure(lambda: vk.ivf_probe(*a, **kw),
                      lambda: vk.ivf_probe_plain(*a, **kw), reps)
        out[what] = row
        print(what, json.dumps(row), flush=True)
    for what, (a, kw) in merge_calls(dev).items():
        row = measure(lambda: mk.merge_topk(*a, **kw),
                      lambda: mk.merge_topk_plain(*a, **kw), 20)
        S, Q, L = a[0].shape
        plane = a[0].permute(1, 0, 2).reshape(Q, S * L).contiguous()
        k = min(a[2], S * L)
        row["topk_ms"] = round(events_ms(lambda: torch.topk(plane, k)), 5)
        out[what] = row
        print(what, json.dumps(row), flush=True)
    if opts.e2e:
        out["e2e"] = e2e(dev)
        print("e2e", json.dumps(out["e2e"]), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
