"""Time `topk_rows` and `kmeans_update` at the main path's shapes through
this checkout's wrappers, on one card.

Inputs are made on the card from seeds (the same in every checkout):
- `packed`: a (16, 8,000,512) plane, `bm25_8m`'s ndocs_pad, about 5 % of
  each row scored, int32 hit counts and require 2 on every other row;
- `dense`: a (256, 100,352) plane, the dense regime's, f32 hit counts;
- `sift`: kmeans_update on `chip_smoke.sift_corpus` (1,000,000 x 128)
  assigned to 1,024 of its rows, as IvfIndex's first k-means iteration;
- `sift_skewed`: the same with 93 % of the rows moved to one cluster.
Each call is checked bit for bit against its plain version, then timed:
the whole wrapper call between CUDA events (REPS calls), its kernels'
device time by name and the kernels and host-to-device copies of one
call from torch.profiler, and the one PyTorch call for the same work
(`torch.topk` of the scores; `index_add_` of the rows and the counts).
Where the checkout has TOPK_ONE_MAX, topk_rows is also timed in both of
its regimes at k = 1,024 ... 8,192, the timings that set the cap. The
last line is one JSON object.

Run it from the root of the checkout; to compare two checkouts on one
card, copy this script into the other's `scripts/` and run both in
turns (`--no-sweep` leaves out the cap sweep).

    python3 scripts/topk_shapes.py [--no-sweep]
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
from serenedb_tpu_torch.ops import _build  # noqa: E402
from serenedb_tpu_torch.ops import bm25_kernels as kern  # noqa: E402
from serenedb_tpu_torch.ops import vector as vops  # noqa: E402
from serenedb_tpu_torch.ops import vector_kernels as vk  # noqa: E402

REPS = 20


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


def plane(dev, rows: int, n: int, hits_dtype, seed: int):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    on = torch.rand((rows, n), generator=g, device=dev) < 0.05
    scores = torch.where(on, torch.rand((rows, n), generator=g, device=dev)
                         * 20.0, torch.zeros((), device=dev))
    hits = torch.where(on, torch.randint(1, 3, (rows, n), generator=g,
                                         device=dev), 0).to(hits_dtype)
    require = (torch.arange(rows, device=dev, dtype=torch.int32) % 2) * 2
    return scores, hits, require


def topk_row(scores, hits, require, k: int) -> dict:
    got = kern.topk_rows(scores, k, hits, require)
    ref = kern.topk_rows_plain(scores, k, hits, require)
    torch.cuda.synchronize()
    if not (torch.equal(got[1], ref[1]) and torch.equal(
            got[0].view(torch.int32), ref[0].view(torch.int32))):
        sys.exit(f"topk_rows differs from its plain version at "
                 f"{tuple(scores.shape)} k={k}")

    def call():
        kern.topk_rows(scores, k, hits, require)
    row = {"shape": f"{tuple(scores.shape)} k={k}",
           "call_ms": events_ms(call)}
    row.update(profiled(call))
    row["torch_topk_ms"] = events_ms(lambda: torch.topk(scores, k, dim=1))
    return row


def kmeans_row(x, a, c) -> dict:
    got = vk.kmeans_update(x, a, c)
    ref = vk.kmeans_update_plain(x, a, c)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        sys.exit("kmeans_update differs from its plain version")
    idx = a.to(torch.int64)
    ones = torch.ones(x.shape[0], device=x.device)

    def library():
        torch.zeros_like(c).index_add_(0, idx, x)
        torch.zeros(c.shape[0], device=x.device).index_add_(0, idx, ones)

    def call():
        vk.kmeans_update(x, a, c)
    row = {"shape": f"N={x.shape[0]} K={c.shape[0]} D={x.shape[1]} "
                    f"largest={int(torch.bincount(idx).max())}",
           "call_ms": events_ms(call)}
    row.update(profiled(call))
    row["index_add_ms"] = events_ms(library)
    return row


def cap_sweep(dev, shapes) -> dict:
    """topk_rows' call and device ms in each regime at k past 1,000."""
    out = {}
    saved = kern.TOPK_ONE_MAX
    try:
        for what, (scores, hits, require) in shapes.items():
            for k in (1024, 2048, 4096, 8192):
                row = {}
                for regime, cap in (("one_read", k), ("radix", 0)):
                    kern.TOPK_ONE_MAX = cap

                    def call():
                        kern.topk_rows(scores, k, hits, require)
                    row[regime] = {"call_ms": events_ms(call),
                                   "device_ms": sum(profiled(call)[
                                       "device_ms"].values())}
                out[f"{what} k={k}"] = row
                print("cap", what, k, json.dumps(row), flush=True)
    finally:
        kern.TOPK_ONE_MAX = saved
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("topk_shapes.py measures on a card")
    dev = torch.device("cuda", 0)
    out = {"card": chip_smoke.card_line()}
    for lib in ("bm25", "vector"):
        _build.load(lib)
        lines = _build.BUILD_LOG.get(lib, {}).get("log", "").splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and re.search(r"topk_|km_", line):
                print(lib, re.search(r"(\w+_kernel)", line).group(1),
                      " | ".join(x.strip() for x in lines[i + 1:i + 4]),
                      flush=True)
    shapes = {"packed": plane(dev, 16, 8_000_512, torch.int32, 1),
              "dense": plane(dev, 256, 100_352, torch.float32, 2)}
    for what, (scores, hits, require) in shapes.items():
        out[what] = topk_row(scores, hits, require, 10)
        print(what, json.dumps(out[what]), flush=True)
    x_np, _q = chip_smoke.sift_corpus(1_000_000)
    x = torch.from_numpy(x_np.astype(np.float32)).to(dev)
    del x_np
    c = x[torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(
        3))[:1024].to(dev)].contiguous()
    a = vops.assign_clusters(x, c)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    skew = torch.where(torch.rand(x.shape[0], generator=g, device=dev)
                       < 0.93, torch.full_like(a, 5), a)
    for what, assign in (("sift", a), ("sift_skewed", skew)):
        out[what] = kmeans_row(x, assign.contiguous(), c)
        print(what, json.dumps(out[what]), flush=True)
    if hasattr(kern, "TOPK_ONE_MAX") and "--no-sweep" not in sys.argv:
        out["cap_sweep"] = cap_sweep(dev, shapes)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
