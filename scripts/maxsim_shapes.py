"""Time `maxsim` on the `colbert` batch through this checkout's wrapper,
on one card.

The corpus is chip_smoke.py's phase 12 (`phase_colbert`, seeds as
there): 50,000 passages of 32-180 unit 128-d tokens as a MaxSimIndex,
then batches of 16 queries of 32 tokens. The first `maxsim` call of a
16-query batch is recorded and replayed:

- `call_ms`: the whole wrapper call, REPS calls between CUDA events;
- `device_ms`: its kernels' device time by name, and the kernels and
  host-to-device copies of one call (torch.profiler);
- `bound_ms`: the operations' bound, two FP32 instructions per
  multiply-add (the build's -fmad=false keeps a product and a sum
  rounded apart) at 132 SMs x 128 lanes x 1.98 GHz;
- the keys and rows of the call bit for bit against a second call and
  against `maxsim_plain`;
- `qps`: `MaxSimIndex.search_batch` end to end, as phase 12 of
  chip_smoke.py times it (4 warm batches of 16 queries), three times.

Run it from the root of the checkout to measure; to compare two
checkouts on one card, copy this script into the other's `scripts/` and
run both in turns:

    python3 scripts/maxsim_shapes.py
"""

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
from serenedb_tpu_torch.ops import vector_kernels as vk  # noqa: E402
from serenedb_tpu_torch.search.ivf import MaxSimIndex, VecSegment  # noqa

REPS = 5
#: FP32 instructions a second outside the tensor cores: 132 SMs x 128
#: lanes x 1.98 GHz (H100 SXM boost clock)
F32_INSTR = 132 * 128 * 1.98e9


def record(dev, n_docs=50_000, dim=128, q_tokens=32, batch=16):
    # the vector pool and column cache sized as chip_smoke.py sizes them,
    # so that the region stays resident between batches
    from serenedb_tpu_torch.utils.config import REGISTRY as settings
    settings.set_global("serene_device_cache_mb", chip_smoke.DEVICE_CACHE_MB)
    settings.set_global("serene_vector_pages", chip_smoke.VECTOR_PAGES)
    rng = np.random.default_rng(12)
    lens = rng.integers(32, 181, n_docs)
    tok = chip_smoke.unit_rows(rng, int(lens.sum()), dim)
    codes = np.repeat(np.arange(n_docs, dtype=np.int32), lens)
    seg = VecSegment(tok, codes.astype(np.int64), codes, n_docs)
    del tok
    idx = MaxSimIndex(column="c", dim=dim, segs=[seg],
                      doc_rows=np.arange(n_docs, dtype=np.int32),
                      num_rows=n_docs, data_version=0, device=dev)
    idx.layout()
    queries = np.stack([chip_smoke.unit_rows(rng, q_tokens, dim)
                        for _ in range(batch * 5)])
    with chip_smoke.Recorder(vk, "maxsim",
                             lambda a, kw: a[5].shape[0] == batch) as rec:
        idx.search_batch(queries[:batch], 10)
    torch.cuda.synchronize()
    qps = []
    for _ in range(3):
        t0 = time.perf_counter()
        for b in range(1, 5):
            idx.search_batch(queries[b * batch:(b + 1) * batch], 10)
        torch.cuda.synchronize()
        qps.append(4 * batch / (time.perf_counter() - t0))
    return rec.args, qps


def profiled(fn, calls=2) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
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
        by_name[name] = by_name.get(name, 0.0) + t / calls / 1e3
    return {"device_ms": by_name, "kernels_per_call": kernels / calls,
            "htod_copies_per_call": copies / calls}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("maxsim_shapes.py measures on a card")
    dev = torch.device("cuda", 0)
    out = {"card": chip_smoke.card_line()}
    t0 = time.perf_counter()
    (a, kw), qps = record(dev)
    out["setup_s"] = time.perf_counter() - t0
    region, slotmap, offsets, counts, rowids, queries, dmap = a
    bp, sp, dp = queries.shape
    ntok = int(counts.to(torch.int64).sum())

    def call():
        return vk.maxsim(*a, **kw)
    k1, r1 = call()
    k2, r2 = call()
    pk, pr = vk.maxsim_plain(*a, **kw)
    torch.cuda.synchronize()
    same = [bool(torch.equal(k1.view(torch.int32), x.view(torch.int32)) and
                 torch.equal(r1, y)) for x, y in ((k2, r2), (pk, pr))]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    call()
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(REPS):
        call()
    ev[1].record()
    torch.cuda.synchronize()
    row = {"shape": f"B={bp} S={sp} dp={dp} docs={dmap.numel()} "
                    f"tokens={ntok} tile={kw['tile']} kkp={kw['kkp']}",
           "call_ms": ev[0].elapsed_time(ev[1]) / REPS,
           "bound_ms": 2 * bp * sp * ntok * dp / F32_INSTR * 1e3,
           "same_as_second_call": same[0], "same_as_plain": same[1],
           "qps": qps}
    row.update(profiled(call))
    out["colbert"] = row
    print(json.dumps(out))
    if not all(same):
        sys.exit("maxsim differs from a second call or its plain version")


if __name__ == "__main__":
    main()
