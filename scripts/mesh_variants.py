"""Time the mesh kernels and `match_bitmap` built with other values of
their constants, on one card.

Each variant is a copy of `serenedb_tpu_torch/ops/csrc/mesh.cu` (and of
`bm25.cu` where a constant is there) with some `constexpr int` constants
replaced (for instance MS_SLICE_MIN: entries a bin-kernel slice at least;
AGG_ROWS: rows a warp has in flight; MC_VEC: 16-byte vectors a thread of
`mesh_combine`; MC_BULK_M: the shards it stages at a time by bulk copies;
MB_THREADS: `match_bitmap`'s block), built with the port's nvcc flags into its own library and
called through its C entry. A variant builds the sources its constants
are in (the empty variant both) and times their shapes. The shapes are
synthetic stand-ins for chip_smoke.py phases 21 and 17, made on the card
from a seed:

- `bm25`: 597,888 entries (4,671 rows of 128), one posting list's docs
  sorted over an 8,000,512-doc plane (shard 0 of the BM25 builder is
  about its first term's postings);
- `sat`: the first 29,353,984 postings of the packed corpus's zipf
  document-frequency profile (200,000 terms over 8M docs, 120M in all),
  each term's docs sorted, over a 117,415,733-slot plane;
- `agg`: 195,313 x 128 int32 rows in [0, 100,000), every lane set,
  lo 1,000, hi 90,000;
- `combine`: the search leg's `mesh_combine`, four f32 planes of 16 x
  8,000,512 each in its own buffer, summed; `combine_stack`: the same
  values as the rows of one (M, N) stack; beside them, once a round, the
  library's `stack.sum(0)` over that stack: a yardstick of time only (it
  promises no shard order); `combine8`: eight f32 planes of 8 x 8,000,512
  (the same bytes over more shards than one stage holds);
- `bitmap`: `match_bitmap` over an 8,000,512-doc bitmap (the packed
  corpus's) from 4,000 packed rows, 2 raw rows and 3,000 tails.

(--shapes: time only these shapes; --rounds: rounds of every variant in
turn, 2 by default.) Each variant's ptxas report (registers,
spills) of the combine and bitmap kernels is printed. Each call's outputs
are checked bit for bit against this checkout's
wrapper; the time is the mean of back-to-back calls between CUDA events,
in rounds of every variant in turn, and the device ms by kernel (and
memset) comes from torch.profiler. Every result carries the card's nvidia-smi name and
power limit.

    python3 scripts/mesh_variants.py '{"base": {}, "s8k": {"MS_SLICE_MIN": 8192}}' [OUT.json] [--shapes=sat,bm25]
    python3 scripts/mesh_variants.py '{"b4": {}, "b2": {"MC_BULK_M": 2}}' --shapes=combine,combine_stack,combine8
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from serenedb_tpu_torch.ops import _build  # noqa: E402
from serenedb_tpu_torch.ops import bm25_kernels  # noqa: E402
from serenedb_tpu_torch.ops import mesh_kernels as mk  # noqa: E402

REPS = 20


#: each variant's ptxas lines, by variant
REPORT: dict = {}
#: the sources a variant may rebuild, and the shapes each one's library
#: times
LIBS = {"mesh": ("agg", "bm25", "sat", "combine", "combine_stack",
                 "combine8"),
        "bm25": ("bitmap",)}


def build(tmp: str, name: str, subs: dict) -> dict:
    """{library: CDLL} of the sources that hold the variant's constants
    (both for the empty variant), each built with them replaced."""
    srcs = {lib: (_build.CSRC / f"{lib}.cu").read_text() for lib in LIBS}
    todo = set(LIBS) if not subs else set()
    for k, v in subs.items():
        hits = [lib for lib, src in srcs.items()
                if re.search(rf"constexpr int {k} = [^;]+;", src)]
        if len(hits) != 1:
            sys.exit(f"{name}: constant {k} in {hits or 'no source'}")
        srcs[hits[0]] = re.sub(rf"constexpr int {k} = [^;]+;",
                               f"constexpr int {k} = {v};", srcs[hits[0]])
        todo.add(hits[0])
    d = os.path.join(tmp, name)
    os.makedirs(d)
    for h in _build.CSRC.glob("*.cuh"):
        with open(os.path.join(d, h.name), "w") as f:
            f.write(h.read_text())
    libs = {}
    for lib in sorted(todo):
        cu, so = os.path.join(d, f"{lib}.cu"), os.path.join(d, f"{lib}.so")
        with open(cu, "w") as f:
            f.write(srcs[lib])
        r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                            cu], capture_output=True, text=True)
        if r.returncode:        # the variant is left out, the rest run
            print(f"{name}: nvcc failed for {lib}.cu\n{r.stderr[-3000:]}",
                  flush=True)
            return {}
        keep = False
        for line in (r.stdout + r.stderr).splitlines():
            if "Compiling entry" in line:
                keep = "mesh_combine_kernel" in line or \
                    "match_bitmap_kernel" in line
            if keep and ("Compiling entry" in line or "spill" in line or
                         "registers" in line):
                REPORT.setdefault(name, []).append(line.strip())
        libs[lib] = ctypes.CDLL(so)
        for fn, argtypes in _build.SIGNATURES[lib].items():
            f = getattr(libs[lib], fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_longlong if fn in _build.SIZE_ENTRIES \
                else ctypes.c_int
    return libs


def sorted_lists(sizes, n_docs: int, gen, dev) -> torch.Tensor:
    """Each list of `sizes` as sorted random docs in [0, n_docs)."""
    terms = torch.repeat_interleave(
        torch.arange(len(sizes), device=dev),
        torch.as_tensor(sizes, device=dev))
    docs = torch.randint(0, n_docs, (terms.numel(),), device=dev,
                         generator=gen)
    keys = torch.sort(terms * n_docs + docs).values
    return (keys % n_docs).to(torch.int32)


def shapes(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    n_docs = 8_000_000
    out = {}
    e = 4_671 * 128
    docs = sorted_lists([e], n_docs, gen, dev)
    tfs = torch.randint(1, 65, (e,), device=dev, generator=gen,
                        dtype=torch.int32)
    norms = torch.randint(1, 400, (8_000_512,), device=dev, generator=gen,
                          dtype=torch.int32)
    gidx = torch.arange(e, device=dev, dtype=torch.int32).view(-1, 128)
    bt = torch.zeros(gidx.shape[0], device=dev, dtype=torch.int32)
    idf = torch.tensor([1.7], device=dev)
    out["bm25"] = (docs, tfs, norms, gidx, bt, idf, 143.2, 8_000_512, "bm25")
    raw = 1.0 / np.arange(1, 200_001) ** 0.9
    df = np.minimum(np.maximum(raw / raw.sum() * 120_000_000, 1.0),
                    n_docs * 0.8).astype(np.int64)
    e = 29_353_984
    cut = int(np.searchsorted(np.cumsum(df), e))
    sizes = df[:cut + 1].copy()
    sizes[-1] -= int(sizes.sum()) - e
    docs = sorted_lists(sizes, n_docs, gen, dev)
    tfs = torch.randint(1, 65, (e,), device=dev, generator=gen,
                        dtype=torch.int32)
    gidx = torch.arange(e, device=dev, dtype=torch.int32).view(-1, 128)
    out["sat"] = (docs, tfs, None, gidx, None, None, 1.0, 117_415_733,
                  "saturation")
    vals = torch.randint(0, 100_000, (195_313, 128), device=dev,
                         generator=gen, dtype=torch.int32)
    out["agg"] = (vals, torch.ones_like(vals, dtype=torch.bool), 1000,
                  90_000)
    n = 16 * 8_000_512
    out["combine"] = ([torch.randn(n, device=dev, generator=gen)
                       for _ in range(4)], "sum")
    out["combine8"] = ([torch.randn(n // 2, device=dev, generator=gen)
                        for _ in range(8)], "sum")
    nd = 8_000_512
    rows = 4_000
    gaps = torch.randint(0, 40, (rows, 128), device=dev, generator=gen,
                         dtype=torch.int32)
    out["bitmap"] = (
        torch.randint(0, nd, (rows,), device=dev, generator=gen,
                      dtype=torch.int32),
        gaps.to(torch.int16).view(torch.uint16),
        torch.randint(0, 4, (rows, 128), device=dev, generator=gen,
                      dtype=torch.int32).to(torch.uint8),
        torch.arange(rows, device=dev, dtype=torch.int32),
        torch.randint(-1, nd, (2, 128), device=dev, generator=gen,
                      dtype=torch.int32),
        torch.tensor([1, 0], device=dev, dtype=torch.int32),
        torch.randint(-1, nd, (3_000,), device=dev, generator=gen,
                      dtype=torch.int32), nd)
    return out


def caller(lib, shape: str, a):
    """(fn() -> outputs) through lib's C entry, its buffers made once."""
    st = torch.cuda.current_stream().cuda_stream
    if shape.startswith("combine"):
        segs = mk._segments([a])
        out = [torch.empty_like(segs[0][0][0])]
        descs = mk.combine_descriptors(segs, out)

        def fn():
            for desc in descs:
                _build.check(lib.mesh_combine(desc.ctypes.data, st),
                             "mesh_combine")
            return out[0]
        return fn
    if shape == "bitmap":
        out = torch.empty(a[-1], dtype=torch.bool, device=a[0].device)

        def fn():
            base, gaps, tfs8, rows, raw, raw_idx, tail, nd = a
            _build.check(lib.match_bitmap(
                base.data_ptr(), gaps.data_ptr(), tfs8.data_ptr(),
                rows.data_ptr(), rows.numel(), raw.data_ptr(),
                raw_idx.data_ptr(), raw_idx.numel(), tail.data_ptr(),
                tail.numel(), nd, out.data_ptr(), st), "match_bitmap")
            return out
        return fn
    if shape == "agg":
        vals, mask, lo, hi = a
        out = torch.empty(1 + 2 * vals.shape[0], dtype=torch.int32,
                          device=vals.device)

        def fn():
            _build.check(lib.mesh_agg_partials(
                vals.data_ptr(), mask.data_ptr(), vals.shape[0], lo, hi,
                out.data_ptr(), st), "mesh_agg_partials")
            return out[:1], out[1:].view(-1, 2)
        return fn
    docs, tfs, norms, gidx, bt, idf, avgdl, nd, mode = a
    E = gidx.numel()
    buf = torch.empty(lib.score_bytes(E, nd), dtype=torch.uint8,
                      device=gidx.device)
    plane = torch.empty(nd, dtype=torch.float32, device=gidx.device)
    bm25 = mode == "bm25"

    def fn():
        _build.check(lib.mesh_score_blocks(
            docs.data_ptr(), tfs.data_ptr(),
            norms.data_ptr() if bm25 else None, gidx.data_ptr(),
            bt.data_ptr() if bm25 else None, idf.data_ptr() if bm25 else None,
            E, gidx.shape[1], nd, mk.SCORE_MODES[mode], 1.2, 0.75,
            float(np.float32(avgdl)), buf.data_ptr(), plane.data_ptr(), st),
            "mesh_score_blocks")
        return plane
    return fn


def device_split(fn, calls: int = 5) -> dict:
    """Device ms a call by kernel name, memsets included (torch.profiler,
    the mean over `calls` calls after a warm-up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"(\w+_kernel)", ev.name)
        name = m.group(1) if m else ev.name[:40]
        t = getattr(ev, "device_time_total", 0) or \
            getattr(ev, "cuda_time_total", 0)
        ms[name] = ms.get(name, 0.0) + t / 1e3 / calls
    return ms


def main() -> int:
    flags = {a.split("=", 1)[0]: a.split("=", 1)[1]
             for a in sys.argv[1:] if a.startswith("--")}
    argv = [a for a in sys.argv if not a.startswith("--")]
    only = set(flags["--shapes"].split(",")) if "--shapes" in flags \
        else None
    rounds = int(flags.get("--rounds", 2))
    variants = json.loads(argv[1]) if len(argv) > 1 else {"base": {}}
    dev = torch.device("cuda", 0)
    res = {"card": chip_smoke.card_line(), "variants": {}}
    data = shapes(dev)
    want = {"agg": mk.mesh_agg_partials(*data["agg"]),
            "bm25": mk.mesh_score_blocks(*data["bm25"]),
            "sat": mk.mesh_score_blocks(*data["sat"]),
            "combine": mk.mesh_combine_plain(*data["combine"]),
            "combine8": mk.mesh_combine_plain(*data["combine8"]),
            "bitmap": bm25_kernels.match_bitmap_plain(*data["bitmap"])}
    stack = torch.stack(data["combine"][0])
    data["combine_stack"] = (stack, "sum")
    want["combine_stack"] = want["combine"]
    res["library"] = {"combine stack.sum(0)": []}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(tmp, name, subs)
                for name, subs in variants.items()}
        calls = {(v, s): caller(lib, s, data[s])
                 for v, built in libs.items() for name, lib in built.items()
                 for s in LIBS[name] if only is None or s in only}
        for (v, s), fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = want[s] if isinstance(want[s], tuple) else (want[s],)
            eq = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                     for x, y in zip(got, ref))
            res["variants"].setdefault(v, {})[s] = {
                "equal": eq, "ms": [], "by_kernel": device_split(fn)}

        for _ in range(rounds):
            for (v, s), fn in calls.items():
                res["variants"][v][s]["ms"].append(
                    chip_smoke.timed_ms(fn, REPS, dev))
            res["library"]["combine stack.sum(0)"].append(
                chip_smoke.timed_ms(lambda: stack.sum(0), REPS, dev))
    for v, r in res["variants"].items():
        for s, x in r.items():
            print(v, s, "equal" if x["equal"] else "DIFFERS",
                  [round(t, 4) for t in x["ms"]],
                  {k: round(t, 4) for k, t in x["by_kernel"].items()},
                  flush=True)
    for what, ms in res["library"].items():
        print("library", what, [round(t, 4) for t in ms], flush=True)
    print(res["card"])
    for v, lines in REPORT.items():
        for line in lines:
            print("ptxas", v, line)
    res["ptxas"] = REPORT
    if len(argv) > 2:   # all results as JSON
        with open(argv[2], "w") as f:
            json.dump(res, f, indent=1)
    return 0 if all(x["equal"] for r in res["variants"].values()
                    for x in r.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
