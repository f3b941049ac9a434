"""Time `mesh_score_blocks` and `mesh_agg_partials` built with other values
of their constants, on one card.

Each variant is a copy of `serenedb_tpu_torch/ops/csrc/mesh.cu` with some
`constexpr int` constants replaced (for instance MS_SLICE_MIN: entries a
bin-kernel slice at least; AGG_ROWS: rows a warp has in flight), built
with the port's nvcc flags into its own library and called through its C
entry. The shapes are synthetic stand-ins for chip_smoke.py phase 21's,
made on the card from a seed:

- `bm25`: 597,888 entries (4,671 rows of 128), one posting list's docs
  sorted over an 8,000,512-doc plane (shard 0 of the BM25 builder is
  about its first term's postings);
- `sat`: the first 29,353,984 postings of the packed corpus's zipf
  document-frequency profile (200,000 terms over 8M docs, 120M in all),
  each term's docs sorted, over a 117,415,733-slot plane;
- `agg`: 195,313 x 128 int32 rows in [0, 100,000), every lane set,
  lo 1,000, hi 90,000.

Each call's outputs are checked bit for bit against this checkout's
wrapper; the time is the mean of back-to-back calls between CUDA events,
two rounds of every variant in turn, and the device ms by kernel comes
from torch.profiler. Every result carries the card's nvidia-smi name and
power limit.

    python3 scripts/mesh_variants.py '{"base": {}, "s8k": {"MS_SLICE_MIN": 8192}}' [OUT.json]
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
from serenedb_tpu_torch.ops import mesh_kernels as mk  # noqa: E402

REPS = 20


def build(tmp: str, name: str, subs: dict) -> ctypes.CDLL:
    src = (_build.CSRC / "mesh.cu").read_text()
    for k, v in subs.items():
        src, n = re.subn(rf"constexpr int {k} = [^;]+;",
                         f"constexpr int {k} = {v};", src)
        if n != 1:
            sys.exit(f"{name}: no constant {k}")
    d = os.path.join(tmp, name)
    os.makedirs(d)
    for h in _build.CSRC.glob("*.cuh"):
        with open(os.path.join(d, h.name), "w") as f:
            f.write(h.read_text())
    cu, so = os.path.join(d, "mesh.cu"), os.path.join(d, "lib.so")
    with open(cu, "w") as f:
        f.write(src)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"{name}: nvcc failed\n{r.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build.SIGNATURES["mesh"].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_longlong if fn in _build.SIZE_ENTRIES \
            else ctypes.c_int
    return lib


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
    return out


def caller(lib, shape: str, a):
    """(fn() -> outputs) through lib's C entry, its buffers made once."""
    st = torch.cuda.current_stream().cuda_stream
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


def main() -> int:
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {"base": {}}
    dev = torch.device("cuda", 0)
    res = {"card": chip_smoke.card_line(), "variants": {}}
    data = shapes(dev)
    want = {"agg": mk.mesh_agg_partials(*data["agg"]),
            "bm25": mk.mesh_score_blocks(*data["bm25"]),
            "sat": mk.mesh_score_blocks(*data["sat"])}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(tmp, name, subs)
                for name, subs in variants.items()}
        calls = {(v, s): caller(lib, s, data[s])
                 for v, lib in libs.items() for s in data}
        for (v, s), fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = want[s] if isinstance(want[s], tuple) else (want[s],)
            eq = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                     for x, y in zip(got, ref))
            res["variants"].setdefault(v, {})[s] = {
                "equal": eq, "ms": [],
                "by_kernel": chip_smoke.kernel_split(fn)}

        for _ in range(2):
            for (v, s), fn in calls.items():
                res["variants"][v][s]["ms"].append(
                    chip_smoke.timed_ms(fn, REPS, dev))
    for v, r in res["variants"].items():
        for s, x in r.items():
            print(v, s, "equal" if x["equal"] else "DIFFERS",
                  [round(t, 4) for t in x["ms"]],
                  {k: round(t, 4) for k, t in x["by_kernel"].items()},
                  flush=True)
    print(res["card"])
    if len(sys.argv) > 2:   # all results as JSON
        with open(sys.argv[2], "w") as f:
            json.dump(res, f, indent=1)
    return 0 if all(x["equal"] for r in res["variants"].values()
                    for x in r.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
