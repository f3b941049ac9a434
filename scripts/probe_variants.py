"""Time `ivf_probe` built with other values of its constants, on one card.

Each variant is a copy of `serenedb_tpu_torch/ops/csrc/vector.cu` with
some `constexpr int` constants replaced (PR_DS: dims a slab; PR_TARGET:
stage 2's blocks a call; PR_GROUP: blocks a group merges), built with the
port's nvcc flags into its own library and called through its C entry.
The calls: nprobe 16 and kkp 16 at batch 1 and 64 over two 1M x 128
layouts at `sift`'s widths (1,024 lists of even size, and
`probe_shapes.py`'s lognormal skew), and the brute layout at 16 queries.
Each call's outputs are checked bit for bit against this checkout's
`ivf_probe`; the time is the mean of back-to-back calls between CUDA
events, two rounds of every variant in turn.

    python3 scripts/probe_variants.py '{"base": {}, "ds32": {"PR_DS": 32}}'
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from serenedb_tpu_torch.ops import _build  # noqa: E402
from serenedb_tpu_torch.ops import vector as vops  # noqa: E402
from serenedb_tpu_torch.ops import vector_kernels as vk  # noqa: E402

N, DIM, LISTS = 1_000_000, 128, 1024


def build(tmp: str, name: str, subs: dict) -> ctypes.CDLL:
    src = (_build.CSRC / "vector.cu").read_text()
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
    cu, so = os.path.join(d, "vector.cu"), os.path.join(d, "lib.so")
    with open(cu, "w") as f:
        f.write(src)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"{name}: nvcc failed\n{r.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build.SIGNATURES["vector"].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_longlong if fn in _build.SIZE_ENTRIES \
            else ctypes.c_int
    return lib


def layout(dev, sigma: float, seed: int = 11):
    """A cluster-major 1M x 128 layout (list sizes lognormal(0, sigma), or
    even at sigma 0), 64 queries near its rows, the maps at nprobe 16."""
    rng = np.random.default_rng(seed)
    w = rng.lognormal(0.0, sigma, LISTS) if sigma else np.ones(LISTS)
    codes = rng.choice(LISTS, N, p=w / w.sum())
    codes[:LISTS] = np.arange(LISTS)
    cents = rng.integers(0, 256, (LISTS, DIM)).astype(np.float32)
    x = cents[codes]
    x += rng.integers(-24, 25, x.shape, dtype=np.int16)
    order = np.argsort(codes, kind="stable")
    counts = np.bincount(codes, minlength=LISTS).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    qs = (x[rng.choice(N, 64, replace=False)] +
          rng.integers(-8, 9, (64, DIM), dtype=np.int16)).astype(np.float32)
    m = int(counts.max())
    tm, jm = vops.chunk_maps(16, m, min(1024, 1 << (m - 1).bit_length()))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lay = (t(x[order]), t(np.arange(N, dtype=np.int32)), t(offsets),
           t(counts), t(order.astype(np.int32)), t(cents))
    return lay, qs, t(tm), t(jm)


def call(lib, a, kw):
    region, slotmap, offsets, counts, rowids, cents, q, tm, _jm = a
    qp, dp = q.shape
    lp, nl = cents.shape[0], tm.numel()
    nb = lib.probe_bytes(qp, lp, kw["nprobe"], nl, kw["kkp"])
    buf = torch.empty(nb, dtype=torch.uint8, device=q.device)
    out = torch.empty((2, qp, kw["kkp"]), dtype=torch.int32, device=q.device)
    _build.check(lib.ivf_probe(
        region.data_ptr(), slotmap.data_ptr(), offsets.data_ptr(),
        counts.data_ptr(), rowids.data_ptr(), cents.data_ptr(),
        q.data_ptr(), qp, dp, lp, kw["l_real"], kw["nprobe"], nl,
        kw["kkp"], vk.METRICS[kw["metric"]], buf.data_ptr(), nb,
        out[0].data_ptr(), out[1].data_ptr(),
        torch.cuda.current_stream().cuda_stream), "ivf_probe")
    return out


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_variants.py measures on a card")
    variants = json.loads(sys.argv[1])
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp()
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(
            lambda kv: build(tmp, *kv), variants.items())))
    kw16 = dict(metric="l2", l_real=LISTS, nprobe=16, kkp=16)
    cases = {}
    for lname, sigma in (("even", 0.0), ("skew", 0.6)):
        lay, qs, tm, jm = layout(dev, sigma)
        for b in (1, 64):
            q = torch.from_numpy(qs[:b]).to(dev)
            cases[f"{lname} b{b}"] = ((*lay, q, tm, jm), kw16,
                                      200 if b == 1 else 50)
        if not sigma:
            btm, bjm = vops.chunk_maps(1, N, 1024)
            brute = (lay[0], lay[1],
                     torch.zeros(1, dtype=torch.int32, device=dev),
                     torch.tensor([N], dtype=torch.int32, device=dev),
                     lay[4], torch.zeros((1, DIM), device=dev),
                     torch.from_numpy(qs[:16]).to(dev),
                     torch.from_numpy(btm).to(dev),
                     torch.from_numpy(bjm).to(dev))
            cases["brute 16"] = (brute, dict(metric="l2", l_real=1,
                                             nprobe=1, kkp=16), 5)
    ref = {k: vk.ivf_probe(*a, **kw) for k, (a, kw, _r) in cases.items()}
    print(json.dumps({"card": chip_smoke.card_line()}))
    for rnd in range(2):
        for name, lib in libs.items():
            row = {}
            for k, (a, kw, reps) in cases.items():
                out = call(lib, a, kw)
                torch.cuda.synchronize()
                same = torch.equal(out[0], ref[k][0].view(torch.int32)) and \
                    torch.equal(out[1], ref[k][1])
                row[k] = [round(events_ms(lambda: call(lib, a, kw), reps), 4),
                          same]
            print(rnd, name, json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
