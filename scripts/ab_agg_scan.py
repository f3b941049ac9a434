"""A/B of the `agg_scan` kernel: another checkout's `agg.cu` against this
tree's, on one card, through the same wrapper.

Three statements run once through `Database.execute` on one
2,097,152-row chunk (the chunk chip_smoke.py's phase 10 checks): q1's
`GROUP BY region` count and sum, q1's scalar count and sum under two
predicates (bench.py bench_q1's table, seed 0), and a 200-group f32 sum
with NULLs. Each statement's `agg_scan` call is recorded and replayed
with the other checkout's library and with this tree's, in turns (other,
this, this, other), ROUNDS times. The two libraries must return the same
outputs, bit for bit; a descriptor layout that differs between the two
sources fails here. Times are CUDA events around the wrapper, as
chip_smoke.py times it, REPS launches each.

    git archive <commit> serenedb_tpu_torch/ops/csrc | tar -x -C <dir>
    python3 scripts/ab_agg_scan.py <dir>/serenedb_tpu_torch/ops/csrc
"""

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from serenedb_tpu_torch.columnar.column import Batch, Column  # noqa: E402
from serenedb_tpu_torch.engine import Database  # noqa: E402
from serenedb_tpu_torch.exec.tables import MemTable  # noqa: E402
from serenedb_tpu_torch.ops import _build  # noqa: E402
from serenedb_tpu_torch.ops import agg_kernels as K  # noqa: E402

ROWS, ROUNDS, REPS = 2_097_152, 5, 50
QUERIES = {
    "q1 GROUP BY region": "SELECT region, count(*), sum(x) FROM q1 "
                          "GROUP BY region",
    "q1 scalar, 2 predicates": "SELECT count(*), sum(x) FROM q1 "
                               "WHERE adv <> 0 AND x < 90000",
    "f32 sum, 200 groups": "SELECT k, sum(f) FROM fl GROUP BY k",
}


def load_other(csrc: str) -> ctypes.CDLL:
    out = os.path.join(tempfile.mkdtemp(), "libagg_other.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                    os.path.join(csrc, "agg.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    for fn, argtypes in _build.SIGNATURES["agg"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def tables() -> dict:
    rng = np.random.default_rng(0)
    q1 = {"adv": rng.choice(np.array([0, 0, 0, 0, 1, 2, 3], np.int32), ROWS),
          "region": rng.integers(0, 200, ROWS).astype(np.int32),
          "x": rng.integers(0, 100000, ROWS).astype(np.int32)}
    rng = np.random.default_rng(8)
    f = rng.random(ROWS) * 1000.0
    fl = {"k": Column.from_numpy(rng.integers(0, 200, ROWS).astype(np.int32)),
          "f": Column.from_numpy(f, validity=rng.random(ROWS) >= 0.05)}
    return {"q1": {n: Column.from_numpy(a) for n, a in q1.items()},
            "fl": fl}


def record_calls(dev) -> dict:
    """Each statement's first agg_scan call, as the main path makes it."""
    db = Database(device=dev)
    for name, cols in tables().items():
        db.schemas["main"].tables[name] = MemTable(
            name, Batch.from_pydict(cols))
    c = db.connect()
    c.execute("SET serene_result_cache = off")
    c.execute("SET serene_device = 'gpu'")
    calls, orig = {}, K.agg_scan

    def wrapper(*a, **kw):
        calls.setdefault(current, (a, kw))
        return orig(*a, **kw)

    K.agg_scan = wrapper
    try:
        for current, q in QUERIES.items():
            c.execute(q).rows()
    finally:
        K.agg_scan = orig
    if set(calls) != set(QUERIES):
        sys.exit(f"agg_scan was not called for {set(QUERIES) - set(calls)}")
    return calls


def flat(raw) -> list:
    rowcount, outs = raw
    return [rowcount] + [t for o in outs for t in o]


def main() -> None:
    dev = torch.device("cuda", 0)
    libs = {"this": _build.load("agg"), "other": load_other(sys.argv[1])}
    calls = record_calls(dev)

    def run(side, a, kw):
        _build._libs["agg"] = libs[side]
        return K.agg_scan(*a, **kw)

    try:
        for what, (a, kw) in calls.items():
            got = {side: flat(run(side, a, kw)) for side in libs}
            torch.cuda.synchronize()
            for x, y in zip(got["this"], got["other"]):
                if x.dtype != y.dtype or not torch.equal(
                        x.view(torch.uint8), y.view(torch.uint8)):
                    sys.exit(f"{what}: the two libraries' outputs differ")
            ms = {"other": [], "this": []}
            for _ in range(ROUNDS):
                for side in ("other", "this", "this", "other"):
                    for _ in range(3):
                        run(side, a, kw)
                    torch.cuda.synchronize()
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    for _ in range(REPS):
                        run(side, a, kw)
                    t1.record()
                    torch.cuda.synchronize()
                    ms[side].append(t0.elapsed_time(t1) / REPS)
            print(f"{what}: outputs equal; ms other {ms['other']}, this "
                  f"{ms['this']}; median other "
                  f"{statistics.median(ms['other'])}, this "
                  f"{statistics.median(ms['this'])}", flush=True)
    finally:
        _build._libs["agg"] = libs["this"]


if __name__ == "__main__":
    main()
