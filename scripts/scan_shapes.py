"""Time the split prepare (`scan_eval`) at the main path's shapes on one
card: this checkout's kernel and another checkout's on the same inputs.

The shapes are the first `scan_eval` call of three of chip_smoke.py's
statements past one launch, run once through `Database.execute` on the
card over its generators' tables (seeded as there) and recorded:

- W1: q1's top-N under a filter 12 deep, over 100,000,768 rows;
- W3: hits' WHERE 12 deep under 17 sums, its first 2,097,152-row chunk;
- J6: the TPC-H SF1 probe side of 18 aggregates under a predicate 12
  deep, 5,998,592 rows.

For each shape, in rounds that take every side in turn (the other
checkout, this one, this one, the other):

- this checkout: the whole call (`chip_smoke.timed_ms`) and the device
  time (`chip_smoke.queued_ms`: the calls queued behind a spin), each
  output bit for bit against the plain version; its build's ptxas
  report (registers, spills, stack frame) is printed first;
- `--other DIR`: the other checkout's kernel on the same spec (one
  fused launch where its `scan_kernels` has `Derive`; else the parent
  of the fused launch, one launch a derive and a mask pass of at most 8
  programs, converted from the fused spec); its whole calls and device
  time, its tiles and mask equal to this one's.

With `--statements`, W1, W3 and J6 themselves: each warm statement's
ms (`Database.execute` to its rows, a sync after) in this checkout and,
with `--other`, in the other's over the same generated tables, in
rounds of other, this, this, other; rows equal between the two.

The byte bound is chip_smoke.py's: each input tile and mask read once
(the row mask only under a mask pass), each written tile, validity and
the mask written once. Every line carries the card's nvidia-smi name and
power limit.

    python3 scripts/scan_shapes.py [--other _archive/parent] [--rounds=3] \
        [--statements]
"""

import argparse
import importlib
import importlib.util
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from serenedb_tpu_torch.ops import _build  # noqa: E402
from serenedb_tpu_torch.ops import scan_kernels as S  # noqa: E402

REPS = 20


def load_other(root: str):
    """The package of the checkout at `root`, imported as `other_sdb`."""
    init = os.path.join(root, "serenedb_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        "other_sdb", init, submodule_search_locations=[os.path.dirname(init)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_sdb"] = mod
    spec.loader.exec_module(mod)
    return mod


STATEMENTS = (("W1", lambda: {"hits": cs.q1_columns(100_000_000)},
               cs.Q1_WIDE[0][0]),
              ("W3", lambda: {"hits": cs.hits_columns(10_000_000)},
               cs.HITS_WIDE[1][0]),
              ("J6", None, cs.TPCH_WIDE[0][0]))


def statements(dev, other, rounds: int) -> None:
    """Each statement's warm ms in this checkout and the other's, in
    rounds of other, this, this, other; the rows equal."""
    import time
    from serenedb_tpu_torch.bench.tpch import tpch_tables
    pkgs = {"this": "serenedb_tpu_torch"}
    if other is not None:
        pkgs = {"parent": other.__name__, **pkgs}
    for name, tables, q in STATEMENTS:
        cols = (tables or tpch_tables)()
        conns = {}
        for side, pkg in pkgs.items():
            col = importlib.import_module(f"{pkg}.columnar.column")
            eng = importlib.import_module(f"{pkg}.engine")
            tab = importlib.import_module(f"{pkg}.exec.tables")
            cfg = importlib.import_module(f"{pkg}.utils.config")
            cfg.REGISTRY.set_global("serene_device_cache_mb",
                                    cs.DEVICE_CACHE_MB)
            dts = importlib.import_module(f"{pkg}.columnar.dtypes")
            db = eng.Database(device=dev)
            for t, columns in cols.items():
                # this checkout's columns as the other package's
                db.schemas["main"].tables[t] = tab.MemTable(
                    t, col.Batch.from_pydict({
                        k: col.Column(dts.SqlType(
                            dts.TypeId[c.type.id.name],
                            None if c.type.elem is None else
                            dts.TypeId[c.type.elem.name]),
                            c.data, c.validity, c.dictionary)
                        for k, c in columns.items()}))
            c = db.connect()
            c.execute("SET serene_result_cache = off")
            c.execute("SET serene_device = 'gpu'")
            c.execute(q).rows()
            conns[side] = c
        rows = {side: c.execute(q).rows() for side, c in conns.items()}
        if len({repr(r) for r in rows.values()}) != 1:
            sys.exit(f"{name}: the checkouts' rows differ")
        order = list(conns) + list(reversed(list(conns)))
        ms = {side: [] for side in conns}
        for _ in range(rounds):
            for side in order:
                t0 = time.perf_counter()
                conns[side].execute(q).rows()
                torch.cuda.synchronize(dev)
                ms[side].append((time.perf_counter() - t0) * 1e3)
        for side, xs in ms.items():
            xs = sorted(xs)
            print(f"{name} statement, {side}: warm median "
                  f"{xs[len(xs) // 2]:.3f} ms [{xs[0]:.3f}-{xs[-1]:.3f}] "
                  f"over {len(xs)} runs", flush=True)
        del conns, cols


def record(dev) -> dict:
    """{shape: (spec, cols, rowmask)}: the first scan_eval call of each
    statement, run once on the card."""
    from serenedb_tpu_torch.bench.tpch import tpch_tables
    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    from serenedb_tpu_torch.utils.config import REGISTRY as settings
    settings.set_global("serene_device_cache_mb", cs.DEVICE_CACHE_MB)
    calls, cur = {}, [None]
    orig = S.scan_eval

    def rec(spec, cols, rowmask):
        if cur[0] is not None and cur[0] not in calls:
            calls[cur[0]] = (spec, list(cols), rowmask)
        return orig(spec, cols, rowmask)
    S.scan_eval = rec
    try:
        for name, tables, (q, _k) in (
                ("W1", lambda: {"hits": cs.q1_columns(100_000_000)},
                 cs.Q1_WIDE[0]),
                ("W3", lambda: {"hits": cs.hits_columns(10_000_000)},
                 cs.HITS_WIDE[1]),
                ("J6", tpch_tables, cs.TPCH_WIDE[0])):
            db = Database(device=dev)
            for t, columns in tables().items():
                db.schemas["main"].tables[t] = MemTable(
                    t, Batch.from_pydict(columns))
            c = db.connect()
            c.execute("SET serene_result_cache = off")
            c.execute("SET serene_device = 'gpu'")
            cur[0] = name
            c.execute(q).rows()
            cur[0] = None
            torch.cuda.synchronize(dev)
    finally:
        S.scan_eval = orig
    return calls


def flat(spec, out) -> list:
    tiles, mask = out
    return [t for pair in tiles if pair is not None for t in pair] + \
        ([mask] if spec.preds else [])


def same(got, ref) -> bool:
    return len(got) == len(ref) and all(
        cs.same_f32(g, r) if g.dtype == torch.float32 else torch.equal(g, r)
        for g, r in zip(got, ref))


def parent_passes(other, spec, cols, rowmask):
    """The other checkout's calls for the fused spec: its one fused
    launch where it has one, else each derive pass one launch over the
    slots its program reads, then the predicates in mask passes of at
    most 8 programs over at most 16 slots (the caps before the fused
    launch)."""
    ok_mod = importlib.import_module(f"{other.__name__}.ops.scan_kernels")
    if hasattr(ok_mod, "Derive"):
        ev = ok_mod.EvalSpec(
            list(spec.col_kinds), list(spec.col_offsets),
            [ok_mod.Derive(d.prog, d.out, d.stored) for d in spec.derived],
            list(spec.preds))
        return lambda: ok_mod.scan_eval(ev, cols, rowmask), 1
    kinds, offs = list(spec.col_kinds), list(spec.col_offsets)
    steps = []

    def local(prog):
        slots = sorted({a for op, a, _ in prog if op == 0})
        loc = {s: i for i, s in enumerate(slots)}
        return slots, tuple((op, loc[a] if op == 0 else a, imm)
                            for op, a, imm in prog)
    for d in spec.derived:
        slots, prog = local(d.prog)
        steps.append(("derive", slots, ok_mod.EvalSpec(
            [kinds[s] for s in slots], [offs[s] for s in slots], prog=prog,
            out=d.out)))
        kinds.append(d.out)
        offs.append(0)
    group, gslots = [], set()
    groups = []
    for p in spec.preds:
        s = {a for op, a, _ in p if op == 0}
        if group and (len(group) == 8 or len(gslots | s) > 16):
            groups.append(group)
            group, gslots = [], set()
        group.append(p)
        gslots |= s
    if group:
        groups.append(group)
    for g in groups:
        slots = sorted({a for p in g for op, a, _ in p if op == 0})
        loc = {s: i for i, s in enumerate(slots)}
        steps.append(("mask", slots, ok_mod.EvalSpec(
            [kinds[s] for s in slots], [offs[s] for s in slots],
            preds=[tuple((op, loc[a] if op == 0 else a, imm)
                         for op, a, imm in p) for p in g])))

    def run():
        tiles, rm = list(cols), rowmask
        out = []
        for mode, slots, ev in steps:
            r = ok_mod.scan_eval(ev, [tiles[s] for s in slots], rm)
            if mode == "derive":
                tiles.append(r)
                out.append(r)
            else:
                rm = r
        return out, rm
    return run, len(steps)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--statements", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: scan_shapes.py runs on a card")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    print(f"card: {card}; {nvcc.strip().splitlines()[-1]}", flush=True)
    _build.load("scan")
    print("ptxas, scan.cu:", flush=True)
    for ln in _build.BUILD_LOG.get("scan", {}).get("log", "").splitlines():
        if "registers" in ln or "spill" in ln or "stack" in ln:
            print("    " + ln.strip(), flush=True)
    other = load_other(args.other) if args.other else None
    if args.statements:
        statements(dev, other, 5 * args.rounds)
    calls = record(dev)
    for name, (spec, cols, rowmask) in calls.items():
        ref = flat(spec, S.scan_eval_plain(spec, cols, rowmask))
        moved = cs.nbytes(*[t for pair in cols for t in pair],
                          rowmask if spec.preds else None, *ref)
        bound = cs.bound_ms(moved)
        sides = {"this": lambda: S.scan_eval(spec, cols, rowmask)}
        n_parent = 0
        if other is not None:
            prun, n_parent = parent_passes(other, spec, cols, rowmask)
            sides = {"parent": prun, **sides}
        for side, fn in sides.items():
            out = fn()
            torch.cuda.synchronize(dev)
            if side == "parent":      # it writes every derived tile
                got = [t for d, pair in zip(spec.derived, out[0])
                       if d.stored for t in pair] + \
                    ([out[1]] if spec.preds else [])
            else:
                got = flat(spec, out)
            if not same(got, ref):
                sys.exit(f"{name}: {side}'s outputs differ from the plain "
                         "version's")
        order = list(sides) + list(reversed(list(sides)))
        times = {side: ([], []) for side in sides}
        for _ in range(args.rounds):
            for side in order:
                times[side][0].append(cs.timed_ms(sides[side], REPS, dev))
                times[side][1].append(cs.queued_ms(sides[side], REPS, dev))
        aligned = all(t.data_ptr() % 16 == 0
                      for t in [t for pair in cols for t in pair] + [rowmask])
        shape = (f"rows={rowmask.numel()} inputs={len(cols)} "
                 f"{'16-byte aligned' if aligned else 'not all aligned'} "
                 f"kinds={list(spec.col_kinds)} derived="
                 f"{len(spec.derived)} (stored "
                 f"{sum(d.stored for d in spec.derived)}) masks="
                 f"{len(spec.preds)} stages={spec.plan.n_stages}")
        print(f"{name} ({shape}; bound {bound:.4f} ms, {moved} bytes; "
              f"{card}):", flush=True)
        for side, (whole, queued) in times.items():
            whole, queued = sorted(whole), sorted(queued)
            launches = n_parent if side == "parent" else 1
            print(f"    {side}: {launches} launch(es) a call; whole call "
                  f"median {whole[len(whole) // 2]:.4f} ms "
                  f"[{whole[0]:.4f}-{whole[-1]:.4f}], device median "
                  f"{queued[len(queued) // 2]:.4f} ms "
                  f"[{queued[0]:.4f}-{queued[-1]:.4f}], "
                  f"{queued[len(queued) // 2] / bound:.2f}x the bound",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
