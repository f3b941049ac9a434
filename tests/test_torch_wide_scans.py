"""Statements past one scan launch, held to the JAX package on the CPU.

The reference's device tier traces any expression into one XLA program;
the port's scan kernels take at most 16 columns, 8 predicates, 16
aggregates and 192 ops a launch and an 8-entry stack, and split a
statement past that across launches (exec/device_split.py: derived tiles
and mask passes by `scan_eval`, several `agg_scan` / `join_probe`
launches). Each statement below goes past one of those caps, in each tier
(aggregate, fused join, fused top-N). It runs in a reference `Database`
with serene_device='tpu' on JAX-CPU and in the port's
`Database(device="cpu")` with 'gpu', which runs the plain versions of the
kernels. Wherever the reference offloaded (its DEVICE_OFFLOADS rose), the
port must have run its scan kernels' plain versions and declined nothing
to the host. Rows must equal the reference's device rows and the port's
host rows: integers exactly, floats within rel/abs 1e-4 (the device adds
in f32). Where both hosts refuse a statement (int8 arithmetic that wraps
on the device overflows on the host), both must refuse it.
"""

import math

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from serenedb_tpu.columnar.column import Batch as RBatch
from serenedb_tpu.columnar.column import Column as RColumn
from serenedb_tpu.engine import Database as RDatabase
from serenedb_tpu.exec.tables import MemTable as RMemTable
from serenedb_tpu.utils import metrics as rmetrics
from serenedb_tpu_torch.carry import memtable_from_reference
from serenedb_tpu_torch.device import LAUNCHES
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.exec import device_split
from serenedb_tpu_torch.obs import device as pobs
from serenedb_tpu_torch.ops import agg_kernels as K
from serenedb_tpu_torch.parallel import virtual_devices

from test_torch_sql import (HITS_QUERIES, Q1_QUERIES, QUERIES, TABLES,
                            _fields)

REL, ABS = 1e-4, 1e-4
SCAN_KERNELS = ("agg_scan", "join_probe", "topn_scan")


def _wide(n, seed):
    """24 INT columns in [-50, 50) (every third with ~10% NULLs), 4
    TINYINT, 3 DOUBLE in [0, 100) with NULLs, 10 BOOLEAN, a group key k,
    a unique id and a join key jk."""
    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(24):
        v = rng.integers(-50, 50, n).astype(np.int32)
        cols[f"c{i}"] = RColumn(RColumn.from_numpy(v).type, v,
                                rng.random(n) > 0.1 if i % 3 == 2 else None)
    for i in range(4):
        cols[f"t{i}"] = RColumn.from_numpy(
            rng.integers(-100, 100, n).astype(np.int8))
    for i in range(3):
        d = rng.random(n) * 100
        cols[f"d{i}"] = RColumn(RColumn.from_numpy(d).type, d,
                                rng.random(n) > 0.1)
    for i in range(10):
        cols[f"b{i}"] = RColumn.from_numpy(rng.random(n) > 0.5)
    cols["k"] = RColumn.from_numpy(rng.integers(0, 10, n).astype(np.int32))
    cols["id"] = RColumn.from_numpy(rng.permutation(n).astype(np.int32))
    cols["jk"] = RColumn.from_numpy(rng.integers(0, 500, n).astype(np.int32))
    return cols


def _hits(n=10_000):
    """ClickBench's ResolutionWidth (SMALLINT) with a region key."""
    rng = np.random.default_rng(3)
    return {"ResolutionWidth": RColumn.from_numpy(
                rng.integers(0, 4000, n).astype(np.int16)),
            "RegionID": RColumn.from_numpy(
                (rng.zipf(1.5, n) % 9000).astype(np.int32))}


def _small(n=2000, seed=9):
    """The property test's table: 24 INT columns in [-3, 3], every third
    with ~15% NULLs (no product of 16 leaves leaves int32)."""
    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(24):
        v = rng.integers(-3, 4, n).astype(np.int32)
        cols[f"c{i}"] = RColumn(RColumn.from_numpy(v).type, v,
                                rng.random(n) > 0.15 if i % 3 == 2 else None)
    return cols


def _rnest(terms, op="+"):
    """A right-nested chain: t0 op (t1 op (t2 ...)), one stack entry a
    level."""
    out = terms[-1]
    for t in reversed(terms[:-1]):
        out = f"{t} {op} ({out})"
    return out


def _c(i, table=""):
    return f"{table}c{i % 24}"


CLICKBENCH_30 = "SELECT " + ", ".join(
    ["SUM(ResolutionWidth)"] +
    [f"SUM(ResolutionWidth + {i})" for i in range(1, 90)]) + " FROM hits;"
SUM17 = " + ".join(_c(i) for i in range(17))
SUM24 = " + ".join(_c(i) for i in range(24))
AND17 = " AND ".join(f"c{i} > -45" for i in range(17))

#: (table, statement): every cap in every tier
AGG_CASES = [
    ("hits", CLICKBENCH_30),
    ("hits", "SELECT RegionID % 7 AS r, " + ", ".join(
        f"sum(ResolutionWidth * {i})" for i in range(17)) +
     " FROM hits GROUP BY r ORDER BY r"),
    ("w", "SELECT " + ", ".join(f"sum(c{i})" for i in range(17)) +
     " FROM w"),
    ("w", "SELECT k, " + ", ".join(
        [f"count(c{i})" for i in range(0, 24, 3)] +
        [f"sum(c{i})" for i in range(24)] +
        [f"min(d{i % 3})" for i in range(4)] +
        [f"avg(d{i % 3})" for i in range(4)]) +
     " FROM w GROUP BY k ORDER BY k"),
    ("w", f"SELECT count(*), sum(c0), min(c5) FROM w WHERE {AND17}"),
    ("w", "SELECT count(*), max(c3) FROM w WHERE " +
     " AND ".join(f"c{i} > -48" for i in range(24))),
    ("w", f"SELECT count(*) FROM w WHERE {SUM24} > 0"),
    ("w", f"SELECT sum({SUM17}), count({SUM17}) FROM w"),
    ("w", f"SELECT k, sum({SUM24}), min(c0 * c1 - c2 + c3 * c4 - c5 + "
          "c6 * c7 - c8 + c9 * c10 - c11 + c12 * c13 - c14 + c15 * c16 - "
          "c17) FROM w GROUP BY k ORDER BY k"),
    ("w", "SELECT count(*), sum(c1) FROM w WHERE " + " AND ".join(
        f"(c{i} > -40 OR c{i + 9} IS NULL)" for i in range(9))),
    ("w", "SELECT count(*), sum(c0) FROM w WHERE " + " AND ".join(
        f"c{i % 24} + c{(i + 7) % 24} + c{(i + 13) % 24} > {-110 + i}"
        for i in range(30))),
    ("w", f"SELECT sum({_rnest([_c(i) for i in range(9)])}) FROM w"),
    ("w", f"SELECT k, sum({_rnest([_c(i) for i in range(12)])}), "
          f"max({_rnest([_c(i + 3) for i in range(12)], '-')}) "
          "FROM w GROUP BY k ORDER BY k"),
    ("w", f"SELECT sum({_rnest([_c(i) for i in range(24)])}) FROM w"),
    ("w", f"SELECT count(*) FROM w WHERE "
          f"{_rnest([_c(i) for i in range(9)])} > 0"),
    ("w", f"SELECT count(*), sum(c2) FROM w WHERE "
          f"{_rnest([_c(i) for i in range(12)], '-')} > 0"),
    ("w", f"SELECT count(*) FROM w WHERE "
          f"{_rnest([_c(i) for i in range(24)])} < 10"),
    ("w", "SELECT k, sum(" + _rnest(
        ["d0", "d1", "d2", "d0 * 0.5", "c1 + 60", "d1", "d2 * 2.0",
         "d0", "c2 + 50", "d1", "d2", "1.5"]) +
     "), max(" + _rnest(["d1", "d2", "d0"] * 4, "*") +
     ") FROM w GROUP BY k ORDER BY k"),
    ("w", "SELECT sum(" + _rnest([f"t{i % 4}" for i in range(12)]) +
     "), " + ", ".join(f"sum(t{i % 4} + t{(i + 1) % 4})"
                       for i in range(17)) + " FROM w"),
    ("w", "SELECT count(*) FROM w WHERE NOT (" + _rnest(
        [f"c{i} > {i - 20}" for i in range(6)] +
        [f"c{i} IS NULL" for i in range(8, 14)],
        "OR") + ") OR " + _rnest([f"c{i} < 0" for i in range(12)], "AND")),
    ("w", "SELECT " + ", ".join(f"b{i}" for i in range(10)) +
     ", count(*), sum(c0) FROM w GROUP BY " +
     ", ".join(f"b{i}" for i in range(10)) +
     " ORDER BY count(*) DESC, sum(c0) LIMIT 5"),
]
JOIN = "FROM w JOIN wb ON w.jk = wb.jk"
JOIN_CASES = [
    ("w", "SELECT count(*), sum(" + " + ".join(
        _c(i, "w.") for i in range(17)) + f") {JOIN}"),
    ("w", "SELECT w.k, count(*), sum(wb.c1) " + JOIN + " WHERE " +
     " AND ".join(f"w.c{i} > -45" for i in range(17)) +
     " GROUP BY w.k ORDER BY w.k"),
    ("w", "SELECT " + ", ".join(f"sum(w.c{i})" for i in range(17)) +
     f", sum(wb.c3), min(wb.c4), max(w.c20) {JOIN}"),
    ("w", "SELECT w.k, " + ", ".join(f"sum(wb.c{i})" for i in range(20)) +
     f" {JOIN} GROUP BY w.k ORDER BY w.k"),
    ("w", "SELECT w.k, count(*), count(wb.c0), sum(w.c1) FROM w LEFT JOIN "
          "wb ON w.jk = wb.jk WHERE " +
     _rnest([_c(i, "w.") for i in range(12)]) + " > 0 "
     "GROUP BY w.k ORDER BY w.k"),
    ("w", "SELECT w.k, count(*), " + ", ".join(
        f"min(w.c{i})" for i in range(17)) + " FROM w LEFT JOIN wb ON "
     "w.jk = wb.jk GROUP BY w.k ORDER BY w.k"),
    ("w", "SELECT w.k, count(*), sum(wb.c0) FROM w RIGHT JOIN wb ON "
     "w.jk = wb.jk WHERE " + " AND ".join(f"wb.c{i} > -45"
                                         for i in range(17)) +
     " GROUP BY w.k ORDER BY w.k"),
    ("w", "SELECT w.k, count(*), " + ", ".join(
        f"sum(wb.c{i})" for i in range(18)) + " FROM w FULL JOIN wb ON "
     "w.jk = wb.jk GROUP BY w.k ORDER BY w.k"),
    ("w", "SELECT w.k, count(*), max(" +
     _rnest([_c(i, "wb.") for i in range(12)]) + "), sum(" + " + ".join(
         _c(i, "wb.") for i in range(20)) + ") FROM w RIGHT JOIN wb ON "
     "w.jk = wb.jk GROUP BY w.k ORDER BY w.k"),
    ("w", "SELECT " + ", ".join(f"w.b{i}" for i in range(9)) +
     f", count(*), sum(wb.c0) {JOIN} GROUP BY " +
     ", ".join(f"w.b{i}" for i in range(9)) +
     " ORDER BY count(*) DESC, sum(wb.c0) LIMIT 5"),
]
TOPN_CASES = [
    ("w", "SELECT id, c0 FROM w WHERE " +
     _rnest([_c(i) for i in range(12)]) + " > 0 ORDER BY id LIMIT 10"),
    ("w", f"SELECT id, c1 FROM w WHERE {AND17} ORDER BY id DESC LIMIT 7"),
    ("w", "SELECT id FROM w WHERE " + " AND ".join(
        f"c{i % 24} + c{(i + 5) % 24} + c{(i + 11) % 24} > -100"
        for i in range(30)) + " ORDER BY id LIMIT 20"),
]
CASES = AGG_CASES + JOIN_CASES + TOPN_CASES


@pytest.fixture(scope="module")
def dbs():
    """One reference and one port connection over the tables w, wb,
    hits and the property test's s."""
    tables = {"w": _wide(4000, 1), "wb": _wide(1000, 2), "hits": _hits(),
              "s": _small()}
    rdb, pdb = RDatabase(), Database(device="cpu")
    for name, cols in tables.items():
        rdb.schemas["main"].tables[name] = RMemTable(
            name, RBatch.from_pydict(cols))
        pdb.schemas["main"].tables[name] = memtable_from_reference(
            name, _fields(cols))
    conns = rdb.connect(), pdb.connect()
    for c in conns:
        c.execute("SET serene_result_cache = off")
        c.execute("SET serene_device_fused = on")
    return conns


def _rows(conn, q, device):
    conn.execute(f"SET serene_device = '{device}'")
    return conn.execute(q).rows()


def _host(conn, q):
    """The host path's rows, or the name of the error it raises."""
    try:
        return _rows(conn, q, "cpu")
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__


def _same(a, b):
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return b == pytest.approx(a, rel=REL, abs=ABS)
    return a == b


def _same_rows(want, got, q):
    assert len(got) == len(want), q
    for rw, rg in zip(want, got):
        assert len(rw) == len(rg), q
        assert all(_same(a, b) for a, b in zip(rw, rg)), (q, rw, rg)


def _run_both(dbs, q):
    """(reference device rows, whether the reference offloaded, port
    device rows, the port's launches)."""
    rconn, pconn = dbs
    off0 = rmetrics.DEVICE_OFFLOADS.value
    ref = _rows(rconn, q, "tpu")
    offloaded = rmetrics.DEVICE_OFFLOADS.value > off0
    declines = pobs.fused_declines()
    LAUNCHES.reset()
    got = _rows(pconn, q, "gpu")
    launches = LAUNCHES.snapshot()
    assert pobs.fused_declines() == declines, q
    return ref, offloaded, got, launches


@pytest.mark.parametrize("table,q", CASES)
def test_wide_statement_runs_on_the_device_tier(dbs, table, q):
    ref, offloaded, got, launches = _run_both(dbs, q)
    assert offloaded, f"the reference kept this statement on the host: {q}"
    assert any(launches.get(f"{k}.plain") for k in SCAN_KERNELS), \
        (q, launches)
    assert not any(n for k, n in launches.items()
                   if not k.endswith(".plain")), launches
    _same_rows(ref, got, q)
    host, ref_host = _host(dbs[1], q), _host(dbs[0], q)
    if isinstance(ref_host, str):
        assert host == ref_host, (q, host, ref_host)
    else:
        _same_rows(got, host, q)
        _same_rows(ref_host, host, q)


def test_clickbench_line_30_is_six_agg_scan_launches(dbs):
    """90 aggregates in launches of 16: six `agg_scan` a chunk, no
    derived tile and no mask pass."""
    _ref, _off, _got, launches = _run_both(dbs, CLICKBENCH_30)
    assert launches == {"agg_scan.plain": 6}


@pytest.mark.parametrize("q,want", [
    # 24 columns in one predicate: one derived tile of 16, then the scan
    (f"SELECT count(*) FROM w WHERE {SUM24} > 0",
     {"scan_eval.plain": 1, "agg_scan.plain": 1}),
    # 17 conjuncts over 17 columns: the scan keeps the 8 predicates a
    # launch holds, two mask passes take the other 9
    (f"SELECT count(*), sum(c0), min(c5) FROM w WHERE {AND17}",
     {"scan_eval.plain": 2, "agg_scan.plain": 1}),
    # 24 deep: cut at depth 8, three times
    (f"SELECT sum({_rnest([_c(i) for i in range(24)])}) FROM w",
     {"scan_eval.plain": 3, "agg_scan.plain": 1}),
])
def test_split_launch_counts(dbs, q, want):
    _ref, _off, _got, launches = _run_both(dbs, q)
    assert launches == want


@pytest.mark.parametrize("key,q", [(k, q) for k, qs in (
    ("h", QUERIES), ("q1", Q1_QUERIES), ("hits", HITS_QUERIES)) for q in qs])
def test_one_launch_statements_launch_as_before(key, q, one_launch_dbs):
    """The statements of test_device_agg's QUERIES and of bench.py's q1
    and hits lists fit one launch: exactly one `agg_scan` (and one
    `agg_fold` for an f32 sum), as before the split existed, and no
    `scan_eval`."""
    conn = one_launch_dbs[key]
    LAUNCHES.reset()
    _rows(conn, q, "gpu")
    want = {"agg_scan.plain": 1}
    if "avg(f)" in q:
        want["agg_fold.plain"] = 1
    assert LAUNCHES.snapshot() == want, q


@pytest.fixture(scope="module")
def one_launch_dbs():
    out = {}
    for key in ("h", "q1", "hits"):
        name = "hits" if key == "q1" else key
        pdb = Database(device="cpu")
        pdb.schemas["main"].tables[name] = memtable_from_reference(
            name, _fields(TABLES[key]()))
        out[key] = pdb.connect()
        out[key].execute("SET serene_result_cache = off")
    return out


def test_split_runs_per_chunk_and_per_mesh_shard(dbs):
    """Small chunks: the derived tiles and the launches repeat a chunk;
    serene_mesh = 2 over a virtual mesh: a shard. The rows stay those of
    the reference."""
    rconn, pconn = dbs
    q = "SELECT k, sum(" + _rnest([_c(i) for i in range(12)]) + "), " + \
        ", ".join(f"sum(c{i})" for i in range(17)) + \
        " FROM w GROUP BY k ORDER BY k"
    ref = _rows(rconn, q, "tpu")
    pconn.execute("SET serene_device_chunk_rows = 1000")
    try:
        LAUNCHES.reset()
        _same_rows(ref, _rows(pconn, q, "gpu"), q)
        chunks = -(-4000 // 896)
        assert LAUNCHES.snapshot() == {"scan_eval.plain": chunks,
                                       "agg_scan.plain": 2 * chunks}
    finally:
        pconn.execute("RESET serene_device_chunk_rows")
    pconn.execute("SET serene_mesh = 2")
    try:
        with virtual_devices(8):
            LAUNCHES.reset()
            _same_rows(ref, _rows(pconn, q, "gpu"), q)
            assert LAUNCHES.get("scan_eval.plain") == 2
            assert LAUNCHES.get("agg_scan.plain") == 4
            assert LAUNCHES.get("mesh_combine.plain") >= 1
    finally:
        pconn.execute("SET serene_mesh = 0")


@pytest.mark.parametrize("combine", ["host", "device"])
def test_split_join_under_shards(dbs, combine):
    """serene_shards = 4: the probe side's split runs per shard (host
    combine) or over the collective's spans (device combine)."""
    rconn, pconn = dbs
    q = "SELECT w.k, count(*), " + ", ".join(
        f"sum(w.c{i})" for i in range(18)) + f" {JOIN} WHERE " + \
        _rnest([_c(i, "w.") for i in range(10)]) + \
        " > -100 GROUP BY w.k ORDER BY w.k"
    ref = _rows(rconn, q, "tpu")
    for s in ("SET serene_shards = 4", "SET serene_morsel_rows = 1024",
              f"SET serene_shard_combine = {combine}"):
        pconn.execute(s)
    try:
        LAUNCHES.reset()
        got = _rows(pconn, q, "gpu")
        assert LAUNCHES.get("join_probe.plain") >= 2
        assert LAUNCHES.get("scan_eval.plain") >= 1
        _same_rows(ref, got, q)
    finally:
        for s in ("RESET serene_shards", "RESET serene_morsel_rows",
                  "RESET serene_shard_combine"):
            pconn.execute(s)


def test_plans_keep_every_launch_inside_the_caps():
    """A plan's launches each fit the descriptor; its derived tiles
    number after the base slots."""
    # c0 + (c1 + (c2 + ...)): 30 entries deep
    deep = tuple((K.OP_COL, i % 20, 0) for i in range(30)) + \
        ((K.OP_ADD_I, 0, 0),) * 29
    spec = K.ScanSpec([K.COL_I32] * 20, [0] * 20,
                      [deep + ((K.OP_I32, 0, 0), (K.OP_CMP_I, 0, 4))], [],
                      False, 1, [K.ScanAgg(K.AGG_SUM_I, ((K.OP_COL, i, 0),))
                                 for i in range(20)])
    plan = device_split.plan_scan(spec)
    assert isinstance(plan, device_split.Split)
    for slots, ev in plan.derived + plan.masks:
        assert len(slots) <= K.MAX_COLS
        progs = [ev.prog] if ev.prog is not None else ev.preds
        assert all(device_split.stack_depth(p) <= K.MAX_STACK
                   for p in progs)
    for ln in plan.launches:
        assert len(ln.slots) <= K.MAX_COLS
        assert len(ln.spec.aggs) <= K.MAX_AGGS
        assert all(device_split.stack_depth(p) <= K.MAX_STACK
                   for p in ln.spec.preds + [a.ops for a in ln.spec.aggs])
    assert sorted(p for ln in plan.launches for p in ln.positions) == \
        list(range(20))
    assert device_split.plan_scan(K.ScanSpec(
        [K.COL_I32], [0], [], [], False, 1,
        [K.ScanAgg(K.AGG_SUM_I, ((K.OP_COL, 0, 0),))])).__class__ is \
        K.ScanSpec


# -- random expression trees: the device split against the host -------------

_COLS = [f"c{i}" for i in range(24)]
_LEAF = st.one_of(st.sampled_from(_COLS), st.integers(-3, 3).map(str))


@st.composite
def _int_tree(draw, max_leaves=16):
    """A tree of up to max_leaves leaves over a stack up to max_leaves
    deep: one leaf joined a level by + - or *, on the right of what is
    built (one stack entry deeper) or on its left (as deep). A product
    takes a leaf, so |value| <= 3^leaves: no int32 wrap."""
    depth = draw(st.sampled_from(range(1, max_leaves + 1)))
    sides = draw(st.permutations(
        ["r"] * (depth - 1) +
        ["l"] * draw(st.integers(0, max_leaves - depth))))
    out = draw(_LEAF)
    for side in sides:
        leaf, op = draw(_LEAF), draw(st.sampled_from("+-*"))
        out = f"({leaf} {op} {out})" if side == "r" else \
            f"({out} {op} {leaf})"
    return out


@st.composite
def _bool_tree(draw):
    """Comparisons of trees and IS NULL, joined by AND / OR on either
    side and NOT."""
    def atom():
        if draw(st.booleans()):
            return f"({draw(_int_tree(8))}) IS NULL"
        op = draw(st.sampled_from(["<", ">", "=", "<>", ">="]))
        return f"{draw(_int_tree(8))} {op} {draw(_int_tree(8))}"
    out = atom()
    for _ in range(draw(st.sampled_from(range(6)))):
        form = draw(st.sampled_from(["and", "or", "rand", "ror", "not"]))
        if form == "not":
            out = f"NOT ({out})"
        elif form.startswith("r"):
            out = f"({atom()} {form[1:].upper()} {out})"
        else:
            out = f"({out} {form.upper()} {atom()})"
    return out


@settings(max_examples=40, derandomize=True, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(arg=_int_tree(), pred=_bool_tree())
def test_random_trees_match_the_host(dbs, arg, pred):
    """Random trees (up to 16 leaves in an aggregate argument, so a stack
    up to 16 deep, over 24 columns, + - *, comparisons, AND OR NOT IS
    NULL): the port's device rows equal its host rows."""
    _rconn, pconn = dbs
    q = f"SELECT count(*), sum({arg}), min({arg}) FROM s WHERE {pred}"
    LAUNCHES.reset()
    got = _rows(pconn, q, "gpu")
    assert LAUNCHES.get("agg_scan.plain") >= 1, q
    assert got == _rows(pconn, q, "cpu"), q
