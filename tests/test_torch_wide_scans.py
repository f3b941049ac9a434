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
    # launch holds, the mask passes of one prepare take the other 9
    (f"SELECT count(*), sum(c0), min(c5) FROM w WHERE {AND17}",
     {"scan_eval.plain": 1, "agg_scan.plain": 1}),
    # 24 deep: cut at depth 8, three times, all three in one prepare
    (f"SELECT sum({_rnest([_c(i) for i in range(24)])}) FROM w",
     {"scan_eval.plain": 1, "agg_scan.plain": 1}),
])
def test_split_launch_counts(dbs, q, want):
    _ref, _off, _got, launches = _run_both(dbs, q)
    assert launches == want


@pytest.fixture(scope="module")
def wide140():
    """A reference and a port connection over x: 140 INT columns in
    [-50, 50) (every tenth with ~2% NULLs) and a group key k."""
    rng = np.random.default_rng(140)
    n, cols = 1500, {}
    for i in range(140):
        v = rng.integers(-50, 50, n).astype(np.int32)
        cols[f"x{i}"] = RColumn(RColumn.from_numpy(v).type, v,
                                rng.random(n) > 0.02 if i % 10 == 3 else None)
    cols["k"] = RColumn.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    rdb, pdb = RDatabase(), Database(device="cpu")
    rdb.schemas["main"].tables["x"] = RMemTable("x", RBatch.from_pydict(cols))
    pdb.schemas["main"].tables["x"] = memtable_from_reference(
        "x", _fields(cols))
    conns = rdb.connect(), pdb.connect()
    for c in conns:
        c.execute("SET serene_result_cache = off")
        c.execute("SET serene_device_fused = on")
    return conns


AND140 = " AND ".join(f"x{i} >= -49" for i in range(140))


@pytest.mark.parametrize("q", [
    f"SELECT count(*), sum(x0), min(x139) FROM x WHERE {AND140}",
    f"SELECT k, count(*), sum(x7 + x8) FROM x WHERE {AND140} "
    "GROUP BY k ORDER BY k",
])
def test_a_prepare_past_128_columns_chains_launches(wide140, q):
    """A WHERE over 140 columns: the scan keeps 8 conjuncts, the mask
    passes read the other 132 columns, more than one scan_eval launch
    takes, so the prepare is two launches in plan order (the second
    narrows the first's row mask); nothing declines and the rows are
    the reference's and the host path's."""
    ref, offloaded, got, launches = _run_both(wide140, q)
    assert offloaded, q
    assert launches == {"scan_eval.plain": 2, "agg_scan.plain": 1}
    _same_rows(ref, got, q)
    _same_rows(got, _host(wide140[1], q), q)


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


# -- the prepare: one scan_eval launch a chunk --------------------------------

def _col(s):
    return (K.OP_COL, s, 0)


def _chain(slots, op):
    """s0 op (s1 op (s2 ...)): one stack entry a slot."""
    return tuple(_col(s) for s in slots) + ((op, 0, 0),) * (len(slots) - 1)


#: base slot kinds of the prepare tests: 20 int32, 4 f32, a FOR8, a FOR16
#: and an int8 column
_KINDS = [K.COL_I32] * 20 + [K.COL_F32] * 4 + [K.COL_U8, K.COL_U16,
                                                K.COL_I8]
_OFFS = [0] * 24 + [-7, -30000, 0]


def _prep_specs():
    """Statements past one launch, planned: a sum 24 deep (three derived
    tiles in a chain, two read only by the next), a WHERE 12 deep under
    17 sums (its cut subtree read only by a mask pass), 17 conjuncts (a
    mask pass only), an f32 sum 12 deep with an int8 and a boolean cut,
    and a wrapped key past 8 keys (a derived code)."""
    ints = list(range(20))
    sums = [K.ScanAgg(K.AGG_SUM_I, (_col(i),)) for i in range(17)]
    f12 = _chain([20, 21, 22, 23] * 3, K.OP_ADD_F)
    i8 = (_col(0),) + _chain([26] * 8, K.OP_ADD_I) + \
        ((K.OP_WRAP8, 0, 0), (K.OP_ADD_I, 0, 0))
    cmp8 = _chain(ints[:8], K.OP_ADD_I) + ((K.OP_I32, 0, 5),
                                          (K.OP_CMP_I, 0, 2))
    boolean = ((K.OP_COL, 24, 0), (K.OP_I32, 0, 0), (K.OP_CMP_I, 0, 4)) + \
        cmp8[:-2] + ((K.OP_I32, 0, 5), (K.OP_CMP_I, 0, 2),
                     (K.OP_AND, 0, 0))
    specs = [
        K.ScanSpec(_KINDS, _OFFS, [], [], False, 1,
                   [K.ScanAgg(K.AGG_SUM_I, _chain(ints + ints[:4],
                                                  K.OP_ADD_I))]),
        K.ScanSpec(_KINDS, _OFFS, [_chain([0, 1, 2, 25] * 3, K.OP_ADD_I) +
                                   ((K.OP_I32, 0, 40), (K.OP_CMP_I, 0, 4))],
                   [], False, 1, sums),
        K.ScanSpec(_KINDS, _OFFS, [(_col(i), (K.OP_I32, 0, -45),
                                    (K.OP_CMP_I, 0, 4)) for i in range(17)],
                   [], False, 1, sums[:2]),
        K.ScanSpec(_KINDS, _OFFS, [boolean], [], False, 1,
                   [K.ScanAgg(K.AGG_SUM_F, f12),
                    K.ScanAgg(K.AGG_MIN_I, i8)]),
        K.ScanSpec(_KINDS, _OFFS, [], [(K.KEY_INT, i, -1, 2)
                                      for i in range(9)], False, 2**9,
                   sums[:3]),
    ]
    return [device_split.plan_scan(s) for s in specs]


def _prep_tiles(n, seed):
    """One chunk's (data, mask) tiles of _KINDS, (n // 128, 128), with
    NULLs, NaN, +-0.0 and +-inf, and its row mask."""
    import torch
    rng = np.random.default_rng(seed)
    cols = []
    for kind in _KINDS:
        if kind == K.COL_F32:
            v = (rng.normal(size=n) * 50).astype(np.float32)
            v[rng.random(n) < 0.02] = np.nan
            v[:4] = [-0.0, 0.0, np.inf, -np.inf]
        elif kind == K.COL_U8:
            v = rng.integers(0, 256, n).astype(np.uint8)
        elif kind == K.COL_U16:
            v = rng.integers(-2**15, 2**15, n).astype(np.int16)
        elif kind == K.COL_I8:
            v = rng.integers(-128, 128, n).astype(np.int8)
        else:
            v = rng.integers(-50, 50, n).astype(np.int32)
        cols.append((torch.from_numpy(v).view(-1, 128),
                     torch.from_numpy(rng.random(n) > 0.1).view(-1, 128)))
    rm = torch.from_numpy(rng.random(n) > 0.05).view(-1, 128)
    return cols, rm


def _one_pass_at_a_time(ev, cols, rowmask):
    """The passes as separate whole-column steps: each derived value
    stored in its tile's type (0 where invalid) and decoded back as the
    next pass's input, each predicate ANDed into the row mask."""
    import torch
    env = [(K.decode_plain(k, o, d.reshape(-1)), m.reshape(-1))
           for (d, m), k, o in zip(cols, ev.col_kinds, ev.col_offsets)]
    n, tiles = rowmask.numel(), []
    for d in ev.derived:
        v, ok = K.eval_plain(d.prog, env, n)
        bits = v.view(torch.int32) if v.dtype == torch.float32 else \
            v.to(torch.int32)
        bits = torch.where(ok, bits, torch.zeros_like(bits))
        t = bits.view(torch.float32) if d.out == K.COL_F32 else \
            (((bits + 128) & 0xFF) - 128).to(torch.int8) \
            if d.out == K.COL_I8 else bits
        env.append((K.decode_plain(d.out, 0, t), ok))
        tiles.append((t, ok) if d.stored else None)
    m = rowmask.reshape(-1).clone()
    for p in ev.preds:
        v, ok = K.eval_plain(p, env, n)
        m &= (v != 0) & ok
    return tiles, m


def _same_tiles(got, want):
    import torch
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            for a, b in zip(g, w):
                a = a.reshape(-1)
                assert a.dtype == b.dtype
                assert torch.equal(a.view(torch.int32)
                                   if a.dtype == torch.float32 else a,
                                   b.view(torch.int32)
                                   if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("which", range(5))
def test_fused_prepare_equals_its_passes_one_at_a_time(which):
    """The plain version of a fused prepare gives, bit for bit, the tiles
    and row mask of its passes run one at a time (each derived tile the
    next pass's input), and counts one call."""
    from serenedb_tpu_torch.ops import scan_kernels as S
    split = _prep_specs()[which]
    assert isinstance(split, device_split.Split) and len(split.prep) == 1
    (slots, ev), = split.prep
    cols, rm = _prep_tiles(128 * 21, which)
    ins = [(cols[s][0][3:19], cols[s][1][3:19]) for s in slots]
    LAUNCHES.reset()
    tiles, mask = S.scan_eval_plain(ev, ins, rm[3:19])
    assert LAUNCHES.snapshot() == {"scan_eval.plain": 1}
    want, wmask = _one_pass_at_a_time(ev, ins, rm[3:19])
    _same_tiles(tiles, want)
    assert mask.shape == rm[3:19].shape
    assert np.array_equal(mask.reshape(-1).numpy(), wmask.numpy())
    stored = {s for ln in split.launches for s in ln.slots}
    n_base = len(split.col_kinds)
    assert [t is not None for t in tiles] == \
        [n_base + k in stored for k in range(len(ev.derived))]


def _words_model(ev, plan, cols, rowmask):
    """What csrc/scan.cu does with the plan's words, whole-column: read
    the header, each pass's program, stage and buffer offsets, and each
    column read's source from its op word (a base input, staged or not, a
    stage or a written tile); run the programs with the plain
    interpreter; write stages, tiles and the mask where the words say."""
    import torch
    w = [x & (2**64 - 1) for x in plan.words.tolist()]
    passes_at, ops_at, n_pass, mask_at, raw_at, n_raw = w[:6]
    mask_at = mask_at - 2**64 if mask_at >= 2**63 else mask_at
    # the staged inputs: disjoint units inside raw_units
    staged, taken = {}, set()
    for rw in w[raw_at: raw_at + n_raw]:
        idx, kind, unit = rw & 0xFFF, (rw >> 12) & 0xF, (rw >> 16) & 0xFFF
        units = set(range(unit, unit + 1 + (1 if kind in (K.COL_I8,
                                                          K.COL_U8)
                                            else 2 if kind == K.COL_U16
                                            else 4)))
        assert not units & taken and max(units) < plan.raw_units
        taken |= units
        staged[idx] = (kind, unit)
    n = rowmask.numel()
    n_pad = -(-n // 16) * 16
    buf = torch.zeros(plan.row_bytes * n_pad, dtype=torch.uint8)
    stages = [None] * 16
    dtypes = {K.COL_I32: torch.int32, K.COL_I8: torch.int8,
              K.COL_F32: torch.float32}

    def signed(x, bits):
        return x - 2**bits if x >= 2**(bits - 1) else x

    def column(ow):
        src, kind, ref = (ow >> 8) & 0x3, (ow >> 10) & 0x7, \
            (ow >> 16) & 0xFFFF
        off = signed(ow >> 32, 32)
        if src == 0:
            idx, unit = ref & 0xFF, ref >> 8
            assert staged.get(idx, (kind, 0xFF)) == (kind, unit)
            d, m = cols[idx]
            return K.decode_plain(kind, off, d.reshape(-1)), m.reshape(-1)
        if src == 1:
            return stages[ref]
        _h, _p, at, v = (signed(x, 64) for x in
                         w[passes_at + 4 * ref: passes_at + 4 * ref + 4])
        assert at >= 0
        width = 1 if kind == K.COL_I8 else 4
        return (K.decode_plain(kind, 0, buf[at * n_pad: at * n_pad +
                                            width * n].view(dtypes[kind])),
                buf[v * n_pad: v * n_pad + n].view(torch.bool))
    m = rowmask.reshape(-1).clone()
    for p in range(n_pass):
        head, sc, at, v = (signed(x, 64) for x in
                           w[passes_at + 4 * p: passes_at + 4 * p + 4])
        start, count = sc & 0xFFFFFFFF, sc >> 32
        prog, env, depth = [], [], 0
        for ow in w[ops_at + start: ops_at + start + count]:
            op = ow & 0xFF
            if op >= 0x40:                # a binary op fused with its leaf
                if op >= 0x60:
                    prog.append((K.OP_I32, 0, signed(ow >> 32, 32)))
                else:
                    prog.append((K.OP_COL, len(env), 0))
                    env.append(column(ow))
                prog.append((op & 0x1F, (ow >> 13) & 0x7, 0))
                continue
            if op == K.OP_COL:            # each read its own env slot
                prog.append((K.OP_COL, len(env), 0))
                env.append(column(ow))
            else:
                prog.append((op, (ow >> 8) & 0xFFFFFF, signed(ow >> 32, 32)))
            depth += 1 if op <= K.OP_NULL else -1 if op in (
                K.OP_AND, K.OP_OR, K.OP_CMP_I, K.OP_CMP_F, K.OP_ADD_I,
                K.OP_SUB_I, K.OP_MUL_I, K.OP_ADD_F, K.OP_SUB_F, K.OP_MUL_F,
                K.OP_GATE) else 0
            assert depth - 1 <= plan.stack
        if not env:
            env = [(torch.zeros(n, dtype=torch.int32),
                    torch.zeros(n, dtype=torch.bool))]
        val, ok = K.eval_plain(tuple(prog), env, n)
        if head & 0xFF == 0:
            m &= (val != 0) & ok
            continue
        kind, stage = (head >> 8) & 0xFF, ((head >> 16) & 0xFFFF) - 1
        bits = val.view(torch.int32) if val.dtype == torch.float32 else \
            val.to(torch.int32)
        bits = torch.where(ok, bits, torch.zeros_like(bits))
        t = bits.view(torch.float32) if kind == K.COL_F32 else \
            (((bits + 128) & 0xFF) - 128).to(torch.int8) \
            if kind == K.COL_I8 else bits
        if stage >= 0:
            stages[stage] = (K.decode_plain(kind, 0, t), ok)
        if at >= 0:
            width = 1 if kind == K.COL_I8 else 4
            buf[at * n_pad: at * n_pad + width * n] = t.view(torch.uint8)
            buf[v * n_pad: v * n_pad + n] = ok.view(torch.uint8)
    if mask_at >= 0:
        buf[mask_at * n_pad: mask_at * n_pad + n] = m.view(torch.uint8)
    return plan.carve(buf, n, n_pad, rowmask.shape)


def _overflow_spec():
    """20 derived values (int32, int8 and f32 tiles) that the mask passes
    all read: past the 16 stages, so four are written and read back; one
    of them stored for a scan launch too."""
    from serenedb_tpu_torch.ops import scan_kernels as S
    der = []
    for k in range(20):
        if k % 3 == 2:
            der.append(S.Derive((_col(20 + k % 4), _col(k),
                                 (K.OP_I2F, 0, 0), (K.OP_MUL_F, 0, 0)),
                                K.COL_F32, k == 2))
        else:
            der.append(S.Derive((_col(k), _col(26), (K.OP_MUL_I, 0, 0)) +
                                (((K.OP_WRAP8, 0, 0),) if k % 3 else ()),
                                K.COL_I8 if k % 3 else K.COL_I32, k == 4))
    preds = [(_col(27 + k), (K.OP_I32 if k % 3 != 2 else K.OP_F32, 0,
                             K.f32_bits(-3.0) if k % 3 == 2 else -3000),
              (K.OP_CMP_F if k % 3 == 2 else K.OP_CMP_I, 0, 5))
             for k in range(20)]
    return S.EvalSpec(list(_KINDS), list(_OFFS), der, preds)


@pytest.mark.parametrize("which", range(6))
def test_the_plans_words_say_what_the_plain_version_does(which):
    """The kernel's plan: its words, read as csrc/scan.cu reads them (the
    slots' sources, stages reused after their last reader, the buffer's
    sections), give the plain version's tiles and mask bit for bit."""
    from serenedb_tpu_torch.ops import scan_kernels as S
    if which < 5:
        (slots, ev), = _prep_specs()[which].prep
    else:
        slots, ev = list(range(len(_KINDS))), _overflow_spec()
    plan = S._Plan(ev)
    if which == 5:
        assert plan.n_stages == S.MAX_STAGES
        assert len(plan.tiles) == 4 + 2
    cols, rm = _prep_tiles(128 * 5, 10 + which)
    ins = [cols[s] for s in slots]
    got = _words_model(ev, plan, ins, rm)
    tiles, mask = S.scan_eval_plain(ev, ins, rm)
    _same_tiles(got[0], [None if t is None else
                         (t[0].reshape(-1), t[1].reshape(-1)) for t in tiles])
    if ev.preds:
        assert np.array_equal(got[1].numpy(), mask.numpy())
    else:
        assert got[1] is None and mask is rm


def _random_program(rng, want_bool: bool, size: int):
    """A random program over slots 0-5 (int32): int + - * (wrapping) and
    constants, compares, AND / OR / NOT, IS NULL and NVL."""
    if size <= 1:
        if want_bool:
            return ((K.OP_COL, int(rng.integers(6)), 0), (K.OP_IS_NULL, 0, 0))
        if rng.random() < 0.7:
            return ((K.OP_COL, int(rng.integers(6)), 0),)
        return ((K.OP_I32, 0, int(rng.choice([0, 1, -7, 2**31 - 1,
                                               -2**31]))),)
    left = int(rng.integers(1, size))
    if want_bool:
        form = rng.choice(["and", "or", "cmp", "not"])
        if form == "not":
            return _random_program(rng, True, size - 1) + ((K.OP_NOT, 0, 0),)
        if form == "cmp":
            return _random_program(rng, False, left) + _random_program(
                rng, False, size - left) + ((K.OP_CMP_I, int(rng.integers(6)),
                                            0),)
        op = K.OP_AND if form == "and" else K.OP_OR
        return _random_program(rng, True, left) + _random_program(
            rng, True, size - left) + ((op, 0, 0),)
    if rng.random() < 0.1:
        return _random_program(rng, False, size - 1) + (
            (K.OP_NVL, 0, int(rng.integers(-5, 5))),)
    op = rng.choice([K.OP_ADD_I, K.OP_ADD_I, K.OP_MUL_I, K.OP_SUB_I])
    return _random_program(rng, False, left) + _random_program(
        rng, False, size - left) + ((int(op), 0, 0),)


@pytest.mark.parametrize("seed", range(6))
def test_kernel_programs_keep_every_valid_result(seed):
    """The kernel's form of a program (ops/scan_kernels `_kernel_ops`:
    integer + and * chains and AND / OR regrouped left-deep, a binary op
    fused with a column or constant right operand) gives every valid row
    the plain program's bits, and never needs a deeper stack."""
    import torch
    from serenedb_tpu_torch.ops import scan_kernels as S
    rng = np.random.default_rng(seed)
    n = 4000
    env = []
    for _ in range(6):
        v = rng.integers(-2**31, 2**31, n).astype(np.int64)
        v[rng.random(n) < 0.5] = rng.integers(-3, 4)
        env.append((torch.from_numpy(v.astype(np.int32)),
                    torch.from_numpy(rng.random(n) > 0.2)))
    checked = 0
    while checked < 40:
        prog = _random_program(rng, bool(rng.random() < 0.5),
                               int(rng.integers(2, 14)))
        if device_split.stack_depth(prog) > K.MAX_STACK:
            continue
        kernel, depth, top = [], 0, 0
        for item in S._kernel_ops(prog):
            if item[0] == "fuse":
                kernel.append(item[2][:3])
            else:
                op = item[1][0]
                depth += 1 if op in S._NULLARY else \
                    -1 if op in S._BINARY else 0
                top = max(top, depth)
            kernel.append(item[1][:3])
        assert sorted(kernel) == sorted(prog)
        assert top <= device_split.stack_depth(prog)
        v, ok = K.eval_plain(prog, env, n)
        kv, kok = K.eval_plain(tuple(kernel), env, n)
        assert torch.equal(ok, kok), prog
        assert torch.equal(v[ok], kv[ok]), prog
        checked += 1


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
    (slots, ev), = plan.prep
    assert len(ev.col_kinds) == len(slots)
    for p in [d.prog for d in ev.derived] + ev.preds:
        assert len({a for op, a, _ in p if op == K.OP_COL}) <= K.MAX_COLS
        assert device_split.stack_depth(p) <= K.MAX_STACK
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
