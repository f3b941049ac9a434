"""The port's SQL analytics slice against the JAX package's, on the CPU.

The same tables, made from numpy seeds, are loaded into a reference
`Database` and — through `carry.memtable_from_reference` — into the port's
`Database(device="cpu")`. Each query of the reference's device-parity
suite (tests/test_device_agg.py) and of bench.py's `q1` and `hits` lists
(at 20,000 rows) runs in both: the reference with serene_device='tpu' on
JAX-CPU, the port with serene_device='gpu', which runs the plain versions
of its kernels. Rows must be equal, floats within rel 1e-4 / abs 1e-4 (the
device sums add in f32 in other orders). Wherever the reference offloaded
a query (its DEVICE_OFFLOADS rose), the port must have run `agg_scan`'s
plain version. The host paths (serene_device='cpu') must agree exactly.
"""

import math

import numpy as np
import pytest
import torch

from serenedb_tpu.columnar.column import Batch as RBatch
from serenedb_tpu.columnar.column import Column as RColumn
from serenedb_tpu.engine import Database as RDatabase
from serenedb_tpu.exec.tables import MemTable as RMemTable
from serenedb_tpu.utils import metrics as rmetrics
from serenedb_tpu_torch.carry import memtable_from_reference
from serenedb_tpu_torch.device import LAUNCHES
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.parallel import virtual_devices

from test_device_agg import QUERIES, WIDE_QUERIES

REL, ABS = 1e-4, 1e-4

Q1_QUERIES = [
    "SELECT count(*) FROM hits WHERE adv <> 0",
    "SELECT count(*), sum(x) FROM hits WHERE adv <> 0 AND x < 90000",
    "SELECT region, count(*), sum(x) FROM hits GROUP BY region",
]
HITS_QUERIES = [
    "SELECT AdvEngineID, count(*) AS c FROM hits WHERE AdvEngineID <> 0 "
    "GROUP BY AdvEngineID ORDER BY c DESC, AdvEngineID",
    "SELECT RegionID, sum(AdvEngineID), count(*) AS c, "
    "avg(ResolutionWidth) FROM hits GROUP BY RegionID "
    "ORDER BY c DESC, RegionID LIMIT 10",
    "SELECT SearchPhrase, count(*) AS c FROM hits "
    "WHERE SearchPhrase <> '' GROUP BY SearchPhrase "
    "ORDER BY c DESC, SearchPhrase LIMIT 10",
    "SELECT SearchEngineID, SearchPhrase, count(*) AS c FROM hits "
    "WHERE SearchPhrase <> '' GROUP BY SearchEngineID, SearchPhrase "
    "ORDER BY c DESC, SearchEngineID, SearchPhrase LIMIT 10",
    "SELECT UserID, count(*) AS c FROM hits GROUP BY UserID "
    "ORDER BY c DESC, UserID LIMIT 10",
    "SELECT UserID, SearchPhrase, count(*) AS c FROM hits "
    "GROUP BY UserID, SearchPhrase ORDER BY c DESC, UserID, "
    "SearchPhrase LIMIT 10",
]
FLOAT_QUERIES = [
    "SELECT k, sum(f), avg(f), min(g), max(g) FROM fl GROUP BY k "
    "ORDER BY k",
    "SELECT sum(f), avg(f), min(g), max(g), count(g) FROM fl",
    "SELECT k, min(g) FROM fl WHERE g <> g OR k = 3 GROUP BY k ORDER BY k",
]


def _h():
    """tests/test_device_agg.py's `h` table."""
    rng = np.random.default_rng(7)
    n = 5000
    ks = rng.integers(0, 50, n)
    gs = rng.choice(["alpha", "beta", "gamma", "delta"], n)
    vs = rng.integers(-1000000, 1000000, n)
    fs = rng.normal(size=n)
    validity = rng.random(n) > 0.1
    return {
        "k": RColumn.from_numpy(ks.astype(np.int32)),
        "g": RColumn.from_numpy(gs),
        "v": RColumn.from_numpy(vs.astype(np.int64)),
        "f": RColumn.from_numpy(fs),
        "nv": RColumn(RColumn.from_numpy(ks.astype(np.int32)).type,
                      ks.astype(np.int32), validity),
    }


def _hits2():
    """tests/test_device_agg.py's `hits2` table."""
    rng = np.random.default_rng(11)
    n = 20000
    uids = rng.integers(0, 1 << 62, n, dtype=np.int64)
    uids = uids[rng.integers(0, n, n)]
    return {
        "uid": RColumn.from_numpy(uids),
        "region": RColumn.from_numpy(
            rng.integers(0, 200, n).astype(np.int32)),
        "w": RColumn.from_numpy(
            rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64)),
        "x": RColumn.from_numpy(rng.integers(0, 1000, n).astype(np.int32)),
    }


def _q1(n=20000):
    """bench.py bench_q1's table, cut to n rows."""
    rng = np.random.default_rng(0)
    return {
        "adv": RColumn.from_numpy(
            rng.choice(np.array([0, 0, 0, 0, 1, 2, 3], dtype=np.int32), n)),
        "region": RColumn.from_numpy(rng.integers(0, 200, n)
                                     .astype(np.int32)),
        "x": RColumn.from_numpy(rng.integers(0, 100000, n).astype(np.int32)),
    }


def _hits(n=20000):
    """bench.py bench_hits's table, cut to n rows."""
    rng = np.random.default_rng(3)
    n_users = 500_000
    user_hashes = rng.integers(0, 1 << 62, n_users, dtype=np.int64)
    uid = user_hashes[rng.zipf(1.4, n).astype(np.int64) % n_users]
    region = (rng.zipf(1.5, n) % 9000).astype(np.int32)
    adv = np.where(rng.random(n) < 0.96, 0,
                   rng.integers(1, 64, n)).astype(np.int32)
    n_phrases = 100_000
    phrase_pool = np.asarray([""] + [f"phrase {i}" for i in range(n_phrases)],
                             dtype=object)
    pid = np.where(rng.random(n) < 0.7, 0,
                   1 + rng.zipf(1.3, n) % n_phrases).astype(np.int64)
    seid = (rng.zipf(1.6, n) % 100).astype(np.int32)
    width = rng.integers(0, 4000, n).astype(np.int32)
    return {
        "UserID": RColumn.from_numpy(uid),
        "RegionID": RColumn.from_numpy(region),
        "AdvEngineID": RColumn.from_numpy(adv),
        "SearchPhrase": RColumn.from_numpy(phrase_pool[pid]),
        "SearchEngineID": RColumn.from_numpy(seid),
        "ResolutionWidth": RColumn.from_numpy(width),
    }


def _fl(n=20000):
    """Float aggregates: an int key of 200 groups, `f` uniform in
    [0, 1000) and `g` normal with NaNs, both with ~5% NULLs."""
    rng = np.random.default_rng(5)
    f = rng.random(n) * 1000
    g = rng.normal(size=n)
    g[rng.random(n) < 0.01] = np.nan
    g[:3] = [-0.0, 0.0, np.nan]
    return {
        "k": RColumn.from_numpy(rng.integers(0, 200, n).astype(np.int32)),
        "f": RColumn(RColumn.from_numpy(f).type, f, rng.random(n) > 0.05),
        "g": RColumn(RColumn.from_numpy(g).type, g, rng.random(n) > 0.05),
    }


TABLES = {"h": _h, "hits2": _hits2, "q1": _q1, "hits": _hits, "fl": _fl}


def _fields(cols):
    return {k: (c.data, c.validity, c.dictionary) for k, c in cols.items()}


@pytest.fixture(scope="module")
def dbs():
    """{table key: (reference connection, port connection)}; each table
    lives in its own pair of databases under its query's table name."""
    out = {}
    for key, make in TABLES.items():
        cols = make()
        name = "hits" if key == "q1" else key
        rdb = RDatabase()
        rdb.schemas["main"].tables[name] = RMemTable(
            name, RBatch.from_pydict(cols))
        pdb = Database(device="cpu")
        pdb.schemas["main"].tables[name] = memtable_from_reference(
            name, _fields(cols))
        conns = (rdb.connect(), pdb.connect())
        for c in conns:
            # every statement executes: launch counts stay meaningful
            c.execute("SET serene_result_cache = off")
        out[key] = conns
    return out


def _rows(conn, q, device):
    conn.execute(f"SET serene_device = '{device}'")
    return conn.execute(q).rows()


def _same(a, b):
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return b == pytest.approx(a, rel=REL, abs=ABS)
    return a == b


CASES = [(key, q) for key, qs in (("h", QUERIES), ("hits2", WIDE_QUERIES),
                                   ("q1", Q1_QUERIES), ("hits", HITS_QUERIES),
                                   ("fl", FLOAT_QUERIES)) for q in qs]


@pytest.mark.parametrize("key,q", CASES)
def test_slice_matches_reference(dbs, key, q):
    rconn, pconn = dbs[key]
    before = rmetrics.DEVICE_OFFLOADS.value
    ref = _rows(rconn, q, "tpu")
    offloaded = rmetrics.DEVICE_OFFLOADS.value > before
    launched = LAUNCHES.get("agg_scan.plain")
    got = _rows(pconn, q, "gpu")
    if offloaded:
        assert LAUNCHES.get("agg_scan.plain") > launched, \
            f"the reference offloaded but the port did not scan: {q}"
    assert LAUNCHES.get("agg_scan") == 0
    assert len(got) == len(ref), q
    for rr, rg in zip(ref, got):
        assert len(rr) == len(rg)
        for a, b in zip(rr, rg):
            assert _same(a, b), (q, rr, rg)
    host, ref_host = _rows(pconn, q, "cpu"), _rows(rconn, q, "cpu")
    assert len(host) == len(ref_host), q
    for rh, rr in zip(host, ref_host):
        assert all(a == b or (isinstance(a, float) and isinstance(b, float)
                              and math.isnan(a) and math.isnan(b))
                   for a, b in zip(rh, rr)), (q, rh, rr)


def test_float_phase_shapes_are_offloaded(dbs):
    """The float, NaN and NULL aggregates of chip_smoke.py's phase 8 run
    on the device tier: agg_fold's plain version runs for the sums."""
    _rconn, pconn = dbs["fl"]
    LAUNCHES.reset()
    _rows(pconn, FLOAT_QUERIES[0], "gpu")
    assert LAUNCHES.get("agg_scan.plain") == 1
    assert LAUNCHES.get("agg_fold.plain") == 2


def test_chunked_dispatch_matches_one_launch(dbs):
    """Small serene_device_chunk_rows splits the scan into many launches;
    the host combine gives the same rows (floats within the tolerance)."""
    _rconn, pconn = dbs["fl"]
    whole = _rows(pconn, FLOAT_QUERIES[0], "gpu")
    pconn.execute("SET serene_device_chunk_rows = 3000")
    LAUNCHES.reset()
    try:
        chunked = _rows(pconn, FLOAT_QUERIES[0], "gpu")
    finally:
        pconn.execute("RESET serene_device_chunk_rows")
    assert LAUNCHES.get("agg_scan.plain") == -(-20000 // 2944)
    for rw, rc in zip(whole, chunked):
        assert all(_same(a, b) for a, b in zip(rw, rc))


# -- (d) what the port refuses ---------------------------------------------

def test_database_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Database()
    assert Database(device="cpu").device == torch.device("cpu")


def test_durable_storage_matches_reference(tmp_path):
    """Durable storage is ported: the same statements on a reference data
    directory and a port one give equal rows after a restart, on the
    host path and on the device tier (the port's plain versions)."""
    setup = ["CREATE TABLE h (k INT, v DOUBLE, s TEXT)",
             "INSERT INTO h VALUES (1, 1.5, 'a'), (2, 2.5, 'b'), "
             "(1, -3.0, NULL), (3, 4.0, 'c')",
             "VACUUM",
             "INSERT INTO h VALUES (2, 10.0, 'd')",
             "DELETE FROM h WHERE k = 3"]
    q = "SELECT k, count(*), sum(v), min(s) FROM h GROUP BY k ORDER BY k"
    out = []
    for name, make in (("ref", lambda p: RDatabase(p)),
                       ("port", lambda p: Database(path=p, device="cpu"))):
        path = str(tmp_path / name)
        db = make(path)
        c = db.connect()
        for st in setup:
            c.execute(st)
        db.close()
        db = make(path)
        c = db.connect()
        host = c.execute(q).rows()
        c.execute("SET serene_device = %s" % (
            "'gpu'" if name == "port" else "'tpu'"))
        dev = c.execute(q).rows()
        db.close()
        out.append((host, dev))
    assert out[1][0] == out[0][0] == [(1, 2, -1.5, "a"), (2, 2, 12.5, "b")]
    assert out[1][1] == out[1][0]


def test_mesh_runs_agg_scan_per_shard(dbs):
    """serene_mesh = 2 over a virtual mesh of 8 devices (the reference's 8
    virtual CPU devices): both packages take their mesh branch. The port
    launches `agg_scan` once a shard a chunk and combines with
    `mesh_combine`; the rows equal the reference's (integers exactly,
    floats within the module's tolerance)."""
    rconn, pconn = dbs["h"]
    q = "SELECT k, count(*), sum(v), min(v) FROM h GROUP BY k ORDER BY k"
    for c in (rconn, pconn):
        c.execute("SET serene_mesh = 2")
    try:
        with virtual_devices(8):
            before = LAUNCHES.snapshot()
            got, want = _rows(pconn, q, "gpu"), _rows(rconn, q, "tpu")
            after = LAUNCHES.snapshot()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(_same(a, b) for a, b in zip(g, w)), (g, w)
        scans = after.get("agg_scan.plain", 0) - \
            before.get("agg_scan.plain", 0)
        assert scans >= 2 and scans % 2 == 0
        assert after.get("mesh_combine.plain", 0) > \
            before.get("mesh_combine.plain", 0)
    finally:
        for c in (rconn, pconn):
            c.execute("SET serene_mesh = 0")


@pytest.mark.parametrize("q", [
    "SELECT count(*) FROM h WHERE g @@ 'alpha'",
    "SELECT count(*) FROM h WHERE ts_match(g, 'alpha')",
    "SELECT bm25(g) FROM h",
])
def test_search_through_sql_matches_reference(dbs, q):
    """Search predicates on a table without a search index: the port
    answers them as the reference does (a brute scan through the search
    functions), where it once raised FEATURE_NOT_SUPPORTED."""
    rconn, pconn = dbs["h"]
    assert _rows(pconn, q, "cpu") == _rows(rconn, q, "cpu")


def test_serene_device_takes_gpu_not_tpu(dbs):
    _rconn, pconn = dbs["h"]
    pconn.execute("SET serene_device = 'gpu'")
    with pytest.raises(Exception, match="serene_device"):
        pconn.execute("SET serene_device = 'tpu'")
    pconn.execute("SET serene_device = 'auto'")


def test_min_nan_rule_spans_chunks():
    """MIN skips NaN unless every row of the group is NaN — over the whole
    table, not per chunk. The reference applies the rule per chunk
    (device_agg.py:709-716 inside each chunk, np.minimum across them), so
    a group that is all NaN in one chunk reads NaN; the port combines the
    chunks first and agrees with the host path (ROADMAP Queue 3)."""
    n = 4096
    g = np.arange(n, dtype=np.float64)
    g[:2048] = np.nan                       # the first two 1024-row chunks
    cols = {"k": RColumn.from_numpy(np.zeros(n, np.int32)),
            "g": RColumn.from_numpy(g)}
    rdb = RDatabase()
    rdb.schemas["main"].tables["t"] = RMemTable("t", RBatch.from_pydict(cols))
    pdb = Database(device="cpu")
    pdb.schemas["main"].tables["t"] = memtable_from_reference(
        "t", _fields(cols))
    q = "SELECT k, min(g), max(g) FROM t GROUP BY k"
    out = {}
    for name, conn, dev in (("ref", rdb.connect(), "tpu"),
                            ("port", pdb.connect(), "gpu")):
        conn.execute("SET serene_result_cache = off")
        conn.execute("SET serene_device_chunk_rows = 1024")
        out[name] = (_rows(conn, q, dev), _rows(conn, q, "cpu"))
    for rows in (out["port"][0], out["port"][1], out["ref"][1]):
        assert len(rows) == 1 and rows[0][:2] == (0, 2048.0)
        assert math.isnan(rows[0][2])
    assert math.isnan(out["ref"][0][0][1]), \
        "the reference's per-chunk rule no longer shows: drop this note"
