"""The port's fused join tier against the JAX package's, on the CPU.

The tables of the reference's fused-tier suites (tests/test_device_pipeline
.py `_mk_conn`: l with 6,000 rows, r with 3,000, NULL and NaN keys,
dictionary strings, wide values) and small TPC-H-shaped tables are loaded
into a reference `Database` and — through `carry.memtable_from_reference`
— into the port's `Database(device="cpu")`. Every query of the
reference's fused join parity lists (inner, outer and residual joins,
FILTER, DISTINCT, string min/max, chained top-N with OFFSET) runs in both:
the reference with serene_device='tpu' on JAX-CPU, the port with
serene_device='gpu', which runs the plain versions of `agg_scan`,
`join_probe` and `chain_topn`. Rows must equal the reference's and both
host paths' exactly (this tier is integer-only), and the per-reason
fused decline counts must move the same way in both packages.
"""

import numpy as np
import pytest

from serenedb_tpu.obs import device as robs
from serenedb_tpu.utils import metrics as rmetrics
from serenedb_tpu_torch.bench.tpch import tpch_tables
from serenedb_tpu_torch.carry import memtable_from_reference
from serenedb_tpu_torch.device import LAUNCHES, UPLOADS
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.exec import device_pipeline as dp
from serenedb_tpu_torch.obs import device as pobs
from serenedb_tpu_torch.ops import join_kernels as J
from serenedb_tpu_torch.parallel import virtual_devices
from serenedb_tpu_torch.utils.config import REGISTRY as PSETTINGS

from test_device_pipeline import FUSED_QUERIES, _mk_conn
from test_fused_admission import CHAINED_SHAPES, NEW_SHAPES

_SETUP = ["SET serene_device = 'gpu'", "SET serene_device_fused = on",
          "SET serene_result_cache = off", "SET serene_morsel_rows = 1024",
          "SET serene_parallel_min_rows = 1024"]

TPCH_QUERIES = [
    "SELECT l_returnflag, l_linestatus, count(*), sum(l_quantity), "
    "sum(l_extendedprice), count(DISTINCT l_suppkey), min(o_orderdate), "
    "max(o_totalprice) FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
    "WHERE o_orderdate < '1995-03-15' AND l_shipdate > '1995-03-15' "
    "GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus",
    "SELECT l_suppkey, count(*) AS n, sum(l_quantity) FROM lineitem "
    "JOIN orders ON l_orderkey = o_orderkey WHERE o_orderdate >= "
    "'1996-01-01' GROUP BY l_suppkey ORDER BY n DESC LIMIT 10",
    "SELECT o_orderpriority, count(*), count(l_quantity), sum(l_quantity), "
    "max(l_extendedprice) FROM orders LEFT JOIN lineitem "
    "ON o_orderkey = l_orderkey GROUP BY o_orderpriority "
    "ORDER BY o_orderpriority",
    "SELECT c_mktsegment, count(*), count(o_orderkey), sum(o_totalprice), "
    "max(o_orderdate) FROM customer LEFT JOIN orders ON c_custkey = "
    "o_custkey GROUP BY c_mktsegment ORDER BY c_mktsegment",
    "SELECT o_orderpriority, count(*), count(o_orderkey), sum(o_totalprice), "
    "max(o_orderdate), count(c_custkey), max(c_custkey) FROM orders RIGHT "
    "JOIN customer ON o_custkey = c_custkey GROUP BY o_orderpriority "
    "ORDER BY o_orderpriority",
    # the typed DATE literal: both device tiers decline it
    "SELECT count(*) FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
    "WHERE o_orderdate < DATE '1995-03-15'",
    # an ON-clause build predicate under LEFT is a residual: declined
    "SELECT o_orderpriority, count(l_quantity) FROM orders LEFT JOIN "
    "lineitem ON o_orderkey = l_orderkey AND l_quantity < 5 "
    "GROUP BY o_orderpriority ORDER BY o_orderpriority",
]


def _port_conn(rconn, names):
    """A port connection over the reference connection's tables."""
    pdb = Database(device="cpu")
    for name in names:
        batch = rconn.db.schemas["main"].tables[name].full_batch()
        pdb.schemas["main"].tables[name] = memtable_from_reference(
            name, {n: (c.data, c.validity, c.dictionary, c.type.id.name)
                   for n in batch.names for c in [batch.column(n)]})
    pconn = pdb.connect()
    for s in _SETUP:
        pconn.execute(s)
    return pconn


def _tpch(n_orders=20_000, seed=0):
    """The port's TPC-H generator (chip_smoke.py's tables) at a small
    scale, as reference tables (customer, orders, lineitem)."""
    from serenedb_tpu.columnar import dtypes as rdt
    from serenedb_tpu.columnar.column import Batch, Column
    from serenedb_tpu.engine import Database as RDatabase
    from serenedb_tpu.exec.tables import MemTable
    rdb = RDatabase()
    for name, cols in tpch_tables(n_orders, seed).items():
        rcols = {}
        for n, c in cols.items():
            data = c.data if c.dictionary is None else c.dictionary[c.data]
            rcols[n] = Column(rdt.DATE, data) if c.type.id.name == "DATE" \
                else Column.from_numpy(np.asarray(data))
        rdb.schemas["main"].tables[name] = MemTable(
            name, Batch.from_pydict(rcols))
    rconn = rdb.connect()
    rconn.execute("SET serene_result_cache = off")
    return rconn


@pytest.fixture(scope="module", autouse=True)
def _forget_reference_compile_rate():
    """The reference's recompile-storm detector keeps a 60 s window of
    compile times per program family, and this module compiles many
    shapes on purpose. Empty the windows after it, so that a later
    module's storm assertions see only that module's own compiles."""
    yield
    with robs.PROGRAMS._lock:
        robs.PROGRAMS._storm_t.clear()


@pytest.fixture(scope="module")
def conns():
    rl = _mk_conn()
    rt = _tpch()
    return {"lr": (rl, _port_conn(rl, ["l", "r"])),
            "tpch": (rt, _port_conn(rt, ["customer", "orders",
                                         "lineitem"]))}


def _rows(conn, q, device):
    conn.execute(f"SET serene_device = '{device}'")
    return repr(conn.execute(q).rows())


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


_PLAIN = ("agg_scan.plain", "join_probe.plain", "chain_topn.plain")

#: chained top-N edges: the LIMIT passes the group space (k_pad is the
#: whole space, every slot picked), and a filter that leaves every slot
#: absent
CHAIN_EDGES = [
    "SELECT l.sk, count(*) AS n, sum(w) FROM l JOIN r ON l.ik = r.ik "
    "GROUP BY l.sk ORDER BY n DESC LIMIT 20",
    "SELECT l.ik, count(*) AS n FROM l JOIN r ON l.ik = r.ik "
    "WHERE l.v > 1000 GROUP BY l.ik ORDER BY n DESC LIMIT 5",
]

CASES = [("lr", q) for q in FUSED_QUERIES + NEW_SHAPES + CHAINED_SHAPES +
         CHAIN_EDGES] + [("tpch", q) for q in TPCH_QUERIES]


@pytest.mark.parametrize("key,q", CASES)
def test_fused_tier_matches_reference(conns, key, q):
    rconn, pconn = conns[key]
    d_ref0, d_port0 = robs.fused_declines(), pobs.fused_declines()
    off0 = rmetrics.DEVICE_OFFLOADS.value
    ref = _rows(rconn, q, "tpu")
    offloaded = rmetrics.DEVICE_OFFLOADS.value > off0
    LAUNCHES.reset()
    got = _rows(pconn, q, "gpu")
    assert got == ref, q
    assert _delta(pobs.fused_declines(), d_port0) == \
        _delta(robs.fused_declines(), d_ref0), q
    launched = LAUNCHES.get("join_probe.plain") > 0
    assert launched == offloaded, q
    if launched:
        assert LAUNCHES.get("agg_scan.plain") == 1
    assert not any(LAUNCHES.get(k[:-6]) for k in _PLAIN)
    assert _rows(pconn, q, "cpu") == ref
    assert _rows(rconn, q, "cpu") == ref


def test_chained_top_n_runs_chain_topn(conns):
    _rconn, pconn = conns["lr"]
    LAUNCHES.reset()
    _rows(pconn, CHAINED_SHAPES[0], "gpu")
    assert LAUNCHES.get("chain_topn.plain") == 1


def test_warm_chained_repeat_uploads_nothing(conns):
    """The stage-1 accumulators stay on the device: a warm repeat moves
    no host→device bytes (bench.py:1594-1598's check)."""
    _rconn, pconn = conns["tpch"]
    q = TPCH_QUERIES[1]
    cold = _rows(pconn, q, "gpu")
    b0, t0 = UPLOADS.get("bytes"), UPLOADS.get("transfers")
    assert _rows(pconn, q, "gpu") == cold
    assert UPLOADS.get("bytes") == b0 and UPLOADS.get("transfers") == t0


def test_fused_off_never_offloads(conns):
    _rconn, pconn = conns["lr"]
    pconn.execute("SET serene_device_fused = off")
    try:
        LAUNCHES.reset()
        _rows(pconn, "SELECT count(*), sum(v) FROM l JOIN r ON l.ik = r.ik",
              "gpu")
        _rows(pconn, CHAINED_SHAPES[0], "gpu")
        assert not any(LAUNCHES.get(k) for k in _PLAIN)
    finally:
        pconn.execute("SET serene_device_fused = on")


def test_empty_and_all_pruned_scans():
    """A genuinely empty side and an all-zone-pruned side give the host
    oracle's (and the reference's) rows."""
    rconn = _mk_conn()
    rconn.execute("CREATE TABLE e (ik INT, u BIGINT)")
    pconn = _port_conn(rconn, ["l", "r"])
    pconn.execute("CREATE TABLE e (ik INT, u BIGINT)")
    for q in [
        "SELECT count(*), sum(v), sum(u) FROM l JOIN e ON l.ik = e.ik",
        "SELECT count(*), sum(u) FROM e JOIN r ON e.ik = r.ik",
        "SELECT l.sk, count(*) FROM l JOIN e ON l.ik = e.ik "
        "GROUP BY l.sk ORDER BY l.sk",
        "SELECT count(*), sum(v), sum(w) FROM l JOIN r ON l.ik = r.ik "
        "WHERE ts > 90000",
        "SELECT l.sk, count(*) FROM l LEFT JOIN e ON l.ik = e.ik "
        "GROUP BY l.sk ORDER BY l.sk",
    ]:
        d_ref0, d_port0 = robs.fused_declines(), pobs.fused_declines()
        ref = _rows(rconn, q, "tpu")
        assert _rows(pconn, q, "gpu") == ref, q
        assert _rows(pconn, q, "cpu") == ref, q
        assert _delta(pobs.fused_declines(), d_port0) == \
            _delta(robs.fused_declines(), d_ref0), q


def test_write_to_build_table_invalidates_cached_codes():
    """Repeat queries serve columns and codes from the device cache; a
    write to the BUILD table moves its publication, so the probe side's
    code tiles (keyed by the partner's publication) are swept and the
    next run sees the new row."""
    rconn = _mk_conn()
    pconn = _port_conn(rconn, ["l", "r"])
    q = ("SELECT count(*), sum(v), sum(w) FROM l JOIN r ON l.ik = r.ik "
         "WHERE v > 0")
    first = _rows(pconn, q, "gpu")
    from serenedb_tpu_torch.utils import metrics as pmetrics
    hits0 = pmetrics.DEVICE_CACHE_HITS.value
    misses0 = pmetrics.DEVICE_CACHE_MISSES.value
    assert _rows(pconn, q, "gpu") == first
    assert pmetrics.DEVICE_CACHE_HITS.value > hits0
    assert pmetrics.DEVICE_CACHE_MISSES.value == misses0
    for c in (rconn, pconn):
        c.execute("INSERT INTO r VALUES (3, 'alpha', 0.5, 77777, 5)")
    fresh = _rows(pconn, q, "gpu")
    assert fresh != first
    assert fresh == _rows(pconn, q, "cpu") == _rows(rconn, q, "tpu")
    with dp._codes_lock:
        keys = list(dp._CODES_CACHE)
    gens = [(p[0], b[0], keyset) for p, b, keyset in keys]
    assert len(gens) == len(set(gens)), \
        "a superseded code factorization survived the write"


def test_device_cache_lru_eviction_and_generation_sweep():
    """The byte cap evicts oldest first (keeping one entry), and a newer
    publication of the same column sweeps the superseded generation."""
    import torch
    old_cap = PSETTINGS.get_global("serene_device_cache_mb")
    PSETTINGS.set_global("serene_device_cache_mb", 1)
    try:
        cache = dp.DeviceColumnCache()
        a = torch.zeros(8)
        cache.put(((1, 0, 0), "c1", "col", None), a, 400_000)
        cache.put(((2, 0, 0), "c2", "col", None), a, 400_000)
        cache.put(((3, 0, 0), "c3", "col", None), a, 400_000)
        assert cache.get(((1, 0, 0), "c1", "col", None)) is None
        assert cache.get(((3, 0, 0), "c3", "col", None)) is not None
        cache.put(((7, 1, 0), "k", "col", None), a, 1000)
        cache.put(((7, 2, 0), "k", "col", None), a, 1000)
        assert cache.get(((7, 1, 0), "k", "col", None)) is None
        assert cache.get(((7, 2, 0), "k", "col", None)) is not None
        cache.put(((9, 0, 0), "big", "col", None), a, 5 << 20)
        assert cache.stats()["entries"] == 1      # over the cap, kept
    finally:
        PSETTINGS.set_global("serene_device_cache_mb", old_cap)


def test_shards_run_the_single_dispatch(conns):
    """serene_shards = 4 decomposes as the reference's sharded tier does:
    an admitted plain inner join runs one build and, per combine, one
    probe launch per surviving shard (host) or one over every shard's
    spans (device); a warm repeat skips the cached build. A LEFT join
    stays on the single dispatch. Rows and dispatch counts equal the
    reference's."""
    rconn, pconn = conns["lr"]
    inner = ("SELECT l.sk, count(*), sum(l.v), min(r.w), max(r.w) FROM l "
             "JOIN r ON l.ik = r.ik GROUP BY l.sk ORDER BY l.sk")
    left = ("SELECT l.sk, count(*), count(r.w) FROM l LEFT JOIN r "
            "ON l.ik = r.ik GROUP BY l.sk ORDER BY l.sk")
    for c in (rconn, pconn):
        c.execute("SET serene_shards = 4")
    try:
        for combine, probes in (("host", 4), ("device", 1)):
            for c in (rconn, pconn):
                c.execute(f"SET serene_shard_combine = {combine}")
            for q, warm_probes in ((inner, probes), (left, 1)):
                _rows(rconn, q, "tpu")
                _rows(pconn, q, "gpu")
                r0 = rmetrics.DEVICE_OFFLOADS.value
                ref = _rows(rconn, q, "tpu")
                r_off = rmetrics.DEVICE_OFFLOADS.value - r0
                LAUNCHES.reset()
                assert _rows(pconn, q, "gpu") == ref, (q, combine)
                assert LAUNCHES.get("join_probe.plain") == warm_probes
                if q is inner:
                    assert LAUNCHES.get("agg_scan.plain") == 0
                    assert r_off == warm_probes
    finally:
        for c in (rconn, pconn):
            c.execute("SET serene_shards = 1")
            c.execute("SET serene_shard_combine = auto")


def test_collective_join_runs_per_mesh_device(conns):
    """Over a virtual mesh of 8 devices: serene_mesh = 2 is read by
    neither package's fused pipeline (one `join_probe`, the rows of
    serene_mesh = 0); at serene_shards = 2 with the device combine the
    collective spans a mesh of 2, so the port launches one `join_probe` a
    mesh device and combines them with `mesh_combine`: the rows equal the
    reference's collective at the same settings."""
    rconn, pconn = conns["lr"]
    q = FUSED_QUERIES[0]
    try:
        with virtual_devices(8):
            for c in (rconn, pconn):
                c.execute("SET serene_mesh = 2")
            LAUNCHES.reset()
            assert _rows(pconn, q, "gpu") == _rows(rconn, q, "tpu")
            assert LAUNCHES.get("join_probe.plain") == 1
            for c in (rconn, pconn):
                c.execute("SET serene_mesh = 0")
                c.execute("SET serene_shards = 2")
                c.execute("SET serene_shard_combine = device")
            _rows(pconn, q, "gpu")
            LAUNCHES.reset()
            assert _rows(pconn, q, "gpu") == _rows(rconn, q, "tpu")
            assert LAUNCHES.get("join_probe.plain") == 2
            assert LAUNCHES.get("mesh_combine.plain") >= 1
    finally:
        for c in (rconn, pconn):
            c.execute("SET serene_mesh = 0")
            c.execute("SET serene_shards = 1")
            c.execute("SET serene_shard_combine = auto")


def test_program_ledger_counts_fused_lookups(conns):
    """The `fused`/`fused_chain` family's hits and misses (what
    bench_fused_admission reads) count one lookup per admitted query."""
    _rconn, pconn = conns["lr"]
    fams = {p["family"]: p for p in pobs.stats_section()["programs"]}
    before = fams.get("fused", {"hits": 0, "misses": 0})
    _rows(pconn, FUSED_QUERIES[1], "gpu")
    _rows(pconn, FUSED_QUERIES[1], "gpu")
    fams = {p["family"]: p for p in pobs.stats_section()["programs"]}
    after = fams["fused"]
    assert after["hits"] + after["misses"] == \
        before["hits"] + before["misses"] + 2
    assert after["hits"] >= before["hits"] + 1


#: joins whose group space straddles join_probe's SMALL/LARGE line:
#: GROUP BY l.ts is G = 6,001 groups, whose count(*) cells take 48,008
#: bytes (SMALL, under PROBE_SMALL_BYTES); one more count doubles them
#: (LARGE); GROUP BY l.v is G = 1,001 with a sum (SMALL)
STRADDLE = [
    ("SELECT l.ts, count(*) FROM l JOIN r ON l.ik = r.ik GROUP BY l.ts "
     "ORDER BY l.ts", J.REGIME_SMALL),
    ("SELECT l.ts, count(*), count(w) FROM l JOIN r ON l.ik = r.ik "
     "GROUP BY l.ts ORDER BY l.ts", J.REGIME_LARGE),
    ("SELECT l.ts, count(*), min(w), max(v) FROM l LEFT JOIN r "
     "ON l.ik = r.ik GROUP BY l.ts ORDER BY l.ts", J.REGIME_LARGE),
    ("SELECT l.v, count(*), sum(w) FROM l JOIN r ON l.ik = r.ik "
     "GROUP BY l.v ORDER BY l.v", J.REGIME_SMALL),
]


@pytest.mark.parametrize("q,regime", STRADDLE)
def test_joins_on_both_sides_of_the_probe_regime_line(conns, q, regime,
                                                      monkeypatch):
    """The plain version that both of join_probe's regimes are held to on
    the card, against the reference at group spaces on either side of
    the regime line (the card picks the regime from the spec alone)."""
    rconn, pconn = conns["lr"]
    specs = []
    orig = J.join_probe

    def spy(*a, **kw):
        specs.append(a[0])
        return orig(*a, **kw)
    monkeypatch.setattr(J, "join_probe", spy)
    assert _rows(pconn, q, "gpu") == _rows(rconn, q, "tpu")
    assert [J.probe_regime(s) for s in specs] == [regime]


def _probe_spec(G: int, aggs: list, outer: bool = False) -> "J.ProbeSpec":
    from serenedb_tpu_torch.ops import agg_kernels as K
    return J.ProbeSpec([K.COL_I32, K.COL_U8], [0, 3], G, 100, outer,
                       [((K.OP_COL, 1, 0), (K.OP_I32, 0, 7),
                         (K.OP_CMP_I, 0, K.CMP_CODES[">"]))],
                       [(K.KEY_INT, 0, 0, G)], aggs)


@pytest.mark.parametrize("G,regime", [(1, J.REGIME_SMALL),
                                      (3072, J.REGIME_SMALL),
                                      (3073, J.REGIME_LARGE),
                                      (1_000_000, J.REGIME_LARGE)])
def test_probe_regime_line(G, regime):
    """count(*) and a count take 16 bytes a group: SMALL up to the 48 KiB
    budget (G 3,072), LARGE past it; a sum and a min add 28 more."""
    from serenedb_tpu_torch.ops import agg_kernels as K
    spec = _probe_spec(G, [J.ProbeAgg(J.JP_COUNT, ((K.OP_COL, 0, 0),))])
    assert J.probe_cells_bytes(spec) == 16 * G
    assert J.probe_regime(spec) == regime
    wide = _probe_spec(G, spec.aggs + [
        J.ProbeAgg(J.JP_SUM, ((K.OP_COL, 0, 0),)),
        J.ProbeAgg(J.JP_MIN, ((K.OP_COL, 0, 0),)),
        J.ProbeAgg(J.JP_PRESENCE, ((K.OP_COL, 1, 0),), pvsize=9)])
    assert J.probe_cells_bytes(wide) == (16 + 16 + 12) * G
    assert J.probe_regime(wide) == (
        J.REGIME_SMALL if 44 * G <= J.PROBE_SMALL_BYTES else J.REGIME_LARGE)


@pytest.mark.parametrize("right", [False, True])
def test_memoized_probe_descriptor_equals_a_fresh_build(right):
    """The card's descriptors come from a template per spec with the
    call's pointers and row counts written in: word for word what a fresh
    build gives, call after call, for the probe and the unmatched pass."""
    import torch

    from serenedb_tpu_torch.ops import agg_kernels as K
    rng = np.random.default_rng(4)
    bsum = (torch.zeros(102, dtype=torch.int64),
            torch.zeros(102, dtype=torch.int64))
    aggs = [J.ProbeAgg(J.JP_COUNT, ((K.OP_COL, 0, 0),)),
            J.ProbeAgg(J.JP_SUM, ((K.OP_COL, 0, 0), (K.OP_I32, 0, 3),
                                  (K.OP_MUL_I, 0, 0))),
            J.ProbeAgg(J.JP_MAX, ((K.OP_COL, 1, 0),)),
            J.ProbeAgg(J.JP_PRESENCE, ((K.OP_COL, 1, 0),), pkind=K.KEY_INT,
                       plo=3, pvsize=5),
            J.ProbeAgg(J.JB_SUM, src=bsum, ub_ops=((K.OP_COL, 0, 0),)),
            J.ProbeAgg(J.JB_COUNT, src=(None, bsum[1]),
                       ub_ops=((K.OP_COL, 0, 0),))]
    J._PLANS.clear()
    for call in range(3):
        spec = _probe_spec(40, aggs, outer=right)
        r = 4 + call
        cols = [(torch.from_numpy(rng.integers(0, 40, (r, 128),
                                               dtype=np.int32)),
                 torch.ones((r, 128), dtype=torch.bool)),
                (torch.zeros((r, 128), dtype=torch.uint8),
                 torch.ones((r, 128), dtype=torch.bool))]
        rowmask = torch.ones((r, 128), dtype=torch.bool)
        codes = torch.zeros((r, 128), dtype=torch.int32)
        cnt = torch.zeros(102, dtype=torch.int64)
        rt = None
        if right:
            rt = (J.UnmatchedSpec([K.COL_I32], [0], 39,
                                  [((K.OP_COL, 0, 0), (K.OP_I32, 0, 1),
                                    (K.OP_CMP_I, 0, K.CMP_CODES[">"]))]),
                  [(torch.zeros((2, 128), dtype=torch.int32),
                    torch.ones((2, 128), dtype=torch.bool))],
                  torch.ones((2, 128), dtype=torch.bool),
                  torch.zeros((2, 128), dtype=torch.int32))
        plan = J._plan(spec, rt)
        _buf, rowcount, outs, pcc = plan.carve("cpu")
        args = (spec, cols, rowmask, codes, cnt, rowcount, outs, pcc, rt)
        fresh = J.probe_descriptors(None, *args)
        got = J.probe_descriptors(plan, *args)
        assert len(J._PLANS) == 1 and plan.tmpl is not None
        for a, b in zip(got, fresh):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("right", [False, True])
@pytest.mark.parametrize("pvsize", [4, 5])
def test_call_buffer_carves_every_output_at_its_starting_value(right,
                                                               pvsize):
    """The card call's one buffer: each output a view of its dtype and
    shape, none overlapping, and the init launch's three sections (0,
    INT32_MAX, INT32_MIN; applied here as the kernel applies them) give
    each output the plain version's starting value; pcc starts at 0."""
    import torch

    from serenedb_tpu_torch.ops import agg_kernels as K
    col = ((K.OP_COL, 0, 0),)
    aggs = [J.ProbeAgg(J.JP_COUNT, col), J.ProbeAgg(J.JP_MIN, col),
            J.ProbeAgg(J.JP_PRESENCE, col, pvsize=pvsize),
            J.ProbeAgg(J.JB_SUM), J.ProbeAgg(J.JB_MAX),
            J.ProbeAgg(J.JP_MAX, col), J.ProbeAgg(J.JB_COUNT),
            J.ProbeAgg(J.JB_MIN), J.ProbeAgg(J.JP_SUM, col)]
    spec = _probe_spec(7, aggs)
    plan = J._Plan(spec, spec.g + 2 if right else 0)
    buf, rowcount, outs, pcc = plan.carve("cpu")
    words = buf.view(torch.int32)
    zero, n_max, n_min = plan.sections
    words[:zero] = 0
    words[zero:zero + n_max] = K.INT32_MAX
    words[zero + n_max:zero + n_max + n_min] = K.INT32_MIN
    want_rc, want = J._outputs(spec, "cpu")
    got = [rowcount] + [t for e in outs for t in e]
    ref = [want_rc] + [t for e in want for t in e]
    assert [len(e) for e in outs] == [len(e) for e in want]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() *
                    t.element_size()) for t in got +
                   ([pcc] if pcc is not None else []))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= buf.data_ptr() + buf.numel() * 8
    if right:
        assert pcc.dtype == torch.int32 and pcc.shape == (spec.g + 2,)
        assert not pcc.any()
    else:
        assert pcc is None
