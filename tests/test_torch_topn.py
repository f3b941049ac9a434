"""The port's device top-N (unfiltered and filtered) against the JAX
package's, on the CPU.

The same tables go into a reference `Database` and the port's
`Database(device="cpu")`. The reference runs with serene_device='tpu' on
JAX-CPU, the port with serene_device='gpu', which runs `topn_scan`'s plain
version. Rows must equal the reference's and both host paths' exactly,
and the selected row indices of `_topn_indices` must be equal, tie order
included (`lax.top_k`'s lowest row first). The one difference: JAX's
`top_k` on the CPU orders +0.0 above -0.0, which the host path's sort ties;
the port follows the host path (ROADMAP Queue 3).
"""

import numpy as np
import pytest

from serenedb_tpu.columnar import dtypes as rdt
from serenedb_tpu.columnar.column import Batch as RBatch
from serenedb_tpu.columnar.column import Column as RColumn
from serenedb_tpu.engine import Database as RDatabase
from serenedb_tpu.exec import device_topn as rtopn
from serenedb_tpu.exec.tables import MemTable as RMemTable
from serenedb_tpu.obs import device as robs
from serenedb_tpu.utils import metrics as rmetrics
from serenedb_tpu_torch import errors
from serenedb_tpu_torch.carry import memtable_from_reference
from serenedb_tpu_torch.device import LAUNCHES
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.exec import device_topn as ptopn
from serenedb_tpu_torch.obs import device as pobs
from serenedb_tpu_torch.parallel import virtual_devices

from test_device_pipeline import TOPN_QUERIES, _mk_conn

_SETUP = ["SET serene_result_cache = off", "SET serene_morsel_rows = 1024",
          "SET serene_parallel_min_rows = 1024"]


def _pair(tables: dict):
    """(reference connection, port connection) over the same tables, given
    as {name: {column: reference Column}}."""
    rdb, pdb = RDatabase(), Database(device="cpu")
    for name, cols in tables.items():
        rdb.schemas["main"].tables[name] = RMemTable(
            name, RBatch.from_pydict(cols))
        pdb.schemas["main"].tables[name] = memtable_from_reference(
            name, {n: (c.data, c.validity, c.dictionary, c.type.id.name)
                   for n, c in cols.items()})
    conns = rdb.connect(), pdb.connect()
    for c in conns:
        for s in _SETUP:
            c.execute(s)
    return conns


def _keys_table(n=12_000, seed=5):
    """Tie-heavy int, DATE and f32 keys (f32 without zeros), a clustered
    key whose blocks zone maps can prune, and a row id."""
    rng = np.random.default_rng(seed)
    f = rng.choice(np.float32([1.5, -2.25, 7.0, 3.0]), n)
    return {"t": {
        "i": RColumn.from_numpy(rng.integers(0, 20, n).astype(np.int32)),
        "d": RColumn(rdt.DATE, rng.integers(9000, 9040, n).astype(np.int32)),
        "f": RColumn.from_numpy(f),
        "c": RColumn.from_numpy(np.arange(n, dtype=np.int32) // 3),
        "rid": RColumn.from_numpy(np.arange(n, dtype=np.int32)),
    }}


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
def keys():
    return _pair(_keys_table())


@pytest.fixture(scope="module")
def lconns():
    rconn = _mk_conn()
    pdb = Database(device="cpu")
    for name in ("l", "r"):
        b = rconn.db.schemas["main"].tables[name].full_batch()
        pdb.schemas["main"].tables[name] = memtable_from_reference(
            name, {n: (c.data, c.validity, c.dictionary, c.type.id.name)
                   for n in b.names for c in [b.column(n)]})
    pconn = pdb.connect()
    for s in _SETUP + ["SET serene_device_fused = on"]:
        pconn.execute(s)
    return rconn, pconn


def _rows(conn, q, device):
    conn.execute(f"SET serene_device = '{device}'")
    return repr(conn.execute(q).rows())


def _capture(monkeypatch, module):
    """Record what `module._topn_indices` returns."""
    seen = []
    orig = module._topn_indices

    def wrapper(*a, **kw):
        out = orig(*a, **kw)
        seen.append(None if out is None else np.asarray(out).copy())
        return out
    monkeypatch.setattr(module, "_topn_indices", wrapper)
    return seen


@pytest.mark.parametrize("col", ["i", "d", "f", "c"])
@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("k", [5, 5000])
def test_topn_indices_match_reference(keys, monkeypatch, col, desc, k):
    """Indices equal, tie order included, on tie-heavy keys, at k past
    topk_rows' cap, and on a zone-sliced range (the clustered key)."""
    rconn, pconn = keys
    ref_seen = _capture(monkeypatch, rtopn)
    port_seen = _capture(monkeypatch, ptopn)
    q = f"SELECT * FROM t ORDER BY {col} {'DESC' if desc else ''} LIMIT {k}"
    ref = _rows(rconn, q, "tpu")
    LAUNCHES.reset()
    got = _rows(pconn, q, "gpu")
    assert len(ref_seen) == len(port_seen) == 1
    assert np.array_equal(ref_seen[0], port_seen[0])
    assert LAUNCHES.get("topn_scan.plain") == 1
    assert got == ref == _rows(pconn, q, "cpu") == _rows(rconn, q, "cpu")


def test_zone_map_slices_the_clustered_key(keys, monkeypatch):
    """ORDER BY the clustered key uploads only the candidate blocks."""
    from serenedb_tpu_torch.exec import zonemap
    ranges = []
    orig = zonemap.topn_block_range

    def wrapper(*a, **kw):
        ranges.append(orig(*a, **kw))
        return ranges[-1]
    monkeypatch.setattr(zonemap, "topn_block_range", wrapper)
    _rconn, pconn = keys
    _rows(pconn, "SELECT * FROM t ORDER BY c DESC LIMIT 50", "gpu")
    assert ranges and ranges[0] is not None and ranges[0][0] > 0


def test_signed_zeros_tie_as_the_host_path_ties_them():
    """-0.0 and +0.0 tie (lowest row first), as the host path's sort has
    it. The reference's device tier puts +0.0 above -0.0 (JAX's top_k on
    the CPU), so it disagrees with its own host path here."""
    rng = np.random.default_rng(2)
    n = 4000
    rconn, pconn = _pair({"z": {
        "f": RColumn.from_numpy(rng.choice(np.float32([0.0, -0.0, 1.0]), n)),
        "rid": RColumn.from_numpy(np.arange(n, dtype=np.int32))}})
    for desc in ("DESC", ""):
        q = f"SELECT * FROM z ORDER BY f {desc} LIMIT 2000"
        host = _rows(pconn, q, "cpu")
        assert host == _rows(rconn, q, "cpu")
        LAUNCHES.reset()
        assert _rows(pconn, q, "gpu") == host
        assert LAUNCHES.get("topn_scan.plain") == 1
        assert _rows(rconn, q, "tpu") != host, \
            "the reference's signed-zero order now matches: drop this note"


CASES = TOPN_QUERIES + [
    "SELECT * FROM l ORDER BY v DESC LIMIT 5",
    "SELECT v, ts FROM l WHERE v > 250 ORDER BY v DESC LIMIT 7",
    # the LIMIT passes the survivors (~54), and no row survives: the
    # selection's tail is the lowest masked rows
    "SELECT v, ts FROM l WHERE v > 490 ORDER BY v DESC LIMIT 100",
    "SELECT * FROM l WHERE v * 2 > 1000 ORDER BY v LIMIT 5",
    # declines, each under the reference's reason
    "SELECT * FROM l WHERE v > 0 ORDER BY ik LIMIT 5",         # NULL key
    "SELECT * FROM l ORDER BY ik DESC LIMIT 5",                # NULL key
    "SELECT * FROM l WHERE v > 0 ORDER BY fk LIMIT 5",         # key type
    "SELECT * FROM l WHERE v > 0 ORDER BY v LIMIT 9000",       # k > 8192
    "SELECT * FROM l ORDER BY v LIMIT 9000",
    "SELECT ts + 1, v FROM l WHERE v > 0 ORDER BY v LIMIT 3",  # projection
]


@pytest.mark.parametrize("q", CASES)
def test_topn_matches_reference(lconns, q):
    rconn, pconn = lconns
    d_ref0, d_port0 = robs.fused_declines(), pobs.fused_declines()
    off0 = rmetrics.DEVICE_OFFLOADS.value
    ref = _rows(rconn, q, "tpu")
    offloaded = rmetrics.DEVICE_OFFLOADS.value > off0
    LAUNCHES.reset()
    assert _rows(pconn, q, "gpu") == ref, q
    assert (LAUNCHES.get("topn_scan.plain") == 1) == offloaded, q
    assert LAUNCHES.get("topn_scan") == 0
    delta = lambda a, b: {k: v - b.get(k, 0) for k, v in a.items()  # noqa
                          if v != b.get(k, 0)}
    assert delta(pobs.fused_declines(), d_port0) == \
        delta(robs.fused_declines(), d_ref0), q
    assert _rows(pconn, q, "cpu") == ref == _rows(rconn, q, "cpu")


@pytest.mark.parametrize("key,desc", [("lo", "DESC"), ("hi", "")])
def test_int32_extremes_decline(key, desc):
    """A key touching int32 min (DESC) or max (ASC) would tie the
    sentinel: both top-N tiers decline, in both packages."""
    n = 3000
    vals = np.arange(n, dtype=np.int32)
    vals[7] = -2**31 if key == "lo" else 2**31 - 1
    rconn, pconn = _pair({"x": {"k": RColumn.from_numpy(vals),
                                "g": RColumn.from_numpy(vals % 5)}})
    for q in (f"SELECT * FROM x ORDER BY k {desc} LIMIT 5",
              f"SELECT * FROM x WHERE g <> 2 ORDER BY k {desc} LIMIT 5"):
        d_ref0, d_port0 = robs.fused_declines(), pobs.fused_declines()
        ref = _rows(rconn, q, "tpu")
        LAUNCHES.reset()
        assert _rows(pconn, q, "gpu") == ref
        assert LAUNCHES.get("topn_scan.plain") == 0
        assert sum(pobs.fused_declines().values()) - \
            sum(d_port0.values()) == \
            sum(robs.fused_declines().values()) - sum(d_ref0.values())


def test_nan_key_declines():
    n = 3000
    f = np.linspace(-1, 1, n).astype(np.float32)
    f[11] = np.nan
    rconn, pconn = _pair({"y": {"f": RColumn.from_numpy(f),
                                "g": RColumn.from_numpy(
                                    np.arange(n, dtype=np.int32) % 4)}})
    for q in ("SELECT * FROM y ORDER BY f DESC LIMIT 5",
              "SELECT * FROM y WHERE g = 1 ORDER BY f LIMIT 5"):
        ref = _rows(rconn, q, "tpu")
        LAUNCHES.reset()
        assert _rows(pconn, q, "gpu") == ref
        assert LAUNCHES.get("topn_scan.plain") == 0


def test_projection_expression_falls_back():
    """A computed projection that raises on a surviving row outside the
    top k raises in both modes: the fused top-N declines it
    (`topn_projection_expr` of the reference's suite)."""
    pconn = Database(device="cpu").connect()
    pconn.execute("CREATE TABLE pz (a BIGINT, b BIGINT)")
    pconn.execute("INSERT INTO pz VALUES (1, 1), (2, 1), (3, 1), (9, 0)")
    q = "SELECT a, 100 / b FROM pz WHERE a > 0 ORDER BY a LIMIT 2"
    for mode in ("off", "on"):
        pconn.execute(f"SET serene_device_fused = {mode}")
        pconn.execute("SET serene_device = 'gpu'")
        before = pobs.fused_declines().get("topn_project", 0)
        with pytest.raises(errors.SqlError, match="division by zero"):
            pconn.execute(q)
        assert pobs.fused_declines().get("topn_project", 0) == \
            before + (mode == "on")


def test_mesh_runs_topn_scan_per_shard(keys):
    """serene_mesh = 2 over a virtual mesh of 8 devices: both packages
    shard the key tiles; the port runs `topn_scan` once a shard and merges
    the 2 x k candidates on the host — the same rows as the reference's
    mesh branch."""
    rconn, pconn = keys
    q = "SELECT * FROM t ORDER BY i LIMIT 5"
    for c in (rconn, pconn):
        c.execute("SET serene_mesh = 2")
    try:
        with virtual_devices(8):
            before = LAUNCHES.get("topn_scan.plain")
            assert _rows(pconn, q, "gpu") == _rows(rconn, q, "tpu")
            assert LAUNCHES.get("topn_scan.plain") == before + 2
    finally:
        for c in (rconn, pconn):
            c.execute("SET serene_mesh = 0")