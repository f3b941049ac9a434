"""The port's durable storage against the JAX package's, on the CPU.

The inputs of `tests/test_storage.py` and `tests/test_ingest_stream.py`
run on both packages: the reference's `Database(path)` and the port's
`Database(path, device="cpu")`, each on a data directory of its own. The
rows each reads back must be equal, and equal to what the reference's
tests expect. Then a data directory crosses between the packages, both
ways: one written by either (a parquet snapshot, a WAL tail, a view, a
DEFAULT, an inverted index) opens in the other with equal rows, and the
other's writes open again in the first. Last, the port without pyarrow
(in a subprocess), and its device cache across a close and a reopen in
one process.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from serenedb_tpu.columnar.column import Batch as RBatch
from serenedb_tpu.engine import Database as RDatabase
from serenedb_tpu.errors import SqlError as RSqlError
from serenedb_tpu.search.analysis import get_analyzer as rget_analyzer
from serenedb_tpu.search.segment import build_field_index as rbuild
from serenedb_tpu.storage import wal as rwal
from serenedb_tpu.utils.config import REGISTRY as RREGISTRY
from serenedb_tpu_torch.columnar.column import Batch
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.errors import SqlError
from serenedb_tpu_torch.search.analysis import get_analyzer
from serenedb_tpu_torch.search.segment import (build_field_index,
                                               build_field_index_auto)
from serenedb_tpu_torch.storage import wal as pwal
from serenedb_tpu_torch.utils.config import REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: package name -> how a test opens a database of it
PKGS = {
    "ref": lambda path=None: RDatabase(path),
    "port": lambda path=None: Database(path, device="cpu"),
}
REGISTRIES = {"ref": RREGISTRY, "port": REGISTRY}
SQL_ERRORS = {"ref": RSqlError, "port": SqlError}


def _both(tmp_path, scenario):
    """scenario(pkg, datadir) on each package, in a directory of its
    own; the two results must be equal, and that one is returned."""
    out = {pkg: scenario(pkg, str(tmp_path / pkg)) for pkg in PKGS}
    assert out["port"] == out["ref"]
    return out["port"]


def _rows(db, sql):
    return db.connect().execute(sql).rows()


class _globals:
    """Set both packages' registry globals for one block."""

    def __init__(self, **kv):
        self.kv = kv
        self.prev = []

    def __enter__(self):
        for reg in REGISTRIES.values():
            for k, v in self.kv.items():
                self.prev.append((reg, k, reg.get_global(k)))
                reg.set_global(k, v)
        return self

    def __exit__(self, *exc):
        for reg, k, v in reversed(self.prev):
            reg.set_global(k, v)
        return False


# -- the WAL ------------------------------------------------------------------

def _record_ops(mod, batch_cls):
    b = batch_cls.from_pydict({"a": [1, 2, None], "s": ["x", None, "z"]})
    return b, [mod.WalOp("main.t", "insert", b),
               mod.WalOp("main.t", "delete", rows=np.array([0, 2])),
               mod.WalOp("main.t", "delete_pk",
                         rows={"cols": ["a"], "keys": [b"\x01\x02"]}),
               mod.WalOp("main.u", "truncate")]


@pytest.mark.parametrize("writer,reader", [(pwal, rwal), (rwal, pwal),
                                           (pwal, pwal)])
def test_wal_record_roundtrip_crosses_packages(writer, reader):
    """A record encoded by either package decodes in either."""
    bcls = Batch if writer is pwal else RBatch
    b, ops = _record_ops(writer, bcls)
    out = reader._decode_record(7, writer._encode_ops(ops))
    assert out.tick == 7
    assert [o.kind for o in out.ops] == ["insert", "delete", "delete_pk",
                                         "truncate"]
    assert out.ops[0].batch.to_pydict() == b.to_pydict()
    assert out.ops[1].rows.tolist() == [0, 2]
    assert out.ops[2].rows == {"cols": ["a"], "keys": [b"\x01\x02"]}


def test_wal_append_recover_and_torn_tail(tmp_path):
    def scenario(pkg, d):
        mod, bcls = (pwal, Batch) if pkg == "port" else (rwal, RBatch)
        wal = mod.SearchDbWal(d)
        b = bcls.from_pydict({"a": [1]})
        wal.append_commit(mod.CommitRecord(1, [mod.WalOp("t", "insert", b)]))
        wal.append_commit(mod.CommitRecord(2, [mod.WalOp("t", "insert", b)]))
        wal.close()
        seg = sorted(os.listdir(d))[0]
        with open(os.path.join(d, seg), "ab") as f:
            f.write(b"\x99\x00\x00\x00garbage")
        wal2 = mod.SearchDbWal(d)
        seen, seen2 = [], []
        mx = wal2.recover(lambda t: 0, lambda tick, op: seen.append(tick))
        wal2.recover(lambda t: 1, lambda tick, op: seen2.append(tick))
        wal2.close()
        return mx, seen, seen2
    assert _both(tmp_path, scenario) == (2, [1, 2], [2])


def test_wal_incompatible_version_rejected(tmp_path):
    def scenario(pkg, d):
        mod = pwal if pkg == "port" else rwal
        os.makedirs(d)
        with open(os.path.join(d, "000000000001.wal"), "wb") as f:
            f.write(b"\x10\x00\x00\x00" + b"x" * 32)
        wal = mod.SearchDbWal(d)
        with pytest.raises(SQL_ERRORS[pkg]) as e:
            wal.recover(lambda t: 0, lambda tick, op: None)
        wal.close()
        with open(os.path.join(d, "000000000002.wal"), "wb") as f:
            f.write(mod.SEGMENT_MAGIC[:3])
        os.remove(os.path.join(d, "000000000001.wal"))
        wal2 = mod.SearchDbWal(d)
        mx = wal2.recover(lambda t: 0, lambda tick, op: None)
        wal2.close()
        return (e.value.sqlstate, "incompatible WAL version" in
                str(e.value), mx,
                os.path.getsize(os.path.join(d, "000000000002.wal")))
    assert _both(tmp_path, scenario) == ("58030", True, 0, 0)
    assert pwal.SEGMENT_MAGIC == rwal.SEGMENT_MAGIC


def test_wal_failed_group_write_rolled_back(tmp_path, monkeypatch):
    real_fsync = os.fsync

    def scenario(pkg, d):
        mod, bcls = (pwal, Batch) if pkg == "port" else (rwal, RBatch)
        wal = mod.SearchDbWal(d)
        b = bcls.from_pydict({"a": [1]})
        wal.append_commit(mod.CommitRecord(1, [mod.WalOp("t", "insert", b)]))
        calls = {"n": 0}

        def failing_fsync(fd):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("injected fsync failure")
            return real_fsync(fd)
        monkeypatch.setattr(os, "fsync", failing_fsync)
        with pytest.raises(OSError):
            wal.append_commit(
                mod.CommitRecord(2, [mod.WalOp("t", "insert", b)]))
        wal.append_commit(mod.CommitRecord(3, [mod.WalOp("t", "insert", b)]))
        monkeypatch.setattr(os, "fsync", real_fsync)
        wal.close()
        wal2 = mod.SearchDbWal(d)
        seen = []
        wal2.recover(lambda t: 0, lambda tick, op: seen.append(tick))
        wal2.close()
        return seen
    assert _both(tmp_path, scenario) == [1, 3]


# -- durable DDL and DML --------------------------------------------------------

def test_durable_dml_and_restart(tmp_path):
    def scenario(pkg, d):
        db = PKGS[pkg](d)
        c = db.connect()
        c.execute("CREATE TABLE t (a INT, s TEXT)")
        c.execute("INSERT INTO t VALUES (1, 'x'), (2, 'y'), (3, 'z')")
        c.execute("DELETE FROM t WHERE a = 2")
        c.execute("UPDATE t SET s = 'xx' WHERE a = 1")
        c.execute("CREATE VIEW v AS SELECT a FROM t WHERE a > 1")
        db.close()
        db2 = PKGS[pkg](d)
        out = (_rows(db2, "SELECT a, s FROM t ORDER BY a"),
               _rows(db2, "SELECT count(*) FROM v"))
        db2.close()
        return out
    assert _both(tmp_path, scenario) == ([(1, "xx"), (3, "z")], [(1,)])


def test_checkpoint_gc_and_delta_replay(tmp_path):
    def scenario(pkg, d):
        db = PKGS[pkg](d)
        c = db.connect()
        c.execute("CREATE TABLE t (a INT)")
        c.execute("INSERT INTO t VALUES (1), (2)")
        c.execute("VACUUM t")
        c.execute("INSERT INTO t VALUES (3)")
        db.close()
        db2 = PKGS[pkg](d)
        out = _rows(db2, "SELECT a FROM t ORDER BY a")
        db2.close()
        return out
    assert _both(tmp_path, scenario) == [(1,), (2,), (3,)]


def test_index_definition_survives_restart(tmp_path):
    def scenario(pkg, d):
        db = PKGS[pkg](d)
        c = db.connect()
        c.execute("CREATE TABLE docs (body TEXT)")
        c.execute("INSERT INTO docs VALUES ('hello world'), "
                  "('other things')")
        c.execute("CREATE INDEX ON docs USING inverted (body)")
        db.close()
        db2 = PKGS[pkg](d)
        ex = _rows(db2, "EXPLAIN SELECT count(*) FROM docs "
                        "WHERE body @@ 'hello'")
        out = (any("SearchScan" in r[0] for r in ex),
               _rows(db2, "SELECT count(*) FROM docs WHERE body @@ 'hello'"))
        db2.close()
        return out
    assert _both(tmp_path, scenario) == (True, [(1,)])


def test_datadir_lock(tmp_path):
    def scenario(pkg, d):
        db = PKGS[pkg](d)
        with pytest.raises(SQL_ERRORS[pkg]) as e:
            PKGS[pkg](d)
        db.close()
        PKGS[pkg](d).close()   # a released lock can be taken again
        return e.value.sqlstate
    assert _both(tmp_path, scenario) == "55000"


def test_lock_is_shared_between_the_packages(tmp_path):
    """One data directory, one process at a time, whichever package
    holds it."""
    d = str(tmp_path / "data")
    db = RDatabase(d)
    with pytest.raises(SqlError):
        Database(d, device="cpu")
    db.close()
    db = Database(d, device="cpu")
    with pytest.raises(RSqlError):
        RDatabase(d)
    db.close()


CRASH_SCRIPT = r"""
import sys
sys.path.insert(0, {repo!r})
from {pkg}.engine import Database
db = Database({datadir!r}{kw})
c = db.connect()
c.execute("CREATE TABLE t (a INT)")
c.execute("INSERT INTO t VALUES (1), (2)")
c.execute("SET sdb_faults = {fault!r}")
try:
    c.execute("INSERT INTO t VALUES (3)")
except BaseException:
    pass
print("SURVIVED")
"""


@pytest.mark.parametrize("fault,expect_third_row", [
    ("crash_before_search_wal_commit", False),
    ("crash_after_search_wal_commit", True),
])
def test_crash_recovery_fault_points(tmp_path, fault, expect_third_row):
    """A process killed at a WAL fault point; the next boot of either
    package sees the commit exactly when it was durable."""
    def scenario(pkg, d):
        name = "serenedb_tpu_torch" if pkg == "port" else "serenedb_tpu"
        kw = ', device="cpu"' if pkg == "port" else ""
        script = CRASH_SCRIPT.format(repo=REPO, pkg=name, datadir=d,
                                     kw=kw, fault=fault)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        p = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode == 137, (p.returncode, p.stdout, p.stderr)
        assert "SURVIVED" not in p.stdout
        db = PKGS[pkg](d)   # the dead pid's lock file must not block
        out = _rows(db, "SELECT a FROM t ORDER BY a")
        db.close()
        return out
    want = [(1,), (2,), (3,)] if expect_third_row else [(1,), (2,)]
    assert _both(tmp_path, scenario) == want


def test_tick_restored_from_checkpoint_cursor_after_gc(tmp_path):
    def scenario(pkg, d):
        db = PKGS[pkg](d)
        c = db.connect()
        c.execute("CREATE TABLE t (a INT)")
        c.execute("INSERT INTO t VALUES (1)")
        c.execute("VACUUM t")
        db.close()
        db2 = PKGS[pkg](d)
        db2.connect().execute("INSERT INTO t VALUES (2)")
        db2.close()
        db3 = PKGS[pkg](d)
        out = _rows(db3, "SELECT a FROM t ORDER BY a")
        db3.close()
        return out
    assert _both(tmp_path, scenario) == [(1,), (2,)]


def test_recreated_table_does_not_resurrect_old_wal(tmp_path):
    def scenario(pkg, d):
        db = PKGS[pkg](d)
        c = db.connect()
        c.execute("CREATE TABLE t (a INT)")
        c.execute("INSERT INTO t VALUES (1)")
        c.execute("DROP TABLE t")
        c.execute("CREATE TABLE t (a INT)")
        db.close()
        db2 = PKGS[pkg](d)
        out = _rows(db2, "SELECT count(*) FROM t")
        db2.close()
        return out
    assert _both(tmp_path, scenario) == [(0,)]


def test_append_after_torn_tail_survives_next_recovery(tmp_path):
    def scenario(pkg, d):
        db = PKGS[pkg](d)
        c = db.connect()
        c.execute("CREATE TABLE t (a INT)")
        c.execute("INSERT INTO t VALUES (1)")
        db.close()
        wal_dir = os.path.join(d, "wal")
        seg = sorted(f for f in os.listdir(wal_dir) if f.endswith(".wal"))[-1]
        with open(os.path.join(wal_dir, seg), "ab") as f:
            f.write(b"\xff\xff\xff\x7fgarbage-torn-frame")
        db2 = PKGS[pkg](d)
        db2.connect().execute("INSERT INTO t VALUES (2)")
        db2.close()
        db3 = PKGS[pkg](d)
        out = _rows(db3, "SELECT a FROM t ORDER BY a")
        db3.close()
        return out
    assert _both(tmp_path, scenario) == [(1,), (2,)]


def test_drop_schema_alter_drop_index_and_upsert_survive_restart(tmp_path):
    def scenario(pkg, d):
        db = PKGS[pkg](d)
        c = db.connect()
        c.execute("CREATE SCHEMA s2")
        c.execute("CREATE TABLE s2.t (a INT)")
        c.execute("INSERT INTO s2.t VALUES (1)")
        c.execute("DROP SCHEMA s2 CASCADE")
        c.execute("CREATE TABLE t (a INT)")
        c.execute("INSERT INTO t VALUES (1)")
        c.execute("ALTER TABLE t ADD COLUMN note TEXT")
        c.execute("UPDATE t SET note = 'hello' WHERE a = 1")
        c.execute("ALTER TABLE t RENAME TO t2")
        c.execute("CREATE TABLE ix (a INT)")
        c.execute("CREATE INDEX MyIdx ON ix USING btree (a)")
        c.execute("DROP INDEX MYIDX")
        c.execute("CREATE TABLE up (id INT PRIMARY KEY, v TEXT)")
        c.execute("INSERT INTO up VALUES (1, 'a')")
        c.execute("INSERT INTO up VALUES (1, 'b'), (2, 'c') "
                  "ON CONFLICT (id) DO UPDATE SET v = excluded.v")
        db.close()
        db2 = PKGS[pkg](d)
        out = ("s2" in db2.schemas,
               _rows(db2, "SELECT a, note FROM t2"),
               bool(getattr(db2.schemas["main"].tables["ix"], "indexes",
                            {})),
               sorted(_rows(db2, "SELECT id, v FROM up")))
        db2.close()
        return out
    assert _both(tmp_path, scenario) == (
        False, [(1, "hello")], False, [(1, "b"), (2, "c")])


def test_async_drop_tombstones_and_maintenance_gc(tmp_path):
    def scenario(pkg, d):
        if pkg == "port":
            from serenedb_tpu_torch.storage.maintenance import \
                MaintenanceManager
        else:
            from serenedb_tpu.storage.maintenance import MaintenanceManager
        db = PKGS[pkg](d)
        c = db.connect()
        c.execute("CREATE TABLE victim (a INT)")
        c.execute("INSERT INTO victim VALUES (1), (2)")
        c.execute("VACUUM")
        tdir = os.path.join(d, "tables")

        def listing(suffix):
            return sorted(f for f in os.listdir(tdir) if f.endswith(suffix))
        snaps = listing(".parquet")
        c.execute("DROP TABLE victim")
        dropped, live = listing(".dropped"), listing(".parquet")
        c.execute("CREATE TABLE v2 (a INT)")
        c.execute("INSERT INTO v2 VALUES (1)")
        c.execute("VACUUM")
        c.execute("DROP TABLE v2")
        ran = MaintenanceManager(db).run_once()
        left = listing(".dropped")
        db.close()
        with open(os.path.join(tdir, "999.parquet.dropped"), "w") as f:
            f.write("x")
        db2 = PKGS[pkg](d)
        after_boot = listing(".dropped")
        db2.close()
        return (len(snaps), len(dropped), live, ran, left, after_boot)
    assert _both(tmp_path, scenario) == (1, 1, [], True, [], [])


# -- the inputs of tests/test_ingest_stream.py ------------------------------------

def _corpus(n, seed=3):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta", "omega", "Sigma", "nu",
             "stream", "ingest", "merge", "segment", "wal", "fsync"]
    docs = []
    for i in range(n):
        if i % 17 == 5:
            docs.append(None)
            continue
        k = int(rng.integers(1, 12))
        docs.append(" ".join(rng.choice(vocab, size=k)))
    return docs


FI_ARRAYS = ("doc_freq", "offsets", "post_docs", "post_tfs", "pos_offsets",
             "positions", "norms", "block_max_tf", "block_offsets")


def _assert_field_index_equal(a, b):
    assert [str(t) for t in a.terms] == [str(t) for t in b.terms]
    for name in FI_ARRAYS:
        av, bv = getattr(a, name), getattr(b, name)
        assert av.dtype == bv.dtype, name
        assert np.array_equal(av, bv), name
    assert a.total_tokens == b.total_tokens


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("analyzer", ["text", "simple"])
def test_parallel_analysis_bit_identical(workers, analyzer):
    """The port's chunked, parallel build (native chunks for `simple`)
    equals its serial build and the reference's, bit for bit."""
    docs = _corpus(700)
    ref = rbuild(list(docs), rget_analyzer(analyzer))
    an = get_analyzer(analyzer)
    with _globals(serene_parallel_ingest=False):
        serial = build_field_index(list(docs), an)
    _assert_field_index_equal(serial, ref)
    for on in (True, False):
        with _globals(serene_parallel_ingest=on,
                      serene_ingest_chunk_docs=64, serene_workers=workers):
            out = build_field_index_auto(list(docs), an)
        _assert_field_index_equal(out, serial)


@pytest.mark.parametrize("group_commit", [True, False])
def test_wal_recovery_across_group_commit_windows(tmp_path, group_commit):
    """Four writers; every commit of every group-commit window replays
    after a restart, in both packages."""
    def scenario(pkg, d):
        with _globals(serene_group_commit=group_commit):
            db = PKGS[pkg](d)
            db.connect().execute("CREATE TABLE t (w INT, i INT)")
            errs = []

            def writer(w):
                conn = db.connect()
                try:
                    for i in range(15):
                        conn.execute(f"INSERT INTO t VALUES ({w}, {i})")
                except Exception as e:  # pragma: no cover - fails test
                    errs.append(e)
            ths = [threading.Thread(target=writer, args=(w,))
                   for w in range(4)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=60)
            assert not errs
            db.close()
            db2 = PKGS[pkg](d)
            out = (_rows(db2, "SELECT count(*) FROM t"),
                   _rows(db2, "SELECT w, count(*) FROM t GROUP BY w "
                              "ORDER BY w"),
                   _rows(db2, "SELECT w, i FROM t ORDER BY w, i"))
            db2.close()
            return out
    out = _both(tmp_path, scenario)
    assert out[0] == [(60,)]
    assert out[1] == [(w, 15) for w in range(4)]


def test_parquet_snapshots_cross_packages(tmp_path):
    """A snapshot written by either package reads back equal in both,
    serially and through the parallel column build."""
    from serenedb_tpu.columnar import arrow_io as rio
    from serenedb_tpu_torch.columnar import arrow_io as pio
    rng = np.random.default_rng(11)
    n = 4000
    data = {
        "i": [int(x) if x % 7 else None for x in rng.integers(0, 1e6, n)],
        "f": [float(x) for x in rng.random(n)],
        "s": [None if x % 13 == 0 else f"doc-{x % 97}"
              for x in rng.integers(0, 1e6, n)],
        "b": [bool(x % 2) for x in rng.integers(0, 2, n)],
    }
    for name, (io, bcls) in {"port": (pio, Batch),
                             "ref": (rio, RBatch)}.items():
        p = str(tmp_path / f"{name}.parquet")
        io.write_parquet_snapshot(p, bcls.from_pydict(data))
        for reader in (pio, rio):
            for on in (True, False):
                with _globals(serene_parallel_ingest=on, serene_workers=4):
                    assert reader.read_parquet_snapshot(p).to_pydict() \
                        == data


def test_ingest_metrics_move_with_the_durable_write_path(tmp_path):
    from serenedb_tpu_torch.obs.export import stats_json
    from serenedb_tpu_torch.utils import metrics as m
    s0 = m.REGISTRY.snapshot()
    db = Database(str(tmp_path / "data"), device="cpu")
    c = db.connect()
    c.execute("CREATE TABLE docs (id INT, body TEXT)")
    c.execute("INSERT INTO docs VALUES (1, 'alpha one'), (2, 'beta two')")
    c.execute("CREATE INDEX ON docs USING inverted (body)")
    c.execute("INSERT INTO docs VALUES (3, 'alpha three')")
    assert c.execute("SELECT count(*) FROM docs WHERE body @@ 'alpha'"
                     ).scalar() == 2
    s1 = m.REGISTRY.snapshot()
    assert s1.get("IngestDocs", 0) - s0.get("IngestDocs", 0) == 3
    assert s1.get("WalFsyncs", 0) > s0.get("WalFsyncs", 0)
    assert s1.get("WalCommits", 0) > s0.get("WalCommits", 0)
    assert stats_json()["ingest"]["wal_fsync"]["count"] > 0
    db.close()


# -- a data directory crosses between the packages ----------------------------

SETUP = [
    "CREATE TABLE t (a INT, s TEXT DEFAULT 'dflt', f DOUBLE, "
    "ts TIMESTAMP, d DATE, b BOOLEAN)",
    "INSERT INTO t VALUES (1, 'x', 1.5, '2024-01-02 03:04:05', "
    "'2024-01-02', true), (2, NULL, NULL, NULL, NULL, NULL), "
    "(3, 'z', -2.25, '1999-12-31 23:59:59', '1999-12-31', false)",
    "CREATE TABLE docs (id INT, body TEXT)",
    "INSERT INTO docs VALUES (1, 'hello world'), (2, 'other things'), "
    "(3, 'hello again world')",
    "CREATE INDEX ON docs USING inverted (body)",
    "VACUUM",                           # parquet snapshots
    "INSERT INTO t (a, f) VALUES (4, 4.5)",    # the WAL's tail
    "DELETE FROM t WHERE a = 3",
    "UPDATE t SET f = 9.0 WHERE a = 1",
    "INSERT INTO docs VALUES (4, 'hello there')",
    "CREATE VIEW v AS SELECT a, s FROM t WHERE a > 1",
]
READS = [
    "SELECT a, s, f, ts, d, b FROM t ORDER BY a",
    "SELECT a, s FROM v ORDER BY a",
    "SELECT id FROM docs WHERE body @@ 'hello' ORDER BY id",
    "SELECT id, bm25(body) AS s FROM docs WHERE body @@ 'hello world' "
    "ORDER BY s DESC, id",
]
MORE = ["INSERT INTO t (a) VALUES (5)",
        "INSERT INTO docs VALUES (5, 'world news')"]


def _reads(db):
    c = db.connect()
    return [c.execute(q).rows() for q in READS]


def _same_reads(a, b):
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                if isinstance(u, float) and isinstance(v, float):
                    assert u == pytest.approx(v, rel=1e-5, abs=1e-6)
                else:
                    assert u == v


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_data_directory_crosses_packages(tmp_path, writer, reader):
    """A directory written by `writer` (snapshots, a WAL tail, a view, a
    DEFAULT, an inverted index) opens in `reader` with equal rows; what
    `reader` then writes opens again in `writer`."""
    d = str(tmp_path / "data")
    db = PKGS[writer](d)
    c = db.connect()
    for st in SETUP:
        c.execute(st)
    before = _reads(db)
    db.close()
    assert os.listdir(os.path.join(d, "tables"))
    assert any(os.path.getsize(os.path.join(d, "wal", f)) > 8
               for f in os.listdir(os.path.join(d, "wal")))

    db = PKGS[reader](d)
    _same_reads(_reads(db), before)
    c = db.connect()
    for st in MORE:
        c.execute(st)
    after = _reads(db)
    db.close()
    assert after[0][-1][:2] == (5, "dflt")   # the DEFAULT crossed too

    db = PKGS[writer](d)
    _same_reads(_reads(db), after)
    db.close()


def test_acknowledged_writes_survive_a_crash(tmp_path):
    """crash() abandons the database without a flush or a checkpoint;
    every acknowledged commit is read back, in both packages."""
    def scenario(pkg, d):
        db = PKGS[pkg](d)
        c = db.connect()
        for st in SETUP:
            c.execute(st)
        for st in MORE:
            c.execute(st)
        c.execute("BEGIN")
        c.execute("INSERT INTO t (a) VALUES (6)")
        c.execute("COMMIT")
        want = _reads(db)
        db.crash()
        db2 = PKGS[pkg](d)
        got = _reads(db2)
        db2.close()
        _same_reads(got, want)
        return [[r[:2] for r in rows] for rows in got[:3]]
    _both(tmp_path, scenario)


# -- the port without pyarrow -----------------------------------------------------

NO_PYARROW_SCRIPT = r"""
import sys
sys.modules["pyarrow"] = None       # `import pyarrow` raises ImportError
sys.path.insert(0, {repo!r})
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.errors import SqlError
c = Database(device="cpu").connect()
c.execute("CREATE TABLE docs (id INT, body TEXT)")
c.execute("BEGIN")
c.execute("INSERT INTO docs VALUES (1, 'hello world'), (2, 'other')")
c.execute("COMMIT")
c.execute("CREATE INDEX ON docs USING inverted (body)")
rows = c.execute("SELECT id FROM docs WHERE body @@ 'hello'").rows()
assert rows == [(1,)], rows
for sql in ("SELECT * FROM read_parquet({parquet!r})",):
    try:
        c.execute(sql)
        raise SystemExit("read_parquet ran without pyarrow")
    except SqlError as e:
        assert "pyarrow" in e.message, e.message
try:
    Database({datadir!r}, device="cpu")
    raise SystemExit("Database(path) opened without pyarrow")
except SqlError as e:
    assert "pyarrow" in e.message, e.message
import os
assert not os.path.exists({datadir!r})
assert sys.modules["pyarrow"] is None
print("NO-PYARROW-OK")
"""


def test_in_memory_port_runs_without_pyarrow(tmp_path):
    """With pyarrow blocked, an in-memory database still commits a
    transaction, builds an inverted index and searches it; Database(path)
    and read_parquet fail with a message naming pyarrow."""
    p = tmp_path / "x.parquet"
    p.write_bytes(b"")
    script = NO_PYARROW_SCRIPT.format(repo=REPO, parquet=str(p),
                                      datadir=str(tmp_path / "data"))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "NO-PYARROW-OK" in r.stdout


# -- the device cache across a close and a reopen ---------------------------------

def test_reopened_tables_never_see_the_closed_ones_device_entries(
        tmp_path, monkeypatch):
    """Two boots of one data directory give tables at the same (version,
    epoch) with other rows. The reopened StoredTable takes a fresh
    provider token, so the device tier's cached columns and the posting
    pool's pages of the closed one never answer for it."""
    from serenedb_tpu_torch.cache.result import _provider_token
    from serenedb_tpu_torch.exec.device_pipeline import DEVICE_CACHE
    from serenedb_tpu_torch.ops import bm25 as pbm25
    from serenedb_tpu_torch.search.posting_pool import POOL
    monkeypatch.setattr(pbm25, "DENSE_HBM_BUDGET", 0)
    d = str(tmp_path / "data")
    queries = [
        "SELECT a.g, count(*), sum(b.v) FROM t a JOIN t b ON a.id = b.id "
        "GROUP BY a.g ORDER BY a.g",
        "SELECT g, count(*), sum(v) FROM t GROUP BY g ORDER BY g",
        "SELECT count(*), sum(v) FROM t WHERE v > 2",
        "SELECT id, bm25(body) AS s FROM t WHERE body @@ 'alpha' "
        "ORDER BY s DESC, id LIMIT 3",
    ]

    def load(rows):
        db = Database(d, device="cpu")
        c = db.connect()
        if "t" not in db.schemas["main"].tables:
            c.execute("CREATE TABLE t (id INT, g INT, v INT, body TEXT)")
            c.execute("CREATE INDEX ON t USING inverted (body)")
        c.execute("DELETE FROM t")
        c.execute("INSERT INTO t VALUES " + ", ".join(
            f"({i}, {g}, {v}, '{b}')" for i, g, v, b in rows))
        c.execute("VACUUM")
        db.close()

    def boot_and_read():
        db = Database(d, device="cpu")
        c = db.connect()
        t = db.schemas["main"].tables["t"]
        pin = (_provider_token(t), t.data_version,
               getattr(t, "mutation_epoch", 0))
        c.execute("SET serene_device = 'gpu'")
        got = [c.execute(q).rows() for q in queries]
        c.execute("SET serene_device = 'cpu'")
        host = [c.execute(q).rows() for q in queries]
        db.close()
        return pin, got, host

    with _globals(serene_posting_pool=True, serene_result_cache=False):
        load([(1, 1, 1, "alpha beta"), (2, 1, 2, "alpha"),
              (3, 2, 3, "gamma")])
        pin1, got1, host1 = boot_and_read()
        cached = DEVICE_CACHE.stats()["entries"]
        pooled = POOL.stats()["resident_terms"]
        load([(1, 2, 5, "gamma"), (2, 3, 7, "alpha alpha"),
              (3, 3, 9, "beta")])
        pin2, got2, host2 = boot_and_read()
    assert cached > 0 and pooled > 0     # both tiers held entries
    assert pin1[1:] == pin2[1:]          # the same publication stamp...
    assert pin1[0] != pin2[0]            # ...under another token
    assert got1 == host1 and got2 == host2
    assert all(a != b for a, b in zip(got1, got2))


def test_an_older_checkpoint_never_replaces_a_newer_one(tmp_path):
    """A VACUUM and the maintenance thread may checkpoint one table at
    once: the port's store takes them one at a time, and one captured at
    an older tick than the table's cursor writes nothing (its snapshot
    would lack commits the WAL no longer holds)."""
    from serenedb_tpu_torch.storage.maintenance import MaintenanceManager
    d = str(tmp_path / "data")
    db = Database(d, device="cpu")
    c = db.connect()
    c.execute("CREATE TABLE t (a INT)")
    c.execute("INSERT INTO t VALUES (1)")
    t = db.schemas["main"].tables["t"]
    old_batch, old_tick = t.full_batch(), db.store.ticks.current()
    c.execute("INSERT INTO t VALUES (2)")
    c.execute("VACUUM t")
    new_tick = db.store.meta["tables"][t.key]["checkpoint_tick"]
    assert new_tick > old_tick
    db.store.checkpoint_table(t.key, t.table_id, old_batch, old_tick)
    assert db.store.meta["tables"][t.key]["checkpoint_tick"] == new_tick
    mm = MaintenanceManager(db, checkpoint_interval=0.0)
    threads = [threading.Thread(target=mm.run_once) for _ in range(3)]
    for th in threads:
        th.start()
    c.execute("VACUUM t")
    for th in threads:
        th.join()
    db.close()
    db2 = Database(d, device="cpu")
    assert _rows(db2, "SELECT a FROM t ORDER BY a") == [(1,), (2,)]
    db2.close()


def test_stop_waits_out_a_maintenance_pass(tmp_path, monkeypatch):
    """close() returns only after the maintenance thread's pass in flight
    ends: nothing writes the data directory once it is released."""
    import time as _time
    from serenedb_tpu_torch.storage import maintenance
    db = Database(str(tmp_path / "data"), device="cpu")
    started, done = threading.Event(), threading.Event()
    real = maintenance.MaintenanceManager._run_passes

    def slow(self):
        started.set()
        _time.sleep(0.5)
        out = real(self)
        done.set()
        return out
    monkeypatch.setattr(maintenance.MaintenanceManager, "_run_passes", slow)
    db.maintenance._wake.set()
    assert started.wait(10)
    db.close()
    assert done.is_set()


def test_a_string_column_of_millions_of_rows_round_trips(tmp_path):
    """pyarrow hands a numpy unicode array of a few million strings back
    in chunks, which a RecordBatch cannot take (the copied codec failed
    there on phase 7's 10,000,000-row `hits` table); the port decodes
    dictionary-coded strings through Arrow, and the WAL record and the
    snapshot round-trip in both packages."""
    from serenedb_tpu.columnar import arrow_io as rio
    from serenedb_tpu_torch.columnar import arrow_io as pio
    from serenedb_tpu_torch.columnar import dtypes as dt
    from serenedb_tpu_torch.columnar.column import Column
    n = 4_000_000
    rng = np.random.default_rng(2)
    words = np.asarray([""] + [f"phrase {i}" for i in range(100_000)],
                       dtype=object)
    codes = rng.integers(0, len(words), n).astype(np.int32)
    valid = rng.random(n) > 0.1
    b = Batch(["s", "i"], [Column(dt.VARCHAR, codes, valid, words),
                           Column.from_numpy(np.arange(n))])
    want = np.where(valid, words[codes], None)
    for io in (pio, rio):
        back = io.bytes_to_batch(pio.batch_to_bytes(b)).column("s")
        assert np.array_equal(back.validity, valid)
        assert (np.where(back.validity, back.dictionary[back.data], None)
                == want).all()
    p = str(tmp_path / "big.parquet")
    pio.write_parquet_snapshot(p, b)
    back = rio.read_parquet_snapshot(p).column("s")
    assert (np.where(back.validity, back.dictionary[back.data], None)
            == want).all()


def test_maintenance_refreshes_indexes_on_the_database_device(tmp_path):
    """The maintenance thread has no statement to take a device from:
    its refresh builds on the database's own (here the CPU; without it,
    the default `cuda:0`, which this machine lacks), under the per-table
    rebuild lock the query path's read-repair takes."""
    import torch
    db = Database(str(tmp_path / "data"), device="cpu")
    c = db.connect()
    c.execute("CREATE TABLE docs (id INT, body TEXT)")
    c.execute("INSERT INTO docs VALUES (1, 'alpha'), (2, 'beta')")
    c.execute("CREATE INDEX ON docs USING inverted (body)")
    c.execute("INSERT INTO docs VALUES (3, 'alpha gamma')")
    t = db.schemas["main"].tables["docs"]
    idx = next(iter(t.indexes.values()))
    assert idx.data_version != t.data_version
    errs = []

    def refresh():
        try:
            db.maintenance.run_once()
        except Exception as e:  # pragma: no cover - fails the test
            errs.append(e)
    th = threading.Thread(target=refresh)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and not errs, errs
    idx = next(iter(t.indexes.values()))
    assert idx.data_version == t.data_version
    for seg in idx.searchers["body"].segments:
        s = seg[0] if isinstance(seg, tuple) else seg
        assert getattr(s, "device", torch.device("cpu")).type == "cpu"
    assert _rows(db, "SELECT id FROM docs WHERE body @@ 'alpha' "
                     "ORDER BY id") == [(1,), (3,)]
    db.close()
