"""Statements that once failed on the port with ModuleNotFoundError,
against the JAX package, on the CPU.

Each statement runs through both packages' `Database.execute`; the port
must give the reference's rows, or its SQLSTATE. The last test resolves
every relative import of the port to a module and a name that the port
holds, so a statement can no longer reach a module that was never copied.
"""

import ast
import os

import numpy as np
import pytest

from serenedb_tpu.engine import Database as RefDatabase
from serenedb_tpu_torch.engine import Database

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "serenedb_tpu_torch")


def _pair(*setup):
    conns = []
    for db in (RefDatabase(), Database(device="cpu")):
        c = db.connect()
        for st in setup:
            c.execute(st)
        conns.append(c)
    return conns


def _same(conns, q):
    ref, port = conns
    assert port.execute(q).rows() == ref.execute(q).rows(), q


def _sqlstate(conn, q):
    with pytest.raises(Exception) as e:
        conn.execute(q)
    return getattr(e.value, "sqlstate", None), type(e.value).__name__


PK_SETUP = ("CREATE TABLE t (id INT PRIMARY KEY, a INT, s VARCHAR)",
            "INSERT INTO t VALUES (1, 10, 'x'), (2, 20, 'y'), (3, 5, 'z')")


def test_primary_key_insert():
    conns = _pair(*PK_SETUP)
    _same(conns, "SELECT * FROM t ORDER BY id")
    _same(conns, "SELECT a FROM t WHERE id = 2")


def test_primary_key_conflict_sqlstate():
    ref, port = _pair(*PK_SETUP)
    q = "INSERT INTO t VALUES (2, 99, 'dup')"
    assert _sqlstate(port, q) == _sqlstate(ref, q) == ("23505", "SqlError")


def test_update_of_a_primary_key_table():
    conns = _pair(*PK_SETUP)
    for c in conns:
        c.execute("UPDATE t SET a = a * 3 WHERE id >= 2")
        c.execute("UPDATE t SET id = 7 WHERE id = 1")
    _same(conns, "SELECT * FROM t ORDER BY id")
    _same(conns, "SELECT s FROM t WHERE id = 7")


def test_insert_on_conflict():
    conns = _pair(*PK_SETUP)
    for c in conns:
        c.execute("INSERT INTO t VALUES (3, 99, 'w'), (4, 1, 'n') "
                  "ON CONFLICT (id) DO UPDATE SET a = excluded.a")
        c.execute("INSERT INTO t VALUES (1, 0, 'q') ON CONFLICT DO NOTHING")
    _same(conns, "SELECT * FROM t ORDER BY id")


def test_missing_relation_sqlstate():
    ref, port = _pair()
    q = "SELECT * FROM nosuch"
    assert _sqlstate(port, q) == _sqlstate(ref, q) == ("42P01", "SqlError")


@pytest.mark.parametrize("q", [
    "SELECT table_name, column_name, data_type FROM "
    "information_schema.columns WHERE table_name = 't' ORDER BY "
    "ordinal_position",
    "SELECT relname, relkind FROM pg_catalog.pg_class WHERE relname = 't'",
])
def test_catalog_queries(q):
    _same(_pair(*PK_SETUP), q)


def test_window_functions():
    rng = np.random.default_rng(31)
    vals = rng.integers(0, 5, 40)
    conns = _pair("CREATE TABLE w (g INT, v INT)",
                  "INSERT INTO w VALUES " + ", ".join(
                      f"({i % 4}, {int(v)})" for i, v in enumerate(vals)))
    _same(conns, "SELECT g, v, row_number() OVER (PARTITION BY g ORDER BY "
                 "v, g), rank() OVER (ORDER BY v), sum(v) OVER (PARTITION "
                 "BY g) FROM w ORDER BY g, v")


def test_copy_and_index_progress_paths(tmp_path):
    """CREATE INDEX and COPY reach utils.progress; binary COPY reaches
    columnar.pgcopy: both packages write the same bytes and read them
    back into the same rows."""
    conns = _pair(*PK_SETUP, "CREATE INDEX ta ON t (a)",
                  "CREATE TABLE u (id INT, a INT, s VARCHAR)")
    _same(conns, "SELECT id FROM t WHERE a = 5")
    files = []
    for name, c in zip(("ref", "port"), conns):
        f = tmp_path / f"{name}.bin"
        c.execute(f"COPY t TO '{f}' (FORMAT binary)")
        c.execute(f"COPY u FROM '{f}' (FORMAT binary)")
        files.append(f.read_bytes())
    assert files[0] == files[1]
    _same(conns, "SELECT * FROM u ORDER BY id")


def test_stubbed_relations_and_sources_say_not_ported(tmp_path):
    """The stubs are gone: sdb_device and sdb_device_cache answer with the
    reference's columns; the file sources are ported: read_csv and
    read_parquet give the reference's rows on a file COPY'd out, and its
    SQLSTATE on a missing one."""
    port = Database(device="cpu").connect()
    # the posting pool is ported: its relation answers
    port.execute("SELECT * FROM sdb_posting_pool").rows()
    ref = RefDatabase().connect()
    for rel in ("sdb_device", "sdb_device_cache"):
        q = f"SELECT * FROM {rel}"
        assert port.execute(q).names == ref.execute(q).names, rel
        port.execute(q).rows()
    conns = _pair(*PK_SETUP)
    conns[0].execute(f"COPY t TO '{tmp_path}/t.csv' (FORMAT csv, "
                     "HEADER true)")
    conns[0].execute(f"COPY t TO '{tmp_path}/t.parquet' (FORMAT parquet)")
    for fn, ext in (("read_csv", "csv"), ("read_parquet", "parquet")):
        _same(conns, f"SELECT * FROM {fn}('{tmp_path}/t.{ext}') ORDER BY id")
        q = f"SELECT * FROM {fn}('{tmp_path}/x.{ext}')"
        assert _sqlstate(conns[1], q) == _sqlstate(conns[0], q) == \
            ("58P01", "SqlError")


def _resolve(path, node):
    """The module a relative `from` import names, and the names it takes."""
    pkg = os.path.relpath(os.path.dirname(path), REPO).split(os.sep)
    base = pkg[:len(pkg) - (node.level - 1)]
    mod = base + (node.module.split(".") if node.module else [])
    return mod, [a.name for a in node.names]


def _module_file(parts):
    p = os.path.join(REPO, *parts)
    for cand in (p + ".py", os.path.join(p, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


def _defined_names(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def test_every_relative_import_resolves_inside_the_port():
    missing = []
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            for node in ast.walk(ast.parse(open(path).read())):
                if not isinstance(node, ast.ImportFrom) or not node.level:
                    continue
                mod, names = _resolve(path, node)
                target = _module_file(mod)
                where = f"{os.path.relpath(path, REPO)}:{node.lineno}"
                if target is None:
                    missing.append(f"{where} {'.'.join(mod)}")
                    continue
                have = _defined_names(target)
                for n in names:
                    if n != "*" and n not in have and \
                            _module_file(mod + [n]) is None:
                        missing.append(f"{where} {'.'.join(mod)}.{n}")
    assert not missing, missing
