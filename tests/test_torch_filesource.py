"""The port's file sources (`read_csv`, `read_parquet`) against the JAX
package's, on the CPU.

Files are written in the test's tmp_path (parquet through `COPY ... TO`
or pyarrow, csv as text); the same statements run through both packages'
`Database.execute` and must give equal rows, or the same SQLSTATE. The
remote-URL branch is copied from the reference and not driven here: it
needs a network.
"""

import pytest

from serenedb_tpu.engine import Database as RDatabase
from serenedb_tpu.errors import SqlError as RSqlError
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.errors import SqlError


@pytest.fixture
def conns():
    return [RDatabase().connect(), Database(device="cpu").connect()]


def _same(conns, sql):
    ref, port = (c.execute(sql).rows() for c in conns)
    assert port == ref
    return port


def _same_error(conns, sql):
    states = []
    for c, err in zip(conns, (RSqlError, SqlError)):
        with pytest.raises(err) as e:
            c.execute(sql)
        states.append(e.value.sqlstate)
    assert states[0] == states[1]
    return states[1]


def _write_parquet(conn, tmp_path, name, rows):
    conn.execute(f"CREATE TABLE _w_{name} (id INT, v DOUBLE)")
    vals = ", ".join(f"({a}, {b})" for a, b in rows)
    conn.execute(f"INSERT INTO _w_{name} VALUES {vals}")
    p = str(tmp_path / f"{name}.parquet")
    conn.execute(f"COPY _w_{name} TO '{p}' WITH (FORMAT parquet)")
    conn.execute(f"DROP TABLE _w_{name}")
    return p


@pytest.mark.parametrize("writer", [0, 1], ids=["ref_file", "port_file"])
def test_read_parquet_single_and_view(conns, tmp_path, writer):
    """A file COPY'd out by either package reads equal in both, directly
    and through a view."""
    p = _write_parquet(conns[writer], tmp_path, "one", [(1, 1.5), (2, 2.5)])
    assert _same(conns, f"SELECT id, v FROM read_parquet('{p}') "
                        "ORDER BY id") == [(1, 1.5), (2, 2.5)]
    for c in conns:
        c.execute(f"CREATE VIEW pv AS SELECT * FROM read_parquet('{p}')")
    assert _same(conns, "SELECT count(*) FROM pv") == [(2,)]
    assert _same(conns, "SELECT sum(v) FROM pv WHERE id > 1") == [(2.5,)]


def test_read_parquet_glob_union_and_errors(conns, tmp_path):
    _write_parquet(conns[0], tmp_path, "part1", [(1, 1.0)])
    _write_parquet(conns[1], tmp_path, "part2", [(2, 2.0), (3, 3.0)])
    g = str(tmp_path / "part*.parquet")
    assert _same(conns, f"SELECT id FROM read_parquet('{g}') "
                        "ORDER BY id") == [(1,), (2,), (3,)]
    assert _same_error(
        conns, f"SELECT * FROM read_parquet('{tmp_path}/nope*.parquet')"
    ) == "58P01"
    assert _same_error(
        conns, f"SELECT * FROM read_parquet('{tmp_path}/missing.parquet')"
    ) == "58P01"


def test_glob_type_mismatch(conns, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    pq.write_table(pa.table({"id": [1]}), str(tmp_path / "t1.parquet"))
    pq.write_table(pa.table({"id": ["x"]}), str(tmp_path / "t2.parquet"))
    assert _same_error(
        conns, f"SELECT * FROM read_parquet('{tmp_path}/t*.parquet')"
    ) == "42P16"


def test_read_parquet_pinned_and_types(conns, tmp_path):
    """pyarrow's own types (strings with NULLs, bools, timestamps, f32)
    read back equal; a second file under one glob is a union."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import datetime as _dt
    pq.write_table(pa.table({
        "s": ["a", None, "c"], "b": [True, False, None],
        "ts": [_dt.datetime(2024, 1, 2, 3, 4, 5), None,
               _dt.datetime(1999, 12, 31)],
        "f": pa.array([1.5, None, -0.25], type=pa.float32()),
        "i": pa.array([1, 2, None], type=pa.int32())}),
        str(tmp_path / "typed.parquet"))
    _same(conns, f"SELECT * FROM read_parquet('{tmp_path}/typed.parquet') "
                 "ORDER BY i")
    _same(conns, f"SELECT count(*), count(s), min(f), max(ts) FROM "
                 f"read_parquet('{tmp_path}/typed.parquet')")


def test_read_csv_inference_and_header(conns, tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("id,name,score\n1,ann,1.5\n2,bob,\n3,cy,3.25\n")
    assert _same(conns, f"SELECT id, name, score FROM read_csv('{p}') "
                        "ORDER BY id") == [(1, "ann", 1.5), (2, "bob", None),
                                           (3, "cy", 3.25)]
    q = tmp_path / "raw.csv"
    q.write_text("10,x\n20,y\n")
    assert _same(conns, f"SELECT column0, column1 FROM read_csv('{q}') "
                        "ORDER BY column0") == [(10, "x"), (20, "y")]
    assert _same(conns, f"SELECT count(*) FROM read_csv('{q}', true)") \
        == [(1,)]


def test_read_csv_bool_delim_glob_and_header_only(conns, tmp_path):
    p = tmp_path / "flags.tsv"
    p.write_text("a\tb\ntrue\t1\nfalse\t2\n")
    assert _same(conns, f"SELECT a, b FROM read_csv('{p}', true, E'\\t') "
                        "ORDER BY b") == [(True, 1), (False, 2)]
    (tmp_path / "m1.csv").write_text("k,v\n1,a\n2,b\n")
    (tmp_path / "m2.csv").write_text("k,v\n3,c\n")
    assert _same(conns, f"SELECT k, v FROM read_csv('{tmp_path}/m*.csv') "
                        "ORDER BY k") == [(1, "a"), (2, "b"), (3, "c")]
    e = tmp_path / "empty.csv"
    e.write_text("a,b\n")
    assert _same(conns, f"SELECT a, b FROM read_csv('{e}', true)") == []
    assert _same_error(conns, f"SELECT * FROM read_csv('{tmp_path}/no.csv')"
                       ) == "58P01"


def test_copy_csv_out_reads_back(conns, tmp_path):
    """The corpus's zero-ETL round trip: COPY ... TO csv by either
    package, read_csv by both, aggregates and a join over file sources."""
    for i, c in enumerate(conns):
        c.execute("CREATE TABLE src (id INT, name TEXT, score DOUBLE)")
        c.execute("INSERT INTO src VALUES (1, 'ann', 9.5), "
                  "(2, 'bob', 7.25), (3, 'cat', NULL)")
        c.execute(f"COPY src TO '{tmp_path}/z{i}.csv' "
                  "(FORMAT csv, HEADER true)")
    assert (tmp_path / "z0.csv").read_bytes() == \
        (tmp_path / "z1.csv").read_bytes()
    f = f"{tmp_path}/z1.csv"
    assert _same(conns, f"SELECT avg(score) FROM read_csv('{f}')") \
        == [(8.375,)]
    _same(conns, f"SELECT a.name, b.name FROM read_csv('{f}') a JOIN "
                 f"read_csv('{f}') b ON a.id = b.id - 1 ORDER BY a.id")
