"""tests/test_pgwire.py against the port, on the CPU (see tests/torch_port.py),
and the port's wire held to the reference's byte for byte.

`test_transcript_matches_reference` sends one message sequence to a
reference `PgServer` and to a port `PgServer` in each of the three modes
of tests/test_sqllogic_wire.py (simple, extended text, extended binary
with a binary result format for every OID that file's client decodes),
and compares the RowDescription, DataRow, CommandComplete, and error
SQLSTATE messages the two send back. The backend key is not among them.
"""

import struct

import pytest

from serenedb_tpu.engine import Database as RefDatabase
from serenedb_tpu_torch.engine import Connection, Database
from tests.test_pgwire import _run_pg_server as _run_ref_server
from tests.test_sqllogic_wire import _BINARY_OIDS, MODES, WireClient
from tests.torch_port import exported, port_module

globals().update(exported(port_module("test_pgwire")))

#: (sql, [(param OID, text value)]): every OID of _BINARY_OIDS shows in
#: a RowDescription (16 ... 1186) or as a declared parameter (1043)
TRANSCRIPT = [
    ("CREATE TABLE typed (b BOOLEAN, i2 SMALLINT, i4 INT, i8 BIGINT, "
     "f4 REAL, f8 DOUBLE PRECISION, t TEXT, v VARCHAR(12), d DATE, "
     "ts TIMESTAMP, iv INTERVAL)", []),
    ("INSERT INTO typed VALUES (true, 1, 10, 100, 1.5, -2.25, 'alpha', "
     "'va', DATE '1999-12-31', TIMESTAMP '2024-01-02 03:04:05.123456', "
     "INTERVAL '1 day 02:03:04'), (false, -2, 20, -200, -0.5, 3.125, "
     "'beta', 'vb', DATE '2000-01-01', TIMESTAMP '1970-01-01 00:00:00', "
     "INTERVAL '36 hours'), (NULL, NULL, 30, NULL, NULL, NULL, NULL, "
     "NULL, NULL, NULL, NULL)", []),
    ("SELECT * FROM typed ORDER BY i4", []),
    ("SELECT CAST(42 AS OID) AS o, oid FROM pg_namespace "
     "WHERE nspname = 'pg_catalog'", []),
    ("SELECT count(*), sum(i8), avg(f8), min(d), max(ts), max(iv) "
     "FROM typed", []),
    ("SELECT i4 + 1 AS x, upper(t) FROM typed WHERE i4 > 10 ORDER BY x",
     []),
    ("SELECT i4, v FROM typed WHERE v = $1 OR i4 > $2 ORDER BY i4",
     [(1043, "va"), (23, "25")]),
    ("SELECT f8 * $1 AS g, b = $2 AS same FROM typed ORDER BY i4",
     [(701, "2.5"), (16, "true")]),
    ("UPDATE typed SET i8 = i8 + 1 WHERE i4 = 10", []),
    ("DELETE FROM typed WHERE i4 = 30", []),
    ("SELECT i8 FROM typed ORDER BY i4", []),
    ("SELECT nosuch FROM typed", []),
    ("SELECT 1 / 0", []),
]

_CAST = {16: "BOOLEAN", 23: "INT", 701: "DOUBLE PRECISION",
         1043: "VARCHAR"}
_BIN_PARAM = {16: lambda s: b"\x01" if s == "true" else b"\x00",
              23: lambda s: struct.pack("!i", int(s)),
              701: lambda s: struct.pack("!d", float(s)),
              1043: str.encode}


def _inline(sql, params):
    for i in range(len(params), 0, -1):
        oid, text = params[i - 1]
        sql = sql.replace(f"${i}", f"CAST('{text}' AS {_CAST[oid]})")
    return sql


def _read_until_ready(pg, out):
    """The messages up to ReadyForQuery that the comparison keeps; the
    result formats a RowDescription asks for, if one came."""
    oids = None
    while True:
        kind, payload = pg.read_msg()
        if kind == b"T":
            oids = WireClient._row_desc_oids(payload)
        if kind in (b"T", b"D", b"C", b"I", b"n", b"s"):
            out.append((kind, payload))
        elif kind == b"E":
            out.append((kind, _parse_err(payload).get("C")))
        elif kind == b"Z":
            return oids


def _transcript(port, mode):
    pg = RawPg(port)
    out = []
    try:
        for sql, params in TRANSCRIPT:
            if mode == "simple":
                pg.send(b"Q", _inline(sql, params).encode() + b"\x00")
                _read_until_ready(pg, out)
                continue
            binary = mode == "extended-binary"
            pg.send(b"P", b"\x00" + sql.encode() + b"\x00" +
                    struct.pack("!H", len(params)) +
                    b"".join(struct.pack("!I", o) for o, _ in params))
            pg.send(b"D", b"S\x00")
            pg.send(b"S", b"")
            oids = _read_until_ready(pg, out) or []
            fmts = [1 if binary and o in _BINARY_OIDS else 0 for o in oids]
            vals = [_BIN_PARAM[o](t) if binary else t.encode()
                    for o, t in params]
            pg.send(b"B", b"\x00\x00" +
                    struct.pack("!H", 1) + struct.pack("!h", int(binary)) +
                    struct.pack("!H", len(vals)) +
                    b"".join(struct.pack("!i", len(v)) + v for v in vals) +
                    struct.pack("!H", len(fmts)) +
                    b"".join(struct.pack("!h", f) for f in fmts))
            pg.send(b"D", b"P\x00")
            pg.send(b"E", b"\x00" + struct.pack("!I", 0))
            pg.send(b"S", b"")
            _read_until_ready(pg, out)
    finally:
        pg.close()
    return out


@pytest.mark.parametrize("mode", MODES)
def test_transcript_matches_reference(mode):
    ref_srv, ref_stop = _run_ref_server(RefDatabase())
    srv, stop = _run_pg_server(Database(device="cpu"))
    try:
        want = _transcript(ref_srv.port, mode)
        got = _transcript(srv.port, mode)
    finally:
        ref_stop()
        stop()
    seen = {o for kind, p in want if kind == b"T"
            for o in WireClient._row_desc_oids(p)}
    declared = {o for _sql, params in TRANSCRIPT for o, _t in params}
    assert _BINARY_OIDS <= seen | declared
    assert sum(kind == b"D" for kind, _p in want) >= 10
    assert got == want


def _describe(pg, sql):
    """Parse + Describe(statement) + Sync: the messages up to ReadyForQuery."""
    pg.send(b"P", b"\x00" + sql.encode() + b"\x00\x00\x00")
    pg.send(b"D", b"S\x00")
    pg.send(b"S", b"")
    msgs = []
    while True:
        kind, payload = pg.read_msg()
        msgs.append((kind, payload))
        if kind == b"Z":
            return msgs


def test_describe_read_repair_builds_on_the_connections_device():
    """A Describe plans outside any Execute; when that plan read-repairs
    an inverted index (rows were appended since it was built), the new
    segment must be built on the database's device: on a CPU database it
    answers a RowDescription, and the session stays open."""
    db = Database(device="cpu")
    c = db.connect()
    c.execute("CREATE TABLE docs (id INT, body TEXT)")
    c.execute("INSERT INTO docs VALUES (1, 'alpha beta'), (2, 'beta gamma')")
    c.execute("CREATE INDEX ON docs USING inverted (body)")
    c.execute("INSERT INTO docs VALUES (3, 'alpha delta')")   # index stale
    srv, stop = _run_pg_server(db)
    pg = RawPg(srv.port)
    try:
        msgs = _describe(pg, "SELECT id, bm25(body) AS s FROM docs "
                             "WHERE body @@ 'alpha' ORDER BY s DESC")
        kinds = [k for k, _p in msgs]
        assert b"E" not in kinds, _parse_err(dict(msgs)[b"E"])
        assert b"T" in kinds
        t = [p for k, p in msgs if k == b"T"][0]
        assert WireClient._row_desc_oids(t) == [23, 700]
        pg.send(b"Q", b"SELECT id FROM docs WHERE body @@ 'alpha' "
                      b"ORDER BY id\x00")
        rows = []
        while True:
            kind, payload = pg.read_msg()
            if kind == b"D":
                rows.append(WireClient._data_row(payload, [23], False))
            if kind == b"Z":
                break
        assert rows == [["1"], ["3"]]
        idx = next(iter(db.schemas["main"].tables["docs"].indexes.values()))
        assert idx.indexed_rows == 3
        assert {s.device.type for s, _b in
                idx.searchers["body"].segments} == {"cpu"}
    finally:
        pg.close()
        stop()


def test_describe_internal_error_answers_and_keeps_the_session(monkeypatch):
    """An engine fault while a Describe plans reaches the client as an
    ErrorResponse (XX000), as it would at Execute; the session stays."""
    srv, stop = _run_pg_server(Database(device="cpu"))
    pg = RawPg(srv.port)
    try:
        def broken(self, sel, params):
            raise RuntimeError("planner fault")
        with monkeypatch.context() as m:
            m.setattr(Connection, "_plan", broken)
            msgs = _describe(pg, "SELECT 1 AS one")
        errs = [_parse_err(p) for k, p in msgs if k == b"E"]
        assert errs and errs[0]["C"] == "XX000"
        assert "planner fault" in errs[0]["M"]
        pg.send(b"Q", b"SELECT 2\x00")
        kinds = []
        while True:
            kind, payload = pg.read_msg()
            kinds.append(kind)
            if kind == b"D":
                assert WireClient._data_row(payload, [23], False) == ["2"]
            if kind == b"Z":
                break
        assert b"D" in kinds
    finally:
        pg.close()
        stop()


def test_copy_from_stdin_runs_as_its_connection():
    """COPY's data phase runs outside `execute_statement`; it must still
    run as its connection: a nextval() default draws from the session's
    sequence, and a role without INSERT is refused (42501)."""
    from serenedb_tpu_torch.server.client import PgClient, PgError
    db = Database(device="cpu")
    c = db.connect()
    c.execute("CREATE SEQUENCE sq")
    c.execute("CREATE TABLE s (id BIGINT DEFAULT nextval('sq'), v TEXT)")
    c.execute("CREATE TABLE t (a INT)")
    c.execute("CREATE ROLE reader LOGIN")
    c.execute("GRANT SELECT ON t TO reader")
    srv, stop = _run_pg_server(db)
    try:
        cl = PgClient(srv.port, timeout=30)
        try:
            assert cl.copy_in("COPY s (v) FROM STDIN", b"x\ny\n") == "COPY 2"
        finally:
            cl.close()
        assert c.execute("SELECT id, v FROM s ORDER BY id").rows() == \
            [(1, "x"), (2, "y")]
        cl = PgClient(srv.port, user="reader", timeout=30)
        try:
            with pytest.raises(PgError) as e:
                cl.copy_in("COPY t FROM STDIN", b"1\n")
            assert e.value.sqlstate == "42501"
            assert cl.rows("SELECT count(*) FROM t") == [("0",)]
        finally:
            cl.close()
    finally:
        stop()
