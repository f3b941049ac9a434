"""Minimal clients of the port's servers: one HTTP request to the JSON API
and the PG v3 protocol in raw bytes: simple queries, the extended
protocol (text or binary results, parameters bound at Bind, portal
chunks), CancelRequest and COPY FROM STDIN.

The port has no client library of its own and the environment may have
no psycopg; `scripts/serened_smoke.py`, `chip_smoke.py` and the serving
tests talk to `FrontDoor` through these.
"""

from __future__ import annotations

import json
import socket
import struct
import urllib.request

import numpy as np

#: result OIDs that `PgClient.extended(binary=True)` asks for in binary
#: (the ones `decode_value` reads in both formats); others come as text
BINARY_OIDS = frozenset({16, 20, 21, 23, 25, 700, 701, 1043, 1082})
#: days from 1970-01-01 to PG's epoch, 2000-01-01
_PG_EPOCH_DAYS = 10_957


def http(port: int, method: str, path: str, body=None, ndjson=False,
         timeout: float = 300):
    """One request to the HTTP API on 127.0.0.1; `body` a JSON value or
    ndjson text. Returns the decoded JSON response."""
    data = None
    if body is not None:
        data = (body if isinstance(body, str) else json.dumps(body)).encode()
    ct = "application/x-ndjson" if ndjson else "application/json"
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                               headers={"Content-Type": ct}, method=method)
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def decode_row(payload: bytes) -> tuple:
    """A DataRow's payload as a tuple of text values (None for NULL)."""
    return tuple(None if f is None else f.decode() for f in _fields(payload))


def decode_value(oid: int, raw, binary: bool):
    """One field as the value `Connection.execute` gives for its type:
    int for the integer OIDs and DATE (days since 1970-01-01), float,
    bool, str; None for NULL. Other OIDs stay text."""
    if raw is None:
        return None
    if binary:
        if oid == 16:
            return raw != b"\x00"
        if oid in (20, 21, 23):
            return int.from_bytes(raw, "big", signed=True)
        if oid == 700:
            return struct.unpack("!f", raw)[0]
        if oid == 701:
            return struct.unpack("!d", raw)[0]
        if oid == 1082:
            return struct.unpack("!i", raw)[0] + _PG_EPOCH_DAYS
        return raw.decode()
    text = raw.decode()
    if oid == 16:
        return text == "t"
    if oid in (20, 21, 23):
        return int(text)
    if oid in (700, 701):
        return float(text)
    if oid == 1082:
        return int(np.datetime64(text, "D").astype(np.int64))
    return text


def _fields(payload: bytes) -> list:
    """A DataRow's fields as raw bytes (None for NULL)."""
    (n,) = struct.unpack("!H", payload[:2])
    off, out = 2, []
    for _ in range(n):
        (ln,) = struct.unpack("!i", payload[off:off + 4])
        off += 4
        out.append(None if ln < 0 else payload[off:off + ln])
        off += max(ln, 0)
    return out


def row_oids(payload: bytes) -> list[int]:
    """The type OIDs of a RowDescription."""
    (n,) = struct.unpack("!H", payload[:2])
    off, oids = 2, []
    for _ in range(n):
        end = payload.index(b"\x00", off)
        oids.append(struct.unpack("!I", payload[end + 7:end + 11])[0])
        off = end + 19
    return oids


class PgError(RuntimeError):
    """An ErrorResponse: its SQLSTATE and message."""

    def __init__(self, payload: bytes):
        fields = {p[:1].decode(): p[1:].decode(errors="replace")
                  for p in payload.split(b"\x00") if p}
        self.sqlstate = fields.get("C", "")
        super().__init__(f"{self.sqlstate}: {fields.get('M', '')}")


class PgClient:
    """A PG v3 connection on 127.0.0.1; no authentication beyond the
    startup message. `backend_key` is the (pid, secret) a CancelRequest
    names."""

    def __init__(self, port: int, user: str = "serene",
                 timeout: float = 120):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        # the extended protocol sends several small messages a statement
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.buf = b""
        body = struct.pack("!I", 196608) + b"user\x00" + user.encode() + \
            b"\x00\x00"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        self.port = port
        self.backend_key = None
        while True:
            kind, payload = self.read()
            if kind == b"K":
                self.backend_key = struct.unpack("!II", payload)
            if kind == b"Z":
                break

    def _send(self, kind: bytes, payload: bytes = b"") -> None:
        self.sock.sendall(kind + struct.pack("!I", len(payload) + 4) +
                          payload)

    def read(self) -> tuple[bytes, bytes]:
        """The next message from the server: (kind, payload)."""
        while len(self.buf) < 5 or \
                len(self.buf) < 1 + struct.unpack("!I", self.buf[1:5])[0]:
            data = self.sock.recv(65536)
            if not data:
                raise ConnectionError("server closed the connection")
            self.buf += data
        (ln,) = struct.unpack("!I", self.buf[1:5])
        kind, payload = self.buf[:1], self.buf[5:1 + ln]
        self.buf = self.buf[1 + ln:]
        return kind, payload

    def send_query(self, sql: str) -> None:
        """Send one simple query without reading its answer (`read`)."""
        self._send(b"Q", sql.encode() + b"\x00")

    def query(self, sql: str) -> list[tuple[bytes, bytes]]:
        """Every (kind, payload) message the server sends for one simple
        query, up to ReadyForQuery."""
        self.send_query(sql)
        out = []
        while True:
            kind, payload = self.read()
            out.append((kind, payload))
            if kind == b"Z":
                return out

    def rows(self, sql: str) -> list[tuple]:
        """The DataRows of one simple query as text tuples; raises on an
        ErrorResponse."""
        out = []
        for kind, payload in self.query(sql):
            if kind == b"E":
                raise RuntimeError(payload.decode(errors="replace"))
            if kind == b"D":
                out.append(decode_row(payload))
        return out

    def typed_rows(self, sql: str) -> list[tuple]:
        """One simple query's rows, each field decoded by its OID
        (`decode_value`); raises PgError on an ErrorResponse."""
        oids, out = [], []
        for kind, payload in self.query(sql):
            if kind == b"E":
                raise PgError(payload)
            if kind == b"T":
                oids = row_oids(payload)
            if kind == b"D":
                out.append(tuple(decode_value(o, f, False) for o, f in
                                 zip(oids, _fields(payload))))
        return out

    def extended(self, sql: str, params=(), binary: bool = False,
                 chunk: int = 0) -> tuple[list[tuple], int]:
        """One statement through Parse, Describe, Bind (`params` as
        text, None for NULL), Execute: the rows decoded by OID
        (`decode_value`; with `binary` every column of BINARY_OIDS comes
        in binary) and the number of Execute messages sent: with `chunk`
        each asks for at most that many rows, and a PortalSuspended
        asks for the next chunk. Raises PgError on an ErrorResponse,
        after the Sync that ends the statement."""
        self._send(b"P", b"\x00" + sql.encode() + b"\x00\x00\x00")
        self._send(b"D", b"S\x00")
        self._send(b"H")
        oids, err = [], None
        while True:
            kind, payload = self.read()
            if kind == b"T":
                oids = row_oids(payload)
            if kind in (b"T", b"n"):
                break
            if kind == b"E":
                err = PgError(payload)
                break
        if err is None:
            fmts = [1 if binary and o in BINARY_OIDS else 0 for o in oids]
            vals = [None if v is None else str(v).encode() for v in params]
            self._send(b"B", b"\x00\x00\x00\x00" +
                       struct.pack("!H", len(vals)) +
                       b"".join(struct.pack("!i", -1) if v is None else
                                struct.pack("!i", len(v)) + v
                                for v in vals) +
                       struct.pack("!H", len(fmts)) +
                       b"".join(struct.pack("!h", f) for f in fmts))
            self._send(b"E", b"\x00" + struct.pack("!I", chunk))
            self._send(b"H")
        rows, executes = [], 1
        while err is None:
            kind, payload = self.read()
            if kind == b"D":
                rows.append(tuple(
                    decode_value(o, f, bool(m)) for o, f, m in
                    zip(oids, _fields(payload), fmts)))
            elif kind == b"s":          # PortalSuspended: the next chunk
                self._send(b"E", b"\x00" + struct.pack("!I", chunk))
                self._send(b"H")
                executes += 1
            elif kind in (b"C", b"I"):
                break
            elif kind == b"E":
                err = PgError(payload)
        self._send(b"S")
        while self.read()[0] != b"Z":
            pass
        if err is not None:
            raise err
        return rows, executes

    def cancel(self) -> None:
        """Send a CancelRequest for this connection's running statement
        on a connection of its own."""
        with socket.create_connection(("127.0.0.1", self.port),
                                      timeout=30) as s:
            s.sendall(struct.pack("!IIII", 16, 80877102,
                                  *self.backend_key))

    def copy_in(self, sql: str, data: bytes,
                piece: int = 1 << 20) -> str:
        """`COPY ... FROM STDIN` (`sql`) with `data` sent as CopyData
        messages of at most `piece` bytes, then CopyDone: the command
        tag. Raises PgError on an ErrorResponse."""
        self.send_query(sql)
        tag, err = "", None
        while True:
            kind, payload = self.read()
            if kind == b"G":
                view = memoryview(data)
                for i in range(0, len(data), piece):
                    self._send(b"d", bytes(view[i:i + piece]))
                self._send(b"c")
            elif kind == b"C":
                tag = payload.rstrip(b"\x00").decode()
            elif kind == b"E":
                err = PgError(payload)
            elif kind == b"Z":
                break
        if err is not None:
            raise err
        return tag

    def close(self) -> None:
        try:
            self.sock.sendall(b"X" + struct.pack("!I", 4))
        finally:
            self.sock.close()


def pg_rows(port: int, sql: str) -> list[tuple]:
    """One statement on a fresh connection: its DataRows as text tuples."""
    c = PgClient(port)
    try:
        return c.rows(sql)
    finally:
        c.close()
