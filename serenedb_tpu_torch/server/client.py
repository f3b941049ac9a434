"""Minimal clients of the port's servers: one HTTP request to the JSON API
and the PG v3 simple-query protocol in raw bytes.

The port has no client library of its own and the environment may have
no psycopg; `scripts/serened_smoke.py`, `chip_smoke.py` and the serving
tests talk to `FrontDoor` through these.
"""

from __future__ import annotations

import json
import socket
import struct
import urllib.request


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
    (n,) = struct.unpack("!H", payload[:2])
    off, row = 2, []
    for _ in range(n):
        (ln,) = struct.unpack("!i", payload[off:off + 4])
        off += 4
        row.append(None if ln < 0 else payload[off:off + ln].decode())
        off += max(ln, 0)
    return tuple(row)


class PgClient:
    """A PG v3 connection on 127.0.0.1 speaking the simple-query
    protocol; no authentication beyond the startup message."""

    def __init__(self, port: int, user: str = "serene",
                 timeout: float = 120):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        self.buf = b""
        body = struct.pack("!I", 196608) + b"user\x00" + user.encode() + \
            b"\x00\x00"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        while self._read()[0] != b"Z":
            pass

    def _read(self) -> tuple[bytes, bytes]:
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

    def query(self, sql: str) -> list[tuple[bytes, bytes]]:
        """Every (kind, payload) message the server sends for one simple
        query, up to ReadyForQuery."""
        body = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + struct.pack("!I", len(body) + 4) + body)
        out = []
        while True:
            kind, payload = self._read()
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
