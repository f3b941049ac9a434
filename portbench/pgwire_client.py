"""A frozen PG v3 client for the benchmark's load: the simple-query part
of `serenedb_tpu_torch/server/client.py` (`PgClient`'s startup, framing
and `query`, `decode_value` in text format, `row_oids`, `_fields`,
`PgError`) copied so that a change to the program cannot change how the
benchmark talks to it, and put on asyncio streams (`AsyncPgConn`), so
that one process drives many connections from one thread (`load.py`). It
imports nothing of the program and no numpy, so the load's process starts
in a fraction of a second.
"""

from __future__ import annotations

import asyncio
import datetime
import socket
import struct

_UNIX_EPOCH = datetime.date(1970, 1, 1)


def startup_message(user: str = "serene") -> bytes:
    body = struct.pack("!I", 196608) + b"user\x00" + user.encode() + \
        b"\x00\x00"
    return struct.pack("!I", len(body) + 4) + body


def query_message(sql: str) -> bytes:
    payload = sql.encode() + b"\x00"
    return b"Q" + struct.pack("!I", len(payload) + 4) + payload


TERMINATE = b"X" + struct.pack("!I", 4)


def decode_value(oid: int, raw):
    """One text-format field as the value `Connection.execute` gives for
    its type: int for the integer OIDs and DATE (days since 1970-01-01),
    float, bool, str; None for NULL. Other OIDs stay text."""
    if raw is None:
        return None
    text = raw.decode()
    if oid == 16:
        return text == "t"
    if oid in (20, 21, 23):
        return int(text)
    if oid in (700, 701):
        return float(text)
    if oid == 1082:
        return (datetime.date.fromisoformat(text) - _UNIX_EPOCH).days
    return text


def fields(payload: bytes) -> list:
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
        f = {p[:1].decode(): p[1:].decode(errors="replace")
             for p in payload.split(b"\x00") if p}
        self.sqlstate = f.get("C", "")
        super().__init__(f"{self.sqlstate}: {f.get('M', '')}")


class Answer:
    """What one simple query brought back: the typed rows, or the error."""

    __slots__ = ("rows", "error")

    def __init__(self):
        self.rows: list[tuple] = []
        self.error: str | None = None


class _Reader:
    """Splits the byte stream into (kind, payload) messages."""

    def __init__(self):
        self.buf = b""

    def feed(self, data: bytes) -> None:
        self.buf += data

    def next(self):
        if len(self.buf) < 5:
            return None
        (ln,) = struct.unpack("!I", self.buf[1:5])
        if len(self.buf) < 1 + ln:
            return None
        kind, payload = self.buf[:1], self.buf[5:1 + ln]
        self.buf = self.buf[1 + ln:]
        return kind, payload


def _take(ans: Answer, oids: list, kind: bytes, payload: bytes) -> list:
    """Fold one message into `ans`; returns the current row OIDs."""
    if kind == b"T":
        return row_oids(payload)
    if kind == b"D":
        ans.rows.append(tuple(decode_value(o, f)
                              for o, f in zip(oids, fields(payload))))
    elif kind == b"E" and ans.error is None:
        ans.error = str(PgError(payload))
    return oids


class AsyncPgConn:
    """The same protocol on asyncio streams."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.r, self.w = reader, writer
        self.reader = _Reader()

    @classmethod
    async def open(cls, port: int, user: str = "serene") -> "AsyncPgConn":
        r, w = await asyncio.open_connection("127.0.0.1", port)
        w.get_extra_info("socket").setsockopt(
            socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = cls(r, w)
        w.write(startup_message(user))
        await w.drain()
        while (await conn._read())[0] != b"Z":
            pass
        return conn

    async def _read(self) -> tuple[bytes, bytes]:
        while True:
            msg = self.reader.next()
            if msg is not None:
                return msg
            data = await self.r.read(65536)
            if not data:
                raise ConnectionError("server closed the connection")
            self.reader.feed(data)

    def send(self, sql: str) -> None:
        self.w.write(query_message(sql))

    async def answer(self) -> Answer:
        """Read one query's messages up to ReadyForQuery."""
        ans, oids = Answer(), []
        while True:
            kind, payload = await self._read()
            if kind == b"Z":
                return ans
            oids = _take(ans, oids, kind, payload)

    async def close(self) -> None:
        try:
            self.w.write(TERMINATE)
            await self.w.drain()
        finally:
            self.w.close()
            try:
                await self.w.wait_closed()
            except (ConnectionError, OSError):
                pass
