"""Copied from serenedb_tpu/server/pgwire.py.

PostgreSQL wire protocol (v3) server.

Reference analog: server/network/pg/pg_wire_session.{h,cpp} (3.4 kLoC C++ —
startup/TLS negotiation, auth, simple+extended protocol, portals, COPY;
SURVEY.md §2.2). This asyncio implementation covers the surface drivers
need: startup + cleartext/trust auth, ParameterStatus, simple queries,
extended protocol (Parse/Bind/Describe/Execute/Close/Sync/Flush) with named
statements and portals, text-format results, SQLSTATE error responses,
implicit transaction status, and CancelRequest keys.

Message framing: [type:1][len:4 incl itself][payload]; startup has no type.
"""

from __future__ import annotations

import asyncio
import functools
import os
import secrets
import struct
import time
from dataclasses import dataclass, field
from typing import Optional

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Batch
from .. import scram
from ..engine import Connection, Database, QueryResult
from ..sql import ast, parser
from ..utils import log, metrics
from . import hba

PROTOCOL_VERSION = 196608          # 3.0
SSL_REQUEST = 80877103
GSS_REQUEST = 80877104
CANCEL_REQUEST = 80877102

# PG type OIDs
_OID = {
    dt.TypeId.BOOL: 16, dt.TypeId.TINYINT: 21, dt.TypeId.SMALLINT: 21,
    dt.TypeId.INT: 23, dt.TypeId.BIGINT: 20, dt.TypeId.FLOAT: 700,
    dt.TypeId.DOUBLE: 701, dt.TypeId.VARCHAR: 25,
    dt.TypeId.TIMESTAMP: 1114, dt.TypeId.DATE: 1082,
    dt.TypeId.INTERVAL: 1186, dt.TypeId.NULL: 25,
    dt.TypeId.OID: 26, dt.TypeId.REGCLASS: 2205,
    dt.TypeId.REGTYPE: 2206, dt.TypeId.REGPROC: 24,
    dt.TypeId.REGNAMESPACE: 4089, dt.TypeId.RECORD: 2249,
}
_TYPLEN = {16: 1, 21: 2, 23: 4, 20: 8, 700: 4, 701: 8, 25: -1, 1114: 8,
           1082: 4, 1186: 16, 26: 4, 2205: 4, 2206: 4, 24: 4, 4089: 4,
           2249: -1}

#: element TypeId → array OID (PG catalog values)
_ARRAY_OID = {
    dt.TypeId.BOOL: 1000, dt.TypeId.SMALLINT: 1005, dt.TypeId.TINYINT: 1005,
    dt.TypeId.INT: 1007, dt.TypeId.BIGINT: 1016, dt.TypeId.FLOAT: 1021,
    dt.TypeId.DOUBLE: 1022, dt.TypeId.VARCHAR: 1009,
    dt.TypeId.DATE: 1182, dt.TypeId.TIMESTAMP: 1115,
}


def oid_of_type(t: dt.SqlType) -> int:
    if t.id is dt.TypeId.ARRAY:
        return _ARRAY_OID.get(t.elem or dt.TypeId.VARCHAR, 1009)
    return _OID.get(t.id, 25)


def _pg_array_text(json_text: str, elem=None, db=None) -> bytes:
    """JSON array text (the physical representation) → PG {...} output
    (reference: server/pg/serialize.cpp array_out). One renderer for
    arrays everywhere — record fields included — lives in
    columnar/pgcopy so the two can never drift."""
    from ..columnar.pgcopy import _array_field_text
    return _array_field_text(json_text, elem).encode()


def pg_text(value, typ: dt.SqlType, db=None) -> Optional[bytes]:
    """PG text-format encoding (reference: server/pg/serialize.cpp)."""
    if value is None:
        return None
    tid = typ.id
    if tid is dt.TypeId.ARRAY:
        return _pg_array_text(str(value), typ.elem, db)
    if tid is dt.TypeId.RECORD:
        from ..columnar.pgcopy import record_text
        return record_text(str(value)).encode()
    if tid is dt.TypeId.BOOL:
        return b"t" if value else b"f"
    if tid in (dt.TypeId.REGCLASS, dt.TypeId.REGTYPE, dt.TypeId.REGPROC,
               dt.TypeId.REGNAMESPACE):
        # PG renders reg* as names in text format (binary stays the oid)
        from .. import pgcatalog as _pgcat
        if tid is dt.TypeId.REGTYPE:
            s = _pgcat.regtype_render(value)
        elif tid is dt.TypeId.REGPROC:
            s = _pgcat.proc_name_of(value) or str(int(value))
        elif tid is dt.TypeId.REGNAMESPACE:
            s = _pgcat.namespace_render(db, int(value))
        else:
            s = _pgcat.regclass_render(db, int(value))
        return s.encode()
    if tid is dt.TypeId.TIMESTAMP:
        from ..sql.binder import format_timestamp
        return format_timestamp(int(value)).encode()
    if tid is dt.TypeId.DATE:
        import numpy as np
        return str(np.datetime64(int(value), "D")).encode()
    if tid is dt.TypeId.INTERVAL:
        from ..sql.binder import format_interval
        return format_interval(int(value)).encode()
    if isinstance(value, float):
        import math
        if math.isnan(value):
            return b"NaN"
        if math.isinf(value):
            return b"Infinity" if value > 0 else b"-Infinity"
        return repr(value).encode()
    return str(value).encode()


def _fmt_for(fmts, i: int) -> int:
    """Result-format code for column i (PG Bind semantics: none = all
    text, one = applies to every column, else positional)."""
    if not fmts:
        return 0
    if len(fmts) == 1:
        return fmts[0]
    return fmts[i] if i < len(fmts) else 0


def pg_binary(value, typ: dt.SqlType) -> Optional[bytes]:
    """PG binary-format encoding for result columns (reference:
    server/pg/serialize.cpp binary send functions). Delegates to the
    shared COPY codec — one source of truth for binary sends."""
    from ..columnar.pgcopy import encode_value
    return encode_value(value, typ)


async def upgrade_writer_tls(writer: asyncio.StreamWriter, ctx) -> None:
    """In-band TLS upgrade of an established stream pair.

    `StreamWriter.start_tls` is 3.11+; on 3.10 run `loop.start_tls`
    over the writer's transport/protocol directly and re-point the
    writer, the protocol, and the reader's flow-control transport at
    the SSL transport (exactly what 3.11's implementation does —
    `loop.start_tls` wraps with call_connection_made=False, so none of
    this re-runs `connection_made`)."""
    if hasattr(writer, "start_tls"):        # 3.11+
        await writer.start_tls(ctx)
        return
    await writer.drain()
    loop = asyncio.get_running_loop()
    transport = writer.transport
    protocol = transport.get_protocol()
    new_transport = await loop.start_tls(
        transport, protocol, ctx, server_side=True)
    writer._transport = new_transport
    protocol._transport = new_transport
    protocol._over_ssl = True
    reader = getattr(protocol, "_stream_reader", None)
    if reader is not None:
        reader._transport = new_transport


class Writer:
    def __init__(self, transport: asyncio.StreamWriter, db=None):
        self.t = transport
        self._buf = bytearray()
        #: the session's Database — reg* text rendering resolves names
        self.db = db

    def msg(self, kind: bytes, payload: bytes = b""):
        self._buf += kind + struct.pack("!I", len(payload) + 4) + payload

    async def flush(self):
        if self._buf:
            self.t.write(bytes(self._buf))
            self._buf.clear()
            await self.t.drain()

    # -- common messages ---------------------------------------------------

    def auth_ok(self):
        self.msg(b"R", struct.pack("!I", 0))

    def auth_cleartext(self):
        self.msg(b"R", struct.pack("!I", 3))

    def auth_sasl(self, mechanisms: list[str]):
        body = b"".join(m.encode() + b"\x00" for m in mechanisms) + b"\x00"
        self.msg(b"R", struct.pack("!I", 10) + body)

    def auth_sasl_continue(self, data: str):
        self.msg(b"R", struct.pack("!I", 11) + data.encode())

    def auth_sasl_final(self, data: str):
        self.msg(b"R", struct.pack("!I", 12) + data.encode())

    def notification(self, pid: int, channel: str, payload: str):
        self.msg(b"A", struct.pack("!I", pid) + channel.encode() +
                 b"\x00" + payload.encode() + b"\x00")

    def parameter_status(self, k: str, v: str):
        self.msg(b"S", k.encode() + b"\x00" + v.encode() + b"\x00")

    def backend_key(self, pid: int, key: int):
        self.msg(b"K", struct.pack("!II", pid, key))

    def ready(self, status: bytes):
        self.msg(b"Z", status)

    def row_description(self, names: list[str], types: list[dt.SqlType],
                        fmts: tuple = ()):
        out = [struct.pack("!H", len(names))]
        for i, (name, t) in enumerate(zip(names, types)):
            oid = oid_of_type(t)
            out.append(name.encode() + b"\x00")
            out.append(struct.pack("!IHIhih", 0, 0, oid,
                                   _TYPLEN.get(oid, -1), -1,
                                   _fmt_for(fmts, i)))
        self.msg(b"T", b"".join(out))

    def data_rows(self, batch: Batch, fmts: tuple = ()):
        types = [c.type for c in batch.columns]
        cols_text = []
        for ci, (col, t) in enumerate(zip(batch.columns, types)):
            vals = col.to_pylist()
            if _fmt_for(fmts, ci) == 1:
                cols_text.append([pg_binary(v, t) for v in vals])
            else:
                cols_text.append([pg_text(v, t, self.db) for v in vals])
        for i in range(batch.num_rows):
            parts = [struct.pack("!H", len(types))]
            for ci in range(len(types)):
                v = cols_text[ci][i]
                if v is None:
                    parts.append(struct.pack("!i", -1))
                else:
                    parts.append(struct.pack("!i", len(v)) + v)
            self.msg(b"D", b"".join(parts))

    def command_complete(self, tag: str):
        self.msg(b"C", tag.encode() + b"\x00")

    def empty_query(self):
        self.msg(b"I")

    def parse_complete(self):
        self.msg(b"1")

    def bind_complete(self):
        self.msg(b"2")

    def close_complete(self):
        self.msg(b"3")

    def no_data(self):
        self.msg(b"n")

    def param_description(self, n: int):
        self.msg(b"t", struct.pack("!H", n) + struct.pack("!I", 25) * n)

    def error(self, e: errors.SqlError):
        fields = [b"SERROR", b"VERROR",
                  b"C" + e.sqlstate.encode(),
                  b"M" + e.message.encode()]
        if e.detail:
            fields.append(b"D" + e.detail.encode())
        if e.hint:
            fields.append(b"H" + e.hint.encode())
        self.msg(b"E", b"\x00".join(fields) + b"\x00\x00")


@dataclass
class Prepared:
    sql: str
    statements: list[ast.Statement]
    n_params: int
    param_oids: tuple = ()   # client-declared OIDs from Parse (may be 0s)


@dataclass
class Portal:
    prepared: Prepared
    params: list
    result_fmts: tuple = ()    # Bind result-format codes (0 text, 1 binary)
    pending: object = None     # QueryResult with rows not yet sent
    sent: int = 0
    #: streaming SELECT state: {"it": batch iterator, "leftover": Batch
    #: remainder after a row-budget split, "total": rows sent} — rows leave
    #: the socket as the executor produces them (wire_collector.h:20-60)
    stream: object = None


def _close_portal_stream(portal: Optional["Portal"]) -> None:
    """Close a suspended streaming portal's executor generator eagerly —
    its session scope (pg_stat_activity 'active', QUERIES_ACTIVE gauge)
    must end now, never at GC time."""
    if portal is not None and portal.stream is not None:
        try:
            portal.stream["it"].close()
        except Exception:
            pass
        portal.stream = None


class PgSession:
    def __init__(self, server: "PgServer", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, gate_info=None):
        self.server = server
        self.reader = reader
        self.w = Writer(writer, db=server.db)
        self.conn: Optional[Connection] = None
        self.prepared: dict[str, Prepared] = {}
        self.portals: dict[str, Portal] = {}
        self.pid = os.getpid()
        self.secret = secrets.randbits(31)
        self.ignore_till_sync = False
        self.tls_active = False
        #: the connection gate's record for this socket (None when the
        #: session is driven outside the accept path, e.g. tests)
        self.gate_info = gate_info

    # -- startup -----------------------------------------------------------

    def _set_gate(self, state: str) -> None:
        if self.gate_info is not None:
            from ..sched.governor import CONNGATE
            CONNGATE.set_state(self.gate_info, state)

    @staticmethod
    def _idle_conn_timeout() -> Optional[float]:
        from ..utils.config import REGISTRY as _settings
        t = float(_settings.get_global("serene_idle_conn_timeout_s") or 0.0)
        return t if t > 0 else None

    async def _handshake(self) -> bool:
        if not await self._consume_proxy_preface():
            return False
        return await self._startup()

    async def run(self):
        with metrics.PG_CONNECTIONS.scoped():
            try:
                # the whole handshake honors the idle timeout: a
                # half-open client (SYN, then silence) is reaped without
                # ever burning a pool slot
                t = self._idle_conn_timeout()
                if t:
                    ok = await asyncio.wait_for(self._handshake(), t)
                else:
                    ok = await self._handshake()
                if not ok:
                    return
                await self._command_loop()
            except (asyncio.IncompleteReadError, ConnectionResetError):
                pass
            except asyncio.TimeoutError:
                log.info("pg", "idle connection reaped "
                         "(serene_idle_conn_timeout_s)")
            finally:
                self.server.unregister_cancel(self.pid, self.secret)
                for p in self.portals.values():
                    _close_portal_stream(p)
                if self.conn is not None:
                    self.conn.close()
                self.w.t.close()

    #: PROXY v2 signature (HAProxy spec); v1 is the ASCII "PROXY " line
    _PP2_SIG = b"\r\n\r\n\x00\r\nQUIT\n"

    async def _consume_proxy_preface(self) -> bool:
        """HAProxy PROXY protocol v1/v2 (reference:
        server/network/proxy_protocol.cpp). off: never read one;
        optional: consume if present; require: reject clients without
        one. The advertised source address replaces the socket peer for
        HBA matching and pg_stat_activity."""
        mode = self.server.proxy_protocol
        if mode == "off":
            return True
        # peek: v2 starts with a 12-byte binary signature, v1 with
        # ASCII "PROXY "; anything else is a plain client
        head = await self.reader.readexactly(1)
        if head == b"\r":
            sig = head + await self.reader.readexactly(11)
            if sig != self._PP2_SIG:
                self.w.t.close()
                return False
            vercmd = await self.reader.readexactly(1)
            fam = await self.reader.readexactly(1)
            (plen,) = struct.unpack("!H", await self.reader.readexactly(2))
            payload = await self.reader.readexactly(plen)
            if vercmd[0] >> 4 != 2:
                self.w.t.close()
                return False
            if (vercmd[0] & 0xF) == 1 and fam[0] >> 4 == 1 and plen >= 12:
                import socket as _socket
                src = _socket.inet_ntoa(payload[0:4])
                sport = struct.unpack("!H", payload[8:10])[0]
                self.proxied_peer = (src, sport)
            elif (vercmd[0] & 0xF) == 1 and fam[0] >> 4 == 2 and plen >= 36:
                import socket as _socket
                src = _socket.inet_ntop(_socket.AF_INET6, payload[0:16])
                sport = struct.unpack("!H", payload[32:34])[0]
                self.proxied_peer = (src, sport)
            # LOCAL command / UNSPEC: keep the socket peer
            return True
        if head == b"P":
            rest = await self.reader.readexactly(5)
            if head + rest != b"PROXY ":
                self.w.t.close()
                return False
            line = bytearray()
            while not line.endswith(b"\r\n"):
                line += await self.reader.readexactly(1)
                if len(line) > 100:          # spec: max 107 bytes total
                    self.w.t.close()
                    return False
            parts = line[:-2].decode("ascii", "replace").split(" ")
            # TCP4/TCP6 src dst sport dport; UNKNOWN keeps the peer;
            # malformed fields drop the connection cleanly (spec) —
            # never an unhandled task exception an unauthenticated
            # peer can spam
            if parts and parts[0] in ("TCP4", "TCP6"):
                try:
                    self.proxied_peer = (parts[1], int(parts[3]))
                except (IndexError, ValueError):
                    self.w.t.close()
                    return False
            return True
        if mode == "require":
            self.w.t.close()
            return False
        # optional + not a preface: stash the byte for the startup reader
        self._preread = head
        return True

    async def _read_exactly(self, n: int) -> bytes:
        """readexactly honoring a byte pre-read by the proxy sniffer."""
        pre = getattr(self, "_preread", b"")
        if pre:
            self._preread = b""
            return pre + await self.reader.readexactly(n - len(pre))
        return await self.reader.readexactly(n)

    async def _startup(self) -> bool:
        while True:
            raw = await self._read_exactly(4)
            (ln,) = struct.unpack("!I", raw)
            body = await self.reader.readexactly(ln - 4)
            (code,) = struct.unpack("!I", body[:4])
            if code == SSL_REQUEST:
                ctx = self.server.tls_context
                if ctx is not None and not self.tls_active:
                    self.w.t.write(b"S")
                    await self.w.t.drain()
                    # in-band upgrade (reference: MaybeTls,
                    # tls_context.cpp); the stream pair survives start_tls
                    await upgrade_writer_tls(self.w.t, ctx)
                    self.tls_active = True
                else:
                    self.w.t.write(b"N")
                    await self.w.t.drain()
                continue
            if code == GSS_REQUEST:
                self.w.t.write(b"N")
                await self.w.t.drain()
                continue
            if code == CANCEL_REQUEST:
                pid, key = struct.unpack("!II", body[4:12])
                self.server.cancel(pid, key)
                return False
            if code != PROTOCOL_VERSION:
                self.w.error(errors.SqlError(
                    "08P01", f"unsupported protocol version {code >> 16}"))
                await self.w.flush()
                return False
            break
        params = {}
        parts = body[4:].split(b"\x00")
        for k, v in zip(parts[::2], parts[1::2]):
            if k:
                params[k.decode()] = v.decode()
        user = params.get("user", "serene")
        database = params.get("database", user)
        roles = self.server.db.roles
        role_known = roles.exists(user)
        if role_known and not roles.can_login(user):
            self.w.error(errors.SqlError(
                "28000", f'role "{user}" is not permitted to log in'))
            await self.w.flush()
            return False
        # HBA: first matching rule decides the auth method (reference:
        # server/network/pg/hba.cpp). Without an HBA config, fall back to
        # the implicit policy (server password / role password / trust).
        method = None
        if self.server.hba_rules is not None:
            peer = getattr(self, "proxied_peer", None) or \
                self.w.t.get_extra_info("peername")
            if isinstance(peer, tuple):
                addr = peer[0]
            else:
                # unix-socket peers have a path (or empty) peername —
                # they match `local` HBA rules
                addr = str(peer) if peer else "/unix-socket"
            rule = hba.match_rule(self.server.hba_rules, database, user,
                                  addr, self.tls_active)
            if rule is None or rule.method == "reject":
                self.w.error(errors.SqlError(
                    "28000",
                    f'no pg_hba.conf entry for host "{addr}", user '
                    f'"{user}", database "{database}"' if rule is None
                    else f'pg_hba.conf rejects connection for host '
                         f'"{addr}", user "{user}", database "{database}"'))
                await self.w.flush()
                return False
            method = rule.method
        if method is None:
            needs_password = self.server.password is not None or (
                role_known and roles.has_password(user))
            method = "implicit-password" if needs_password else "trust"
        if method != "trust":
            if self.server.password is not None:
                # a server-wide password gates EVERY login, including
                # passwordless roles — no bypass via user=serene
                verifier = self.server.password_verifier
            else:
                verifier = roles.scram_verifier(user)
            if method in ("password", "md5") or (
                    method == "implicit-password" and verifier is None):
                # cleartext exchange (md5 verifiers are never stored; the
                # md5 method degrades to password, as documented in hba.py)
                self.w.auth_cleartext()
                await self.w.flush()
                kind, payload = await self._read_msg()
                supplied = payload[:-1].decode() if kind == b"p" else ""
                if self.server.password is not None:
                    ok = kind == b"p" and supplied == self.server.password
                else:
                    ok = kind == b"p" and role_known and \
                        roles.check_password(user, supplied)
            elif verifier is not None:
                ok = await self._scram_auth(verifier)
            else:
                # scram demanded by HBA but the role has no password
                ok = False
            if not ok:
                self.w.error(errors.SqlError(
                    "28P01",
                    f'password authentication failed for user "{user}"'))
                await self.w.flush()
                return False
        # known roles get their own privileges; unknown users fall back to
        # the bootstrap superuser (trust mode, matching default pg_hba)
        self.conn = Connection(self.server.db,
                               user if role_known else None)
        for k, v in params.items():
            if k in ("user", "database", "options", "replication"):
                continue
            try:
                self.conn.settings.set(k, v)
            except (KeyError, ValueError):
                pass
        # the session registry id IS the backend pid clients see: a
        # BackendKeyData pid must find its own row in pg_stat_activity
        self.pid = self.conn._session_id
        # idle NOTIFY delivery: the engine bus wakes this loop from any
        # thread; the task only writes while the session is idle (a
        # client blocked in select() on the socket sees the 'A' push)
        loop = asyncio.get_running_loop()
        self._idle = False
        self.conn.notify_hook = lambda: loop.call_soon_threadsafe(
            lambda: loop.create_task(self._push_notifications()))
        self.w.auth_ok()
        for k, v in [("server_version", "16.0 (serenedb_tpu)"),
                     ("server_encoding", "UTF8"),
                     ("client_encoding", "UTF8"),
                     ("DateStyle", "ISO, MDY"),
                     ("TimeZone", "UTC"),
                     ("integer_datetimes", "on"),
                     ("standard_conforming_strings", "on"),
                     ("application_name",
                      params.get("application_name", ""))]:
            self.w.parameter_status(k, v)
        self.w.backend_key(self.pid, self.secret)
        self.server.register_cancel(self.pid, self.secret, self)
        self._drain_notifications()
        self.w.ready(self._txn_status())
        await self.w.flush()
        return True

    async def _scram_auth(self, verifier: dict) -> bool:
        """SCRAM-SHA-256 SASL exchange (RFC 7677 over the PG SASL
        messages: AuthenticationSASL → SASLInitialResponse →
        SASLContinue → SASLResponse → SASLFinal)."""
        self.w.auth_sasl([scram.MECHANISM])
        await self.w.flush()
        kind, payload = await self._read_msg()
        if kind != b"p":
            return False
        try:
            end = payload.index(b"\x00")
            mech = payload[:end].decode()
            (ln,) = struct.unpack_from("!i", payload, end + 1)
            data = payload[end + 5:end + 5 + ln].decode() if ln >= 0 else ""
            if mech != scram.MECHANISM:
                return False
            srv = scram.ScramServer(verifier)
            self.w.auth_sasl_continue(srv.first(data))
            await self.w.flush()
            kind, payload = await self._read_msg()
            if kind != b"p":
                return False
            ok, final = srv.final(payload.decode())
        except (ValueError, IndexError, struct.error, UnicodeDecodeError):
            return False
        if ok:
            self.w.auth_sasl_final(final)
        return ok

    async def _push_notifications(self):
        """Async NotificationResponse push while the session is idle."""
        if not self._idle or self.conn is None:
            return   # mid-command: the boundary drain will deliver
        try:
            self._drain_notifications()
            await self.w.flush()
        except (ConnectionResetError, RuntimeError):
            pass

    def _drain_notifications(self):
        """NotificationResponse delivery at statement boundaries (PG also
        delivers when idle; boundary delivery covers the standard driver
        poll loop)."""
        if self.conn is None:
            return
        for pid, channel, payload in self.conn.take_notifications():
            self.w.notification(pid, channel, payload)

    def _txn_status(self) -> bytes:
        if self.conn is None:
            return b"I"
        if self.conn.txn_failed:
            return b"E"
        return b"T" if self.conn.in_txn else b"I"

    async def _read_msg(self) -> tuple[bytes, bytes]:
        kind = await self.reader.readexactly(1)
        (ln,) = struct.unpack("!I", await self.reader.readexactly(4))
        payload = await self.reader.readexactly(ln - 4)
        return kind, payload

    # -- command loop ------------------------------------------------------

    async def _command_loop(self):
        while True:
            self._idle = True
            self._set_gate("idle")
            # close the missed-wakeup window: anything enqueued before
            # _idle flipped is delivered here; later arrivals take the
            # hook path
            self._drain_notifications()
            await self.w.flush()
            t = self._idle_conn_timeout()
            if t:
                # reap abandoned sessions between commands; propagates
                # to run()'s TimeoutError handler which closes the
                # transport (a statement in flight is never interrupted
                # — the timeout only guards this idle read)
                kind, payload = await asyncio.wait_for(
                    self._read_msg(), t)
            else:
                kind, payload = await self._read_msg()
            self._idle = False
            self._set_gate("active")
            if kind == b"X":
                return
            if self.ignore_till_sync and kind not in (b"S",):
                continue
            handler = {
                b"Q": self._on_query,
                b"P": self._on_parse,
                b"B": self._on_bind,
                b"D": self._on_describe,
                b"E": self._on_execute,
                b"C": self._on_close,
                b"S": self._on_sync,
                b"H": self._on_flush,
            }.get(kind)
            if handler is None:
                self.w.error(errors.SqlError(
                    "08P01", f"unknown message type {kind!r}"))
                self.ignore_till_sync = True
                await self.w.flush()
                continue
            await handler(payload)

    async def _on_query(self, payload: bytes):
        sql = payload[:-1].decode()
        loop = asyncio.get_running_loop()
        try:
            stmts = parser.parse(sql)
            if not stmts:
                self.w.empty_query()
            for st in stmts:
                if isinstance(st, ast.CopyStmt) and \
                        st.target in ("STDIN", "STDOUT"):
                    await self._run_copy(st)
                    continue
                if isinstance(st, (ast.Select, ast.SetOp)):
                    await self._stream_select(st, sql)
                    continue
                res = await loop.run_in_executor(
                    self.server.pool,
                    functools.partial(self.conn.execute_statement, st, [],
                                      sql_text=sql))
                self._send_result(res, describe=True)
        except errors.SqlError as e:
            self._note_error()
            self.w.error(e)
        except Exception as e:  # engine bug: surface as internal error
            log.error("pg", f"internal error: {e!r}")
            self._note_error()
            self.w.error(errors.SqlError("XX000", f"internal error: {e}"))
        self._drain_notifications()
        self.w.ready(self._txn_status())
        await self.w.flush()

    async def _run_copy(self, st):
        """COPY ... FROM STDIN / TO STDOUT sub-protocol (reference:
        pg_wire_session COPY in/out legs, SURVEY.md §2.2)."""
        if self.conn.txn_failed:
            raise errors.SqlError(
                errors.IN_FAILED_TRANSACTION,
                "current transaction is aborted, commands ignored until "
                "end of transaction block")
        loop = asyncio.get_running_loop()
        is_bin = str(st.options.get("format", "")).lower() == "binary"
        ov_fmt = 1 if is_bin else 0
        if st.direction == "from":
            ncols = len(st.columns) if st.columns else \
                len(self.conn.db.resolve_table(st.table).column_names)
            self.w.msg(b"G", struct.pack("!bH", ov_fmt, ncols) +
                       struct.pack("!h", ov_fmt) * ncols)
            await self.w.flush()
            chunks = []
            failed = None
            while True:
                kind, payload = await self._read_msg()
                if kind == b"d":
                    chunks.append(payload)
                elif kind == b"c":
                    break
                elif kind == b"f":
                    failed = payload[:-1].decode() or "COPY terminated"
                    break
                elif kind == b"X":
                    raise ConnectionResetError
                # 'H'/'S' flush/sync during copy: ignore
            if failed is not None:
                raise errors.SqlError(errors.QUERY_CANCELED,
                                      f"COPY from stdin failed: {failed}")
            data = b"".join(chunks)
            res = await loop.run_in_executor(
                self.server.pool, self.conn.copy_in_data, st, data)
            self.w.command_complete(res.command_tag)
            return
        # COPY TO STDOUT
        rows, n, ncols = await loop.run_in_executor(
            self.server.pool, self.conn.copy_out_data, st)
        self.w.msg(b"H", struct.pack("!bH", ov_fmt, ncols) +
                   struct.pack("!h", ov_fmt) * ncols)
        for row in rows:
            self.w.msg(b"d", row)
        self.w.msg(b"c")
        self.w.command_complete(f"COPY {n}")

    def _note_error(self):
        """Any error inside an explicit transaction block aborts it (the
        engine only marks this for errors it raises during execution)."""
        if self.conn is not None and self.conn.in_txn:
            self.conn.txn_failed = True

    async def _stream_select(self, st, sql: str):
        """Streaming wire collector for simple-protocol SELECTs: encode +
        flush per executor batch (reference: wire_collector.h:20-60 —
        rows leave the socket during execution, bounding session memory
        and time-to-first-row)."""
        loop = asyncio.get_running_loop()
        names, types, it = await loop.run_in_executor(
            self.server.pool,
            functools.partial(self.conn.execute_streaming, st, [],
                              sql_text=sql))
        self.w.row_description(names, types)
        n = 0
        try:
            while True:
                b = await loop.run_in_executor(self.server.pool,
                                               lambda: next(it, None))
                if b is None:
                    break
                if b.num_rows:
                    self.w.data_rows(b)
                    n += b.num_rows
                    # flush per batch: backpressure via the transport drain
                    await self.w.flush()
        finally:
            # deterministic engine-side cleanup (session state, metrics) on
            # error/disconnect — never wait for GC to finalize the generator
            await loop.run_in_executor(self.server.pool, it.close)
        self.w.command_complete(f"SELECT {n}")

    def _send_result(self, res: QueryResult, describe: bool,
                     fmts: tuple = ()):
        if res.batch.num_columns:
            if describe:
                self.w.row_description(
                    res.batch.names, [c.type for c in res.batch.columns],
                    fmts)
            self.w.data_rows(res.batch, fmts)
        self.w.command_complete(res.command_tag or "OK")

    # -- extended protocol -------------------------------------------------

    async def _on_parse(self, payload: bytes):
        try:
            name_end = payload.index(b"\x00")
            name = payload[:name_end].decode()
            sql_end = payload.index(b"\x00", name_end + 1)
            sql = payload[name_end + 1:sql_end].decode()
            (n_oids,) = struct.unpack_from("!H", payload, sql_end + 1)
            oids = struct.unpack_from(f"!{n_oids}I", payload, sql_end + 3)
            stmts = parser.parse(sql)
            if len(stmts) > 1:
                raise errors.syntax(
                    "cannot insert multiple commands into a prepared "
                    "statement")
            n_params = _count_params(stmts[0]) if stmts else 0
            self.prepared[name] = Prepared(sql, stmts, n_params, oids)
            self.w.parse_complete()
        except errors.SqlError as e:
            self._note_error()
            self.w.error(e)
            self.ignore_till_sync = True
        await self.w.flush()

    async def _on_bind(self, payload: bytes):
        try:
            off = 0
            pend = payload.index(b"\x00", off)
            portal = payload[off:pend].decode()
            send = payload.index(b"\x00", pend + 1)
            stmt_name = payload[pend + 1:send].decode()
            off = send + 1
            (n_fmt,) = struct.unpack_from("!H", payload, off)
            off += 2
            fmts = struct.unpack_from(f"!{n_fmt}h", payload, off)
            off += 2 * n_fmt
            prep = self.prepared.get(stmt_name)
            if prep is None:
                raise errors.SqlError(
                    "26000", f'prepared statement "{stmt_name}" does not '
                             "exist")
            (n_params,) = struct.unpack_from("!H", payload, off)
            off += 2
            params = []
            for i in range(n_params):
                (ln,) = struct.unpack_from("!i", payload, off)
                off += 4
                if ln < 0:
                    params.append(None)
                else:
                    raw = payload[off:off + ln]
                    off += ln
                    fmt = fmts[i] if i < len(fmts) else \
                        (fmts[0] if len(fmts) == 1 else 0)
                    oid = prep.param_oids[i] if i < len(prep.param_oids) \
                        else 0
                    params.append(_decode_param(raw, fmt, oid))
            rfmts: tuple = ()
            if off + 2 <= len(payload):   # tolerate clients omitting it
                (n_rfmt,) = struct.unpack_from("!H", payload, off)
                off += 2
                rfmts = struct.unpack_from(f"!{n_rfmt}h", payload, off)
            if any(f not in (0, 1) for f in rfmts):
                raise errors.SqlError(
                    "08P01", f"invalid result format code "
                             f"{[f for f in rfmts if f not in (0, 1)][0]}")
            _close_portal_stream(self.portals.get(portal))
            self.portals[portal] = Portal(prep, params, rfmts)
            self.w.bind_complete()
        except errors.SqlError as e:
            self._note_error()
            self.w.error(e)
            self.ignore_till_sync = True
        except Exception as e:
            # malformed Bind payloads (struct/index errors) must answer
            # 08P01, not tear the connection down silently
            self._note_error()
            self.w.error(errors.SqlError(
                "08P01", f"malformed Bind message: {e!r}"))
            self.ignore_till_sync = True
        await self.w.flush()

    async def _on_describe(self, payload: bytes):
        kind = payload[:1]
        name = payload[1:-1].decode()
        try:
            if kind == b"S":
                prep = self.prepared.get(name)
                if prep is None:
                    raise errors.SqlError(
                        "26000", f'prepared statement "{name}" does not exist')
                self.w.param_description(prep.n_params)
                self._describe_statement(prep)
            else:
                portal = self.portals.get(name)
                if portal is None:
                    raise errors.SqlError(
                        "34000", f'portal "{name}" does not exist')
                self._describe_statement(portal.prepared,
                                         portal.result_fmts)
        except errors.SqlError as e:
            self._note_error()
            self.w.error(e)
            self.ignore_till_sync = True
        except Exception as e:  # engine bug: answer it, keep the session
            log.error("pg", f"internal error: {e!r}")
            self._note_error()
            self.w.error(errors.SqlError("XX000", f"internal error: {e}"))
            self.ignore_till_sync = True
        await self.w.flush()

    def _describe_statement(self, prep: Prepared, fmts: tuple = ()):
        st = prep.statements[0] if prep.statements else None
        if isinstance(st, (ast.Select, ast.SetOp, ast.ShowStmt,
                           ast.Explain)):
            try:
                if isinstance(st, (ast.Select, ast.SetOp)):
                    plan = self.conn.describe_plan(st, prep.n_params)
                    self.w.row_description(plan.names, plan.types, fmts)
                    return
            except errors.SqlError:
                pass
            self.w.no_data()
        elif isinstance(st, (ast.Insert, ast.Update, ast.Delete)) and \
                getattr(st, "returning", None):
            # drivers need the RETURNING row shape from Describe
            try:
                names, types = self.conn._describe_returning(
                    st, [None] * prep.n_params)
                self.w.row_description(names, types, fmts)
            except errors.SqlError:
                self.w.no_data()
        else:
            self.w.no_data()

    async def _on_execute(self, payload: bytes):
        end = payload.index(b"\x00")
        name = payload[:end].decode()
        loop = asyncio.get_running_loop()
        try:
            (max_rows,) = struct.unpack_from("!I", payload, end + 1)
            portal = self.portals.get(name)
            if portal is None:
                raise errors.SqlError("34000",
                                      f'portal "{name}" does not exist')
            if not portal.prepared.statements:
                self.w.empty_query()
                return
            st0 = portal.prepared.statements[0]
            if portal.stream is not None or (
                    portal.pending is None and
                    isinstance(st0, (ast.Select, ast.SetOp))):
                try:
                    await self._execute_streaming_portal(portal, st0,
                                                         max_rows)
                except Exception:
                    # never resume a broken iterator — and close it NOW so
                    # session-scope state (pg_stat_activity 'active',
                    # QUERIES_ACTIVE) never waits for GC
                    _close_portal_stream(portal)
                    raise
                await self.w.flush()
                return
            if portal.pending is None:
                portal.pending = await loop.run_in_executor(
                    self.server.pool,
                    functools.partial(self.conn.execute_statement, st0,
                                      portal.params,
                                      sql_text=portal.prepared.sql))
                portal.sent = 0
            res = portal.pending
            total = res.batch.num_rows
            if max_rows and res.batch.num_columns and \
                    portal.sent + max_rows < total:
                # partial page: rows then PortalSuspended (reference:
                # portals with row-budget paging, pg_wire_session.h:293-300)
                page = res.batch.slice(portal.sent,
                                       portal.sent + max_rows)
                portal.sent += max_rows
                self.w.data_rows(page, portal.result_fmts)
                self.w.msg(b"s")           # PortalSuspended
            else:
                remainder = res
                if res.batch.num_columns and portal.sent:
                    from ..engine import QueryResult as _QR
                    remainder = _QR(res.batch.slice(portal.sent, total),
                                    res.command_tag)
                self._send_result(remainder, describe=False,
                                  fmts=portal.result_fmts)
                portal.pending = None
                portal.sent = 0
        except errors.SqlError as e:
            self._note_error()
            self.w.error(e)
            self.ignore_till_sync = True
        except Exception as e:
            log.error("pg", f"internal error: {e!r}")
            self._note_error()
            self.w.error(errors.SqlError("XX000", f"internal error: {e}"))
            self.ignore_till_sync = True
        await self.w.flush()

    async def _execute_streaming_portal(self, portal: Portal, st,
                                        max_rows: int):
        """Extended-protocol streaming Execute: DataRows flush per
        executor batch; a row budget suspends the portal mid-stream
        without materializing the rest (reference: wire_collector.h:20-60
        + portal row-budget paging, pg_wire_session.h:293-300)."""
        loop = asyncio.get_running_loop()
        if portal.stream is None:
            names, types, it = await loop.run_in_executor(
                self.server.pool,
                functools.partial(self.conn.execute_streaming, st,
                                  portal.params,
                                  sql_text=portal.prepared.sql))
            portal.stream = {"it": it, "leftover": None, "total": 0}
        s = portal.stream
        it = s["it"]
        budget = max_rows if max_rows else None
        while True:
            b = s["leftover"]
            s["leftover"] = None
            if b is None:
                b = await loop.run_in_executor(self.server.pool,
                                               lambda: next(it, None))
            if b is None:
                self.w.command_complete(f"SELECT {s['total']}")
                portal.stream = None
                break
            if budget is not None and b.num_rows > budget:
                s["leftover"] = b.slice(budget, b.num_rows)
                b = b.slice(0, budget)
            if b.num_rows:
                self.w.data_rows(b, portal.result_fmts)
                s["total"] += b.num_rows
                if budget is not None:
                    budget -= b.num_rows
                await self.w.flush()   # backpressure via transport drain
            if budget == 0:
                self.w.msg(b"s")       # PortalSuspended
                break

    async def _on_close(self, payload: bytes):
        kind = payload[:1]
        name = payload[1:-1].decode()
        if kind == b"S":
            self.prepared.pop(name, None)
        else:
            _close_portal_stream(self.portals.pop(name, None))
        self.w.close_complete()
        await self.w.flush()

    async def _on_sync(self, payload: bytes):
        self.ignore_till_sync = False
        self._drain_notifications()
        self.w.ready(self._txn_status())
        await self.w.flush()

    async def _on_flush(self, payload: bytes):
        await self.w.flush()


def _decode_param(raw: bytes, fmt: int, oid: int = 0):
    if fmt == 1:
        # binary params: the Parse-declared OID disambiguates same-width
        # types (float8 vs int8); length alone is a fallback for OID 0
        if oid == 700:
            return struct.unpack("!f", raw)[0]
        if oid == 701:
            return struct.unpack("!d", raw)[0]
        if oid == 16:
            return raw != b"\x00"
        if oid == 25 or oid == 1043:
            return raw.decode()
        if len(raw) == 4:
            return struct.unpack("!i", raw)[0]
        if len(raw) == 8:
            return struct.unpack("!q", raw)[0]
        if len(raw) == 2:
            return struct.unpack("!h", raw)[0]
        raise errors.unsupported("binary parameter format for this type")
    text = raw.decode()
    # the wire gives no context for parameter typing here (the reference
    # resolves param types at bind through the planner); numeric-looking
    # text coerces to numbers, and _coerce casts on insert fix up the rest
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    return text


def _count_params(st: ast.Statement) -> int:
    mx = 0

    def walk_expr(e):
        nonlocal mx
        if isinstance(e, ast.Param):
            mx = max(mx, e.index)
        for attr in ("left", "right", "operand", "low", "high", "pattern",
                     "else_"):
            v = getattr(e, attr, None)
            if isinstance(v, ast.Expr):
                walk_expr(v)
        for attr in ("args", "items"):
            for v in getattr(e, attr, []) or []:
                if isinstance(v, ast.Expr):
                    walk_expr(v)
        if isinstance(e, ast.Case):
            for c, v in e.branches:
                walk_expr(c)
                walk_expr(v)

    def walk_stmt(s):
        if isinstance(s, ast.Select):
            for it in s.items:
                walk_expr(it.expr)
            for e in ([s.where] if s.where else []) + s.group_by + \
                    ([s.having] if s.having else []):
                walk_expr(e)
            for oi in s.order_by:
                walk_expr(oi.expr)
        elif isinstance(s, ast.Insert):
            for row in s.values or []:
                for e in row:
                    walk_expr(e)
            if s.query:
                walk_stmt(s.query)
        elif isinstance(s, (ast.Delete, ast.Update)):
            if s.where:
                walk_expr(s.where)
            if isinstance(s, ast.Update):
                for _, e in s.assignments:
                    walk_expr(e)

    walk_stmt(st)
    return mx


def _remove_stale_unix_socket(path: str) -> None:
    """Unlink `path` only when it is a socket nobody answers on — a live
    server's socket raises 98 (address in use) instead of being stolen,
    and a regular file at the path is never deleted."""
    import socket as _socket
    import stat as _stat
    try:
        st = os.stat(path)
    except OSError:
        return
    if not _stat.S_ISSOCK(st.st_mode):
        raise errors.SqlError(
            "58030", f"listen path {path!r} exists and is not a socket")
    probe = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    probe.settimeout(1.0)
    try:
        probe.connect(path)
        probe.close()
        raise errors.SqlError(
            "55006", f"unix socket {path!r} is in use by a live server")
    except _socket.timeout:
        # a connect timeout is NOT proof of death — a live server with a
        # full accept backlog looks exactly like this. Never steal the
        # path; report it busy (reference: 55006 object_in_use).
        probe.close()
        raise errors.SqlError(
            "55006", f"unix socket {path!r} did not answer within 1s; "
            "assuming a live (busy) server owns it")
    except (ConnectionRefusedError, FileNotFoundError):
        probe.close()
        try:
            os.unlink(path)   # stale socket from a crashed process
        except OSError:
            pass
    except OSError:
        probe.close()


class PgServer:
    def __init__(self, db: Database, host: str = "127.0.0.1",
                 port: int = 5432, password: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 hba_conf: Optional[str] = None,
                 proxy_protocol: str = "off",
                 listen: Optional[list[str]] = None,
                 pool=None):
        self.db = db
        #: extra listener specs (tcp://… / unix://…) beyond host:port
        #: (reference: listen_spec.h multi-spec --listen)
        self.listen_specs = list(listen or [])
        #: HAProxy PROXY preface handling: off | optional | require
        #: (reference: server/network/proxy_protocol.cpp)
        self.proxy_protocol = proxy_protocol
        self.host = host
        self.port = port
        self.password = password
        self.password_verifier = None
        if password is not None:
            self.password_verifier = scram.build_verifier(password)
        # TLS: in-band upgrade on SSLRequest (reference: tls_context.cpp)
        self.tls_context = None
        if tls_cert is not None:
            import ssl as ssl_mod
            ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
            ctx.minimum_version = ssl_mod.TLSVersion.TLSv1_2
            ctx.load_cert_chain(tls_cert, tls_key)
            self.tls_context = ctx
        # HBA: None = implicit policy; text/path = pg_hba-style rules
        self.hba_rules = None
        if hba_conf is not None:
            self.set_hba(hba_conf)
        self._cancel_keys: dict[tuple[int, int], PgSession] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        # the session executor (the engine boundary): when the front
        # door hosts this server it passes its shared pool so BOTH
        # protocols draw on one bounded executor
        if pool is not None:
            self.pool = pool
            self._owns_pool = False
        else:
            import concurrent.futures
            self.pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(4, (os.cpu_count() or 4)))
            self._owns_pool = True

    def set_hba(self, conf: str) -> None:
        """Install pg_hba rules from conf text or a file path (runtime
        reconfigurable, matching the reference's SET hba)."""
        if "\n" not in conf and os.path.exists(conf):
            with open(conf) as f:
                conf = f.read()
        self.hba_rules = hba.parse_hba(conf)

    def register_cancel(self, pid: int, key: int, session: PgSession):
        self._cancel_keys[(pid, key)] = session

    def unregister_cancel(self, pid: int, key: int):
        self._cancel_keys.pop((pid, key), None)

    def cancel(self, pid: int, key: int):
        """CancelRequest: interrupt the session's in-flight statement
        (reference: CancelRegistry, cancel_registry.h). Cooperative — the
        executor raises 57014 at its next batch boundary."""
        session = self._cancel_keys.get((pid, key))
        if session is None or session.conn is None:
            log.info("pg", f"cancel request for unknown {pid}/{key}")
            return
        log.info("pg", f"cancel request for {pid}/{key}")
        session.conn.request_cancel()

    def _accept(self, reader, writer):
        # sync accept callback (runs inside connection_made): stamp NOW
        # so the accept→serve gap feeds the AcceptQueueWait histogram
        return self._client(reader, writer, time.monotonic_ns())

    async def _client(self, reader, writer, accept_ns=None):
        from ..sched.governor import CONNGATE
        info = CONNGATE.try_admit(
            "pg", writer.get_extra_info("peername"), accept_ns)
        if info is None:
            # socket-level admission: a clean 53300 ErrorResponse before
            # reading — let alone parsing — a single byte of the session
            w = Writer(writer)
            w.error(errors.SqlError(
                errors.TOO_MANY_CONNECTIONS,
                "sorry, too many clients already",
                hint="raise serene_max_connections or close idle "
                     "connections"))
            try:
                await w.flush()
            except (ConnectionResetError, RuntimeError):
                pass
            writer.close()
            return
        conns = getattr(self, "_live_writers", None)
        if conns is None:
            conns = self._live_writers = set()
        conns.add(writer)
        info.buffered = writer.transport.get_write_buffer_size
        try:
            await PgSession(self, reader, writer, gate_info=info).run()
        finally:
            CONNGATE.release(info)
            conns.discard(writer)

    async def start(self):
        from .listen import parse_listen_spec

        # warm the SHARED morsel worker pool at server start: every
        # session's parallel pipelines run on this one pool, so worker
        # count never multiplies with connection count (reference: one
        # TaskScheduler shared by all DuckDB connections)
        from ..parallel.pool import get_pool
        get_pool().ensure_started()
        self._server = await asyncio.start_server(
            self._accept, self.host, self.port)
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]
        log.info("pg", f"listening on {addr[0]}:{addr[1]}")
        self._extra_servers = []
        self._unix_paths = []
        for raw in self.listen_specs:
            spec = parse_listen_spec(raw, default_host=self.host)
            if spec.kind == "unix":
                _remove_stale_unix_socket(spec.path)
                srv = await asyncio.start_unix_server(
                    self._accept, path=spec.path)
                self._unix_paths.append(spec.path)
            else:
                srv = await asyncio.start_server(
                    self._accept, spec.host, spec.port)
            self._extra_servers.append(srv)
            log.info("pg", f"listening on {spec}")

    async def stop(self):
        # ordered teardown (reference serened.cpp): stop accepting, then
        # close live client transports — wait_closed() would otherwise
        # block forever on an idle connected client
        if self._server is not None:
            self._server.close()
        for srv in getattr(self, "_extra_servers", []):
            srv.close()
        for w in list(getattr(self, "_live_writers", ())):
            try:
                w.close()
            except Exception:  # noqa: BLE001
                pass
        if self._server is not None:
            await self._server.wait_closed()
        for srv in getattr(self, "_extra_servers", []):
            await srv.wait_closed()
        for path in getattr(self, "_unix_paths", []):
            try:
                os.unlink(path)
            except OSError:
                pass
        if getattr(self, "_owns_pool", True):
            self.pool.shutdown(wait=False)

    def run_forever(self):
        async def main():
            await self.start()
            await asyncio.Event().wait()
        asyncio.run(main())
