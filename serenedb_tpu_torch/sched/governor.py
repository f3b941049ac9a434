"""Copied from serenedb_tpu/sched/governor.py.

Workload governor: admission control for concurrent statements.

Reference analog: the reference engine survives production traffic
because a scheduler arbitrates many concurrent statements over shared
task queues and bounded memory (PAPER.md: DuckDB's task scheduler plus
three thread pools; SURVEY.md §3.2). This module is the statement-level
half of that story — the layer between statement dispatch (engine.py)
and the shared worker pool (parallel/pool.py):

- **Admission control** — at most `serene_max_concurrent_statements`
  statements EXECUTE at once; later arrivals wait in a bounded FIFO
  queue (`serene_admission_queue_depth`), visible as pg_stat_activity
  state ``queued`` with an ``Admission/AdmissionQueue`` wait event and
  a ``queue_wait``-category span in the statement's timeline trace.
  Queue overflow rejects immediately with SQLSTATE 53300 —
  backpressure, not an unbounded convoy. Waiting statements keep
  honoring cancel and statement timeouts (the wait loop polls
  `Connection.check_cancel`), so a queued statement can be cancelled
  exactly like a running one.

- **Statement identity for fair-share scheduling** — every statement
  gets a scheduling tag + weight (`serene_priority`) published on its
  connection (`Connection._sched`) and overridable through the
  `CURRENT_SCHED` contextvar; the worker pool keys its stride
  scheduler on it (parallel/pool.py).

The governor steers WHEN statements run, never what they return:
admission order and fair-share picking change scheduling only, and the
deterministic merge sinks guarantee bit-identical results at any
setting (tests/test_admission.py parity matrix). Memory budgets
(`serene_work_mem` → SQLSTATE 53200) and `serene_statement_timeout_ms`
are enforced cooperatively at the existing `check_cancel` sites in
engine.py — the governor only provides the queueing tier they pair
with.

Exemptions: utility statements (SET/SHOW/txn control — engine.py's
`_UNTRACED_STATEMENTS` gate) and catalog-only introspection reads
(`admission_exempt`) bypass admission, so the dashboards that diagnose
an overloaded server never queue behind the overload they are
diagnosing.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import threading
import time
from typing import Optional

from .. import errors
from ..utils import metrics

#: explicit (tag, weight) scheduling override for code that submits
#: pool tasks outside any statement (tests, maintenance); when unset,
#: the pool falls back to the submitting connection's `_sched` pair
CURRENT_SCHED: contextvars.ContextVar = contextvars.ContextVar(
    "sdb_current_sched", default=None)

_STMT_TAGS = itertools.count(1)

#: seconds between cancel/timeout polls while queued for admission — a
#: queued statement reacts to CancelRequest / statement_timeout within
#: one poll interval
_QUEUE_POLL_S = 0.02


def next_stmt_tag() -> int:
    """Process-unique scheduling tag for one statement's pool tasks."""
    return next(_STMT_TAGS)


class AdmissionTicket:
    """Proof of one admit() — released exactly once at statement end.
    `nested` tickets (a statement on a connection that already holds a
    slot, e.g. interleaved with its own suspended streaming portal)
    never count against the limit: a single session cannot deadlock
    itself at serene_max_concurrent_statements = 1."""

    __slots__ = ("conn", "nested", "released")

    def __init__(self, conn, nested: bool):
        self.conn = conn
        self.nested = nested
        self.released = False


class Governor:
    """Process-wide admission gate (one instance, like the worker pool).

    `_running` counts only statements that went through `admit()`; the
    engine skips the whole gate while `enabled()` is false, so arming
    `serene_max_concurrent_statements` mid-traffic applies to
    statements STARTED after arming (see `enabled()`) — the trade for
    a default path that costs one global read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._running = 0
        self._queue: collections.deque = collections.deque()   # waiter ids

    # -- config ------------------------------------------------------------

    @staticmethod
    def _limits() -> tuple[int, int]:
        from ..utils.config import REGISTRY
        try:
            maxc = int(REGISTRY.get_global("serene_max_concurrent_statements"))
        except KeyError:                # pragma: no cover — always declared
            maxc = 0
        try:
            depth = int(REGISTRY.get_global("serene_admission_queue_depth"))
        except KeyError:                # pragma: no cover — always declared
            depth = 64
        return maxc, depth

    # -- admission ---------------------------------------------------------

    def enabled(self) -> bool:
        """Admission armed? Callers skip the whole gate (including the
        admission_exempt AST walk) when the limit is 0 — the default
        path costs one global read. Consequence: statements already
        running when the limit is first armed are not counted against
        it; the limit applies to statements admitted after arming."""
        return self._limits()[0] > 0

    def admit(self, conn=None, label: str = "",
              trace=None) -> AdmissionTicket:
        """Block until this statement may execute (or raise).

        Raises SqlError 53300 when the admission queue is at capacity,
        and re-raises whatever `conn.check_cancel()` raises while
        queued (57014 on cancel or statement timeout) — the waiter is
        dequeued on every exit path. On a waited admission the queue
        time lands in the Admission* gauges and, when `trace` is
        given, as a ``queue_wait``-category span."""
        held = getattr(conn, "_admission_held", 0) if conn is not None else 0
        if held > 0:
            # nested statement on a slot-holding connection: never a
            # second slot (self-deadlock at max=1), never a release of
            # the outer statement's slot
            conn._admission_held = held + 1
            return AdmissionTicket(conn, nested=True)
        maxc, depth = self._limits()
        w: Optional[object] = None
        with self._cv:
            if maxc <= 0 or (self._running < maxc and not self._queue):
                self._running += 1
                if conn is not None:
                    conn._admission_held = 1
                return AdmissionTicket(conn, nested=False)
            if len(self._queue) >= depth:
                metrics.ADMISSION_REJECTED.add()
                raise errors.SqlError(
                    errors.TOO_MANY_CONNECTIONS,
                    "statement rejected: admission queue is full "
                    f"({len(self._queue)} queued, "
                    f"serene_admission_queue_depth = {depth})",
                    hint="retry later, or raise "
                         "serene_max_concurrent_statements / "
                         "serene_admission_queue_depth")
            w = object()
            self._queue.append(w)
        # -- queued: surface it, then poll-wait honoring cancel/timeout
        metrics.ADMISSION_QUEUED.add()
        metrics.ADMISSION_QUEUE_DEPTH.add()
        t0 = time.perf_counter_ns()
        sess = None
        prev = (None, None, None)
        if conn is not None:
            sess = conn.db.sessions.get(conn._session_id)
        if sess is not None:
            prev = (sess.get("state"), sess.get("wait_event_type"),
                    sess.get("wait_event"))
            sess["state"] = "queued"
            sess["wait_event_type"] = "Admission"
            sess["wait_event"] = "AdmissionQueue"
        admitted = False
        try:
            while not admitted:
                with self._cv:
                    maxc, _ = self._limits()
                    if (maxc <= 0 or self._running < maxc) and \
                            self._queue and self._queue[0] is w:
                        self._queue.popleft()
                        self._running += 1
                        admitted = True
                        self._cv.notify_all()
                        break
                    self._cv.wait(timeout=_QUEUE_POLL_S)
                if conn is not None:
                    conn.check_cancel()     # 57014 → finally dequeues
        finally:
            t1 = time.perf_counter_ns()
            metrics.ADMISSION_WAIT_NS.add(t1 - t0)
            metrics.ADMISSION_QUEUE_DEPTH.sub()
            if not admitted:
                with self._cv:
                    try:
                        self._queue.remove(w)
                    except ValueError:      # already popped
                        pass
                    self._cv.notify_all()
            if sess is not None:
                sess["state"], sess["wait_event_type"], \
                    sess["wait_event"] = prev
            if trace is not None:
                trace.add("queue_wait", "admission", t0, t1, label="queued")
        if conn is not None:
            conn._admission_held = 1
        return AdmissionTicket(conn, nested=False)

    def release(self, ticket: Optional[AdmissionTicket]) -> None:
        """Return a statement's hold; idempotent per ticket. The
        governor SLOT follows the connection's LAST outstanding hold,
        not the first-admitted ticket: a session that opens portal P1
        (slot), opens nested P2 on that slot, then closes P1 first
        must keep the slot occupied until P2 drains too — else the
        concurrency limit is exceeded while P2 still executes. Wakes
        the queue head so admission stays FIFO."""
        if ticket is None or ticket.released:
            return
        ticket.released = True
        conn = ticket.conn
        if conn is not None:
            held = max(0, getattr(conn, "_admission_held", 1) - 1)
            conn._admission_held = held
            if held > 0:
                return              # a sibling hold still owns the slot
        elif ticket.nested:
            return
        with self._cv:
            self._running = max(0, self._running - 1)
            self._cv.notify_all()

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        """One point-in-time governor view for /_stats, sdb_admission
        and tests."""
        maxc, depth = self._limits()
        with self._lock:
            running, queued = self._running, len(self._queue)
        return {"running": running, "queued": queued,
                "max_concurrent_statements": maxc,
                "queue_depth": depth,
                "queued_total": metrics.ADMISSION_QUEUED.value,
                "rejected_total": metrics.ADMISSION_REJECTED.value,
                "wait_ns_total": metrics.ADMISSION_WAIT_NS.value,
                "preemptions_total": metrics.SCHED_PREEMPTIONS.value}


#: process-wide governor (one per process, like the worker pool)
GOVERNOR = Governor()


# -- admission exemption ------------------------------------------------------

#: relation-name prefixes that mark catalog/introspection sources
_CATALOG_PREFIXES = ("pg_", "sdb_", "information_schema")


def _catalog_name(name: str) -> bool:
    return name.lower().startswith(_CATALOG_PREFIXES)


def admission_exempt(st) -> bool:
    """True when a statement may bypass admission control: a read
    (Select/SetOp) whose every table source is a system catalog
    (pg_* / sdb_* / information_schema relations or table functions) —
    or that references no table at all (``SELECT 1``). The dashboards
    that diagnose an overloaded server (`pg_stat_activity`,
    `sdb_admission`, `sdb_query_progress`) must not queue behind the
    overload they are diagnosing. Any user relation, and any table
    source the walk does not positively recognize as catalog, makes
    the statement admissible like normal work."""
    import dataclasses

    from ..sql import ast

    if not isinstance(st, (ast.Select, ast.SetOp)):
        return False

    def walk(node, depth: int = 0) -> bool:
        """False the moment a non-catalog table source is seen."""
        if depth > 200:
            return False    # fail CLOSED: an unwalkably deep statement
            #                 is admitted like normal work, never exempt
        if node is None:
            return True
        if isinstance(node, ast.NamedTable):
            # the relation name or its schema qualifier may mark the
            # catalog: information_schema.tables, pg_catalog.pg_class
            return _catalog_name(node.parts[-1]) or \
                (len(node.parts) >= 2 and _catalog_name(node.parts[-2]))
        if isinstance(node, ast.TableFunction):
            return _catalog_name(node.name)
        if isinstance(node, ast.TableRef) and \
                not isinstance(node, (ast.SubqueryRef, ast.JoinRef)):
            # a table-source kind this walk doesn't know (file sources,
            # future VALUES lists): not provably catalog → admit
            return False
        if isinstance(node, (list, tuple)):
            return all(walk(v, depth + 1) for v in node)
        if isinstance(node, dict):
            return all(walk(v, depth + 1) for v in node.values())
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return all(walk(getattr(node, f.name), depth + 1)
                       for f in dataclasses.fields(node))
        return True

    return walk(st)


# -- socket-level admission ---------------------------------------------------


class ConnInfo:
    """One open front-door socket (server/frontdoor.py, server/pgwire.py)
    as the connection gate tracks it: a virtual pid (process-unique,
    monotonically assigned — the sdb_connections analog of a backend
    pid), the protocol frontend, a coarse state machine
    (active ⇄ idle), and activity timestamps for idle_s."""

    __slots__ = ("pid", "protocol", "peer", "state", "connected_ns",
                 "last_ns", "buffered")

    def __init__(self, pid: int, protocol: str, peer: str):
        self.pid = pid
        self.protocol = protocol
        self.peer = peer
        self.state = "active"        # accept/handshake counts as active
        self.connected_ns = time.monotonic_ns()
        self.last_ns = self.connected_ns
        #: callable -> bytes currently sitting in this connection's
        #: transport write buffer (set by the owning frontend; sampled
        #: for the SocketBytesBuffered gauge and sdb_connections)
        self.buffered = None


class ConnectionGate:
    """Admission control at the SOCKET, the layer below the statement
    governor above: `serene_max_connections` caps how many sockets the
    front door holds open across BOTH protocols, and an accept past the
    cap is rejected before a single byte of the session is parsed
    (pgwire: a clean 53300 ErrorResponse; HTTP: 429 + Retry-After).
    The statement governor then arbitrates what the admitted
    connections may RUN — two gates, one backpressure story.

    Also the socket layer's observability spine: the
    Connections{Open,Idle,Active,Rejected} gauges, the AcceptQueueWait
    histogram, `/_stats.connections` and the `sdb_connections()`
    relation all read from here."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conns: dict[int, ConnInfo] = {}
        self._pids = itertools.count(1)
        self._pauses = 0

    @staticmethod
    def limit() -> int:
        from ..utils.config import REGISTRY
        return int(REGISTRY.get_global("serene_max_connections") or 0)

    def try_admit(self, protocol: str, peer,
                  accept_ns: Optional[int] = None) -> Optional[ConnInfo]:
        """Admit one socket or return None (caller sends the protocol's
        rejection packet and closes). accept_ns is the monotonic stamp
        taken when the OS handed us the socket — the gap to now is the
        event-loop accept backlog (AcceptQueueWait)."""
        if accept_ns is not None:
            metrics.ACCEPT_QUEUE_WAIT_HIST.observe_ns(
                max(0, time.monotonic_ns() - accept_ns))
        if isinstance(peer, tuple):
            peer = f"{peer[0]}:{peer[1]}"
        limit = self.limit()
        with self._lock:
            if limit and len(self._conns) >= limit:
                metrics.CONNECTIONS_REJECTED.add(1)
                return None
            info = ConnInfo(next(self._pids), protocol, str(peer or ""))
            self._conns[info.pid] = info
        metrics.CONNECTIONS_OPEN.add(1)
        metrics.CONNECTIONS_ACTIVE.add(1)
        return info

    def set_state(self, info: ConnInfo, state: str) -> None:
        """active ⇄ idle transition; maintains the live gauges and the
        idle_s clock (touch on every transition)."""
        if info.state == state:
            return
        if info.state == "idle":
            metrics.CONNECTIONS_IDLE.sub(1)
        elif info.state == "active":
            metrics.CONNECTIONS_ACTIVE.sub(1)
        info.state = state
        info.last_ns = time.monotonic_ns()
        if state == "idle":
            metrics.CONNECTIONS_IDLE.add(1)
        else:
            metrics.CONNECTIONS_ACTIVE.add(1)

    def note_pause(self) -> None:
        """A frontend paused reading on a slow-writer connection."""
        with self._lock:
            self._pauses += 1

    def release(self, info: Optional[ConnInfo]) -> None:
        if info is None:
            return
        with self._lock:
            if self._conns.pop(info.pid, None) is None:
                return
        metrics.CONNECTIONS_OPEN.sub(1)
        if info.state == "idle":
            metrics.CONNECTIONS_IDLE.sub(1)
        else:
            metrics.CONNECTIONS_ACTIVE.sub(1)

    # -- introspection ----------------------------------------------------

    def buffered_bytes(self) -> int:
        """Sum of transport write-buffer bytes across open connections
        (sampled — feeds the SocketBytesBuffered gauge at scrape)."""
        total = 0
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            fn = c.buffered
            if fn is not None:
                try:
                    total += int(fn())
                except Exception:  # noqa: BLE001 — transport closing
                    pass
        metrics.SOCKET_BYTES_BUFFERED.set(total)
        return total

    def rows(self) -> list[dict]:
        """sdb_connections(): one row per open front-door socket —
        the pg_stat_activity analog for the socket layer."""
        now = time.monotonic_ns()
        out = []
        with self._lock:
            conns = sorted(self._conns.values(), key=lambda c: c.pid)
        for c in conns:
            buffered = 0
            if c.buffered is not None:
                try:
                    buffered = int(c.buffered())
                except Exception:  # noqa: BLE001
                    pass
            out.append({
                "pid": c.pid, "protocol": c.protocol, "state": c.state,
                "idle_s": round((now - c.last_ns) / 1e9, 3)
                if c.state == "idle" else 0.0,
                "peer": c.peer,
                "connected_s": round((now - c.connected_ns) / 1e9, 3),
                "buffered_bytes": buffered})
        return out

    def snapshot(self) -> dict:
        """The `/_stats.connections` section."""
        with self._lock:
            open_ = len(self._conns)
            idle = sum(1 for c in self._conns.values()
                       if c.state == "idle")
            pauses = self._pauses
        return {"open": open_, "idle": idle, "active": open_ - idle,
                "max_connections": self.limit(),
                "rejected_total": metrics.CONNECTIONS_REJECTED.value,
                "pause_reads_total": pauses,
                "buffered_bytes": self.buffered_bytes()}


#: process-wide socket gate (one per process, like GOVERNOR above)
CONNGATE = ConnectionGate()
