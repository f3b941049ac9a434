"""Copied from serenedb_tpu/utils/faults.py.

Deterministic fault-injection points.

Reference analog: SDB_IF_FAILURE / SDB_WAIT_ON_FAILURE named failure points
armed per session with `SET sdb_faults='name'` (reference:
libs/basics/debugging.h:28-99, server/query/config_variables.cpp:261-296).
Recovery tests arm a point (e.g. crash_before_search_wal_commit), crash the
process, restart, and verify the replayed state.

Unlike the reference these are always compiled in; arming is the gate.
`crash` uses os._exit to simulate a hard kill (no atexit/flush), which is
what recovery tests need.
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_armed: set[str] = set()


class FaultInjected(RuntimeError):
    def __init__(self, name: str):
        super().__init__(f"fault injected: {name}")
        self.name = name


def arm_from_spec(spec: str) -> None:
    """Apply a `SET sdb_faults` spec: 'a,b' arms; '+a' adds; '-a' removes;
    empty string clears (RESET semantics)."""
    with _lock:
        names = [s.strip() for s in spec.split(",") if s.strip()]
        if not names:
            _armed.clear()
            return
        if not any(n.startswith(("+", "-")) for n in names):
            _armed.clear()
        for n in names:
            if n.startswith("+"):
                _armed.add(n[1:])
            elif n.startswith("-"):
                _armed.discard(n[1:])
            else:
                _armed.add(n)


def armed(name: str) -> bool:
    with _lock:
        return name in _armed


def if_failure(name: str) -> None:
    """Raise FaultInjected if `name` is armed."""
    if armed(name):
        raise FaultInjected(name)


#: 'exit' hard-kills the process (the real crash semantics); 'raise' throws
#: FaultInjected so an in-process recovery harness can abandon the Database
#: (no close/flush) and reopen from disk — equivalent on-disk state to a
#: kill at the fault point, but runnable inside one pytest process.
_crash_mode = "exit"


def set_crash_mode(mode: str) -> None:
    global _crash_mode
    assert mode in ("exit", "raise")
    _crash_mode = mode


def crash_if_armed(name: str) -> None:
    """Hard-kill the process if `name` is armed (crash-recovery testing)."""
    if armed(name):
        if _crash_mode == "raise":
            raise FaultInjected(name)
        os._exit(137)


def clear() -> None:
    with _lock:
        _armed.clear()
