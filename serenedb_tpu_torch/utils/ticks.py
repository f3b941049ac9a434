"""Copied from serenedb_tpu/utils/ticks.py.

Server-wide monotonic tick counter.

Reference analog: server/database/ticks.h:28-33 — ticks order catalog and WAL
operations; commit ticks are handed out strictly in WAL-append order
(reference invariant: server/query/transaction.h:61-70).
"""

from __future__ import annotations

import threading


class TickServer:
    def __init__(self, start: int = 0):
        self._tick = start
        self._lock = threading.Lock()

    def next(self, n: int = 1) -> int:
        """Reserve a band of n ticks; returns the first."""
        with self._lock:
            first = self._tick + 1
            self._tick += n
            return first

    def current(self) -> int:
        with self._lock:
            return self._tick

    def advance_to(self, tick: int) -> None:
        """Recovery: fast-forward past replayed ticks."""
        with self._lock:
            self._tick = max(self._tick, tick)
