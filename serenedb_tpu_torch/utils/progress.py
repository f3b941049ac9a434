"""Copied from serenedb_tpu/utils/progress.py.

Cross-session command progress registry.

Reference analog: server/pg/progress_registry.h:40-56 — atomics per phase
powering the pg_stat_progress_* views (CopyFrom/CopyTo/CreateIndex/CTAS/
Analyze/Vacuum commands).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager


class ProgressRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._active: dict[int, dict] = {}
        self._next = 1

    @contextmanager
    def track(self, command: str, total: int = 0):
        with self._lock:
            pid = self._next
            self._next += 1
            rec = {"pid": pid, "command": command, "phase": "running",
                   "done": 0, "total": total}
            self._active[pid] = rec
        try:
            yield rec
        finally:
            with self._lock:
                self._active.pop(pid, None)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._active.values()]


REGISTRY = ProgressRegistry()
