"""Copied from serenedb_tpu/storage/maintenance.py (each pass runs on the
database's device, see `run_once`; `stop` waits out a pass in flight).

Background maintenance: refresh + checkpoint loops.

Reference analog: per-target RefreshLoop + CompactionCoordinator coroutines
on the background pool, with a global compaction-slot semaphore
max(1, min(4, cores/2)) and idle backoff ×1.5 up to 5× (reference:
server/storage_engine/search_engine.h:46-123, server/search/task.cpp:85-380).

Here: a refresh thread rebuilds stale search indexes (publish = atomic dict
swap), and a checkpoint thread snapshots dirty stored tables so WAL segments
can be garbage-collected. Heavy rebuilds take a global slot, mirroring the
compaction cap. `run_once()` gives tests a deterministic handle."""

from __future__ import annotations

import os
import threading
import time

from ..utils import log, metrics

MAX_SLOTS = max(1, min(4, (os.cpu_count() or 2) // 2))


class MaintenanceManager:
    def __init__(self, db, refresh_interval: float = 0.25,
                 checkpoint_interval: float = 30.0,
                 checkpoint_wal_bytes: int = 8 << 20):
        self.db = db
        self.refresh_interval = refresh_interval
        self.checkpoint_interval = checkpoint_interval
        self.checkpoint_wal_bytes = checkpoint_wal_bytes
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._slots = threading.Semaphore(MAX_SLOTS)
        self._checkpointed_version: dict[str, int] = {}
        self._last_checkpoint = time.monotonic()
        #: set by the write path after an append publishes: the ticker
        #: wakes immediately (instead of riding out its idle backoff) to
        #: build the enqueued delta segments off the query path
        self._wake = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        t = threading.Thread(target=self._loop, name="serene-maintenance",
                             daemon=True)
        self._threads.append(t)
        t.start()

    def stop(self):
        """Join loops before teardown (the reference's stop protocol joins
        search loops before the pool dies, serened.cpp:86-130). The join
        waits out a pass in flight, however long its checkpoint takes: a
        closed or crashed database must leave no thread writing its data
        directory while the next one boots from it."""
        self._stop.set()
        self._wake.set()
        for t in self._threads:
            t.join()

    # -- loops -------------------------------------------------------------

    def notify_append(self):
        """Wake the ticker: an append just published, so a delta range is
        waiting to become a segment (one lock-free Event.set — cheap
        enough for the per-statement write path)."""
        self._wake.set()

    def _loop(self):
        idle = self.refresh_interval
        while not self._stop.is_set():
            self._wake.clear()
            did_work = False
            try:
                did_work = self.run_once()
            except Exception as e:  # maintenance must never die
                log.error("maintenance", f"loop error: {e!r}")
            if did_work:
                idle = self.refresh_interval
            else:
                # idle stretch ×1.5 capped at 5× (reference task.cpp:85-95)
                idle = min(idle * 1.5, self.refresh_interval * 5)
            if self._stop.is_set():
                break
            # appends cut the idle wait short so delta segments build
            # promptly in the background, narrowing the tail queries pay
            self._wake.wait(idle)

    def run_once(self) -> bool:
        """One maintenance pass; returns True if any work was done. Its
        index refreshes build on the database's device, under the same
        per-table rebuild lock as a query's read-repair
        (search.index._repair)."""
        if getattr(self.db, "_crashed", False):
            return False  # abandoned db must not checkpoint post-"kill"
        from ..device import building_on
        with building_on(self.db.device):
            return self._run_passes()

    def _run_passes(self) -> bool:
        # process-level gauges (RSS/uptime/GC) ride the existing ticker
        # so sdb_metrics stays fresh between scrapes; the /metrics and
        # /_stats renderers also sample at scrape time
        from ..obs.resources import sample_process_gauges
        sample_process_gauges()
        did = self._refresh_pass()
        did = self._checkpoint_pass() or did
        did = self._drop_gc_pass() or did
        return did

    def _drop_gc_pass(self) -> bool:
        """Reclaim tombstoned snapshots of dropped tables (the async-drop
        background half; reference: server/catalog/drop_task.cpp)."""
        store = self.db.store
        if store is None:
            return False
        n = store.gc_tombstones()
        if n:
            log.info("maintenance", f"reclaimed {n} dropped snapshot(s)")
        return bool(n)

    def _refresh_pass(self) -> bool:
        from ..engine import _refresh_indexes
        from ..search.index import needs_merge
        did = False
        with self.db.lock:
            tables = [t for s in self.db.schemas.values()
                      for t in s.tables.values()]
        for t in tables:
            idxs = getattr(t, "indexes", {})
            if any(ix.data_version != t.data_version or needs_merge(ix)
                   for ix in idxs.values()):
                with self._slots:
                    with metrics.REFRESH_ACTIVE.scoped():
                        _refresh_indexes(self.db, t)
                did = True
        return did

    def _checkpoint_pass(self) -> bool:
        store = self.db.store
        if store is None:
            return False
        due = (time.monotonic() - self._last_checkpoint
               >= self.checkpoint_interval) or \
            self._wal_bytes() >= self.checkpoint_wal_bytes
        if not due:
            return False
        from ..engine import StoredTable
        did = False
        with self.db.lock:
            tables = [t for s in self.db.schemas.values()
                      for t in s.tables.values()
                      if isinstance(t, StoredTable)]
        for t in tables:
            if self._checkpointed_version.get(t.key) == t.data_version:
                continue
            # batch + tick captured atomically vs DML of THIS table:
            # committed-but-unpublished fast-path inserts would be
            # missing from the batch yet covered by the tick
            with self.db.quiesced([t]):
                batch = t.full_batch()
                version = t.data_version
                tick = store.ticks.current()
            with metrics.COMPACTION_ACTIVE.scoped():
                store.checkpoint_table(t.key, t.table_id, batch, tick)
            self._checkpointed_version[t.key] = version
            did = True
        self._last_checkpoint = time.monotonic()
        return did

    def _wal_bytes(self) -> int:
        store = self.db.store
        total = 0
        try:
            for name in os.listdir(store.wal.dir):
                if name.endswith(".wal"):
                    total += os.path.getsize(os.path.join(store.wal.dir, name))
        except OSError:
            pass
        return total
