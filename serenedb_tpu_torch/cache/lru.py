"""Copied from serenedb_tpu/cache/lru.py.

Bytes-bounded LRU — the shared store under both cache tiers.

One lock, short critical sections (dict moves and integer bookkeeping;
values are stored by reference, never copied here). Recency is
last-ACCESS order: a get refreshes the entry, so a hot dashboard query
survives a scan of one-off statements.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Iterator, Optional


class _Entry:
    __slots__ = ("value", "nbytes", "hits")

    def __init__(self, value, nbytes: int):
        self.value = value
        self.nbytes = int(nbytes)
        self.hits = 0


class BytesLRU:
    """key → value with a byte budget. `on_evict(key, entry)` fires for
    every removal that is NOT an explicit caller `remove`/`clear` —
    callers use it to keep gauges honest."""

    def __init__(self, on_evict: Optional[Callable] = None):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[object, _Entry]" = OrderedDict()
        self._bytes = 0
        self._on_evict = on_evict

    def get(self, key):
        """The entry's value on a hit (recency refreshed), else None."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            e.hits += 1
            return e.value

    def put(self, key, value, nbytes: int, cap_bytes: int,
            cap_entries: int = 0) -> bool:
        """Insert/replace and evict LRU entries past `cap_bytes` (and
        past `cap_entries` when > 0 — many tiny entries cost sweep and
        lookup time even under the byte budget). A value larger than
        the whole cap is refused (False) — caching it would just evict
        everything else for a single entry."""
        nbytes = int(nbytes)
        if nbytes > cap_bytes:
            return False
        evicted = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = _Entry(value, nbytes)
            self._bytes += nbytes
            while self._entries and (
                    self._bytes > cap_bytes or
                    (cap_entries and len(self._entries) > cap_entries)):
                k, e = self._entries.popitem(last=False)
                self._bytes -= e.nbytes
                evicted.append((k, e))
        if self._on_evict is not None:
            for k, e in evicted:
                self._on_evict(k, e)
        return True

    def remove(self, key) -> Optional[_Entry]:
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                self._bytes -= e.nbytes
            return e

    def evict_where(self, pred: Callable) -> int:
        """Remove every entry where pred(key, entry) is true (the lazy
        sweep of superseded generations); fires on_evict per entry."""
        with self._lock:
            dead = [(k, e) for k, e in self._entries.items()
                    if pred(k, e)]
            for k, e in dead:
                del self._entries[k]
                self._bytes -= e.nbytes
        if self._on_evict is not None:
            for k, e in dead:
                self._on_evict(k, e)
        return len(dead)

    def items(self) -> Iterator[tuple]:
        """Point-in-time (key, entry) snapshot, LRU first."""
        with self._lock:
            return list(self._entries.items())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
