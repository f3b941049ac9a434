"""Copied from serenedb_tpu/utils/log.py.

Topic-based logging with an in-memory, SQL-queryable ring.

Reference analog: SDB_* macros routing into DuckDB's LogManager so logs are
queryable via `SELECT * FROM sdb_log` (reference: libs/basics/log.h:40-118,
CLAUDE.md:22-23). Here: a process-wide ring buffer of structured records that
the sdb_log system view reads, plus optional stdout/file emission.
"""

from __future__ import annotations

import collections
import enum
import os
import sys
import threading
import time
from dataclasses import dataclass


class Level(enum.IntEnum):
    TRACE = 0
    DEBUG = 1
    INFO = 2
    WARN = 3
    ERROR = 4
    FATAL = 5


@dataclass
class Record:
    ts: float
    level: Level
    topic: str
    message: str


class LogManager:
    def __init__(self, capacity: int = 8192):
        self._ring: collections.deque[Record] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.level = Level[os.environ.get("SERENE_LOG_LEVEL", "INFO").upper()] \
            if os.environ.get("SERENE_LOG_LEVEL", "INFO").upper() in Level.__members__ \
            else Level.INFO
        self.topic_levels: dict[str, Level] = {}
        self.stdout = os.environ.get("SERENE_LOG_STDOUT", "0") == "1"
        self._file = None

    def set_file(self, path: str) -> None:
        self._file = open(path, "a", buffering=1)

    def enabled(self, level: Level, topic: str) -> bool:
        return level >= self.topic_levels.get(topic, self.level)

    def log(self, level: Level, topic: str, message: str) -> None:
        if not self.enabled(level, topic):
            return
        rec = Record(time.time(), level, topic, message)
        with self._lock:
            self._ring.append(rec)
        if self.stdout or level >= Level.ERROR:
            line = f"[{level.name}] {topic}: {message}"
            print(line, file=sys.stderr)
        if self._file is not None:
            self._file.write(
                f"{rec.ts:.6f} {level.name} {topic} {message}\n")

    def records(self) -> list[Record]:
        with self._lock:
            return list(self._ring)


MANAGER = LogManager()


def trace(topic, msg): MANAGER.log(Level.TRACE, topic, msg)
def debug(topic, msg): MANAGER.log(Level.DEBUG, topic, msg)
def info(topic, msg): MANAGER.log(Level.INFO, topic, msg)
def warn(topic, msg): MANAGER.log(Level.WARN, topic, msg)
def error(topic, msg): MANAGER.log(Level.ERROR, topic, msg)
