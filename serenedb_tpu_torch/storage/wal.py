"""Copied from serenedb_tpu/storage/wal.py.

Per-database write-ahead log with tick-banded commits and delta replay.

Reference analog: SearchDbWal — ONE WAL per database shared by all tables so
cross-table commits are atomic; tick-banded records; zstd-compressed inline
chunks; 16 MB segment seal; GC by min committed tick; delta replay on boot
(reference: server/search/search_db_wal.h:50-205, .cpp, SURVEY.md §3.4/§3.5).

Record frame: [u32 len][u32 crc32(tick||payload)][u64 tick][payload];
payload is a zstd-1 compressed JSON header + arrow-IPC chunk blobs:

    {ops: [{table, kind: insert|delete|truncate, ...}]}

The tick lives OUTSIDE the compressed payload so the expensive encoding
(arrow IPC + zstd — the reference's per-thread ChunkWriter work,
duckdb_physical_search_insert.cpp:107-369) happens before the tick is
assigned: concurrent committers encode in parallel, enqueue (tick order ==
queue order), and a group-commit leader writes every pending frame with
ONE fsync.

Commit protocol (mirrors SearchTableTransaction::Commit,
search_table_transaction.cpp:117-211):
    1. fault point  crash_before_search_wal_commit
    2. append record, flush, fsync          ← durability point
    3. fault point  crash_after_search_wal_commit
    4. apply to in-memory tables (memory-only publish)
Recovery replays records with tick > the table's checkpointed tick.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

try:
    import zstandard
except ImportError:          # optional codec: zlib fallback below
    zstandard = None

from .. import errors
from ..columnar.arrow_io import batch_to_bytes, bytes_to_batch
from ..columnar.column import Batch
from ..utils import faults, log, metrics

SEGMENT_SEAL_BYTES = 16 << 20   # reference: 16 MB segment seal
_HDR = struct.Struct("<II")
# Segment header: magic + format version. Frames follow the 8-byte header.
# A version bump makes old segments fail loudly ("incompatible WAL version")
# instead of decoding as torn/corrupt frames.
# v3: delete_pk op kind (PK-based remove filters) — a v2 reader would
# silently skip the delete and resurrect rows, exactly what versioning
# is for.
SEGMENT_MAGIC = b"SDBWAL\x00\x03"


def _group_commit() -> bool:
    """serene_group_commit global: widens the leader's write window with a
    bounded queue re-drain before the fsync (off = one drain per fsync,
    the parity oracle for recovery tests)."""
    from ..utils.config import REGISTRY
    try:
        return bool(REGISTRY.get_global("serene_group_commit"))
    except KeyError:
        return True


@dataclass
class WalOp:
    table: str
    kind: str                       # insert | delete | delete_pk | truncate
    batch: Optional[Batch] = None   # insert payload
    #: delete: positional row indices (int64 array);
    #: delete_pk: {"cols": [pk column names], "keys": [key bytes]} —
    #: an order-preserving PK remove filter (reference:
    #: server/connector/key_encoding.cpp + search_remove_filter.*)
    rows: Optional[object] = None


@dataclass
class CommitRecord:
    tick: int
    ops: list[WalOp]


@dataclass
class _Pending:
    """One queued group-commit entry."""
    done: threading.Event
    tick: int = 0
    payload: bytes = b""
    error: Optional[BaseException] = None


def _encode_ops(ops: list[WalOp]) -> bytes:
    """Encode a commit's ops (tick-independent — the expensive leg, done
    OUTSIDE any commit lock)."""
    header = {"ops": []}
    blobs: list[bytes] = []
    for op in ops:
        entry = {"table": op.table, "kind": op.kind}
        if op.batch is not None:
            blob = batch_to_bytes(op.batch)
            entry["blob"] = len(blobs)
            blobs.append(blob)
        if op.kind == "delete_pk":
            import base64
            entry["pk_cols"] = list(op.rows["cols"])
            entry["keys"] = [base64.b64encode(k).decode()
                             for k in op.rows["keys"]]
        elif op.rows is not None:
            entry["rows"] = np.asarray(op.rows, dtype=np.int64).tolist()
        header["ops"].append(entry)
    hj = json.dumps(header).encode()
    parts = [struct.pack("<I", len(hj)), hj,
             struct.pack("<I", len(blobs))]
    for b in blobs:
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
    raw = b"".join(parts)
    return _compress(raw)


#: zstd frame magic — payloads self-describe their codec (zstd frames
#: start with this magic, zlib streams with 0x78), so a zlib-written
#: datadir always reads back under either install; zstd-written frames
#: fail loudly (58030) on a zlib-only install instead of decoding as
#: garbage
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _compress(raw: bytes) -> bytes:
    """zstd-1 when the optional module is present, zlib-1 otherwise.
    Both stamp a self-identifying header (zstd's frame magic vs zlib's
    0x78), so decode never needs out-of-band codec metadata."""
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=1).compress(raw)
    return zlib.compress(raw, 1)


def _decompress(payload: bytes) -> bytes:
    if payload[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise errors.SqlError(
                "58030", "WAL payload is zstd-compressed but the "
                "zstandard module is not installed")
        return zstandard.ZstdDecompressor().decompress(payload)
    return zlib.decompress(payload)


def _decode_record(tick: int, payload: bytes) -> CommitRecord:
    raw = _decompress(payload)
    off = 0
    (hlen,) = struct.unpack_from("<I", raw, off)
    off += 4
    header = json.loads(raw[off:off + hlen].decode())
    off += hlen
    (nblobs,) = struct.unpack_from("<I", raw, off)
    off += 4
    blobs = []
    for _ in range(nblobs):
        (blen,) = struct.unpack_from("<I", raw, off)
        off += 4
        blobs.append(raw[off:off + blen])
        off += blen
    ops = []
    for entry in header["ops"]:
        batch = bytes_to_batch(blobs[entry["blob"]]) \
            if "blob" in entry else None
        if entry["kind"] == "delete_pk":
            import base64
            rows = {"cols": entry["pk_cols"],
                    "keys": [base64.b64decode(k) for k in entry["keys"]]}
        else:
            rows = np.asarray(entry["rows"], dtype=np.int64) \
                if "rows" in entry else None
        ops.append(WalOp(entry["table"], entry["kind"], batch, rows))
    return CommitRecord(tick, ops)


class SearchDbWal:
    """Append-only segmented WAL for one database directory."""

    def __init__(self, wal_dir: str):
        self.dir = wal_dir
        os.makedirs(wal_dir, exist_ok=True)
        self._lock = threading.Lock()
        # group-commit queue: (tick, payload, Event) triples appended under
        # _pending_lock (tick order == queue order); a leader holding _lock
        # drains and writes all of them with one fsync
        self._pending_lock = threading.Lock()
        self._pending: list = []
        self._fh = None
        self._gen = 0
        self._bytes = 0
        self._poisoned: Optional[str] = None
        # per-segment max tick, maintained on append so GC doesn't re-read
        # sealed segments; lazily scanned for segments found at boot
        self._seg_max_tick: dict[int, int] = {}
        gens = self._generations()
        self._gen = (gens[-1] if gens else 0)

    # -- segment files -----------------------------------------------------

    def _seg_path(self, gen: int) -> str:
        return os.path.join(self.dir, f"{gen:012d}.wal")

    def _generations(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.endswith(".wal"):
                try:
                    out.append(int(name[:-4]))
                except ValueError:
                    continue
        return sorted(out)

    def _open_for_append(self):
        if self._fh is None:
            path = self._seg_path(self._gen)
            self._fh = open(path, "ab")
            self._bytes = self._fh.tell()
            if self._bytes == 0:
                try:
                    self._fh.write(SEGMENT_MAGIC)
                    self._fh.flush()
                except BaseException:
                    # a partial header must not stay ahead of later frames
                    # (the segment would be unrecoverable); reset so the
                    # next open retries a fresh header, poison if we can't
                    try:
                        self._fh.truncate(0)
                        self._fh.close()
                    except BaseException as exc2:
                        self._poisoned = repr(exc2)
                    self._fh = None
                    raise
                self._bytes = len(SEGMENT_MAGIC)

    def _seal_if_needed(self):
        if self._bytes >= SEGMENT_SEAL_BYTES:
            self._fh.close()
            self._fh = None
            self._gen += 1
            self._open_for_append()

    # -- commit ------------------------------------------------------------

    def commit_ops(self, ops: list[WalOp], ticks, on_tick=None) -> int:
        """Durably commit ops; returns the assigned tick. Encoding happens
        before the tick is assigned (parallel across committers); the tick
        is taken under the queue lock so queue order == tick order; a
        group-commit leader writes every queued frame with one fsync
        (reference: parallel sink ChunkWriters combined at Finalize,
        duckdb_physical_search_insert.h:46-61)."""
        faults.if_failure("search_wal_append_error")
        faults.crash_if_armed("crash_before_search_wal_commit")
        payload = _encode_ops(ops)
        entry = _Pending(threading.Event())
        with self._pending_lock:
            tick = ticks.next()
            entry.tick = tick
            entry.payload = payload
            self._pending.append(entry)
            if on_tick is not None:
                # runs under the queue lock: callers that sequence their
                # in-memory publishes by tick see every EARLIER-enqueued
                # commit's tick already recorded (enqueue order == tick
                # order, and both happen atomically here)
                on_tick(tick)
        while not entry.done.is_set():
            with self._lock:
                if entry.done.is_set():
                    break
                with self._pending_lock:
                    batch, self._pending = self._pending, []
                if not batch:
                    continue
                start_bytes = None
                try:
                    if self._poisoned is not None:
                        raise errors.SqlError(
                            "58030", "WAL poisoned by earlier write "
                            f"failure: {self._poisoned}")
                    self._open_for_append()
                    start_bytes = self._bytes
                    max_tick = 0
                    for e in batch:
                        tb = struct.pack("<Q", e.tick)
                        frame = _HDR.pack(
                            len(e.payload),
                            zlib.crc32(tb + e.payload)) + tb + e.payload
                        self._fh.write(frame)
                        self._bytes += len(frame)
                        max_tick = max(max_tick, e.tick)
                    # group-commit window: re-drain the queue for commits
                    # that enqueued while this leader was writing, so they
                    # ride THIS fsync instead of forcing their own. Bounded
                    # passes keep leader latency predictable; the rollback
                    # below covers every frame written since start_bytes,
                    # drained entries are failed with the batch on error.
                    if _group_commit():
                        for _ in range(4):
                            with self._pending_lock:
                                extra, self._pending = self._pending, []
                            if not extra:
                                break
                            for e in extra:
                                tb = struct.pack("<Q", e.tick)
                                frame = _HDR.pack(
                                    len(e.payload),
                                    zlib.crc32(tb + e.payload)) \
                                    + tb + e.payload
                                self._fh.write(frame)
                                self._bytes += len(frame)
                                max_tick = max(max_tick, e.tick)
                                batch.append(e)
                    t0 = time.perf_counter_ns()
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    metrics.WAL_FSYNCS.add()
                    metrics.WAL_FSYNC_HIST.observe_ns(
                        time.perf_counter_ns() - t0)
                    self._seg_max_tick[self._gen] = max(
                        self._seg_max_tick.get(self._gen, 0), max_tick)
                except BaseException as exc:
                    # Partially-written frames of the FAILED batch must not
                    # become durable behind a later commit's fsync — callers
                    # were told the commit failed and never published it, so
                    # recovery would replay ghosts. Roll the segment back to
                    # its pre-batch offset; if even that fails, poison the
                    # WAL so nothing can append after the garbage.
                    try:
                        if self._fh is not None and start_bytes is not None:
                            self._fh.truncate(start_bytes)
                            self._fh.seek(start_bytes)
                            # make the truncation itself durable: without
                            # this the failed frames may still hit disk via
                            # background writeback and replay as ghosts
                            os.fsync(self._fh.fileno())
                            self._bytes = start_bytes
                    except BaseException:
                        self._poisoned = repr(exc)
                    # the leader must fail EVERY drained follower — their
                    # frames were lost with this write and they would
                    # otherwise spin forever on an empty queue
                    for e in batch:
                        e.error = exc
                        e.done.set()
                    raise
                for e in batch:
                    e.done.set()
                # Seal OUTSIDE the rollback-protected region: the batch IS
                # durable, and rolling back to the old segment's pre-batch
                # offset after _fh swapped to the next generation would
                # zero-extend the fresh segment. A seal failure can leave
                # the open segment header-less, so poison instead of
                # letting later appends land in an unrecoverable file.
                try:
                    self._seal_if_needed()
                except BaseException as exc:
                    self._poisoned = repr(exc)
                    raise
        if entry.error is not None:
            raise entry.error
        metrics.WAL_COMMITS.add()
        faults.crash_if_armed("crash_after_search_wal_commit")
        return tick

    def append_commit(self, rec: CommitRecord) -> None:
        """Single-record append at a caller-chosen tick (tests/tools; the
        engine path is commit_ops)."""
        class _Fixed:
            def __init__(self, t):
                self.t = t

            def next(self):
                return self.t
        self.commit_ops(rec.ops, _Fixed(rec.tick))

    # -- recovery ----------------------------------------------------------

    def recover(self, committed_of: Callable[[str], int],
                apply_op: Callable[[int, WalOp], None]) -> int:
        """Delta replay: for every record, ops whose table's committed tick
        is below the record tick are re-applied (reference:
        SearchDbWal::Recover, search_db_wal.h:175-179). A torn/corrupt frame
        in the LAST segment is the uncommitted tail: it is truncated away so
        later appends never land behind garbage (which would make them
        unreachable on the next recovery). Corruption in an earlier, sealed
        segment aborts replay loudly; a segment written by a different WAL
        format version is an explicit 58030 "incompatible WAL version", not
        corruption semantics. Returns the highest tick seen."""
        max_tick = 0
        gens = self._generations()
        for gi, gen in enumerate(gens):
            path = self._seg_path(gen)
            with open(path, "rb") as f:
                data = f.read()
            if len(data) == 0:
                self._seg_max_tick[gen] = 0
                continue
            if data[:len(SEGMENT_MAGIC)] != SEGMENT_MAGIC:
                if SEGMENT_MAGIC.startswith(data):
                    # torn header write (strict prefix of the magic)
                    if gi == len(gens) - 1:
                        # last segment: the uncommitted tail — truncate
                        with open(path, "r+b") as f:
                            f.truncate(0)
                        self._seg_max_tick[gen] = 0
                        continue
                    # a sealed segment can never legitimately hold a bare
                    # prefix of the magic: that is corruption, not a
                    # format mismatch
                    raise errors.SqlError(
                        "58030",
                        f"WAL corruption in sealed segment {path}: torn "
                        "header")
                raise errors.SqlError(
                    "58030",
                    f"incompatible WAL version in {path}: expected format "
                    f"{SEGMENT_MAGIC[-1]} (header {SEGMENT_MAGIC!r})")
            off = len(SEGMENT_MAGIC)
            seg_max = 0
            while off + _HDR.size + 8 <= len(data):
                ln, crc = _HDR.unpack_from(data, off)
                start = off + _HDR.size + 8      # u64 tick after the crc
                end = start + ln
                torn = end > len(data)
                if not torn:
                    tick_bytes = data[off + _HDR.size:start]
                    payload = data[start:end]
                    torn = zlib.crc32(tick_bytes + payload) != crc
                if torn:
                    if gi != len(gens) - 1:
                        raise errors.SqlError(
                            "58030",
                            f"WAL corruption in sealed segment {path}")
                    log.warn("wal", f"torn tail in {path}: truncating at "
                                    f"{off}")
                    with open(path, "r+b") as f:
                        f.truncate(off)
                    self._seg_max_tick[gen] = seg_max
                    return max_tick
                rec = _decode_record(
                    struct.unpack("<Q", tick_bytes)[0], payload)
                max_tick = max(max_tick, rec.tick)
                seg_max = max(seg_max, rec.tick)
                for op in rec.ops:
                    if committed_of(op.table) < rec.tick:
                        apply_op(rec.tick, op)
                off = end
            # trailing partial header bytes (fewer than a frame header)
            if off < len(data):
                if gi != len(gens) - 1:
                    raise errors.SqlError(
                        "58030", f"WAL corruption in sealed segment {path}")
                log.warn("wal", f"partial tail header in {path}: truncating")
                with open(path, "r+b") as f:
                    f.truncate(off)
            self._seg_max_tick[gen] = seg_max
        return max_tick

    # -- GC ----------------------------------------------------------------

    def gc(self, min_committed_tick: int) -> int:
        """Drop sealed segments whose every record tick ≤ min committed tick
        across tables. Returns number of segments removed. Uses the
        in-memory per-segment max-tick map (maintained on append / replay)
        instead of re-reading segment contents."""
        removed = 0
        with self._lock:
            gens = self._generations()
            for gen in gens[:-1] if self._fh else gens:  # never the open one
                max_tick = self._seg_max_tick.get(gen)
                if max_tick is not None and max_tick <= min_committed_tick:
                    os.remove(self._seg_path(gen))
                    self._seg_max_tick.pop(gen, None)
                    removed += 1
                else:
                    break
        return removed

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
