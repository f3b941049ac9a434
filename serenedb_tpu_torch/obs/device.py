"""The device tier's program cache, readback and upload accounting (the
part of serenedb_tpu/obs/device.py the analytics path uses).

- `compiled(family, key, builder)`: the reference's compile ledger
  (`PROGRAMS`, a `ProgramLedger`). The port has nothing to jit: a
  "program" is the lowered scan description that the device tier hands
  to its kernels, built once per key and kept in a bounded LRU
  (`serene_program_cache_entries`). A family's compile is that build on
  a miss, and the first-use `nvcc` build of a kernel source (family
  `nvcc`); both are timed into the `DeviceCompile` histogram, stamped as
  `device_compile` spans and counted per family (`entries()`,
  `family()`, `snapshot()`), while `serene_device_telemetry` is on. Only
  a program's build is a cache miss, watched for recompile storms
  (`RECOMPILE_STORM_PER_MIN`): a kernel source builds once a process.
- `note_fused_decline(reason)` / `fused_declines()`: the fused tier's
  per-reason decline counts (queries that fell back to the host path).
- `stats_section()`: the program ledger, the device column cache, the
  posting and vector pools and the decline counts in one payload (the
  `/_stats` and `GET /device` body).
- `fetch_all(outs)`: device→host readback of a program's outputs as numpy
  arrays.
- `note_upload(nbytes)`: one host→device upload, counted in
  `device.UPLOADS`.
- `LEDGER`: the per-device ledger (dispatches, transfer bytes and times
  up and down), by mesh device: a logical device of a virtual mesh has
  its own row (`device.on_mesh_device`); kept while
  `serene_device_telemetry` is on, as the reference keeps its own.
- `device_rows` / `device_cache_rows`: the sdb_device and
  sdb_device_cache relations.
- `note_provider` / `provider_name`: publication token → table name, for
  the pools' rows.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

import numpy as np

from ..device import UPLOADS, mesh_device_index
from ..utils import log, metrics
from ..utils.config import REGISTRY as _settings


#: new builds of ONE family within a 60 s window that trip the
#: recompile-storm warning (a healthy steady state builds each query
#: shape once and hits forever after)
RECOMPILE_STORM_PER_MIN = 8
_STORM_WINDOW_S = 60.0
#: a family's storm re-warns at most this often
_STORM_RELOG_S = 30.0


def _cap() -> int:
    return max(1, int(_settings.get_global("serene_program_cache_entries")))


def enabled() -> bool:
    """The telemetry switch the reference's ledger keys off."""
    return bool(_settings.get_global("serene_device_telemetry"))


def _new_family() -> dict:
    return {"entries": 0, "compiles": 0, "hits": 0, "misses": 0,
            "evictions": 0, "compile_ns": 0, "timed": 0,
            "last_compile_ns": 0, "storms": 0}


class ProgramLedger:
    """Bounded LRU of built programs keyed by (family, key), with the
    reference's per-family statistics. The port has no XLA compile: a
    family's "compile" is the build of its program on a miss (the
    lowered scan description its kernels take), timed as the
    reference times a jitted program's first call, and the first-use
    `nvcc` build of a kernel source (family `nvcc`, `note_kernel_build`).
    Either stamps a `device_compile` span on the statement's trace; a
    program's miss also counts toward the recompile-storm warning."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._progs: OrderedDict = OrderedDict()
        self._fams: dict[str, dict] = {}
        self._storm_t: dict[str, deque] = {}
        self._storm_warned: dict[str, float] = {}

    def _fam(self, family: str) -> dict:
        f = self._fams.get(family)
        if f is None:
            f = self._fams[family] = _new_family()
        return f

    def _hit(self, family: str, profile, node_key) -> None:
        self._fam(family)["hits"] += 1
        metrics.DEVICE_PROGRAM_HITS.add()
        if profile is not None and node_key is not None:
            profile.stats(node_key).device_prog_hits += 1

    def get(self, family: str, key: tuple, builder: Callable,
            profile=None, node_key=None):
        k = (family, key)
        on = enabled()
        with self._lock:
            prog = self._progs.get(k)
            if prog is not None:
                self._progs.move_to_end(k)
                if on:
                    self._hit(family, profile, node_key)
                return prog
        t0 = time.perf_counter_ns()
        prog = builder()
        ns = time.perf_counter_ns() - t0
        with self._lock:
            cur = self._progs.get(k)
            if cur is not None:     # a racing build won: this one is dropped
                self._progs.move_to_end(k)
                if on:
                    self._hit(family, profile, node_key)
                return cur
            self._progs[k] = prog
            if on:
                self._miss(family, profile, node_key)
            # the cap bounds memory and holds with telemetry off too;
            # the counts move only while it is on
            while len(self._progs) > _cap():
                (efam, _ekey), _ = self._progs.popitem(last=False)
                if on:
                    self._fam(efam)["evictions"] += 1
                    metrics.DEVICE_PROGRAM_EVICTIONS.add()
            if on:
                metrics.DEVICE_PROGRAM_ENTRIES.set(len(self._progs))
        if on:
            self.record_compile_time(family, ns, t0)
        return prog

    def _miss(self, family: str, profile=None, node_key=None) -> None:
        """Under self._lock: one build of `family`'s program."""
        fam = self._fam(family)
        fam["misses"] += 1
        fam["compiles"] += 1
        metrics.DEVICE_PROGRAM_MISSES.add()
        metrics.DEVICE_PROGRAMS_COMPILED.add()
        if profile is not None and node_key is not None:
            profile.stats(node_key).device_prog_misses += 1
        self._note_storm(family, fam)

    def record_build(self, family: str, ns: int) -> None:
        """A build of `family` made outside the program cache that took
        `ns`, ending now: counted and timed as a compile, but no cache
        miss, so the program-cache metrics and the storm check keep to
        the cache's own programs."""
        with self._lock:
            self._fam(family)["compiles"] += 1
        self.record_compile_time(family, ns, time.perf_counter_ns() - ns)

    def _note_storm(self, family: str, fam: dict) -> None:
        """Under self._lock on every miss: a family building more than
        RECOMPILE_STORM_PER_MIN new programs a minute means repeat
        queries are not reusing them (a churning cache key)."""
        now = time.monotonic()
        dq = self._storm_t.setdefault(family, deque())
        dq.append(now)
        while dq and now - dq[0] > _STORM_WINDOW_S:
            dq.popleft()
        if len(dq) > RECOMPILE_STORM_PER_MIN and \
                now - self._storm_warned.get(family, -1e18) >= \
                _STORM_RELOG_S:
            self._storm_warned[family] = now
            fam["storms"] += 1
            metrics.DEVICE_RECOMPILE_STORMS.add()
            log.warn("device",
                     f"recompile storm: program family '{family}' "
                     f"built {len(dq)} new programs in the last 60s — "
                     "repeat queries are not reusing cached programs "
                     "(churning cache key, or serene_program_cache_"
                     "entries too small for the live query mix)")

    def record_compile_time(self, family: str, ns: int,
                            t0: Optional[int] = None) -> None:
        """One build of `family` that took `ns`, begun at `t0` on the
        perf_counter_ns clock (the `device_compile` span's start)."""
        with self._lock:
            f = self._fam(family)
            f["compile_ns"] += int(ns)
            f["timed"] += 1
            f["last_compile_ns"] = int(ns)
        metrics.DEVICE_COMPILE_HIST.observe_ns(ns)
        if t0 is not None:
            from .trace import current_trace
            tr = current_trace()
            if tr is not None:
                tr.add("device_compile", "device", t0, t0 + max(int(ns), 1),
                       family=family)

    def entries(self) -> int:
        with self._lock:
            return len(self._progs)

    def snapshot(self) -> list[dict]:
        """One row per program family, sorted: the sdb_programs()
        relation body."""
        with self._lock:
            per_fam: dict[str, int] = {}
            for fam, _k in self._progs:
                per_fam[fam] = per_fam.get(fam, 0) + 1
            return [{"family": fam, "entries": per_fam.get(fam, 0),
                     "compiles": f["compiles"], "hits": f["hits"],
                     "misses": f["misses"], "evictions": f["evictions"],
                     "storms": f["storms"],
                     "compile_ms_total": round(f["compile_ns"] / 1e6, 3),
                     "compile_ms_mean": round(
                         f["compile_ns"] / max(f["timed"], 1) / 1e6, 3),
                     "last_compile_ms": round(
                         f["last_compile_ns"] / 1e6, 3)}
                    for fam, f in sorted(self._fams.items())]

    def family(self, name: str) -> dict:
        with self._lock:
            return dict(self._fams.get(name) or _new_family())

    def clear(self) -> None:
        """Drop every cached program and the family statistics."""
        with self._lock:
            self._progs.clear()
            self._fams.clear()
            self._storm_t.clear()
            self._storm_warned.clear()
            metrics.DEVICE_PROGRAM_ENTRIES.set(0)


PROGRAMS = ProgramLedger()


def compiled(family: str, key: tuple, builder: Callable, *,
             profile=None, node_key=None):
    """The program for `key`, built by `builder()` on a miss.
    `profile`/`node_key` stamp the hit or miss on the plan operator, for
    EXPLAIN ANALYZE's `compile=hit|miss`."""
    return PROGRAMS.get(family, key, builder, profile=profile,
                        node_key=node_key)


def note_kernel_build(ns: int) -> None:
    """A kernel source's first-use `nvcc` build, taking `ns`: a compile
    of family `nvcc`, timed, and no program-cache miss."""
    if enabled():
        PROGRAMS.record_build("nvcc", int(ns))


# -- fused-tier decline accounting -------------------------------------------

#: reason slug → count of fused-tier declines (queries that fell back to
#: the host path, and why)
_FUSED_DECLINES: dict[str, int] = {}
_fused_declines_lock = threading.Lock()


def note_fused_decline(reason: str, profile=None, node_key=None) -> None:
    """One fused-tier fallback: count it per reason slug, bump the
    per-reason `DeviceFusedDeclines_<reason>` gauge, and stamp the reason
    onto the plan operator for EXPLAIN ANALYZE."""
    reason = str(reason)[:64]
    with _fused_declines_lock:
        _FUSED_DECLINES[reason] = _FUSED_DECLINES.get(reason, 0) + 1
    metrics.REGISTRY.gauge(
        f"DeviceFusedDeclines_{reason}",
        "fused device pipeline declines for this reason (query fell "
        "back to the host path)").add()
    if profile is not None and node_key is not None:
        profile.stats(node_key).device_declined = reason


def fused_declines() -> dict[str, int]:
    with _fused_declines_lock:
        return dict(sorted(_FUSED_DECLINES.items()))


def stats_section() -> dict:
    """The `/_stats` / `GET /device` payload: the per-device rows, the
    program ledger and its cache's size, the device column cache's, the
    posting pool's and the vector pool's summaries and the fused decline
    counts."""
    from ..exec.device_pipeline import DEVICE_CACHE
    from ..search.posting_pool import POOL
    from ..search.vector_store import VPOOL
    return {"devices": device_rows(),
            "programs": PROGRAMS.snapshot(),
            "program_cache": {"entries": PROGRAMS.entries(),
                              "cap": _cap()},
            "column_cache": DEVICE_CACHE.stats(),
            "posting_pool": POOL.stats(),
            "vector_pool": VPOOL.stats(),
            "fused_declines": fused_declines()}


def device_rows() -> list[dict]:
    """One row per mesh device (serenedb_tpu/obs/device.py
    `device_rows`): dispatches, transfer bytes and times up and down, and
    the live-bytes estimate (the device column cache, the posting pool
    and the vector pool, split by holding device). Lists every device of
    the mesh once a device is initialised (a passive probe, never
    initialising CUDA), else only those the ledger has seen."""
    from ..exec.device_pipeline import DEVICE_CACHE
    from ..parallel import mesh as mesh_mod
    from ..search.posting_pool import POOL
    from ..search.vector_store import VPOOL
    live = DEVICE_CACHE.device_bytes()
    for pool in (POOL, VPOOL):
        for i, n in pool.device_bytes().items():
            live[i] = live.get(i, 0) + n
    snap = LEDGER.snapshot()
    n_init = mesh_mod.device_count_if_initialized()
    placed = mesh_mod.devices() if n_init else []
    ids = sorted(set(snap) | set(live) | set(range(len(placed))))
    zeros = {f: 0 for f in _DEV_FIELDS}
    rows = []
    for i in ids:
        s = snap.get(i, zeros)
        dev = placed[i] if i < len(placed) else None
        rows.append({
            "device": i,
            "platform": dev.type if dev is not None else "",
            "kind": _device_kind(dev),
            "dispatches": s["dispatches"],
            "bytes_up": s["bytes_up"],
            "transfers_up": s["transfers_up"],
            "up_ms": round(s["up_ns"] / 1e6, 3),
            "bytes_down": s["bytes_down"],
            "transfers_down": s["transfers_down"],
            "down_ms": round(s["down_ns"] / 1e6, 3),
            "hbm_bytes_est": live.get(i, 0)})
    return rows


def _device_kind(dev) -> str:
    if dev is None:
        return ""
    if dev.type == "cuda":
        import torch
        return torch.cuda.get_device_name(dev)
    return dev.type


def device_cache_rows() -> list[dict]:
    """One row per DEVICE_CACHE entry with the provider token resolved
    to its table name: the per-publication/column occupancy view."""
    from ..exec.device_pipeline import DEVICE_CACHE
    rows = DEVICE_CACHE.snapshot()
    for r in rows:
        r["table"] = provider_name(r["token"])
    return rows


# -- the per-device ledger (copied from serenedb_tpu/obs/device.py) -----------

_DEV_FIELDS = ("dispatches", "bytes_up", "transfers_up", "up_ns",
               "bytes_down", "transfers_down", "down_ns")


class DeviceLedger:
    """Per-mesh-device counters: dispatches executed, bytes and time
    moved host→device and device→host."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dev: dict[int, dict] = {}

    def _slot(self, did: int) -> dict:
        d = self._dev.get(did)
        if d is None:
            d = self._dev[did] = {f: 0 for f in _DEV_FIELDS}
        return d

    def note_dispatch(self, did: int, n: int = 1) -> None:
        with self._lock:
            self._slot(int(did))["dispatches"] += int(n)

    def note_upload(self, nbytes: int, did: int, ns: int = 0) -> None:
        with self._lock:
            s = self._slot(int(did))
            s["bytes_up"] += int(nbytes)
            s["transfers_up"] += 1
            s["up_ns"] += int(ns)

    def note_fetch(self, nbytes: int, did: int, ns: int = 0) -> None:
        with self._lock:
            s = self._slot(int(did))
            s["bytes_down"] += int(nbytes)
            s["transfers_down"] += 1
            s["down_ns"] += int(ns)

    def snapshot(self) -> dict[int, dict]:
        with self._lock:
            return {i: dict(v) for i, v in self._dev.items()}

    def reset(self) -> None:
        with self._lock:
            self._dev.clear()


LEDGER = DeviceLedger()


def note_dispatch(did: int, n: int = 1) -> None:
    """`n` launches (kernels or plain versions) on mesh device `did`."""
    if enabled():
        LEDGER.note_dispatch(did, n)


# -- provider-token naming (copied from serenedb_tpu/obs/device.py) -----------

_TOKEN_NAMES: dict[int, str] = {}
_TOKEN_NAMES_MAX = 1024
_token_names_lock = threading.Lock()


def note_provider(token: int, name: str) -> None:
    """Remember a publication token's table name (pool entries carry
    only the token). Bounded FIFO."""
    if _TOKEN_NAMES.get(token) != name:
        with _token_names_lock:
            while len(_TOKEN_NAMES) >= _TOKEN_NAMES_MAX:
                _TOKEN_NAMES.pop(next(iter(_TOKEN_NAMES)))
            _TOKEN_NAMES[token] = str(name)


def provider_name(token: int) -> str:
    return _TOKEN_NAMES.get(token, "")


def fetch_all(outs) -> list:
    """Device→host readback: each output (tensor or number) as a numpy
    array, its bytes and time counted for the current mesh device."""
    t0 = time.perf_counter_ns()
    host = [o.cpu().numpy() if hasattr(o, "cpu") else np.asarray(o)
            for o in outs]
    if enabled():
        dev = next((o.device for o in outs if hasattr(o, "device")), None)
        LEDGER.note_fetch(sum(h.nbytes for h in host),
                          mesh_device_index(dev),
                          time.perf_counter_ns() - t0)
    return host


def note_upload(nbytes: int, device=None, ns: int = 0) -> None:
    """One host→device upload of `nbytes` to `device` (taking `ns`)."""
    UPLOADS.bump("transfers")
    UPLOADS.bump("bytes", int(nbytes))
    if enabled():
        LEDGER.note_upload(nbytes, mesh_device_index(device), ns)
