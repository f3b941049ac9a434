"""The device tier's program cache, readback and upload accounting (the
part of serenedb_tpu/obs/device.py the analytics path uses).

- `compiled(family, key, builder)`: the reference's jit ledger. The port
  has nothing to jit: a "program" is the lowered scan description that
  the device tier hands to its kernels, built once per key and kept in a
  bounded LRU (`serene_program_cache_entries`), with per-family hit and
  miss counts (`programs()`, gated on `serene_device_telemetry`, as the
  reference's ledger is).
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
from collections import OrderedDict
from typing import Callable

import numpy as np

from ..device import UPLOADS, mesh_device_index
from ..utils import metrics
from ..utils.config import REGISTRY as _settings


def _cap() -> int:
    return max(1, int(_settings.get_global("serene_program_cache_entries")))


def enabled() -> bool:
    """The telemetry switch the reference's ledger keys off."""
    return bool(_settings.get_global("serene_device_telemetry"))


class ProgramCache:
    """Bounded LRU of built programs keyed by (family, key), with
    per-family hit/miss/eviction counts."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._progs: OrderedDict = OrderedDict()
        self._fams: dict[str, dict] = {}

    def _count(self, family: str, what: str) -> None:
        fam = self._fams.setdefault(
            family, {"hits": 0, "misses": 0, "evictions": 0})
        fam[what] += 1

    def get(self, family: str, key: tuple, builder: Callable):
        k = (family, key)
        on = enabled()
        with self._lock:
            prog = self._progs.get(k)
            if prog is not None:
                self._progs.move_to_end(k)
                if on:
                    self._count(family, "hits")
                    metrics.DEVICE_PROGRAM_HITS.add()
                return prog
        prog = builder()
        with self._lock:
            self._progs[k] = prog
            if on:
                self._count(family, "misses")
                metrics.DEVICE_PROGRAM_MISSES.add()
            while len(self._progs) > _cap():
                (efam, _ekey), _ = self._progs.popitem(last=False)
                if on:
                    self._count(efam, "evictions")
                    metrics.DEVICE_PROGRAM_EVICTIONS.add()
        return prog

    def snapshot(self) -> list[dict]:
        """One row per program family, sorted (the reference's
        sdb_programs() relation, less its compile timings)."""
        with self._lock:
            per_fam: dict[str, int] = {}
            for fam, _k in self._progs:
                per_fam[fam] = per_fam.get(fam, 0) + 1
            # nothing is traced or compiled at query time: a miss is
            # the build, and there is no compile time to report
            return [{"family": fam, "entries": per_fam.get(fam, 0), **f,
                     "compiles": f["misses"], "storms": 0,
                     "compile_ms_total": None, "compile_ms_mean": None,
                     "last_compile_ms": None}
                    for fam, f in sorted(self._fams.items())]


PROGRAMS = ProgramCache()


def compiled(family: str, key: tuple, builder: Callable):
    """The program for `key`, built by `builder()` on a miss."""
    return PROGRAMS.get(family, key, builder)


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
    """The program ledger, the device column cache's, the posting pool's
    and the vector pool's summaries and the fused decline counts."""
    from ..exec.device_pipeline import DEVICE_CACHE
    from ..search.posting_pool import POOL
    from ..search.vector_store import VPOOL
    return {"programs": PROGRAMS.snapshot(),
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
