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
- `note_provider` / `provider_name`: publication token → table name, for
  the pools' rows. `device_rows` and `device_cache_rows` (the
  sdb_device and sdb_device_cache relations) raise: not ported yet.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np

from .. import errors
from ..device import UPLOADS
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
    """sdb_device's rows: the per-device transfer ledger is not ported
    (`device.UPLOADS` counts uploads for the whole process)."""
    raise errors.unsupported("sdb_device is not ported yet")


def device_cache_rows() -> list[dict]:
    """sdb_device_cache's rows: the per-entry view of the device column
    cache is not ported (its summary is in `stats_section`)."""
    raise errors.unsupported("sdb_device_cache is not ported yet")


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
    array."""
    return [o.cpu().numpy() if hasattr(o, "cpu") else np.asarray(o)
            for o in outs]


def note_upload(nbytes: int) -> None:
    UPLOADS.bump("transfers")
    UPLOADS.bump("bytes", int(nbytes))
