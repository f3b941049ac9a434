"""The device tier's program cache, readback and upload accounting (the
part of serenedb_tpu/obs/device.py the analytics path uses).

- `compiled(family, key, builder)`: the reference's jit ledger. The port
  has nothing to jit: a "program" is the lowered scan description that
  `exec/device_agg.py` hands to the `agg_scan` kernel, built once per key
  and kept in a bounded LRU (`serene_program_cache_entries`).
- `fetch_all(outs)`: device→host readback of a program's outputs as numpy
  arrays.
- `note_upload(nbytes)`: one host→device upload, counted in
  `device.UPLOADS`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np

from ..device import UPLOADS
from ..utils.config import REGISTRY as _settings


def _cap() -> int:
    return max(1, int(_settings.get_global("serene_program_cache_entries")))


class ProgramCache:
    """Bounded LRU of built programs keyed by (family, key)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._progs: OrderedDict = OrderedDict()

    def get(self, family: str, key: tuple, builder: Callable):
        k = (family, key)
        with self._lock:
            prog = self._progs.get(k)
            if prog is not None:
                self._progs.move_to_end(k)
                return prog
        prog = builder()
        with self._lock:
            self._progs[k] = prog
            while len(self._progs) > _cap():
                self._progs.popitem(last=False)
        return prog


PROGRAMS = ProgramCache()


def compiled(family: str, key: tuple, builder: Callable):
    """The program for `key`, built by `builder()` on a miss."""
    return PROGRAMS.get(family, key, builder)


def fetch_all(outs) -> list:
    """Device→host readback: each output (tensor or number) as a numpy
    array."""
    return [o.cpu().numpy() if hasattr(o, "cpu") else np.asarray(o)
            for o in outs]


def note_upload(nbytes: int) -> None:
    UPLOADS.bump("transfers")
    UPLOADS.bump("bytes", int(nbytes))
