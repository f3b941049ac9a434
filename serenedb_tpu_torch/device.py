"""Device choice and the kernel launch ledger.

`resolve_device` is the one place an entry point turns its `device`
argument into a `torch.device`: `cuda:0` by default, the CPU only when the
caller asks for it. There is no fallback — a missing card is an error, not
a slower run.

`LAUNCHES` counts kernel launches per wrapper (and plain-version calls
under `<name>.plain`), so a run can show that its main path went through
the hand kernels; each bump is also one dispatch of the current mesh
device in the per-device ledger (`obs.device.LEDGER`, `on_mesh_device`). `UPLOADS` counts host→device uploads (`transfers`) and
their `bytes`; `columnar.device.commit_host_array` is the one place that
bumps it. Together they stand in for the reference's dispatch/upload
ledger (serenedb_tpu/obs/device.py).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`cuda:0` unless the caller passes a CPU device; raise when the
    requested CUDA device is absent."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "serenedb_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


#: the device set by `building_on` (a database's boot, its maintenance
#: passes): index builds that run outside any statement
_BUILDING_ON: contextvars.ContextVar = contextvars.ContextVar(
    "serene_building_on", default=None)


def current_device() -> torch.device:
    """The device of the database whose statement is executing (its
    `Database(device=)`), or the one `building_on` set; `cuda:0`
    otherwise. Index builds and refreshes place their device state here,
    since they run inside CREATE INDEX, a query's read-repair, a durable
    database's boot or its maintenance thread."""
    dev = _BUILDING_ON.get()
    if dev is not None:
        return dev
    from .engine import CURRENT_CONNECTION
    conn = CURRENT_CONNECTION.get()
    return conn.db.device if conn is not None else resolve_device(None)


@contextlib.contextmanager
def building_on(device: torch.device):
    """Make `device` the current one for the work of this block, on this
    thread: index builds at boot and in the maintenance thread, which
    have no statement to take it from."""
    token = _BUILDING_ON.set(device)
    try:
        with device_scope(device):
            yield
    finally:
        _BUILDING_ON.reset(token)


#: the logical mesh device whose work runs on this thread
#: (`on_mesh_device`); None outside a mesh shard
_MESH_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "serene_mesh_device", default=None)


def mesh_device_index(device=None) -> int:
    """The per-device ledger's id of the work running on this thread: the
    logical mesh device `on_mesh_device` set, else the physical index of
    `device` (0 for the CPU or an unindexed device)."""
    i = _MESH_DEVICE.get()
    if i is not None:
        return i
    return int(getattr(device, "index", None) or 0)


@contextlib.contextmanager
def on_mesh_device(index: int, device: torch.device):
    """Run this block as logical mesh device `index`, placed on the
    physical `device`: its launches, uploads and fetches count for that
    logical device, and `device` is the thread's current CUDA device."""
    token = _MESH_DEVICE.set(int(index))
    try:
        with device_scope(device):
            yield
    finally:
        _MESH_DEVICE.reset(token)


def device_scope(device: torch.device):
    """Make `device` the calling thread's current CUDA device (worker-pool
    tasks launch kernels from their own threads); a no-op for the CPU."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class LaunchLedger:
    """Integer launch counters keyed by kernel name (thread-safe). With
    `dispatches`, each bump also counts as dispatches of the current mesh
    device in the per-device ledger."""

    def __init__(self, dispatches: bool = False) -> None:
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._dispatches = dispatches

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
        if self._dispatches:
            from .obs.device import note_dispatch
            note_dispatch(mesh_device_index(), n)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


LAUNCHES = LaunchLedger(dispatches=True)
UPLOADS = LaunchLedger()
