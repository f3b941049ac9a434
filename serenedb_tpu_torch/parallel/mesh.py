"""The device mesh (port of serenedb_tpu/parallel/mesh.py).

The reference maps intra-node parallelism onto a `jax.sharding.Mesh`:
row blocks shard across devices, per-device partials combine with psum /
pmin / pmax, per-device top-k merge by all_gather. The port keeps one
process and no collective library: a mesh is a list of logical devices,
each placed on a physical `torch.device`; a shard's work is the existing
hand kernels launched on its device (under `device.on_mesh_device`, so
the per-device ledger counts it), and the combine copies the partials to
the mesh's first device and reduces them with the `mesh_combine` kernel
(ops/mesh_kernels.py).

- `devices()`: the physical placement of each logical device. By
  default the host's cards for a CUDA database (`cuda:0..n-1`), or the
  one CPU; under `virtual_devices(n)` (the counterpart of the reference
  tests' `xla_force_host_platform_device_count`) n logical devices over
  the database's one physical device. A virtual mesh is a process-wide
  state that the tests and `chip_smoke.py` set and restore; nothing
  reads it from a setting or the environment.
- `device_count_if_initialized()`: the reference's passive probe: the
  mesh's width once a device is in use (a virtual mesh always is), else
  0 — `serene_shard_combine = 'auto'` resolves to `device` above 1.
- `make_mesh`, `data_mesh` (width min(S, devices)), `shard_devices`
  (shard s on logical device s % n), `pad_to_multiple`, `shard_rows`,
  `combine_agg_partials`, `apply_axis_combines`: as the reference's.
- `sharded_agg_step`, `sharded_bm25_topk`, `sharded_query_step`: the
  reference's three builders, each returning a callable on torch
  tensors that runs one shard's launches per mesh device and combines.

On a host with n cards shard s runs on `cuda:s`, its inputs copied
there; on a virtual mesh every shard is a view of the one copy.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import on_mesh_device

#: the mesh axis name of the reference (trace and EXPLAIN attributes)
AXIS = "shard"

_lock = threading.Lock()
#: logical devices of the virtual mesh, or None for the host's devices
_VIRTUAL: Optional[int] = None


@contextlib.contextmanager
def virtual_devices(n: int):
    """Within this block the mesh has `n` logical devices over the
    database's physical device, process-wide; the previous state comes
    back on exit."""
    global _VIRTUAL
    if int(n) < 1:
        raise ValueError("virtual_devices: n >= 1")
    with _lock:
        prev, _VIRTUAL = _VIRTUAL, int(n)
    try:
        yield
    finally:
        with _lock:
            _VIRTUAL = prev


def _base_device() -> torch.device:
    """The executing database's device (its connection or the device a
    build runs on), else `cuda:0`: without a card that raises, as every
    entry point does (`device.resolve_device`)."""
    from ..device import _BUILDING_ON, resolve_device
    from ..engine import CURRENT_CONNECTION
    dev = _BUILDING_ON.get()
    if dev is not None:
        return dev
    conn = CURRENT_CONNECTION.get()
    if conn is not None:
        return conn.db.device
    return resolve_device(None)


def devices(base: Optional[torch.device] = None) -> list[torch.device]:
    """The physical device of each logical device of the mesh."""
    base = torch.device(base) if base is not None else _base_device()
    if _VIRTUAL is not None:
        return [base] * _VIRTUAL
    if base.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(max(1, torch.cuda.device_count()))]
    return [base]


def device_count(base: Optional[torch.device] = None) -> int:
    """Devices the mesh programs can span (`len(jax.devices())`)."""
    return len(devices(base))


def device_count_if_initialized() -> int:
    """The mesh's width once a device is in use, else 0 — never
    initialises CUDA (the reference's passive probe)."""
    if _VIRTUAL is not None:
        return _VIRTUAL
    return torch.cuda.device_count() if torch.cuda.is_initialized() else 0


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: the physical placement of each logical device."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def shard(self, s: int):
        """Run a block as logical device s (`device.on_mesh_device`)."""
        return on_mesh_device(s, self.devices[s])


def make_mesh(n_devices: Optional[int] = None,
              base: Optional[torch.device] = None) -> Mesh:
    devs = devices(base)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"a mesh of {n} devices over {len(devs)}")
    return Mesh(tuple(devs[:n]))


def data_mesh(n_shards: int, base: Optional[torch.device] = None) -> Mesh:
    """The data-axis mesh of the sharded tier: min(n_shards, devices)
    devices."""
    devs = devices(base)
    return Mesh(tuple(devs[:max(1, min(int(n_shards), len(devs)))]))


def data_mesh_width(n_shards: int,
                    base: Optional[torch.device] = None) -> int:
    """The width of `data_mesh(n_shards)`: min(n_shards, devices)."""
    return max(1, min(int(n_shards), device_count(base)))


def shard_devices(n_shards: int, base: Optional[torch.device] = None
                  ) -> Optional[list]:
    """Placement of the sharded tier's shards: shard s on logical device
    s % n, as (logical index, physical device) pairs; None with one
    device or one shard (the shards then share the default device)."""
    devs = devices(base)
    if len(devs) <= 1 or n_shards <= 1:
        return None
    return [(s % len(devs), devs[s % len(devs)]) for s in range(n_shards)]


def pad_to_multiple(arr, n: int, fill=0):
    """Pad the leading axis to a multiple of n (data with `fill`, masks
    with False: padded rows never count). numpy arrays and tensors."""
    rows = arr.shape[0]
    pad = (-rows) % n
    if not pad:
        return arr
    if isinstance(arr, np.ndarray):
        widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, widths, constant_values=fill)
    tail = torch.full((pad,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                      device=arr.device)
    return torch.cat([arr, tail])


def shard_rows(arr, mesh: Mesh):
    """Pad the leading (row-block) axis to a multiple of the mesh size."""
    return pad_to_multiple(arr, mesh.size)


def shard_slices(rows: int, m: int) -> list[tuple[int, int]]:
    """[start, end) of each of m contiguous, equal shards of `rows` rows
    (a multiple of m: `pad_to_multiple` first), as shard_map cuts its
    inputs."""
    if rows % m:
        raise ValueError(f"{rows} rows do not split over {m} shards")
    w = rows // m
    return [(s * w, (s + 1) * w) for s in range(m)]


def combine_agg_partials(partials) -> int:
    """(R, 2) int32 [hi16, lo16] row partials → exact int64 total."""
    if isinstance(partials, torch.Tensor):
        partials = partials.cpu().numpy()
    p = np.asarray(partials).astype(np.int64)
    return int((p[:, 0].sum() << 16) + p[:, 1].sum())


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


def apply_axis_combines(shard_outs: list, kinds: list, dest: torch.device,
                        fuse_sums: bool = False,
                        unsigned: Optional[list] = None) -> list:
    """The cross-shard reduction of per-shard outputs (one list of
    tensors a shard, in `kinds`' order), on `dest` (the mesh's first
    device), by kind: 'sum', 'min' and 'max' through `mesh_combine_many`,
    which reads each shard's partial where it lies, 'rows' concatenated
    over the shards (per-row outputs). `fuse_sums` reduces every 'sum',
    'min' and 'max' output in one launch (more only past the descriptor's
    caps); without it each output is a launch of its own, as each psum of
    the reference is a collective of its own. `unsigned[i]` compares
    output i's int32 words as u32. Integer adds and min/max are exact in
    any order, so the combine equals a single-device run; f32 sums add in
    shard order."""
    from ..ops.mesh_kernels import mesh_combine_many
    combined: list = [None] * len(kinds)
    segs, at = [], []
    for i, kind in enumerate(kinds):
        parts = [_to(outs[i], dest) for outs in shard_outs]
        if kind == "rows":
            combined[i] = torch.cat(parts)
        else:
            segs.append((parts, kind, bool(unsigned and unsigned[i])))
            at.append(i)
    calls = [segs] if fuse_sums else [[s] for s in segs]
    reduced = [r for call in calls if call for r in mesh_combine_many(call)]
    for i, r in zip(at, reduced):
        combined[i] = r
    return combined


# -- the reference's three builders ------------------------------------------


def _cut(mesh: Mesh, t: torch.Tensor, s: int) -> torch.Tensor:
    """Shard s's contiguous rows of t on shard s's device."""
    a, b = shard_slices(t.shape[0], mesh.size)[s]
    return _to(t[a:b], mesh.devices[s])


def sharded_agg_step(mesh: Mesh):
    """(vals (R, 128) i32, mask (R, 128) bool, lo, hi) → (total count
    (one int32), (R, 2) int32 [hi16, lo16] row partials): one
    `mesh_agg_partials` launch a shard over its R / M rows, the counts
    summed by `mesh_combine`, the partials concatenated (combine them
    exactly with `combine_agg_partials`). R must be a multiple of the
    mesh size (`shard_rows`)."""
    from ..ops.mesh_kernels import mesh_agg_partials

    def step(vals: torch.Tensor, mask: torch.Tensor, lo: int, hi: int):
        outs = []
        for s in range(mesh.size):
            with mesh.shard(s):
                cnt, part = mesh_agg_partials(_cut(mesh, vals, s),
                                              _cut(mesh, mask, s), lo, hi)
                outs.append([cnt, part])
        cnt, parts = apply_axis_combines(outs, ["sum", "rows"], mesh.first)
        return cnt.reshape(()), parts

    return step


def _score_shards(mesh: Mesh, flat_docs, flat_tfs, norms, gidx,
                  block_term, idf, avgdl: float, ndocs_pad: int,
                  mode: str, k1: float = 1.2, b: float = 0.75
                  ) -> torch.Tensor:
    """Each shard's `mesh_score_blocks` plane over its gidx rows, summed
    in shard order by `mesh_combine` on the first device."""
    from ..ops.mesh_kernels import mesh_score_blocks
    planes = []
    for s in range(mesh.size):
        dev = mesh.devices[s]
        with mesh.shard(s):
            planes.append([mesh_score_blocks(
                _to(flat_docs, dev), _to(flat_tfs, dev),
                None if norms is None else _to(norms, dev),
                _cut(mesh, gidx, s),
                None if block_term is None else _cut(mesh, block_term, s),
                None if idf is None else _to(idf, dev), avgdl, ndocs_pad,
                mode, k1, b)])
    return apply_axis_combines(planes, ["sum"], mesh.first)[0]


def sharded_bm25_topk(mesh: Mesh, ndocs_pad: int, k: int, k1: float = 1.2,
                      b: float = 0.75):
    """(flat_docs, flat_tfs, norms, gidx (Rb, 128), block_term (Rb,),
    idf, avgdl) → the top k (scores f32, docs int32) of one query: each
    shard scores its gidx rows into its own plane (`mesh_score_blocks`),
    the planes sum in shard order (`mesh_combine`), one `topk_rows`
    selects by (score desc, doc asc)."""
    from ..ops.bm25_kernels import topk_rows

    def step(flat_docs, flat_tfs, norms, gidx, block_term, idf, avgdl):
        scores = _score_shards(mesh, flat_docs, flat_tfs, norms, gidx,
                               block_term, idf, float(avgdl), ndocs_pad,
                               "bm25", k1, b)
        vals, docs = topk_rows(scores.view(1, -1), k)
        return vals[0], docs[0]

    return step


def sharded_query_step(mesh: Mesh, num_groups: int):
    """(vals, mask, codes (R, 128), flat_docs, flat_tfs, gidx (Rb, 128),
    block_term) → (group counts f32 (G,), group sums f32 (G,), the
    tf / (tf + 1.2) plane f32 (len(flat_docs),)): per shard the masked
    `vals >= 0` group count and f32 sum through ops/agg.py's entries (on
    `agg_scan`) over its rows, and `mesh_score_blocks` over its gidx
    rows; the three sum over the shards in one `mesh_combine` launch."""
    from ..ops import agg as agg_ops
    from ..ops.mesh_kernels import mesh_score_blocks

    def step(vals, mask, codes, flat_docs, flat_tfs, gidx, block_term):
        outs = []
        nd = int(flat_docs.shape[0])
        for s in range(mesh.size):
            dev = mesh.devices[s]
            with mesh.shard(s):
                v, m = _cut(mesh, vals, s), _cut(mesh, mask, s)
                c = _cut(mesh, codes, s).clamp(0, num_groups - 1)
                sel = m & (v >= 0)
                counts = agg_ops.group_count_scatter(
                    c, sel, num_groups).to(torch.float32)
                sums = agg_ops.group_sum_float(c, sel, v, num_groups)
                plane = mesh_score_blocks(
                    _to(flat_docs, dev), _to(flat_tfs, dev), None,
                    _cut(mesh, gidx, s), None, None, 1.0, nd, "saturation")
                outs.append([counts, sums, plane])
        return tuple(apply_axis_combines(outs, ["sum", "sum", "sum"],
                                         mesh.first, fuse_sums=True))

    return step
