"""The one-card entries of serenedb_tpu/parallel/mesh.py; the multi-device
mesh programs (K12) are not ported yet.

The port runs on one card (`cuda:0`) however many the host has, so:

- `device_count_if_initialized` is 1 once this process has initialised
  CUDA, else 0 (the reference counts jax devices once a backend is up,
  never initialising one), and `serene_shard_combine = 'auto'` resolves
  to `host`, as the reference resolves it with one device;
- `device_count` is 1: every `serene_mesh > 1` asks for more devices than
  there are, and the device tiers take their single-device programs, as
  the reference does when it has fewer devices than the mesh names;
- `shard_devices` is None: the sharded tier's shards share the card and
  fan out as worker-pool tasks only;
- `data_mesh_width(S)` is the width of the reference's `data_mesh(S)`,
  min(S, devices) = 1: the collective dispatch stacks every shard on the
  one card.

Everything else of the reference's module raises FEATURE_NOT_SUPPORTED.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import errors

#: the mesh axis name of the reference (trace and EXPLAIN attributes)
AXIS = "shard"


def device_count() -> int:
    """Devices the port's programs span: one card."""
    return 1


def device_count_if_initialized() -> int:
    return device_count() if torch.cuda.is_initialized() else 0


def shard_devices(n_shards: int) -> Optional[list]:
    """Per-shard device placement (serenedb_tpu/parallel/mesh.py
    `shard_devices`): None on a single-device host, so shard tasks share
    the default device."""
    if device_count() <= 1 or n_shards <= 1:
        return None
    raise errors.unsupported("multi-device shard placement is not ported "
                             "yet")


def data_mesh_width(n_shards: int) -> int:
    """The data axis of the reference's `data_mesh(n_shards)`:
    min(n_shards, devices), at least 1."""
    return max(1, min(int(n_shards), device_count()))


def data_mesh(n_shards: int):
    raise errors.unsupported("the device mesh is not ported yet")
