"""Stub of serenedb_tpu/parallel/mesh.py: the multi-device mesh programs
(K12) are not ported yet.

`device_count_if_initialized` is the one entry the host tiers read: the
number of devices the port runs on once this process has initialised CUDA,
else 0 (the reference counts jax devices once a backend is up, never
initialising one). The port runs on one card (`cuda:0`) however many the
host has, so that number is 1 until the mesh programs are ported, and
`serene_shard_combine = 'auto'` resolves to `host`, as the reference
resolves it with one device. Everything else raises FEATURE_NOT_SUPPORTED.
"""

from __future__ import annotations

import torch

from .. import errors


def device_count_if_initialized() -> int:
    return 1 if torch.cuda.is_initialized() else 0


def data_mesh(n_shards: int):
    raise errors.unsupported("the device mesh is not ported yet")
