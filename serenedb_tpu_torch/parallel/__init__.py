"""The shared host worker pool (copied from serenedb_tpu/parallel/pool.py).
The device mesh (serenedb_tpu/parallel/mesh.py) has its one-card entries
only."""

from .pool import WorkerPool, get_pool, parallel_map, session_workers

__all__ = ["WorkerPool", "get_pool", "parallel_map", "session_workers"]
