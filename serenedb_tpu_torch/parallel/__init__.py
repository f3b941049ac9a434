"""The shared host worker pool (copied from serenedb_tpu/parallel/pool.py)
and the device mesh (port of serenedb_tpu/parallel/mesh.py)."""

from .mesh import (combine_agg_partials, make_mesh, shard_rows,
                   sharded_agg_step, sharded_bm25_topk, sharded_query_step,
                   virtual_devices)
from .pool import WorkerPool, get_pool, parallel_map, session_workers

__all__ = ["WorkerPool", "get_pool", "parallel_map", "session_workers",
           "combine_agg_partials", "make_mesh", "shard_rows",
           "sharded_agg_step", "sharded_bm25_topk", "sharded_query_step",
           "virtual_devices"]
