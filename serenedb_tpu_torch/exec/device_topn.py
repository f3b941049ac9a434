"""Device top-N: ORDER BY <column> LIMIT k over a table scan (port of
serenedb_tpu/exec/device_topn.py).

The reference runs one XLA `top_k` over the HBM-resident key column. The
port runs the `topn_scan` kernel (`ops/topn_kernels.py`, `ops/csrc/
topn.cu`) over the same column tiles: the key transform, then a selection
by (value desc, row asc) — `lax.top_k`'s order — returning the k row
indices.

Supported shape: Limit(Sort(Scan | Project(Scan))) with a single sort
key that is a plain numeric column (int / date / float32) with no NULLs
and no filter. Anything else falls back to the exact CPU lexsort
(plan.SortNode). The asc direction uses the bitwise-NOT transform
(~k = -k-1) so int32 min does not overflow under negation.

With `serene_mesh = M > 1` and at least M mesh devices (the reference's
mesh branch), the key tiles pad to a multiple of M and split into M
contiguous shards; `topn_scan` runs once a shard on its mesh device and
each shard's rows shift by its base; the N x k candidates merge on the
host by (key desc, row asc), the padded and under-filled shards' rows
dropped, which is the single-device selection. With fewer devices than M
the single-device path runs, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.column import Batch
from ..columnar.device import LANES
from ..ops import agg_kernels as K
from ..ops import topn_kernels as TK
from ..utils import log, metrics
from .device import NotCompilable
from .tables import TableProvider

MAX_TOPN_K = TK.TOPN_MAX_K
_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1


def try_device_topn(limit_node, ctx) -> Optional[Batch]:
    """Attempt device execution of Limit(Sort(...)); None → CPU path."""
    from .plan import ProjectNode, ScanNode, SortNode

    device = ctx.settings.get("serene_device")
    if device == "cpu":
        return None
    if limit_node.limit is None:
        return None
    k = limit_node.limit + limit_node.offset
    if k == 0 or k > MAX_TOPN_K:
        return None
    sort = limit_node.child
    if not isinstance(sort, SortNode) or len(sort.key_indices) != 1:
        return None
    if sort.nulls_first[0] is not None:
        return None     # explicit NULLS placement: CPU handles it
    proj = None
    inner = sort.child
    if isinstance(inner, ProjectNode):
        proj = inner
        inner = inner.child
    if not isinstance(inner, ScanNode) or inner.filter is not None:
        return None
    scan = inner
    ki = sort.key_indices[0]
    if proj is not None:
        from ..sql.expr import BoundColumn
        key_expr = proj.exprs[ki]
        if not isinstance(key_expr, BoundColumn):
            return None
        col_idx = key_expr.index
    else:
        col_idx = ki
    t = scan.types[col_idx]
    if not (t.is_integer or t.id in (dt.TypeId.DATE, dt.TypeId.FLOAT)):
        return None
    provider = scan.provider
    if device == "auto" and \
            provider.row_count() < ctx.settings.get("serene_device_min_rows"):
        return None
    from ..columnar.device import DeviceNarrowingError
    from ..obs.trace import current_trace
    prof = getattr(ctx, "profile", None)
    trace = current_trace()
    try:
        import time as _time
        t0 = _time.perf_counter_ns()
        idx = _topn_indices(provider, scan, scan.columns[col_idx],
                            bool(sort.descs[0]), k, ctx,
                            prof_key=id(limit_node))
        t1 = _time.perf_counter_ns()
        if prof is not None:
            # device-path time lands on the Limit node that claimed the
            # Sort pipeline (the offload replaced its whole subtree)
            prof.add_device_ns(id(limit_node), t1 - t0)
        if idx is not None:
            metrics.DEVICE_DISPATCH_HIST.observe_ns(t1 - t0)
            if trace is not None:
                trace.add("device_dispatch", "device", t0, t1, op="topn")
    except (NotCompilable, DeviceNarrowingError) as e:
        log.debug("device", f"top-N fell back to CPU: {e}")
        return None
    if idx is None:
        return None
    idx = idx[limit_node.offset:]
    base = provider.full_batch(scan.columns).take(idx)
    if proj is None:
        return base
    cols = [e.eval(base) for e in proj.exprs]
    return Batch(list(proj.names), cols)


def _topn_indices(provider: TableProvider, scan, col_name: str,
                  desc: bool, k: int, ctx,
                  prof_key=None) -> Optional[np.ndarray]:
    from .device_agg import _ctx_device

    pin = provider.try_pin()
    dev_ver = pin[1] if pin is not None else provider.data_version
    host = (pin[0].column(col_name) if pin is not None
            else provider.host_column(col_name))
    n = len(host)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if not host.valid_mask().all():
        raise NotCompilable("top-N key column has NULLs")
    if host.data.dtype.kind == "f":
        if not np.isfinite(host.data).all():
            # NaN ordering is PG-specific; +/-inf would collide with the
            # -inf sentinel
            raise NotCompilable("top-N float key has NaN/inf")
    else:
        # sentinel-tie gates: the transform must keep every valid key
        # strictly above the invalid sentinel
        lo, hi = int(host.data.min()), int(host.data.max())
        if desc and lo <= _I32_MIN:
            raise NotCompilable("key touches int32 min")
        if not desc and hi >= _I32_MAX:
            raise NotCompilable("key touches int32 max")
    device = _ctx_device(ctx)

    # zone-map skip-scan: block bounds alone can prove a prefix/suffix
    # of blocks holds no top-k candidate; only the surviving contiguous
    # range uploads. Pruned rows are strictly outside the top-k, so
    # result AND tie order are untouched — indices just shift by the
    # range start.
    from . import zonemap
    block_rows = int(ctx.settings.get("serene_morsel_rows"))
    zrange = zonemap.topn_block_range(provider, ctx.settings, col_name,
                                      block_rows, desc, k, pin)
    if zrange is None:
        dc = provider.device_columns([col_name], pin, device)[col_name]
    else:
        from .device_agg import _range_device_columns
        dc = _range_device_columns(provider, [col_name], pin, zrange,
                                   device)[col_name]
    is_float = dc.data.dtype == torch.float32

    # the range keys the spec: a sliced upload's frame-of-reference
    # scheme can differ from the whole column's
    cache_key = ("topn", id(provider), dev_ver, col_name, desc, k, zrange)

    def build() -> TK.TopnSpec:
        kind, off = K.col_kind(dc)
        return TK.TopnSpec([kind], [off], 0, desc, is_float)

    from ..obs import device as obs_device
    from ..parallel import mesh as mesh_mod
    spec = obs_device.compiled("device_topn", cache_key, build)
    mesh_n = int(ctx.settings.get("serene_mesh") or 0)
    if mesh_n > 1 and mesh_mod.device_count(device) < mesh_n:
        mesh_n = 0
    tiles = dc.data.shape[0]
    if (tiles + (-tiles) % max(mesh_n, 1)) * LANES < k * max(mesh_n, 1):
        # k exceeds the (per-shard) padded domain — tiny table, CPU wins
        raise NotCompilable("k exceeds per-shard rows")
    if mesh_n > 1:
        ii = _mesh_topn(spec, dc, k, mesh_mod.make_mesh(mesh_n, base=device),
                        host, zrange, desc, is_float)
    else:
        ii, _nsurv = TK.topn_scan(spec, [(dc.data, dc.mask)], dc.mask, k)
        ii = obs_device.fetch_all([ii])[0].astype(np.int64)
    if zrange is not None:
        ii = ii + zrange[0]     # slice-relative → table row ids
    metrics.DEVICE_OFFLOADS.add()
    k_eff = min(k, n)
    return ii[:k_eff]


def _mesh_topn(spec: TK.TopnSpec, dc, k: int, mesh, host, zrange,
               desc: bool, is_float: bool) -> np.ndarray:
    """The mesh branch: one `topn_scan` a shard of the key tiles (padded
    to a multiple of the mesh size with masked-out tiles), the shard's
    base added to its rows, then the host merge of the N x k candidates
    by (key desc, row asc) — the reference's stable sort of the shards'
    lists in shard order — keeping real rows only (the padding and an
    under-filled shard's masked rows are the reference's sentinels)."""
    from ..obs import device as obs_device
    from ..parallel.mesh import pad_to_multiple, shard_slices
    M = mesh.size
    data = pad_to_multiple(dc.data, M)
    mask = pad_to_multiple(dc.mask, M, False)
    cands = []
    for s, (a, b) in enumerate(shard_slices(data.shape[0], M)):
        dev = mesh.devices[s]
        d, m = data[a:b], mask[a:b]
        if d.device != dev:
            d, m = d.to(dev), m.to(dev)
        with mesh.shard(s):
            ii, _nsurv = TK.topn_scan(spec, [(d, m)], m, k)
            cands.append(ii.to(torch.int64) + a * LANES)
    rows = obs_device.fetch_all([torch.cat([c.to(mesh.first)
                                            for c in cands])])[0]
    lo = zrange[0] if zrange is not None else 0
    n_live = (zrange[1] - zrange[0]) if zrange is not None else len(host)
    rows = rows[(rows >= 0) & (rows < n_live)]
    vals = host.data[lo:lo + n_live][rows]
    # the keys as the card compares them (a DOUBLE column narrows to f32)
    key = vals.astype(np.float32).astype(np.float64) if is_float \
        else vals.astype(np.int64)
    order = np.lexsort((rows, -key if desc else key))
    return rows[order][:k]
