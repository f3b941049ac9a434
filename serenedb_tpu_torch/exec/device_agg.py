"""Device-offloaded Scan→Filter→Aggregate (port of
serenedb_tpu/exec/device_agg.py).

The reference jits one XLA program per (table, query) over its cached
HBM columns. The port runs the same work as one launch of the hand-written
`agg_scan` kernel per row chunk (`ops/agg_kernels.py`, `ops/csrc/agg.cu`):

    mask   = rowmask & predicates(cols)        (postfix programs, 3-valued)
    codes  = direct key plans | factorized codes | one group
    counts, exact int64 sums, f32 partial sums, min/max, DISTINCT grids

then `agg_fold` for the float sums, and the host builds the result batch
exactly as the reference does. A query past one launch's descriptor runs
as several launches a chunk (exec/device_split.py: derived tiles and
mask passes by `scan_eval`, the aggregates over as many `agg_scan`
launches as they need). Queries the device tier cannot run exactly
decline to the host path (plan.AggregateNode) where the reference declines
them: `NotCompilable` and `DeviceNarrowingError`, and nothing else.
With `serene_mesh = M > 1` and at least M mesh devices (parallel/mesh.py;
the reference's `_mesh_wrap`), each chunk's tiles split into M contiguous
shards, one `agg_scan` launch a shard on its mesh device, and the shards'
outputs combine on the first device by the chunk combine kinds through
`mesh_combine` (every output of a chunk in one launch); the float MIN's
NaN rule applies once, after shards and chunks. With fewer devices than M
the single-device program runs, as in the reference.
"""

from __future__ import annotations

import functools
import threading as _threading
from typing import Optional

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column
from ..columnar.device import (DeviceNarrowingError, commit_host_array,
                               pad_len)
from ..ops import agg_kernels as K
from ..sql.binder import _expr_key
from ..sql.expr import AggSpec, BoundColumn, BoundExpr
from ..utils import log, metrics
from . import device_split
from .device import NotCompilable, column_type, compile_expr
from .tables import TableProvider

MAX_GROUP_PRODUCT = 1 << 21   # combined-key code-space cap
MAX_INT_KEY_RANGE = 1 << 20   # direct-coding range cap for integer keys
MAX_DISTINCT_CELLS = 1 << 22  # (group_space x value_space) presence cap

_factorize_guard = _threading.Lock()


def _factorize_lock(provider) -> "_threading.Lock":
    """Per-provider lock guarding _factorize_cache (lazily attached)."""
    lk = getattr(provider, "_factorize_cache_lock", None)
    if lk is None:
        with _factorize_guard:
            lk = getattr(provider, "_factorize_cache_lock", None)
            if lk is None:
                lk = _threading.Lock()
                provider._factorize_cache_lock = lk
    return lk


_AGG_FUNCS = {"count_star", "count", "sum", "min", "max", "avg"}


def _ctx_device(ctx) -> torch.device:
    """The exec context's device; contexts built without a database (the
    binder's subqueries) take the current connection's."""
    dev = getattr(ctx, "device", None)
    if dev is None:
        from ..engine import CURRENT_CONNECTION
        conn = CURRENT_CONNECTION.get()
        if conn is not None:
            dev = conn.db.device
    if dev is None:
        from ..device import resolve_device
        dev = resolve_device(None)
    return dev


def try_device_aggregate(node, ctx) -> Optional[Batch]:
    """Attempt device execution of an AggregateNode; None → host path."""
    from .plan import FilterNode, ScanNode

    device = ctx.settings.get("serene_device")
    if device == "cpu":
        return None
    # unwrap Filter(Scan) / Scan
    child = node.child
    preds: list[BoundExpr] = []
    while isinstance(child, FilterNode):
        preds.append(child.pred)
        child = child.child
    if not isinstance(child, ScanNode):
        return None
    scan = child
    if scan.filter is not None:
        preds.append(scan.filter)
    provider = scan.provider
    if device == "auto" and \
            provider.row_count() < ctx.settings.get("serene_device_min_rows"):
        return None
    for spec in node.aggs:
        if spec.func not in _AGG_FUNCS or spec.filter is not None:
            return None
        if spec.distinct and spec.func in ("count", "sum", "avg") and \
                not isinstance(spec.arg, BoundColumn):
            # DISTINCT runs as a (group, value)-presence grid; value
            # coding needs a plain column (min/max ignore DISTINCT)
            return None
    try:
        prof = getattr(ctx, "profile", None)
        from ..obs.trace import current_trace
        trace = current_trace()
        import time as _time
        t0 = _time.perf_counter_ns()
        out = _run(node, scan, provider, preds, ctx)
        t1 = _time.perf_counter_ns()
        if prof is not None:
            prof.add_device_ns(id(node), t1 - t0)
        metrics.DEVICE_DISPATCH_HIST.observe_ns(t1 - t0)
        if trace is not None:
            trace.add("device_dispatch", "device", t0, t1, op="agg")
        return out
    except (NotCompilable, DeviceNarrowingError) as e:
        log.debug("device", f"aggregate fell back to CPU: {e}")
        return None


def _run(node, scan, provider: TableProvider, preds: list[BoundExpr],
         ctx) -> Batch:
    device = _ctx_device(ctx)
    col_names = scan.columns

    # ONE publication observation for the WHOLE query: dictionaries, key
    # planning, factorized codes, the device column environment and the
    # row mask must all come from the same (batch, version)
    pin = provider.try_pin()
    pin_batch = pin[0] if pin is not None else None
    dev_ver = pin[1] if pin is not None else provider.data_version

    def host_col(name):
        if pin_batch is not None:
            return pin_batch.column(name)
        return provider.host_column(name)

    # only referenced string columns need their dictionary materialized
    referenced: set[int] = set()
    for e in preds + list(node.group_exprs) + \
            [s.arg for s in node.aggs if s.arg is not None]:
        for sub in e.walk():
            if isinstance(sub, BoundColumn):
                referenced.add(sub.index)
    dictionaries: dict[int, np.ndarray] = {}
    for i in sorted(referenced):
        if scan.types[i].is_string:
            col = host_col(col_names[i])
            if col.dictionary is not None:
                dictionaries[i] = col.dictionary

    compiled_preds = [compile_expr(p, scan.types, dictionaries) for p in preds]

    # group keys: direct coding (dict codes / small-range ints) when it
    # fits, else composite host factorization (arbitrary keys/cardinality)
    fact = None
    try:
        key_plans, group_space = _plan_direct_keys(
            node, scan, host_col, col_names, dictionaries)
    except NotCompilable:
        if not node.group_exprs:
            raise
        fact = _factorize_group_keys(node, scan, provider, pin_batch,
                                     dev_ver, device)
        key_plans, group_space = [], max(fact["g"], 1)

    agg_plans = []
    for spec in node.aggs:
        if spec.func == "count_star":
            agg_plans.append((spec, None))
        else:
            if spec.arg.type.is_string and spec.func != "count":
                raise NotCompilable(f"{spec.func} over strings")
            agg_plans.append((spec, compile_expr(spec.arg, scan.types,
                                                 dictionaries)))

    # DISTINCT value plans: each count/sum/avg DISTINCT column gets a
    # direct value coding (dict codes / small-range ints) and the kernel
    # marks a (group, value) presence grid
    distinct_plans: dict[int, tuple] = {}
    for si, (spec, ce) in enumerate(agg_plans):
        if not (spec.distinct and spec.func in ("count", "sum", "avg")):
            continue
        vi = spec.arg.index
        vt = scan.types[vi]
        if vt.is_string:
            d = dictionaries.get(vi)
            if d is None:
                raise NotCompilable("DISTINCT string without dictionary")
            distinct_plans[si] = ("dict", vi, 0, len(d) + 1)
        elif vt.is_integer or vt.id in (dt.TypeId.BOOL, dt.TypeId.DATE):
            col = host_col(col_names[vi])
            if col.data.size == 0:
                lo, hi = 0, 0
            else:
                lo, hi = int(col.data.min()), int(col.data.max())
            rng = hi - lo + 1
            if rng > MAX_INT_KEY_RANGE:
                raise NotCompilable("DISTINCT value range too large")
            if not (-2**31 <= lo and hi < 2**31):
                raise NotCompilable("DISTINCT value offset beyond int32")
            distinct_plans[si] = ("int", vi, lo, rng + 1)
        else:
            raise NotCompilable(f"DISTINCT over {vt}")
    for si in distinct_plans:
        if max(group_space, 1) * distinct_plans[si][3] > MAX_DISTINCT_CELLS:
            raise NotCompilable("DISTINCT presence matrix too large")

    # zone maps: when the filter conjuncts prove a prefix/suffix of
    # morsel blocks can't match, upload (and aggregate) only the
    # surviving contiguous row range. The factorized code buffer is
    # whole-table, so the shrink only engages on directly coded keys.
    nrows = pin_batch.num_rows if pin_batch is not None \
        else provider.row_count()
    zrange = None
    if preds and fact is None:
        zrange = _zonemap_range(scan, provider, preds, pin, nrows, ctx)

    # collect needed device columns
    needed: set[int] = set()
    for ce in compiled_preds:
        needed.update(ce.inputs)
    for kp in key_plans:
        needed.add(kp[1])
    for si, (spec, ce) in enumerate(agg_plans):
        if si in distinct_plans:
            needed.add(distinct_plans[si][1])
        elif ce is not None:
            needed.update(ce.inputs)
    needed = sorted(needed)
    from ..parallel import mesh as mesh_mod
    mesh_n = int(ctx.settings.get("serene_mesh") or 0)
    if mesh_n > 1 and mesh_mod.device_count(device) < mesh_n:
        mesh_n = 0

    def columns_on(dev) -> dict:
        names = [col_names[i] for i in needed]
        if zrange is None:
            by_name = provider.device_columns(names, pin, dev)
        else:
            by_name = _range_device_columns(provider, names, pin, zrange,
                                            dev)
        return {i: by_name[col_names[i]] for i in needed}

    env_cols = columns_on(device)
    metrics.DEVICE_OFFLOADS.add()

    group_mode = bool(node.group_exprs)
    slot_of = {i: k for k, i in enumerate(needed)}
    decode_specs = [K.col_kind(env_cols[i]) for i in needed]
    for i, (kind, _off) in zip(needed, decode_specs):
        want = column_type(scan.types[i])
        if (want == "f") != (kind == K.COL_F32) or \
                (want == "i8") != (kind == K.COL_I8):
            raise NotCompilable(f"column {col_names[i]}: tiles do not "
                                f"match its type {scan.types[i]}")

    # zrange is part of the key: the frame-of-reference scheme/offset of
    # a sliced upload differs from the whole column's
    key = (id(provider), dev_ver,
           tuple(_expr_key(p) for p in preds),
           tuple(_expr_key(g) for g in node.group_exprs),
           tuple((s.func, s.distinct, _expr_key(s.arg))
                 for s in node.aggs), zrange)
    from ..obs import device as obs_device

    def build() -> K.ScanSpec:
        return _scan_spec(compiled_preds, key_plans, fact is not None,
                          group_space if group_mode else 1, agg_plans,
                          distinct_plans, slot_of, decode_specs)

    spec = obs_device.compiled("device_agg", key, build,
                               profile=getattr(ctx, "profile", None),
                               node_key=id(node))

    # A column's device mask excludes padding but ALSO that column's NULLs —
    # wrong as a row mask for count(*). Use a pure row-validity mask built
    # from the logical length of the SAME publication as the columns
    # (cached per version and device on the provider).
    mask_rows = nrows if zrange is None else zrange[1] - zrange[0]
    prows = pad_len(mask_rows)

    def rowmask_on(dev) -> torch.Tensor:
        masks = getattr(provider, "_device_rowmask", None)
        if masks is None:
            masks = provider._device_rowmask = {}
        rm_entry = masks.get(str(dev))
        if rm_entry is None or rm_entry[0] != (dev_ver, zrange) or \
                rm_entry[1].shape != (prows // 128, 128):
            rm = np.zeros(prows, dtype=bool)
            rm[:mask_rows] = True
            rm_entry = ((dev_ver, zrange),
                        commit_host_array(rm.reshape(-1, 128), dev))
            masks[str(dev)] = rm_entry
        return rm_entry[1]

    def inputs_on(dev) -> tuple:
        """(cols, rowmask, codes) of the scan on one physical device."""
        env = env_cols if dev == device else columns_on(dev)
        codes = None
        if fact is not None:
            codes = fact["codes2d"] if dev == device else \
                _factorize_group_keys(node, scan, provider, pin_batch,
                                      dev_ver, dev)["codes2d"]
        return ([(env[i].data, env[i].mask) for i in needed],
                rowmask_on(dev), codes)

    cols, rowmask_arr, codes2d = inputs_on(device)

    def run_chunk(start: int, end: int) -> list:
        raw = device_split.agg_scan(spec, cols, rowmask_arr, codes2d,
                                    start, end)
        return _host_outputs(spec, _device_outputs(spec, raw), group_mode)

    if mesh_n > 1:
        mesh = mesh_mod.make_mesh(mesh_n, base=device)
        placed = {dev: (cols, rowmask_arr, codes2d) if dev == device
                  else inputs_on(dev) for dev in set(mesh.devices)}
        run_chunk = functools.partial(_run_mesh_chunk, spec, mesh, placed,
                                      group_mode)

    chunk_rows = int(ctx.settings.get("serene_device_chunk_rows") or 0)
    # clamp to one tile: tiny values must mean "maximum responsiveness",
    # never silently disable chunking
    chunk_tiles = max(1, chunk_rows // 128) if chunk_rows > 0 else 0
    if mesh_n > 1 and chunk_tiles:
        chunk_tiles += (-chunk_tiles) % mesh_n
    n_tiles = int(rowmask_arr.shape[0])
    if chunk_tiles and n_tiles > chunk_tiles:
        # chunked dispatch: cancel/statement_timeout can fire between
        # chunks instead of waiting out one long launch
        results = _chunked_dispatch(run_chunk, n_tiles, chunk_tiles,
                                    _out_combines(spec))
    else:
        results = run_chunk(0, n_tiles)
    results = _min_nan_rule(spec, results)

    if group_mode:
        return _build_group_batch(node, key_plans, agg_plans, results,
                                  provider, col_names, dictionaries,
                                  group_space, fact, distinct_plans)
    return _build_scalar_batch(node, agg_plans, results, distinct_plans)


def _scan_spec(compiled_preds, key_plans, factorized: bool, G: int,
               agg_plans, distinct_plans, slot_of, decode_specs):
    """The kernel's description of this query: the reference's `program`
    (device_agg.py:251-301) as data; a `device_split.Split` where one
    launch cannot take it."""
    aggs = []
    for si, (spec, ce) in enumerate(agg_plans):
        if si in distinct_plans:
            kind, vi, lo, vsize = distinct_plans[si]
            aggs.append(K.ScanAgg(
                K.AGG_PRESENCE, None, slot_of[vi],
                K.KEY_DICT if kind == "dict" else K.KEY_INT, lo, vsize))
            continue
        if spec.func == "count_star":
            continue
        ops = ce.remap(slot_of)
        is_float = ce.type == "f"
        if spec.func == "count":
            kind = K.AGG_COUNT
        elif spec.func in ("sum", "avg"):
            kind = K.AGG_SUM_F if is_float else K.AGG_SUM_I
        elif spec.func == "min":
            kind = K.AGG_MIN_F if is_float else K.AGG_MIN_I
        elif spec.func == "max":
            kind = K.AGG_MAX_F if is_float else K.AGG_MAX_I
        else:
            raise NotCompilable(spec.func)
        aggs.append(K.ScanAgg(kind, ops))
    keys = [(K.KEY_DICT if kind == "dict" else K.KEY_INT, slot_of[idx], lo,
             size) for kind, idx, lo, size in key_plans]
    preds = [pred_program(ce, slot_of) for ce in compiled_preds]
    return device_split.plan_scan(K.ScanSpec(
        [k for k, _ in decode_specs], [o for _, o in decode_specs], preds,
        keys, factorized, G, aggs))


def pred_program(ce, slot_of: dict) -> tuple:
    """A predicate's program over the scan slots, its value made a
    boolean, as the reference's programs take it (v != 0)."""
    tobool = {"f": ((K.OP_TOBOOL_F, 0, 0),), "b": ()}
    return ce.remap(slot_of) + tobool.get(ce.type,
                                          ((K.OP_TOBOOL_I, 0, 0),))


def _device_outputs(spec: K.ScanSpec, raw) -> list:
    """One launch's raw outputs as a flat list of device tensors, in the
    reference program's order (device_agg.py `program`: the row count,
    then per aggregate [presence] | [count] | [sum, count] | [min/max,
    count]), with one extra output after a float MIN's count: its non-NaN
    count, which `_min_nan_rule` spends once the chunks are combined. The
    float sums fold on the device (agg_fold; a plane of one row is
    already the sums); float min/max stay u32 images."""
    rowcount, outs = raw
    flat = [rowcount]
    for a, out in zip(spec.aggs, outs):
        if a.kind == K.AGG_SUM_F and out[0].numel() > spec.G:
            out = (K.agg_fold(out[0], spec.G),) + tuple(out[1:])
        flat.extend(out)
    return flat


def _host_outputs(spec: K.ScanSpec, flat: list, group_mode: bool) -> list:
    """`_device_outputs` fetched as numpy, float min/max images decoded
    on the device first, shaped as the host combine takes them."""
    from ..obs import device as obs_device
    G = spec.G
    dec = list(flat)
    at = 1
    for a in spec.aggs:
        if a.kind in (K.AGG_MIN_F, K.AGG_MAX_F):
            dec[at] = K.image_decode(dec[at])
        at += len(_KINDS[a.kind])
    host = iter(obs_device.fetch_all(dec))
    first = next(host)
    res = [first if group_mode else first.reshape(())]
    for a in spec.aggs:
        if a.kind == K.AGG_PRESENCE:
            res.append(next(host).reshape(G, a.pvsize))
            continue
        vals = [next(host) for _ in _KINDS[a.kind]]
        if not group_mode:
            vals = [x.reshape(()) for x in vals]
        res.extend(vals)
    return res


def _run_mesh_chunk(spec: K.ScanSpec, mesh, placed: dict, group_mode: bool,
                    start: int, end: int) -> list:
    """Tiles [start, end) over the mesh: M contiguous shards, one
    `agg_scan` a shard on its device (`placed`: the scan's inputs on each
    physical device), the outputs combined on the first device by kind
    (`mesh_combine`, one launch for every output; the float images as
    u32)."""
    M = mesh.size
    w = -(-(end - start) // M)
    shard_outs = []
    for s in range(M):
        a, b = start + s * w, min(start + (s + 1) * w, end)
        if a >= b:
            continue
        cols, rowmask, codes = placed[mesh.devices[s]]
        with mesh.shard(s):
            shard_outs.append(_device_outputs(
                spec, device_split.agg_scan(spec, cols, rowmask, codes, a,
                                            b)))
    kinds = _out_combines(spec)
    uns = [False]
    for a in spec.aggs:
        uns.extend([a.kind in (K.AGG_MIN_F, K.AGG_MAX_F)] +
                   [False] * (len(_KINDS[a.kind]) - 1))
    from ..parallel.mesh import apply_axis_combines
    flat = apply_axis_combines(shard_outs, kinds, mesh.first,
                               fuse_sums=True, unsigned=uns)
    return _host_outputs(spec, flat, group_mode)


#: per aggregate kind, its outputs' chunk (and mesh) combine kinds
_KINDS = {K.AGG_PRESENCE: ["max"], K.AGG_COUNT: ["sum"],
          K.AGG_SUM_I: ["sum", "sum"], K.AGG_SUM_F: ["sum", "sum"],
          K.AGG_MIN_I: ["min", "sum"], K.AGG_MAX_I: ["max", "sum"],
          K.AGG_MIN_F: ["min", "sum", "sum"], K.AGG_MAX_F: ["max", "sum"]}


def _out_combines(spec: K.ScanSpec) -> list:
    """Per-output chunk combine kinds, in the order of `_device_outputs`:
    'sum' adds (counts, int64 and float sums), 'min'/'max' fold, 'max'
    also unions the DISTINCT presence grids."""
    return ["sum"] + [c for a in spec.aggs for c in _KINDS[a.kind]]


def _min_nan_rule(spec: K.ScanSpec, results) -> list:
    """PG: NaN is the greatest float, so MIN skips NaN unless every row
    of the group is NaN. Applied once over the combined chunks (the
    reference applies it per chunk, so a group that is all NaN in one
    chunk reads NaN there — ROADMAP Queue 3); drops the non-NaN counts,
    leaving the reference program's output layout."""
    ri = iter(results)
    out = [next(ri)]
    for a in spec.aggs:
        if a.kind == K.AGG_PRESENCE:
            out.append(next(ri))
            continue
        vals = [next(ri)]
        if a.kind != K.AGG_COUNT:
            vals.append(next(ri))
        if a.kind == K.AGG_MIN_F:
            nonnan = next(ri)
            vals[0] = np.where((vals[1] > 0) & (nonnan == 0),
                               np.float32(np.nan), vals[0])
        out.extend(vals)
    return out


def _zonemap_range(scan, provider, preds, pin, nrows,
                   ctx) -> Optional[tuple[int, int]]:
    """Contiguous surviving row range [lo, hi) under the filter
    conjuncts' zone-map verdicts, or None when nothing prunes. Raises
    NotCompilable when EVERY block is pruned — the morsel path then
    resolves the query from the same verdicts without touching data.
    lo is block-aligned and therefore a multiple of the 128-lane tile."""
    from . import zonemap
    block_rows = int(ctx.settings.get("serene_morsel_rows"))
    verdicts = zonemap.block_verdicts(provider, ctx.settings, preds,
                                      scan.columns, block_rows, pin)
    if verdicts is None:
        return None
    lo, hi = zonemap.surviving_range(verdicts, block_rows, nrows)
    if hi <= lo:
        # don't touch the counters here: the host morsel path resolves
        # the query from the same verdict vector and does the counting
        raise NotCompilable("zone maps pruned every block")
    if (lo, hi) == (0, nrows):
        return None
    # only the envelope shrink is real pruning on the device path —
    # interior SKIP blocks inside [lo, hi) still upload and scan
    n_blocks = len(verdicts)
    lo_b, hi_b = lo // block_rows, (hi + block_rows - 1) // block_rows
    metrics.ZONEMAP_PRUNED.add(n_blocks - (hi_b - lo_b))
    metrics.ZONEMAP_SCANNED.add(hi_b - lo_b)
    if zonemap.verify_enabled(ctx.settings):
        full = pin[0] if pin is not None else \
            provider.full_batch(scan.columns)
        full = Batch(list(scan.columns),
                     [full.column(c) for c in scan.columns])
        spans = [(s, e) for s, e in ((0, lo), (hi, nrows)) if e > s]
        zonemap.verify_pruned_blocks(preds, full, spans,
                                     f"device aggregate {provider.name}")
    return lo, hi


def _range_device_columns(provider, names, pin, zrange, device) -> dict:
    """{name: DeviceColumn} for a row subrange, one publication
    observation (mirrors TableProvider.device_columns). Cached per
    (version, range, device) with one entry per column."""
    from . import zonemap as _zm
    from ..columnar.device import to_device_column
    lo, hi = zrange
    lock = _zm._zone_lock(provider)
    if pin is not None:
        batch, ver = pin[0], pin[1]
    else:
        batch, ver = None, provider.data_version
    stamp = (ver, lo, hi, str(device))
    with lock:
        cache = getattr(provider, "_zonemap_devcache", None)
        if cache is None:
            cache = provider._zonemap_devcache = {}
        hits = {n: e[1] for n in names
                if (e := cache.get(n)) is not None and e[0] == stamp}
    out = dict(hits)
    # uploads run OUTSIDE the lock: a large host→device copy must not
    # serialize every other query's zone-stats access on this provider
    for name in names:
        if name in out:
            continue
        col = (batch.column(name) if batch is not None
               else provider.full_batch([name]).column(name))
        dc = to_device_column(col.slice(lo, hi), device=device)
        metrics.DEVICE_BYTES.add(dc.data.numel() * dc.data.element_size())
        with lock:
            cache[name] = (stamp, dc)
        out[name] = dc
    return out


def _chunked_dispatch(run_chunk, n_tiles: int, chunk_tiles: int,
                      combines: list):
    """Run the aggregate launch chunk by chunk over the tile axis,
    combining per-output partials on host ('sum' adds exactly in
    int64/float64, 'min'/'max' fold elementwise). check_cancel() runs
    between launches, so a cancel or a statement timeout interrupts a
    long aggregate within one chunk's latency."""
    from .plan import check_cancel

    def widen(o, c):
        if c != "sum":
            return o
        # chunk-size-stable host accumulation: ints widen to int64,
        # floats to float64
        return o.astype(np.int64 if o.dtype.kind in "iu" else np.float64)

    acc = None
    for start in range(0, n_tiles, chunk_tiles):
        check_cancel()
        outs = run_chunk(start, min(start + chunk_tiles, n_tiles))
        if acc is None:
            acc = [widen(o, c) for o, c in zip(outs, combines)]
            continue
        for k, (o, c) in enumerate(zip(outs, combines)):
            if c == "sum":
                acc[k] = acc[k] + widen(o, c)
            elif c == "min":
                acc[k] = np.minimum(acc[k], o)
            else:
                acc[k] = np.maximum(acc[k], o)
    return tuple(acc)


def _plan_direct_keys(node, scan, host_col, col_names, dictionaries):
    """Direct group-key coding: dictionary codes / small-range integers.
    Raises NotCompilable when any key needs factorization. host_col reads
    from the query's pinned publication."""
    key_plans = []
    group_space = 1
    for g in node.group_exprs:
        if not isinstance(g, BoundColumn):
            raise NotCompilable("group key is not a plain column")
        t = scan.types[g.index]
        if t.is_string:
            d = dictionaries.get(g.index)
            if d is None:
                raise NotCompilable("string key without dictionary")
            size = len(d) + 1      # +1: NULL group
            key_plans.append(("dict", g.index, 0, size))
        elif t.is_integer or t.id in (dt.TypeId.BOOL, dt.TypeId.DATE):
            col = host_col(col_names[g.index])
            if col.data.size == 0:
                lo, hi = 0, 0
            else:
                lo, hi = int(col.data.min()), int(col.data.max())
            rng = hi - lo + 1
            if rng > MAX_INT_KEY_RANGE:
                raise NotCompilable("integer key range too large for direct coding")
            if not (-2**31 <= lo and hi < 2**31):
                # small range but offset beyond int32 (snowflake-style ids):
                # the raw column can't upload exactly — factorize instead
                raise NotCompilable("integer key offset beyond int32")
            size = rng + 1
            key_plans.append(("int", g.index, lo, size))
        else:
            raise NotCompilable(f"group key type {t}")
        group_space *= size
        if group_space > MAX_GROUP_PRODUCT:
            raise NotCompilable("group code space too large")
    return key_plans, group_space


def _factorize_group_keys(node, scan, provider, pin_batch, dev_ver,
                          device) -> dict:
    """Composite host factorization of arbitrary GROUP BY keys: evaluate
    the key expressions over the host columns, build dense codes (NULLs
    group per PG semantics), upload the codes as device tiles. Cached per
    (data_version, key exprs, device) — the factorize pass is O(n log n)
    once, amortized across queries."""
    ekeys = tuple(_expr_key(g) for g in node.group_exprs)
    # version + batch are ONE observation (passed in from the query's
    # pin): codes factorized over batch N+1 must never cache under N
    ver = dev_ver
    ckey = (ver, ekeys, str(device))
    lock = _factorize_lock(provider)
    with lock:
        cache = getattr(provider, "_factorize_cache", None)
        if cache is None:
            cache = provider._factorize_cache = {}
        stale = [k2 for k2 in cache if k2[0] != ver]
        for k2 in stale:  # old data versions can never be read again
            del cache[k2]
        hit = cache.get(ckey)
    if hit is not None:
        return hit
    if pin_batch is not None:
        full = Batch(list(scan.columns),
                     [pin_batch.column(c) for c in scan.columns])
    else:
        full = provider.full_batch(scan.columns)
    try:
        key_cols = [g.eval(full) for g in node.group_exprs]
    except Exception as e:
        # the host path evaluates keys only over WHERE-surviving rows; an
        # eval error on a filtered-out row (e.g. division by zero) must
        # decline, not surface
        raise NotCompilable(f"group key eval over unfiltered rows: {e}")
    # shared with the host morsel sink: direct (perfect-hash) coding for
    # small int/dict key spaces, factorize for arbitrary keys; group order
    # is identical either way
    from .morsel import _group_codes
    codes, uniq_vals, uniq_valid, g_count = _group_codes(key_cols)
    if g_count > MAX_GROUP_PRODUCT:
        raise NotCompilable(
            f"{g_count} distinct groups exceeds the device code-space cap")
    n_pad = pad_len(len(codes))
    padded = np.zeros(n_pad, dtype=np.int32)
    padded[:len(codes)] = codes
    value = {
        "codes2d": commit_host_array(padded.reshape(-1, 128), device),
        "uniq_vals": uniq_vals,
        "uniq_valid": uniq_valid,
        "g": g_count,
        "key_meta": [(c.type, c.dictionary) for c in key_cols],
    }
    with lock:
        if len(cache) >= 16:  # bound device memory held by codes buffers
            cache.pop(next(iter(cache)))
        cache[ckey] = value
    return value


def _build_scalar_batch(node, agg_plans, results,
                        distinct_plans=None) -> Batch:
    ri = iter(results)
    total = int(np.asarray(next(ri)))
    cols = []
    for si, (spec, ce) in enumerate(agg_plans):
        dplan = (distinct_plans or {}).get(si)
        if dplan is not None:
            pres = np.asarray(next(ri)).reshape(1, -1)
            cols.append(_distinct_result_col(spec, dplan, pres,
                                             np.asarray([0]))[0])
        else:
            cols.append(_scalar_result_col(spec, ri, total))
    return Batch(list(node.names), cols)


def _distinct_result_col(spec: AggSpec, dplan, pres: np.ndarray,
                         present: np.ndarray):
    """Presence matrix -> one result column, rows selected by `present`.
    Returns a 1-element list for uniform use."""
    kind, vi, lo, vsize = dplan
    sub = pres[present].astype(np.int64)
    cnt = sub.sum(axis=1)
    if spec.func == "count":
        return [Column(dt.BIGINT, cnt)]
    vals = (lo + np.arange(vsize, dtype=np.int64))
    sums = sub @ vals
    empty = cnt == 0
    if spec.func == "avg":
        with np.errstate(invalid="ignore", divide="ignore"):
            data = np.where(empty, 0.0, sums / np.maximum(cnt, 1))
        return [Column(dt.DOUBLE, data, ~empty if empty.any() else None)]
    t = spec.type
    if t.is_integer:
        return [Column(dt.BIGINT, sums,
                       ~empty if empty.any() else None)]
    return [Column(dt.DOUBLE, sums.astype(np.float64),
                   ~empty if empty.any() else None)]


def _scalar_result_col(spec: AggSpec, ri, total: int) -> Column:
    t = spec.type
    if spec.func == "count_star":
        return Column.from_pylist([total], t)
    if spec.func == "count":
        return Column.from_pylist([int(np.asarray(next(ri)))], t)
    if spec.func in ("sum", "avg"):
        first = np.asarray(next(ri))
        cnt = int(np.asarray(next(ri)))
        # an exact int64 sum, or an f32 (f64 once chunks combine) sum
        s = int(first) if first.dtype.kind in "iu" else float(first)
        if cnt == 0:
            return Column.from_pylist([None], t)
        if spec.func == "avg":
            return Column.from_pylist([s / cnt], t)
        return Column.from_pylist([s if t.is_integer else float(s)], t)
    if spec.func in ("min", "max"):
        v = np.asarray(next(ri))
        cnt = int(np.asarray(next(ri)))
        if cnt == 0:
            return Column.from_pylist([None], t)
        out = v.item()
        if t.is_integer:
            out = int(out)
        return Column.from_pylist([out], t)
    raise NotCompilable(spec.func)


def _build_group_batch(node, key_plans, agg_plans, results, provider,
                       col_names, dictionaries, g, fact=None,
                       distinct_plans=None) -> Batch:
    ri = iter(results)
    counts = np.asarray(next(ri)).astype(np.int64)
    present = np.flatnonzero(counts > 0)
    cols: list[Column] = []
    if fact is not None:
        for k2, (t, d) in enumerate(fact["key_meta"]):
            uv = np.asarray(fact["uniq_vals"][k2])[present]
            validity = fact["uniq_valid"][k2][present] \
                if fact["uniq_valid"].size else None
            if validity is not None and validity.all():
                validity = None
            cols.append(Column(t, uv, validity, d))
        for si, (spec, ce) in enumerate(agg_plans):
            dplan = (distinct_plans or {}).get(si)
            if dplan is not None:
                pres = np.asarray(next(ri))
                cols.extend(_distinct_result_col(spec, dplan, pres,
                                                 present))
            else:
                cols.append(_group_result_col(spec, ri, counts, present))
        return Batch(list(node.names), cols)
    # decode combined codes back to per-key codes
    sizes = [kp[3] for kp in key_plans]
    rem = present.copy()
    key_codes = []
    for size in reversed(sizes):
        key_codes.append(rem % size)
        rem //= size
    key_codes.reverse()
    for (kind, idx, lo, size), kc in zip(key_plans, key_codes):
        null_mask = kc == (size - 1)
        t = provider.type_of(col_names[idx])
        if kind == "dict":
            d = dictionaries[idx]
            data = np.where(null_mask, 0, kc).astype(np.int32)
            cols.append(Column(t, data,
                               ~null_mask if null_mask.any() else None, d))
        else:
            data = (kc + lo).astype(t.np_dtype)
            data = np.where(null_mask, 0, data).astype(t.np_dtype)
            cols.append(Column(t, data,
                               ~null_mask if null_mask.any() else None))
    for si, (spec, ce) in enumerate(agg_plans):
        dplan = (distinct_plans or {}).get(si)
        if dplan is not None:
            pres = np.asarray(next(ri))
            cols.extend(_distinct_result_col(spec, dplan, pres, present))
        else:
            cols.append(_group_result_col(spec, ri, counts, present))
    return Batch(list(node.names), cols)


def _group_result_col(spec: AggSpec, ri, star_counts, present) -> Column:
    t = spec.type
    if spec.func == "count_star":
        return Column(dt.BIGINT, star_counts[present])
    if spec.func == "count":
        c = np.asarray(next(ri)).astype(np.int64)
        return Column(dt.BIGINT, c[present])
    if spec.func in ("sum", "avg"):
        first = np.asarray(next(ri))
        cnt = np.asarray(next(ri)).astype(np.int64)[present]
        if first.dtype.kind in "iu":     # exact int64 sums
            sums = first.astype(np.int64)[present]
        else:
            sums = first.astype(np.float64)[present]
        empty = cnt == 0
        if spec.func == "avg":
            with np.errstate(invalid="ignore", divide="ignore"):
                data = np.where(empty, 0.0, sums / np.maximum(cnt, 1))
            return Column(dt.DOUBLE, data, ~empty if empty.any() else None)
        if t.is_integer:
            return Column(dt.BIGINT, sums.astype(np.int64),
                          ~empty if empty.any() else None)
        return Column(dt.DOUBLE, sums.astype(np.float64),
                      ~empty if empty.any() else None)
    if spec.func in ("min", "max"):
        v = np.asarray(next(ri))[present]
        cnt = np.asarray(next(ri)).astype(np.int64)[present]
        empty = cnt == 0
        data = np.where(empty, 0, v).astype(t.np_dtype)
        return Column(t, data, ~empty if empty.any() else None)
    raise NotCompilable(spec.func)
