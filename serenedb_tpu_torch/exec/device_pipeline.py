"""Fused device-side relational execution (port of
serenedb_tpu/exec/device_pipeline.py): a Scan→Filter→Join→Aggregate chain
and a filtered top-N each run on the card without materializing pairs.

Join representation: both sides' equi-keys factorize host-side into ONE
dense int64 code space (exec/morsel.combined_codes — NULL keys masked to
a per-side sentinel so NULL never matches, every NaN occurrence its own
code so NaN ≠ NaN, exactly the row-tuple oracle's semantics). The codes
upload as int32 tiles and the probe happens on the card as gathers:

- build phase: `agg_scan` (ops/csrc/agg.cu) with the build codes as its
  factorized group codes and G = g + 2 — per-code partials (match count,
  and per build-side aggregate its value count, exact int64 sum or int32
  min/max), the sentinel slots g and g + 1 zeroed;
- probe phase: `join_probe` (ops/csrc/join.cu) — per probe row the
  predicates, the gather of its code's match count, the output weight
  (max(count, 1) for LEFT/FULL), the direct group code, and one integer
  accumulation into the group outputs; for RIGHT/FULL the unmatched build
  rows then land in the all-NULL group slot.

A filtered top-N (Sort+Limit over Filter→Scan) is one `topn_scan` launch:
the predicates mask rows to the sort sentinel before the selection. A
chained Limit(Sort(Aggregate over a join)) keeps the stage-1 outputs on
the card and runs `chain_topn` over them: only the k picked rows come
back.

Exactness policy (PG parity): only integer/bool/date aggregate arguments
(and min/max over sorted-dictionary string codes) compile; the walls of
the reference stay as they are (MAX_CODE_SPACE, MAX_PAIRS_EXACT,
MAX_GROUP_PRODUCT, MAX_INT_KEY_RANGE, the int32 sentinel gates) so the
device tier admits the queries the reference's does, and declines count
under the reference's reasons. The port accumulates in native int64
where the reference uses 8-bit limbs; the rows are the same.

Transfers: uploads go through DEVICE_CACHE, a process-wide bytes-bounded
cache keyed by publication tuples (provider token, data_version,
mutation_epoch) + column + surviving row range — a repeat query on an
unchanged table uploads nothing, and any write moves the key. Zone maps
bound what uploads at all (each side's surviving block envelope).

Sharded tier (`serene_shards > 1`, the reference's gate): the probe
phase runs per round-robin probe shard after one publication-cached build
launch — N `join_probe` launches (shard s on mesh device s % n) and an
exact host combine under `serene_shard_combine = host`; under `device`
(the reference's collective over `data_mesh(S)`) one launch over the
concatenated shard spans on a one-device mesh, or one launch a mesh
device over an even slice of them, combined by `mesh_combine`.
`serene_mesh` is never read here, as in the reference.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column
from ..columnar.device import (LANES, DeviceNarrowingError,
                               commit_host_array, pad_len, to_device_column)
from ..device import device_scope, on_mesh_device
from ..obs import device as obs_device
from ..ops import agg_kernels as K
from ..ops import join_kernels as J
from ..ops import topn_kernels as TK
from ..parallel import mesh as mesh_mod
from ..sql.binder import _expr_key
from ..sql.expr import AggSpec, BoundColumn, BoundExpr, BoundFunc
from ..utils import log, metrics
from ..utils.config import REGISTRY as _settings_registry
from .device import DeviceExpr, NotCompilable, column_type, compile_expr
from .device_agg import (MAX_GROUP_PRODUCT, MAX_INT_KEY_RANGE, _ctx_device,
                         pred_program)

#: combined join-key code-space cap (dense per-code arrays on the card)
MAX_CODE_SPACE = 1 << 22
#: worst-case matched-pair bound of the reference's exact int32 scatters
#: (255 * pairs < 2^31); kept as the admission wall
MAX_PAIRS_EXACT = 1 << 23

_AGG_FUNCS = {"count_star", "count", "sum", "min", "max", "avg"}

#: expressions whose host-side evaluation draws shared mutable state or
#: runs a subplan — pre-evaluating them over unfiltered rows would
#: double-draw / reorder effects (same list the morsel tier excludes)
_HOST_EVAL_UNSAFE = {
    "scalar_subquery", "array_subquery", "in_subquery", "exists",
    "currval", "lastval"}


def _trace_span(trace, name: str, t0_ns: int, **args) -> None:
    """Timeline phase attribution (serene_trace); no-op when tracing is
    off (trace is None)."""
    if trace is not None:
        trace.add(name, "device", t0_ns, time.perf_counter_ns(), **args)


def fused_enabled(settings) -> bool:
    return bool(settings.get("serene_device_fused"))


def fused_ext_enabled(settings) -> bool:
    """Extended admission (strings/DISTINCT/FILTER/residual/outer joins
    + chained stage handoff); off restores the narrower walls."""
    return bool(settings.get("serene_device_fused_ext"))


def _pow2_int(n: int, floor: int = 8) -> int:
    """pow2 bucket of the DISTINCT value spaces and the chained k (part
    of the reference's admission arithmetic, so kept as it is)."""
    b = floor
    while b < n:
        b <<= 1
    return b


# -- publication-keyed device column cache ----------------------------------


def _pub(provider, pin) -> tuple:
    """(provider token, data_version, mutation_epoch): the publication
    tuple. The token is process-unique per provider object, so DROP +
    CREATE can never alias generations."""
    from ..cache.result import _provider_token
    if pin is not None:
        return (_provider_token(provider), pin[1], pin[2])
    return (_provider_token(provider),
            getattr(provider, "data_version", 0),
            getattr(provider, "mutation_epoch", 0))


def _charge_upload(nbytes: int) -> None:
    """Per-query attribution of a host→device transfer (obs/resources)."""
    from ..obs.resources import charge_device_upload
    charge_device_upload(nbytes)


class DeviceColumnCache:
    """Process-wide cache of device-resident arrays keyed by publication
    tuples. A key embeds (token, data_version, mutation_epoch) + column +
    row range + device, so invalidation is implicit: any write bumps the
    publication and the next query keys past the stale upload. Bytes are
    bounded by the serene_device_cache_mb global (LRU past the cap, at
    least one entry kept); superseded generations of a token are swept on
    store so the card never holds two versions of one column. With
    `serene_device_cache_trade` on, the cap trades with the posting and
    vector pools' live pages, as the reference's does."""

    def __init__(self):
        #: key -> [value, nbytes, last-touch epoch s, hits, device index]
        self._entries: OrderedDict[tuple, list] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @staticmethod
    def _trade_on() -> bool:
        try:
            return bool(_settings_registry.get_global(
                "serene_device_cache_trade"))
        except KeyError:  # pragma: no cover
            return False

    def _cap_bytes(self) -> int:
        """Byte cap of THIS side of the device budget. With the
        pressure trade on, the cap is the serene_device_cache_mb
        envelope minus the posting and vector pools' LIVE page bytes,
        floored at a quarter of the envelope — the pools' residency
        squeezes the column cache instead of a static carve-out, and
        vice versa via shed_colder. Consults the pools' locks, so call
        it OUTSIDE self._lock (the only cross-lock order is
        cache-unlocked → pool; the pools never call into this cache)."""
        env = int(_settings_registry.get_global(
            "serene_device_cache_mb")) << 20
        if self._trade_on():
            try:
                from ..search.posting_pool import POOL
                from ..search.vector_store import VPOOL
                return max(env // 4,
                           env - POOL.live_bytes() - VPOOL.live_bytes())
            except Exception:  # noqa: BLE001 — sizing only, never fatal
                pass
        return env

    def get(self, key: tuple):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                metrics.DEVICE_CACHE_MISSES.add()
                return None
            self._entries.move_to_end(key)
            entry[2] = time.time()
            entry[3] += 1
            metrics.DEVICE_CACHE_HITS.add()
            return entry[0]

    def put(self, key: tuple, value, nbytes: int, sweep=None) -> None:
        """Store + LRU/byte bookkeeping. `sweep(k) -> bool` marks extra
        keys as superseded (code tiles whose staleness comes from the
        PARTNER table's publication)."""
        cap = self._cap_bytes()        # pool consult happens pre-lock
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            token, name = key[0][0], key[1]
            stale = [k for k in self._entries
                     if (k[0][0] == token and k[1] == name and
                         k[0] != key[0]) or
                     (sweep is not None and k != key and sweep(k))]
            for k in stale:
                self._bytes -= self._entries.pop(k)[1]
                metrics.DEVICE_CACHE_EVICTIONS.add()
            self._entries[key] = [value, nbytes, time.time(), 0,
                                  _holding_device(value)]
            self._bytes += nbytes
            over = self._bytes - cap
            tail_idle_s = None
            if over > 0:
                for e in self._entries.values():
                    tail_idle_s = time.time() - e[2]
                    break
        if over > 0 and self._trade_on() and tail_idle_s is not None:
            # pressure trade: before shedding our own tail, offer the
            # eviction to the COLDEST pool tail (posting pages or vector
            # pages) if it is idler than ours — freed pages raise this
            # cache's cap directly
            try:
                from ..search.posting_pool import POOL
                from ..search.vector_store import VPOOL
                pools = sorted(
                    ((idle, p) for p in (POOL, VPOOL)
                     for idle in (p.tail_idle_ns(),) if idle is not None),
                    reverse=True)
                shed = False
                for pool_idle, p in pools:
                    if pool_idle > tail_idle_s * 1e9 and \
                            p.shed_colder(int(tail_idle_s * 1e9), over):
                        shed = True
                        break
                if shed:
                    cap = self._cap_bytes()
            except Exception:  # noqa: BLE001 — sizing only, never fatal
                pass
        with self._lock:
            while self._bytes > cap and len(self._entries) > 1:
                _, e = self._entries.popitem(last=False)
                self._bytes -= e[1]
                metrics.DEVICE_CACHE_EVICTIONS.add()
            metrics.DEVICE_CACHE_BYTES.set(self._bytes)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            metrics.DEVICE_CACHE_BYTES.set(0)

    def stats(self) -> dict:
        cap = self._cap_bytes()
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "cap_bytes": cap}

    def device_bytes(self) -> dict[int, int]:
        """Bytes per holding device (the physical index; the shards of a
        virtual mesh share their one copy, which counts for device 0)."""
        out: dict[int, int] = {}
        with self._lock:
            for e in self._entries.values():
                out[e[4]] = out.get(e[4], 0) + e[1]
        return out

    def snapshot(self) -> list[dict]:
        """One row per live entry (the sdb_device_cache body): which
        publication and column, how big, on which device, how recently
        touched."""
        now = time.time()
        with self._lock:
            return [{"token": pub[0], "data_version": pub[1],
                     "mutation_epoch": pub[2], "column": name,
                     "kind": kind, "tag": repr(tag)[:120], "bytes": e[1],
                     "devices": str(e[4]), "hits": e[3],
                     "idle_ms": round((now - e[2]) * 1e3, 1)}
                    for (pub, name, kind, tag), e in self._entries.items()]

    def column(self, pub: tuple, name: str, host_col_fn,
               zrange: Optional[tuple], device, spans=None):
        """Device tiles of one column (optionally row-sliced, or with
        `spans` restricted to a shard's row spans: exec/shard.py's
        round-robin block set), cached by (publication, column, range or
        spans, device). host_col_fn() materializes the host column only
        on a miss."""
        rows = zrange if spans is None else ("spans", tuple(spans))
        key = (pub, name, "col", (rows, str(device)))
        dc = self.get(key)
        if dc is not None:
            return dc
        col = host_col_fn()
        if spans is not None:
            from .shard import _concat_spans
            col = _concat_spans(col, spans)
        elif zrange is not None:
            col = col.slice(zrange[0], zrange[1])
        dc = to_device_column(col, device=device)
        nbytes = dc.data.numel() * dc.data.element_size() + dc.mask.numel()
        metrics.DEVICE_BYTES.add(nbytes)
        _charge_upload(nbytes)
        self.put(key, dc, nbytes)
        return dc

    def outputs(self, pub: tuple, name: str, tag, build_fn, sweep=None):
        """Cached device outputs of a launch under ONE key (the sharded
        tier's build phase: per-code counts and partials) — a repeat
        query skips the build launch entirely. build_fn() returns a
        nested tuple of tensors."""
        key = (pub, name, "arr", tag)
        val = self.get(key)
        if val is not None:
            return val
        val = build_fn()

        def flat(v):
            return [v] if isinstance(v, torch.Tensor) else \
                [t for x in v for t in flat(x)]
        nbytes = sum(t.numel() * t.element_size() for t in flat(val))
        metrics.DEVICE_BYTES.add(nbytes)
        self.put(key, val, nbytes, sweep=sweep)
        return val

    def array(self, pub: tuple, name: str, tag, build_fn, sweep=None):
        """A cached device array (code tiles, row masks): build_fn()
        uploads it on a miss."""
        key = (pub, name, "arr", tag)
        arr = self.get(key)
        if arr is not None:
            return arr
        arr = build_fn()
        nbytes = arr.numel() * arr.element_size()
        metrics.DEVICE_BYTES.add(nbytes)
        _charge_upload(nbytes)
        self.put(key, arr, nbytes, sweep=sweep)
        return arr


DEVICE_CACHE = DeviceColumnCache()


def _holding_device(value) -> int:
    """The physical index of the first tensor in a cached value (a
    DeviceColumn, a tensor or nested tuples of them); 0 for the CPU."""
    if isinstance(value, torch.Tensor):
        return int(value.device.index or 0)
    data = getattr(value, "data", None)
    if isinstance(data, torch.Tensor):
        return int(data.device.index or 0)
    if isinstance(value, (tuple, list)):
        for v in value:
            if isinstance(v, (torch.Tensor, tuple, list)) or \
                    hasattr(v, "data"):
                return _holding_device(v)
    return 0

#: host-side factorized join-code cache: (pub_l, pub_r, key exprs) →
#: (codes_l, codes_r, g, worst-case pairs). Count- and byte-bounded;
#: superseded publication pairs are swept on store.
_CODES_CACHE: OrderedDict[tuple, tuple] = OrderedDict()
_CODES_CACHE_MAX = 16
_CODES_CACHE_MAX_BYTES = 256 << 20
_codes_bytes = 0
_codes_lock = threading.Lock()

#: column admission stats, (pub, column) → (all_valid, finite_all, lo,
#: hi) — a pure function of the publication
_COL_STATS_CACHE: OrderedDict[tuple, tuple] = OrderedDict()
_COL_STATS_MAX = 64
_col_stats_lock = threading.Lock()


def clear_codes_cache() -> None:
    """Drop every cached factorization and reset the byte accounting."""
    global _codes_bytes
    with _codes_lock:
        _CODES_CACHE.clear()
        _codes_bytes = 0


def _rowmask_tiles(nrows: int, device) -> torch.Tensor:
    rm = np.zeros(pad_len(nrows), dtype=bool)
    rm[:nrows] = True
    return commit_host_array(rm.reshape(-1, LANES), device)


# -- pipeline recognition ----------------------------------------------------


def _split_and(e: BoundExpr) -> list[BoundExpr]:
    """Top-level AND conjuncts (a Filter keeps only rows where the whole
    expression is TRUE, so `a AND b` splits losslessly even under
    three-valued logic)."""
    if isinstance(e, BoundFunc) and e.name == "and":
        out: list[BoundExpr] = []
        for a in e.args:
            out.extend(_split_and(a))
        return out
    return [e]


def _unwrap_side(plan):
    """Filter*(Scan) → (scan, [scan-schema-bound predicates]) or None."""
    from .plan import FilterNode, ScanNode
    preds: list[BoundExpr] = []
    node = plan
    while isinstance(node, FilterNode):
        preds.append(node.pred)
        node = node.child
    if type(node) is not ScanNode:
        return None
    if node.filter is not None:
        preds.append(node.filter)
    return node, preds


def _side_of(expr: BoundExpr, nl: int) -> int:
    """0 = probe (left), 1 = build (right); raises when the expression
    reads columns of both join sides."""
    sides = set()
    for sub in expr.walk():
        if isinstance(sub, BoundColumn):
            sides.add(0 if sub.index < nl else 1)
    if len(sides) > 1:
        raise NotCompilable("expression spans both join sides")
    return sides.pop() if sides else 0


def _check_host_eval_safe(exprs: list[BoundExpr]) -> None:
    from ..sql.binder import _VOLATILE_FUNCS
    unsafe = _VOLATILE_FUNCS | _HOST_EVAL_UNSAFE
    for e in exprs:
        for sub in e.walk():
            if isinstance(sub, BoundFunc) and sub.name in unsafe:
                raise NotCompilable(f"host-evaluated {sub.name}")


class _Side:
    """One join side's publication observation + host access + zone range."""

    def __init__(self, scan, preds: list[BoundExpr], ctx):
        self.scan = scan
        self.preds = preds
        self.provider = scan.provider
        self.pin = self.provider.try_pin()
        self.pub = _pub(self.provider, self.pin)
        try:
            self.nrows = self.pin[0].num_rows if self.pin is not None \
                else self.provider.row_count()
        except NotImplementedError:
            raise NotCompilable("provider without row_count")
        #: per-block scan-conjunct verdicts (the sharded tier combines
        #: them with the shard-to-shard join filter's)
        self.verdicts = None
        self.zrange = self._zone_range(ctx)

    def host_col(self, name: str) -> Column:
        if self.pin is not None:
            return self.pin[0].column(name)
        return self.provider.host_column(name)

    def _zone_range(self, ctx) -> Optional[tuple[int, int]]:
        """Surviving block envelope under this side's scan conjuncts
        (upload shrink; interior SKIP blocks still upload). (0, 0) when
        everything prunes — the caller short-circuits to the empty
        result the host path would produce from the same verdicts."""
        if not self.preds:
            return None
        from . import zonemap
        block_rows = int(ctx.settings.get("serene_morsel_rows"))
        verdicts = zonemap.block_verdicts(
            self.provider, ctx.settings, self.preds, self.scan.columns,
            block_rows, self.pin)
        if verdicts is None:
            return None
        self.verdicts = verdicts
        lo, hi = zonemap.surviving_range(verdicts, block_rows, self.nrows)
        if hi <= lo:
            return (0, 0)
        if (lo, hi) == (0, self.nrows):
            return None
        n_blocks = len(verdicts)
        lo_b, hi_b = lo // block_rows, (hi + block_rows - 1) // block_rows
        metrics.ZONEMAP_PRUNED.add(n_blocks - (hi_b - lo_b))
        metrics.ZONEMAP_SCANNED.add(hi_b - lo_b)
        if zonemap.verify_enabled(ctx.settings):
            full = self.pin[0] if self.pin is not None else \
                self.provider.full_batch(self.scan.columns)
            full = Batch(list(self.scan.columns),
                         [full.column(c) for c in self.scan.columns])
            spans = [(s, e) for s, e in ((0, lo), (hi, self.nrows))
                     if e > s]
            zonemap.verify_pruned_blocks(
                self.preds, full, spans,
                f"fused pipeline {self.provider.name}")
        return lo, hi

    @property
    def lo(self) -> int:
        return 0 if self.zrange is None else self.zrange[0]

    @property
    def n_live(self) -> int:
        if self.zrange is None:
            return self.nrows
        return self.zrange[1] - self.zrange[0]


def _device_env(side: _Side, names: dict, device, spans=None) -> dict:
    """{join index: DeviceColumn} of one side's needed columns, through
    the publication-keyed cache, each checked against its SQL type: the
    side's surviving range, or with `spans` a shard's row spans."""
    obs_device.note_provider(side.pub[0], side.provider.name)
    out = {}
    for ji, (name, t) in names.items():
        dc = DEVICE_CACHE.column(
            side.pub, name, (lambda s=side, n=name: s.host_col(n)),
            side.zrange, device, spans)
        kind, _off = K.col_kind(dc)
        want = column_type(t)
        if (want == "f") != (kind == K.COL_F32) or \
                (want == "i8") != (kind == K.COL_I8):
            raise NotCompilable(f"column {name}: tiles do not match its "
                                f"type {t}")
        out[ji] = dc
    return out


# -- fused Scan→Filter→Join→Aggregate ---------------------------------------


#: join kinds the fused tier executes (outer kinds behind
#: serene_device_fused_ext)
_JOIN_KINDS = ("inner", "left", "right", "full")

#: DISTINCT is a no-op for these
_DISTINCT_DROP = {"min", "max"}


def _note_decline(reason: str, ctx, node) -> None:
    obs_device.note_fused_decline(
        reason, profile=getattr(ctx, "profile", None), node_key=id(node))


def _admit_pipeline(node, ctx, decline):
    """Shape recognition + admission walls shared by the aggregate hook
    (try_device_pipeline) and the chained top-N hook. Returns
    (join, probe_side, build_side, post_preds) or None — every None
    taken AFTER the shape is recognizably a join pipeline went through
    `decline` first."""
    from .plan import JoinNode, FilterNode

    settings = ctx.settings
    ext = fused_ext_enabled(settings)
    post_preds: list[BoundExpr] = []
    child = node.child
    while isinstance(child, FilterNode):
        post_preds.extend(_split_and(child.pred))
        child = child.child
    if type(child) is not JoinNode:
        return None
    join = child

    if not join.left_keys:
        return decline("cross_join")
    if join.merge_pairs:
        return decline("merge_pairs")
    if join.kind not in _JOIN_KINDS:
        return decline("join_kind")
    if join.kind != "inner" and not ext:
        return decline("outer_join")
    if join.residual is not None:
        # an inner join's residual is exactly a post-join pair filter;
        # under outer kinds it changes which rows null-extend
        if not ext or join.kind != "inner":
            return decline("residual")
        post_preds = post_preds + _split_and(join.residual)
    probe_side = _unwrap_side(join.left)
    build_side = _unwrap_side(join.right)
    if probe_side is None or build_side is None:
        return decline("side_shape")
    for spec in node.aggs:
        if spec.func not in _AGG_FUNCS:
            return decline("agg_func")
        if spec.order_by:
            return decline("agg_order_by")
        if spec.distinct and not ext:
            return decline("distinct")
        if spec.filter is not None and not ext:
            return decline("agg_filter")
    pscan = probe_side[0]
    if settings.get("serene_device") == "auto":
        try:
            if pscan.provider.row_count() < \
                    settings.get("serene_device_min_rows"):
                return None
        except NotImplementedError:
            return None
    return join, probe_side, build_side, post_preds


def try_device_pipeline(node, ctx) -> Optional[Batch]:
    """Attempt device execution of AggregateNode over an equi-join of two
    scans; None → host path (the parity oracle). Every None taken AFTER
    the shape is recognizably a join pipeline records a per-reason
    decline (obs_device.note_fused_decline)."""
    settings = ctx.settings
    if settings.get("serene_device") == "cpu" or not fused_enabled(settings):
        return None

    def decline(reason: str) -> None:
        _note_decline(reason, ctx, node)
        return None

    admitted = _admit_pipeline(node, ctx, decline)
    if admitted is None:
        return None
    join, probe_side, build_side, post_preds = admitted
    try:
        return _run_fused(node, join, probe_side, build_side, post_preds,
                          ctx)
    except (NotCompilable, DeviceNarrowingError) as e:
        log.debug("device", f"fused pipeline fell back to CPU: {e}")
        return decline(getattr(e, "reason", "not_compilable"))


def _gated(ce: Optional[DeviceExpr], fe: Optional[DeviceExpr],
           slot_of: dict) -> tuple:
    """An aggregate's program over one side's slots: its argument (or the
    constant 1 for count(*)), valid only where the FILTER clause `fe`, if
    any, is TRUE."""
    ops = ce.remap(slot_of) if ce is not None else ((K.OP_I32, 0, 1),)
    if fe is None:
        return ops
    if max(ce.depth if ce is not None else 1, 1 + fe.depth) > K.MAX_STACK:
        raise NotCompilable("FILTER needs a deeper stack than the device's",
                            "device_stack")
    return ops + pred_program(fe, slot_of) + ((K.OP_GATE, 0, 0),)


def _run_fused(node, join, probe_side, build_side,
               post_preds: list[BoundExpr], ctx, fetch: bool = True):
    """Execute the fused pipeline. fetch=True (default) fetches the
    outputs and finalizes to a host Batch. fetch=False is the chained-
    stage entry: it returns (device outputs, finalize ctx) WITHOUT any
    device→host readback, so the top-N stage can consume the
    accumulators on the card."""
    device = _ctx_device(ctx)
    prof = getattr(ctx, "profile", None)
    from ..obs.trace import current_trace
    tspan = functools.partial(_trace_span, current_trace())
    clock = time.perf_counter_ns

    pscan, ppreds = probe_side
    bscan, bpreds = build_side
    nl = len(join.left.names)
    _check_host_eval_safe(list(join.left_keys) + list(join.right_keys))

    t0 = clock()
    probe = _Side(pscan, ppreds, ctx)
    build = _Side(bscan, bpreds, ctx)

    # split the post-join conjuncts by side: a pair filter that reads
    # only probe (build) columns is exactly a probe (build) row filter
    # under an inner join — and under an OUTER join only on the side
    # that never null-extends
    post_p: list[BoundExpr] = []
    post_b: list[BoundExpr] = []
    for p in post_preds:
        try:
            sd = _side_of(p, nl)
        except NotCompilable:
            raise NotCompilable("post-join predicate spans both sides",
                                "post_pred_cross_side")
        (post_p if sd == 0 else post_b).append(p)
    outer_left = join.kind in ("left", "full")    # probe rows null-extend
    outer_right = join.kind in ("right", "full")  # build rows null-extend
    if outer_left and post_b:
        raise NotCompilable("post filter on null-extended build side",
                            "outer_post_filter")
    if outer_right and post_p:
        raise NotCompilable("post filter on null-extended probe side",
                            "outer_post_filter")

    # group keys: plain probe-side columns, direct-coded
    for gx in node.group_exprs:
        if not isinstance(gx, BoundColumn) or gx.index >= nl:
            raise NotCompilable("group key is not a plain probe column")

    # referenced-column dictionaries (join-schema namespace: probe scan
    # col i == join col i, build scan col i == join col nl + i)
    dictionaries: dict[int, np.ndarray] = {}
    join_types = list(join.types)

    def note_dicts(exprs):
        for e in exprs:
            for sub in e.walk():
                if isinstance(sub, BoundColumn) and sub.type.is_string:
                    ji = sub.index
                    if ji in dictionaries:
                        continue
                    if ji < nl:
                        col = probe.host_col(pscan.columns[ji])
                    else:
                        col = build.host_col(bscan.columns[ji - nl])
                    if col.dictionary is not None:
                        dictionaries[ji] = col.dictionary

    note_dicts(post_p + post_b + list(node.group_exprs) +
               [s.arg for s in node.aggs if s.arg is not None] +
               [s.filter for s in node.aggs if s.filter is not None])

    # scan-level predicates compile against the scan schema; their input
    # slots translate into the join namespace
    def compile_scan_preds(side: _Side, shift: int) -> list[DeviceExpr]:
        dicts = {}
        for e in side.preds:
            for sub in e.walk():
                if isinstance(sub, BoundColumn) and sub.type.is_string \
                        and sub.index not in dicts:
                    col = side.host_col(side.scan.columns[sub.index])
                    if col.dictionary is not None:
                        dicts[sub.index] = col.dictionary
        out = []
        for e in side.preds:
            ce = compile_expr(e, side.scan.types, dicts)
            ce.inputs = [i + shift for i in ce.inputs]
            out.append(ce)
        return out

    preds_probe = compile_scan_preds(probe, 0) + \
        [compile_expr(p, join_types, dictionaries) for p in post_p]
    preds_build = compile_scan_preds(build, nl) + \
        [compile_expr(p, join_types, dictionaries) for p in post_b]

    # group-key plans (direct coding; the NULL group takes the last slot)
    key_plans, group_space = _plan_group_keys(node, join_types, probe,
                                              pscan, dictionaries)
    group_mode = bool(node.group_exprs)

    # aggregate plans: (spec, side, compiled arg | None), plus the
    # per-agg FILTER programs, count_star FILTER sides and DISTINCT plans
    ext = fused_ext_enabled(ctx.settings)
    agg_plans: list[tuple] = []
    agg_filters: dict[int, DeviceExpr] = {}
    star_filter: dict[int, int] = {}       # si → side of the filter
    distinct_sis: list[int] = []
    for si, spec in enumerate(node.aggs):
        fe = None
        fside = 0
        if spec.filter is not None:
            _check_host_eval_safe([spec.filter])
            fside = _side_of(spec.filter, nl)
            fe = compile_expr(spec.filter, join_types, dictionaries)
        if spec.func == "count_star":
            if fe is not None:
                star_filter[si] = fside
                agg_filters[si] = fe
                agg_plans.append((spec, fside, None))
            else:
                agg_plans.append((spec, 0, None))
            continue
        side = _side_of(spec.arg, nl)
        if fe is not None:
            if fside != side:
                raise NotCompilable(
                    "FILTER predicate on the other join side",
                    "filter_cross_side")
            agg_filters[si] = fe
        t = spec.arg.type
        if spec.distinct and spec.func not in _DISTINCT_DROP:
            distinct_sis.append(si)
        if spec.func in ("sum", "avg"):
            if not t.is_integer:
                raise NotCompilable(f"{spec.func} over {t} (exactness)",
                                    "agg_type")
        elif spec.func in ("min", "max"):
            if not (t.is_integer or
                    t.id in (dt.TypeId.BOOL, dt.TypeId.DATE)):
                # sorted dictionaries give strings a total order on
                # int32 codes: min/max over codes, decode at finalize
                if not (ext and t.is_string and
                        isinstance(spec.arg, BoundColumn) and
                        dictionaries.get(spec.arg.index) is not None):
                    raise NotCompilable(f"{spec.func} over {t}",
                                        "agg_type")
        agg_plans.append((spec, side,
                          compile_expr(spec.arg, join_types, dictionaries)))

    # DISTINCT (count/sum/avg): a (group, value) presence grid over the
    # probe side's direct-coded values
    distinct_plans: dict[int, tuple] = {}
    for si in distinct_sis:
        spec, side, ce = agg_plans[si]
        if side != 0 or not isinstance(spec.arg, BoundColumn):
            raise NotCompilable("DISTINCT arg is not a plain probe column",
                                "distinct_arg")
        ji = spec.arg.index
        t = spec.arg.type
        if t.is_string:
            d = dictionaries.get(ji)
            if d is None:
                raise NotCompilable("DISTINCT string without dictionary",
                                    "distinct_arg")
            dkind, lo_v, vspace = "dict", 0, len(d)
        elif t.is_integer or t.id in (dt.TypeId.BOOL, dt.TypeId.DATE):
            _, _, lo_v, hi_v = _col_stats(probe, pscan.columns[ji])
            if lo_v is None:
                raise NotCompilable("DISTINCT value range unknown",
                                    "distinct_space")
            rng = hi_v - lo_v + 1
            if rng > MAX_INT_KEY_RANGE:
                raise NotCompilable("DISTINCT value range too large",
                                    "distinct_space")
            dkind, vspace = "int", rng
        else:
            raise NotCompilable(f"DISTINCT over {t}", "distinct_arg")
        vspace = _pow2_int(max(vspace, 1))
        if group_space * vspace > MAX_GROUP_PRODUCT:
            raise NotCompilable("DISTINCT presence grid too large",
                                "distinct_space")
        distinct_plans[si] = (dkind, ji, int(lo_v), vspace)
    if prof is not None:
        prof.add_device_ns(id(node), clock() - t0)
    tspan("device_compile", t0)

    # join-key factorization (host, cached per publication pair along
    # with the worst-case pair count)
    t0 = clock()
    cl, cr, g, total_pairs = _join_codes(join, probe, build)
    if g + 2 > MAX_CODE_SPACE:
        raise NotCompilable("join code space too large")
    # outer kinds add up to one output row per null-extended input row
    # on top of the inner pairs
    eff_pairs = total_pairs + (probe.nrows if outer_left else 0) + \
        (build.nrows if outer_right else 0)
    if eff_pairs > MAX_PAIRS_EXACT:
        raise NotCompilable(
            f"{eff_pairs} worst-case pairs exceed the exact-scatter "
            f"bound")
    if probe.zrange is not None:
        cl = cl[probe.zrange[0]:probe.zrange[1]]
    if build.zrange is not None:
        cr = cr[build.zrange[0]:build.zrange[1]]
    if prof is not None:
        prof.add_device_ns(id(join), clock() - t0)
    tspan("device_factorize", t0)

    # empty short-circuit: zero output rows only when NEITHER side can
    # null-extend past the empty one
    if probe.n_live == 0 or build.n_live == 0:
        empty_ok = (probe.n_live == 0 and build.n_live == 0) or \
            (probe.n_live == 0 and not outer_right) or \
            (build.n_live == 0 and not outer_left)
        if not empty_ok:
            raise NotCompilable("outer join with an empty side",
                                "outer_empty")
        results = _zero_results(agg_plans, group_space, star_filter,
                                distinct_plans)
        return _finalize(node, key_plans, agg_plans, results,
                         dictionaries, group_space, group_mode,
                         star_filter=star_filter,
                         distinct_plans=distinct_plans)

    # device environment: per side, the columns its programs read
    needed: set[int] = set()
    for ce in preds_probe + preds_build:
        needed.update(ce.inputs)
    for kp in key_plans:
        needed.add(kp[1])
    for spec, side, ce in agg_plans:
        if ce is not None:
            needed.update(ce.inputs)
    for fe in agg_filters.values():
        needed.update(fe.inputs)
    for (_dk, d_ji, _lo, _vs) in distinct_plans.values():
        needed.add(d_ji)
    p_need = sorted(i for i in needed if i < nl)
    b_need = sorted(i for i in needed if i >= nl)
    if max(len(p_need), len(b_need)) > K.MAX_COLS:
        raise NotCompilable(f"a join side reads more than {K.MAX_COLS} "
                            "columns (device limit)", "device_cols")
    p_names = {ji: (pscan.columns[ji], join_types[ji]) for ji in p_need}
    t0 = clock()
    env_b = _device_env(build, {ji: (bscan.columns[ji - nl], join_types[ji])
                                for ji in b_need}, device)

    # code tiles + row masks (sentinels baked in host-side: NULL-key /
    # padding probe rows → g+1, build rows → g; neither ever matches).
    # A codes entry is stale when EITHER side's publication moved: the
    # owner-generation sweep covers this side, the sweep predicate
    # covers entries pinned to an older generation of the partner.
    keyset = (tuple(_expr_key(k) for k in join.left_keys),
              tuple(_expr_key(k) for k in join.right_keys))
    dev_tag = str(device)
    bc_dev = DEVICE_CACHE.array(
        build.pub, "__codes__",
        (probe.pub, keyset, build.zrange, "b", dev_tag),
        lambda: _code_tiles(cr, g, device),
        sweep=_partner_stale_pred(build.pub, probe.pub, "b", keyset))
    brow = DEVICE_CACHE.array(build.pub, "__rowmask__",
                              (build.zrange, dev_tag),
                              lambda: _rowmask_tiles(build.n_live, device))

    # the launch descriptions: data-free, cached like the reference's
    # programs (keyed by everything the lowering reads; the probe side's
    # decode differs per uploaded span set)
    slot_p = {ji: s for s, ji in enumerate(p_need)}
    slot_b = {ji: s for s, ji in enumerate(b_need)}
    dec_b = [K.col_kind(env_b[ji]) for ji in b_need]
    consts_sig = tuple(ce.consts for ce in preds_probe + preds_build) + \
        tuple(ce.consts for _s, _sd, ce in agg_plans if ce is not None) + \
        tuple(agg_filters[si].consts for si in sorted(agg_filters))
    shape_sig = (
        join.kind, tuple(p_need), tuple(b_need), tuple(dec_b), g,
        group_space, tuple(key_plans),
        tuple(sorted(star_filter.items())),
        tuple(sorted(distinct_plans.items())), consts_sig,
        tuple(_expr_key(p) for p in ppreds),
        tuple(_expr_key(p) for p in bpreds),
        tuple(_expr_key(p) for p in post_preds),
        tuple((s.func, _expr_key(s.arg) if s.arg is not None else None,
               bool(s.distinct),
               _expr_key(s.filter) if s.filter is not None else None)
              for s in node.aggs),
        tuple(_expr_key(gx) for gx in node.group_exprs))

    def specs_for(env_p: dict):
        dec_p = [K.col_kind(env_p[ji]) for ji in p_need]

        def build_specs():
            return _launch_specs(
                agg_plans, agg_filters, star_filter, distinct_plans,
                key_plans, preds_probe, preds_build, slot_p, slot_b, dec_p,
                dec_b, g, group_space, group_mode, outer_left, outer_right)
        return obs_device.compiled(
            "fused", ("fused", tuple(dec_p)) + shape_sig, build_specs,
            profile=prof, node_key=id(node))

    # sharded tier: the probe phase runs once per probe shard
    # (round-robin block partitions) after one publication-cached build
    # launch; the per-shard int64 accumulators combine exactly on the
    # host (or, under the device combine, one launch over the
    # concatenated shard spans) — bit-identical to shards = 1. Outer
    # kinds, FILTER masks and DISTINCT grids run single-dispatch only
    # (LEFT's max(cnt, 1) weight and presence grids do not add across
    # shards); chained (fetch=False) callers need ONE launch's outputs
    # on the card
    from . import shard as shard_mod
    n_shards = shard_mod.shard_count(ctx.settings)
    block_rows = int(ctx.settings.get("serene_morsel_rows"))
    plain = (join.kind == "inner" and not agg_filters and
             not star_filter and not distinct_plans)
    if fetch and plain and n_shards > 1 and probe.n_live > block_rows:
        return _run_fused_sharded(
            node, join, probe, build, pscan, p_names, key_plans, agg_plans,
            group_space, group_mode, dictionaries, cl, g, keyset, device,
            env_b, b_need, bc_dev, brow, specs_for, shape_sig, ctx, prof,
            clock, block_rows, n_shards)

    env_p = _device_env(probe, p_names, device)
    pc_dev = DEVICE_CACHE.array(
        probe.pub, "__codes__",
        (build.pub, keyset, probe.zrange, "p", dev_tag),
        lambda: _code_tiles(cl, g + 1, device),
        sweep=_partner_stale_pred(probe.pub, build.pub, "p", keyset))
    prow = DEVICE_CACHE.array(probe.pub, "__rowmask__",
                              (probe.zrange, dev_tag),
                              lambda: _rowmask_tiles(probe.n_live, device))
    if prof is not None:
        prof.add_device_ns(id(pscan), clock() - t0)
    tspan("device_upload", t0)
    bspec, pspec, uspec, build_slots = specs_for(env_p)
    cache_key = ("fused", tuple(K.col_kind(env_p[ji]) for ji in p_need)) + \
        shape_sig

    from .plan import check_cancel
    check_cancel()
    t0 = clock()
    metrics.DEVICE_OFFLOADS.add()
    bcols = [(env_b[ji].data, env_b[ji].mask) for ji in b_need]
    b_rc, b_outs = _build_phase(bspec, bcols, brow, bc_dev, g)
    pspec = _with_partials(pspec, build_slots, b_outs)
    # probe phase
    pcols = [(env_p[ji].data, env_p[ji].mask) for ji in p_need]
    right = (uspec, bcols, brow, bc_dev) if outer_right else None
    rowcount, p_outs = J.join_probe(pspec, pcols, prow, pc_dev, b_rc, right)
    outs = [rowcount] + [t for out in p_outs for t in out]
    if not fetch:
        # chained handoff: the outputs STAY on the card
        fin = {"node": node, "key_plans": key_plans,
               "agg_plans": agg_plans, "dictionaries": dictionaries,
               "group_space": group_space, "group_mode": group_mode,
               "star_filter": star_filter,
               "distinct_plans": distinct_plans, "stage1_key": cache_key}
        if prof is not None:
            prof.add_device_ns(id(node), clock() - t0)
        tspan("device_dispatch", t0)
        return outs, fin
    results = obs_device.fetch_all(outs)
    out = _finalize(node, key_plans, agg_plans, results, dictionaries,
                    group_space, group_mode, star_filter=star_filter,
                    distinct_plans=distinct_plans)
    if prof is not None:
        prof.add_device_ns(id(node), clock() - t0)
    metrics.DEVICE_DISPATCH_HIST.observe_ns(time.perf_counter_ns() - t0)
    tspan("device_dispatch", t0)
    return out


def _build_phase(bspec, bcols, brow, bc_dev, g: int):
    """The build phase: per-code partials, one `agg_scan` over the build
    codes, with the sentinel slots g and g + 1 zeroed."""
    b_rc, b_outs = K.agg_scan(bspec, bcols, brow, bc_dev, 0,
                              int(brow.shape[0]))
    b_rc[g:] = 0                                 # sentinel slots g, g+1
    for out in b_outs:
        if out[-1].dtype == torch.int64:         # the value counts
            out[-1][g:] = 0
        if len(out) == 2 and out[0].dtype == torch.int64:   # int64 sums
            out[0][g:] = 0
    return b_rc, b_outs


# -- sharded execution tier (serene_shards > 1) -----------------------------
#
# The fused join/aggregate over round-robin probe-block shards
# (exec/shard.py), in one of two combines:
# - host: one `join_probe` launch per shard over that shard's spans, as
#   concurrent worker-pool tasks, then the exact host combine (int64
#   adds, elementwise min/max);
# - device (the reference's shard_map collective): the concatenated
#   surviving spans of every shard split evenly over `data_mesh(S)`'s
#   width M = min(S, devices): one `join_probe` launch at M = 1 (its own
#   accumulation is the psum/pmin/pmax), else one a mesh device combined
#   by `mesh_combine` on the first; the accumulators stay on the device
#   until the one fetch.
# Both run after one build `agg_scan`, whose outputs cache per
# publication pair, so a warm query launches only its probes. Every
# accumulator is an integer add or a min/max selection over disjoint row
# sets, so both combines equal the shards = 1 dispatch bit for bit. The
# build side also publishes PER-SHARD key min/max (the shard-to-shard
# join filter): probe blocks outside every build shard's range never
# upload.

#: per-(build publication, keyset) cache of the published shard ranges,
#: so repeat queries skip the O(n) build-key min/max scans
_SHARD_RANGES_CACHE: OrderedDict[tuple, object] = OrderedDict()
_SHARD_RANGES_MAX = 32
_shard_ranges_lock = threading.Lock()


def _shard_build_ranges(join, build: _Side, n_shards: int,
                        block_rows: int):
    """The build side's per-shard key ranges (exec/shard.ShardedRanges)
    or None when no shard publishes a rangeable key / key eval must
    fall back. Cached per build publication — pure function of it."""
    from . import shard as shard_mod
    keyset = (tuple(_expr_key(k) for k in join.left_keys),
              tuple(_expr_key(k) for k in join.right_keys))
    ck = (build.pub, keyset, n_shards, block_rows)
    with _shard_ranges_lock:
        if ck in _SHARD_RANGES_CACHE:
            _SHARD_RANGES_CACHE.move_to_end(ck)
            return _SHARD_RANGES_CACHE[ck]
    bbatch = build.pin[0] if build.pin is not None \
        else build.provider.full_batch(build.scan.columns)
    bbatch = Batch(list(build.scan.columns),
                   [bbatch.column(c) for c in build.scan.columns])
    try:
        rkeys = [k.eval(bbatch) for k in join.right_keys]
        groups = shard_mod.build_shard_ranges(
            join.left_keys, rkeys,
            build.provider.shard_view(n_shards, block_rows,
                                      bbatch.num_rows))
    except Exception:
        # key eval over unfiltered rows may legitimately raise (the
        # host path evaluates keys only over surviving rows) — then no
        # shard filter, never an error
        groups = None
    with _shard_ranges_lock:
        while len(_SHARD_RANGES_CACHE) >= _SHARD_RANGES_MAX:
            _SHARD_RANGES_CACHE.popitem(last=False)
        _SHARD_RANGES_CACHE[ck] = groups
    return groups


def _sum_i64(arrs) -> np.ndarray:
    out = np.asarray(arrs[0]).astype(np.int64)
    for a in arrs[1:]:
        out = out + np.asarray(a).astype(np.int64)
    return out


def _collective_out_kinds(agg_plans) -> list[str]:
    """Per-output cross-shard combine kinds in `join_probe`'s output
    order: the pair counts, then per aggregate its count / (sum, count)
    / (min or max partial, count)."""
    kinds = ["sum"]                          # pair counts
    for spec, _side, _ce in agg_plans:
        if spec.func == "count_star":
            continue
        if spec.func == "count":
            kinds.append("sum")
        elif spec.func in ("sum", "avg"):
            kinds.extend(["sum", "sum"])     # int64 sum + vcnt
        else:
            kinds.extend([spec.func, "sum"])  # mm partial + vcnt
    return kinds


def _combine_shard_results(agg_plans, shard_outs: list[list]) -> list:
    """Exact cross-shard combine of per-shard `join_probe` outputs into
    the single-dispatch output list _finalize consumes: counts and sums
    add in int64, min/max reduce elementwise. Integer addition over
    disjoint row sets is associative, so the combined accumulators equal
    the shards = 1 dispatch bit for bit."""
    out = []
    for kind, per_shard in zip(_collective_out_kinds(agg_plans),
                               zip(*shard_outs)):
        if kind == "sum":
            out.append(_sum_i64(per_shard))
        else:
            red = np.minimum.reduce if kind == "min" else np.maximum.reduce
            out.append(red([np.asarray(m) for m in per_shard]))
    return out


def _run_fused_sharded(node, join, probe: _Side, build: _Side, pscan,
                       p_names: dict, key_plans, agg_plans,
                       group_space: int, group_mode: bool, dictionaries,
                       cl: np.ndarray, g: int, keyset, device, env_b,
                       b_need, bc_dev, brow, specs_for, shape_sig, ctx,
                       prof, clock, block_rows: int, n_shards: int) -> Batch:
    from . import shard as shard_mod
    from . import zonemap
    from .plan import check_cancel

    settings = ctx.settings
    from ..obs.trace import current_trace
    trace = current_trace()
    tspan = functools.partial(_trace_span, trace)
    p_need = sorted(p_names)
    plo, phi = probe.lo, probe.lo + probe.n_live

    # -- shard-to-shard join filter: per-build-shard key ranges prune
    # probe blocks (and their uploads) before any transfer
    t0 = clock()
    groups = _shard_build_ranges(join, build, n_shards, block_rows)
    v_shard = None
    if groups is not None:
        v_shard = shard_mod.sharded_verdicts(
            probe.provider, settings, groups, pscan.columns, block_rows,
            probe.pin)
    verdicts = zonemap.combine_verdicts(probe.verdicts, v_shard)

    if v_shard is not None:
        # 4 bytes of code tile + 1 mask byte per needed column ride on
        # every uploaded probe row; count what per-shard pruning saved
        nbytes_row = 4 + sum(
            int(probe.host_col(pscan.columns[ji]).data.dtype.itemsize) + 1
            for ji in p_need)
        shard_mod.count_shard_pruned(v_shard, nbytes_row, block_rows,
                                     probe.nrows)
        if zonemap.verify_enabled(settings) and \
                (v_shard == zonemap.SKIP).any():
            full = probe.pin[0] if probe.pin is not None else \
                probe.provider.full_batch(pscan.columns)
            full = Batch(list(pscan.columns),
                         [full.column(c) for c in pscan.columns])
            spans = [(int(b) * block_rows,
                      min((int(b) + 1) * block_rows, probe.nrows))
                     for b in np.flatnonzero(v_shard == zonemap.SKIP)]
            shard_mod.verify_sharded_pruned(
                groups, full, spans,
                f"fused shard filter {probe.provider.name}")

    n_blocks = (probe.nrows + block_rows - 1) // block_rows
    if verdicts is None:
        alive = [b for b in range(n_blocks)
                 if b * block_rows < phi and (b + 1) * block_rows > plo]
    else:
        alive = [int(b) for b in np.flatnonzero(verdicts != zonemap.SKIP)
                 if int(b) * block_rows < phi and
                 int(b) * block_rows >= plo]
    per_shard: dict[int, list[tuple[int, int]]] = {}
    for b in alive:
        s = shard_mod.shard_of_block(b, n_shards)
        per_shard.setdefault(s, []).append(
            (b * block_rows, min((b + 1) * block_rows, probe.nrows)))
    shard_ids = sorted(per_shard)
    pruned = int((v_shard == zonemap.SKIP).sum()) \
        if v_shard is not None else 0
    if not shard_ids:
        # zero pipelines actually ran — the Shards: line still renders
        # the pruning that short-circuited them
        shard_mod.stamp_profile(ctx, id(node), 0, pruned)
        results = _zero_results(agg_plans, group_space)
        return _finalize(node, key_plans, agg_plans, results, dictionaries,
                         group_space, group_mode)

    # -- build phase: ONE launch a query (the first shard to need it),
    # its outputs publication-cached: a warm query skips it ------------
    dev_tag = str(device)
    build_mu = threading.Lock()

    def build_outs(bspec, dev=device):
        if dev != device:
            # a shard on another card: the build outputs copied there,
            # cached per card as the reference pins them per device
            def copy():
                b_rc, b_outs = build_outs(bspec)
                return b_rc.to(dev), tuple(tuple(t.to(dev) for t in o)
                                           for o in b_outs)
            tag = str(dev)
            return DEVICE_CACHE.outputs(
                build.pub, "__bacc__",
                (probe.pub, keyset, (build.zrange, shape_sig), tag), copy,
                sweep=_partner_stale_pred(build.pub, probe.pub, tag,
                                          keyset, name="__bacc__"))

        def launch():
            tb = clock()
            bcols = [(env_b[ji].data, env_b[ji].mask) for ji in b_need]
            check_cancel()
            metrics.DEVICE_OFFLOADS.add()
            b_rc, b_outs = _build_phase(bspec, bcols, brow, bc_dev, g)
            if prof is not None:
                prof.add_device_ns(id(join), clock() - tb)
            metrics.DEVICE_DISPATCH_HIST.observe_ns(
                time.perf_counter_ns() - tb)
            tspan("device_dispatch", tb, phase="build")
            return b_rc, tuple(tuple(o) for o in b_outs)

        with build_mu:
            return DEVICE_CACHE.outputs(
                build.pub, "__bacc__",
                (probe.pub, keyset, (build.zrange, shape_sig), dev_tag),
                launch,
                sweep=_partner_stale_pred(build.pub, probe.pub, dev_tag,
                                          keyset, name="__bacc__"))

    def probe_inputs(spans: list, tag, dev=device) -> tuple:
        """(pspec with the build partials, probe cols, row mask, codes,
        build match counts) over a span set on device `dev`: the probe
        tiles through the publication-keyed cache, the build outputs
        through theirs."""
        env_p = _device_env(probe, p_names, dev, spans)
        side_tag = f"ps{tag}@{dev}"
        pc_dev = DEVICE_CACHE.array(
            probe.pub, "__codes__", (build.pub, keyset, tuple(spans),
                                     side_tag),
            lambda: _code_tiles(
                np.concatenate([cl[a - plo:e - plo] for a, e in spans]),
                g + 1, dev),
            sweep=_partner_stale_pred(probe.pub, build.pub, side_tag,
                                      keyset))
        n_live_s = sum(e - a for a, e in spans)
        prow = DEVICE_CACHE.array(
            probe.pub, "__rowmask__", (tuple(spans), tag, str(dev)),
            lambda: _rowmask_tiles(n_live_s, dev))
        bspec, pspec, _uspec, build_slots = specs_for(env_p)
        b_rc, b_outs = build_outs(bspec, dev)
        pspec = _with_partials(pspec, build_slots, b_outs)
        pcols = [(env_p[ji].data, env_p[ji].mask) for ji in p_need]
        return pspec, pcols, prow, pc_dev, b_rc

    if shard_mod.combine_mode(settings) == "device":
        return _run_fused_collective(
            node, agg_plans, key_plans, group_space, group_mode,
            dictionaries, per_shard, shard_ids, pruned, probe_inputs,
            tspan, ctx, prof, clock, t0, device)

    # shard s's probe on its mesh device (`shard_devices`: logical device
    # s % n), else every shard on the query's device
    placed = mesh_mod.shard_devices(n_shards, base=device)

    def run_shard(s: int) -> list[np.ndarray]:
        check_cancel()
        idx, dev = placed[s] if placed is not None else (None, device)
        scope = on_mesh_device(idx, dev) if idx is not None else \
            device_scope(dev)
        with scope:
            t_up = time.perf_counter_ns()
            pspec, pcols, prow, pc_dev, b_rc = probe_inputs(
                per_shard[s], (n_shards, s), dev)
            metrics.DEVICE_OFFLOADS.add()
            tspan("device_upload", t_up, shard=s)
            t_d = time.perf_counter_ns()
            rowcount, p_outs = J.join_probe(pspec, pcols, prow, pc_dev,
                                            b_rc)
            outs = obs_device.fetch_all(
                [rowcount] + [t for out in p_outs for t in out])
            metrics.DEVICE_DISPATCH_HIST.observe_ns(
                time.perf_counter_ns() - t_d)
            tspan("device_dispatch", t_d, shard=s)
            return outs

    shard_outs = shard_mod.run_shard_tasks(settings, run_shard, shard_ids)
    results = _combine_shard_results(agg_plans, shard_outs)
    shard_mod.stamp_profile(ctx, id(node), len(shard_ids), pruned)
    out = _finalize(node, key_plans, agg_plans, results, dictionaries,
                    group_space, group_mode)
    if prof is not None:
        prof.add_device_ns(id(node), clock() - t0)
    return out


def _run_fused_collective(node, agg_plans, key_plans, group_space: int,
                          group_mode: bool, dictionaries, per_shard: dict,
                          shard_ids: list, pruned: int, probe_inputs,
                          tspan, ctx, prof, clock, t0, device) -> Batch:
    """The device combine over the surviving shard spans, concatenated in
    ascending shard, then ascending span order. The reference splits that
    row set evenly over its mesh axis (width min(S, devices)) and psums
    the slices' accumulators: at width 1 that is one `join_probe` launch
    over the whole set; at width M, one launch a mesh device over its
    slice of the tiles, the accumulators combined on the first device by
    `_collective_out_kinds` through `mesh_combine` (sums fused). Integer
    adds and min/max selections are exact over any row partition, so
    every width gives the same accumulators."""
    from ..obs.resources import wait_scope
    from . import shard as shard_mod
    from .plan import check_cancel

    S = len(shard_ids)
    mesh = mesh_mod.data_mesh(S, base=device)
    M = mesh.size
    all_spans = [sp for s in shard_ids for sp in per_shard[s]]
    pspec, pcols, prow, pc_dev, b_rc = probe_inputs(
        all_spans, ("coll", tuple(shard_ids), M))
    if prof is not None:
        prof.add_device_ns(id(node), clock() - t0)
    tspan("device_upload", t0, shards=S)

    check_cancel()
    t_d = time.perf_counter_ns()
    metrics.DEVICE_OFFLOADS.add()
    metrics.COLLECTIVE_DISPATCHES.add()
    # the shard workloads still execute — as row slices of the launches
    metrics.SHARD_PIPELINES.add(S)
    with wait_scope("Device", "CollectiveCombine"):
        if M == 1:
            rowcount, p_outs = J.join_probe(pspec, pcols, prow, pc_dev,
                                            b_rc)
            results = obs_device.fetch_all(
                [rowcount] + [t for out in p_outs for t in out])
        else:
            tiles = prow.shape[0]
            sizes = [len(c) for c in np.array_split(np.arange(tiles),
                                                    min(M, tiles))]
            shard_outs, a = [], 0
            for j, n in enumerate(sizes):
                b, dev = a + n, mesh.devices[j]
                with mesh.shard(j):
                    rowcount, p_outs = J.join_probe(
                        _spec_on(pspec, dev),
                        [(d[a:b].to(dev), m[a:b].to(dev))
                         for d, m in pcols],
                        prow[a:b].to(dev), pc_dev[a:b].to(dev),
                        b_rc.to(dev))
                shard_outs.append([rowcount] +
                                  [t for out in p_outs for t in out])
                a = b
            results = obs_device.fetch_all(mesh_mod.apply_axis_combines(
                shard_outs, _collective_out_kinds(agg_plans), mesh.first,
                fuse_sums=True))
    dt_ns = time.perf_counter_ns() - t_d
    metrics.COLLECTIVE_COMBINE_NS.add(dt_ns)
    metrics.DEVICE_DISPATCH_HIST.observe_ns(dt_ns)
    tspan("collective_dispatch", t_d, shards=S, mesh=M)
    shard_mod.stamp_profile(ctx, id(node), S, pruned, collective=True)
    out = _finalize(node, key_plans, agg_plans, results, dictionaries,
                    group_space, group_mode)
    if prof is not None:
        prof.add_device_ns(id(node), time.perf_counter_ns() - t_d)
    return out


def _spec_on(pspec: J.ProbeSpec, dev) -> J.ProbeSpec:
    """The probe spec with its build partials on `dev` (a mesh slice on
    another card)."""
    aggs = [J.ProbeAgg(a.kind, a.ops,
                       tuple(None if t is None else t.to(dev)
                             for t in a.src), a.ub_ops)
            for a in pspec.aggs]
    return J.ProbeSpec(pspec.col_kinds, pspec.col_offsets, pspec.G,
                       pspec.g, pspec.outer_left, pspec.preds, pspec.keys,
                       aggs)


def _launch_specs(agg_plans, agg_filters, star_filter, distinct_plans,
                  key_plans, preds_probe, preds_build, slot_p, slot_b,
                  dec_p, dec_b, g, group_space, group_mode, outer_left,
                  outer_right):
    """The build phase's agg_scan spec, the probe phase's join_probe spec
    (its build-side entries still without their partials) and the
    unmatched-build spec. Returns them with `build_slots`: per probe
    entry that gathers build partials, (entry index, build agg index)."""
    b_aggs: list = []
    p_aggs: list = []
    build_slots: list = []
    for si, (spec, side, ce) in enumerate(agg_plans):
        fe = agg_filters.get(si)
        if spec.func == "count_star":
            if si not in star_filter:
                continue                     # shared output-row counts
            if side == 0:
                p_aggs.append(J.ProbeAgg(J.JP_COUNT,
                                         _gated(None, fe, slot_p)))
            else:
                build_slots.append((len(p_aggs), len(b_aggs)))
                b_aggs.append(K.ScanAgg(K.AGG_COUNT,
                                        _gated(None, fe, slot_b)))
                p_aggs.append(J.ProbeAgg(
                    J.JB_COUNT, ub_ops=_gated(None, fe, slot_b)))
            continue
        if si in distinct_plans:
            dkind, ji, lo_v, vspace = distinct_plans[si]
            col = DeviceExpr(((K.OP_COL, 0, 0),), [ji], "i")
            p_aggs.append(J.ProbeAgg(
                J.JP_PRESENCE, _gated(col, fe, slot_p),
                pkind=K.KEY_DICT if dkind == "dict" else K.KEY_INT,
                plo=lo_v, pvsize=vspace))
            continue
        func = "sum" if spec.func == "avg" else spec.func
        if side == 0:
            kind = {"count": J.JP_COUNT, "sum": J.JP_SUM, "min": J.JP_MIN,
                    "max": J.JP_MAX}[func]
            p_aggs.append(J.ProbeAgg(kind, _gated(ce, fe, slot_p)))
        else:
            bkind = {"count": K.AGG_COUNT, "sum": K.AGG_SUM_I,
                     "min": K.AGG_MIN_I, "max": K.AGG_MAX_I}[func]
            kind = {"count": J.JB_COUNT, "sum": J.JB_SUM, "min": J.JB_MIN,
                    "max": J.JB_MAX}[func]
            build_slots.append((len(p_aggs), len(b_aggs)))
            b_aggs.append(K.ScanAgg(bkind, _gated(ce, fe, slot_b)))
            p_aggs.append(J.ProbeAgg(kind, ub_ops=_gated(ce, fe, slot_b)))
    keys = [(K.KEY_DICT if kind == "dict" else K.KEY_INT, slot_p[ji], lo,
             size) for kind, ji, lo, size in key_plans]
    bspec = K.ScanSpec([k for k, _ in dec_b], [o for _, o in dec_b],
                       [pred_program(ce, slot_b) for ce in preds_build],
                       [], True, g + 2, b_aggs)
    pspec = J.ProbeSpec([k for k, _ in dec_p], [o for _, o in dec_p],
                        group_space, g, outer_left,
                        [pred_program(ce, slot_p) for ce in preds_probe],
                        keys, p_aggs)
    uspec = J.UnmatchedSpec(list(bspec.col_kinds), list(bspec.col_offsets),
                            group_space - 1 if group_mode else 0,
                            list(bspec.preds)) if outer_right else None
    for s in (bspec, pspec):
        ops = sum(map(len, s.preds)) + sum(len(a.ops or ()) for a in s.aggs)
        if len(s.preds) > K.MAX_PREDS or len(s.aggs) > K.MAX_AGGS or \
                len(s.keys) > K.MAX_KEYS or ops > K.MAX_OPS:
            raise NotCompilable("query exceeds the device scan's "
                                "descriptor", "device_descriptor")
    return bspec, pspec, uspec, build_slots


def _with_partials(pspec: J.ProbeSpec, build_slots, b_outs) -> J.ProbeSpec:
    """The probe spec with each build-side entry's per-code partials:
    (value, count) from the build phase's outputs."""
    aggs = list(pspec.aggs)
    for pi, bi in build_slots:
        out = b_outs[bi]
        src = (None, out[0]) if len(out) == 1 else (out[0], out[1])
        a = aggs[pi]
        aggs[pi] = J.ProbeAgg(a.kind, a.ops, src, a.ub_ops)
    return J.ProbeSpec(pspec.col_kinds, pspec.col_offsets, pspec.G,
                       pspec.g, pspec.outer_left, pspec.preds, pspec.keys,
                       aggs)


def _partner_stale_pred(owner_pub, partner_pub, side_tag, keyset,
                        name="__codes__"):
    """Sweep predicate for code tiles pinned to an older generation of
    the PARTNER table (whose publication the owner-side generation sweep
    cannot see): their tag embeds the partner publication at position
    0."""
    def pred(k):
        return (k[0][0] == owner_pub[0] and k[1] == name and
                isinstance(k[3], tuple) and len(k[3]) >= 4 and
                k[3][3] == side_tag and k[3][1] == keyset and
                isinstance(k[3][0], tuple) and
                k[3][0][0] == partner_pub[0] and k[3][0] != partner_pub)
    return pred


def _mm_ident(func: str) -> int:
    info = np.iinfo(np.int32)
    return info.max if func == "min" else info.min


def _code_tiles(codes: np.ndarray, sentinel: int, device) -> torch.Tensor:
    """Factorized join codes → int32 device tiles; padding rows take the
    side's never-matches sentinel."""
    n = len(codes)
    padded = np.full(pad_len(n), sentinel, dtype=np.int32)
    padded[:n] = codes
    return commit_host_array(padded.reshape(-1, LANES), device)


def _join_codes(join, probe: _Side, build: _Side
                ) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Key-code factorization over BOTH sides (one shared dense int64
    code space), with NULL-key rows already rewritten to the per-side
    sentinel (g for build, g+1 for probe) so NULL never matches, plus the
    worst-case matched-pair count for the admission wall (computed over
    the UNSLICED sides). Cached per publication pair."""
    from .morsel import combined_codes, rows_valid
    keyset = (tuple(_expr_key(k) for k in join.left_keys),
              tuple(_expr_key(k) for k in join.right_keys))
    ck = (probe.pub, build.pub, keyset)
    with _codes_lock:
        hit = _CODES_CACHE.get(ck)
        if hit is not None:
            _CODES_CACHE.move_to_end(ck)
            return hit
    pbatch = probe.pin[0] if probe.pin is not None \
        else probe.provider.full_batch(probe.scan.columns)
    bbatch = build.pin[0] if build.pin is not None \
        else build.provider.full_batch(build.scan.columns)
    pbatch = Batch(list(probe.scan.columns),
                   [pbatch.column(c) for c in probe.scan.columns])
    bbatch = Batch(list(build.scan.columns),
                   [bbatch.column(c) for c in build.scan.columns])
    try:
        lkeys = [k.eval(pbatch) for k in join.left_keys]
        rkeys = [k.eval(bbatch) for k in join.right_keys]
    except Exception as e:
        # the host path evaluates keys only over filter-surviving rows;
        # an eval error on a filtered-out row must fall back, not surface
        raise NotCompilable(f"key eval over unfiltered rows: {e}")
    pair = combined_codes(lkeys, rkeys)
    if pair is None:
        raise NotCompilable("join keys have no shared code representation")
    cl, cr, g = pair
    lvalid = rows_valid(lkeys)
    rvalid = rows_valid(rkeys)
    cl = cl.astype(np.int64)
    cr = cr.astype(np.int64)
    if lvalid is not None:
        cl = np.where(lvalid, cl, g + 1)
    if rvalid is not None:
        cr = np.where(rvalid, cr, g)
    total_pairs = 0
    if len(cl) and len(cr) and g:
        bc_counts = np.bincount(cr[cr < g], minlength=g)
        pl = cl[cl < g]
        total_pairs = int(bc_counts[pl].sum()) if len(pl) else 0
    value = (cl, cr, g, total_pairs)
    nbytes = int(cl.nbytes) + int(cr.nbytes)
    global _codes_bytes
    with _codes_lock:
        # superseded generations of the same (table pair, keyset) are
        # unreachable — publications are monotone — sweep them first
        stale = [k for k in _CODES_CACHE
                 if k[2] == keyset and k[0][0] == ck[0][0] and
                 k[1][0] == ck[1][0] and k != ck]
        for k in stale:
            old = _CODES_CACHE.pop(k)
            _codes_bytes -= int(old[0].nbytes) + int(old[1].nbytes)
        while _CODES_CACHE and (
                len(_CODES_CACHE) >= _CODES_CACHE_MAX or
                _codes_bytes + nbytes > _CODES_CACHE_MAX_BYTES):
            _, old = _CODES_CACHE.popitem(last=False)
            _codes_bytes -= int(old[0].nbytes) + int(old[1].nbytes)
        _CODES_CACHE[ck] = value
        _codes_bytes += nbytes
    return value


def _plan_group_keys(node, join_types, probe: _Side, pscan, dictionaries
                     ) -> tuple[list, int]:
    """Direct coding of the probe-side group keys: dictionary codes for
    strings, offset small-range coding for ints; the NULL group takes
    slot size-1, matching factorize_keys' (values asc, NULL last)
    composite order so the host oracle's group order is reproduced."""
    key_plans = []
    group_space = 1
    for gx in node.group_exprs:
        t = join_types[gx.index]
        if t.is_string:
            d = dictionaries.get(gx.index)
            if d is None:
                raise NotCompilable("string group key without dictionary")
            size = len(d) + 1
            key_plans.append(("dict", gx.index, 0, size))
        elif t.is_integer or t.id in (dt.TypeId.BOOL, dt.TypeId.DATE):
            col = probe.host_col(pscan.columns[gx.index])
            if col.data.size == 0:
                lo, hi = 0, 0
            else:
                lo, hi = int(col.data.min()), int(col.data.max())
            rng = hi - lo + 1
            if rng > MAX_INT_KEY_RANGE:
                raise NotCompilable("group key range too large")
            if not (-2**31 <= lo and hi < 2**31):
                raise NotCompilable("group key offset beyond int32")
            size = rng + 1
            key_plans.append(("int", gx.index, lo, size))
        else:
            raise NotCompilable(f"group key type {t}")
        group_space *= size
        if group_space > MAX_GROUP_PRODUCT:
            raise NotCompilable("group code space too large")
    return key_plans, group_space


def _zero_results(agg_plans, group_space: int, star_filter=None,
                  distinct_plans=None) -> list:
    """Host-side zero accumulators matching the outputs' layout — the
    no-surviving-rows short-circuit never launches."""
    star_filter = star_filter or {}
    distinct_plans = distinct_plans or {}
    z = lambda: np.zeros(group_space, dtype=np.int64)  # noqa: E731
    out = [z()]
    for si, (spec, side, ce) in enumerate(agg_plans):
        if spec.func == "count_star":
            if si in star_filter:
                out.append(z())
            continue
        if si in distinct_plans:
            vspace = distinct_plans[si][3]
            out.append(np.zeros(group_space * vspace, dtype=np.int32))
            continue
        if spec.func == "count":
            out.append(z())
        elif spec.func in ("sum", "avg"):
            out.extend([z(), z()])
        else:
            out.append(np.full(group_space, _mm_ident(spec.func),
                               dtype=np.int32))
            out.append(z())
    return out


def _finalize(node, key_plans, agg_plans, results, dictionaries,
              group_space: int, group_mode: bool, star_filter=None,
              distinct_plans=None, slots=None) -> Batch:
    """Device outputs → result batch, bit-matching the host oracle:
    groups emit in ascending composite-code order (= factorize_keys
    order), empty groups / scalar aggregates go NULL exactly where the
    oracle's do.

    `slots=(codes, row_lo, row_hi)` is the chained-top-N entry: results
    arrive pre-gathered to the selected group rows, `codes` holds those
    rows' composite group codes, and only rows [row_lo, row_hi) emit
    (host-side OFFSET/LIMIT slice)."""
    star_filter = star_filter or {}
    distinct_plans = distinct_plans or {}
    ri = iter(results)
    pair_counts = np.asarray(next(ri)).astype(np.int64)
    if slots is not None:
        slot_codes, row_lo, row_hi = slots
        present = np.arange(row_lo, row_hi)
    elif group_mode:
        present = np.flatnonzero(pair_counts > 0)
    else:
        present = np.asarray([0])
    cols: list[Column] = []
    if group_mode:
        sizes = [kp[3] for kp in key_plans]
        rem = slot_codes[row_lo:row_hi].copy() if slots is not None \
            else present.copy()
        key_codes = []
        for size in reversed(sizes):
            key_codes.append(rem % size)
            rem //= size
        key_codes.reverse()
        for pos, ((kind, ji, lo, size), kc) in \
                enumerate(zip(key_plans, key_codes)):
            null_mask = kc == (size - 1)
            t = node.group_exprs[pos].type
            if kind == "dict":
                d = dictionaries[ji]
                data = np.where(null_mask, 0, kc).astype(np.int32)
                cols.append(Column(
                    t, data, ~null_mask if null_mask.any() else None, d))
            else:
                data = (kc + lo).astype(t.np_dtype)
                data = np.where(null_mask, 0, data).astype(t.np_dtype)
                cols.append(Column(
                    t, data, ~null_mask if null_mask.any() else None))
    for si, (spec, side, ce) in enumerate(agg_plans):
        if si in distinct_plans:
            cols.append(_distinct_result_col(
                spec, np.asarray(next(ri)), distinct_plans[si],
                group_space, group_mode, present))
            continue
        if spec.func == "count_star" and si in star_filter:
            c = np.asarray(next(ri)).astype(np.int64)
            if group_mode:
                cols.append(Column(dt.BIGINT, c[present]))
            else:
                cols.append(Column.from_pylist([int(c[0])], spec.type))
            continue
        cols.append(_agg_result_col(spec, ri, pair_counts, present,
                                    group_mode, dictionaries))
    return Batch(list(node.names), cols)


def _distinct_result_col(spec: AggSpec, grid: np.ndarray, dplan,
                         group_space: int, group_mode: bool,
                         present) -> Column:
    """Presence grid → count/sum/avg DISTINCT, exactly: a cell is
    present iff ≥ 1 surviving (group, value) occurrence marked it."""
    _dkind, _ji, lo_v, vspace = dplan
    if grid.ndim == 1:
        grid = grid.reshape(group_space, vspace)
    pres = grid[present] > 0                   # (rows, vspace)
    cnt = pres.sum(axis=1).astype(np.int64)
    if spec.func == "count":
        if group_mode:
            return Column(dt.BIGINT, cnt)
        return Column.from_pylist([int(cnt[0])], spec.type)
    vals = (np.int64(lo_v) + np.arange(vspace, dtype=np.int64))
    sums = (pres * vals).sum(axis=1)
    t = spec.type
    if group_mode:
        empty = cnt == 0
        if spec.func == "avg":
            with np.errstate(invalid="ignore", divide="ignore"):
                data = np.where(empty, 0.0, sums / np.maximum(cnt, 1))
            return Column(dt.DOUBLE, data, ~empty if empty.any() else None)
        if t.is_integer:
            return Column(dt.BIGINT, sums,
                          ~empty if empty.any() else None)
        return Column(dt.DOUBLE, sums.astype(np.float64),
                      ~empty if empty.any() else None)
    s, n = int(sums[0]), int(cnt[0])
    if n == 0:
        return Column.from_pylist([None], t)
    if spec.func == "avg":
        return Column.from_pylist([s / n], t)
    return Column.from_pylist([s if t.is_integer else float(s)], t)


def _agg_result_col(spec: AggSpec, ri, pair_counts, present,
                    group_mode: bool, dictionaries=None) -> Column:
    t = spec.type
    if spec.func == "count_star":
        if group_mode:
            return Column(dt.BIGINT, pair_counts[present])
        return Column.from_pylist([int(pair_counts[0])], t)
    if spec.func == "count":
        c = np.asarray(next(ri)).astype(np.int64)
        if group_mode:
            return Column(dt.BIGINT, c[present])
        return Column.from_pylist([int(c[0])], t)
    if spec.func in ("sum", "avg"):
        sums = np.asarray(next(ri)).astype(np.int64)
        cnt = np.asarray(next(ri)).astype(np.int64)
        if group_mode:
            sums, cnt = sums[present], cnt[present]
            empty = cnt == 0
            if spec.func == "avg":
                with np.errstate(invalid="ignore", divide="ignore"):
                    data = np.where(empty, 0.0, sums / np.maximum(cnt, 1))
                return Column(dt.DOUBLE, data,
                              ~empty if empty.any() else None)
            if t.is_integer:
                return Column(dt.BIGINT, sums,
                              ~empty if empty.any() else None)
            return Column(dt.DOUBLE, sums.astype(np.float64),
                          ~empty if empty.any() else None)
        s, n = int(sums[0]), int(cnt[0])
        if n == 0:
            return Column.from_pylist([None], t)
        if spec.func == "avg":
            return Column.from_pylist([s / n], t)
        return Column.from_pylist([s if t.is_integer else float(s)], t)
    if spec.func in ("min", "max"):
        v = np.asarray(next(ri)).astype(np.int64)
        cnt = np.asarray(next(ri)).astype(np.int64)
        at = spec.arg.type
        if at.is_string:
            # min/max ran over sorted-dictionary codes (code order ==
            # string order); decode back through the dictionary
            d = (dictionaries or {}).get(spec.arg.index)
            if group_mode:
                v, cnt = v[present], cnt[present]
                empty = cnt == 0
                codes = np.where(empty, 0, v).astype(np.int32)
                return Column(at, codes,
                              ~empty if empty.any() else None, d)
            if int(cnt[0]) == 0:
                return Column.from_pylist([None], t)
            return Column.from_pylist([str(d[int(v[0])])], t)
        if group_mode:
            v, cnt = v[present], cnt[present]
            empty = cnt == 0
            data = np.where(empty, 0, v).astype(at.np_dtype)
            return Column(at, data, ~empty if empty.any() else None)
        if int(cnt[0]) == 0:
            return Column.from_pylist([None], t)
        out = int(v[0])
        if at.id is dt.TypeId.BOOL:
            out = bool(out)
        return Column.from_pylist([out], t)
    raise NotCompilable(spec.func)


# -- fused filtered top-N ----------------------------------------------------


def _col_stats(side: _Side, name: str) -> tuple:
    """(all_valid, finite_all, lo, hi) of one column — a pure function
    of the publication, so cached repeats skip the O(n) host scans.
    lo/hi are None for float columns (only finiteness gates those) and
    span EVERY slot including NULL ones."""
    ck = (side.pub, name)
    with _col_stats_lock:
        hit = _COL_STATS_CACHE.get(ck)
        if hit is not None:
            _COL_STATS_CACHE.move_to_end(ck)
            return hit
    host = side.host_col(name)
    all_valid = bool(host.valid_mask().all())
    if host.data.dtype.kind == "f":
        stats = (all_valid, bool(np.isfinite(host.data).all()), None, None)
    elif host.data.size == 0:
        stats = (all_valid, True, 0, 0)
    else:
        stats = (all_valid, True,
                 int(host.data.min()), int(host.data.max()))
    with _col_stats_lock:
        while len(_COL_STATS_CACHE) >= _COL_STATS_MAX:
            _COL_STATS_CACHE.popitem(last=False)
        _COL_STATS_CACHE[ck] = stats
    return stats


def try_device_fused_topn(limit_node, ctx) -> Optional[Batch]:
    """ORDER BY col LIMIT k over a FILTERED scan as one `topn_scan`
    launch: the compiled predicates mask filtered-out rows to the sort
    sentinel before the selection (device_topn covers only the
    unfiltered shape). None → CPU lexsort oracle."""
    from .plan import ProjectNode, SortNode
    from .device_topn import MAX_TOPN_K

    settings = ctx.settings
    if settings.get("serene_device") == "cpu" or not fused_enabled(settings):
        return None
    if limit_node.limit is None:
        return None

    def decline(reason: str) -> None:
        _note_decline(reason, ctx, limit_node)
        return None

    k = limit_node.limit + limit_node.offset
    if k == 0:
        return None
    if k > MAX_TOPN_K:
        return decline("topn_k")
    sort = limit_node.child
    if not isinstance(sort, SortNode) or len(sort.key_indices) != 1 or \
            sort.nulls_first[0] is not None:
        return None
    proj = None
    inner = sort.child
    if isinstance(inner, ProjectNode):
        proj = inner
        inner = inner.child
    side = _unwrap_side(inner)
    if side is None or not side[1]:
        return None       # unfiltered shape: device_topn's territory
    scan, preds = side
    ki = sort.key_indices[0]
    if proj is not None:
        # plain column projections only: the host oracle evaluates the
        # Project over EVERY filter-surviving row, the fused path over
        # only the k selected ones — a computed expression that raises
        # or draws state would diverge
        if not all(isinstance(e, BoundColumn) for e in proj.exprs):
            return decline("topn_project")
        ki = proj.exprs[ki].index
    t = scan.types[ki]
    if not (t.is_integer or t.id in (dt.TypeId.DATE, dt.TypeId.FLOAT)):
        return decline("topn_key_type")
    provider = scan.provider
    if settings.get("serene_device") == "auto":
        try:
            if provider.row_count() < settings.get("serene_device_min_rows"):
                return None
        except NotImplementedError:
            return None
    desc = bool(sort.descs[0])
    try:
        prof = getattr(ctx, "profile", None)
        from ..obs.trace import current_trace
        trace = current_trace()
        t0 = time.perf_counter_ns()
        out = _run_fused_topn(limit_node, scan, preds, ki, desc, k, ctx,
                              proj)
        if prof is not None:
            prof.add_device_ns(id(limit_node),
                               time.perf_counter_ns() - t0)
        if out is not None:
            metrics.DEVICE_DISPATCH_HIST.observe_ns(
                time.perf_counter_ns() - t0)
            if trace is not None:
                trace.add("device_dispatch", "device", t0,
                          time.perf_counter_ns(), op="topn")
        return out
    except (NotCompilable, DeviceNarrowingError) as e:
        log.debug("device", f"fused top-N fell back to CPU: {e}")
        return decline(getattr(e, "reason", "not_compilable"))


def _run_fused_topn(limit_node, scan, preds, ki: int, desc: bool, k: int,
                    ctx, proj=None) -> Optional[Batch]:
    from .device_topn import _I32_MIN, _I32_MAX
    from .plan import check_cancel

    side = _Side(scan, preds, ctx)
    if side.nrows == 0 or side.n_live == 0:
        from .plan import empty_batch
        if proj is not None:
            return empty_batch(list(proj.names),
                               [e.type for e in proj.exprs])
        return empty_batch(list(scan.names), list(scan.types))
    name = scan.columns[ki]
    all_valid, finite_all, lo_v, hi_v = _col_stats(side, name)
    if not all_valid:
        raise NotCompilable("top-N key column has NULLs")
    if lo_v is None:                         # float key
        if not finite_all:
            raise NotCompilable("top-N float key has NaN/inf")
    else:
        if desc and lo_v <= _I32_MIN:
            raise NotCompilable("key touches int32 min")
        if not desc and hi_v >= _I32_MAX:
            raise NotCompilable("key touches int32 max")

    dicts = {}
    for e in preds:
        for sub in e.walk():
            if isinstance(sub, BoundColumn) and sub.type.is_string and \
                    sub.index not in dicts:
                col = side.host_col(scan.columns[sub.index])
                if col.dictionary is not None:
                    dicts[sub.index] = col.dictionary
    compiled = [compile_expr(p, scan.types, dicts) for p in preds]

    needed = sorted({ki} | {i for ce in compiled for i in ce.inputs})
    if len(needed) > K.MAX_COLS:
        raise NotCompilable(f"{len(needed)} input columns (device limit "
                            f"{K.MAX_COLS})", "device_cols")
    device = _ctx_device(ctx)
    env_cols = _device_env(side, {i: (scan.columns[i], scan.types[i])
                                  for i in needed}, device)
    rowmask = DEVICE_CACHE.array(side.pub, "__rowmask__",
                                 (side.zrange, str(device)),
                                 lambda: _rowmask_tiles(side.n_live, device))
    kc = env_cols[ki]
    if kc.data.numel() < k:
        raise NotCompilable("k exceeds padded rows")
    slot_of = {i: s for s, i in enumerate(needed)}
    decode = [K.col_kind(env_cols[i]) for i in needed]
    cache_key = ("fusedtopn", side.pub, side.zrange, name, desc, k,
                 tuple(_expr_key(p) for p in preds))

    def build() -> TK.TopnSpec:
        spec = TK.TopnSpec([kd for kd, _ in decode], [o for _, o in decode],
                           slot_of[ki], desc,
                           kc.data.dtype == torch.float32,
                           [pred_program(ce, slot_of) for ce in compiled])
        if len(spec.preds) > K.MAX_PREDS or \
                sum(map(len, spec.preds)) > K.MAX_OPS:
            raise NotCompilable("query exceeds the device scan's "
                                "descriptor", "device_descriptor")
        return spec

    spec = obs_device.compiled("fused_topn", cache_key, build,
                               profile=getattr(ctx, "profile", None),
                               node_key=id(limit_node))
    cols = [(env_cols[i].data, env_cols[i].mask) for i in needed]
    check_cancel()
    metrics.DEVICE_OFFLOADS.add()
    ii, nsurv = obs_device.fetch_all(TK.topn_scan(spec, cols, rowmask, k))
    idx = ii.astype(np.int64)
    k_eff = min(k, int(nsurv[0]))
    idx = idx[:k_eff]
    if side.zrange is not None:
        idx = idx + side.zrange[0]
    idx = idx[limit_node.offset:]
    if side.pin is not None and all(c in side.pin[0] for c in scan.columns):
        base = Batch(list(scan.columns),
                     [side.pin[0].column(c) for c in scan.columns])
    else:
        base = side.provider.full_batch(scan.columns)
    base = base.take(idx)
    if proj is None:
        return base
    return Batch(list(proj.names), [e.eval(base) for e in proj.exprs])


# -- chained device-resident stages: fused agg → fused top-N -----------------


def _stage1_out_slots(agg_plans, star_filter, distinct_plans
                      ) -> dict[int, int]:
    """agg index → its FIRST slot in the stage-1 outputs (mirrors the
    probe phase's output ordering exactly)."""
    slots: dict[int, int] = {}
    pos = 1
    for si, (spec, _side, _ce) in enumerate(agg_plans):
        if spec.func == "count_star":
            if si in star_filter:
                slots[si] = pos
                pos += 1
            continue
        slots[si] = pos
        if si in distinct_plans or spec.func == "count":
            pos += 1
        else:
            pos += 2                      # sum/avg and min/max: 2 slots
    return slots


def try_device_chained_topn(limit_node, ctx) -> Optional[Batch]:
    """Whole-query device residency: Limit(Sort(Project?(Aggregate)))
    over a fused-admissible join runs the fused pipeline with its outputs
    left on the card, then `chain_topn` masks absent groups to the sort
    sentinel, selects the k requested group slots (lowest slot first on
    ties) and gathers every output down to those rows; the host fetches
    only those. Sort keys are group-key columns (composite-code order ==
    value order: sorted dictionaries / offset ints, NULL slot last ⇒ PG's
    default asc NULLS LAST / desc NULLS FIRST exactly) or count-family
    aggregates; min/max/sum keys decline. None → host path."""
    from .plan import AggregateNode, ProjectNode, SortNode, check_cancel

    settings = ctx.settings
    if settings.get("serene_device") == "cpu" or \
            not fused_enabled(settings) or \
            not fused_ext_enabled(settings):
        return None
    if limit_node.limit is None or limit_node.limit == 0:
        return None
    k = limit_node.limit + limit_node.offset
    sort = limit_node.child
    if not isinstance(sort, SortNode) or len(sort.key_indices) != 1 or \
            sort.nulls_first[0] is not None:
        return None
    proj = None
    agg = sort.child
    if isinstance(proj_c := agg, ProjectNode):
        proj = proj_c
        agg = proj_c.child
    if not isinstance(agg, AggregateNode):
        return None
    if proj is not None and not all(isinstance(e, BoundColumn)
                                    for e in proj.exprs):
        return None
    if not agg.group_exprs:
        return None               # scalar aggregate: one row, host-trivial

    def decline(reason: str) -> None:
        _note_decline(reason, ctx, limit_node)
        return None

    sel = sort.key_indices[0]
    if proj is not None:
        sel = proj.exprs[sel].index
    ng = len(agg.group_exprs)
    if sel >= ng:
        spec = agg.aggs[sel - ng]
        if spec.func not in ("count_star", "count") or spec.distinct:
            return decline("chain_sort_key")
    admitted = _admit_pipeline(agg, ctx, decline)
    if admitted is None:
        return None
    join, probe_side, build_side, post_preds = admitted
    try:
        res = _run_fused(agg, join, probe_side, build_side, post_preds,
                         ctx, fetch=False)
    except (NotCompilable, DeviceNarrowingError) as e:
        log.debug("device", f"chained fused top-N fell back to CPU: {e}")
        return decline(getattr(e, "reason", "not_compilable"))
    if isinstance(res, Batch):
        return None               # empty short-circuit: host path, cheap
    outs, fin = res
    desc = bool(sort.descs[0])
    group_space = fin["group_space"]
    key_plans = fin["key_plans"]
    agg_plans = fin["agg_plans"]
    star_filter = fin["star_filter"]
    distinct_plans = fin["distinct_plans"]
    k_pad = min(_pow2_int(k, floor=8), group_space)

    src = None
    stride, size = 1, 1
    if sel >= ng:
        si = sel - ng
        if not (agg_plans[si][0].func == "count_star" and
                si not in star_filter):
            src = outs[_stage1_out_slots(agg_plans, star_filter,
                                         distinct_plans)[si]]
        else:
            src = outs[0]                 # shared output-row counts
    else:
        sizes = [kp[3] for kp in key_plans]
        for s2 in sizes[sel + 1:]:
            stride *= s2
        size = sizes[sel]

    prof = getattr(ctx, "profile", None)
    check_cancel()
    t0 = time.perf_counter_ns()
    metrics.DEVICE_OFFLOADS.add()
    metrics.REGISTRY.gauge(
        "DeviceChainedStages",
        "Fused agg→top-N chains executed with the intermediate "
        "accumulators handed off on the card").add()
    ii, npres, picked = TK.chain_topn(outs[0], src, stride, size, desc,
                                      k_pad, outs)
    fetched = obs_device.fetch_all([ii, npres, *picked])
    ii_np = np.asarray(fetched[0]).astype(np.int64)
    k_eff = min(k, int(fetched[1][0]))
    row_lo = min(limit_node.offset, k_eff)
    out = _finalize(agg, key_plans, agg_plans, list(fetched[2:]),
                    fin["dictionaries"], group_space, True,
                    star_filter=star_filter, distinct_plans=distinct_plans,
                    slots=(ii_np, row_lo, k_eff))
    if proj is not None:
        out = Batch(list(proj.names),
                    [out.columns[e.index] for e in proj.exprs])
    if prof is not None:
        prof.add_device_ns(id(limit_node), time.perf_counter_ns() - t0)
    metrics.DEVICE_DISPATCH_HIST.observe_ns(time.perf_counter_ns() - t0)
    return out
