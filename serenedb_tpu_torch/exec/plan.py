"""Copied from serenedb_tpu/exec/plan.py (ExecContext carries a device).

Physical plan nodes and their (streaming, batch-at-a-time) execution.

Reference analog: DuckDB physical operators driven by morsel pipelines
(SURVEY.md §3.2 hot loop). Here nodes pull iterators of column batches;
Scan→Filter→Aggregate chains are intercepted by the device offload
(exec/device_agg.py) when compilable — the TPU analog of the reference's
parallel pipeline sink.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column, concat_batches, merge_dictionaries
from ..sql.expr import AggSpec, BoundColumn, BoundExpr
from ..utils.config import SessionSettings
from .tables import TableProvider


@dataclass
class ExecContext:
    settings: SessionSettings = field(default_factory=SessionSettings)
    params: list = field(default_factory=list)
    #: sideways information passing (JoinNode → probe-side ScanNode):
    #: id(scan node) → synthetic build-key-range conjuncts. Keyed on the
    #: EXECUTION context, never on plan nodes — cached plans execute
    #: concurrently and must not see each other's filters.
    join_filters: dict = field(default_factory=dict)
    #: per-query span collector (obs/trace.QueryProfile) or None.
    #: Observation only: executors stamp rows/time/prune counters into
    #: it but never read it back, so a profile can't perturb results.
    profile: object = None
    #: per-query memory accountant (obs/resources.MemoryAccountant) or
    #: None. Same observe-only contract as `profile`: executors charge
    #: live/peak bytes and progress counters into it but never read it
    #: back, so accounting can't perturb results.
    mem: object = None
    #: the database's torch device (engine.Database.device); the device
    #: tier places its tiles and launches its kernels there. None in
    #: contexts built without a database (binder subqueries): the device
    #: tier then takes the current connection's
    device: object = None


def empty_batch(names: list[str], types: list[dt.SqlType]) -> Batch:
    cols = [Column(t, np.empty(0, dtype=t.np_dtype), None,
                   np.empty(0, dtype=object) if t.is_string else None)
            for t in types]
    return Batch(list(names), cols)


def _profiled_batches(fn):
    """Wrap one node class's raw batch generator with the span collector
    and/or the memory accountant. With neither on the context this is
    two attribute checks that return the raw generator — zero extra
    frames during iteration, so `serene_profile = off` +
    `serene_mem_account = off` costs nothing in the hot loop."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, ctx):
        prof = getattr(ctx, "profile", None)
        mem = getattr(ctx, "mem", None)
        if prof is None and mem is None:
            return fn(self, ctx)
        gen = prof.wrap_batches(self, fn, ctx) if prof is not None \
            else fn(self, ctx)
        if mem is not None:
            gen = mem.wrap_batches(self, gen)
        return gen

    wrapper._obs_wrapped = True
    wrapper._obs_raw = fn
    return wrapper


class PlanNode:
    names: list[str]
    types: list[dt.SqlType]

    def __init_subclass__(cls, **kwargs):
        # every operator that defines its own batches() is profiled
        # automatically (search_scan/window nodes included) — the span
        # layer can never drift out of sync with new operators
        super().__init_subclass__(**kwargs)
        impl = cls.__dict__.get("batches")
        if impl is not None and not getattr(impl, "_obs_wrapped", False):
            cls.batches = _profiled_batches(impl)

    def batches(self, ctx: ExecContext) -> Iterator[Batch]:
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> Batch:
        bs = list(self.batches(ctx))
        if not bs:
            return empty_batch(self.names, self.types)
        return concat_batches(bs)

    def children(self) -> list["PlanNode"]:
        return []

    def explain(self, depth: int = 0) -> list[str]:
        line = "  " * depth + self.label()
        out = [line]
        for c in self.children():
            out.extend(c.explain(depth + 1))
        return out

    def label(self) -> str:
        return type(self).__name__


def check_cancel():
    """Cooperative cancellation point at executor batch boundaries
    (reference: interrupt checks inside execution tasks,
    pg_wire_session.h:205-220). Reads the executing connection from the
    contextvar; free when no connection or no cancel pending."""
    from ..engine import CURRENT_CONNECTION
    conn = CURRENT_CONNECTION.get()
    if conn is not None:
        conn.check_cancel()


class ScanNode(PlanNode):
    def __init__(self, provider: TableProvider, columns: list[str],
                 alias: str, filter_expr: Optional[BoundExpr] = None):
        self.provider = provider
        self.columns = columns
        self.alias = alias
        self.filter = filter_expr  # pushed-down predicate (bound to scan schema)
        self.names = list(columns)
        self.types = [provider.type_of(c) for c in columns]

    def batches(self, ctx: ExecContext) -> Iterator[Batch]:
        join_filters = ctx.join_filters.get(id(self)) \
            if ctx.join_filters else None
        if self.filter is not None or join_filters:
            pruned = self._pruned_batches(ctx, join_filters)
            if pruned is not None:
                yield from pruned
                return
        for b in self.provider.batches(self.columns):
            check_cancel()
            if self.filter is not None:
                mask_col = self.filter.eval(b)
                mask = mask_col.data.astype(bool) & mask_col.valid_mask()
                b = b.filter(mask)
            yield b

    def _pruned_batches(self, ctx: ExecContext, join_filters=None):
        """Zone-map skip-scan for a serial scan: blocks whose stats prove
        no row matches are never sliced, blocks that provably match whole
        skip predicate evaluation. `join_filters` are build-key-range
        conjuncts a JoinNode published for this scan (probe side of an
        inner/right hash join) — they prune blocks like filter conjuncts
        but never run per row: rows in surviving blocks that miss the
        range are simply non-matching probe rows. None → plain scan."""
        from . import shard as shard_mod
        from . import zonemap
        pin = self.provider.try_pin()
        block_rows = int(ctx.settings.get("serene_morsel_rows"))
        sharded = isinstance(join_filters, shard_mod.ShardedRanges)
        v_scan = zonemap.block_verdicts(
            self.provider, ctx.settings, [self.filter], self.columns,
            block_rows, pin) if self.filter is not None else None
        if sharded:
            v_join = shard_mod.sharded_verdicts(
                self.provider, ctx.settings, join_filters, self.columns,
                block_rows, pin)
        else:
            v_join = zonemap.block_verdicts(
                self.provider, ctx.settings, list(join_filters),
                self.columns, block_rows, pin) if join_filters else None
        verdicts = zonemap.combine_verdicts(v_scan, v_join)
        if verdicts is None:
            return None
        if v_join is not None:
            zonemap.count_join_filter(v_join)
            if sharded:
                shard_mod.count_shard_pruned(v_join)
                shard_mod.stamp_profile(
                    ctx, id(self), len(join_filters),
                    int((v_join == zonemap.SKIP).sum()))
        zonemap.count_pruned(verdicts)
        prof = getattr(ctx, "profile", None)
        if prof is not None:
            # disjoint attribution (scheduled + pruned + jf_pruned =
            # total blocks): a block both analyses would skip counts
            # once, under the join filter
            total = int((verdicts == zonemap.SKIP).sum())
            jf = int((v_join == zonemap.SKIP).sum()) \
                if v_join is not None else 0
            prof.add_scan_morsels(id(self),
                                  scheduled=len(verdicts) - total,
                                  pruned=total - jf, jf_pruned=jf)
        if pin is not None and all(c in pin[0] for c in self.columns):
            full = Batch(list(self.columns),
                         [pin[0].column(c) for c in self.columns])
        else:
            full = self.provider.full_batch(self.columns)
        nrows = full.num_rows
        scan_exprs = [self.filter] if self.filter is not None else []
        exprs = scan_exprs + (list(join_filters or [])
                              if not sharded else [])

        def gen():
            if zonemap.verify_enabled(ctx.settings):
                spans = [(b * block_rows, min((b + 1) * block_rows, nrows))
                         for b in np.flatnonzero(verdicts == zonemap.SKIP)]
                if sharded:
                    # OR semantics: a pruned block must fail EVERY build
                    # shard's range conjunction (plus the scan filter)
                    for grp in join_filters:
                        zonemap.verify_pruned_blocks(
                            scan_exprs + list(grp), full, spans,
                            f"scan {self.provider.name}")
                else:
                    zonemap.verify_pruned_blocks(
                        exprs, full, spans, f"scan {self.provider.name}")
            emitted = False
            for b, v in enumerate(verdicts):
                check_cancel()
                if v == zonemap.SKIP:
                    continue
                sl = full.slice(b * block_rows,
                                min((b + 1) * block_rows, nrows))
                # the filter-skip decision reads the SCAN verdict: a
                # join-range SCAN must not force a re-eval the zone maps
                # already proved all-match, and a join-range ALL says
                # nothing about the scan filter
                if self.filter is not None and \
                        (v_scan is None or v_scan[b] != zonemap.ALL):
                    c = self.filter.eval(sl)
                    sl = sl.filter(c.data.astype(bool) & c.valid_mask())
                emitted = True
                yield sl
            if not emitted:
                yield full.slice(0, 0)
        return gen()

    def label(self) -> str:
        f = " filter=yes" if self.filter is not None else ""
        return f"Scan {self.provider.name} [{', '.join(self.columns)}]{f}"


def _take_null_extended(batch: Batch, idx: np.ndarray) -> list[Column]:
    """Row gather where idx == -1 yields a NULL row (outer-join extension)."""
    nullmask = idx < 0
    out = []
    for c in batch.columns:
        if batch.num_rows == 0:
            out.append(Column.from_pylist([None] * len(idx), c.type))
            continue
        t = c.take(np.where(nullmask, 0, idx))
        validity = t.valid_mask() & ~nullmask
        out.append(Column(t.type, t.data,
                          None if validity.all() else validity, t.dictionary))
    return out


def _merge_using_columns(lc: Column, rc: Column,
                         right_only: np.ndarray) -> Column:
    """FULL JOIN USING merged key: COALESCE(l, r) realized as one
    np.where over the null-extended sides (right-only rows take the
    right value). Dictionary strings re-encode onto a shared dictionary
    first so the select works on codes."""
    from ..columnar.column import merge_dictionaries
    if lc.type.is_string and rc.type.is_string:
        ml, mr = merge_dictionaries([lc, rc])
        data = np.where(right_only, mr.data, ml.data).astype(ml.data.dtype)
        validity = np.where(right_only, mr.valid_mask(), ml.valid_mask())
        return Column(lc.type, data,
                      None if validity.all() else validity, ml.dictionary)
    if lc.type.is_string != rc.type.is_string:   # heterogeneous USING pair
        lvals, rvals = lc.to_pylist(), rc.to_pylist()
        merged = [rvals[i] if right_only[i] else lvals[i]
                  for i in range(len(lvals))]
        return Column.from_pylist(merged, lc.type)
    if rc.data.dtype != lc.data.dtype and lc.data.dtype.kind in "iu":
        # astype would WRAP a wider right value that overflows the left
        # key's physical type; the row merge this replaced raised 22003
        merged = rc.data[right_only & rc.valid_mask()]
        if len(merged):
            info = np.iinfo(lc.data.dtype)
            if merged.min() < info.min or merged.max() > info.max:
                raise errors.SqlError(
                    "22003", f"value out of range for type "
                    f"{lc.type.id.name.lower()}")
    data = np.where(right_only, rc.data.astype(lc.data.dtype), lc.data)
    validity = np.where(right_only, rc.valid_mask(), lc.valid_mask())
    return Column(lc.type, data,
                  None if validity.all() else validity, lc.dictionary)


class ValuesNode(PlanNode):
    def __init__(self, batch: Batch):
        self.batch = batch
        self.names = list(batch.names)
        self.types = [c.type for c in batch.columns]

    def batches(self, ctx):
        yield self.batch

    def label(self):
        return f"Values ({self.batch.num_rows} rows)"


class FilterNode(PlanNode):
    def __init__(self, child: PlanNode, pred: BoundExpr):
        self.child = child
        self.pred = pred
        self.names = child.names
        self.types = child.types

    def children(self):
        return [self.child]

    def batches(self, ctx):
        for b in self.child.batches(ctx):
            c = self.pred.eval(b)
            mask = c.data.astype(bool) & c.valid_mask()
            yield b.filter(mask)

    def label(self):
        return "Filter"


class ProjectNode(PlanNode):
    def __init__(self, child: PlanNode, exprs: list[BoundExpr],
                 names: list[str]):
        self.child = child
        self.exprs = exprs
        self.names = names
        self.types = [e.type for e in exprs]

    def children(self):
        return [self.child]

    def batches(self, ctx):
        for b in self.child.batches(ctx):
            cols = [e.eval(b) for e in self.exprs]
            yield Batch(list(self.names), cols)

    def label(self):
        return f"Project [{', '.join(self.names)}]"


class LimitNode(PlanNode):
    def __init__(self, child: PlanNode, limit: Optional[int], offset: int = 0):
        if limit is not None and limit < 0:
            raise errors.SqlError("2201W", "LIMIT must not be negative")
        if offset and offset < 0:
            raise errors.SqlError("2201X", "OFFSET must not be negative")
        self.child = child
        self.limit = limit
        self.offset = offset
        self.names = child.names
        self.types = child.types

    def children(self):
        return [self.child]

    def batches(self, ctx):
        if isinstance(self.child, SortNode):
            # chained device residency first: a fused aggregate under
            # the sort runs agg → top-N as two dispatches with the
            # accumulators handed off in HBM. Then fused top-N (owns
            # the FILTERED scan shape: predicate masks to the sort
            # sentinel inside the same program as top_k); the
            # unfiltered shape stays with device_topn, and all three
            # decline overlapping territory
            from .device_pipeline import (try_device_chained_topn,
                                          try_device_fused_topn)
            out = try_device_chained_topn(self, ctx)
            if out is None:
                out = try_device_fused_topn(self, ctx)
            if out is None:
                from .device_topn import try_device_topn
                out = try_device_topn(self, ctx)
            if out is not None:
                yield out
                return
        skipped = 0
        emitted = 0
        for b in self.child.batches(ctx):
            if self.offset and skipped < self.offset:
                take = min(b.num_rows, self.offset - skipped)
                skipped += take
                b = b.slice(take, b.num_rows)
            if b.num_rows == 0:
                continue
            if self.limit is not None:
                remaining = self.limit - emitted
                if remaining <= 0:
                    return
                if b.num_rows > remaining:
                    b = b.slice(0, remaining)
            emitted += b.num_rows
            yield b

    def label(self):
        return f"Limit {self.limit} offset {self.offset}"


def _record_sort_ranks(col: Column) -> np.ndarray:
    """Dense field-wise sort ranks for a record column (PG record_cmp
    order, not physical-text order — text would put ROW(10) before
    ROW(2))."""
    import functools

    from ..columnar.pgcopy import record_cmp_total
    vals = [str(v) for v in col.to_pylist()]
    n = len(vals)
    order = sorted(range(n),
                   key=functools.cmp_to_key(
                       lambda i, j: record_cmp_total(vals[i], vals[j])))
    ranks = np.zeros(n, dtype=np.int64)
    r = 0
    for k, i in enumerate(order):
        if k > 0 and record_cmp_total(vals[order[k - 1]], vals[i]) != 0:
            r += 1
        ranks[i] = r
    return ranks


class SortNode(PlanNode):
    """Full materializing sort. keys are column indices into the child
    output; PG default null ordering: NULLS LAST asc, NULLS FIRST desc."""

    def __init__(self, child: PlanNode, key_indices: list[int],
                 descs: list[bool], nulls_first: list[Optional[bool]]):
        self.child = child
        self.key_indices = key_indices
        self.descs = descs
        self.nulls_first = nulls_first
        self.names = child.names
        self.types = child.types

    def children(self):
        return [self.child]

    def batches(self, ctx):
        full = concat_batches(list(self.child.batches(ctx)))
        mem = getattr(ctx, "mem", None)
        sort_bytes = 0
        if mem is not None:
            # the materialized sort buffer (input copy + key ranks are
            # the same order of bytes; the input batch is the charge)
            from ..obs.trace import batch_nbytes
            sort_bytes = batch_nbytes(full)
            mem.charge(id(self), sort_bytes)
        try:
            yield from self._sorted(full)
        finally:
            if sort_bytes:
                mem.release(id(self), sort_bytes)

    def _sorted(self, full):
        if full.num_rows <= 1:
            yield full
            return
        # np.lexsort: last key is primary. Keys are densified to int64 ranks
        # (np.unique inverse) so DESC negation and NULL placement are exact
        # for any dtype, including int64 beyond 2^53.
        keys = []
        for ki, desc, nf in zip(reversed(self.key_indices),
                                reversed(self.descs),
                                reversed(self.nulls_first)):
            col = full.columns[ki]
            null_first = nf if nf is not None else desc
            if col.type.id is dt.TypeId.RECORD:
                ranks = _record_sort_ranks(col)
            else:
                _, ranks = np.unique(col.data, return_inverse=True)
            ranks = ranks.astype(np.int64)
            if desc:
                ranks = -ranks
            nulls = ~col.valid_mask()
            nullkey = np.where(nulls, -1, 1) if null_first \
                else np.where(nulls, 1, -1)
            keys.append(np.where(nulls, 0, ranks))
            keys.append(nullkey)
        order = np.lexsort(tuple(keys))
        yield full.take(order)

    def label(self):
        return f"Sort {list(zip(self.key_indices, self.descs))}"


class DropColumnsNode(PlanNode):
    """Drops hidden sort columns after Sort."""

    def __init__(self, child: PlanNode, keep: int):
        self.child = child
        self.keep = keep
        self.names = child.names[:keep]
        self.types = child.types[:keep]

    def children(self):
        return [self.child]

    def batches(self, ctx):
        for b in self.child.batches(ctx):
            yield Batch(list(self.names), b.columns[:self.keep])

    def label(self):
        return f"Project(keep {self.keep})"


class JoinNode(PlanNode):
    """Hash join (inner/left/right/full/cross). Equi-keys are extracted
    by the planner; residual predicates run over candidate pairs.

    The default path is vectorized: both sides' keys factorize
    into one dense int64 code space (ops/agg.factorize_codes via
    morsel.combined_codes), the build side becomes an argsort/bincount
    offset index, and probe morsels expand matches on the shared worker
    pool with repeat/cumsum arithmetic — no python dicts or row tuples.
    The build side also publishes its key min/max to the probe scan's
    zone-map analyzer (`serene_join_filter`) so provably partner-less
    probe morsels are never enqueued (inner/right only: left/full must
    emit unmatched probe rows). `SET serene_join_vectorized = off` runs
    the legacy row-tuple interpreter; results are bit-identical."""

    def __init__(self, kind: str, left: PlanNode, right: PlanNode,
                 left_keys: list[BoundExpr], right_keys: list[BoundExpr],
                 residual: Optional[BoundExpr], names: list[str],
                 types: list[dt.SqlType],
                 merge_pairs: Optional[list] = None):
        self.kind = kind
        self.left = left
        self.right = right
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.residual = residual
        self.names = names
        self.types = types
        #: FULL JOIN USING: (left col idx, right col idx) pairs whose
        #: left copy takes the right side's value on right-only rows
        self.merge_pairs = merge_pairs or []

    def children(self):
        return [self.left, self.right]

    def batches(self, ctx):
        from ..obs.trace import batch_nbytes
        mem = getattr(ctx, "mem", None)
        held = 0          # input/pair bytes charged to this node

        def hold(n):
            nonlocal held
            if mem is not None and n:
                mem.charge(id(self), n)
                held += n

        scan = self._join_filter_target(ctx)
        scan_id = None
        rkey_cols = None
        if scan is None:
            # no sideways filter possible: keep the pre-filter left-then-
            # right evaluation order (side-effect parity with the oracle)
            lb = concat_batches(list(self.left.batches(ctx)))
            rb = concat_batches(list(self.right.batches(ctx)))
        else:
            # build side (right) materializes FIRST so its key range can
            # prune the probe scan's morsels before they are enqueued
            rb = concat_batches(list(self.right.batches(ctx)))
            if rb.num_rows:
                from . import shard as shard_mod
                from . import zonemap
                rkey_cols = [k.eval(rb) for k in self.right_keys]
                # shard-to-shard sideways passing: with serene_shards >
                # 1 the build side publishes PER-SHARD key ranges (one
                # min/max per round-robin block group) — probe blocks in
                # the gaps between shard ranges prune where the single
                # global envelope could not
                published = None
                n_shards = shard_mod.shard_count(ctx.settings)
                if n_shards > 1:
                    # the build side here is a materialized subtree
                    # batch (no provider), so the view comes straight
                    # from the partitioning function
                    published = shard_mod.build_shard_ranges(
                        self.left_keys, rkey_cols,
                        shard_mod.shard_spans(
                            rb.num_rows,
                            int(ctx.settings.get("serene_morsel_rows")),
                            n_shards))
                if published is None:
                    exprs = zonemap.build_key_range_exprs(
                        self.left_keys, rkey_cols)
                    published = exprs if exprs else None
                if published:
                    ctx.join_filters[id(scan)] = published
                    scan_id = id(scan)
            try:
                lb = concat_batches(list(self.left.batches(ctx)))
            finally:
                if scan_id is not None:
                    ctx.join_filters.pop(scan_id, None)
        # memory accounting: the materialized build + probe sides are
        # this operator's dominant buffers; the candidate pair index
        # arrays join them below. Charged here, released when the
        # output batch has been consumed (generator close).
        hold(batch_nbytes(rb))
        hold(batch_nbytes(lb))
        li, ri = self._match_inner(lb, rb, ctx, rkey_cols)
        hold(int(li.nbytes) + int(ri.nbytes))
        # ON-clause residual applies to *candidate pairs* (outer-join
        # semantics: a pair failing the residual is unmatched, the left row
        # survives null-extended — PG LEFT JOIN ... ON a AND b)
        if self.residual is not None and len(li):
            pair = Batch(list(self.names),
                         lb.take(li).columns + rb.take(ri).columns)
            c = self.residual.eval(pair)
            keep = c.data.astype(bool) & c.valid_mask()
            li, ri = li[keep], ri[keep]
        if self.kind in ("left", "full"):
            matched = np.zeros(lb.num_rows, dtype=bool)
            matched[li] = True
            extra = np.flatnonzero(~matched)
            li = np.concatenate([li, extra])
            ri = np.concatenate([ri, np.full(len(extra), -1, dtype=np.int64)])
        if self.kind in ("right", "full"):
            matched = np.zeros(rb.num_rows, dtype=bool)
            matched[ri[ri >= 0]] = True
            extra = np.flatnonzero(~matched)
            ri = np.concatenate([ri, extra])
            li = np.concatenate([li, np.full(len(extra), -1, dtype=np.int64)])
        lcols = _take_null_extended(lb, li)
        rcols = _take_null_extended(rb, ri)
        if self.merge_pairs:
            right_only = li < 0
            if right_only.any():
                for lk, rk in self.merge_pairs:
                    lcols[lk] = _merge_using_columns(
                        lcols[lk], rcols[rk], right_only)
        try:
            yield Batch(list(self.names), lcols + rcols)
        finally:
            if mem is not None and held:
                mem.release(id(self), held)

    def _join_filter_target(self, ctx) -> Optional["ScanNode"]:
        """The probe-side scan the build key range could prune, when the
        sideways filter is sound: inner/right joins only (left/full emit
        unmatched probe rows and must scan everything), at least one
        bare-column probe key, a probe subtree whose scan indices are
        stable (Filter chains only), and no volatile build-key
        expressions (pre-probe evaluation would double-draw their
        state). None ⇒ run the join in plain left-then-right order."""
        from . import zonemap
        if self.kind not in ("inner", "right") or not self.left_keys:
            return None
        if not zonemap.join_filter_enabled(ctx.settings) or \
                not zonemap.enabled(ctx.settings):
            return None
        if not any(isinstance(k, BoundColumn) for k in self.left_keys):
            return None
        scan = self.left
        while isinstance(scan, FilterNode):
            scan = scan.child
        if type(scan) is not ScanNode:
            return None
        from ..sql.binder import _VOLATILE_FUNCS
        for k in self.right_keys:
            for sub in k.walk():
                if getattr(sub, "name", None) in _VOLATILE_FUNCS:
                    return None
        return scan

    def _match_inner(self, lb: Batch, rb: Batch, ctx,
                     rkey_cols=None) -> tuple[np.ndarray, np.ndarray]:
        """Candidate (inner) pairs; left-join null extension happens later."""
        if self.kind == "cross" or not self.left_keys:
            li = np.repeat(np.arange(lb.num_rows), rb.num_rows)
            ri = np.tile(np.arange(rb.num_rows), lb.num_rows)
            return li, ri
        lkeys = [k.eval(lb) for k in self.left_keys]
        rkeys = rkey_cols if rkey_cols is not None \
            else [k.eval(rb) for k in self.right_keys]
        from .morsel import join_pairs, vectorized_enabled
        if vectorized_enabled(ctx.settings):
            out = join_pairs(lkeys, rkeys, ctx.settings,
                             lb.num_rows, rb.num_rows)
            if out is not None:
                return out
        return self._match_legacy(lkeys, rkeys, lb.num_rows, rb.num_rows)

    def _match_legacy(self, lkeys: list[Column], rkeys: list[Column],
                      nl: int, nr: int) -> tuple[np.ndarray, np.ndarray]:
        """Row-tuple parity oracle (the row-at-a-time interpreter): a python
        dict of build-side tuples probed row by row."""
        lt = list(zip(*(c.to_pylist() for c in lkeys))) \
            if lkeys else [()] * nl
        rt = list(zip(*(c.to_pylist() for c in rkeys))) \
            if rkeys else [()] * nr
        table: dict = {}
        for j, key in enumerate(rt):
            if any(k is None for k in key):
                continue  # NULL never joins
            table.setdefault(key, []).append(j)
        li, ri = [], []
        for i, key in enumerate(lt):
            if any(k is None for k in key):
                continue
            for j in table.get(key, ()):
                li.append(i)
                ri.append(j)
        return (np.asarray(li, dtype=np.int64),
                np.asarray(ri, dtype=np.int64))

    def label(self):
        return f"HashJoin {self.kind}"


class SetOpNode(PlanNode):
    """UNION / INTERSECT / EXCEPT with set (default) or bag (ALL) semantics.
    Row-tuple based on CPU; schema/names come from the left arm."""

    def __init__(self, op: str, all_: bool, left: PlanNode, right: PlanNode):
        self.op = op
        self.all = all_
        self.left = left
        self.right = right
        self.names = list(left.names)
        self.types = [_unify_setop_type(lt, rt)
                      for lt, rt in zip(left.types, right.types)]

    def children(self):
        return [self.left, self.right]

    def label(self):
        return f"SetOp {self.op.upper()}{' ALL' if self.all else ''}"

    def batches(self, ctx):
        if self.op == "union" and self.all:
            # pure concatenation: stay columnar, no python row tuples
            from ..sql.binder import cast_column
            for arm in (self.left, self.right):
                for b in arm.batches(ctx):
                    cols = [cast_column(c, t)
                            for c, t in zip(b.columns, self.types)]
                    yield Batch(list(self.names), cols)
            return
        from .morsel import vectorized_enabled
        if vectorized_enabled(ctx.settings):
            out = self._batches_vectorized(ctx)
            if out is not None:
                yield out
                return
        yield from self._batches_legacy(ctx)

    def _batches_vectorized(self, ctx) -> Optional[Batch]:
        """Set semantics over dense key codes: both arms cast
        to the unified types, factorize into ONE code space, and every
        variant becomes bincount/first-occurrence arithmetic — identical
        row selection and order to the row-tuple oracle (NULL = NULL,
        each NaN occurrence distinct). None → unsupported column shape,
        run the legacy path."""
        from ..sql.binder import cast_column
        from .morsel import (combined_codes, first_occurrence_mask,
                             occurrence_ranks)
        if any(t.id is dt.TypeId.NULL for t in self.types):
            return None
        lb = self.left.execute(ctx)
        rb = self.right.execute(ctx)
        for arm in (lb, rb):
            for c, t in zip(arm.columns, self.types):
                # an integer arm unified to DOUBLE collapses beyond 2**53
                # under the cast; the row-tuple oracle compares int ==
                # float exactly, so those shapes stay on it
                if t.is_float and c.data.dtype.kind in "iu" and \
                        len(c.data) and \
                        (int(c.data.max()) > 2 ** 53 or
                         int(c.data.min()) < -(2 ** 53)):
                    return None
        try:
            lcols = [cast_column(c, t)
                     for c, t in zip(lb.columns, self.types)]
            rcols = [cast_column(c, t)
                     for c, t in zip(rb.columns, self.types)]
        except errors.SqlError:
            return None
        pair = combined_codes(lcols, rcols)
        if pair is None:
            return None
        cl, cr, g = pair
        nl = len(cl)
        if self.op == "union":                      # UNION (distinct)
            codes = np.concatenate([cl, cr])
            keep = first_occurrence_mask(codes, g)
            both = concat_batches([Batch(list(self.names), lcols),
                                   Batch(list(self.names), rcols)])
            return both if keep.all() else both.filter(keep)
        counts_r = np.bincount(cr, minlength=g)
        if self.all:
            # bag semantics: the k-th occurrence of a value on the left
            # pairs off against (INTERSECT) or outlives (EXCEPT) the
            # right side's multiplicity
            occ = occurrence_ranks(cl, g)
            if self.op == "intersect":
                keep = occ < counts_r[cl]
            else:                                   # except
                keep = occ >= counts_r[cl]
        else:
            first = first_occurrence_mask(cl, g)
            if self.op == "intersect":
                keep = first & (counts_r[cl] > 0)
            else:                                   # except
                keep = first & (counts_r[cl] == 0)
        left = Batch(list(self.names), lcols)
        return left if keep.all() else left.filter(keep)

    def _batches_legacy(self, ctx):
        """Row-tuple parity oracle (the row-at-a-time interpreter)."""
        lrows = self.left.execute(ctx).rows()
        rrows = self.right.execute(ctx).rows()
        if self.op == "union":
            out = lrows + rrows
            if not self.all:
                out = _dedup(out)
        elif self.op == "intersect":
            from collections import Counter
            rc = Counter(rrows)
            if self.all:
                out = []
                for row in lrows:
                    if rc[row] > 0:
                        rc[row] -= 1
                        out.append(row)
            else:
                rset = set(rrows)
                out = _dedup([row for row in lrows if row in rset])
        else:  # except
            from collections import Counter
            rc = Counter(rrows)
            if self.all:
                out = []
                for row in lrows:
                    if rc[row] > 0:
                        rc[row] -= 1
                    else:
                        out.append(row)
            else:
                rset = set(rrows)
                out = _dedup([row for row in lrows if row not in rset])
        cols = []
        for i, t in enumerate(self.types):
            cols.append(Column.from_pylist([r[i] for r in out], t))
        yield Batch(list(self.names), cols)


class DistinctOnNode(PlanNode):
    """SELECT DISTINCT ON (keys): keep the FIRST row (in the incoming,
    already-sorted order) of each distinct key tuple (PG semantics)."""

    def __init__(self, child: PlanNode, key_indices: list):
        self.child = child
        self.key_indices = list(key_indices)
        self.names = list(child.names)
        self.types = list(child.types)

    def children(self):
        return [self.child]

    def label(self):
        return f"DistinctOn {self.key_indices}"

    def batches(self, ctx):
        from .morsel import (factorize_codes, first_occurrence_mask,
                             vectorized_enabled)
        vectorized = vectorized_enabled(ctx.settings) and \
            bool(self.key_indices)
        # cross-batch dedup state: within-batch duplicates fall to one
        # code-based first-occurrence pass; across batches only the
        # WINNERS' decoded keys enter a python set (O(distinct keys)
        # total, never O(rows)). The set is seeded lazily so the common
        # single-batch plan never decodes a key at all.
        seen: Optional[set] = None
        pending: Optional[list[Column]] = None   # first batch's winners

        def flush_pending():
            nonlocal seen, pending
            if seen is None:
                seen = set()
            if pending is not None:
                seen.update(zip(*(c.to_pylist() for c in pending)))
                pending = None

        for b in self.child.batches(ctx):
            key_cols = [b.columns[i] for i in self.key_indices]
            supported = vectorized and all(
                (c.type.is_string and c.dictionary is not None) or
                (not c.type.is_string and c.data.dtype.kind in "biuf")
                for c in key_cols)
            if supported:
                codes, g = factorize_codes(
                    [c.data for c in key_cols],
                    [c.validity for c in key_cols])
                all_unique = g == b.num_rows
                keep = None if all_unique \
                    else first_occurrence_mask(codes, g)
                if seen is None and pending is None:
                    pending = key_cols if keep is None \
                        else [c.filter(keep) for c in key_cols]
                    yield b if keep is None else b.filter(keep)
                    continue
                flush_pending()
                if keep is None:
                    keep = np.ones(b.num_rows, dtype=bool)
                cand = np.flatnonzero(keep)
                if len(cand):
                    rows = zip(*(kc.take(cand).to_pylist()
                                 for kc in key_cols))
                    for j, row in enumerate(rows):
                        if row in seen:
                            keep[cand[j]] = False
                        else:
                            seen.add(row)
                yield b if keep.all() else b.filter(keep)
                continue
            # row-tuple path (legacy mode or unsupported key shape)
            flush_pending()
            key_vals = [kc.to_pylist() for kc in key_cols]
            keep = np.zeros(b.num_rows, dtype=bool)
            for r in range(b.num_rows):
                k = tuple(kc[r] for kc in key_vals)
                if k not in seen:
                    seen.add(k)
                    keep[r] = True
            yield b if keep.all() else b.filter(keep)


class RenameNode(PlanNode):
    """Output-column rename (CTE column lists: WITH c(a, b) AS ...)."""

    def __init__(self, child: PlanNode, names: list):
        self.child = child
        if len(names) != len(child.names):
            raise errors.SqlError(
                "42P10", "column list does not match the number of "
                "output columns")
        self.names = list(names)
        self.types = list(child.types)

    def children(self):
        return [self.child]

    def batches(self, ctx):
        for b in self.child.batches(ctx):
            yield Batch(list(self.names), list(b.columns))


class RecursiveCteNode(PlanNode):
    """WITH RECURSIVE fixpoint: run the base term, then re-run the step
    term against the previous iteration's rows (exposed as the `work`
    MemTable the step plan scans) until no new rows arrive. UNION (not
    ALL) deduplicates across ALL accumulated rows, so cyclic graphs
    terminate (PG semantics, src/backend/executor/nodeRecursiveunion.c
    re-expressed over columnar batches)."""

    MAX_ITERATIONS = 20_000

    def __init__(self, names, base: PlanNode, step: PlanNode, work,
                 union_all: bool):
        self.names = list(names)
        self.types = list(base.types)
        self.base = base
        self.step = step
        self.work = work
        self.union_all = union_all

    def children(self):
        return [self.base, self.step]

    def label(self):
        return f"RecursiveCte {self.work.name}" + \
            (" ALL" if self.union_all else "")

    def batches(self, ctx):
        from ..sql.binder import cast_column
        seen: set = set()
        acc: list[Batch] = []

        def conform(b: Batch) -> Batch:
            cols = [cast_column(c, t) for c, t in zip(b.columns, self.types)]
            return Batch(list(self.names), cols)

        def dedup(b: Batch) -> Batch:
            rows = b.rows()
            keep = np.ones(len(rows), dtype=bool)
            for i, r in enumerate(rows):
                if r in seen:
                    keep[i] = False
                else:
                    seen.add(r)
            return b if keep.all() else b.filter(keep)

        cur = conform(self.base.execute(ctx))
        if not self.union_all:
            cur = dedup(cur)
        it = 0
        while cur.num_rows:
            check_cancel()
            acc.append(cur)
            it += 1
            if it > self.MAX_ITERATIONS:
                raise errors.SqlError(
                    "54001", "recursive query iteration limit exceeded")
            self.work.replace(cur)
            cur = conform(self.step.execute(ctx))
            if not self.union_all:
                cur = dedup(cur)
        # leave the working table empty so a cached plan re-executes from
        # a clean slate
        self.work.replace(Batch(list(self.names),
                                [Column.from_pylist([], t)
                                 for t in self.types]))
        if not acc:
            yield empty_batch(self.names, self.types)
            return
        for b in acc:
            yield b


def _unify_setop_type(lt: dt.SqlType, rt: dt.SqlType) -> dt.SqlType:
    if lt.id is dt.TypeId.NULL:
        return rt
    if rt.id is dt.TypeId.NULL:
        return lt
    if lt == rt:
        return lt
    if lt.is_numeric and rt.is_numeric:
        return dt.common_numeric(lt, rt)
    raise errors.SqlError(errors.DATATYPE_MISMATCH,
                          f"UNION types {lt} and {rt} cannot be matched")


def _dedup(rows: list[tuple]) -> list[tuple]:
    seen = set()
    out = []
    for r in rows:
        if r not in seen:
            seen.add(r)
            out.append(r)
    return out


def _sort_key(v, desc: bool, nulls_first=None):
    """Orderable wrapper for aggregate ORDER BY keys; NULL placement
    defaults to last asc / first desc, override via NULLS FIRST/LAST."""
    null_first = nulls_first if nulls_first is not None else desc
    if v is None:
        return (-1 if null_first else 1, 0)
    return (0, _Rev(v) if desc else v)


class _Rev:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return other.v == self.v


#: aggregates whose result is unchanged by duplicate elimination — a
#: DISTINCT qualifier on them runs the plain accumulator
_DISTINCT_INVARIANT = {"min", "max", "bool_and", "bool_or", "every"}


class AggregateNode(PlanNode):
    def __init__(self, child: PlanNode, group_exprs: list[BoundExpr],
                 aggs: list[AggSpec], names: list[str] = None):
        self.child = child
        self.group_exprs = group_exprs
        self.aggs = aggs
        self._names = names

    # names/types derive from the LIVE agg list: ORDER BY / HAVING binding
    # may append aggregates after construction (ORDER BY sum(x) when
    # sum(x) is not in the select list), so a constructor-time snapshot
    # can go stale; explicit names are honored while they still match
    @property
    def names(self) -> list[str]:
        n = len(self.group_exprs) + len(self.aggs)
        if self._names is not None and len(self._names) == n:
            return self._names
        return [f"#g{k}" for k in range(len(self.group_exprs))] + \
               [f"#agg{k}" for k in range(len(self.aggs))]

    @property
    def types(self) -> list:
        return ([g.type for g in self.group_exprs] +
                [a.type for a in self.aggs])

    def children(self):
        return [self.child]

    def label(self):
        return (f"Aggregate groups={len(self.group_exprs)} "
                f"aggs=[{', '.join(a.func for a in self.aggs)}]")

    def batches(self, ctx):
        fast = self._try_count_fast_path(ctx)
        if fast is not None:
            yield fast
            return
        # fused relational pipeline first: Aggregate over an inner
        # equi-join of two (filtered) scans runs as ONE device dispatch
        # (exec/device_pipeline.py); single-table chains stay with
        # try_device_aggregate below
        from .device_pipeline import try_device_pipeline
        result = try_device_pipeline(self, ctx)
        if result is not None:
            yield result
            return
        from .device_agg import try_device_aggregate
        result = try_device_aggregate(self, ctx)
        if result is not None:
            yield result
            return
        # the device path declined the pipeline — morsel-parallel host
        # execution over the shared worker pool, serial oracle last
        from .morsel import try_parallel_aggregate
        result = try_parallel_aggregate(self, ctx)
        if result is not None:
            yield result
            return
        yield self._cpu_aggregate(ctx)

    def _try_count_fast_path(self, ctx):
        """count(*)-only over an index scan skips row materialization
        (reference: ScanMode::Count/CountFast,
        duckdb_search_full_scan.hpp:58-62). The scan node owns the
        counting semantics (count_matching) so they can never diverge
        from its row-returning path."""
        if self.group_exprs or not self.aggs or \
                any(s.func != "count_star" or s.filter is not None
                    for s in self.aggs):
            return None
        count_fn = getattr(self.child, "count_matching", None)
        if count_fn is None:
            return None
        n = count_fn()
        if n is None:
            return None
        return Batch(list(self.names),
                     [Column.from_pylist([n], s.type) for s in self.aggs])

    # -- CPU reference aggregation ----------------------------------------

    def _cpu_aggregate(self, ctx) -> Batch:
        if not self.group_exprs:
            return self._cpu_scalar_agg(ctx)
        full = concat_batches(list(self.child.batches(ctx)))
        from ..ops.agg import factorize_keys
        key_cols = [g.eval(full) for g in self.group_exprs]
        codes, uniq_vals, uniq_valid = factorize_keys(
            [c.data for c in key_cols],
            [c.validity for c in key_cols])
        num_groups = len(uniq_vals[0]) if uniq_vals else 0
        out_cols: list[Column] = []
        for k, (kc, uv) in enumerate(zip(key_cols, uniq_vals)):
            validity = uniq_valid[k] if uniq_valid.size else None
            if validity is not None and validity.all():
                validity = None
            out_cols.append(Column(kc.type, uv, validity, kc.dictionary))
        for spec in self.aggs:
            out_cols.append(self._cpu_group_agg(spec, full, codes, num_groups))
        return Batch(list(self.names), out_cols)

    def _cpu_group_agg(self, spec: AggSpec, full: Batch, codes: np.ndarray,
                       g: int) -> Column:
        if spec.filter is not None:
            c = spec.filter.eval(full)
            fm = c.data.astype(bool) & c.valid_mask()
            full = full.filter(fm)
            codes = codes[fm]
        if spec.func == "count_star":
            data = np.bincount(codes, minlength=g).astype(np.int64)
            return Column(dt.BIGINT, data)
        arg = spec.arg.eval(full)
        valid = arg.valid_mask()
        if spec.distinct:
            if spec.func in ("count", "sum", "avg"):
                return self._cpu_group_distinct(spec, arg, codes, g)
            if spec.func not in _DISTINCT_INVARIANT:
                # string_agg/array_agg/stddev & co. would need real dedup
                raise errors.unsupported(f"DISTINCT {spec.func}")
            # min/max/bool aggs are DISTINCT-invariant: run them plain
        vc = codes[valid]
        if spec.func == "count":
            data = np.bincount(vc, minlength=g).astype(np.int64)
            return Column(dt.BIGINT, data)
        vals = arg.data[valid]
        counts = np.bincount(vc, minlength=g)
        empty = counts == 0
        if spec.func == "sum":
            if arg.type.is_integer or arg.type.id is dt.TypeId.BOOL:
                data = np.bincount(vc, weights=vals.astype(np.float64),
                                   minlength=g)
                # exact: redo in int64 via add.at
                acc = np.zeros(g, dtype=np.int64)
                np.add.at(acc, vc, vals.astype(np.int64))
                return Column(dt.BIGINT, acc, ~empty if empty.any() else None)
            acc = np.zeros(g, dtype=np.float64)
            np.add.at(acc, vc, vals.astype(np.float64))
            return Column(dt.DOUBLE, acc, ~empty if empty.any() else None)
        if spec.func == "avg":
            acc = np.zeros(g, dtype=np.float64)
            np.add.at(acc, vc, vals.astype(np.float64))
            with np.errstate(invalid="ignore", divide="ignore"):
                data = acc / counts
            return Column(dt.DOUBLE, np.where(empty, 0.0, data),
                          ~empty if empty.any() else None)
        if spec.func in ("min", "max"):
            if arg.type.is_string:
                # operate on codes (sorted dictionary ⇒ order-preserving)
                ident = np.iinfo(np.int64).max if spec.func == "min" else -1
                acc = np.full(g, ident, dtype=np.int64)
                ufunc = np.minimum if spec.func == "min" else np.maximum
                ufunc.at(acc, vc, vals.astype(np.int64))
                acc2 = np.where(empty, 0, acc).astype(np.int32)
                return Column(dt.VARCHAR, acc2,
                              ~empty if empty.any() else None, arg.dictionary)
            if arg.type.is_float:
                ident = np.inf if spec.func == "min" else -np.inf
                acc = np.full(g, ident, dtype=np.float64)
            else:
                info = np.iinfo(np.int64)
                ident = info.max if spec.func == "min" else info.min
                acc = np.full(g, ident, dtype=np.int64)
            # PG float total order: NaN is the greatest — np.fmin skips
            # NaN for min; np.maximum propagates it for max
            if spec.func == "min":
                ufunc = np.fmin if arg.type.is_float else np.minimum
            else:
                ufunc = np.maximum
            with np.errstate(invalid="ignore"):   # NaN propagation is wanted
                ufunc.at(acc, vc, vals)
            if spec.func == "min" and arg.type.is_float:
                # all-NaN groups keep the identity: stamp them NaN
                # (~empty already says which groups have valid rows)
                has_non_nan = np.zeros(g, dtype=bool)
                np.logical_or.at(has_non_nan, vc, ~np.isnan(vals))
                acc = np.where(~empty & ~has_non_nan, np.nan, acc)
            acc = np.where(empty, 0, acc).astype(arg.type.np_dtype)
            return Column(arg.type, acc, ~empty if empty.any() else None)
        if spec.func in ("stddev", "stddev_samp", "var_samp", "variance",
                         "stddev_pop", "var_pop"):
            pop = spec.func.endswith("_pop")
            s1 = np.zeros(g)
            s2 = np.zeros(g)
            fv = vals.astype(np.float64)
            np.add.at(s1, vc, fv)
            np.add.at(s2, vc, fv * fv)
            cnt = counts.astype(np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                var = (s2 - s1 * s1 / cnt) / (cnt if pop else cnt - 1)
            # float cancellation can drive the variance fractionally
            # negative (PG clamps to zero)
            var = np.maximum(var, 0.0)
            bad = counts < (1 if pop else 2)
            data = np.sqrt(var) if spec.func.startswith("stddev") else var
            return Column(dt.DOUBLE, np.where(bad, 0.0, data),
                          ~bad if bad.any() else None)
        if spec.func in ("bool_and", "bool_or"):
            vb = vals.astype(bool)
            if spec.func == "bool_and":
                acc = np.ones(g, dtype=bool)
                np.logical_and.at(acc, vc, vb)
            else:
                acc = np.zeros(g, dtype=bool)
                np.logical_or.at(acc, vc, vb)
            return Column(dt.BOOL, acc, ~empty if empty.any() else None)
        if spec.func in ("string_agg", "array_agg"):
            import json as _json
            vals_all = arg.to_pylist()
            row_order = range(len(codes))
            if spec.order_by:
                # aggregate ORDER BY: feed rows in key order (PG),
                # honoring NULLS FIRST/LAST (default: last asc, first
                # desc)
                keys = []
                for e, desc, nf in reversed(spec.order_by):
                    c = e.eval(full)
                    _, rk = np.unique(c.data, return_inverse=True)
                    rk = rk.astype(np.int64)
                    if desc:
                        rk = -rk
                    null_first = nf if nf is not None else desc
                    nulls = ~c.valid_mask()
                    keys.append(np.where(nulls, 0, rk))
                    keys.append(np.where(nulls,
                                         -1 if null_first else 1,
                                         1 if null_first else -1))
                row_order = np.lexsort(tuple(keys))
            groups: dict[int, list] = {}
            for i in row_order:
                code = codes[i]
                v = vals_all[i]
                if v is None:
                    continue
                groups.setdefault(int(code), []).append(v)
            out = []
            for gi in range(g):
                items = groups.get(gi)
                if items is None:
                    out.append(None)
                elif spec.func == "string_agg":
                    out.append((spec.sep or "").join(str(x) for x in items))
                else:
                    out.append(_json.dumps(items))
            return Column.from_pylist(out, dt.VARCHAR)
        raise errors.unsupported(f"aggregate {spec.func}")

    def _cpu_group_distinct(self, spec: AggSpec, arg: Column,
                            codes: np.ndarray, g: int) -> Column:
        valid = arg.valid_mask()
        vc = codes[valid]
        vals = arg.data[valid]
        if len(vc):
            order = np.lexsort((vals, vc))
            sc, sv = vc[order], vals[order]
            keep = np.concatenate([[True], (sc[1:] != sc[:-1]) | (sv[1:] != sv[:-1])])
            uc, uv = sc[keep], sv[keep]
        else:
            uc, uv = vc, vals
        if spec.func == "count":
            data = np.bincount(uc, minlength=g).astype(np.int64)
            return Column(dt.BIGINT, data)
        if spec.func in ("sum", "avg"):
            cnt = np.bincount(uc, minlength=g).astype(np.int64)
            empty = cnt == 0    # all-NULL group: SUM/AVG are NULL (PG)
            validity = ~empty if empty.any() else None
            if spec.func == "avg" or not arg.type.is_integer:
                acc = np.zeros(g, dtype=np.float64)
                np.add.at(acc, uc, uv.astype(np.float64))
                if spec.func == "avg":
                    with np.errstate(invalid="ignore", divide="ignore"):
                        acc = np.where(empty, 0.0, acc / np.maximum(cnt, 1))
                return Column(dt.DOUBLE, acc, validity)
            acc = np.zeros(g, dtype=np.int64)
            np.add.at(acc, uc, uv.astype(np.int64))
            return Column(dt.BIGINT, acc, validity)
        raise errors.unsupported(f"DISTINCT {spec.func}")

    def _cpu_scalar_agg(self, ctx) -> Batch:
        accs = [_ScalarAcc(spec) for spec in self.aggs]
        for b in self.child.batches(ctx):
            for acc in accs:
                acc.update(b)
        cols = [acc.result() for acc in accs]
        return Batch(list(self.names), cols)


class _ScalarAcc:
    def __init__(self, spec: AggSpec):
        self.spec = spec
        self.count = 0
        self.sum_i = 0
        self.sum_f = 0.0
        self.sum_sq = 0.0
        self.min_v = None
        self.max_v = None
        if spec.distinct and spec.func not in ("count", "sum", "avg") \
                and spec.func not in _DISTINCT_INVARIANT:
            raise errors.unsupported(f"DISTINCT {spec.func}")
        # min/max & friends are DISTINCT-invariant — no dedup set needed
        self.distinct: Optional[set] = set() \
            if spec.distinct and spec.func in ("count", "sum", "avg") \
            else None
        self.strings: list[str] = []
        self.bool_acc = None

    def update(self, b: Batch):
        spec = self.spec
        if spec.filter is not None:
            c = spec.filter.eval(b)
            b = b.filter(c.data.astype(bool) & c.valid_mask())
        if spec.func == "count_star":
            self.count += b.num_rows
            return
        col = spec.arg.eval(b)
        valid = col.valid_mask()
        n_valid = int(valid.sum())
        if n_valid == 0:
            return
        if self.distinct is not None:
            vals = col.to_pylist()
            self.distinct.update(v for v in vals if v is not None)
            return
        self.count += n_valid
        if spec.func in ("sum", "avg", "stddev", "stddev_samp", "var_samp",
                         "variance", "stddev_pop", "var_pop"):
            vals = col.data[valid]
            if col.type.is_integer or col.type.id is dt.TypeId.BOOL:
                self.sum_i += int(vals.astype(np.int64).sum())
            self.sum_f += float(vals.astype(np.float64).sum())
            self.sum_sq += float((vals.astype(np.float64) ** 2).sum())
        elif spec.func in ("min", "max"):
            if col.type.is_string:
                vals = [v for v in col.to_pylist() if v is not None]
                lo, hi = min(vals), max(vals)
                self.min_v = lo if self.min_v is None \
                    else min(self.min_v, lo)
                self.max_v = hi if self.max_v is None \
                    else max(self.max_v, hi)
            else:
                vals = col.data[valid]
                # PG float total order: NaN is the GREATEST value — max
                # returns NaN when any NaN exists, min skips NaN unless
                # every value is NaN
                if vals.dtype.kind == "f" and np.isnan(vals).any():
                    nn = vals[~np.isnan(vals)]
                    lo = nn.min() if len(nn) else np.nan
                    hi = np.nan
                else:
                    lo, hi = vals.min(), vals.max()
                self.min_v = lo if self.min_v is None \
                    else np.fmin(self.min_v, lo)
                # np.maximum propagates NaN — exactly PG's max
                self.max_v = hi if self.max_v is None \
                    else np.maximum(self.max_v, hi)
        elif spec.func in ("bool_and", "bool_or"):
            vals = col.data[valid].astype(bool)
            v = vals.all() if spec.func == "bool_and" else vals.any()
            if self.bool_acc is None:
                self.bool_acc = bool(v)
            else:
                self.bool_acc = (self.bool_acc and bool(v)) \
                    if spec.func == "bool_and" else (self.bool_acc or bool(v))
        elif spec.func in ("string_agg", "array_agg"):
            if spec.order_by:
                keycols = [(e.eval(b).to_pylist(), desc, nf)
                           for e, desc, nf in spec.order_by]
                for i, v in enumerate(col.to_pylist()):
                    if v is not None:
                        self.strings.append(
                            (tuple(_sort_key(kc[i], desc, nf)
                                   for kc, desc, nf in keycols), v))
            else:
                self.strings.extend(
                    v for v in col.to_pylist() if v is not None)
        elif spec.func == "count":
            pass
        else:
            raise errors.unsupported(f"aggregate {spec.func}")

    def result(self) -> Column:
        spec = self.spec
        t = spec.type
        if spec.func == "count_star":
            return Column.from_pylist([self.count], t)
        if self.distinct is not None:
            if spec.func == "count":
                return Column.from_pylist([len(self.distinct)], t)
            if spec.func == "sum":
                s = sum(self.distinct) if self.distinct else None
                return Column.from_pylist([s], t)
            if spec.func == "avg":
                a = (sum(self.distinct) / len(self.distinct)
                     if self.distinct else None)
                return Column.from_pylist([a], t)
            raise errors.unsupported(f"DISTINCT {spec.func}")
        if spec.func == "count":
            return Column.from_pylist([self.count], t)
        if self.count == 0 and spec.func != "count":
            return Column.from_pylist([None], t)
        if spec.func == "sum":
            v = self.sum_i if t.is_integer else self.sum_f
            return Column.from_pylist([v], t)
        if spec.func == "avg":
            return Column.from_pylist([self.sum_f / self.count], t)
        if spec.func == "min":
            v = self.min_v
            return Column.from_pylist([v.item() if hasattr(v, "item") else v], t)
        if spec.func == "max":
            v = self.max_v
            return Column.from_pylist([v.item() if hasattr(v, "item") else v], t)
        if spec.func in ("stddev", "stddev_samp", "var_samp", "variance",
                         "stddev_pop", "var_pop"):
            pop = spec.func.endswith("_pop")
            if self.count < (1 if pop else 2):
                return Column.from_pylist([None], t)
            var = max((self.sum_sq - self.sum_f ** 2 / self.count) /
                      (self.count if pop else self.count - 1), 0.0)
            v = math.sqrt(var) if spec.func.startswith("stddev") else var
            return Column.from_pylist([v], t)
        if spec.func in ("bool_and", "bool_or"):
            return Column.from_pylist([self.bool_acc], t)
        if spec.func in ("string_agg", "array_agg"):
            items = self.strings
            if spec.order_by and items:
                items = [v for _k, v in sorted(items, key=lambda p: p[0])]
            if spec.func == "string_agg":
                sep = spec.sep if spec.sep is not None else ""
                v = sep.join(str(x) for x in items) if items else None
                return Column.from_pylist([v], t)
            import json as _json
            v = _json.dumps(items) if items else None
            return Column.from_pylist([v], t)
        raise errors.unsupported(f"aggregate {spec.func}")
