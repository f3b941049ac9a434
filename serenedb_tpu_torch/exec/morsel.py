"""Copied from serenedb_tpu/exec/morsel.py.

Morsel-driven parallel host pipelines: Scan→Filter→Project→partial-Agg.

Reference analog: DuckDB's morsel-driven parallelism (SURVEY.md §3.2) — a
table scan splits into fixed-size row morsels, each worker runs the WHOLE
operator chain over its morsel and feeds a partial-aggregate sink, and a
single combine step merges the partials. This is the host-CPU half of the
engine's headline ratios; the device offload (exec/device_agg.py) claims
the pipeline first and this path takes over whenever the device declines.

Determinism contract (the bench ledger asserts device-vs-CPU parity, so
the CPU result must not wobble):

- the morsel split is a pure function of (row count, serene_morsel_rows)
  — never of worker count or scheduling;
- partial batches merge in MORSEL ORDER via one vectorized second-level
  aggregation whose group order comes from the same composite-key
  factorization the serial path uses (ops/agg.py factorize_keys), so
  `serene_workers = 1` and `= N` produce bit-identical batches;
- exact combiners: integer SUM/COUNT merge in int64, MIN/MAX are
  selections, float partials accumulate in float64 with a fixed
  association.

Anything outside the supported shape (DISTINCT, ordered string_agg, record
keys, custom providers) falls back to the serial CPU oracle in plan.py.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.column import (Batch, Column, concat_batches,
                               merge_dictionaries)
from ..obs.trace import batch_nbytes
from ..ops.agg import factorize_codes, factorize_keys
from ..parallel.pool import parallel_map
from ..sql.expr import AggSpec, BoundColumn

#: aggregate functions with an exact partial/combine decomposition
_PARALLEL_FUNCS = {
    "count_star", "count", "sum", "min", "max", "avg",
    "bool_and", "bool_or",
    "stddev", "stddev_samp", "var_samp", "variance", "stddev_pop",
    "var_pop",
}

_STDDEV = {"stddev", "stddev_samp", "var_samp", "variance", "stddev_pop",
           "var_pop"}


class _Fallback(Exception):
    """Shape turned out unsupported mid-flight — use the serial path."""


def _stage_clocks() -> tuple[int, int]:
    return time.perf_counter_ns(), time.thread_time_ns()


def _stage_stamp(prof, key: int, b: Batch,
                 clocks: tuple[int, int]) -> tuple[int, int]:
    """One morsel × one fused stage → one add_stage() span; returns fresh
    clocks so consecutive stages chain without double counting."""
    t1, c1 = time.perf_counter_ns(), time.thread_time_ns()
    prof.add_stage(key, b.num_rows, t1 - clocks[0], c1 - clocks[1],
                   batch_nbytes(b))
    return t1, c1


def try_parallel_aggregate(node, ctx) -> Optional[Batch]:
    """Morsel-parallel execution of an AggregateNode; None → serial CPU."""
    from .plan import FilterNode, ProjectNode, ScanNode, check_cancel

    settings = ctx.settings
    stages = []
    child = node.child
    while isinstance(child, (FilterNode, ProjectNode)):
        stages.append(child)
        child = child.child
    if type(child) is not ScanNode:
        return None
    scan = child
    stages.reverse()
    for spec in node.aggs:
        if spec.func not in _PARALLEL_FUNCS or spec.distinct \
                or spec.order_by:
            return None
    for g in node.group_exprs:
        if g.type.id is dt.TypeId.RECORD:
            return None
    # two classes of expression pin a pipeline to serial execution:
    # subquery impls carry lazily-computed one-shot caches that are not
    # synchronized (every worker would run the inner plan), and volatile
    # / sequence functions (nextval & co.) draw from shared mutable
    # state whose interleaving would break the workers=1 == workers=N
    # bit-identity contract.
    from ..sql.binder import _VOLATILE_FUNCS
    serial_only = _VOLATILE_FUNCS | {
        "scalar_subquery", "array_subquery", "in_subquery", "exists",
        "currval", "lastval"}
    exprs = ([scan.filter] if scan.filter is not None else []) + \
        [st.pred for st in stages if isinstance(st, FilterNode)] + \
        [e for st in stages if isinstance(st, ProjectNode)
         for e in st.exprs] + \
        list(node.group_exprs) + \
        [e for s in node.aggs for e in (s.arg, s.filter) if e is not None]
    for e in exprs:
        for sub in e.walk():
            if getattr(sub, "name", None) in serial_only:
                return None
    provider = scan.provider
    try:
        nrows = provider.row_count()
    except NotImplementedError:
        return None
    morsel_rows = int(settings.get("serene_morsel_rows"))
    if nrows < int(settings.get("serene_parallel_min_rows")) or \
            nrows <= morsel_rows:
        return None
    # ONE publication observation for the whole pipeline (same rule as the
    # device path): every morsel slices the same batch reference, and the
    # zone-map verdicts are built from the same pin so a racing publish
    # can never pair fresh data with stale block stats.
    from . import zonemap
    pin = provider.try_pin()
    if pin is not None:
        nrows = pin[0].num_rows

    # scan-schema-bound predicates: the pushed-down scan filter plus every
    # FilterNode ahead of the first projection (after a Project, column
    # indices refer to the projected batch, not the scan)
    first_proj = next((i for i, st in enumerate(stages)
                       if isinstance(st, ProjectNode)), len(stages))
    scan_preds = ([scan.filter] if scan.filter is not None else []) + \
        [st.pred for st in stages[:first_proj]]
    leading = frozenset(id(st) for st in stages[:first_proj])

    verdicts = zonemap.block_verdicts(provider, settings, scan_preds,
                                      scan.columns, morsel_rows, pin)
    spans = [(s, min(s + morsel_rows, nrows))
             for s in range(0, nrows, morsel_rows)]
    verify = verdicts is not None and zonemap.verify_enabled(settings)
    if verdicts is not None:
        zonemap.count_pruned(verdicts)
        keep = [(sp, int(v)) for sp, v in zip(spans, verdicts)
                if v != zonemap.SKIP]
    else:
        keep = [(sp, zonemap.SCAN) for sp in spans]
    prof = getattr(ctx, "profile", None)
    if prof is not None:
        prof.add_scan_morsels(id(scan), scheduled=len(keep),
                              pruned=len(spans) - len(keep))
    mem = getattr(ctx, "mem", None)
    if mem is not None:
        mem.add_morsels_scheduled(len(keep))
        mem.set_op(scan.label())

    # late materialization: only columns the scan-bound expressions
    # actually read are fetched before morsels run; the rest never
    # materialize (pinned providers hand out column references for free,
    # so the pin batch is used whole there)
    full = None
    if keep or verify:
        full = _scan_batch(provider, scan, stages, node, first_proj,
                           scan_preds, pin)
    if verify:
        pruned = [sp for sp, v in zip(spans, verdicts)
                  if v == zonemap.SKIP]
        zonemap.verify_pruned_blocks(scan_preds, full, pruned,
                                     "morsel aggregate")
    if not keep:
        # every block pruned: one empty morsel keeps the merge shape
        # (zero groups / NULL scalar aggregates) without touching data
        from .plan import empty_batch
        empty = empty_batch(list(scan.columns), list(scan.types))
        keep = [((0, 0), zonemap.SCAN)]
        full = empty

    def run_morsel(item):
        # per-stage span stamps (profile on): the fused pipeline is the
        # only execution these operators get, so each stage's rows/time
        # accumulate under the PLAN NODE's id from every worker thread —
        # the sink merge sums them, giving exact per-operator actual
        # rows at any worker count
        span, verdict = item
        check_cancel()
        b = full.slice(span[0], span[1])
        in_rows = b.num_rows
        in_bytes = batch_nbytes(b) if mem is not None else 0
        if in_bytes:
            # the morsel's working slice is this worker's live set for
            # the duration of the task (the slice views the pinned
            # batch, but filter/project stages materialize copies of
            # the same order of bytes — the slice size is the charge)
            mem.charge(id(scan), in_bytes)
        all_match = verdict == zonemap.ALL
        clocks = _stage_clocks() if prof is not None else None
        if scan.filter is not None and not all_match:
            c = scan.filter.eval(b)
            b = b.filter(c.data.astype(bool) & c.valid_mask())
        if clocks is not None:
            clocks = _stage_stamp(prof, id(scan), b, clocks)
        for st in stages:
            if isinstance(st, FilterNode):
                if all_match and id(st) in leading:
                    if clocks is not None:
                        clocks = _stage_stamp(prof, id(st), b, clocks)
                    continue     # zone maps proved every row matches
                c = st.pred.eval(b)
                b = b.filter(c.data.astype(bool) & c.valid_mask())
            else:
                b = Batch(list(st.names), [e.eval(b) for e in st.exprs])
            if clocks is not None:
                clocks = _stage_stamp(prof, id(st), b, clocks)
        p = _morsel_partials(node, b)
        if mem is not None:
            # the partial outlives the task (released by the merge
            # sink); the input slice retires with it
            mem.charge(id(node), batch_nbytes(p))
            mem.release(id(scan), in_bytes)
            mem.add_progress(rows=in_rows, nbytes=in_bytes, morsels=1)
        return p

    from ..obs.trace import current_trace
    from . import shard as shard_mod
    n_shards = shard_mod.shard_count(settings)
    trace = current_trace()
    t_pipe = time.perf_counter_ns() if trace is not None else 0
    try:
        if n_shards > 1 and len(keep) > 1:
            # sharded tier (exec/shard.py): ONE pipeline per shard — the
            # same morsel plan over the shard's round-robin block set,
            # fanned out as concurrent pool tasks. Partials re-enter the
            # merge in GLOBAL morsel order, so the sink consumes exactly
            # the shards=1 partial list and the combine stays the
            # bit-identical deterministic merge.
            groups: dict[int, list] = {}
            for pos, item in enumerate(keep):
                s = shard_mod.shard_of_block(item[0][0] // morsel_rows,
                                             n_shards)
                groups.setdefault(s, []).append((pos, item))
            shard_lists = [groups[s] for s in sorted(groups)]

            def run_shard(entries):
                return [(pos, run_morsel(item)) for pos, item in entries]

            parts = shard_mod.run_shard_tasks(settings, run_shard,
                                              shard_lists)
            ordered: list = [None] * len(keep)
            for chunk in parts:
                for pos, p in chunk:
                    ordered[pos] = p
            shard_mod.stamp_profile(ctx, id(node), len(shard_lists))
            out = _merge_partials(node, ordered)
            if mem is not None:
                mem.release(id(node),
                            sum(batch_nbytes(p) for p in ordered))
            if trace is not None:
                trace.add("morsel_pipeline", "morsel", t_pipe,
                          time.perf_counter_ns(), morsels=len(keep),
                          shards=len(shard_lists))
            return out
        partials = parallel_map(settings, run_morsel, keep)
        out = _merge_partials(node, partials)
        if mem is not None:
            mem.release(id(node),
                        sum(batch_nbytes(p) for p in partials))
        if trace is not None:
            trace.add("morsel_pipeline", "morsel", t_pipe,
                      time.perf_counter_ns(), morsels=len(keep))
        return out
    except _Fallback:
        return None


def _scan_batch(provider, scan, stages, node, first_proj: int,
                scan_preds: list, pin) -> Batch:
    """The pipeline's input batch under one publication observation.
    Pinned (mutable) providers hand back their published batch — column
    references, zero cost. Pin-less providers (parquet) decode columns
    lazily, so only the columns the scan-bound expressions actually
    reference are fetched; unreferenced positions get zero-byte
    broadcast placeholders that keep Batch geometry without
    materializing (they are provably never evaluated)."""
    names = scan.columns
    if pin is not None:
        batch = pin[0]
        if all(c in batch for c in names):
            return Batch(list(names), [batch.column(c) for c in names])
        return provider.full_batch(names)     # surface the proper error
    scan_bound = list(scan_preds)
    if first_proj < len(stages):
        scan_bound += list(stages[first_proj].exprs)
    else:
        scan_bound += list(node.group_exprs)
        scan_bound += [e for s in node.aggs
                       for e in (s.arg, s.filter) if e is not None]
    referenced: set[int] = set()
    for e in scan_bound:
        for sub in e.walk():
            if isinstance(sub, BoundColumn):
                referenced.add(sub.index)
    if len(referenced) >= len(names):
        return provider.full_batch(names)
    need = [names[i] for i in sorted(referenced)]
    fetched = provider.full_batch(need) if need else None
    n = fetched.num_rows if fetched is not None else provider.row_count()
    cols = []
    for i, c in enumerate(names):
        if i in referenced:
            cols.append(fetched.column(c))
        else:
            t = scan.types[i]
            cols.append(Column(
                t, np.broadcast_to(np.zeros(1, dtype=t.np_dtype), (n,)),
                None,
                np.asarray([""], dtype=object) if t.is_string else None))
    return Batch(list(names), cols)


# -- per-morsel partial states ----------------------------------------------
#
# Each morsel reduces to a tiny Batch: one row per (group seen in the
# morsel), key columns first (real Columns, so dictionary-encoded string
# keys merge through the normal concat machinery), then fixed-width state
# columns per aggregate.


#: combined slot-space cap for the direct (perfect-hash) key coding
_DIRECT_SPACE_CAP = 1 << 16


def _direct_key_plan(key_cols: list[Column]) -> Optional[list[tuple]]:
    """[(lo, range)] per key when every key direct-codes into a small
    slot space (dict codes / small-range ints), else None. Mirrors the
    device path's perfect-hash key coding (device_agg._plan_direct_keys)
    so the host morsel sink skips the composite lexsort entirely."""
    plan: list[tuple] = []
    space = 1
    for kc in key_cols:
        d = kc.data
        if kc.type.is_string and kc.dictionary is not None:
            lo, r = 0, len(kc.dictionary)
        elif d.dtype.kind in "iu":
            vd = d if kc.validity is None else d[kc.validity]
            if not len(vd):
                lo, r = 0, 0
            else:
                lo = int(vd.min())
                r = int(vd.max()) - lo + 1
        else:
            return None
        plan.append((lo, r))
        space *= r + 1          # one extra slot per key: NULL sorts last
        if space > _DIRECT_SPACE_CAP:
            return None
    return plan


def _direct_codes(key_cols: list[Column], plan: list[tuple],
                  ) -> tuple[np.ndarray, list[np.ndarray], np.ndarray, int]:
    """Dense group codes via direct slot coding — no sort. Slot order per
    key is (valid values ascending, NULL last), the exact composite order
    factorize_keys produces, so group order is identical either way."""
    n = len(key_cols[0].data)
    codes = np.zeros(n, dtype=np.int64)
    for kc, (lo, r) in zip(key_cols, plan):
        slot = kc.data.astype(np.int64) - lo
        if kc.validity is not None:
            slot = np.where(kc.validity, slot, r)
        codes = codes * (r + 1) + slot
    space = 1
    for _, r in plan:
        space *= r + 1
    occ = np.bincount(codes, minlength=space)
    present = np.flatnonzero(occ)
    remap = np.zeros(space, dtype=np.int64)
    remap[present] = np.arange(len(present))
    dense = remap[codes].astype(np.int32)
    uniq_vals: list[np.ndarray] = []
    valids: list[np.ndarray] = []
    rem = present.copy()
    for kc, (lo, r) in zip(reversed(key_cols), reversed(plan)):
        slot = rem % (r + 1)
        rem = rem // (r + 1)
        valid = slot != r
        vals = np.where(valid, slot + lo, 0).astype(kc.data.dtype)
        uniq_vals.append(vals)
        valids.append(valid)
    uniq_vals.reverse()
    valids.reverse()
    uniq_valid = np.stack(valids) if valids \
        else np.ones((0, len(present)), dtype=bool)
    return dense, uniq_vals, uniq_valid, len(present)


def _group_codes(key_cols: list[Column],
                 ) -> tuple[np.ndarray, list[np.ndarray], np.ndarray, int]:
    n = len(key_cols[0].data)
    if n:
        plan = _direct_key_plan(key_cols)
        if plan is not None:
            return _direct_codes(key_cols, plan)
    codes, uniq_vals, uniq_valid = factorize_keys(
        [c.data for c in key_cols],
        [c.validity for c in key_cols])
    g = len(uniq_vals[0]) if uniq_vals else 0
    return codes, uniq_vals, uniq_valid, g


def _morsel_partials(node, b: Batch) -> Batch:
    key_cols = [g.eval(b) for g in node.group_exprs]
    if key_cols:
        codes, uniq_vals, uniq_valid, g = _group_codes(key_cols)
    else:
        codes = np.zeros(b.num_rows, dtype=np.int32)
        uniq_vals, uniq_valid = [], np.ones((0, 1), dtype=bool)
        g = 1
    names: list[str] = []
    cols: list[Column] = []
    for k, kc in enumerate(key_cols):
        validity = uniq_valid[k] if uniq_valid.size else None
        if validity is not None and validity.all():
            validity = None
        names.append(f"#k{k}")
        cols.append(Column(kc.type, uniq_vals[k], validity, kc.dictionary))
    for j, spec in enumerate(node.aggs):
        for m, c in enumerate(_partial_state(spec, b, codes, g)):
            names.append(f"#s{j}_{m}")
            cols.append(c)
    return Batch(names, cols)


def _partial_state(spec: AggSpec, b: Batch, codes: np.ndarray,
                   g: int) -> list[Column]:
    if spec.filter is not None:
        c = spec.filter.eval(b)
        fm = c.data.astype(bool) & c.valid_mask()
        b = b.filter(fm)
        codes = codes[fm]
    if spec.func == "count_star":
        return [_i64(np.bincount(codes, minlength=g))]
    arg = spec.arg.eval(b)
    valid = arg.valid_mask()
    vc = codes[valid]
    cnt = np.bincount(vc, minlength=g).astype(np.int64)
    if spec.func == "count":
        return [_i64(cnt)]
    vals = arg.data[valid]
    empty = cnt == 0
    if spec.func in ("sum", "avg") or spec.func in _STDDEV:
        # keyed off the DECLARED result type: sum(bool) binds as DOUBLE
        # (BOOL is not is_integer), so its partials must be float or the
        # result batch would contradict the RowDescription type
        int_sum = spec.func == "sum" and spec.type.is_integer
        if int_sum:
            acc = np.zeros(g, dtype=np.int64)
            np.add.at(acc, vc, vals.astype(np.int64))
            return [_i64(acc), _i64(cnt)]
        s1 = np.zeros(g, dtype=np.float64)
        fv = vals.astype(np.float64)
        np.add.at(s1, vc, fv)
        if spec.func in _STDDEV:
            s2 = np.zeros(g, dtype=np.float64)
            np.add.at(s2, vc, fv * fv)
            return [_f64(s1), _f64(s2), _i64(cnt)]
        return [_f64(s1), _i64(cnt)]
    if spec.func in ("min", "max"):
        if arg.type.is_string:
            if arg.dictionary is None:
                raise _Fallback("string min/max without dictionary")
            # sorted dictionary ⇒ code order == string order; ship the
            # per-group champion as a real VARCHAR column so concat
            # re-encodes codes onto the merged dictionary
            ident = np.iinfo(np.int64).max if spec.func == "min" else -1
            acc = np.full(g, ident, dtype=np.int64)
            ufunc = np.minimum if spec.func == "min" else np.maximum
            ufunc.at(acc, vc, vals.astype(np.int64))
            acc = np.where(empty, 0, acc).astype(np.int32)
            return [Column(dt.VARCHAR, acc,
                           ~empty if empty.any() else None, arg.dictionary),
                    _i64(cnt)]
        if arg.type.is_float:
            if spec.func == "min":
                # PG float order: min skips NaN unless the group is
                # all-NaN — track has-non-NaN alongside (serial path's
                # np.fmin + has_non_nan stamp, decomposed)
                acc = np.full(g, np.inf, dtype=np.float64)
                with np.errstate(invalid="ignore"):
                    np.fmin.at(acc, vc, vals.astype(np.float64))
                nonnan = np.zeros(g, dtype=bool)
                np.logical_or.at(nonnan, vc, ~np.isnan(vals))
                return [_f64(acc), _i64(nonnan.astype(np.int64)),
                        _i64(cnt)]
            acc = np.full(g, -np.inf, dtype=np.float64)
            with np.errstate(invalid="ignore"):   # NaN propagation wanted
                np.maximum.at(acc, vc, vals.astype(np.float64))
            return [_f64(acc), _i64(cnt)]
        ident = np.iinfo(np.int64).max if spec.func == "min" else \
            np.iinfo(np.int64).min
        acc = np.full(g, ident, dtype=np.int64)
        ufunc = np.minimum if spec.func == "min" else np.maximum
        ufunc.at(acc, vc, vals.astype(np.int64))
        return [_i64(acc), _i64(cnt)]
    if spec.func in ("bool_and", "bool_or"):
        vb = vals.astype(bool)
        if spec.func == "bool_and":
            acc = np.ones(g, dtype=bool)
            np.logical_and.at(acc, vc, vb)
        else:
            acc = np.zeros(g, dtype=bool)
            np.logical_or.at(acc, vc, vb)
        return [Column(dt.BOOL, acc), _i64(cnt)]
    raise _Fallback(f"aggregate {spec.func}")


# -- vectorized relational tier (hash join / set ops / DISTINCT ON) ----------
#
# Shared key machinery for the operators above the scan: factorize
# composite keys from BOTH inputs into ONE dense int64 code space, then do
# all matching with array kernels — the batched-codes trick GPUSparse uses
# for accelerator-side postings intersection, applied host-side. The legacy
# row-tuple interpreters in plan.py stay as the parity oracle behind
# `SET serene_join_vectorized = off`.


def vectorized_enabled(settings) -> bool:
    try:
        return bool(settings.get("serene_join_vectorized"))
    except KeyError:  # pragma: no cover — registry always declares it
        return False


def combined_codes(cols_a: list[Column], cols_b: list[Column]
                   ) -> Optional[tuple[np.ndarray, np.ndarray, int]]:
    """Dense int64 codes over the CONCATENATION of two equal-arity column
    lists (a-rows first), in one shared code space: equal code ⟺ the
    legacy python row tuples would compare equal. Dictionary-encoded
    string pairs re-encode onto one merged dictionary first (code order
    is irrelevant here, only equality); numeric pairs concatenate under
    numpy promotion (int vs float keys compare by value, like python).
    Returns (codes_a, codes_b, num_codes), or None when a column pair
    has no sound array representation (mixed string/non-string keys,
    dictionary-less strings) — callers fall back to the row-tuple path.
    """
    if not cols_a or len(cols_a) != len(cols_b):
        return None
    arrays: list[np.ndarray] = []
    valids: list[Optional[np.ndarray]] = []
    for ca, cb in zip(cols_a, cols_b):
        if ca.type.is_string or cb.type.is_string:
            if not (ca.type.is_string and cb.type.is_string) or \
                    ca.dictionary is None or cb.dictionary is None:
                return None
            ma, mb = merge_dictionaries([ca, cb])
            data = np.concatenate([ma.data, mb.data])
        else:
            if ca.data.dtype.kind not in "biuf" or \
                    cb.data.dtype.kind not in "biuf":
                return None
            data = np.concatenate([ca.data, cb.data])
            if data.dtype.kind == "f":
                # an integer side promoted to float64 meets its partner
                # exactly only below 2**53 — python row tuples compare
                # int == float losslessly, so beyond that bound the
                # array path must defer to the oracle
                for side in (ca.data, cb.data):
                    if side.dtype.kind in "iu" and len(side) and \
                            (int(side.max()) > 2 ** 53 or
                             int(side.min()) < -(2 ** 53)):
                        return None
        if ca.validity is None and cb.validity is None:
            valid = None
        else:
            valid = np.concatenate([ca.valid_mask(), cb.valid_mask()])
        arrays.append(data)
        valids.append(valid)
    codes, g = factorize_codes(arrays, valids)
    na = len(cols_a[0])
    return codes[:na], codes[na:], g


def rows_valid(cols: list[Column]) -> Optional[np.ndarray]:
    """AND of the columns' validities (None ⇒ every row fully valid)."""
    valid: Optional[np.ndarray] = None
    for c in cols:
        if c.validity is not None:
            valid = c.validity if valid is None else (valid & c.validity)
    return valid


def first_occurrence_mask(codes: np.ndarray, g: int) -> np.ndarray:
    """True at the FIRST row of each code, in row order."""
    n = len(codes)
    first = np.full(g, n, dtype=np.int64)
    np.minimum.at(first, codes, np.arange(n, dtype=np.int64))
    return first[codes] == np.arange(n, dtype=np.int64)


def occurrence_ranks(codes: np.ndarray, g: int) -> np.ndarray:
    """0-based occurrence number of each row within its code, in row
    order (row i holding code c ranks k when it is the (k+1)-th row with
    c) — the vectorized form of the bag-semantics counters the legacy
    INTERSECT/EXCEPT ALL paths kept per row."""
    n = len(codes)
    order = np.argsort(codes, kind="stable")
    sorted_codes = codes[order]
    counts = np.bincount(codes, minlength=g)
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]]) \
        if g else np.zeros(0, dtype=np.int64)
    pos_sorted = np.arange(n, dtype=np.int64) - \
        np.repeat(group_start, counts) if n else \
        np.zeros(0, dtype=np.int64)
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = pos_sorted
    return ranks


_EMPTY_I64 = np.empty(0, dtype=np.int64)


def join_pairs(lkeys: list[Column], rkeys: list[Column], settings,
               nl: int, nr: int
               ) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Candidate (left, right) index pairs of the equi-join, vectorized.

    Build side (right): rows grouped by key code via one stable argsort +
    bincount prefix sums — a dense offset/payload index, no python dicts.
    Probe side (left): morsel tasks over the shared worker pool expand
    matches with repeat/cumsum arithmetic; partial pair vectors merge in
    MORSEL ORDER, so the pair stream is bit-identical to the serial scan
    at any worker count and exactly matches the legacy interpreter's
    (left row, right insertion order) emission. NULL keys never match
    (masked out per side, NOT grouped). None → caller uses the legacy
    row-tuple path.
    """
    if nl == 0 or nr == 0:
        return _EMPTY_I64, _EMPTY_I64
    pair = combined_codes(lkeys, rkeys)
    if pair is None:
        return None
    cl, cr, g = pair
    lvalid = rows_valid(lkeys)
    rvalid = rows_valid(rkeys)

    # build: right row ids grouped by code, plus per-code [offset, count)
    if rvalid is None:
        bidx = np.arange(nr, dtype=np.int64)
        crv = cr
    else:
        bidx = np.flatnonzero(rvalid).astype(np.int64)
        crv = cr[bidx]
    order = np.argsort(crv, kind="stable")
    sorted_right = bidx[order]
    counts = np.bincount(crv, minlength=g)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]) \
        if g else np.zeros(0, dtype=np.int64)

    def probe(span: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
        from .plan import check_cancel
        check_cancel()
        s, e = span
        if lvalid is None:
            pidx = np.arange(s, e, dtype=np.int64)
        else:
            pidx = np.flatnonzero(lvalid[s:e]).astype(np.int64) + s
        pc = cl[pidx]
        cnt = counts[pc]
        li = np.repeat(pidx, cnt)
        total = int(cnt.sum())
        if total == 0:
            return li, _EMPTY_I64
        cum = np.cumsum(cnt)
        within = np.arange(total, dtype=np.int64) - \
            np.repeat(cum - cnt, cnt)
        ri = sorted_right[np.repeat(offsets[pc], cnt) + within]
        return li, ri

    morsel_rows = int(settings.get("serene_morsel_rows"))
    spans = [(s, min(s + morsel_rows, nl))
             for s in range(0, nl, morsel_rows)]
    if nl > morsel_rows and \
            nl >= int(settings.get("serene_parallel_min_rows")):
        parts = parallel_map(settings, probe, spans)
    else:
        parts = [probe(sp) for sp in spans]
    li = np.concatenate([p[0] for p in parts])
    ri = np.concatenate([p[1] for p in parts])
    return li, ri


def _i64(a: np.ndarray) -> Column:
    return Column(dt.BIGINT, a.astype(np.int64))


def _f64(a: np.ndarray) -> Column:
    return Column(dt.DOUBLE, a.astype(np.float64))


_STATE_WIDTH = {"count_star": 1, "count": 1, "sum": 2, "avg": 2,
                "min": 2, "max": 2, "bool_and": 2, "bool_or": 2}


def _state_width(spec: AggSpec) -> int:
    if spec.func in _STDDEV:
        return 3
    if spec.func == "min" and spec.arg is not None and \
            spec.arg.type.is_float:
        return 3
    return _STATE_WIDTH[spec.func]


# -- merge sink --------------------------------------------------------------


def _merge_partials(node, partials: list[Batch]) -> Batch:
    nk = len(node.group_exprs)
    merged = concat_batches(partials)
    if nk:
        key_cols = merged.columns[:nk]
        codes, uniq_vals, uniq_valid = factorize_keys(
            [c.data for c in key_cols],
            [c.validity for c in key_cols])
        g = len(uniq_vals[0]) if uniq_vals else 0
    else:
        codes = np.zeros(merged.num_rows, dtype=np.int32)
        uniq_vals, uniq_valid = [], np.ones((0, 1), dtype=bool)
        g = 1
    out_cols: list[Column] = []
    for k in range(nk):
        kc = key_cols[k]
        validity = uniq_valid[k] if uniq_valid.size else None
        if validity is not None and validity.all():
            validity = None
        out_cols.append(Column(kc.type, uniq_vals[k], validity,
                               kc.dictionary))
    ci = nk
    for spec in node.aggs:
        w = _state_width(spec)
        out_cols.append(_combine(spec, merged.columns[ci:ci + w], codes, g))
        ci += w
    return Batch(list(node.names), out_cols)


def _combine(spec: AggSpec, states: list[Column], codes: np.ndarray,
             g: int) -> Column:
    if spec.func in ("count_star", "count"):
        acc = np.zeros(g, dtype=np.int64)
        np.add.at(acc, codes, states[0].data)
        return Column(dt.BIGINT, acc)
    cnt = np.zeros(g, dtype=np.int64)
    np.add.at(cnt, codes, states[-1].data)
    empty = cnt == 0
    validity = ~empty if empty.any() else None
    # value scatters only take partial rows that actually saw valid input
    live = states[-1].data > 0
    lc = codes[live]
    if spec.func == "sum":
        v = states[0]
        if v.data.dtype.kind == "i":
            acc = np.zeros(g, dtype=np.int64)
            np.add.at(acc, lc, v.data[live])
            return Column(dt.BIGINT, acc, validity)
        acc = np.zeros(g, dtype=np.float64)
        np.add.at(acc, lc, v.data[live])
        return Column(dt.DOUBLE, acc, validity)
    if spec.func == "avg":
        acc = np.zeros(g, dtype=np.float64)
        np.add.at(acc, lc, states[0].data[live])
        with np.errstate(invalid="ignore", divide="ignore"):
            data = acc / cnt
        return Column(dt.DOUBLE, np.where(empty, 0.0, data), validity)
    if spec.func in _STDDEV:
        pop = spec.func.endswith("_pop")
        s1 = np.zeros(g, dtype=np.float64)
        s2 = np.zeros(g, dtype=np.float64)
        np.add.at(s1, lc, states[0].data[live])
        np.add.at(s2, lc, states[1].data[live])
        fc = cnt.astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            var = (s2 - s1 * s1 / fc) / (fc if pop else fc - 1)
        var = np.maximum(var, 0.0)     # float cancellation clamp (PG)
        bad = cnt < (1 if pop else 2)
        data = np.sqrt(var) if spec.func.startswith("stddev") else var
        return Column(dt.DOUBLE, np.where(bad, 0.0, data),
                      ~bad if bad.any() else None)
    if spec.func in ("min", "max"):
        t = spec.arg.type
        if t.is_string:
            v = states[0]
            ident = np.iinfo(np.int64).max if spec.func == "min" else -1
            acc = np.full(g, ident, dtype=np.int64)
            ufunc = np.minimum if spec.func == "min" else np.maximum
            ufunc.at(acc, lc, v.data[live].astype(np.int64))
            acc = np.where(empty, 0, acc).astype(np.int32)
            return Column(dt.VARCHAR, acc, validity, v.dictionary)
        if t.is_float:
            if spec.func == "min":
                acc = np.full(g, np.inf, dtype=np.float64)
                # partial mins never hold NaN (fmin skips; all-NaN groups
                # hold the +inf identity) so plain minimum is exact here
                np.minimum.at(acc, lc, states[0].data[live])
                nonnan = np.zeros(g, dtype=bool)
                np.logical_or.at(nonnan, lc, states[1].data[live] > 0)
                acc = np.where(~empty & ~nonnan, np.nan, acc)
            else:
                acc = np.full(g, -np.inf, dtype=np.float64)
                with np.errstate(invalid="ignore"):
                    np.maximum.at(acc, lc, states[0].data[live])
            acc = np.where(empty, 0, acc).astype(t.np_dtype)
            return Column(t, acc, validity)
        ident = np.iinfo(np.int64).max if spec.func == "min" else \
            np.iinfo(np.int64).min
        acc = np.full(g, ident, dtype=np.int64)
        ufunc = np.minimum if spec.func == "min" else np.maximum
        ufunc.at(acc, lc, states[0].data[live])
        acc = np.where(empty, 0, acc).astype(t.np_dtype)
        return Column(t, acc, validity)
    if spec.func in ("bool_and", "bool_or"):
        v = states[0].data.astype(bool)
        if spec.func == "bool_and":
            acc = np.ones(g, dtype=bool)
            np.logical_and.at(acc, lc, v[live])
        else:
            acc = np.zeros(g, dtype=bool)
            np.logical_or.at(acc, lc, v[live])
        return Column(dt.BOOL, acc, validity)
    raise _Fallback(f"aggregate {spec.func}")
