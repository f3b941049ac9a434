"""Copied from serenedb_tpu/exec/zonemap.py.

Zone maps: per-morsel block statistics + predicate skip-scan.

Reference analog: ClickHouse-style granule pruning on the analytics side
and block-max WAND on the search side (ops/bm25.py) share one discipline —
consult per-block bounds before touching data, and never materialize a
block whose bounds prove it can't contribute. This module gives the
columnar scan paths that capability:

- **Block stats** (`column_zones`): per `serene_morsel_rows`-aligned block,
  min / max / null count (+ a has-NaN flag for floats) for numeric, date/
  timestamp, interval, bool, and dictionary-encoded string columns. Stats
  are built lazily per column, cached on the TableProvider, and
  version-stamped exactly like the device-column cache: any `data_version`
  bump invalidates, but a pure append (same `mutation_epoch`) only
  rebuilds the tail blocks — complete prefix blocks are reused because
  epoch-preserving operations never change existing row values. String
  min/max are stored DECODED (python str, the sorted-dictionary order) so
  append-time dictionary re-encodes can't stale them.

- **Interval analyzer** (`block_verdicts`): evaluates a conjunction of
  bound filter expressions against each block's stats to a three-state
  verdict — SKIP (no row can match), ALL (every row must match), SCAN
  (unknown). Internally each subexpression maps to the SET of row
  outcomes it can take on the block ({true, false, null} bitmask), so
  AND/OR/NOT compose with exact Kleene algebra and anything unsupported
  (expressions over columns, casts of columns, functions, subqueries)
  degrades to the safe "all outcomes possible" set. Comparisons follow
  the engine's PG float total order: NaN = NaN and NaN > everything.

- **Consumers**: exec/morsel.py never enqueues SKIP morsels and skips
  filter evaluation on ALL morsels; plan.ScanNode skip-scans filtered
  serial scans; exec/device_agg.py / device_topn.py shrink the padded
  device upload to the contiguous surviving block range; search_scan's
  stream mode drops candidate docs that fall in SKIP blocks.

`SET serene_zonemap = off` disables everything; `serene_zonemap_verify`
re-scans every pruned block and fails loudly if any row matched (the
structural guard the verify script arms over the parity suite).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column
from ..sql.binder import _CMP_CANON, comparison_parts
from ..sql.expr import BoundColumn, BoundExpr, BoundFunc, BoundLiteral
from ..utils import metrics

#: three-state block verdicts (ints so verdict vectors are numpy arrays)
SKIP, SCAN, ALL = 0, 1, 2

#: possible row outcomes of a predicate over a block, as a bitmask set
_T, _F, _N = 1, 2, 4
_TFN = _T | _F | _N

#: column type ids whose values zone-compare exactly: fixed-width scalars
#: ordered by their physical representation, plus sorted-dictionary
#: VARCHAR (decoded min/max compare in python-str order == code order).
#: ARRAY/RECORD share the dictionary representation but compare
#: field-wise, not text-wise — excluded.
_SUPPORTED = {dt.TypeId.BOOL, dt.TypeId.TINYINT, dt.TypeId.SMALLINT,
              dt.TypeId.INT, dt.TypeId.BIGINT, dt.TypeId.FLOAT,
              dt.TypeId.DOUBLE, dt.TypeId.DATE, dt.TypeId.TIMESTAMP,
              dt.TypeId.INTERVAL, dt.TypeId.VARCHAR}


def enabled(settings) -> bool:
    try:
        return bool(settings.get("serene_zonemap"))
    except KeyError:  # pragma: no cover — registry always declares it
        return False


def verify_enabled(settings) -> bool:
    try:
        return bool(settings.get("serene_zonemap_verify"))
    except KeyError:  # pragma: no cover
        return False


def join_filter_enabled(settings) -> bool:
    try:
        return bool(settings.get("serene_join_filter"))
    except KeyError:  # pragma: no cover
        return False


# -- per-column block statistics --------------------------------------------


@dataclass
class ColumnZones:
    """Block stats for one column at one block size. mins/maxs hold
    DECODED python values (str for VARCHAR, int/float/bool otherwise);
    None marks a block with no valid non-NaN value."""

    type: dt.SqlType
    block_rows: int
    nrows: int
    mins: list
    maxs: list
    nulls: np.ndarray     # int64 per block: invalid rows
    counts: np.ndarray    # int64 per block: total rows
    nans: np.ndarray      # bool per block: any NaN among valid (floats)

    @property
    def n_blocks(self) -> int:
        return len(self.mins)


def _build_blocks(col: Column, block_rows: int, start_row: int,
                  nrows: int) -> tuple[list, list, list, list, list]:
    """Stats for blocks covering [start_row, nrows) (start block-aligned)."""
    mins, maxs, nulls, counts, nans = [], [], [], [], []
    is_str = col.type.id is dt.TypeId.VARCHAR
    is_float = col.data.dtype.kind == "f"
    for s in range(start_row, nrows, block_rows):
        e = min(s + block_rows, nrows)
        data = col.data[s:e]
        if col.validity is None:
            valid_n = e - s
            vals = data
        else:
            v = col.validity[s:e]
            valid_n = int(v.sum())
            vals = data[v]
        counts.append(e - s)
        nulls.append((e - s) - valid_n)
        has_nan = False
        mn = mx = None
        if valid_n:
            if is_float:
                nan = np.isnan(vals)
                has_nan = bool(nan.any())
                vv = vals[~nan] if has_nan else vals
                if len(vv):
                    mn, mx = vv.min().item(), vv.max().item()
            elif is_str:
                d = col.dictionary
                mn = str(d[int(vals.min())])
                mx = str(d[int(vals.max())])
            else:
                mn, mx = vals.min().item(), vals.max().item()
        mins.append(mn)
        maxs.append(mx)
        nans.append(has_nan)
    return mins, maxs, nulls, counts, nans


_cache_guard = threading.Lock()

#: bound on cached (column, block_rows) entries per provider
_CACHE_CAP = 64


def _zone_lock(provider) -> threading.Lock:
    lk = getattr(provider, "_zonemap_lock", None)
    if lk is None:
        with _cache_guard:
            lk = getattr(provider, "_zonemap_lock", None)
            if lk is None:
                lk = threading.Lock()
                provider._zonemap_lock = lk
    return lk


def column_zones(provider, name: str, block_rows: int,
                 pin=None) -> Optional[ColumnZones]:
    """Version-stamped block stats for one column, cached on the
    provider. `pin` is the caller's (batch, data_version, mutation_epoch)
    publication observation (tables.TableProvider.try_pin); stats are
    built from — and stamped with — that same observation so a racing
    publish can never pair stale stats with fresh data. Returns None for
    unsupported column types (dictionary-less strings included)."""
    if pin is not None:
        batch, ver, epoch = pin[0], pin[1], pin[2]
    else:
        batch = None
        ver = provider.data_version
        epoch = getattr(provider, "mutation_epoch", 0)
    lock = _zone_lock(provider)
    key = (name, block_rows)
    # the column's schema POSITION is part of the cache identity.
    # Column-identity ALTERs (drop/rename) bump mutation_epoch today, so
    # the epoch check alone already rejects them — the position check is
    # defense in depth: if a future change makes some schema ALTER
    # epoch-preserving again, a name moving to a different position
    # still forces a rebuild instead of silently reusing stale stats
    try:
        names = list(batch.names) if batch is not None \
            else list(provider.column_names)
        col_pos = names.index(name)
    except ValueError:
        return None
    with lock:
        cache = getattr(provider, "_zonemap_cache", None)
        if cache is None:
            cache = provider._zonemap_cache = {}
        entry = cache.get(key)
        if entry is not None and entry[0] == ver and entry[2] == col_pos:
            return entry[3]
    try:
        col = (batch.column(name) if batch is not None
               else provider.full_batch([name]).column(name))
    except Exception:   # column dropped/renamed under the plan
        return None
    if col.type.id not in _SUPPORTED or \
            (col.type.id is dt.TypeId.VARCHAR and col.dictionary is None):
        return None
    nrows = len(col)
    old: Optional[ColumnZones] = None
    if entry is not None:
        old = entry[3]
        if old is not None and entry[1] == epoch and entry[2] == col_pos \
                and old.type == col.type \
                and old.block_rows == block_rows and nrows >= old.nrows:
            # pure append: existing row values are unchanged (epoch
            # semantics), so complete prefix blocks carry over verbatim
            # and only the tail rebuilds
            keep = old.nrows // block_rows
            m, x, nu, cn, na = _build_blocks(col, block_rows,
                                             keep * block_rows, nrows)
            zones = ColumnZones(
                col.type, block_rows, nrows,
                old.mins[:keep] + m, old.maxs[:keep] + x,
                np.concatenate([old.nulls[:keep],
                                np.asarray(nu, dtype=np.int64)]),
                np.concatenate([old.counts[:keep],
                                np.asarray(cn, dtype=np.int64)]),
                np.concatenate([old.nans[:keep],
                                np.asarray(na, dtype=bool)]))
            with lock:
                cache[key] = (ver, epoch, col_pos, zones)
            return zones
        metrics.ZONEMAP_STALE_REBUILDS.add()
    m, x, nu, cn, na = _build_blocks(col, block_rows, 0, nrows)
    zones = ColumnZones(col.type, block_rows, nrows, m, x,
                        np.asarray(nu, dtype=np.int64),
                        np.asarray(cn, dtype=np.int64),
                        np.asarray(na, dtype=bool))
    with lock:
        if len(cache) >= _CACHE_CAP:
            cache.pop(next(iter(cache)))
        cache[key] = (ver, epoch, col_pos, zones)
    return zones


# -- interval analyzer -------------------------------------------------------
#
# A predicate over one block maps to the SET of outcomes its rows can take
# ({true, false, null} bitmask). Leaves derive their set from block stats;
# AND/OR/NOT combine sets with exact Kleene algebra over the cross product
# (sound over-approximation: children share rows, so the true outcome set
# is a subset of the combination set). Unknown shapes yield {T,F,N}.

def _and3(x: int, y: int) -> int:
    if x == _F or y == _F:
        return _F
    if x == _N or y == _N:
        return _N
    return _T


def _or3(x: int, y: int) -> int:
    if x == _T or y == _T:
        return _T
    if x == _N or y == _N:
        return _N
    return _F


def _combine(a: int, b: int, op3) -> int:
    out = 0
    for x in (_T, _F, _N):
        if not a & x:
            continue
        for y in (_T, _F, _N):
            if b & y:
                out |= op3(x, y)
    return out


def _not_set(a: int) -> int:
    out = a & _N
    if a & _T:
        out |= _F
    if a & _F:
        out |= _T
    return out


def _cmp_set(op: str, zones: ColumnZones, b: int, const) -> int:
    """Outcome set of `column <op> const` over block b."""
    nulls = int(zones.nulls[b])
    nvalid = int(zones.counts[b]) - nulls
    s = _N if nulls else 0
    if nvalid == 0:
        return s or _N      # empty block degenerates to "no rows": N only
    if const is None:
        return s | _N       # strict comparison with NULL is NULL per row
    mn, mx = zones.mins[b], zones.maxs[b]
    has_nan = bool(zones.nans[b])
    has_range = mn is not None
    if zones.type.id is dt.TypeId.VARCHAR:
        if not isinstance(const, str):
            return _TFN
        c = const
    else:
        if isinstance(const, str):
            return _TFN
        c = const
    c_nan = isinstance(c, float) and c != c
    t = f = False
    if c_nan:
        # PG float total order: NaN = NaN and NaN is the greatest value
        if op == "=":
            t, f = has_nan, has_range
        elif op == "<>":
            t, f = has_range, has_nan
        elif op == "<":
            t, f = has_range, has_nan
        elif op == "<=":
            t, f = True, False
        elif op == ">":
            t, f = False, True
        else:                # >=
            t, f = has_nan, has_range
    else:
        if op == "=":
            t = has_range and mn <= c <= mx
            f = has_nan or (has_range and not (mn == c == mx))
        elif op == "<>":
            t = has_nan or (has_range and not (mn == c == mx))
            f = has_range and mn <= c <= mx
        elif op == "<":
            t = has_range and mn < c
            f = has_nan or (has_range and mx >= c)
        elif op == "<=":
            t = has_range and mn <= c
            f = has_nan or (has_range and mx > c)
        elif op == ">":
            t = has_nan or (has_range and mx > c)
            f = has_range and mn <= c
        else:                # >=
            t = has_nan or (has_range and mx >= c)
            f = has_range and mn < c
    if t:
        s |= _T
    if f:
        s |= _F
    return s


class _Analyzer:
    """Compiled once per predicate list; evaluated per block. `zones_of`
    maps a scan column index to its ColumnZones (or None)."""

    def __init__(self, exprs: list[BoundExpr],
                 zones_of: Callable[[int], Optional[ColumnZones]]):
        self.exprs = exprs
        self.zones_of = zones_of
        #: comparison leaves fold their constant side ONCE per query —
        #: re-folding per block would rebuild a dummy batch and re-eval
        #: the constant expression once per block for nothing
        self._parts: dict[int, Optional[tuple]] = {}
        self.prunable = any(self._has_prunable_leaf(e) for e in exprs)

    def _parts_of(self, e: BoundFunc) -> Optional[tuple]:
        k = id(e)
        if k not in self._parts:
            self._parts[k] = comparison_parts(e)
        return self._parts[k]

    def _has_prunable_leaf(self, e: BoundExpr) -> bool:
        for sub in e.walk():
            if isinstance(sub, BoundFunc):
                if sub.name in _CMP_CANON:
                    parts = self._parts_of(sub)
                    if parts is not None and \
                            self.zones_of(parts[0]) is not None:
                        return True
                if sub.name in ("is_null", "is_not_null") and \
                        isinstance(sub.args[0], BoundColumn) and \
                        self.zones_of(sub.args[0].index) is not None:
                    return True
        return False

    def outcome_set(self, e: BoundExpr, b: int) -> int:
        if isinstance(e, BoundLiteral):
            if e.value is None:
                return _N
            if isinstance(e.value, bool):
                return _T if e.value else _F
            return _TFN
        if not isinstance(e, BoundFunc):
            return _TFN
        name = e.name
        if name == "and":
            s = _T
            for a in e.args:
                s = _combine(s, self.outcome_set(a, b), _and3)
            return s
        if name == "or":
            s = _F
            for a in e.args:
                s = _combine(s, self.outcome_set(a, b), _or3)
            return s
        if name == "opnot" or name == "not":
            if len(e.args) == 1:
                return _not_set(self.outcome_set(e.args[0], b))
            return _TFN
        if name in ("is_null", "is_not_null") and len(e.args) == 1 and \
                isinstance(e.args[0], BoundColumn):
            zones = self.zones_of(e.args[0].index)
            if zones is None:
                return _TFN
            nulls = int(zones.nulls[b])
            total = int(zones.counts[b])
            has_null, has_val = nulls > 0, nulls < total
            if name == "is_not_null":
                has_null, has_val = has_val, has_null
            return (_T if has_null else 0) | (_F if has_val else 0) or _N
        if name in _CMP_CANON:
            parts = self._parts_of(e)
            if parts is None:
                return _TFN
            ci, op, const = parts
            zones = self.zones_of(ci)
            if zones is None:
                return _TFN
            return _cmp_set(op, zones, b, const)
        return _TFN

    def verdict(self, b: int) -> int:
        s = _T
        for e in self.exprs:
            s = _combine(s, self.outcome_set(e, b), _and3)
            if not s & _T:
                return SKIP
        return ALL if s == _T else SCAN


def block_verdicts(provider, settings, exprs: list[BoundExpr],
                   columns: list[str], block_rows: int,
                   pin=None) -> Optional[np.ndarray]:
    """Per-block verdict vector (SKIP/SCAN/ALL) for the conjunction of
    `exprs` over a scan of `columns`, or None when zone maps can't help
    (disabled, single block, no prunable conjunct, provider without
    row_count). BoundColumn indices in `exprs` index into `columns`."""
    if not exprs or not enabled(settings):
        return None
    try:
        nrows = pin[0].num_rows if pin is not None else provider.row_count()
    except NotImplementedError:
        return None
    if nrows <= block_rows:
        return None
    zcache: dict[int, Optional[ColumnZones]] = {}

    def zones_of(ci: int) -> Optional[ColumnZones]:
        if ci not in zcache:
            if 0 <= ci < len(columns):
                zcache[ci] = column_zones(provider, columns[ci],
                                          block_rows, pin)
            else:
                zcache[ci] = None
        return zcache[ci]

    az = _Analyzer(exprs, zones_of)
    if not az.prunable:
        return None
    n_blocks = (nrows + block_rows - 1) // block_rows
    # a concurrent append can leave cached zones one (rebuilt) call away
    # from the pinned row count; zones_of built from the same pin, so the
    # block counts always agree with nrows here
    out = np.empty(n_blocks, dtype=np.int8)
    for b in range(n_blocks):
        out[b] = az.verdict(b)
    return out


def count_pruned(verdicts: np.ndarray) -> None:
    """Bump the sdb_metrics counters for one pruned scan."""
    pruned = int((verdicts == SKIP).sum())
    if pruned:
        metrics.ZONEMAP_PRUNED.add(pruned)
    scanned = len(verdicts) - pruned
    if scanned:
        metrics.ZONEMAP_SCANNED.add(scanned)


def count_join_filter(verdicts: np.ndarray) -> None:
    """Bump the join-filter sideways-pushdown counters (verdicts from the
    published build-key range alone, so pruning is attributed exactly)."""
    pruned = int((verdicts == SKIP).sum())
    if pruned:
        metrics.JOIN_FILTER_PRUNED.add(pruned)
    scanned = len(verdicts) - pruned
    if scanned:
        metrics.JOIN_FILTER_SCANNED.add(scanned)


def combine_verdicts(a: Optional[np.ndarray],
                     b: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Conjunction of two per-block verdict vectors. SKIP < SCAN < ALL by
    value, and conjunction is exactly the minimum: SKIP if either side
    skips, ALL iff both prove every row matches."""
    if a is None:
        return b
    if b is None:
        return a
    return np.minimum(a, b)


#: key column families the join filter can publish a range for: the
#: range literal must both zone-compare (exec/zonemap._cmp_set) and
#: evaluate through the engine's comparison kernels in verify mode
_JF_RANGEABLE = {dt.TypeId.BOOL, dt.TypeId.TINYINT, dt.TypeId.SMALLINT,
                 dt.TypeId.INT, dt.TypeId.BIGINT, dt.TypeId.FLOAT,
                 dt.TypeId.DOUBLE, dt.TypeId.DATE, dt.TypeId.TIMESTAMP,
                 dt.TypeId.VARCHAR}


def build_key_range_exprs(probe_keys, build_key_cols) -> list[BoundExpr]:
    """Min/max sideways information passing (the SereneDB/DuckDB join
    filter): for every equi-key whose probe side is a bare scan column,
    fold the build side's observed key range into two synthetic
    comparison conjuncts `col >= lo AND col <= hi`, bound with the same
    scalar kernels the binder would use. The exprs feed `block_verdicts`
    on the probe scan, so morsels whose block stats can't overlap the
    build keys are never enqueued — and `serene_zonemap_verify` re-scans
    them structurally like any other pruned block.

    NULL and NaN build keys never find a partner (row-tuple semantics),
    so they are excluded from the published range; probe blocks that are
    all-NULL or all-NaN on the key prune as a consequence. Returns []
    when no key is rangeable (caller scans normally)."""
    from ..functions import scalar as fnlib

    exprs: list[BoundExpr] = []
    for pk, kc in zip(probe_keys, build_key_cols):
        if not isinstance(pk, BoundColumn) or \
                pk.type.id not in _JF_RANGEABLE or \
                kc.type.id not in _JF_RANGEABLE:
            continue
        valid = kc.valid_mask()
        if kc.type.is_string:
            if kc.dictionary is None:
                continue
            vals = kc.data[valid]
            if not len(vals):
                continue
            lo = str(kc.dictionary[int(vals.min())])
            hi = str(kc.dictionary[int(vals.max())])
            lit_t = dt.VARCHAR
        else:
            vals = kc.data[valid]
            if vals.dtype.kind == "f":
                vals = vals[~np.isnan(vals)]
            if not len(vals):
                continue
            lo, hi = vals.min().item(), vals.max().item()
            if vals.dtype.kind == "f":
                lit_t = dt.DOUBLE
            elif kc.type.id in (dt.TypeId.DATE, dt.TypeId.TIMESTAMP):
                lit_t = kc.type
            elif kc.type.id is dt.TypeId.BOOL:
                lit_t = dt.BOOL
            else:
                lit_t = dt.BIGINT
        try:
            pair = []
            for op, v in (("op>=", lo), ("op<=", hi)):
                res = fnlib.resolve(op, [pk.type, lit_t])

                def impl(cols, batch, _impl=res.impl):
                    return _impl(cols, batch.num_rows)

                pair.append(BoundFunc(
                    op, [BoundColumn(pk.index, pk.type, pk.name),
                         BoundLiteral(v, lit_t)], dt.BOOL, impl))
        except errors.SqlError:
            continue          # no comparison kernel for this type pair
        exprs.extend(pair)
    return exprs


def surviving_range(verdicts: np.ndarray, block_rows: int,
                    nrows: int) -> tuple[int, int]:
    """Row range [lo, hi) covering every non-SKIP block (contiguous
    envelope — interior SKIP blocks stay, prefix/suffix prune). lo == hi
    when everything is pruned. lo is always block-aligned (and therefore
    a multiple of 128: serene_morsel_rows is floored at 1024)."""
    alive = np.flatnonzero(verdicts != SKIP)
    if not len(alive):
        return 0, 0
    lo = int(alive[0]) * block_rows
    hi = min((int(alive[-1]) + 1) * block_rows, nrows)
    return lo, hi


# -- verification (debug assert mode) ---------------------------------------


def verify_pruned_blocks(exprs: list[BoundExpr], full: Batch,
                         spans: list[tuple[int, int]], what: str) -> None:
    """serene_zonemap_verify: re-scan pruned blocks with the REAL filter
    and fail loudly if any row matched — stats/data divergence must
    surface structurally, never as silently wrong results."""
    for s, e in spans:
        b = full.slice(s, e)
        mask = np.ones(b.num_rows, dtype=bool)
        for ex in exprs:
            c = ex.eval(b)
            mask &= c.data.astype(bool) & c.valid_mask()
            if not mask.any():
                break
        if mask.any():
            raise AssertionError(
                f"serene_zonemap_verify: zone map pruned a matching "
                f"morsel in {what} (rows {s}..{e}: "
                f"{int(mask.sum())} matching rows) — block statistics "
                f"diverged from table data")


# -- top-N candidate range ---------------------------------------------------


def topn_block_range(provider, settings, name: str, block_rows: int,
                     desc: bool, k: int, pin=None
                     ) -> Optional[tuple[int, int]]:
    """Row range [lo, hi) that provably contains every top-k candidate
    for ORDER BY name [DESC] LIMIT k, from block bounds alone: take
    blocks in best-block-WORST-value order until they cover k rows — the
    k-th best value is then at least that threshold, so any block whose
    best value is strictly beyond it cannot contribute. Assumes the
    caller already rejected NULLs and NaNs (device_topn's gates). None
    when nothing prunes."""
    if not enabled(settings):
        return None
    zones = column_zones(provider, name, block_rows, pin)
    if zones is None or zones.n_blocks <= 1 or zones.nans.any() or \
            int(zones.nulls.sum()):
        return None
    mins = zones.mins
    maxs = zones.maxs
    nb = zones.n_blocks
    if any(m is None for m in mins):
        return None
    # worst value still inside block b for the sort direction
    worst = mins if desc else maxs
    best = maxs if desc else mins
    order = sorted(range(nb), key=lambda b: worst[b], reverse=desc)
    covered = 0
    thresh = None
    for b in order:
        thresh = worst[b]
        covered += int(zones.counts[b])
        if covered >= k:
            break
    if covered < k:
        return None          # fewer rows than k: nothing to prune
    if desc:
        alive = [b for b in range(nb) if best[b] >= thresh]
    else:
        alive = [b for b in range(nb) if best[b] <= thresh]
    if len(alive) == nb:
        return None
    lo = alive[0] * block_rows
    hi = min((alive[-1] + 1) * block_rows, zones.nrows)
    if hi - lo >= zones.nrows:
        return None
    metrics.ZONEMAP_PRUNED.add(nb - (alive[-1] - alive[0] + 1))
    metrics.ZONEMAP_SCANNED.add(alive[-1] - alive[0] + 1)
    return lo, hi
