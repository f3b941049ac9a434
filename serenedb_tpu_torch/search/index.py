"""Copied from serenedb_tpu/search/index.py (segment searchers built on
`device.current_device()`).

Index build: CREATE INDEX ... USING inverted backfill.

Reference analog: duckdb_physical_create_index.* (backfill scan feeding an
irs::IndexWriter; SURVEY.md §2.5). V1 builds one segment over the current
table contents; the storage layer adds incremental segments + WAL.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from .. import errors
from ..device import current_device
from ..utils import log, metrics
from .analysis import get_analyzer
from .searcher import MultiSearcher, SearchIndex, SegmentSearcher
# build_field_index stays re-exported: callers that want the serial
# oracle unconditionally (tests, parity harnesses) import it from here.
from .segment import build_field_index  # noqa: F401
from .segment import build_field_index_auto


@contextlib.contextmanager
def _span(name: str, **detail):
    """Record a segment_build/segment_merge span on the executing
    statement's timeline (read-repair inside a query) when one exists;
    maintenance-thread builds run outside any trace and skip it."""
    from ..obs.trace import current_trace
    tr = current_trace()
    if tr is None:
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        tr.add(name, "ingest", t0, time.perf_counter_ns(), **detail)


def _build_field(texts, an, settings=None):
    """One field-segment build: the parallel-chunk builder (bit-identical
    to serial), counted and traced."""
    metrics.SEGMENT_BUILDS.add()
    with _span("segment_build", docs=len(texts)):
        return build_field_index_auto(texts, an, settings)


class BtreeIndex:
    """Sorted-array point/range lookup index over one column (reference:
    `USING btree`/`secondary` DuckDB bound indexes, server_engine.cpp:
    290-299). Values sort as (dictionary codes | numerics); lookups are
    binary searches returning row ids."""

    def __init__(self, column: str, using: str, options: dict,
                 sort_vals, row_ids, data_version: int):
        self.column = column
        self.columns = (column,)
        self.using = using
        self.options = dict(options)
        self.sort_vals = sort_vals   # sorted values (codes for strings)
        self.row_ids = row_ids       # row id of each sorted value
        self.data_version = data_version
        self.analyzer_name = ""

    def lookup_eq(self, value) -> "np.ndarray":
        lo = np.searchsorted(self.sort_vals, value, side="left")
        hi = np.searchsorted(self.sort_vals, value, side="right")
        return np.sort(self.row_ids[lo:hi])

def build_btree_index(provider, column: str, using: str,
                      options: dict) -> BtreeIndex:
    col = provider.full_batch([column]).column(column)
    valid = col.valid_mask()
    rows = np.flatnonzero(valid)
    vals = col.data[rows]
    order = np.argsort(vals, kind="stable")
    return BtreeIndex(column, using, options, vals[order],
                      rows[order].astype(np.int64), provider.data_version)


_rebuild_guard = threading.Lock()


def _index_lock(provider) -> threading.Lock:
    """Per-provider rebuild lock (lazily attached) — read-repair rebuilds
    must not run concurrently (racy duplicate builds) or stamp a version
    that doesn't match the batch they were built from."""
    lk = getattr(provider, "_index_rebuild_lock", None)
    if lk is None:
        with _rebuild_guard:
            lk = getattr(provider, "_index_rebuild_lock", None)
            if lk is None:
                lk = threading.Lock()
                provider._index_rebuild_lock = lk
    return lk


def _repair(provider, name, idx, rebuild, force=False):
    """Read-repair `idx` under the provider's rebuild lock. The version is
    captured BEFORE the data is read: if a concurrent fast-path publish
    lands mid-build the new index carries the older stamp, so the next
    reader repairs again instead of trusting an index that may be missing
    the published rows (an index with EXTRA rows is harmless — those rows
    exist in the table). `force` rebuilds even at a current version — the
    maintenance ticker's merge-ladder leg compacts segment tiers whose
    data is perfectly fresh."""
    with _index_lock(provider):
        cur = provider.indexes.get(name, idx)
        if cur.data_version == provider.data_version and not force:
            return cur
        ver = provider.data_version
        new = rebuild(cur)
        new.data_version = ver
        provider.indexes[name] = new
        return new


def find_btree_index(provider, column: str):
    for name, idx in getattr(provider, "indexes", {}).items():
        if isinstance(idx, BtreeIndex) and idx.column == column:
            if idx.data_version != provider.data_version:
                idx = _repair(provider, name, idx,
                              lambda cur: build_btree_index(
                                  provider, cur.column, cur.using,
                                  cur.options))
            return idx
    return None


def build_index_for_table(provider, columns, using, options) -> SearchIndex:
    if using not in ("inverted", "btree", "secondary", "ivf", "maxsim",
                     "geo"):
        raise errors.unsupported(f"index type {using}")
    if using in ("btree", "secondary"):
        if len(columns) != 1:
            raise errors.unsupported("multi-column btree index")
        return build_btree_index(provider, columns[0], using, options)
    if using == "geo":
        if len(columns) != 1:
            raise errors.unsupported("geo index over multiple columns")
        return build_geo_index(provider, columns[0], options)
    analyzer_name = str(options.get("tokenizer", options.get("analyzer",
                                                             "text")))
    if using == "ivf":
        from .ivf import build_ivf_index
        if len(columns) != 1:
            raise errors.unsupported("ivf index over multiple columns")
        return build_ivf_index(provider, columns[0], options)
    if using == "maxsim":
        from .ivf import build_maxsim_index
        if len(columns) != 1:
            raise errors.unsupported("maxsim index over multiple columns")
        return build_maxsim_index(provider, columns[0], options)
    searchers = {}
    n_rows = provider.row_count()
    col_toks = options.get("column_tokenizers", {}) or {}
    if using == "inverted":
        for col_name in columns:
            an = get_analyzer(col_toks.get(col_name, analyzer_name))
            col = provider.full_batch([col_name]).column(col_name)
            if not col.type.is_string:
                raise errors.SqlError(
                    errors.DATATYPE_MISMATCH,
                    f'inverted index requires a text column, "{col_name}" '
                    f"is {col.type}")
            texts = col.to_pylist()
            fi = _build_field(texts, an)
            ms = MultiSearcher(an)
            ms.add_segment(
                SegmentSearcher(fi, an, len(texts), current_device()), 0)
            searchers[col_name] = ms
    return SearchIndex(list(columns), using, dict(options), analyzer_name,
                       searchers, provider.data_version,
                       mutation_epoch=getattr(provider, "mutation_epoch", 0),
                       indexed_rows=n_rows)


MAX_SEGMENTS = 8   # default merge-ladder threshold (serene_max_segments)


def _max_segments() -> int:
    from ..utils.config import REGISTRY
    try:
        return max(2, int(REGISTRY.get_global("serene_max_segments")))
    except KeyError:
        return MAX_SEGMENTS


def _background_merge() -> bool:
    from ..utils.config import REGISTRY
    try:
        return bool(REGISTRY.get_global("serene_background_merge"))
    except KeyError:
        return True


def _merge_tier(provider, col_name, an, segs: list, cap: int) -> list:
    """Tiered merge ladder over one field's [(SegmentSearcher, base)] list:
    while at/over the cap, rebuild the SMALLEST adjacent pair into one
    segment re-read from the provider's columnstore — O(run docs) per
    merge, never a full rebuild. Same epoch is a precondition (appends
    only), so stored rows [base, base+docs) still hold each segment's
    text."""
    segs = list(segs)
    col = None
    while len(segs) >= cap:
        sizes = [s.num_docs + segs[i + 1][0].num_docs
                 for i, (s, _) in enumerate(segs[:-1])]
        i = int(np.argmin(sizes))
        lo_base = segs[i][1]
        n_docs = segs[i][0].num_docs + segs[i + 1][0].num_docs
        if col is None:
            col = provider.full_batch([col_name]).column(col_name)
        texts = col.slice(lo_base, lo_base + n_docs).to_pylist()
        metrics.SEGMENT_MERGES.add()
        with _span("segment_merge", docs=n_docs, segments=2):
            fi = _build_field(texts, an)
        segs[i:i + 2] = [(SegmentSearcher(fi, an, n_docs, current_device()),
                          lo_base)]
    return segs


def refresh_index(provider, idx, *,
                  merge: bool = True) -> "SearchIndex | BtreeIndex":
    """Refresh one index (reference RefreshLoop leg). Inverted indexes:
    - rows appended since the last refresh → ONE new segment over the delta
      (O(new docs), the real-time path)
    - row mutations (delete/update/truncate) → full rebuild, with the
      reason logged (a silent compaction storm is undiagnosable)
    - at/over the segment cap → the tiered merge ladder compacts the
      smallest adjacent runs (replacing the old full-rebuild cliff).
      `merge=False` skips the ladder — the query-path read-repair leg
      under background maintenance, which pays only the bounded delta
      tail and leaves compaction to the maintenance ticker."""
    if idx.using == "ivf":
        # IVF has its own incremental leg: a pure append assigns only
        # the tail rows to the existing centroids (one new cluster-major
        # segment); everything else re-clusters with the reason logged
        from .ivf import refresh_ivf_index
        return refresh_ivf_index(provider, idx)
    if idx.using != "inverted":
        return build_index_for_table(provider, idx.columns, idx.using,
                                     idx.options)
    same_epoch = idx.mutation_epoch == getattr(provider, "mutation_epoch", 0)
    n_rows = provider.row_count()
    if not same_epoch or n_rows < idx.indexed_rows:
        reason = ("mutation epoch advanced (delete/update/truncate)"
                  if not same_epoch else
                  f"row count shrank ({n_rows} < {idx.indexed_rows}) "
                  "without an epoch bump (truncate/rollback)")
        log.info("maintenance",
                 f"full index rebuild on \"{provider.name}\" "
                 f"({', '.join(idx.columns)}): {reason}")
        return build_index_for_table(provider, idx.columns, idx.using,
                                     idx.options)
    col_toks = idx.options.get("column_tokenizers", {}) or {}
    base = idx.indexed_rows
    cap = _max_segments()
    # build-new-then-swap: assemble fresh MultiSearchers (reusing the old
    # immutable SegmentSearcher objects) and return a NEW SearchIndex the
    # caller publishes with one assignment — in-flight queries keep their
    # consistent snapshot, and a failure mid-build publishes nothing
    new_searchers = {}
    for col_name in idx.columns:
        an = get_analyzer(col_toks.get(col_name, idx.analyzer_name))
        segs = list(idx.searchers[col_name].segments)
        if n_rows > base:
            col = provider.full_batch([col_name]).column(col_name)
            delta = col.slice(base, n_rows).to_pylist()  # O(new docs)
            fi = _build_field(delta, an)
            segs.append((SegmentSearcher(fi, an, len(delta),
                                         current_device()), base))
        if merge and len(segs) >= cap:
            segs = _merge_tier(provider, col_name, an, segs, cap)
        ms = MultiSearcher(an)
        for seg, seg_base in segs:
            ms.add_segment(seg, seg_base)
        new_searchers[col_name] = ms
    return SearchIndex(list(idx.columns), idx.using, dict(idx.options),
                       idx.analyzer_name, new_searchers,
                       provider.data_version,
                       mutation_epoch=idx.mutation_epoch,
                       indexed_rows=n_rows)


def needs_merge(idx) -> bool:
    """True when an inverted index's segment tier is at/over the merge
    ladder's cap — the maintenance ticker's compaction trigger (data may
    be perfectly fresh; the ladder is about read amplification, not
    staleness)."""
    if getattr(idx, "using", "") != "inverted":
        return False
    searchers = getattr(idx, "searchers", None) or {}
    return max((len(ms.segments) for ms in searchers.values()),
               default=0) >= _max_segments()


def find_index(provider, column: str):
    """The inverted index covering `column`, or None. A stale index
    (data_version behind the provider) is refreshed IN PLACE before use —
    read-repair. Skipping it instead would silently fall back to a brute
    scan with the DEFAULT analyzer, diverging from the column's tokenizer
    (and the maintenance loop only narrows, never closes, that window)."""
    for name, idx in getattr(provider, "indexes", {}).items():
        if idx.using == "inverted" and column in idx.columns:
            if idx.data_version != provider.data_version:
                # under background maintenance the query path pays only
                # the bounded delta-tail build; the merge ladder runs on
                # the maintenance ticker (refresh_index merge=True there)
                fg = not _background_merge()
                idx = _repair(provider, name, idx,
                              lambda cur: refresh_index(provider, cur,
                                                        merge=fg))
            return idx
    return None


class GeoIndex:
    """Cell-term geo index over one geometry (text) column (reference:
    geo_filter_builder.cpp + iresearch GeoFilter — S2 cell terms; here
    the quadtree of geo/cells.py). Candidates come from posting lists
    keyed by packed cell ids; exact predicates post-verify them."""

    def __init__(self, column: str, options: dict, postings: dict,
                 n_rows: int, data_version: int):
        self.column = column
        self.columns = (column,)
        self.using = "geo"
        self.options = dict(options)
        self.postings = postings       # cell id -> np.int64 row ids
        self.indexed_rows = n_rows
        self.data_version = data_version
        self.analyzer_name = ""

    def candidates(self, probe_terms) -> np.ndarray:
        hits = [self.postings[t] for t in probe_terms
                if t in self.postings]
        if not hits:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(hits))


def build_geo_index(provider, column: str, options: dict) -> GeoIndex:
    from ..geo import cells as geo_cells
    from ..geo import shapes as geo_shapes
    col = provider.full_batch([column]).column(column)
    if not col.type.is_string:
        raise errors.SqlError(
            errors.DATATYPE_MISMATCH,
            f'geo index requires a geometry text column, "{column}" is '
            f"{col.type}")
    texts = col.to_pylist()
    valid = col.valid_mask()
    lists: dict = {}
    import re as _re
    point_rx = _re.compile(
        r"^\s*POINT\s*\(\s*(-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)\s+"
        r"(-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)\s*\)\s*$", _re.IGNORECASE)
    for i, t in enumerate(texts):
        if t is None or (valid is not None and not valid[i]):
            continue
        m = point_rx.match(t) if isinstance(t, str) else None
        if m:
            # fast path: POINT(x y) terms without a full WKT parse —
            # same scheme function as every other geometry
            terms = geo_cells.point_terms(float(m.group(1)),
                                          float(m.group(2)))
        else:
            # unparseable geometry FAILS the build (like a functional
            # index in PG): silently skipping the row would make index
            # presence flip the query outcome — the unindexed path
            # raises on that row, the indexed one would exclude it
            terms = geo_cells.geometry_terms(geo_shapes.parse_any(t))
        for term in terms:
            lists.setdefault(term, []).append(i)
    postings = {t: np.asarray(rs, dtype=np.int64)
                for t, rs in lists.items()}
    return GeoIndex(column, options, postings, len(texts),
                    provider.data_version)


def find_geo_index(provider, column: str):
    for name, idx in getattr(provider, "indexes", {}).items():
        if isinstance(idx, GeoIndex) and idx.column == column:
            if idx.data_version != provider.data_version:
                idx = _repair(provider, name, idx,
                              lambda cur: build_geo_index(
                                  provider, cur.column, cur.options))
            return idx
    return None
