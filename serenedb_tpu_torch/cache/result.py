"""Copied from serenedb_tpu/cache/result.py.

Tier 1: whole-statement result cache with publication-keyed
invalidation.

Reference analog: the reused whole-request results a search engine
serves repeated dashboard traffic from. A read-only statement whose
plan touches only IMMUTABLE expressions (functions/volatility.py) and
catalog tables is keyed by everything its result is a function of:

    (statement digest,             canonical AST repr — distinguishes
                                   literal values and statements that
                                   share one multi-statement text
     bound parameter values,
     result-affecting settings digest,
     sorted per-table publication tuples)

where a publication tuple is (catalog key, publication token,
data_version, mutation_epoch) — the token is a process-unique id
attached to the provider, so a DROP + CREATE of a same-named table can
never collide with the old generation's entries.

Invalidation proof sketch: the executor pins each table's publication
atomically (MemTable._pub); versions are monotone. The probe observes
every table's publication BEFORE execution and again AFTER — the entry
is stored only when both observations are equal, so the cached batch is
exactly the result of evaluating the statement against the keyed
publications. A later lookup builds its key from the CURRENT
publications; any interleaved write bumped a version, the keys differ,
and the stale entry is unreachable forever (a lazy sweep reclaims its
bytes). Therefore a hit returns bit-identical data to a fresh
execution, at any `serene_workers`, and a write between two identical
statements always surfaces fresh data.

The statement → table-set map learned at store time powers a fast path
that skips parse-free replanning entirely on repeat traffic: resolve
the remembered catalog keys, re-check ACLs, observe publications, and
serve. Any resolution hiccup (rename, drop, revoke, new generation)
falls back to the full plan path.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import weakref
from collections import OrderedDict
from typing import Optional

from ..functions.volatility import IMMUTABLE, volatility
from ..utils import metrics
from ..utils.config import REGISTRY as _settings_registry
from .lru import BytesLRU

#: session settings whose value changes what a result CONTAINS (device
#: summation order, ANN probe counts, scored-term expansion caps) — part
#: of the key, so two sessions with different knobs never share entries.
#: serene_search_batch is deliberately ABSENT: the search batcher's
#: contract is per-query bit-identity with serial dispatch (scores, doc
#: ids, tie order — enforced by the tests/test_search_batch.py parity
#: matrix and the verify_tier1.sh SERENE_SEARCH_BATCH=off pass), so
#: keying on it would only split the cache between identical entries.
#: serene_shards is deliberately ABSENT for the same reason: the
#: sharded execution tier's contract is bit-identity with shards=1 at
#: any worker/device count (the tests/test_shard_exec.py parity matrix
#: and the verify_tier1.sh SERENE_SHARDS=4 pass enforce it), so keying
#: on it would only split the cache between identical entries.
RESULT_AFFECTING_SETTINGS = (
    "serene_device", "serene_device_min_rows", "serene_device_chunk_rows",
    "serene_device_fused", "serene_mesh", "sdb_nprobe", "sdb_rerank_factor",
    "sdb_scored_terms_limit", "search_path",
    # serene_nprobe (and its compat alias sdb_nprobe above) changes
    # which rows a knn RETURNS — more probes, higher recall; and
    # serene_maxsim switches vec_maxsim between f32 device scoring and
    # the f64 host oracle, which can reorder near-tied docs
    "serene_nprobe", "serene_maxsim",
)
assert "serene_search_batch" not in RESULT_AFFECTING_SETTINGS
assert "serene_shards" not in RESULT_AFFECTING_SETTINGS
# serene_shard_combine picks WHERE the cross-shard combine runs (one
# in-program shard_map dispatch with psum/pmin/pmax vs per-shard
# dispatches with the host integer combine) — every accumulator is an
# integer add or min/max selection, exact in any reduction order, so
# device and host combines are bit-identical by construction (the
# tests/test_multichip.py parity matrix and the verify_tier1.sh
# SERENE_SHARD_COMBINE=device pass enforce it)
assert "serene_shard_combine" not in RESULT_AFFECTING_SETTINGS
# tracing observes, never steers (obs/trace.py): results are
# bit-identical with the timeline layer on or off, so a cached entry is
# valid across either setting
assert "serene_trace" not in RESULT_AFFECTING_SETTINGS
assert "serene_profile" not in RESULT_AFFECTING_SETTINGS
# memory accounting observes too (obs/resources.py): charge/release
# events never steer execution, so a cached entry is valid whether the
# statement that stored it was accounted or not
assert "serene_mem_account" not in RESULT_AFFECTING_SETTINGS
# the workload governor (sched/governor.py) steers WHEN statements run,
# never what they return: admission order, fair-share picking and
# priorities change scheduling only (the deterministic merge sinks
# guarantee bit-identity), and the budget/timeout settings produce
# ERRORS, not results — an aborted statement stores nothing, so no
# cached entry can ever encode a budget's effect
# device telemetry observes too (obs/device.py): the compile ledger /
# transfer accounting never change which program runs, and the bounded
# program LRU can only cause a re-compile of the SAME program — results
# are bit-identical with telemetry on or off at any cache cap
assert "serene_device_telemetry" not in RESULT_AFFECTING_SETTINGS
assert "serene_program_cache_entries" not in RESULT_AFFECTING_SETTINGS
assert "serene_max_concurrent_statements" not in RESULT_AFFECTING_SETTINGS
assert "serene_admission_queue_depth" not in RESULT_AFFECTING_SETTINGS
assert "serene_fair_share" not in RESULT_AFFECTING_SETTINGS
assert "serene_priority" not in RESULT_AFFECTING_SETTINGS
assert "serene_work_mem" not in RESULT_AFFECTING_SETTINGS
assert "serene_statement_timeout_ms" not in RESULT_AFFECTING_SETTINGS
# the streaming-ingest tier is bit-identical by contract: the parallel
# analysis merge reproduces the serial segment byte for byte, group-commit
# windows only coalesce WHEN publications land (every statement still
# fsyncs before returning), and background vs foreground maintenance only
# changes the segment LAYOUT — scores use global collection stats, so any
# layout returns identical results (tests/test_ingest_stream.py parity
# matrix and the verify_tier1.sh pass 17 enforce all three)
assert "serene_parallel_ingest" not in RESULT_AFFECTING_SETTINGS
assert "serene_ingest_chunk_docs" not in RESULT_AFFECTING_SETTINGS
assert "serene_group_commit" not in RESULT_AFFECTING_SETTINGS
assert "serene_background_merge" not in RESULT_AFFECTING_SETTINGS
# the vector pool only moves WHERE the probe program reads vectors from
# (paged HBM region vs a per-call cold commit of the same cluster-major
# layout); the distance chain is association-fixed in the graph, so
# resident and cold dispatches are bit-identical at any page budget
# (tests/test_vector_store.py pool on/off parity and the verify_tier1.sh
# pass 18 starvation leg enforce it) — unlike serene_nprobe/serene_maxsim
# above, which DO change results and ARE in the digest
assert "serene_vector_pool" not in RESULT_AFFECTING_SETTINGS
assert "serene_vector_pages" not in RESULT_AFFECTING_SETTINGS
assert "serene_nprobe" in RESULT_AFFECTING_SETTINGS
assert "serene_maxsim" in RESULT_AFFECTING_SETTINGS
assert "serene_max_segments" not in RESULT_AFFECTING_SETTINGS

#: remember the table set of at most this many distinct statements for
#: the plan-skipping fast path
_STMT_MAP_CAP = 4096

_token_counter = itertools.count(1)
_token_lock = threading.Lock()


def _provider_token(provider) -> int:
    """Process-unique publication token, lazily attached. Distinguishes
    generations: a recreated table starts a fresh token, so its
    (version 0, epoch 0) can never alias the old table's entries."""
    tok = getattr(provider, "_cache_token", None)
    if tok is None:
        with _token_lock:
            tok = getattr(provider, "_cache_token", None)
            if tok is None:
                tok = next(_token_counter)
                provider._cache_token = tok
    return tok


def _observe(provider) -> tuple:
    pin = provider.try_pin()
    if pin is not None:
        return (_provider_token(provider), pin[1], pin[2])
    return (_provider_token(provider),
            getattr(provider, "data_version", 0),
            getattr(provider, "mutation_epoch", 0))


def _detach_batch(batch):
    """Copy any column array that is a VIEW into a larger base array.
    A cached `... LIMIT 5` result sliced from a 6M-row table would
    otherwise pin the whole base array while its accounted size says a
    few hundred bytes — the cache must own exactly the bytes it
    accounts for. Non-view columns (aggregate outputs, fresh arrays)
    are stored as-is."""
    import numpy as np

    from ..columnar.column import Batch, Column
    cols = []
    changed = False
    for c in batch.columns:
        data, validity = c.data, c.validity
        if isinstance(data, np.ndarray) and data.base is not None:
            data = data.copy()
            changed = True
        if isinstance(validity, np.ndarray) and validity.base is not None:
            validity = validity.copy()
            changed = True
        cols.append(Column(c.type, data, validity, c.dictionary)
                    if (data is not c.data or validity is not c.validity)
                    else c)
    if not changed:
        return batch
    return Batch(list(batch.names), cols)


def _batch_nbytes(batch) -> int:
    total = 0
    for c in batch.columns:
        total += int(c.data.nbytes)
        if c.validity is not None:
            total += int(c.validity.nbytes)
        if c.dictionary is not None:
            total += sum(len(str(s)) for s in c.dictionary) + \
                8 * len(c.dictionary)
    return total


# -- statement-level cacheability ------------------------------------------

class _Uncacheable(Exception):
    pass


#: out-of-band attributes the parser attaches OUTSIDE the dataclass
#: fields. values_rows CARRIES STATEMENT CONTENT (bare `VALUES (1),(2)`
#: rows live only there) — a digest that missed it would collide every
#: VALUES statement with every other. The text spans are derivable from
#: the fields and excluded.
_AST_EXTRA_ATTRS = ("values_rows",)


def _ast_canon(node, out: list, depth: int = 0) -> None:
    """Canonical value-based serialization of a statement AST into
    `out`, refusing anything it cannot serialize by VALUE. This is the
    cache's statement identity — repr() is NOT usable here: default
    object reprs are address-based and addresses recycle, which would
    alias two different statements into one key.

    The same single walk enforces the volatility gate, and it runs
    BEFORE binding on purpose: the binder constant-folds STABLE calls
    (now() becomes a literal — that fold IS its statement-stability),
    so the bound plan can no longer testify that the statement depends
    on the clock."""
    import dataclasses

    from ..sql import ast as _ast
    if depth > 200:
        raise _Uncacheable
    if node is None or isinstance(node, (bool, int, float, str, bytes)):
        out.append(repr(node))
        return
    if isinstance(node, (list, tuple)):
        out.append("[")
        for v in node:
            _ast_canon(v, out, depth + 1)
        out.append("]")
        return
    if isinstance(node, dict):
        out.append("{")
        for k in node:
            out.append(repr(k))
            _ast_canon(node[k], out, depth + 1)
        out.append("}")
        return
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        if isinstance(node, _ast.FuncCall) and \
                volatility(node.name) is not IMMUTABLE:
            raise _Uncacheable
        # subquery EXPRESSIONS bind to stable scalar_subquery funcs, so
        # the plan walk rejects them — except inside VALUES, where the
        # planner evaluates them at plan time and materializes the rows,
        # leaving no expression to testify and no provider to key. The
        # subplan's tables are never in the publication key, so these
        # must be refused here. SubqueryRef (derived tables in FROM) is
        # fine: it plans as a real subtree whose scans are collected.
        if isinstance(node, (_ast.Subquery, _ast.InSubquery,
                             _ast.Exists, _ast.ArraySubquery)):
            raise _Uncacheable
        out.append(type(node).__name__)
        out.append("(")
        for f in dataclasses.fields(node):
            _ast_canon(getattr(node, f.name), out, depth + 1)
        for extra in _AST_EXTRA_ATTRS:
            v = getattr(node, extra, None)
            if v is not None:
                out.append(extra)
                _ast_canon(v, out, depth + 1)
        out.append(")")
        return
    raise _Uncacheable          # unknown object: no value identity


# -- plan cacheability analysis --------------------------------------------

def _exprs_immutable(exprs) -> bool:
    from ..sql.expr import BoundFunc
    for e in exprs:
        if e is None:
            continue
        for sub in e.walk():
            if isinstance(sub, BoundFunc) and \
                    volatility(sub.name) is not IMMUTABLE:
                return False
    return True


def _agg_exprs(node):
    out = list(node.group_exprs)
    for spec in node.aggs:
        out.append(spec.arg)
        out.append(spec.filter)
        for e, _d, _nf in (spec.order_by or []):
            out.append(e)
    return out


def _plan_sources(plan) -> Optional[list]:
    """Every table provider a plan reads, or None when the plan is not
    cacheable (unknown operator, non-catalog source handled by the
    caller, stable/volatile expression anywhere). The operator list is
    a WHITELIST: an operator this walk does not know is assumed to hide
    state and blocks caching — new operators opt in, they never leak
    in."""
    from ..exec import plan as P
    from ..exec.search_scan import (BtreeScanNode, IvfScanNode,
                                    SearchScanNode)
    providers = []

    def walk(node) -> bool:
        if isinstance(node, P.ScanNode):
            providers.append(node.provider)
            return _exprs_immutable([node.filter])
        if isinstance(node, SearchScanNode):
            providers.append(node.provider)
            return _exprs_immutable([node.residual])
        if isinstance(node, (BtreeScanNode, IvfScanNode)):
            providers.append(node.provider)
            return True
        if isinstance(node, P.ValuesNode):
            return True
        if isinstance(node, P.FilterNode):
            return _exprs_immutable([node.pred]) and walk(node.child)
        if isinstance(node, P.ProjectNode):
            return _exprs_immutable(node.exprs) and walk(node.child)
        if isinstance(node, P.JoinNode):
            return (_exprs_immutable(node.left_keys) and
                    _exprs_immutable(node.right_keys) and
                    _exprs_immutable([node.residual]) and
                    walk(node.left) and walk(node.right))
        if isinstance(node, P.AggregateNode):
            return _exprs_immutable(_agg_exprs(node)) and walk(node.child)
        if isinstance(node, (P.LimitNode, P.SortNode, P.DropColumnsNode,
                             P.RenameNode, P.DistinctOnNode)):
            return all(walk(c) for c in node.children())
        if isinstance(node, P.SetOpNode):
            return walk(node.left) and walk(node.right)
        return False

    return providers if walk(plan) else None


def _catalog_key(db, provider) -> Optional[tuple]:
    """("table", "schema.name") / ("parquet", path) when the provider is
    the catalog's own long-lived instance; None for per-query providers
    (system tables, table functions, txn pins) — those never cache."""
    from ..exec.tables import MemTable, ParquetTable
    if isinstance(provider, ParquetTable):
        if db._parquet_cache.get(provider.path) is provider:
            return ("parquet", provider.path)
        return None
    if not isinstance(provider, MemTable):
        return None
    key = db.catalog_key_of(provider)
    return None if key is None else ("table", key)


def _resolve_source(db, conn, kind: str, key: str):
    """Fast-path re-resolution of a remembered source; None on any
    mismatch (dropped, renamed, revoked) — the caller replans."""
    if kind == "parquet":
        return db._parquet_cache.get(key)
    schema, name = key.split(".", 1)
    with db.lock:
        s = db.schemas.get(schema)
        p = s.tables.get(name) if s is not None else None
    if p is None:
        return None
    try:
        db.roles.require(conn.current_role, key, "select")
    except Exception:
        return None                    # let the plan path raise properly
    return p


# -- entries ----------------------------------------------------------------

class _Entry:
    __slots__ = ("batch", "label", "qid", "pubs", "sources", "wrefs")

    def __init__(self, batch, label, qid, pubs, sources, wrefs):
        self.batch = batch
        self.label = label        # normalized query text (inspection)
        self.qid = qid            # lexer fingerprint for attribution
        self.pubs = pubs          # tuple of (kind, key, token, ver, epoch)
        self.sources = sources    # tuple of (kind, key)
        self.wrefs = wrefs        # weakrefs to providers (sweep)


class ResultCache:
    def __init__(self):
        self._lru = BytesLRU(on_evict=self._evicted)
        self._lock = threading.Lock()
        self._stmt_tables: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._gauge_bytes = 0
        self._stores = 0

    # -- gauges ------------------------------------------------------------

    def _evicted(self, key, entry):
        metrics.RESULT_CACHE_EVICTIONS.add()
        self._sync_bytes()

    def _sync_bytes(self):
        with self._lock:
            now = self._lru.total_bytes
            delta = now - self._gauge_bytes
            self._gauge_bytes = now
        if delta:
            metrics.RESULT_CACHE_BYTES.add(delta)

    # -- key pieces --------------------------------------------------------

    @staticmethod
    def _settings_digest(settings) -> str:
        return "\x1f".join(
            f"{n}={settings.get(n)}" for n in RESULT_AFFECTING_SETTINGS)

    @staticmethod
    def _stmt_hash(sel_ast, params, settings) -> Optional[bytes]:
        """None when the statement refuses canonical serialization
        (unknown AST payloads, stable/volatile function calls)."""
        parts: list = []
        try:
            _ast_canon(sel_ast, parts)
        except _Uncacheable:
            return None
        h = hashlib.blake2b(digest_size=16)
        h.update("\x1e".join(parts).encode())
        h.update(b"\x00")
        h.update(repr(tuple(params)).encode())
        h.update(b"\x00")
        h.update(ResultCache._settings_digest(settings).encode())
        return h.digest()

    # -- statement lifecycle ----------------------------------------------

    def begin(self, conn, sel_ast, params,
              sql_text: Optional[str]) -> Optional["_Probe"]:
        """None when caching is off for this session or the statement
        runs inside a transaction (snapshot pins + read-your-writes make
        the catalog publication meaningless for it)."""
        try:
            if not conn.settings.get("serene_result_cache"):
                return None
        except KeyError:                      # pragma: no cover
            return None
        if conn.in_txn:
            return None
        stmt_hash = self._stmt_hash(sel_ast, params, conn.settings)
        if stmt_hash is None:
            return None
        return _Probe(self, conn, stmt_hash, sql_text)

    def tables_for(self, stmt_hash: bytes) -> Optional[tuple]:
        with self._lock:
            return self._stmt_tables.get(stmt_hash)

    def remember_tables(self, stmt_hash: bytes, sources: tuple):
        with self._lock:
            self._stmt_tables[stmt_hash] = sources
            self._stmt_tables.move_to_end(stmt_hash)
            while len(self._stmt_tables) > _STMT_MAP_CAP:
                self._stmt_tables.popitem(last=False)

    def get(self, key) -> Optional[_Entry]:
        return self._lru.get(key)

    #: entry-count ceiling: lookup/sweep cost stays bounded even when
    #: every entry is tiny
    MAX_ENTRIES = 4096
    #: sweep cadence in stores — a dead table's entries linger at most
    #: this many stores before their bytes are reclaimed
    SWEEP_EVERY = 16

    def put(self, key, entry: _Entry, nbytes: int) -> bool:
        cap = int(_settings_registry.get_global(
            "serene_result_cache_mb")) << 20
        ok = self._lru.put(key, entry, nbytes, cap,
                           cap_entries=self.MAX_ENTRIES)
        self._sync_bytes()
        with self._lock:
            self._stores += 1
            do_sweep = self._stores % self.SWEEP_EVERY == 0
        if do_sweep:
            self.sweep()
        return ok

    def sweep(self) -> int:
        """Lazy reclamation of superseded generations: entries whose
        provider died or whose publication advanced can never be hit
        again (keys embed the publication) — drop their bytes."""

        def stale(key, lru_entry) -> bool:
            e = lru_entry.value
            for wref, pub in zip(e.wrefs, e.pubs):
                p = wref()
                if p is None or _observe(p) != pub[2:]:
                    return True
            return False

        n = self._lru.evict_where(stale)
        self._sync_bytes()
        return n

    def clear(self):
        self._lru.clear()
        with self._lock:
            self._stmt_tables.clear()
        self._sync_bytes()

    def snapshot(self) -> list[dict]:
        out = []
        for key, e in self._lru.items():
            out.append({
                "tier": "result",
                "key": key[0].hex() if isinstance(key, tuple) else str(key),
                "query": e.value.label,
                "queryid": e.value.qid,
                "bytes": e.nbytes,
                "hits": e.hits,
                "rows": e.value.batch.num_rows,
                "objects": ",".join(k for _kind, k in e.value.sources),
            })
        return out

    def stats(self) -> dict:
        return {
            "entries": len(self._lru),
            "bytes": self._lru.total_bytes,
            "hits": metrics.RESULT_CACHE_HITS.value,
            "misses": metrics.RESULT_CACHE_MISSES.value,
            "evictions": metrics.RESULT_CACHE_EVICTIONS.value,
        }


class _Probe:
    """One statement's interaction with the cache: fast_lookup before
    planning, prepare+lookup after planning, store after execution."""

    def __init__(self, cache: ResultCache, conn, stmt_hash: bytes,
                 sql_text: Optional[str]):
        self.cache = cache
        self.conn = conn
        self.stmt_hash = stmt_hash
        self.sql_text = sql_text
        self.cacheable = False
        self.providers = None        # [(kind, key, provider)]
        self.pubs = None             # observed pre-execution
        self._counted = False

    # -- key assembly ------------------------------------------------------

    def _full_key(self, pubs) -> tuple:
        return (self.stmt_hash, pubs)

    @staticmethod
    def _pubs_of(sources) -> tuple:
        return tuple(sorted(
            (kind, key) + _observe(p) for kind, key, p in sources))

    def _hit(self, entry) -> object:
        from ..columnar.column import Batch
        metrics.RESULT_CACHE_HITS.add()
        self.conn._cache_hit = True
        # shallow container copy: consumers may relabel columns, the
        # cached column objects themselves are immutable by convention
        return Batch(list(entry.batch.names), list(entry.batch.columns))

    # -- pre-plan fast path ------------------------------------------------

    def fast_lookup(self):
        """Serve without planning when the statement's table set is
        remembered from an earlier store and every source still
        resolves (ACL re-checked). None on any doubt."""
        sources = self.cache.tables_for(self.stmt_hash)
        if sources is None:
            return None
        resolved = []
        for kind, key in sources:
            p = _resolve_source(self.conn.db, self.conn, kind, key)
            if p is None:
                return None
            resolved.append((kind, key, p))
        entry = self.cache.get(self._full_key(self._pubs_of(resolved)))
        if entry is None:
            return None
        return self._hit(entry)

    # -- post-plan path ----------------------------------------------------

    def prepare(self, plan) -> None:
        """Analyze the built plan: collect sources, verify every
        expression is immutable and every source is a catalog-resident
        provider, observe publications. Not cacheable ⇒ inert probe."""
        if getattr(self.conn, "_plan_inlined_views", False):
            return                    # view identity is not in the key
        providers = _plan_sources(plan)
        if providers is None:
            return
        db = self.conn.db
        seen = {}
        for p in providers:
            if id(p) in seen:
                continue
            ck = _catalog_key(db, p)
            if ck is None:
                return
            seen[id(p)] = (ck[0], ck[1], p)
        self.providers = list(seen.values())
        self.pubs = self._pubs_of(self.providers)
        self.cacheable = True

    def lookup(self):
        if not self.cacheable:
            return None
        entry = self.cache.get(self._full_key(self.pubs))
        if entry is not None:
            return self._hit(entry)
        if not self._counted:
            metrics.RESULT_CACHE_MISSES.add()
            self._counted = True
        return None

    def peek(self) -> bool:
        """Would lookup() hit? No gauges, no hit attribution — EXPLAIN
        ANALYZE reports cache state without perturbing it."""
        return self.cacheable and \
            self.cache.get(self._full_key(self.pubs)) is not None

    def store(self, batch) -> bool:
        """Store only when the post-execution publication observation
        matches the pre-execution one — a write racing the execution
        makes the result unattributable to either publication, so it is
        simply not cached."""
        if not self.cacheable:
            return False
        if self._pubs_of(self.providers) != self.pubs:
            return False
        batch = _detach_batch(batch)
        label, qid = self._label()
        # wrefs must align with the SORTED pubs tuple: the sweep zips
        # them pairwise to re-observe each provider
        pairs = sorted((((kind, key) + _observe(p)), p)
                       for kind, key, p in self.providers)
        entry = _Entry(
            batch, label, qid, tuple(t[0] for t in pairs),
            tuple((kind, key) for kind, key, _p in self.providers),
            [weakref.ref(t[1]) for t in pairs])
        nbytes = _batch_nbytes(batch)
        from ..obs.resources import charge_cache_store
        charge_cache_store(nbytes)
        ok = self.cache.put(self._full_key(self.pubs), entry, nbytes)
        if ok:
            self.cache.remember_tables(self.stmt_hash, entry.sources)
        return ok

    def _label(self) -> tuple:
        if self.sql_text:
            from ..obs.statements import fingerprint, normalize
            norm = normalize(self.sql_text)
            # an entry stored by EXPLAIN ANALYZE is keyed on (and later
            # hit by) the INNER statement — label and attribute it as
            # that statement, not as the explain wrapper
            for prefix in ("explain analyze ", "explain "):
                if norm.startswith(prefix):
                    norm = norm[len(prefix):]
                    break
            return norm[:500], fingerprint(norm)
        return "<internal>", 0


#: process-wide store, one per process like the metrics registry
RESULT_CACHE = ResultCache()
