"""Device-resident paged posting pool: batched ragged search on the card.

Port of serenedb_tpu/search/posting_pool.py. The pool's bookkeeping
(pages, LRU entries keyed (segment uid, term id) with weakref finalizers,
prefix residency, the batch-descriptor memo keyed on entry stamps, the
page budget inside `serene_device_cache_mb`, the budget trade with the
device column cache) is the reference's; the region is a pair of torch
tensors on the searcher's device (`cuda:0`, or the CPU for
`device="cpu"`), and its programs are the hand kernel `pool_score`
(ops/pool_kernels.py, csrc/pool.cu) in full and partial mode.

Two changes, neither visible in a result bit:
- Page writes update the region in place with ONE `index_copy_` pair
  (the reference builds a new immutable snapshot per write). A kernel
  reads the region on the device's current stream, so the pool holds its
  lock from the residency check through the launch: a later write of the
  same pages (another batch's eviction) is enqueued behind the launch and
  cannot change what it reads.
- The batch descriptor carries the forward scatter indices of
  `_ragged_candidates` (one int32 lane per kept posting, plus per-slice
  offsets) instead of the reference's inverse map `posm` (qp x tp x cp
  int32): the kernel adds slice after slice in stream order, each lane
  once a slice, which is the same f32 addition sequence.

The reference's summary follows.
Device-resident paged posting pool: batched ragged search in HBM.

The batched ragged scorer (search/searcher._ragged_resolve) is host
numpy end to end — every coalesced dispatch re-flattens WAND-kept
postings on the CPU while the device tier sits idle. This module is the
accelerator analog of Ragged Paged Attention's paged KV pool (PAPERS.md)
applied to inverted lists (GPUSparse's parallel index traversal): one
paged HBM region holds posting blocks, uploaded ONCE, and a coalesced
batch whose terms are page-resident scores as ONE jitted
gather-and-segment-accumulate program over page tables — zero
host→device posting bytes on the warm path.

Layout and keying
-----------------
The pool owns a fixed region pair `(docs, tfs)` of shape
`(serene_posting_pages, PAGE)` int32 — pow2 page size, budget
coordinated with `serene_device_cache_mb` (the region never exceeds the
column-cache byte cap). A pool entry is ONE term's full posting range
chunked into pages, keyed `(segment uid, term id)` where the uid is
pinned to the segment's immutable BlockStore (fragment-cache idiom:
attach + weakref finalizer). The serving publication
`(provider token, data_version, mutation_epoch)` — stamped by
exec/search_scan via `note_publication` — rides on entries for the
`sdb_posting_pool()` operator view. The append-tail ("zone-map tail")
trick falls out of segment immutability: a pure append creates NEW
segments whose terms allocate new tail pages while every old segment's
pages stay valid and hot; a mutation rebuilds segments, so writes move
the key and the dead uids' pages are reclaimed by their finalizers.

Scoring and parity
------------------
Residency is PREFIX-shaped per query: slices (the (plane, term) flatten
order of `_ragged_resolve`) are ensured in order, and the first
non-resident slice cuts the device portion. Fully resident queries run
the `posting_pool` program (gather pages → `ops/bm25.contrib_expr` —
THE same expression tree the host ragged path traces — → scatter-add
over the query's candidate slots → exact two-key lax.sort top-k);
partially resident queries run `posting_pool_partial`, which returns
the raw accumulator so the host adds the non-resident suffix slices in
the SAME order — an identical f32 addition sequence to the all-host
path, which stays on as the bit-exact parity oracle behind
`serene_posting_pool = off`. Query/page/candidate axes pad to powers of
two so coalesced batches of every size reuse a handful of programs
(compile-ledger hygiene), and pad entries carry weight 0 into a dead
dump slot — contributing exactly +0.0 nowhere visible.

Concurrency: region arrays are immutable jax values; page writes build
NEW arrays via one staged scatter-set program, so an in-flight dispatch
keeps scoring its captured snapshot even while another thread evicts or
rewrites pages. Residency ensure + descriptor capture happen under one
lock hold; dispatches run outside it.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..obs import device as obs_device
from ..obs.trace import current_trace
from ..ops import pool_kernels
from ..utils import faults, metrics
from ..utils.config import REGISTRY as _settings

#: postings per page (pow2): 8 KiB/page across the (docs, tfs) pair —
#: small enough that short tails waste little, large enough that a
#: million-posting term is ~1k page table entries
PAGE = 1024
PAGE_SHIFT = 10

#: doc-id pad sentinel in sort keys (matches the device merge pads)
_PAD_DOC = pool_kernels.PAD_DOC

#: device-side batch descriptor memo entries kept per store (each holds
#: the uploaded slot/weight/lane tables of one batch composition — the
#: warm-repeat zero-upload path)
_BATCH_MEMO_CAP = 16


def enabled() -> bool:
    try:
        return bool(_settings.get_global("serene_posting_pool"))
    except KeyError:  # pragma: no cover — registry declares it
        return False


def _effective_pages() -> int:
    """Page budget: `serene_posting_pages`, never exceeding the
    `serene_device_cache_mb` byte cap the operator already granted the
    device tier (the pool is carved out of that budget, not added)."""
    try:
        pages = max(8, int(_settings.get_global("serene_posting_pages")))
    except KeyError:  # pragma: no cover — registry declares it
        pages = 4096
    try:
        cap_mb = int(_settings.get_global("serene_device_cache_mb"))
        pages = min(pages, max(8, (cap_mb << 20) // (PAGE * 8)))
    except KeyError:  # pragma: no cover
        pass
    return pages


def note_publication(searcher, provider, pin) -> None:
    """Stamp the scan's publication identity onto the (multi)searcher's
    segments so pool entries written for them report which
    table/version/epoch occupies the pages (sdb_posting_pool rows).
    First write wins per distinct publication; cheap enough to call per
    scan."""
    try:
        from ..exec.device_pipeline import _pub
        pub = _pub(provider, pin)
    except Exception:  # noqa: BLE001 — stats identity only, never fatal
        return
    obs_device.note_provider(pub[0], getattr(provider, "name", ""))
    segs = getattr(searcher, "segments", None)
    targets = [s for s, _ in segs] if segs else [searcher]
    for seg in targets:
        if getattr(seg, "_pool_pub", None) != pub:
            seg._pool_pub = pub


def _write_program(docs_pg, tfs_pg, slots, stage_docs, stage_tfs):
    """Staged page write: ONE scatter-set pair into the region, in
    place."""
    docs_pg.index_copy_(0, slots, stage_docs)
    tfs_pg.index_copy_(0, slots, stage_tfs)


class _Entry:
    """One resident term: its page table, posting count, write stamp
    (descriptor-validity token — changes iff the key is rewritten) and
    the hit/idle signals the LRU and sdb_posting_pool read."""

    __slots__ = ("key", "slots", "n", "stamp", "pub", "hits", "last_ns")

    def __init__(self, key, slots, n, stamp, pub):
        self.key = key
        self.slots = slots
        self.n = n
        self.stamp = stamp
        self.pub = pub
        self.hits = 0
        self.last_ns = time.perf_counter_ns()


def _slice_slots(entry: _Entry, sl) -> np.ndarray:
    """Global region slots of one slice's kept postings: the term's page
    table expanded at the slice's within-term positions (all of them for
    light/full-range slices, the WAND-kept subset for masked ones)."""
    pos = sl.idx if sl.idx is not None \
        else np.arange(entry.n, dtype=np.int64)
    return (entry.slots[pos >> PAGE_SHIFT].astype(np.int64) * PAGE
            + (pos & (PAGE - 1))).astype(np.int32)




class PostingPool:
    def __init__(self):
        self._lock = threading.RLock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._docs = None
        self._tfs = None
        self._n_pages = 0
        self._free: list[int] = []
        self._seq = 0                  # region generation (budget change)
        self._stamp = itertools.count(1)
        self._uids = itertools.count(1)

    # -- identity ---------------------------------------------------------

    def store_uid(self, store) -> int:
        """Process-unique id for a segment's BlockStore; the finalizer
        frees the dead segment's pages (fragment-cache segment_uid
        idiom). Rebuilt segments get fresh stores, hence fresh uids —
        'writes move the key'."""
        uid = getattr(store, "_pool_uid", None)
        if uid is None:
            with self._lock:
                uid = getattr(store, "_pool_uid", None)
                if uid is None:
                    uid = store._pool_uid = next(self._uids)
                    weakref.finalize(store, self.release_segment, uid)
        return uid

    def release_segment(self, uid: int) -> None:
        """Weakref finalizer target: reclaim every page the dead
        segment's terms held."""
        with self._lock:
            dead = [k for k in self._entries if k[0] == uid]
            for k in dead:
                e = self._entries.pop(k)
                self._free.extend(e.slots.tolist())
            if dead and self._n_pages:
                self._note_used()

    def _note_used(self) -> None:
        used = self._n_pages - len(self._free)
        metrics.POSTING_POOL_PAGES_USED.set(used)
        metrics.POSTING_POOL_BYTES.set(used * PAGE * 8)

    # -- region -----------------------------------------------------------

    def _region(self, device) -> None:
        """Caller holds the lock. (Re)build the paged region to the
        current budget on `device`; a budget or device change drops every
        entry (operator action, rare)."""
        budget = _effective_pages()
        if self._docs is None or self._n_pages != budget or \
                self._docs.device != device:
            self._docs = self._tfs = None
            self._docs = torch.zeros((budget, PAGE), dtype=torch.int32,
                                     device=device)
            self._tfs = torch.zeros((budget, PAGE), dtype=torch.int32,
                                    device=device)
            self._n_pages = budget
            self._entries.clear()
            self._free = list(range(budget - 1, -1, -1))
            self._seq += 1
            metrics.POSTING_POOL_PAGES_USED.set(0)
            metrics.POSTING_POOL_BYTES.set(0)

    def clear(self) -> None:
        """Drop the region and every entry (tests / budget experiments).
        The next scoring call rebuilds lazily."""
        with self._lock:
            self._docs = self._tfs = None
            self._n_pages = 0
            self._entries.clear()
            self._free = []
            self._seq += 1
            metrics.POSTING_POOL_PAGES_USED.set(0)
            metrics.POSTING_POOL_BYTES.set(0)

    def _alloc(self, need: int, busy: set) -> Optional[np.ndarray]:
        """Caller holds the lock: pop `need` free pages, evicting
        least-recently-used entries (never ones this batch pinned) to
        make room. None when the budget cannot fit the term at all."""
        if need > self._n_pages:
            return None
        while len(self._free) < need:
            victim = None
            # LRU order; iterate a copy — a GC-triggered segment
            # finalizer re-entering on this thread may mutate the dict
            for key in list(self._entries):
                if key not in busy:
                    victim = key
                    break
            if victim is None:
                return None
            e = self._entries.pop(victim)
            self._free.extend(e.slots.tolist())
            metrics.POSTING_POOL_EVICTIONS.add()
        return np.asarray([self._free.pop() for _ in range(need)],
                          dtype=np.int32)

    def _write(self, writes) -> None:
        """Caller holds the lock: batch every new entry's pages into ONE
        staged upload + one `index_copy_` pair into the region. Short
        tails zero-pad to the page boundary, so reused pages never leak a
        prior tenant's postings past `entry.n`."""
        slots = np.concatenate([w[0] for w in writes])
        n_new = len(slots)
        sd = np.zeros((n_new, PAGE), np.int32)
        st = np.zeros((n_new, PAGE), np.int32)
        row = 0
        for pages, d, t in writes:
            npg = len(pages)
            sd[row:row + npg].reshape(-1)[:len(d)] = d
            st[row:row + npg].reshape(-1)[:len(t)] = t
            row += npg
        # (the reference pads the write to a power of two of pages so its
        # jitted program compiles per bucket; index_copy_ needs no pad)
        t0 = time.perf_counter_ns()
        from ..columnar.device import commit_host_array
        dev = self._docs.device
        _write_program(self._docs, self._tfs,
                       commit_host_array(slots.astype(np.int64), dev),
                       commit_host_array(sd, dev), commit_host_array(st, dev))
        tr = current_trace()
        if tr is not None:
            tr.add("posting_upload", "device", t0, time.perf_counter_ns(),
                   pages=n_new)

    # -- scoring ----------------------------------------------------------

    def score_queries(self, searcher, store, per_q, k: int, scorer: str,
                      avgdl: float, k1: float, b: float, cand_fn) -> dict:
        """Device tier of `_ragged_resolve`: ensure residency for each
        admitted query's slices (in slice order — prefix semantics),
        then score fully resident queries to final top-k and partially
        resident ones to raw accumulators in at most two batched
        launches. Returns {qi: ("full", scores, docs) |
        ("partial", acc, n_resident_slices)}; queries absent from the
        result stay entirely on the host oracle path."""
        faults.if_failure("posting_pool_dispatch")
        # plan-free queries (all-light terms, or θ=0 plans) are admitted
        # too: their slices are a pure function of (store, tids), so the
        # entry-stamp tuple in the batch-memo key still identifies the
        # composition exactly even though id(plan) is id(None) for all
        reqs = [(qi, plan, slices) for qi, plan, slices in per_q if slices]
        if not reqs:
            return {}
        uid = self.store_uid(store)
        pub = getattr(searcher, "_pool_pub", None)
        # the candidate tables are a pure function of (plan, slices), so
        # they are built before the lock (the reference builds them after
        # its snapshot capture)
        cands = {qi: cand_fn(store, plan, slices)
                 for qi, plan, slices in reqs}
        out: dict = {}
        with self._lock:
            self._region(store.norms.device)
            busy: set = set()
            writes = []
            prefixes: list[list[_Entry]] = []
            now = time.perf_counter_ns()
            for qi, plan, slices in reqs:
                ents: list[_Entry] = []
                blocked = False
                for sl in slices:
                    key = (uid, sl.tid)
                    e = self._entries.get(key)
                    if e is not None:
                        metrics.POSTING_POOL_HITS.add()
                        e.hits += 1
                    elif not blocked:
                        n = sl.e - sl.s
                        pages = self._alloc(-(-n // PAGE), busy)
                        if pages is None:
                            blocked = True
                        else:
                            e = _Entry(key, pages, n, next(self._stamp),
                                       pub)
                            self._entries[key] = e
                            writes.append((pages, store.flat_docs[sl.s:sl.e],
                                           store.flat_tfs[sl.s:sl.e]))
                            metrics.POSTING_POOL_MISSES.add()
                    if e is None:
                        break    # prefix ends at first non-resident slice
                    e.last_ns = now
                    if pub is not None:
                        e.pub = pub
                    self._entries.move_to_end(key)
                    busy.add(key)
                    ents.append(e)
                prefixes.append(ents)
            if writes:
                self._write(writes)
            self._note_used()
            full_items, part_items = [], []
            for (qi, plan, slices), ents in zip(reqs, prefixes):
                if not ents:
                    continue
                cand, ixs = cands[qi]
                if not len(cand):
                    continue
                item = (qi, plan, slices, ents, cand, ixs)
                (full_items if len(ents) == len(slices)
                 else part_items).append(item)
            # launches stay under the lock (see the module docstring);
            # the readback waits for them outside it
            pending = []
            if full_items:
                pending.append((True, full_items, self._dispatch(
                    store, full_items, k, scorer, avgdl, k1, b, True)))
            if part_items:
                pending.append((False, part_items, self._dispatch(
                    store, part_items, k, scorer, avgdl, k1, b, False)))
        for topk, items, outs in pending:
            t0 = time.perf_counter_ns()
            fetched = obs_device.fetch_all(outs)
            tr = current_trace()
            if tr is not None:
                tr.add("posting_dispatch", "device", t0,
                       time.perf_counter_ns(), queries=len(items),
                       partial=not topk)
            if topk:
                vals, docs = fetched
                for i, (qi, _p, _s, _e, cand, _i) in enumerate(items):
                    m = min(k, len(cand))
                    out[qi] = ("full", vals[i][:m], docs[i][:m])
                metrics.POSTING_POOL_DEVICE_QUERIES.add(len(items))
            else:
                acc = fetched[0]
                for i, (qi, _p, _s, ents, cand, _i) in enumerate(items):
                    out[qi] = ("partial", acc[i][:len(cand)].copy(),
                               len(ents))
                metrics.POSTING_POOL_PARTIAL.add(len(items))
        return out

    def _dispatch(self, store, items, k, scorer, avgdl, k1, b,
                  topk: bool) -> list:
        """Caller holds the lock: ONE `pool_score` launch over the
        region. The per-batch descriptor (slot/weight/lane/offset and
        candidate tables) memoizes on the store keyed by batch
        composition + entry write stamps, so a warm repeat of the same
        coalesced batch uploads ZERO bytes and launches exactly once.
        Returns the launch's outputs, still on the device."""
        from ..ops import bm25 as bm25_ops
        memo = getattr(store, "_pool_batch_memo", None)
        if memo is None:
            memo = store._pool_batch_memo = OrderedDict()
        kk_want = min(bm25_ops.pad_k(k), 1 << 30) if topk else 0
        mkey = (topk, kk_want, scorer, self._seq, self._n_pages,
                tuple((id(plan), len(ents),
                       tuple(e.stamp for e in ents))
                      for _q, plan, _s, ents, _c, _i in items))
        hit = memo.get(mkey)
        if hit is None:
            hit = self._descriptor(items, kk_want, topk,
                                   store.norms.device)
            memo[mkey] = hit
            while len(memo) > _BATCH_MEMO_CAP:
                memo.popitem(last=False)
        else:
            memo.move_to_end(mkey)
        res = pool_kernels.pool_score(
            self._docs, self._tfs, store.norms, hit["si"], hit["w"],
            hit["lane"], hit["soff"], hit["slice_max"], hit["cp"],
            float(k1), float(b), float(avgdl), scorer, hit["cand"],
            hit["nc"], hit["kk"])
        return list(res) if topk else [res]

    @staticmethod
    def _descriptor(items, kk_want: int, topk: bool, device) -> dict:
        """Build and upload one batch's descriptor: each query's kept
        postings in slice order (region slot, weight, candidate lane),
        its slice offsets, and for full mode its candidate docs. Sized
        exactly: the reference pads each axis to a power of two so that
        XLA reuses a compiled program per size bucket; the kernel takes
        any size, and every padded lane would be one more key to sort."""
        from ..columnar.device import commit_host_array
        qp = len(items)
        ep = max(1, max(sum(len(ix) for ix in ixs[:len(ents)])
                        for _q, _p, _s, ents, _c, ixs in items))
        cp = max(len(cand) for _q, _p, _s, _e, cand, _i in items)
        tp = max(len(ents) for _q, _p, _s, ents, _c, _i in items)
        si = np.zeros((qp, ep), np.int32)
        wm = np.zeros((qp, ep), np.float32)
        lane = np.zeros((qp, ep), np.int32)
        soff = np.zeros((qp, tp + 1), np.int32)
        slice_max = [0] * tp
        cm = np.full((qp, cp), _PAD_DOC, np.int32)
        ncv = np.zeros((qp,), np.int32)
        for i, (_q, _p, slices, ents, cand, ixs) in enumerate(items):
            pos = 0
            for t, (sl, e, ix) in enumerate(zip(slices, ents, ixs)):
                g = _slice_slots(e, sl)
                si[i, pos:pos + len(g)] = g
                wm[i, pos:pos + len(g)] = sl.w
                lane[i, pos:pos + len(g)] = ix
                soff[i, t] = pos
                slice_max[t] = max(slice_max[t], len(g))
                pos += len(g)
            soff[i, len(ents):] = pos
            cm[i, :len(cand)] = cand
            ncv[i] = len(cand)
        return {"cp": cp, "kk": min(kk_want, cp) if topk else 0,
                "slice_max": slice_max,
                "si": commit_host_array(si, device),
                "w": commit_host_array(wm, device),
                "lane": commit_host_array(lane, device),
                "soff": commit_host_array(soff, device),
                "cand": commit_host_array(cm, device) if topk else None,
                "nc": commit_host_array(ncv, device) if topk else None,
                # strong plan refs pin the id()s in the memo key
                "plans": [p for _q, p, _s, _e, _c, _i in items]}

    # -- observability ----------------------------------------------------

    def device_bytes(self) -> dict[int, int]:
        """Region bytes per holding device (the index of its CUDA
        device; 0 for the CPU)."""
        with self._lock:
            if self._docs is None:
                return {}
            return {int(self._docs.device.index or 0):
                    self._n_pages * PAGE * 8}

    def snapshot(self) -> list[dict]:
        """sdb_posting_pool() rows: per (publication, segment) resident
        terms, page occupancy, bytes, hits and idle time — the live data
        operators size `serene_posting_pages` from."""
        with self._lock:
            now = time.perf_counter_ns()
            agg: dict = {}
            for (uid, _tid), e in self._entries.items():
                pub = e.pub or (0, 0, 0)
                r = agg.get((pub, uid))
                if r is None:
                    r = agg[(pub, uid)] = {
                        "token": int(pub[0]),
                        "data_version": int(pub[1]),
                        "mutation_epoch": int(pub[2]),
                        "segment": uid, "terms": 0, "pages": 0,
                        "bytes": 0, "hits": 0, "last_ns": 0}
                r["terms"] += 1
                r["pages"] += len(e.slots)
                r["bytes"] += e.n * 8
                r["hits"] += e.hits
                r["last_ns"] = max(r["last_ns"], e.last_ns)
        rows = []
        for r in agg.values():
            r["idle_ms"] = round((now - r.pop("last_ns")) / 1e6, 3)
            rows.append(r)
        rows.sort(key=lambda r: (r["token"], r["segment"]))
        return rows

    # -- budget trade with the device column cache (§19) -------------------

    def live_bytes(self) -> int:
        """HBM bytes of LIVE (allocated) pages — the pool's claim on the
        shared serene_device_cache_mb envelope. Free pages of the region
        don't count: they cost HBM but the trade is about who gets to
        KEEP data resident, and an idle region re-shrinks only on a
        budget change (rebuilds drop every entry, so resizing per query
        would thrash)."""
        with self._lock:
            if self._docs is None:
                return 0
            return (self._n_pages - len(self._free)) * PAGE * 8

    def tail_idle_ns(self) -> Optional[int]:
        """Idle time of the LRU tail entry (the next eviction victim),
        or None when the pool is empty."""
        with self._lock:
            for e in self._entries.values():
                return time.perf_counter_ns() - e.last_ns
            return None

    def shed_colder(self, idle_ns: int, need_bytes: int) -> int:
        """Evict LRU-tail entries that have sat idle LONGER than
        `idle_ns` until `need_bytes` of pages are freed; stops at the
        first tail entry warmer than the threshold. Returns bytes
        freed. Called by the column cache when IT is over cap and the
        pool's tail is colder than its own — lock order is strictly
        cache-side-unlocked → pool, so this can never deadlock against
        a concurrent score/alloc holding the pool lock."""
        freed = 0
        with self._lock:
            now = time.perf_counter_ns()
            while freed < need_bytes:
                victim = None
                for key, e in self._entries.items():
                    if now - e.last_ns > idle_ns:
                        victim = key
                    break           # LRU head only: warmer head ends it
                if victim is None:
                    break
                e = self._entries.pop(victim)
                self._free.extend(e.slots.tolist())
                freed += len(e.slots) * PAGE * 8
                metrics.POSTING_POOL_EVICTIONS.add()
            if freed and self._n_pages:
                used = self._n_pages - len(self._free)
                metrics.POSTING_POOL_PAGES_USED.set(used)
                metrics.POSTING_POOL_BYTES.set(used * PAGE * 8)
        return freed

    def stats(self) -> dict:
        """The `/_stats` / `GET /device` posting_pool section."""
        with self._lock:
            used = (self._n_pages - len(self._free)) if self._docs \
                is not None else 0
            return {"pages": self._n_pages,
                    "pages_used": used,
                    "page_bytes": PAGE * 8,
                    "resident_terms": len(self._entries),
                    "hits": int(metrics.POSTING_POOL_HITS.value),
                    "misses": int(metrics.POSTING_POOL_MISSES.value),
                    "evictions": int(
                        metrics.POSTING_POOL_EVICTIONS.value)}


#: process-wide pool (segments and their stores are process-wide objects)
POOL = PostingPool()
