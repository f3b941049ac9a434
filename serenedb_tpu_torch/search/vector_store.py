"""Device-resident vector store: a paged region of device memory for IVF
/ MaxSim.

Port of serenedb_tpu/search/vector_store.py. The pool's bookkeeping (pages,
LRU by segment, descriptor and chunk-map memos, the page budget) is the
reference's; the region is a torch tensor on the index's device
(`cuda:0`, or the CPU for `Database(device="cpu")`), and the programs are
the hand kernels of ops/vector_kernels.py (`ivf_probe`, `maxsim`).

Page writes update the region in place with ONE `index_copy_` (the
reference's scatter-set builds a new immutable snapshot instead). A kernel
reads the region on the device's current stream, so the pool holds its
lock from residency through the kernel's launch: a later write of the same
pages (an eviction by another query) is enqueued behind the launch and
cannot change what that kernel reads.

The reference's summary follows.

The PR 16 posting-pool pattern applied to dense vectors: vectors live
CLUSTER-MAJOR in a paged f32 region (`serene_vector_pages` 16 KiB
pages, carved out of the `serene_device_cache_mb` envelope and traded
against the column cache / posting pool under
`serene_device_cache_trade`), one pool entry per index segment with
LRU eviction and weakref reclamation. A query probes the top-nprobe
centroid lists and exact-rescores their contiguous logical slices
through a slot map (logical position → region row), so warm coalesced
knn batches run as ONE jitted dispatch with ZERO host→device vector
bytes — only the query block uploads.

Layout: an index's logical order is cluster-major across its segments
(cluster c = seg₀'s c-rows ++ seg₁'s c-rows ++ …); each segment's rows
sit row-padded in whole pages (rows-per-page = PAGE_F32 / pow2(dim)),
so a segment append writes ONLY the new segment's pages — the base
segments stay hot (the zone-map tail trick, device edition).

Bit-parity: resident, cold (pool off / starved / dim > page) and
brute-oracle paths all run the same `ops.vector` program bodies whose
distance expression is a fixed f32 add chain mirrored by
`ops.vector.host_dist`, and selection is an exact two-key sort — so
`serene_vector_pool` is NOT result-affecting and `nprobe=lists` is
bit-identical to the host brute-force oracle.
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
from ..ops import vector as vops
from ..ops import vector_kernels as vk
from ..utils import faults, metrics
from ..utils.config import REGISTRY as _settings

#: f32 slots per page (pow2): 16 KiB/page — rows-per-page stays whole
#: for every pow2-padded dim up to 4096
PAGE_F32 = 4096

_PAD_ROW = vops._PAD_ROW

#: scan-chunk lanes: bounds the rescore temp at (Qp, 1024, dp) however
#: large N or nprobe·M grow (the memory-blowup guard)
_CHUNK_LANES = 1024

#: MaxSim docs per scan chunk (the (B, dc, tmax, S) similarity block is
#: the program's large temp)
_MAXSIM_DOCS = 128

#: per-index descriptor memo entries (committed slot/offset/rowid
#: tables of one (region seq, segment stamps) composition — the
#: warm-repeat zero-upload path)
_DESC_MEMO_CAP = 8

#: committed probe-grid chunk maps kept pool-wide, keyed
#: (nprobe, max-count, lanes)
_MAP_MEMO_CAP = 32


def enabled() -> bool:
    try:
        return bool(_settings.get_global("serene_vector_pool"))
    except KeyError:  # pragma: no cover — registry declares it
        return False


def maxsim_device(settings=None) -> bool:
    try:
        if settings is not None:
            return bool(settings.get("serene_maxsim"))
        return bool(_settings.get_global("serene_maxsim"))
    except KeyError:  # pragma: no cover — registry declares it
        return True


def effective_nprobe(settings) -> int:
    """`serene_nprobe` when set (> 0), else the legacy `sdb_nprobe` —
    one result-affecting knob with a compatibility alias."""
    try:
        n = int(settings.get("serene_nprobe"))
    except KeyError:
        n = 0
    if n > 0:
        return n
    try:
        return max(1, int(settings.get("sdb_nprobe")))
    except KeyError:  # pragma: no cover — registry declares it
        return 8


def _effective_pages() -> int:
    """Page budget: `serene_vector_pages`, never exceeding the
    `serene_device_cache_mb` byte cap (the pool is carved out of that
    budget, not added)."""
    try:
        pages = max(4, int(_settings.get_global("serene_vector_pages")))
    except KeyError:  # pragma: no cover — registry declares it
        pages = 4096
    try:
        cap_mb = int(_settings.get_global("serene_device_cache_mb"))
        pages = min(pages, max(4, (cap_mb << 20) // (PAGE_F32 * 4)))
    except KeyError:  # pragma: no cover
        pass
    return pages


def _pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def note_publication(idx, provider, pin) -> None:
    """Stamp the scan's publication identity onto the index so pool
    entries written for its segments report which table/version/epoch
    occupies the pages (sdb_vector_pool rows)."""
    try:
        from ..exec.device_pipeline import _pub
        pub = _pub(provider, pin)
    except Exception:  # noqa: BLE001 — stats identity only, never fatal
        return
    obs_device.note_provider(pub[0], getattr(provider, "name", ""))
    if getattr(idx, "_pool_pub", None) != pub:
        idx._pool_pub = pub


def _write_program(region, slots, stage):
    """Staged page write: ONE scatter-set into the region, in place."""
    region.index_copy_(0, slots, stage)


class _Entry:
    """One resident index segment: its page list, row count, padded
    width, write stamp (descriptor-validity token) and the hit/idle
    signals the LRU and sdb_vector_pool read."""

    __slots__ = ("key", "slots", "n", "dp", "stamp", "pub", "hits",
                 "last_ns")

    def __init__(self, key, slots, n, dp, stamp, pub):
        self.key = key
        self.slots = slots
        self.n = n
        self.dp = dp
        self.stamp = stamp
        self.pub = pub
        self.hits = 0
        self.last_ns = time.perf_counter_ns()


class VectorPool:
    def __init__(self):
        self._lock = threading.RLock()
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._region_arr = None
        self._n_pages = 0
        self._free: list[int] = []
        self._seq = 0                  # region generation (budget change)
        self._stamp = itertools.count(1)
        self._uids = itertools.count(1)
        self._maps: "OrderedDict[tuple, tuple]" = OrderedDict()

    # -- identity ---------------------------------------------------------

    def seg_uid(self, seg) -> int:
        """Process-unique id for an index segment; the finalizer frees
        the dead segment's pages. Rebuilt indexes get fresh segments,
        hence fresh uids — 'writes move the key'. Appends REUSE the
        base segments, so their pages stay hot across the refresh."""
        uid = getattr(seg, "_vpool_uid", None)
        if uid is None:
            with self._lock:
                uid = getattr(seg, "_vpool_uid", None)
                if uid is None:
                    uid = seg._vpool_uid = next(self._uids)
                    weakref.finalize(seg, self.release_segment, uid)
        return uid

    def release_segment(self, uid: int) -> None:
        with self._lock:
            e = self._entries.pop(uid, None)
            if e is not None:
                self._free.extend(e.slots.tolist())
                if self._n_pages:
                    used = self._n_pages - len(self._free)
                    metrics.VECTOR_BYTES_RESIDENT.set(
                        used * PAGE_F32 * 4)

    # -- region -----------------------------------------------------------

    def _region(self, device) -> None:
        """Caller holds the lock. (Re)build the paged region to the
        current budget on `device`; a budget or device change drops every
        entry (operator action, rare)."""
        budget = _effective_pages()
        if self._region_arr is None or self._n_pages != budget or \
                self._region_arr.device != device:
            self._region_arr = None
            self._region_arr = torch.zeros((budget, PAGE_F32),
                                           dtype=torch.float32, device=device)
            self._n_pages = budget
            self._entries.clear()
            self._free = list(range(budget - 1, -1, -1))
            self._seq += 1
            metrics.VECTOR_BYTES_RESIDENT.set(0)

    def clear(self) -> None:
        """Drop the region and every entry (tests / budget
        experiments). The next search rebuilds lazily."""
        with self._lock:
            self._region_arr = None
            self._n_pages = 0
            self._entries.clear()
            self._free = []
            self._seq += 1
            self._maps.clear()
            metrics.VECTOR_BYTES_RESIDENT.set(0)

    def _alloc(self, need: int, busy: set) -> Optional[np.ndarray]:
        """Caller holds the lock: pop `need` free pages, evicting
        least-recently-used segments (never ones this batch pinned).
        None when the budget cannot fit the segment at all."""
        if need > self._n_pages:
            return None
        while len(self._free) < need:
            victim = None
            for key in list(self._entries):
                if key not in busy:
                    victim = key
                    break
            if victim is None:
                return None
            e = self._entries.pop(victim)
            self._free.extend(e.slots.tolist())
            metrics.VECTOR_POOL_EVICTIONS.add()
        return np.asarray([self._free.pop() for _ in range(need)],
                          dtype=np.int32)

    def _write(self, writes) -> None:
        """Caller holds the lock: batch every new segment's pages into
        ONE staged upload + one `index_copy_` into the region. Rows pad
        to pow2(dim) width and pages zero-pad past the segment tail, so
        reused pages never leak a prior tenant's vectors."""
        slots = np.concatenate([w[0] for w in writes])
        n_new = len(slots)
        stage = np.zeros((n_new, PAGE_F32), np.float32)
        row = 0
        for pages, vals, dp in writes:
            npg = len(pages)
            rpp = PAGE_F32 // dp
            buf = np.zeros((npg * rpp, dp), np.float32)
            buf[:len(vals), :vals.shape[1]] = vals
            stage[row:row + npg] = buf.reshape(npg, PAGE_F32)
            row += npg
        # (the reference pads the write to a power of two of pages so its
        # jitted program compiles per bucket; index_copy_ needs no pad)
        t0 = time.perf_counter_ns()
        from ..columnar.device import commit_host_array
        dev = self._region_arr.device
        _write_program(self._region_arr,
                       commit_host_array(slots.astype(np.int64), dev),
                       commit_host_array(stage, dev))
        tr = current_trace()
        if tr is not None:
            tr.add("vector_upload", "device", t0, time.perf_counter_ns(),
                   pages=n_new)

    # -- residency --------------------------------------------------------

    def _ensure(self, idx):
        """Try to make every segment of `idx` resident (all-or-nothing:
        partial vector residency buys little — a missing segment would
        force a host merge — so a segment that cannot fit sends the
        whole query to the cold path). Returns
        (region, seq, n_pages, entries) or None."""
        dp = _pow2(int(idx.dim), 1)
        if dp > PAGE_F32 or not idx.segs:
            return None
        rpp = PAGE_F32 // dp
        pub = getattr(idx, "_pool_pub", None)
        with self._lock:
            self._region(idx.device)
            busy: set = set()
            writes = []
            ents: list[_Entry] = []
            now = time.perf_counter_ns()
            for seg in idx.segs:
                uid = self.seg_uid(seg)
                e = self._entries.get(uid)
                if e is None:
                    n = len(seg.vals)
                    pages = self._alloc(max(1, -(-n // rpp)), busy)
                    if pages is None:
                        return None
                    e = _Entry(uid, pages, n, dp, next(self._stamp), pub)
                    self._entries[uid] = e
                    writes.append((pages, seg.vals, dp))
                    metrics.VECTOR_POOL_MISSES.add()
                else:
                    metrics.VECTOR_POOL_HITS.add()
                    e.hits += 1
                e.last_ns = now
                if pub is not None:
                    e.pub = pub
                self._entries.move_to_end(uid)
                busy.add(uid)
                ents.append(e)
            if writes:
                self._write(writes)
            used = self._n_pages - len(self._free)
            metrics.VECTOR_BYTES_RESIDENT.set(used * PAGE_F32 * 4)
            # the caller dispatches under this same lock (see the module
            # docstring): no write can land between here and its launch
            return (self._region_arr, self._seq, self._n_pages, ents)

    def _slotmap(self, idx, ents, npos_pad: int) -> np.ndarray:
        """Logical position → region row, through each segment's page
        list. Pad positions point at row 0 (dead lanes never read them
        live)."""
        lay = idx.layout()
        seg_of, within = lay["seg_of"], lay["within"]
        slot = np.zeros(npos_pad, np.int32)
        for si, e in enumerate(ents):
            mask = seg_of == si
            if not mask.any():
                continue
            w = within[mask].astype(np.int64)
            rpp = PAGE_F32 // e.dp
            shift = rpp.bit_length() - 1
            slot[np.nonzero(mask)[0]] = (
                e.slots[w >> shift].astype(np.int64) * rpp
                + (w & (rpp - 1))).astype(np.int32)
        return slot

    def _descriptor(self, idx, ents, seq: int, kind: str) -> dict:
        """Committed device descriptor tables for one index
        composition, memoized on the index keyed by (region seq,
        segment write stamps): a warm repeat uploads ZERO descriptor
        bytes."""
        key = (kind, seq, tuple(e.stamp for e in ents))
        memo = getattr(idx, "_vpool_desc", None)
        if memo is None:
            memo = idx._vpool_desc = OrderedDict()
        hit = memo.get(key)
        if hit is not None:
            memo.move_to_end(key)
            return hit
        hit = self._build_descriptor(idx, ents, kind)
        memo[key] = hit
        while len(memo) > _DESC_MEMO_CAP:
            memo.popitem(last=False)
        return hit

    def _build_descriptor(self, idx, ents, kind: str,
                          region: Optional[np.ndarray] = None) -> dict:
        """The committed tables themselves, on the index's device. With
        `region` given (cold path) the slot map is the identity over the
        logical matrix."""
        from ..columnar.device import commit_host_array
        dev = idx.device
        lay = idx.layout()
        ntot = lay["ntot"]
        l_real = lay["nlists"]
        dp = _pow2(int(idx.dim), 1)
        # maxsim pads one extra zero-count slot so pad docs in the scan
        # chunks have a dead cluster to point at
        lp = _pow2(max(l_real, 1) + (1 if kind == "maxsim" else 0), 1)
        npos_pad = _pow2(max(ntot, 1), 8)
        off = np.zeros(lp, np.int32)
        off[:l_real] = lay["offsets"][:l_real].astype(np.int32)
        cnt = np.zeros(lp, np.int32)
        cnt[:l_real] = lay["counts"][:l_real].astype(np.int32)
        rows = np.full(npos_pad, _PAD_ROW, np.int32)
        rows[:ntot] = lay["rowids"]
        if region is None:
            slot = self._slotmap(idx, ents, npos_pad)
        else:
            slot = np.arange(npos_pad, dtype=np.int32)
        d = {"dp": dp, "lp": lp, "npos_pad": npos_pad,
             "slotmap": commit_host_array(slot, dev),
             "offsets": commit_host_array(off, dev),
             "counts": commit_host_array(cnt, dev),
             "rowids": commit_host_array(rows, dev)}
        if kind == "ivf":
            cents = np.zeros((lp, dp), np.float32)
            c = idx.centroids
            cents[:c.shape[0], :c.shape[1]] = c
            d["cents"] = commit_host_array(cents, dev)
        else:
            # maxsim: per-cluster (= per-doc) row ids, pad-docs dead
            crows = np.full(lp, _PAD_ROW, np.int32)
            crows[:l_real] = lay["cluster_rowids"]
            d["cluster_rowids"] = commit_host_array(crows, dev)
        if region is not None:
            pad = np.zeros((npos_pad, dp), np.float32)
            pad[:region.shape[0], :region.shape[1]] = region
            d["region"] = commit_host_array(pad, dev)
        return d

    def _cold_descriptor(self, idx, kind: str) -> dict:
        """Pool off / starved / dim too wide: commit the logical matrix
        as a temporary region, fresh per call (unaccounted residency
        would dodge the budget). Same kernels → same bits."""
        return self._build_descriptor(idx, [], kind,
                                      region=idx.host_logical())

    def _chunk_maps(self, nprobe: int, m: int, mc: int, device):
        """Committed probe-grid chunk maps, memoized pool-wide."""
        key = (nprobe, m, mc, str(device))
        with self._lock:
            hit = self._maps.get(key)
            if hit is not None:
                self._maps.move_to_end(key)
                return hit
        from ..columnar.device import commit_host_array
        tm, jm = vops.chunk_maps(nprobe, m, mc)
        hit = (commit_host_array(tm, device), commit_host_array(jm, device),
               tm.shape[0])
        with self._lock:
            self._maps[key] = hit
            while len(self._maps) > _MAP_MEMO_CAP:
                self._maps.popitem(last=False)
        return hit

    # -- search -----------------------------------------------------------

    def search(self, idx, queries: np.ndarray, k: int, nprobe: int):
        """Batched IVF probe: centroid top-nprobe → slot-map gather →
        exact rescore → exact (dist asc, row asc) top-k, ONE kernel
        launch. Returns (dists (nq, kk) f32, rows (nq, kk) i32) numpy;
        dead lanes carry (+inf, _PAD_ROW) — callers filter non-finite."""
        lay = idx.layout()
        l_real = lay["nlists"]
        nprobe = max(1, min(int(nprobe), l_real))
        m = int(lay["max_count"])
        return self._dispatch_probe(idx, queries, k, nprobe, m, "ivf",
                                    resident=enabled())

    def brute(self, idx, queries: np.ndarray, k: int):
        """Brute-force oracle: the SAME probe kernel over a trivial
        one-cluster descriptor (every logical row in list 0), scanned
        in the SAME lane chunks — per-(query,row) distance bits are the
        probe path's bits by construction, which is what makes the
        `nprobe=lists` parity contract checkable bit-for-bit."""
        return self._dispatch_probe(idx, queries, k, 1,
                                    int(idx.layout()["ntot"]), "brute",
                                    resident=False)

    def _dispatch_probe(self, idx, queries, k, nprobe, m, kind,
                        resident):
        from ..columnar.device import commit_host_array
        faults.if_failure("vector_dispatch")
        lay = idx.layout()
        ntot = lay["ntot"]
        metric = idx.metric
        nq = queries.shape[0]
        kk = min(max(int(k), 1), max(ntot, 1))
        kkp = _pow2(kk, 8)
        mc = min(_CHUNK_LANES, _pow2(max(m, 1), 8))
        dev = idx.device
        tmap, jmap, _nchunks = self._chunk_maps(nprobe, max(m, 1), mc, dev)
        t0 = time.perf_counter_ns()
        with self._lock:
            res = self._ensure(idx) if (resident and kind == "ivf") \
                else None
            if res is not None:
                region, seq, _n_pages, ents = res
                desc = self._descriptor(idx, ents, seq, "ivf")
            else:
                if kind == "brute":
                    # the oracle's one-cluster layout: every logical row
                    # in list 0 of the identity slot map
                    desc = self._brute_descriptor(idx)
                else:
                    desc = self._cold_descriptor(idx, "ivf")
                region = desc["region"]
            dp = desc["dp"]
            l_real = 1 if kind == "brute" else lay["nlists"]
            qp = _pow2(nq, 1)
            q = np.zeros((qp, dp), np.float32)
            q[:nq, :queries.shape[1]] = queries
            outs = vk.ivf_probe(
                region, desc["slotmap"], desc["offsets"], desc["counts"],
                desc["rowids"], desc["cents"], commit_host_array(q, dev),
                tmap, jmap, metric=metric, l_real=l_real, nprobe=nprobe,
                kkp=kkp)
        d, r = obs_device.fetch_all(outs)
        tr = current_trace()
        if tr is not None:
            tr.add("vector_dispatch", "device", t0,
                   time.perf_counter_ns(), queries=nq, nprobe=nprobe,
                   kind=kind, resident=res is not None)
        metrics.VECTOR_SEARCH_QUERIES.add(nq)
        metrics.VECTOR_SEARCH_DISPATCHES.add()
        metrics.VECTOR_PROBED_CLUSTERS.add(nq * nprobe)
        return d[:nq, :kk], r[:nq, :kk]

    def _brute_descriptor(self, idx) -> dict:
        """One cluster holding the whole logical matrix, memoized on
        the (immutable) index — the oracle is a test/bench surface, not
        a serving path, but the bench calls it in a loop."""
        hit = getattr(idx, "_vpool_brute_desc", None)
        if hit is not None:
            return hit
        from ..columnar.device import commit_host_array
        dev = idx.device
        x = idx.host_logical()
        lay = idx.layout()
        ntot = lay["ntot"]
        dp = _pow2(int(idx.dim), 1)
        npos_pad = _pow2(max(ntot, 1), 8)
        rows = np.full(npos_pad, _PAD_ROW, np.int32)
        rows[:ntot] = lay["rowids"]
        pad = np.zeros((npos_pad, dp), np.float32)
        pad[:x.shape[0], :x.shape[1]] = x
        hit = {"dp": dp, "lp": 1, "npos_pad": npos_pad,
               "region": commit_host_array(pad, dev),
               "slotmap": commit_host_array(
                   np.arange(npos_pad, dtype=np.int32), dev),
               "offsets": commit_host_array(np.zeros(1, np.int32), dev),
               "counts": commit_host_array(
                   np.asarray([ntot], np.int32), dev),
               "rowids": commit_host_array(rows, dev),
               "cents": commit_host_array(np.zeros((1, dp), np.float32),
                                          dev)}
        idx._vpool_brute_desc = hit
        return hit

    # -- MaxSim -----------------------------------------------------------

    def maxsim_search(self, idx, qtoks: np.ndarray, k: int):
        """Batched MaxSim: docs are the clusters (one token matrix
        each); scores are Σ_s max_t <q_s, d_t>, selected with the exact
        (score desc, doc asc) contract. qtoks: (B, S, dim) f32 (token
        rows zero-padded across the batch — an exact no-op). Returns
        (keys (B, kk) f32 = NEGATED scores, rows (B, kk) i32)."""
        from ..columnar.device import commit_host_array
        faults.if_failure("vector_dispatch")
        lay = idx.layout()
        ndocs = lay["nlists"]
        b, s = qtoks.shape[0], qtoks.shape[1]
        kk = min(max(int(k), 1), max(ndocs, 1))
        kkp = _pow2(kk, 8)
        dc = min(_MAXSIM_DOCS, _pow2(max(ndocs, 1), 1))
        dev = idx.device
        # doc chunks: pad docs point at the extra zero-count slot the
        # maxsim descriptor reserves at index ndocs (dead lanes)
        dmap, _nchunks = self._doc_maps(ndocs, dc, dev)
        t0 = time.perf_counter_ns()
        with self._lock:
            res = self._ensure(idx) if enabled() else None
            if res is not None:
                region, seq, _n_pages, ents = res
                desc = self._descriptor(idx, ents, seq, "maxsim")
            else:
                desc = self._cold_descriptor(idx, "maxsim")
                region = desc["region"]
            dp = desc["dp"]
            tile = min(dp, 32)
            sp = _pow2(max(s, 1), 1)
            bp = _pow2(max(b, 1), 1)
            q = np.zeros((bp, sp, dp), np.float32)
            q[:b, :s, :qtoks.shape[2]] = qtoks
            outs = vk.maxsim(
                region, desc["slotmap"], desc["offsets"], desc["counts"],
                desc["cluster_rowids"], commit_host_array(q, dev), dmap,
                tile=tile, tcap=int(lay["max_count"]), kkp=kkp)
        keys, rows = obs_device.fetch_all(outs)
        tr = current_trace()
        if tr is not None:
            tr.add("vector_dispatch", "device", t0,
                   time.perf_counter_ns(), queries=b, kind="maxsim",
                   resident=res is not None)
        metrics.VECTOR_SEARCH_QUERIES.add(b)
        metrics.VECTOR_SEARCH_DISPATCHES.add()
        metrics.VECTOR_PROBED_CLUSTERS.add(b * ndocs)
        return keys[:b, :kk], rows[:b, :kk]

    def _doc_maps(self, ndocs: int, dc: int, device):
        """Committed MaxSim doc-chunk map (pad = index ndocs, the
        reserved zero-count slot), memoized pool-wide."""
        key = ("dmap", ndocs, dc, str(device))
        with self._lock:
            hit = self._maps.get(key)
            if hit is not None:
                self._maps.move_to_end(key)
                return hit
        from ..columnar.device import commit_host_array
        nchunks = max(1, -(-ndocs // dc))
        dm = np.full(nchunks * dc, ndocs, np.int32)
        dm[:ndocs] = np.arange(ndocs, dtype=np.int32)
        hit = (commit_host_array(dm.reshape(nchunks, dc), device), nchunks)
        with self._lock:
            self._maps[key] = hit
            while len(self._maps) > _MAP_MEMO_CAP:
                self._maps.popitem(last=False)
        return hit

    # -- observability ----------------------------------------------------

    def device_bytes(self) -> dict[int, int]:
        """Region bytes per holding device (the index of its CUDA
        device; 0 for the CPU)."""
        with self._lock:
            if self._region_arr is None:
                return {}
            dev = self._region_arr.device
            return {int(dev.index or 0): self._n_pages * PAGE_F32 * 4}

    def snapshot(self) -> list[dict]:
        """sdb_vector_pool() rows: per (publication, segment) resident
        pages, bytes, hits and idle time."""
        with self._lock:
            now = time.perf_counter_ns()
            rows = []
            for uid, e in self._entries.items():
                pub = e.pub or (0, 0, 0)
                rows.append({
                    "token": int(pub[0]),
                    "data_version": int(pub[1]),
                    "mutation_epoch": int(pub[2]),
                    "segment": uid,
                    "vectors": int(e.n),
                    "pages": len(e.slots),
                    "bytes": len(e.slots) * PAGE_F32 * 4,
                    "hits": int(e.hits),
                    "idle_ms": round((now - e.last_ns) / 1e6, 3)})
        rows.sort(key=lambda r: (r["token"], r["segment"]))
        return rows

    # -- budget trade with the device column cache (§19) -------------------

    def live_bytes(self) -> int:
        """HBM bytes of LIVE (allocated) pages — this pool's claim on
        the shared serene_device_cache_mb envelope."""
        with self._lock:
            if self._region_arr is None:
                return 0
            return (self._n_pages - len(self._free)) * PAGE_F32 * 4

    def tail_idle_ns(self) -> Optional[int]:
        """Idle time of the LRU tail entry (the next eviction victim),
        or None when the pool is empty."""
        with self._lock:
            for e in self._entries.values():
                return time.perf_counter_ns() - e.last_ns
            return None

    def shed_colder(self, idle_ns: int, need_bytes: int) -> int:
        """Evict LRU-tail segments idle LONGER than `idle_ns` until
        `need_bytes` of pages free; stops at the first tail entry
        warmer than the threshold. Returns bytes freed (the column
        cache calls this when IT is over cap and this pool's tail is
        the coldest claimant)."""
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
                freed += len(e.slots) * PAGE_F32 * 4
                metrics.VECTOR_POOL_EVICTIONS.add()
            if freed and self._n_pages:
                used = self._n_pages - len(self._free)
                metrics.VECTOR_BYTES_RESIDENT.set(used * PAGE_F32 * 4)
        return freed

    def stats(self) -> dict:
        """The `/_stats` / `GET /device` vector_pool section."""
        with self._lock:
            used = (self._n_pages - len(self._free)) \
                if self._region_arr is not None else 0
            return {"pages": self._n_pages,
                    "pages_used": used,
                    "page_bytes": PAGE_F32 * 4,
                    "resident_segments": len(self._entries),
                    "hits": int(metrics.VECTOR_POOL_HITS.value),
                    "misses": int(metrics.VECTOR_POOL_MISSES.value),
                    "evictions": int(
                        metrics.VECTOR_POOL_EVICTIONS.value),
                    "queries": int(
                        metrics.VECTOR_SEARCH_QUERIES.value),
                    "dispatches": int(
                        metrics.VECTOR_SEARCH_DISPATCHES.value)}


#: process-wide pool (indexes and their segments are process-wide)
VPOOL = VectorPool()
