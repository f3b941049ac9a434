"""Immutable inverted-index segments, TPU-shaped.

Reference analog: IResearch segments — postings in 128-doc blocks with
block-max (WAND) metadata, columnstore for stored fields, norms for scoring
(reference: libs/iresearch/formats/posting/format_block_128.cpp,
wand_writer.hpp; SURVEY.md §2.7). The 128-doc block granularity is kept —
it is exactly one TPU lane row — but postings live as flat HBM arrays with
per-term offsets; queries gather (n_blocks, 128) tiles by index matrix and
score them on the MXU/VPU (ops/bm25.py).

A segment is immutable once built; deletes are a live-docs bitmap owned by
the enclosing shard (storage layer); merges rebuild segments.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from .analysis import Analyzer, get_analyzer

BLOCK = 128


@dataclass
class FieldIndex:
    """Inverted index of one text field within a segment."""

    terms: np.ndarray          # (T,) object, sorted unique terms
    doc_freq: np.ndarray       # (T,) int32
    offsets: np.ndarray        # (T+1,) int64 into postings arrays
    post_docs: np.ndarray      # (P,) int32 doc ids, ascending per term
    post_tfs: np.ndarray       # (P,) int32 term frequencies
    pos_offsets: np.ndarray    # (P+1,) int64 into positions
    positions: np.ndarray      # (PP,) int32 token positions (phrase queries)
    norms: np.ndarray          # (ndocs,) int32 tokens per document
    block_max_tf: np.ndarray   # (NB_total,) int32 — per 128-block max tf
    block_offsets: np.ndarray  # (T+1,) int64 into block_max_tf
    total_tokens: int

    @property
    def num_terms(self) -> int:
        return len(self.terms)

    @property
    def avgdl(self) -> float:
        n = len(self.norms)
        return (self.total_tokens / n) if n else 0.0

    @property
    def ctf(self) -> np.ndarray:
        """Collection term frequency per term (LM-family scorers); lazily
        reduced over the postings and memoized — segments are immutable."""
        c = getattr(self, "_ctf", None)
        if c is None:
            if len(self.offsets) > 1 and len(self.post_tfs):
                c = np.add.reduceat(
                    self.post_tfs.astype(np.int64), self.offsets[:-1])
                # reduceat repeats values for empty ranges; terms always
                # have ≥1 posting here, but guard stays cheap
            else:
                c = np.zeros(max(len(self.offsets) - 1, 0), dtype=np.int64)
            self._ctf = c
        return c

    @property
    def terms_str(self) -> np.ndarray:
        """str-dtype view of the term dictionary, materialized once (term
        lookups are the hot path — no per-query O(T) copies)."""
        ts = getattr(self, "_terms_str", None)
        if ts is None:
            ts = self._terms_str = self.terms.astype(str)
        return ts

    def term_id(self, term: str) -> int:
        """-1 if absent."""
        ts = self.terms_str
        i = int(np.searchsorted(ts, term))
        if i < len(ts) and ts[i] == term:
            return i
        return -1

    def term_range(self, lo: str, hi: str) -> np.ndarray:
        """Term ids with lo <= term < hi (prefix/range expansion)."""
        ts = self.terms_str
        a = int(np.searchsorted(ts, lo, side="left"))
        b = int(np.searchsorted(ts, hi, side="left"))
        return np.arange(a, b, dtype=np.int64)

    def prefix_term_ids(self, prefix: str) -> np.ndarray:
        return self.term_range(prefix, prefix + "￿")

    def postings(self, tid: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = int(self.offsets[tid]), int(self.offsets[tid + 1])
        return self.post_docs[s:e], self.post_tfs[s:e]

    def positions_of(self, tid: int, within_docs: np.ndarray) -> dict[int, np.ndarray]:
        """doc id → positions array, for the given docs (phrase check)."""
        s, e = int(self.offsets[tid]), int(self.offsets[tid + 1])
        docs = self.post_docs[s:e]
        idx = np.searchsorted(docs, within_docs)
        out = {}
        for k, d in zip(idx, within_docs):
            if k < len(docs) and docs[k] == d:
                p = s + k
                out[int(d)] = self.positions[
                    int(self.pos_offsets[p]):int(self.pos_offsets[p + 1])]
        return out


@dataclass
class Segment:
    """One immutable segment: per-field inverted indexes + doc count.
    Stored fields live in the enclosing table's columnstore (the provider's
    Batch), addressed by this segment's base row offset."""

    fields: dict[str, FieldIndex]
    num_docs: int
    base_row: int = 0           # offset of doc 0 in the table's row space

    def field(self, name: str) -> Optional[FieldIndex]:
        return self.fields.get(name)


def build_field_index(texts: Iterable[Optional[str]],
                      analyzer: Analyzer) -> FieldIndex:
    """Tokenize a column of documents into a FieldIndex (host-side; analysis
    is CPU work by design — SURVEY.md §7 hard part 5).

    The "simple" analyzer over pure-ASCII corpora takes the native C++
    one-pass indexer (serenedb_tpu_torch/native); everything else
    (stemming, stopwords, unicode casing) uses the Python analyzers.
    `native.BUILDS` counts which path built each index."""
    texts = list(texts)
    if getattr(analyzer, "name", "") == "simple" and \
            all(t is None or t.isascii() for t in texts):
        from ..native import build_field_index_native
        fi = build_field_index_native(texts)
        if fi is not None:
            _add_block_max(fi)
            return fi
    from ..native import BUILDS
    BUILDS.bump("python")
    term_postings: dict[str, list] = {}
    norms = []
    total_tokens = 0
    for doc_id, text in enumerate(texts):
        if text is None:
            norms.append(0)
            continue
        toks = analyzer.tokenize(text)
        norms.append(len(toks))
        total_tokens += len(toks)
        per_term: dict[str, list[int]] = {}
        for t in toks:
            per_term.setdefault(t.term, []).append(t.position)
        for term, poss in per_term.items():
            term_postings.setdefault(term, []).append((doc_id, poss))
    terms_sorted = sorted(term_postings)
    T = len(terms_sorted)
    doc_freq = np.zeros(T, dtype=np.int32)
    offsets = np.zeros(T + 1, dtype=np.int64)
    post_docs_l: list[int] = []
    post_tfs_l: list[int] = []
    pos_offsets_l: list[int] = [0]
    positions_l: list[int] = []
    block_max_l: list[int] = []
    block_offsets = np.zeros(T + 1, dtype=np.int64)
    for ti, term in enumerate(terms_sorted):
        plist = term_postings[term]
        doc_freq[ti] = len(plist)
        for doc_id, poss in plist:
            post_docs_l.append(doc_id)
            post_tfs_l.append(len(poss))
            positions_l.extend(poss)
            pos_offsets_l.append(len(positions_l))
        offsets[ti + 1] = len(post_docs_l)
        # per-128-block max tf (WAND metadata)
        tfs = np.asarray(post_tfs_l[offsets[ti]:offsets[ti + 1]],
                         dtype=np.int32)
        nb = -(-len(tfs) // BLOCK) if len(tfs) else 0
        for bi in range(nb):
            block_max_l.append(int(tfs[bi * BLOCK:(bi + 1) * BLOCK].max()))
        block_offsets[ti + 1] = len(block_max_l)
    return FieldIndex(
        terms=np.asarray(terms_sorted, dtype=object),
        doc_freq=doc_freq,
        offsets=offsets,
        post_docs=np.asarray(post_docs_l, dtype=np.int32),
        post_tfs=np.asarray(post_tfs_l, dtype=np.int32),
        pos_offsets=np.asarray(pos_offsets_l, dtype=np.int64),
        positions=np.asarray(positions_l, dtype=np.int32),
        norms=np.asarray(norms, dtype=np.int32),
        block_max_tf=np.asarray(block_max_l, dtype=np.int32),
        block_offsets=block_offsets,
        total_tokens=total_tokens,
    )


def _add_block_max(fi: FieldIndex) -> None:
    """Compute per-128-block max-tf metadata for an index built without it
    (the native builder returns raw postings; the parallel merge recomputes
    it because posting blocks span chunk boundaries). Vectorized: every
    term holds >= 1 posting, so the per-block start indices are strictly
    increasing and one maximum.reduceat covers all terms — same values as
    the per-term loop, bit for bit."""
    T = fi.num_terms
    block_offsets = np.zeros(T + 1, dtype=np.int64)
    if T == 0 or len(fi.post_tfs) == 0:
        fi.block_max_tf = np.zeros(0, dtype=np.int32)
        fi.block_offsets = block_offsets
        return
    df = (fi.offsets[1:] - fi.offsets[:-1]).astype(np.int64)
    nb = -(-df // BLOCK)
    block_offsets[1:] = np.cumsum(nb)
    total_blocks = int(block_offsets[-1])
    within = np.arange(total_blocks, dtype=np.int64) - \
        np.repeat(block_offsets[:-1], nb)
    starts = np.repeat(fi.offsets[:-1], nb) + within * BLOCK
    fi.block_max_tf = np.maximum.reduceat(
        fi.post_tfs, starts).astype(np.int32)
    fi.block_offsets = block_offsets


def merge_field_indexes(parts: list[FieldIndex],
                        doc_offsets: list[int]) -> FieldIndex:
    """Merge per-chunk FieldIndexes built over a partition of one document
    batch into the index the serial builder would have produced, bit for
    bit. `doc_offsets[i]` is chunk i's first doc id in the merged space;
    chunks arrive in ascending doc order, so concatenating each term's
    per-chunk postings in part order (doc ids shifted by the chunk offset)
    preserves the ascending-doc-id postings invariant without any sort.
    WAND block metadata is recomputed — 128-doc posting blocks span chunk
    boundaries, so per-chunk block maxima cannot be reused."""
    if len(parts) == 1 and not doc_offsets[0]:
        return parts[0]
    term_arrays = [p.terms_str for p in parts if p.num_terms]
    if not term_arrays:
        norms = np.concatenate([p.norms for p in parts]).astype(np.int32)
        return FieldIndex(
            terms=np.asarray([], dtype=object),
            doc_freq=np.zeros(0, dtype=np.int32),
            offsets=np.zeros(1, dtype=np.int64),
            post_docs=np.zeros(0, dtype=np.int32),
            post_tfs=np.zeros(0, dtype=np.int32),
            pos_offsets=np.zeros(1, dtype=np.int64),
            positions=np.zeros(0, dtype=np.int32),
            norms=norms,
            block_max_tf=np.zeros(0, dtype=np.int32),
            block_offsets=np.zeros(1, dtype=np.int64),
            total_tokens=0)
    merged_terms = np.unique(np.concatenate(term_arrays))
    T = len(merged_terms)
    maps = [np.searchsorted(merged_terms, p.terms_str) if p.num_terms
            else np.zeros(0, dtype=np.int64) for p in parts]
    # per-term doc freq, then postings laid out by a running per-term
    # write cursor — parts visit the cursor in chunk order, so each
    # term's merged postings are its chunks' postings concatenated
    df = np.zeros(T, dtype=np.int64)
    for p, m in zip(parts, maps):
        if p.num_terms:
            df[m] += p.doc_freq          # terms are unique per part
    offsets = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(df, out=offsets[1:])
    n_post = int(offsets[-1])
    post_docs = np.empty(n_post, dtype=np.int32)
    post_tfs = np.empty(n_post, dtype=np.int32)
    pos_lens = np.empty(n_post, dtype=np.int64)
    cursor = offsets[:-1].copy()
    dsts = []
    for p, m, doc_off in zip(parts, maps, doc_offsets):
        if not p.num_terms:
            dsts.append(None)
            continue
        dfp = p.doc_freq.astype(np.int64)
        within = np.arange(len(p.post_docs), dtype=np.int64) - \
            np.repeat(p.offsets[:-1], dfp)
        dst = np.repeat(cursor[m], dfp) + within
        post_docs[dst] = p.post_docs + np.int32(doc_off)
        post_tfs[dst] = p.post_tfs
        pos_lens[dst] = np.diff(p.pos_offsets)
        cursor[m] += dfp
        dsts.append(dst)
    pos_offsets = np.zeros(n_post + 1, dtype=np.int64)
    np.cumsum(pos_lens, out=pos_offsets[1:])
    positions = np.empty(int(pos_offsets[-1]), dtype=np.int32)
    for p, dst in zip(parts, dsts):
        if dst is None or not len(p.positions):
            continue
        plens = np.diff(p.pos_offsets)
        pwithin = np.arange(len(p.positions), dtype=np.int64) - \
            np.repeat(p.pos_offsets[:-1], plens)
        positions[np.repeat(pos_offsets[dst], plens) + pwithin] = \
            p.positions
    fi = FieldIndex(
        terms=np.asarray([str(t) for t in merged_terms], dtype=object),
        doc_freq=df.astype(np.int32),
        offsets=offsets,
        post_docs=post_docs,
        post_tfs=post_tfs,
        pos_offsets=pos_offsets,
        positions=positions,
        norms=np.concatenate([p.norms for p in parts]).astype(np.int32),
        block_max_tf=np.zeros(0, dtype=np.int32),
        block_offsets=np.zeros(T + 1, dtype=np.int64),
        total_tokens=sum(p.total_tokens for p in parts),
    )
    _add_block_max(fi)
    return fi


def _ingest_setting(settings, name: str):
    """Resolve a write-path setting: explicit session settings, the
    executing connection's session, or the global default."""
    if settings is None:
        from ..engine import CURRENT_CONNECTION
        conn = CURRENT_CONNECTION.get()
        if conn is not None:
            settings = conn.settings
    from ..utils.config import REGISTRY
    try:
        if settings is not None:
            return settings.get(name)
        return REGISTRY.get_global(name)
    except KeyError:
        return None


def build_field_index_auto(texts, analyzer: Analyzer,
                           settings=None) -> FieldIndex:
    """build_field_index, chunk-split across the shared worker pool when
    `serene_parallel_ingest` is on and the corpus spans at least two
    chunks. The fixed-size chunk split is independent of worker count and
    the merge is deterministic, so the result is BIT-IDENTICAL to the
    serial build at any parallelism (off/small corpora run the serial
    path — the parity oracle)."""
    texts = list(texts)
    n = len(texts)
    chunk = _ingest_setting(settings, "serene_ingest_chunk_docs") or 4096
    chunk = max(64, int(chunk))
    if not _ingest_setting(settings, "serene_parallel_ingest") or \
            n < 2 * chunk:
        return build_field_index(texts, analyzer)
    from ..parallel.pool import parallel_map, session_workers
    if session_workers(settings) <= 1:
        return build_field_index(texts, analyzer)
    bounds = list(range(0, n, chunk))
    parts = parallel_map(
        settings, lambda b: build_field_index(texts[b:b + chunk], analyzer),
        bounds)
    return merge_field_indexes(parts, bounds)


def build_segment(columns: dict[str, Iterable[Optional[str]]],
                  analyzers: dict[str, str],
                  num_docs: int, base_row: int = 0) -> Segment:
    fields = {}
    for name, texts in columns.items():
        an = get_analyzer(analyzers.get(name, "text"))
        fields[name] = build_field_index(texts, an)
    return Segment(fields, num_docs, base_row)


def merge_segments(segments: list[Segment], live_masks: list[np.ndarray],
                   columns_of, analyzers: dict[str, str]) -> Segment:
    """Compaction: rebuild one segment from the live docs of many.
    `columns_of(seg) -> dict[field, list[str]]` re-reads stored text (the
    reference's merge_writer reads the columnstore the same way)."""
    all_cols: dict[str, list] = {}
    total = 0
    for seg, live in zip(segments, live_masks):
        cols = columns_of(seg)
        keep = np.flatnonzero(live[:seg.num_docs])
        for name, texts in cols.items():
            all_cols.setdefault(name, []).extend(
                [texts[i] for i in keep])
        total += len(keep)
    return build_segment(all_cols, analyzers, total,
                         segments[0].base_row if segments else 0)
