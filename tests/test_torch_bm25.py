"""The port's BM25 device functions against the JAX package's, on the CPU.

The same index (made from a numpy seed), carried across as numpy arrays,
goes through `serenedb_tpu.ops.bm25` (jitted, on the CPU) and through
`serenedb_tpu_torch.ops.bm25` with its plain PyTorch versions on CPU
tensors. Scores agree within rtol 1e-5 / atol 1e-6 (f32 arithmetic in
the same order; XLA may fuse or contract differently); doc ids agree
except where scores tie within that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serenedb_tpu.ops import bm25 as ref_bm25
from serenedb_tpu_torch.carry import block_store_from_reference
from serenedb_tpu_torch.device import LAUNCHES
from serenedb_tpu_torch.ops import bm25 as port_bm25
from serenedb_tpu_torch.ops import bm25_kernels

RTOL, ATOL = 1e-5, 1e-6
SCORERS = ["bm25", "tfidf", "lm_dirichlet", "jelinek_mercer", "dfi"]


def _postings(n_docs, vocab, postings, seed):
    """(offsets, docs, tfs, doc_freq, norms) with zipf dfs; some tfs of 300
    and one term whose doc gap passes 2^16 (when n_docs allows) so rows
    land in the raw plane as well as the packed one."""
    rng = np.random.default_rng(seed)
    raw = 1.0 / np.arange(1, vocab + 1) ** 0.9
    df = np.minimum(np.maximum(raw / raw.sum() * postings, 1),
                    n_docs * 0.8).astype(np.int64)
    df[-1] = 0
    keys = np.repeat(np.arange(vocab), df) * n_docs + \
        rng.integers(0, n_docs, int(df.sum()))
    gap_row = np.r_[np.arange(39), n_docs - 1] + (vocab - 1) * n_docs
    keys = np.unique(np.concatenate([keys, gap_row]))
    terms, docs = keys // n_docs, (keys % n_docs).astype(np.int32)
    tfs = np.minimum(rng.zipf(1.7, len(keys)), 64).astype(np.int32)
    tfs[rng.random(len(tfs)) < 0.003] = 300
    doc_freq = np.bincount(terms, minlength=vocab).astype(np.int32)
    offsets = np.zeros(vocab + 1, dtype=np.int64)
    np.cumsum(doc_freq, out=offsets[1:])
    norms = np.bincount(docs, weights=tfs, minlength=n_docs).astype(np.int32)
    return offsets, docs, tfs, doc_freq, norms


def _stores(n_docs, vocab, postings, seed):
    offsets, docs, tfs, doc_freq, norms = _postings(n_docs, vocab, postings,
                                                    seed)
    ref = ref_bm25.build_block_store(offsets, docs, tfs, doc_freq, norms,
                                     n_docs)
    arrays = {name: np.asarray(getattr(ref, name)) for name in (
        "block_base", "block_gaps", "block_tfs8", "raw_docs", "raw_tfs",
        "norms", "block_offsets", "heavy", "flat_docs", "flat_tfs",
        "offsets", "row_plane", "row_slot", "block_bmax_tf",
        "block_bmin_dl", "norms_host", "ndocs_pad", "pad_row", "n_packed",
        "n_raw")}
    port = block_store_from_reference(arrays, device="cpu")
    avgdl = float(norms.sum()) / n_docs
    return ref, port, doc_freq, norms, avgdl


@pytest.fixture(scope="module")
def packed_stores():
    return _stores(n_docs=70_000, vocab=300, postings=40_000, seed=3)


@pytest.fixture(scope="module")
def dense_stores():
    return _stores(n_docs=3000, vocab=200, postings=20_000, seed=4)


def _queries(vocab, any_require, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for qi in range(8):
        n_terms = 1 + qi % 4
        # common terms and rare ones, so both block planes and tails fill
        tids = np.concatenate([rng.choice(8, 1), rng.choice(
            np.arange(8, vocab), n_terms - 1, replace=False)])
        req = n_terms if any_require and qi % 2 else 0
        out.append((tids.astype(np.int64), req))
    out[-1] = (np.array([vocab - 1, 0], dtype=np.int64), 0)  # raw gap row
    return out


def _weights(scorer, docs_n, doc_freq, tfs_total, ctf):
    if scorer not in ref_bm25.LM_SCORERS:
        return None

    def weight_of(t):
        return ref_bm25.term_weight_for(scorer, docs_n, None, ctf[t],
                                        tfs_total)
    return weight_of


def _assert_topk_close(ref_vals, ref_docs, vals, docs):
    ref_vals, ref_docs = np.asarray(ref_vals), np.asarray(ref_docs)
    vals, docs = vals.numpy(), docs.numpy()
    np.testing.assert_allclose(vals, ref_vals, rtol=RTOL, atol=ATOL)
    diff = docs != ref_docs
    if diff.any():
        # ids may differ only where the scores tie within the tolerance
        for r, c in zip(*np.nonzero(diff)):
            row = ref_vals[r]
            ties = np.isclose(row, row[c], rtol=RTOL, atol=ATOL)
            assert ties.sum() > 1, (r, c, ref_vals[r, c], vals[r, c])


@pytest.mark.parametrize("any_require", [False, True])
@pytest.mark.parametrize("scorer", SCORERS)
def test_score_topk_packed_matches_reference(packed_stores, scorer,
                                             any_require):
    ref, port, doc_freq, norms, avgdl = packed_stores
    n_docs = len(norms)
    ctf = np.bincount(np.repeat(np.arange(len(doc_freq)), doc_freq),
                      weights=ref.flat_tfs, minlength=len(doc_freq))
    weight_of = _weights(scorer, n_docs, doc_freq, float(ref.flat_tfs.sum()),
                         ctf)
    queries = _queries(len(doc_freq), any_require)
    rqb = ref_bm25.assemble_query_batch(ref, n_docs, queries, doc_freq,
                                        scorer, idf_of=weight_of)
    pqb = port_bm25.assemble_query_batch(port, n_docs, queries, doc_freq,
                                         scorer, idf_of=weight_of)
    r_ints, r_floats, nb, nr, tt, nq = ref_bm25.pack_query_batch(rqb)
    p_ints, p_floats, *sizes = port_bm25.pack_query_batch(pqb)
    assert sizes == [nb, nr, tt, nq]
    assert nr > 0 and int((rqb.raw_idx != ref.n_raw).sum()) > 0
    # the port's buffer is the reference's plus the three rank sections
    np.testing.assert_array_equal(p_ints[:len(r_ints)], r_ints)
    np.testing.assert_array_equal(p_floats, r_floats)
    k1 = ref_bm25.scorer_param(scorer, 1.2)
    kk = 100
    req = bool(rqb.require.any())
    assert req == any_require
    ref_vals, ref_docs = ref_bm25.score_topk_packed(
        ref.block_base, ref.block_gaps, ref.block_tfs8, ref.raw_docs,
        ref.raw_tfs, ref.norms, jnp.asarray(r_ints), jnp.asarray(r_floats),
        nb, nr, tt, ref.ndocs_pad, kk, nq, req, k1, 0.75, avgdl, scorer)
    before = LAUNCHES.snapshot()
    vals, docs = port_bm25.score_topk_packed(
        port.block_base, port.block_gaps, port.block_tfs8, port.raw_docs,
        port.raw_tfs, port.norms, torch.from_numpy(p_ints),
        torch.from_numpy(p_floats), nb, nr, tt, port.ndocs_pad, kk, nq, req,
        k1, 0.75, avgdl, scorer)
    after = LAUNCHES.snapshot()
    for name in ("bm25_accumulate.plain", "topk_rows.plain"):
        assert after.get(name, 0) > before.get(name, 0)
    assert vals.dtype == torch.float32 and docs.dtype == torch.int32
    assert tuple(vals.shape) == (nq, kk)
    _assert_topk_close(jax.device_get(ref_vals), jax.device_get(ref_docs),
                       vals, docs)


@pytest.mark.parametrize("scorer", ["bm25", "tfidf"])
def test_build_dense_matches_reference(dense_stores, scorer):
    ref, port, doc_freq, norms, avgdl = dense_stores
    before = LAUNCHES.get("build_dense.plain")
    ref_ds = ref_bm25.build_dense_store(ref, doc_freq, avgdl, 1.2, 0.75,
                                        scorer)
    port_ds = port_bm25.build_dense_store(port, doc_freq, avgdl, 1.2, 0.75,
                                          scorer)
    assert LAUNCHES.get("build_dense.plain") == before + 1
    assert (port_ds.ndocs_pad, port_ds.v_pad) == (ref_ds.ndocs_pad,
                                                  ref_ds.v_pad)
    np.testing.assert_allclose(port_ds.S.numpy(), np.asarray(ref_ds.S),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("any_require", [False, True])
@pytest.mark.parametrize("scorer", ["bm25", "tfidf"])
def test_dense_topk_matches_reference(dense_stores, scorer, any_require):
    ref, port, doc_freq, norms, avgdl = dense_stores
    n_docs = len(norms)
    ref_ds = ref_bm25.build_dense_store(ref, doc_freq, avgdl, 1.2, 0.75,
                                        scorer)
    port_ds = port_bm25.build_dense_store(port, doc_freq, avgdl, 1.2, 0.75,
                                          scorer)
    queries = _queries(len(doc_freq), any_require, seed=1)
    W, require, _ = ref_bm25.assemble_dense_weights(
        ref_ds.v_pad, queries, n_docs, doc_freq, scorer)
    pW, prequire, _ = port_bm25.assemble_dense_weights(
        port_ds.v_pad, queries, n_docs, doc_freq, scorer)
    np.testing.assert_array_equal(W, pW)
    np.testing.assert_array_equal(require, prequire)
    req = bool(require.any())
    assert req == any_require
    ref_vals, ref_docs = ref_bm25.dense_topk(
        ref_ds.S, jnp.asarray(W), jnp.asarray(require), 10, req)
    before = LAUNCHES.get("topk_rows.plain")
    vals, docs = port_bm25.dense_topk(port_ds.S, torch.from_numpy(pW),
                                      torch.from_numpy(prequire), 10, req)
    assert LAUNCHES.get("topk_rows.plain") == before + 1
    _assert_topk_close(jax.device_get(ref_vals), jax.device_get(ref_docs),
                       vals, docs)


def _tie_plane(rows, n, seed, levels):
    rng = np.random.default_rng(seed)
    plane = rng.choice(np.float32(levels), size=(rows, n))
    plane[0] = 0.0                                # all ties
    plane[1, : n // 2] = levels[-1]               # a long run of maxima
    return plane


@pytest.mark.parametrize("k", [1, 10, 100, 1000])
@pytest.mark.parametrize("n", [1024, 5000])
def test_topk_rows_plain_tie_order_matches_lax_top_k(k, n):
    if k > n:
        pytest.skip("k above the row length")
    plane = _tie_plane(6, n, seed=k + n,
                       levels=[0.0, 0.5, 1.25, 1.25, 4.0])
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(plane), k)
    vals, idx = bm25_kernels.topk_rows(torch.from_numpy(plane), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


@pytest.mark.parametrize("hits_dtype", [torch.int32, torch.float32])
def test_topk_rows_plain_mask_matches_reference_masking(hits_dtype):
    """The fused conjunction mask: rows with require > 0 zero the scores
    whose hits fall short, as `_score_topk` / `dense_topk` do before top_k."""
    rng = np.random.default_rng(2)
    plane = rng.choice(np.float32([0.0, 1.0, 2.0, 3.5]), size=(4, 3000))
    hits = rng.integers(0, 4, size=(4, 3000)).astype(np.int32)
    require = np.array([0, 1, 2, 3], dtype=np.int32)
    need = require[:, None]
    masked = np.where((need <= 0) | (hits >= need), plane, 0.0)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(masked), 50)
    vals, idx = bm25_kernels.topk_rows(
        torch.from_numpy(plane), 50,
        hits=torch.from_numpy(hits).to(hits_dtype),
        require=torch.from_numpy(require))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


@pytest.mark.parametrize("k", [7, 1003])
def test_topk_rows_plain_on_unaligned_rows_matches_lax_top_k(k):
    """Rows of 1,003 columns (not a multiple of 4), up to k = ncols, with
    int hits and a mixed require: equal to lax.top_k of the masked plane."""
    rng = np.random.default_rng(k)
    plane = _tie_plane(5, 1003, seed=k, levels=[0.0, 0.5, 1.25, 4.0])
    plane[2] = -0.0
    hits = rng.integers(0, 3, size=(5, 1003)).astype(np.int32)
    require = np.array([0, 1, 2, 1, 0], dtype=np.int32)
    need = require[:, None]
    masked = np.where((need <= 0) | (hits >= need), plane, 0.0)
    masked = np.where(masked == 0, np.float32(0.0), masked)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(masked), k)
    vals, idx = bm25_kernels.topk_rows(
        torch.from_numpy(plane), k, hits=torch.from_numpy(hits),
        require=torch.from_numpy(require))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


@pytest.mark.parametrize("k", [3, 40])
def test_topk_rows_plain_orders_nan_by_its_sign_as_lax_top_k(k):
    """A positive NaN above +inf, a negative one below -inf, -0.0 tied
    with +0.0: the plain version's order is lax.top_k's."""
    rng = np.random.default_rng(k)
    plane = rng.choice(np.float32([0.0, -0.0, 1.5, -2.0]), size=(3, 41))
    plane[0, ::5] = np.nan
    plane[0, 2::5] = -np.nan
    plane[1, ::4] = -np.nan
    plane[1, 1::9] = -np.inf
    plane[2, ::3] = np.inf
    plane[2, 1::6] = np.nan
    masked = np.where(plane == 0, np.float32(0.0), plane)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(masked), k)
    vals, idx = bm25_kernels.topk_rows(torch.from_numpy(plane), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  np.asarray(ref_vals).view(np.uint32))


def test_topk_rows_rejects_k_outside_the_row():
    with pytest.raises(ValueError):
        bm25_kernels.topk_rows(torch.zeros((2, 8)), 9)
    with pytest.raises(ValueError):
        bm25_kernels.topk_rows(torch.zeros((2, 8)), 2,
                               hits=torch.zeros((2, 8), dtype=torch.int32))


def test_host_helpers_equal_the_reference():
    for k in (1, 9, 10, 11, 100, 101, 1000, 1001, 5000):
        assert port_bm25.pad_k(k) == ref_bm25.pad_k(k)
    rng = np.random.default_rng(0)
    scores = rng.choice(np.float32([0.0, 1.0, 2.0]), 500)
    docs = np.arange(500, dtype=np.int32)
    for k in (1, 7, 100, 600):
        for a, b in zip(port_bm25.topk_tie_exact(scores, docs, k),
                        ref_bm25.topk_tie_exact(scores, docs, k)):
            np.testing.assert_array_equal(a, b)
    df = rng.integers(1, 900, 50).astype(np.int32)
    for scorer in ("bm25", "tfidf"):
        np.testing.assert_array_equal(port_bm25.idf_for(scorer, 1000, df),
                                      ref_bm25.idf_for(scorer, 1000, df))
    for ndocs_pad, vocab in ((1024, 10), (100_352, 2000), (8_000_512, 200_000)):
        assert port_bm25.dense_fits(ndocs_pad, vocab) == \
            ref_bm25.dense_fits(ndocs_pad, vocab)


def test_wand_plans_equal_the_reference(packed_stores):
    ref, port, doc_freq, norms, avgdl = packed_stores
    n_docs = len(norms)
    for tids in ([0, 1], [2, 9, 40], [0, 3, 5, 7]):
        t = np.asarray(tids, dtype=np.int64)
        idf = ref_bm25.idf_for("bm25", n_docs, doc_freq[t])
        rp = ref_bm25.wand_plan(ref, t, idf, 10, avgdl, 1.2, 0.75, "bm25")
        pp = port_bm25.wand_plan(port, t, idf, 10, avgdl, 1.2, 0.75, "bm25")
        assert (rp is None) == (pp is None)
        if rp is None:
            continue
        assert rp.theta == pp.theta and rp.maxscore == pp.maxscore
        assert rp.kept.keys() == pp.kept.keys()
        for tid in rp.kept:
            np.testing.assert_array_equal(rp.kept[tid], pp.kept[tid])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_bitmap_matches_reference(packed_stores, seed):
    """The disjunctive match bitmap over packed rows (their padding
    included), raw rows and tails with -1 pads and a doc past the bitmap:
    bit for bit the reference's."""
    ref, port, _df, _norms, _avg = packed_stores
    rng = np.random.default_rng(seed)
    n_packed = int(np.asarray(ref.block_base).shape[0])
    n_raw = int(np.asarray(ref.raw_docs).shape[0])
    assert n_packed > 1 and n_raw > 1
    row_idx = rng.choice(n_packed, min(n_packed, 40 + 20 * seed),
                         replace=False).astype(np.int32)
    raw_idx = rng.choice(n_raw, min(n_raw, 1 + seed), replace=False) \
        .astype(np.int32)
    flat = np.asarray(ref.flat_docs)
    tail = np.concatenate([rng.choice(flat, 50), [-1, -1, ref.ndocs_pad + 3]]
                          ).astype(np.int32)
    want = np.asarray(ref_bm25.match_bitmap(
        ref.block_base, ref.block_gaps, ref.block_tfs8, jnp.asarray(row_idx),
        ref.raw_docs, jnp.asarray(raw_idx), jnp.asarray(tail),
        ref.ndocs_pad))
    LAUNCHES.reset()
    got = port_bm25.match_bitmap(
        port.block_base, port.block_gaps, port.block_tfs8,
        torch.from_numpy(row_idx), port.raw_docs, torch.from_numpy(raw_idx),
        torch.from_numpy(tail), port.ndocs_pad)
    assert LAUNCHES.get("match_bitmap.plain") == 1
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 50


@pytest.mark.parametrize("empty", ["all", "packed", "raw", "tails",
                                   "packed+raw"])
def test_match_bitmap_empty_sections_match_reference(packed_stores, empty):
    """Any of the three sections empty (all three too), a tail of docs
    past the bitmap only: bit for bit the reference's, one call."""
    ref, port, _df, _norms, _avg = packed_stores
    rng = np.random.default_rng(7)
    n_packed = int(np.asarray(ref.block_base).shape[0])
    n_raw = int(np.asarray(ref.raw_docs).shape[0])
    row_idx = rng.choice(n_packed, min(n_packed, 30), replace=False)
    raw_idx = rng.choice(n_raw, min(n_raw, 2), replace=False)
    tail = np.concatenate([rng.choice(np.asarray(ref.flat_docs), 20),
                           [ref.ndocs_pad, ref.ndocs_pad + 9, -1]])
    if empty in ("all", "packed", "packed+raw"):
        row_idx = row_idx[:0]
    if empty in ("all", "raw", "packed+raw"):
        raw_idx = raw_idx[:0]
    if empty in ("all", "tails"):
        tail = tail[:0]
    row_idx, raw_idx, tail = (a.astype(np.int32)
                              for a in (row_idx, raw_idx, tail))
    want = np.asarray(ref_bm25.match_bitmap(
        ref.block_base, ref.block_gaps, ref.block_tfs8, jnp.asarray(row_idx),
        ref.raw_docs, jnp.asarray(raw_idx), jnp.asarray(tail),
        ref.ndocs_pad))
    LAUNCHES.reset()
    got = port_bm25.match_bitmap(
        port.block_base, port.block_gaps, port.block_tfs8,
        torch.from_numpy(row_idx), port.raw_docs, torch.from_numpy(raw_idx),
        torch.from_numpy(tail), port.ndocs_pad)
    assert LAUNCHES.get("match_bitmap.plain") == 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want.sum() == 0) == (empty == "all")


@pytest.mark.parametrize("scorer", ["bm25", "tfidf"])
@pytest.mark.parametrize("n", [1, 1500, 4096])
def test_ragged_contribs_uploads_exactly_its_postings(n, scorer):
    """`ragged_contribs` sizes its arrays exactly: 12 bytes a posting
    uploaded (int32 tf, int32 dl, f32 w), and the values of the padded
    launch it made before (a power of two, floor 1,024), bit for bit;
    the reference's within rtol 1e-6 (XLA's CPU code rounds its chain
    differently in the last bit)."""
    from serenedb_tpu_torch.device import UPLOADS
    rng = np.random.default_rng(n)
    tfs = rng.integers(1, 300, n).astype(np.int32)
    dls = rng.integers(1, 900, n).astype(np.int32)
    w = (rng.random(n) * 8).astype(np.float32)
    b0 = UPLOADS.get("bytes")
    got = port_bm25.ragged_contribs(tfs, dls, w, 1.2, 0.75, 37.5, scorer,
                                    device="cpu")
    assert UPLOADS.get("bytes") - b0 == 12 * n
    assert got.dtype == np.float32 and got.shape == (n,)
    n_pad = max(1024, 1 << (n - 1).bit_length())

    def pad(a):
        out = np.zeros(n_pad, dtype=a.dtype)
        out[:n] = a
        return torch.from_numpy(out)
    padded = port_bm25.contrib_flat(
        pad(tfs), pad(dls), pad(w), port_bm25.scorer_param(scorer, 1.2),
        0.75, 37.5, scorer).numpy()[:n]
    np.testing.assert_array_equal(got.view(np.int32),
                                  padded.view(np.int32))
    ref = ref_bm25.ragged_contribs(tfs, dls, w, 1.2, 0.75, 37.5, scorer)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("scorer", ["bm25", "tfidf"])
@pytest.mark.parametrize("n", [0, 1, 1503, 4096])
def test_ragged_contribs_gathers_the_store_norms(n, scorer):
    """`ragged_contribs` in the route's form: doc ids go up in one packed
    upload (12 bytes a posting) and each dl is gathered from the store's
    resident norms, which hold norms_host's int32 values; the result
    equals the dl form (dls = norms_host[docs]) bit for bit, and the
    reference's given the same dls bit for bit for tfidf, within rtol
    1e-6 for bm25 (XLA's CPU code rounds bm25's chain differently in the
    last bit of ~5 % of the postings)."""
    from serenedb_tpu_torch.device import UPLOADS
    offsets, docs, tfs, doc_freq, norms = _postings(5000, 60, 9000, seed=n)
    store = port_bm25.build_block_store(offsets, docs, tfs, doc_freq, norms,
                                        5000, device="cpu")
    assert store.norms.dtype == torch.int32
    np.testing.assert_array_equal(store.norms[:5000].numpy(),
                                  store.norms_host)
    assert store.norms_host.dtype == np.int32
    rng = np.random.default_rng(n)
    d = rng.integers(0, 5000, n).astype(np.int32)
    t = rng.integers(1, 300, n).astype(np.int32)
    w = (rng.random(n) * 8).astype(np.float32)
    LAUNCHES.reset()
    b0 = UPLOADS.get("bytes")
    got = port_bm25.ragged_contribs(t, d, w, 1.2, 0.75, 37.5, scorer,
                                    norms=store.norms)
    assert UPLOADS.get("bytes") - b0 == 12 * n
    assert LAUNCHES.get("contrib_flat.plain") == (1 if n else 0)
    assert got.dtype == np.float32 and got.shape == (n,)
    dls = store.norms_host[d]
    by_dl = port_bm25.ragged_contribs(t, dls, w, 1.2, 0.75, 37.5, scorer,
                                      device="cpu")
    np.testing.assert_array_equal(got.view(np.int32), by_dl.view(np.int32))
    if n:
        ref = ref_bm25.ragged_contribs(t, dls, w, 1.2, 0.75, 37.5, scorer)
        if scorer == "tfidf":
            np.testing.assert_array_equal(got.view(np.int32),
                                          ref.view(np.int32))
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
