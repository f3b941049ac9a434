"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test asks the `cuda` fixture for the device, and the
fixture skips when no card is present. Run them on a machine with an H100:

    python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import time

import numpy as np
import pytest
import torch

from serenedb_tpu_torch.device import LAUNCHES
from serenedb_tpu_torch.ops import bm25 as bm25_ops
from serenedb_tpu_torch.ops import bm25_kernels as kern
from serenedb_tpu_torch.search.segment import FieldIndex, _add_block_max

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _index(n_docs=70_000, vocab=400, postings=300_000, seed=5):
    """Synthetic index whose heavy terms fill both block planes: tfs of
    300 and a doc gap past 2^16 force rows into the raw plane."""
    rng = np.random.default_rng(seed)
    raw = 1.0 / np.arange(1, vocab + 1) ** 0.9
    df = np.minimum(np.maximum(raw / raw.sum() * postings, 1),
                    n_docs * 0.8).astype(np.int64)
    df[-1] = 0
    keys = np.repeat(np.arange(vocab), df) * n_docs + \
        rng.integers(0, n_docs, int(df.sum()))
    # the last term: one block row whose last doc gap passes 2^16
    gap_row = np.r_[np.arange(39), n_docs - 1] + (vocab - 1) * n_docs
    keys = np.unique(np.concatenate([keys, gap_row]))
    terms, docs = keys // n_docs, (keys % n_docs).astype(np.int32)
    tfs = np.minimum(rng.zipf(1.7, len(keys)), 64).astype(np.int32)
    tfs[rng.random(len(tfs)) < 0.002] = 300
    doc_freq = np.bincount(terms, minlength=vocab).astype(np.int32)
    offsets = np.zeros(vocab + 1, dtype=np.int64)
    np.cumsum(doc_freq, out=offsets[1:])
    norms = np.bincount(docs, weights=tfs, minlength=n_docs).astype(np.int32)
    fi = FieldIndex(
        terms=np.asarray([f"w{i:05d}" for i in range(vocab)], dtype=object),
        doc_freq=doc_freq, offsets=offsets, post_docs=docs, post_tfs=tfs,
        pos_offsets=np.zeros(len(docs) + 1, dtype=np.int64),
        positions=np.empty(0, dtype=np.int32), norms=norms,
        block_max_tf=np.empty(0, dtype=np.int32),
        block_offsets=np.zeros(vocab + 1, dtype=np.int64),
        total_tokens=int(tfs.sum()))
    _add_block_max(fi)
    return fi


def _store(cuda):
    fi = _index()
    store = bm25_ops.build_block_store(
        fi.offsets, fi.post_docs, fi.post_tfs, fi.doc_freq, fi.norms,
        len(fi.norms), device=cuda)
    assert store.n_raw > 0 and store.n_packed > 0
    return fi, store


def _batch(fi, store, scorer):
    rng = np.random.default_rng(1)
    vocab = len(fi.doc_freq)
    queries = []
    for qi in range(16):
        n_terms = 1 + qi % 4
        tids = rng.choice(vocab, n_terms, replace=False)
        queries.append((tids.astype(np.int64), n_terms if qi % 3 == 2 else 0))
    weight_of = None
    if scorer in bm25_ops.LM_SCORERS:
        def weight_of(t):
            return bm25_ops.term_weight_for(scorer, len(fi.norms), None,
                                            fi.ctf[t], fi.total_tokens)
    qb = bm25_ops.assemble_query_batch(store, len(fi.norms), queries,
                                       fi.doc_freq, scorer,
                                       idf_of=weight_of)
    return qb


@pytest.mark.parametrize("scorer", ["bm25", "tfidf", "lm_dirichlet",
                                    "jelinek_mercer", "dfi"])
def test_bm25_accumulate_kernel_matches_plain(cuda, scorer):
    fi, store = _store(cuda)
    qb = _batch(fi, store, scorer)
    ints, floats, nb, nr, tt, nq = bm25_ops.pack_query_batch(qb)
    s = bm25_ops._unpack_ints(torch.from_numpy(ints).to(cuda), nb, nr, tt,
                              nq)
    f = torch.from_numpy(floats).to(cuda)
    args = (store.block_base, store.block_gaps, store.block_tfs8,
            store.raw_docs, store.raw_tfs, store.norms, s["row_idx"],
            f[:nb], s["row_qid"], s["row_rank"], s["raw_idx"],
            f[nb:nb + nr], s["raw_qid"], s["raw_rank"], s["tail_docs"],
            s["tail_tfs"], f[nb + nr:], s["tail_qid"], s["tail_rank"],
            store.ndocs_pad, nq, True,
            bm25_ops.scorer_param(scorer, 1.2), 0.75,
            float(fi.avgdl), scorer)
    before = LAUNCHES.get("bm25_accumulate")
    got_s, got_h = kern.bm25_accumulate(*args)
    torch.cuda.synchronize()
    assert LAUNCHES.get("bm25_accumulate") > before
    ref_s, ref_h = kern.bm25_accumulate_plain(*args)
    torch.testing.assert_close(got_s, ref_s, rtol=1e-5, atol=1e-6)
    assert torch.equal(got_h, ref_h)
    again_s, _ = kern.bm25_accumulate(*args)
    assert torch.equal(again_s, got_s)        # no float atomics: same bits


@pytest.mark.parametrize("scorer", ["bm25", "tfidf"])
def test_build_dense_kernel_matches_plain(cuda, scorer):
    fi, store = _store(cuda)
    before = LAUNCHES.get("build_dense")
    got = bm25_ops.build_dense_store(store, fi.doc_freq, float(fi.avgdl),
                                     1.2, 0.75, scorer).S
    torch.cuda.synchronize()
    assert LAUNCHES.get("build_dense") == before + 3
    orig = kern.build_dense
    try:
        kern.build_dense = kern.build_dense_plain
        ref = bm25_ops.build_dense_store(store, fi.doc_freq,
                                         float(fi.avgdl), 1.2, 0.75,
                                         scorer).S
    finally:
        kern.build_dense = orig
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def _tie_plane(rows, n, seed):
    rng = np.random.default_rng(seed)
    plane = rng.choice(np.float32([0.0, 1.5, 2.25, 7.0]), size=(rows, n))
    plane[0] = 0.0                              # a row of ties only
    if rows > 3:
        plane[1, ::3] = -0.0
        plane[2] = rng.random(n).astype(np.float32)
        # NaN by its sign bit: +NaN above +inf, -NaN below -inf
        plane[3, ::7] = np.nan
        plane[3, 3::7] = -np.nan
        plane[3, 5::11] = -np.inf
    return plane


def _topk_case(cuda, rows, n, k, hits_dtype, seed):
    scores = torch.from_numpy(_tie_plane(rows, n, seed)).to(cuda)
    hits = require = None
    if hits_dtype is not None:
        rng = np.random.default_rng(7)
        hits = torch.from_numpy(rng.integers(0, 3, (rows, n))).to(
            cuda, hits_dtype)
        require = torch.from_numpy(
            np.resize(np.int32([0, 1, 2, 0, 2, 1, 0, 3]), rows)).to(cuda)
    before = LAUNCHES.get("topk_rows")
    vals, idx = kern.topk_rows(scores, k, hits, require)
    again_v, again_i = kern.topk_rows(scores, k, hits, require)
    torch.cuda.synchronize()
    assert LAUNCHES.get("topk_rows") == before + 2
    ref_v, ref_i = kern.topk_rows_plain(scores, k, hits, require)
    assert torch.equal(idx, ref_i)
    assert torch.equal(vals.view(torch.int32), ref_v.view(torch.int32))
    assert torch.equal(idx, again_i)
    assert torch.equal(vals.view(torch.int32), again_v.view(torch.int32))


@pytest.mark.parametrize("k", [1, 10, 100, 1000, kern.TOPK_ONE_MAX,
                               kern.TOPK_ONE_MAX + 1, 20_000])
@pytest.mark.parametrize("hits_dtype", [None, torch.int32, torch.float32])
@pytest.mark.parametrize("rows,n", [(8, 50_000), (8, 50_001), (1, 50_001)])
def test_topk_rows_kernel_matches_plain_bit_for_bit(cuda, k, hits_dtype,
                                                    rows, n):
    """Both regimes (k on either side of TOPK_ONE_MAX), aligned and
    unaligned rows (n % 4 != 0), a row of ties, -0.0 and NaN."""
    _topk_case(cuda, rows, n, k, hits_dtype, seed=k)


@pytest.mark.parametrize("k", [1, 10, 37])
@pytest.mark.parametrize("hits_dtype", [None, torch.int32, torch.float32])
def test_topk_rows_past_the_grid_row_limit(cuda, k, hits_dtype):
    """70,000 short rows (more than a grid's y dimension holds) of 37
    columns, up to k = ncols: one call."""
    _topk_case(cuda, 70_000, 37, k, hits_dtype, seed=k + 1)


def test_topk_rows_misaligned_hits_and_scores(cuda):
    """hits and scores at different 16-byte offsets: the scalar loads."""
    rows, n, k = 4, 10_003, 50
    rng = np.random.default_rng(3)
    scores = torch.from_numpy(
        rng.random((rows, n)).astype(np.float32)).to(cuda)
    flat = torch.from_numpy(rng.integers(0, 3, rows * n + 1)).to(
        cuda, torch.int32)
    hits = flat[1:].view(rows, n)
    require = torch.tensor([1, 2, 0, 1], dtype=torch.int32, device=cuda)
    vals, idx = kern.topk_rows(scores, k, hits, require)
    ref_v, ref_i = kern.topk_rows_plain(scores, k, hits, require)
    torch.cuda.synchronize()
    assert torch.equal(idx, ref_i)
    assert torch.equal(vals.view(torch.int32), ref_v.view(torch.int32))


_SELECT_FLOORS = [32, 256, 1024]


@pytest.mark.parametrize("floor", _SELECT_FLOORS)
def test_select_scratch_matches_the_kernel_sizes(cuda, floor):
    """ops/select.py `scratch` (the Python wrappers' buffer sizes) equals
    select.cuh `sel::level_caps` (vector.cu `select_cap`) over flat and
    merge levels, unsorted and tile-sorted input."""
    from serenedb_tpu_torch.ops import _build, select
    lib = _build.load("vector")
    for keep in (1, 10, 100, 4096, 8192, 8193, 20_000):
        tile = select.tile_for(keep, floor)
        for run in sorted({1, min(keep, tile)}):
            for m in (1, 3, 17, 1000):
                n = max(m, -(-keep // run)) * run
                for rows in (1, 7):
                    want = select.scratch(rows, n, run, keep, floor)
                    got = (lib.select_cap(rows, n, run, keep, floor, 0),
                           lib.select_cap(rows, n, run, keep, floor, 1))
                    assert got == want, (rows, n, run, keep, floor)


# -- analytics: agg_scan and agg_fold ---------------------------------------

from serenedb_tpu_torch.columnar import dtypes as dt  # noqa: E402
from serenedb_tpu_torch.columnar.column import Column  # noqa: E402
from serenedb_tpu_torch.columnar.device import to_device_column  # noqa: E402
from serenedb_tpu_torch.ops import agg as agg_ops  # noqa: E402
from serenedb_tpu_torch.ops import agg_kernels as ak  # noqa: E402


def _scan_cols(cuda, n=50_000, seed=3):
    """Slots: 0 FOR8 int, 1 FOR16 int, 2 raw int32 (wide range), 3 int8,
    4 f32 with NaN/-0.0/inf, 5 dictionary codes; ~8% NULLs each."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n).astype(np.float64) * 50
    f[rng.random(n) < 0.01] = np.nan
    f[:4] = [-0.0, 0.0, np.inf, -np.inf]
    raw = [
        Column(dt.INT, rng.integers(-100, 100, n).astype(np.int32)),
        Column(dt.INT, rng.integers(-30000, 30000, n).astype(np.int32)),
        Column(dt.INT, rng.integers(-2**31, 2**31, n).astype(np.int32)),
        Column(dt.TINYINT, rng.integers(-128, 128, n).astype(np.int8)),
        Column(dt.DOUBLE, f),
        Column(dt.INT, rng.integers(0, 7, n).astype(np.int32)),
    ]
    for c in raw:
        c.validity = rng.random(n) > 0.08
    dcs = [to_device_column(c, device=cuda) for c in raw]
    kinds = [ak.col_kind(dc) for dc in dcs]
    assert [k for k, _ in kinds] == [ak.COL_U8, ak.COL_U16, ak.COL_I32,
                                     ak.COL_I8, ak.COL_F32, ak.COL_U8]
    rows = dcs[0].data.shape[0]
    rowmask = torch.zeros(rows * 128, dtype=torch.bool)
    rowmask[:n] = True
    return (dcs, [k for k, _ in kinds], [o for _, o in kinds],
            rowmask.view(rows, 128).to(cuda))


C = ak.CMP_CODES
_COL = lambda s: (ak.OP_COL, s, 0)  # noqa: E731
_I = lambda v: (ak.OP_I32, 0, v)  # noqa: E731
# (slot0 > -50 AND slot1 < 20000) OR NOT (slot3 IS NULL)
_PRED = (_COL(0), _I(-50), (ak.OP_CMP_I, 0, C[">"]), _COL(1), _I(20000),
         (ak.OP_CMP_I, 0, C["<"]), (ak.OP_AND, 0, 0), _COL(3),
         (ak.OP_IS_NULL, 0, 0), (ak.OP_NOT, 0, 0), (ak.OP_OR, 0, 0))
_ARGS = {
    ak.AGG_COUNT: (_COL(4),),
    ak.AGG_SUM_I: (_COL(2), _COL(0), (ak.OP_MUL_I, 0, 0)),   # wraps
    ak.AGG_SUM_F: (_COL(4), _COL(1), (ak.OP_I2F, 0, 0),
                   (ak.OP_ADD_F, 0, 0)),
    ak.AGG_MIN_I: (_COL(3), _COL(3), (ak.OP_MUL_I, 0, 0),
                   (ak.OP_WRAP8, 0, 0)),
    ak.AGG_MAX_I: (_COL(4), (ak.OP_F2I, 0, 0)),
    ak.AGG_MIN_F: (_COL(4),),
    ak.AGG_MAX_F: (_COL(4), (ak.OP_F32, 0, ak.f32_bits(0.5)),
                   (ak.OP_MUL_F, 0, 0)),
}


def _all_aggs():
    aggs = [ak.ScanAgg(kind, ops) for kind, ops in _ARGS.items()]
    aggs.append(ak.ScanAgg(ak.AGG_PRESENCE, None, 5, ak.KEY_INT, 0, 8))
    return aggs


def _same_f32(a, b):
    """Bit for bit, NaN meeting NaN (the card's NaN is canonical)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _assert_raw_equal(got, ref):
    (rc, outs), (rc_ref, outs_ref) = got, ref
    assert torch.equal(rc, rc_ref)
    for o, r in zip(outs, outs_ref):
        for a, b in zip(o, r):
            if a.dtype == torch.float32:
                assert _same_f32(a, b)
            else:
                assert torch.equal(a, b)


def _small_limit(aggs):
    """The largest G the SMALL regime takes for these aggregates."""
    per_group = ak.small_cells_bytes(ak.ScanSpec([], [], G=1, aggs=aggs))
    return ak.SMALL_SMEM_BYTES // per_group


@pytest.mark.parametrize("mode", ["scalar", "small", "edge", "edge+1",
                                  "direct", "factorized", "1000001"])
def test_agg_scan_matches_plain(cuda, mode):
    """Every regime of the split, at its boundary G values, bit for bit
    (f32 partial planes and large-G sums included), on the whole table
    and on a tile sub-range; two launches bit-identical."""
    dcs, kinds, offs, rowmask = _scan_cols(cuda)
    cols = [(dc.data, dc.mask) for dc in dcs]
    codes, keys, G = None, [], 1
    lim = _small_limit(_all_aggs())
    if mode == "direct":
        keys = [(ak.KEY_INT, 5, 0, 8), (ak.KEY_INT, 0, -100, 201)]
        G = 8 * 201
    elif mode == "small":
        keys = [(ak.KEY_INT, 5, 0, 8), (ak.KEY_INT, 3, -128, 16)]
        G = 8 * 16
    elif mode != "scalar":
        G = {"edge": lim, "edge+1": lim + 1, "factorized": 100_003,
             "1000001": 1_000_001}[mode]
        rng = np.random.default_rng(9)
        codes = torch.from_numpy(rng.integers(
            0, G, rowmask.numel()).astype(np.int32)).view_as(
            rowmask).to(cuda)
    spec = ak.ScanSpec(kinds, offs, [_PRED], keys, codes is not None, G,
                       _all_aggs())
    want = ak.REGIME_SCALAR if G == 1 else ak.REGIME_SMALL if G <= lim \
        else ak.REGIME_SORT
    assert ak.split(spec, rowmask.numel()).regime == want
    LAUNCHES.reset()
    got = ak.agg_scan(spec, cols, rowmask, codes, 0, rowmask.shape[0])
    assert LAUNCHES.get("agg_scan") == 1
    again = ak.agg_scan(spec, cols, rowmask, codes, 0, rowmask.shape[0])
    ref = ak.agg_scan_plain(spec, cols, rowmask, codes, 0, rowmask.shape[0])
    torch.cuda.synchronize()
    _assert_raw_equal(got, ref)
    _assert_raw_equal(got, again)
    # a sub-range of tiles
    got = ak.agg_scan(spec, cols, rowmask, codes, 7, 300)
    ref = ak.agg_scan_plain(spec, cols, rowmask, codes, 7, 300)
    _assert_raw_equal(got, ref)


@pytest.mark.parametrize("skew", [False, True])
def test_large_regime_matches_plain(cuda, skew):
    """The LARGE regime (large G, no f32 sum), on codes nearly all
    distinct and on codes where most rows share a few: the same outputs
    as the plain version."""
    dcs, kinds, offs, rowmask = _scan_cols(cuda)
    cols = [(dc.data, dc.mask) for dc in dcs]
    rng = np.random.default_rng(10)
    G = 50_000
    c = rng.integers(0, G, rowmask.numel())
    if skew:
        c[rng.random(c.size) < 0.8] = 7
    codes = torch.from_numpy(c.astype(np.int32)).view_as(rowmask).to(cuda)
    aggs = [a for a in _all_aggs() if a.kind != ak.AGG_SUM_F]
    spec = ak.ScanSpec(kinds, offs, [_PRED], [], True, G, aggs)
    assert ak.split(spec, rowmask.numel()).regime == ak.REGIME_LARGE
    got = ak.agg_scan(spec, cols, rowmask, codes, 0, rowmask.shape[0])
    ref = ak.agg_scan_plain(spec, cols, rowmask, codes, 0, rowmask.shape[0])
    _assert_raw_equal(got, ref)


@pytest.mark.parametrize("P, G", [(8192, 201), (1, 1000), (4, 1_000_001),
                                  (37, 1_000_001), (300, 1)])
def test_agg_fold_matches_plain(cuda, P, G):
    """agg_fold against its plain version bit for bit, and two launches
    bit-identical, on planes with NaN and -0.0."""
    rng = np.random.default_rng(P)
    plane = (rng.standard_normal(P * G) * 100).astype(np.float32)
    plane[rng.random(P * G) < 1e-3] = np.nan
    plane[::97] = -0.0
    dev = torch.from_numpy(plane).to(cuda)
    LAUNCHES.reset()
    got = ak.agg_fold(dev, G)
    again = ak.agg_fold(dev, G)
    assert LAUNCHES.get("agg_fold") == 2
    assert _same_f32(got, ak.agg_fold_plain(torch.from_numpy(plane), G))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_agg_fold_and_float_sums_are_deterministic(cuda):
    dcs, kinds, offs, rowmask = _scan_cols(cuda, n=400_000)
    cols = [(dc.data, dc.mask) for dc in dcs]
    for keys, G in (([], 1), ([(ak.KEY_INT, 0, -100, 201)], 201)):
        spec = ak.ScanSpec(kinds, offs, [], keys, False, G,
                           [ak.ScanAgg(ak.AGG_SUM_F, (_COL(4),))])
        runs = []
        for _ in range(2):
            _, outs = ak.agg_scan(spec, cols, rowmask, None, 0,
                                  rowmask.shape[0])
            runs.append((outs[0][0], ak.agg_fold(outs[0][0], G)))
        plane, total = runs[0]
        assert torch.equal(plane.view(torch.int32),
                           runs[1][0].view(torch.int32))
        assert torch.equal(total.view(torch.int32),
                           runs[1][1].view(torch.int32))
        assert _same_f32(total, ak.agg_fold_plain(plane, G))


def test_f2i_and_float_images_on_the_card(cuda):
    v = torch.tensor([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5, -2.5,
                      0.49999997, -0.0, 1e-45], dtype=torch.float32)
    rows = torch.zeros(128, dtype=torch.float32)
    rows[:len(v)] = v
    data = rows.view(1, 128)
    mask = torch.ones(1, 128, dtype=torch.bool)
    spec = ak.ScanSpec([ak.COL_F32], [0], [], [], True, 128,
                       [ak.ScanAgg(ak.AGG_MAX_I, (_COL(0),
                                                   (ak.OP_F2I, 0, 0))),
                        ak.ScanAgg(ak.AGG_MIN_F, (_COL(0),)),
                        ak.ScanAgg(ak.AGG_MAX_F, (_COL(0),))])
    codes = torch.arange(128, dtype=torch.int32).view(1, 128)
    got = ak.agg_scan(spec, [(data.to(cuda), mask.to(cuda))],
                      mask.to(cuda), codes.to(cuda), 0, 1)
    ref = ak.agg_scan_plain(spec, [(data, mask)], mask, codes, 0, 1)
    _assert_raw_equal(tuple(x.cpu() if torch.is_tensor(x) else
                            [tuple(t.cpu() for t in o) for o in x]
                            for x in got), ref)


def test_ops_agg_entries_on_the_card(cuda):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 50, (40, 128)).astype(np.int32)
    mask = rng.random((40, 128)) > 0.2
    ivals = rng.integers(-2**31, 2**31, (40, 128)).astype(np.int32)
    fvals = rng.normal(size=(40, 128)).astype(np.float32)
    t = lambda a, d: torch.from_numpy(a).to(d)  # noqa: E731
    for d in (cuda,):
        c, m = t(codes, d), t(mask, d)
        iv, fv = t(ivals, d), t(fvals, d)
        pairs = [
            (agg_ops.masked_sum_int_partials(iv, m),
             agg_ops.masked_sum_int_partials(iv.cpu(), m.cpu())),
            (agg_ops.group_count_scatter(c, m, 50),
             agg_ops.group_count_scatter(c.cpu(), m.cpu(), 50)),
            (agg_ops.group_sum_int_limbs(c, m, iv, 50),
             agg_ops.group_sum_int_limbs(c.cpu(), m.cpu(), iv.cpu(), 50)),
            (agg_ops.group_min_max(c, m, iv, 50, "min"),
             agg_ops.group_min_max(c.cpu(), m.cpu(), iv.cpu(), 50, "min")),
            (agg_ops.group_min_max(c, m, fv, 50, "max"),
             agg_ops.group_min_max(c.cpu(), m.cpu(), fv.cpu(), 50, "max")),
        ]
        for got, ref in pairs:
            assert torch.equal(got.cpu(), ref)
        torch.testing.assert_close(
            agg_ops.group_sum_float(c, m, fv, 50).cpu(),
            agg_ops.group_sum_float(c.cpu(), m.cpu(), fv.cpu(), 50),
            rtol=1e-5, atol=1e-5)


def test_sql_on_the_card_matches_the_host_path(cuda):
    from serenedb_tpu_torch.columnar.column import Batch
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.exec.tables import MemTable
    rng = np.random.default_rng(0)
    n = 300_000
    db = Database()
    c = db.connect()
    c.execute("SET serene_result_cache = off")
    db.schemas["main"].tables["t"] = MemTable("t", Batch.from_pydict({
        "k": Column.from_numpy(rng.integers(0, 300, n).astype(np.int32)),
        "s": Column.from_numpy(np.asarray(["a", "b", "c"], dtype=object)[
            rng.integers(0, 3, n)]),
        "u": Column.from_numpy(rng.integers(0, 1 << 62, n)),
        "x": Column.from_numpy(rng.integers(-10**6, 10**6, n)
                               .astype(np.int32)),
        "f": Column.from_numpy(rng.random(n) * 100),
    }))
    qs = ["SELECT count(*), sum(x), min(x), max(x) FROM t WHERE k < 100",
          "SELECT k, count(*), sum(x), avg(f), min(f) FROM t GROUP BY k "
          "ORDER BY k",
          "SELECT s, count(DISTINCT k), max(f) FROM t WHERE s <> 'b' "
          "GROUP BY s ORDER BY s",
          "SELECT u, count(*) FROM t GROUP BY u ORDER BY 2 DESC, u LIMIT 5"]
    for q in qs:
        c.execute("SET serene_device = 'cpu'")
        host = c.execute(q).rows()
        c.execute("SET serene_device = 'gpu'")
        LAUNCHES.reset()
        dev = c.execute(q).rows()
        assert LAUNCHES.get("agg_scan") >= 1, q
        assert len(host) == len(dev)
        for rh, rd in zip(host, dev):
            for a, b in zip(rh, rd):
                if isinstance(a, float):
                    assert b == pytest.approx(a, rel=1e-4, abs=1e-4), q
                else:
                    assert a == b, q


# -- top-N and fused join kernels -------------------------------------------

from serenedb_tpu_torch.ops import join_kernels as jk  # noqa: E402
from serenedb_tpu_torch.ops import topn_kernels as tk  # noqa: E402


def _key_tiles(cuda, vals: np.ndarray):
    dc = to_device_column(Column.from_numpy(vals), device=cuda)
    kind, off = ak.col_kind(dc)
    return dc, kind, off


#: q1's x ([0, 100,000)) at one 2,097,152-row chunk; the survivor-count
#: edges (the filter keeps k // 2, 0 or k rows); one value for all rows
#: (the tie quota spans blocks); k = n on a small table
_SCAN_CASES = [
    ("ties", 10, 200_000), ("ties", 5000, 200_000), ("ties", 8192, 200_000),
    ("wide", 300, 200_000), ("float", 1000, 200_000), ("for8", 7, 200_000),
    ("q1", 10, 2_097_152), ("q1", 110, 2_097_152), ("q1", 8192, 2_097_152),
    ("few", 1000, 200_000), ("none", 50, 200_000), ("exact", 700, 200_000),
    ("one", 1000, 300_000), ("ties", 1000, 1000)]


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("keys,k,n", _SCAN_CASES)
def test_topn_scan_matches_plain(cuda, keys, k, n, desc):
    """Indices equal (tie order included) on tie-heavy int keys, keys of
    the full int32 range less the sentinel, f32 keys with +-0.0, FOR8
    tiles, q1's keys, fewer survivors than k, none, exactly k, one value
    for every row and k = n; with and without a predicate."""
    rng = np.random.default_rng(4)
    vals = {"ties": lambda: rng.integers(0, 50, n).astype(np.int32),
            "wide": lambda: rng.integers(-2**31 + 1, 2**31 - 1, n)
            .astype(np.int32),
            "float": lambda: rng.choice(np.float32([0.0, -0.0, 1.5, -2.25]),
                                        n),
            "for8": lambda: rng.integers(1000, 1200, n).astype(np.int32),
            "one": lambda: np.full(n, 77, np.int32)}.get(
        keys, lambda: rng.integers(0, 100_000, n).astype(np.int32))()
    flt = rng.integers(0, 3, n).astype(np.int32)
    keep = {"few": k // 2, "none": 0, "exact": k}.get(keys)
    if keep is not None:       # the predicate (flt <> 1) keeps `keep` rows
        flt[:] = 1
        flt[rng.choice(n, keep, replace=False)] = 0
    dc, kind, off = _key_tiles(cuda, vals)
    f, fk, fo = _key_tiles(cuda, flt)
    cols = [(dc.data, dc.mask), (f.data, f.mask)]
    pred = (_COL(1), _I(1), (ak.OP_CMP_I, 0, C["<>"]))
    for preds in ([], [pred]):
        spec = tk.TopnSpec([kind, fk], [off, fo], 0, desc,
                           keys == "float", preds)
        LAUNCHES.reset()
        idx, nsurv = tk.topn_scan(spec, cols, dc.mask, k)
        assert LAUNCHES.get("topn_scan") == 1
        ref_idx, ref_n = tk.topn_scan_plain(spec, cols, dc.mask, k)
        torch.cuda.synchronize()
        assert torch.equal(idx, ref_idx)
        assert torch.equal(nsurv, ref_n)


@pytest.mark.parametrize("mode", ["agg", "gkey", "absent"])
@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("G", [1000, 10_001, tk.CHAIN_ONE_MAX,
                               tk.CHAIN_ONE_MAX + 1, 100_000])
def test_chain_topn_matches_plain(cuda, mode, desc, G):
    """G on both sides of the one-block cap, k_pad = G (G = 1,000), and
    every slot absent."""
    rng = np.random.default_rng(6)
    rowcount = np.where(rng.random(G) < 0.2, 0, rng.integers(1, 5, G))
    if mode == "absent":
        rowcount[:] = 0
    rowcount = torch.from_numpy(rowcount).to(cuda)
    src = None if mode == "gkey" else rowcount
    stride, size = (1, 1) if mode != "gkey" else (101, 99)
    outs = [rowcount,
            torch.from_numpy(rng.integers(-9, 9, G).astype(np.int32)).to(
                cuda),
            torch.from_numpy(rng.integers(0, 2, G * 16).astype(np.int32)).to(
                cuda)]
    for k in sorted({8, 64, min(G, tk.TOPN_MAX_K)}):
        LAUNCHES.reset()
        got = tk.chain_topn(rowcount, src, stride, size, desc, k, outs)
        assert LAUNCHES.get("chain_topn") == 1
        ref = tk.chain_topn_plain(rowcount, src, stride, size, desc, k,
                                  outs)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        for a, b in zip(got[2], ref[2]):
            assert torch.equal(a, b)


def _device_activity(fn) -> tuple:
    """(kernels, host-to-device copies) that one fn() issues on the card,
    from torch.profiler after a warm-up call: the most over three profiled
    calls (the profiler can drop an event, never add one), and over up to
    ten while none has shown a kernel (every call launches one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    kernels = copies = 0
    for session in range(10):
        if session >= 3 and kernels:
            break
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # idle host time around the call (2 ms, doubling): a short
            # window's device events can go missing from the results
            time.sleep(min(0.002 * 2 ** session, 0.2))
            fn()
            torch.cuda.synchronize()
            time.sleep(min(0.002 * 2 ** session, 0.2))
        n_k = n_c = 0
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            if ev.name.startswith("Memcpy"):
                n_c += "HtoD" in ev.name
            elif not ev.name.startswith("Memset"):
                n_k += 1
        kernels, copies = max(kernels, n_k), max(copies, n_c)
    return kernels, copies


def test_topn_calls_issue_few_kernels_and_no_copy(cuda):
    """One topn_scan call: at most 5 kernels and no host-to-device copy;
    one chain_topn call under the one-block cap: exactly one kernel."""
    rng = np.random.default_rng(9)
    n = 2_097_152
    dc, kind, off = _key_tiles(
        cuda, rng.integers(0, 100_000, n).astype(np.int32))
    spec = tk.TopnSpec([kind], [off], 0, True, False)
    kernels, copies = _device_activity(
        lambda: tk.topn_scan(spec, [(dc.data, dc.mask)], dc.mask, 10))
    assert 1 <= kernels <= 5 and copies == 0, (kernels, copies)
    G = 10_001
    rowcount = torch.from_numpy(rng.integers(0, 5, G)).to(cuda)
    outs = [rowcount, torch.zeros(G * 3, dtype=torch.int32, device=cuda)]
    kernels, copies = _device_activity(
        lambda: tk.chain_topn(rowcount, rowcount, 1, 1, True, 16, outs))
    assert kernels == 1 and copies == 0, (kernels, copies)


def _probe_case(cuda, outer_left: bool, right: bool, G: int = 31,
                skew: bool = False, sparse: bool = False):
    """A probe table (slots: group key, int value, dictionary-coded
    distinct column), a build table (one int value), and the join codes,
    with NULLs, unmatched codes and sentinels. The key spreads over G - 1
    groups (NULL takes the last), or with `skew` every row holds 7; the
    probe predicate keeps ~95 % of the rows, or with `sparse` ~10 % (a
    warp step then adds its rows lane by lane)."""
    rng = np.random.default_rng(8)
    npr, nb, g = 60_000, 9_000, 5_000
    keys = np.full(npr, 7, np.int32) if skew else \
        rng.integers(0, G - 1, npr).astype(np.int32)
    pcols_raw = [Column(dt.INT, keys),
                 Column(dt.INT, rng.integers(-1000, 1000, npr)
                        .astype(np.int32)),
                 Column(dt.INT, rng.integers(0, 12, npr).astype(np.int32))]
    for c in pcols_raw:
        c.validity = rng.random(npr) > 0.05
    bcol = Column(dt.INT, rng.integers(-10**6, 10**6, nb).astype(np.int32))
    bcol.validity = rng.random(nb) > 0.1
    pdc = [to_device_column(c, device=cuda) for c in pcols_raw]
    bdc = to_device_column(bcol, device=cuda)

    def tiles(codes, sentinel, n_pad):
        out = np.full(n_pad, sentinel, dtype=np.int32)
        out[:len(codes)] = codes
        return torch.from_numpy(out.reshape(-1, 128)).to(cuda)

    pcodes = np.where(rng.random(npr) < 0.05, g + 1,
                      rng.integers(0, g, npr))
    bcodes = np.where(rng.random(nb) < 0.05, g, rng.integers(0, g, nb))
    pc = tiles(pcodes, g + 1, pdc[0].data.numel())
    bc = tiles(bcodes, g, bdc.data.numel())

    def rowmask(n, like):
        m = torch.zeros(like.numel(), dtype=torch.bool)
        m[:n] = True
        return m.view_as(like).to(cuda)

    prow, brow = rowmask(npr, pdc[0].data), rowmask(nb, bdc.data)
    bkind, boff = ak.col_kind(bdc)
    bcols = [(bdc.data, bdc.mask)]
    bpred = (_COL(0), _I(-900_000), (ak.OP_CMP_I, 0, C[">"]))
    gate = (_COL(0), _I(0), (ak.OP_CMP_I, 0, C[">"]), (ak.OP_GATE, 0, 0))
    bspec = ak.ScanSpec([bkind], [boff], [bpred], [], True, g + 2, [
        ak.ScanAgg(ak.AGG_COUNT, (_COL(0),)),
        ak.ScanAgg(ak.AGG_SUM_I, (_COL(0),)),
        ak.ScanAgg(ak.AGG_MIN_I, (_COL(0),) + gate)])
    b_rc, b_outs = ak.agg_scan(bspec, bcols, brow, bc, 0, brow.shape[0])
    b_rc[g:] = 0
    kinds = [ak.col_kind(d) for d in pdc]
    ppred = (_COL(1), _I(800 if sparse else -900),
             (ak.OP_CMP_I, 0, C[">"]))
    aggs = [
        jk.ProbeAgg(jk.JP_COUNT, (_COL(1),)),
        jk.ProbeAgg(jk.JP_SUM, (_COL(1),)),
        jk.ProbeAgg(jk.JP_MIN, (_COL(1), _COL(2), _I(5),
                                (ak.OP_CMP_I, 0, C["<"]), (ak.OP_GATE, 0, 0))),
        jk.ProbeAgg(jk.JP_MAX, (_COL(1),)),
        jk.ProbeAgg(jk.JP_PRESENCE, (_COL(2),), pkind=ak.KEY_INT, plo=0,
                    pvsize=16),
        jk.ProbeAgg(jk.JB_COUNT, src=(None, b_outs[0][0]),
                    ub_ops=(_COL(0),)),
        jk.ProbeAgg(jk.JB_SUM, src=b_outs[1], ub_ops=(_COL(0),)),
        jk.ProbeAgg(jk.JB_MIN, src=b_outs[2], ub_ops=(_COL(0),) + gate),
    ]
    spec = jk.ProbeSpec([k for k, _ in kinds], [o for _, o in kinds], G, g,
                        outer_left, [ppred], [(ak.KEY_INT, 0, 0, G)], aggs)
    cols = [(d.data, d.mask) for d in pdc]
    rt = (jk.UnmatchedSpec([bkind], [boff], G - 1, [bpred]), bcols, brow,
          bc) if right else None
    return spec, cols, prow, pc, b_rc, rt


@pytest.mark.parametrize("G,skew,sparse", [(31, False, False),
                                           (31, True, False),
                                           (31, False, True),
                                           (4001, False, False)])
@pytest.mark.parametrize("kind", ["inner", "left", "right", "full"])
def test_join_probe_matches_plain(cuda, kind, G, skew, sparse):
    """Every output bit for bit, in both regimes (G 31: SMALL; 4,001:
    LARGE), with every row in one group, with few rows a warp, negative
    min/max and a DISTINCT grid."""
    spec, cols, prow, pc, cnt, rt = _probe_case(
        cuda, kind in ("left", "full"), kind in ("right", "full"), G, skew,
        sparse)
    assert jk.probe_regime(spec) == (jk.REGIME_SMALL if G == 31
                                     else jk.REGIME_LARGE)
    LAUNCHES.reset()
    got = jk.join_probe(spec, cols, prow, pc, cnt, rt)
    assert LAUNCHES.get("join_probe") == 1
    assert LAUNCHES.get("join_unmatched") == int(rt is not None)
    ref = jk.join_probe_plain(spec, cols, prow, pc, cnt, rt)
    torch.cuda.synchronize()
    _assert_raw_equal(got, ref)
    again = jk.join_probe(spec, cols, prow, pc, cnt, rt)
    torch.cuda.synchronize()
    _assert_raw_equal(again, ref)


@pytest.mark.parametrize("right", [False, True])
def test_join_probe_call_issues_its_launches_and_no_copy(cuda, right):
    """A warm call: init + probe (+ unmatched) kernels, and no host-to-
    device copy (both descriptors go by value)."""
    spec, cols, prow, pc, cnt, rt = _probe_case(cuda, False, right)
    kernels, copies = _device_activity(
        lambda: jk.join_probe(spec, cols, prow, pc, cnt, rt))
    assert (kernels, copies) == (jk.CALL_LAUNCHES[right], 0)


# -- vector kernels (csrc/vector.cu) ------------------------------------------

def _cluster_layout(n, dp, lists, nprobe, seed, special=False):
    """A cluster-major probe layout over n random f32 rows of width dp:
    region rows through an identity slot map, per-list offsets/counts,
    unique row ids, the probe grid's chunk maps for nprobe. `special`
    plants NaN and +-inf rows, a row equal to the first query (an l2
    distance of 0) and a row of -0.0."""
    from serenedb_tpu_torch.ops import vector as vops
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dp)).astype(np.float32)
    q = rng.standard_normal((8, dp)).astype(np.float32)
    if special:
        x[5] = np.nan
        x[9, 2] = np.inf
        x[11, 0] = -np.inf
        x[13] = q[0]
        x[14] = -0.0
    codes = rng.integers(0, lists, n)
    codes[:lists] = np.arange(lists)
    order = np.lexsort((np.arange(n), codes))
    counts = np.bincount(codes, minlength=lists).astype(np.int32)
    offsets = np.zeros(lists, np.int32)
    offsets[1:] = np.cumsum(counts)[:-1]
    cents = np.stack([x[codes == c].mean(0) for c in range(lists)])
    cents[3] = cents[2]                            # tied centroids
    m = int(counts.max())
    tm, jm = vops.chunk_maps(nprobe, m, min(1024, 1 << (m - 1).bit_length()))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(x[order]), t(np.arange(n, dtype=np.int32)), t(offsets),
            t(counts), t(order.astype(np.int32)), t(cents.astype(np.float32)),
            t(q), t(tm), t(jm))


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("special", [False, True])
def test_ivf_probe_matches_plain_bit_for_bit(cuda, metric, special):
    from serenedb_tpu_torch.ops import vector_kernels as vk
    for nprobe, kkp in ((1, 8), (4, 16), (4, 4096)):
        host = _cluster_layout(3000, 32, 16, nprobe, seed=41,
                               special=special)
        dev = [a.to(cuda) for a in host]
        kw = dict(metric=metric, l_real=16, nprobe=nprobe, kkp=kkp)
        LAUNCHES.reset()
        d, r = vk.ivf_probe(*dev, **kw)
        assert LAUNCHES.get("ivf_probe") == 1
        pd, pr = vk.ivf_probe_plain(*host, **kw)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(d.cpu().numpy().view(np.int32),
                                      pd.numpy().view(np.int32))
        np.testing.assert_array_equal(r.cpu().numpy(), pr.numpy())
        if kkp == 4096:                             # past the live lanes
            assert (r.cpu().numpy() == vk.PAD_ROW).any()
        d2, r2 = vk.ivf_probe(*dev, **kw)           # repeat: same bits
        assert torch.equal(d2.view(torch.int32), d.view(torch.int32))
        assert torch.equal(r2, r)


@pytest.mark.parametrize("kkp", [8192, 16_384, 20_000])
def test_ivf_probe_keeps_past_one_selection_tile(cuda, kkp):
    """kkp past 4,096 takes select.cuh's device-memory merge levels."""
    from serenedb_tpu_torch.ops import vector_kernels as vk
    host = _cluster_layout(40_000, 16, 16, 16, seed=45, special=True)
    kw = dict(metric="l2", l_real=16, nprobe=16, kkp=kkp)
    LAUNCHES.reset()
    d, r = vk.ivf_probe(*[a.to(cuda) for a in host], **kw)
    assert LAUNCHES.get("ivf_probe") == 1
    pd, pr = vk.ivf_probe_plain(*host, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(d.cpu().numpy().view(np.int32),
                                  pd.numpy().view(np.int32))
    np.testing.assert_array_equal(r.cpu().numpy(), pr.numpy())


def test_ivf_probe_brute_layout_matches_plain(cuda):
    from serenedb_tpu_torch.ops import vector as vops
    from serenedb_tpu_torch.ops import vector_kernels as vk
    rng = np.random.default_rng(42)
    n, dp = 5000, 64
    x = torch.from_numpy(rng.standard_normal((n, dp)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, dp)).astype(np.float32))
    tm, jm = vops.chunk_maps(1, n, 1024)
    host = (x, torch.arange(n, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32),
            torch.arange(n, dtype=torch.int32),
            torch.zeros((1, dp)), q, torch.from_numpy(tm),
            torch.from_numpy(jm))
    kw = dict(metric="l2", l_real=1, nprobe=1, kkp=16)
    d, r = vk.ivf_probe(*[a.to(cuda) for a in host], **kw)
    pd, pr = vk.ivf_probe_plain(*host, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(d.cpu().numpy().view(np.int32),
                                  pd.numpy().view(np.int32))
    np.testing.assert_array_equal(r.cpu().numpy(), pr.numpy())
    hd = vops.host_dist(x.numpy(), q.numpy()[:, None, :], "l2")
    order = np.lexsort((np.broadcast_to(np.arange(n), hd.shape), hd))[:, :16]
    np.testing.assert_array_equal(r.cpu().numpy(), order)


def _ivf_case(n, dp, lists, nprobe, nq, seed, skew=False, empty=0,
              special=False):
    """A cluster-major layout for the redesigned probe: n rows of width dp
    in `lists` lists (`skew`: list 1 holds ~90 % of the rows; `empty`: the
    first `empty` lists hold none, their centroids all at one far point
    that query 0 sits on, so its nprobe <= empty probed lists are empty),
    nq queries, the chunk maps for nprobe; `special` plants NaN, +-inf and
    -0.0 rows."""
    from serenedb_tpu_torch.ops import vector as vops
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dp)).astype(np.float32)
    q = rng.standard_normal((nq, dp)).astype(np.float32)
    if special:
        x[5] = np.nan
        x[9, 2] = np.inf
        x[11, 0] = -np.inf
        x[13] = q[0]
        x[14] = -0.0
    codes = rng.integers(empty, lists, n)
    if skew:
        codes[rng.random(n) < 0.9] = min(empty + 1, lists - 1)
    codes[:lists - empty] = np.arange(empty, lists)
    order = np.lexsort((np.arange(n), codes))
    counts = np.bincount(codes, minlength=lists).astype(np.int32)
    offsets = np.zeros(lists, np.int32)
    offsets[1:] = np.cumsum(counts)[:-1]
    cents = np.zeros((lists, dp), np.float32)
    for c in range(empty, lists):
        cents[c] = x[codes == c].mean(0)
    if empty:
        cents[:empty] = 50.0
        q[0] = 50.0
    m = max(int(counts.max()), 1)
    tm, jm = vops.chunk_maps(nprobe, m, min(1024, 1 << (m - 1).bit_length()))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(x[order]), t(np.arange(n, dtype=np.int32)), t(offsets),
            t(counts), t(order.astype(np.int32)), t(cents), t(q), t(tm),
            t(jm))


def _probe_bits(cuda, host, **kw):
    """The call on the card against a repeat call and the plain version,
    bit for bit; returns the rows."""
    from serenedb_tpu_torch.ops import vector_kernels as vk
    dev = [a.to(cuda) for a in host]
    before = LAUNCHES.get("ivf_probe")
    d, r = vk.ivf_probe(*dev, **kw)
    d2, r2 = vk.ivf_probe(*dev, **kw)
    pd, pr = vk.ivf_probe_plain(*host, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.get("ivf_probe") == before + 2
    np.testing.assert_array_equal(d.cpu().numpy().view(np.int32),
                                  pd.numpy().view(np.int32))
    np.testing.assert_array_equal(r.cpu().numpy(), pr.numpy())
    assert torch.equal(d2.view(torch.int32), d.view(torch.int32))
    assert torch.equal(r2, r)
    return r.cpu().numpy()


@pytest.mark.parametrize("qp", [1, 3, 64, 1024])
@pytest.mark.parametrize("dp", [6, 128, 130, 200])
def test_ivf_probe_batches_and_widths_match_plain(cuda, qp, dp):
    """Every metric at the main path's batches and at widths that take
    one float a copy (6, 130) and more than one slab (130, 200)."""
    host = _ivf_case(6000, dp, 32, 4, qp, seed=qp + dp, special=True)
    for metric in ("l2", "ip", "cos"):
        _probe_bits(cuda, host, metric=metric, l_real=32, nprobe=4, kkp=16)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_ivf_probe_skewed_and_empty_lists_match_plain(cuda, metric):
    """One list holding ~90 % of the rows (blocks of several tiles), empty
    lists, and a query whose probed lists are all empty (every output
    dead)."""
    from serenedb_tpu_torch.ops import vector_kernels as vk
    host = _ivf_case(50_000, 32, 64, 4, 8, seed=3, skew=True, empty=4)
    rows = _probe_bits(cuda, host, metric=metric, l_real=64, nprobe=4,
                       kkp=16)
    assert (rows[0] == vk.PAD_ROW).all()
    if metric != "ip":     # under ip the far lists are every query's nearest
        assert (rows[1:] != vk.PAD_ROW).all()
    host = _ivf_case(50_000, 32, 64, 16, 8, seed=3, skew=True, empty=4)
    _probe_bits(cuda, host, metric=metric, l_real=64, nprobe=16, kkp=64)


@pytest.mark.parametrize("lists,nprobe,kkp", [(8192, 5000, 16),
                                              (64, 48, 600),
                                              (8192, 300, 4096),
                                              (16_384, 64, 256)])
def test_ivf_probe_levels_regimes_match_plain(cuda, lists, nprobe, kkp):
    """Stages whose candidates pass one block's merges take select.cuh's
    levels (stage 1 with 5,000 of 8,192 lists; stage 2 at kkp 600 over 48
    lists and at 4,096), and stage 1 over 16,384 lists keeps 64 in blocks
    of two tiles: bit-equal all the same."""
    from serenedb_tpu_torch.ops import vector_kernels as vk
    host = _ivf_case(40_000, 8, lists, nprobe, 3, seed=lists + kkp,
                     special=True)
    plan = vk.probe_plan(3, lists, nprobe, host[7].numel(), kkp)
    assert not (plan.lists.fused and plan.rows.fused) or \
        plan.lists.tpb > 1
    _probe_bits(cuda, host, metric="l2", l_real=lists, nprobe=nprobe,
                kkp=kkp)


def test_ivf_probe_brute_at_many_tiles_a_block_matches_plain(cuda):
    """The brute layout over 300,000 rows at 16 queries: at kkp 16 2,344
    blocks a query in 74 groups, at kkp 256 blocks of 16 tiles; bit-equal
    to the plain version and to host_dist's (distance, row) order."""
    from serenedb_tpu_torch.ops import vector as vops
    from serenedb_tpu_torch.ops import vector_kernels as vk
    rng = np.random.default_rng(44)
    n, dp = 300_000, 32
    x = torch.from_numpy(rng.integers(0, 256, (n, dp)).astype(np.float32))
    q = torch.from_numpy(rng.integers(0, 256, (16, dp)).astype(np.float32))
    tm, jm = vops.chunk_maps(1, n, 1024)
    host = (x, torch.arange(n, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32),
            torch.arange(n, dtype=torch.int32), torch.zeros((1, dp)), q,
            torch.from_numpy(tm), torch.from_numpy(jm))
    assert vk.probe_plan(16, 1, 1, tm.size, 16).rows.groups > 1
    assert vk.probe_plan(16, 1, 1, tm.size, 256).rows.tpb > 1
    hd = vops.host_dist(x.numpy(), q.numpy()[:, None, :], "l2")
    order = np.lexsort((np.broadcast_to(np.arange(n), hd.shape), hd))
    for kkp in (16, 256):
        rows = _probe_bits(cuda, host, metric="l2", l_real=1, nprobe=1,
                           kkp=kkp)
        np.testing.assert_array_equal(rows, order[:, :kkp])


def test_probe_plan_bytes_match_the_kernel_over_a_grid(cuda):
    from serenedb_tpu_torch.ops import _build
    from serenedb_tpu_torch.ops import vector_kernels as vk
    lib = _build.load("vector")
    for qp in (1, 7, 1024):
        for lp, nprobe in ((1, 1), (1024, 16), (1024, 1024), (8192, 5000),
                           (65_536, 64)):
            for nlanes, kkp in ((1024, 16), (20_480, 16), (1_000_448, 16),
                                (40_960, 600), (114_688, 8192)):
                plan = vk.probe_plan(qp, lp, nprobe, nlanes, kkp)
                assert lib.probe_bytes(qp, lp, nprobe, nlanes, kkp) == \
                    plan.bytes, (qp, lp, nprobe, nlanes, kkp)


def test_maxsim_matches_plain_with_empty_docs_and_zero_tokens(cuda):
    from serenedb_tpu_torch.ops import vector_kernels as vk
    rng = np.random.default_rng(43)
    ndocs, dp = 300, 64
    cnt = rng.integers(1, 12, ndocs).astype(np.int32)
    cnt[[4, 77]] = 0                                 # empty docs
    lp = 512
    counts = np.zeros(lp, np.int32)
    counts[:ndocs] = cnt
    offsets = np.zeros(lp, np.int32)
    offsets[1:ndocs + 1] = np.cumsum(cnt)
    ntok = int(cnt.sum())
    x = rng.standard_normal((ntok, dp)).astype(np.float32)
    rows = np.full(lp, vk.PAD_ROW, np.int32)
    rows[:ndocs] = rng.permutation(10_000)[:ndocs]
    q = rng.standard_normal((4, 8, dp)).astype(np.float32)
    q[1, 5:] = 0.0                                   # zero query tokens
    q[3] = 0.0
    dmap = np.full(3 * 128, ndocs, np.int32)
    dmap[:ndocs] = np.arange(ndocs)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    host = (t(x), t(np.arange(max(ntok, 8), dtype=np.int32)), t(offsets),
            t(counts), t(rows), t(q), t(dmap.reshape(3, 128)))
    for kkp in (8, 512):
        kw = dict(tile=32, tcap=int(cnt.max()), kkp=kkp)
        LAUNCHES.reset()
        k, r = vk.maxsim(*[a.to(cuda) for a in host], **kw)
        assert LAUNCHES.get("maxsim") == 1
        pk, pr = vk.maxsim_plain(*host, **kw)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(k.cpu().numpy().view(np.int32),
                                      pk.numpy().view(np.int32))
        np.testing.assert_array_equal(r.cpu().numpy(), pr.numpy())


@pytest.mark.parametrize("dp", [128, 768])
def test_maxsim_long_docs_match_plain(cuda, dp):
    """Docs of 300 tokens (ColBERTv2) and 1,030 (a ColPali page) stream
    through the kernel's token tiles; kkp 16,384 keeps past one tile."""
    from serenedb_tpu_torch.ops import vector_kernels as vk
    rng = np.random.default_rng(46)
    ndocs = 9000 if dp == 128 else 600
    cnt = rng.integers(1, 40, ndocs).astype(np.int32)
    cnt[:6] = (300, 1030, 299, 301, 0, 64)
    lp = 1 << ndocs.bit_length()
    counts = np.zeros(lp, np.int32)
    counts[:ndocs] = cnt
    offsets = np.zeros(lp, np.int32)
    offsets[1:ndocs + 1] = np.cumsum(cnt)
    ntok = int(cnt.sum())
    x = rng.standard_normal((ntok, dp)).astype(np.float32)
    rows = np.full(lp, vk.PAD_ROW, np.int32)
    rows[:ndocs] = rng.permutation(100_000)[:ndocs]
    q = rng.standard_normal((3, 32, dp)).astype(np.float32)
    dc = 128
    dmap = np.full(-(-ndocs // dc) * dc, ndocs, np.int32)
    dmap[:ndocs] = np.arange(ndocs)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    host = (t(x), t(np.arange(ntok, dtype=np.int32)), t(offsets),
            t(counts), t(rows), t(q), t(dmap.reshape(-1, dc)))
    dev = [a.to(cuda) for a in host]
    for kkp in (8, 16_384):
        kw = dict(tile=32, tcap=int(cnt.max()), kkp=kkp)
        LAUNCHES.reset()
        k, r = vk.maxsim(*dev, **kw)
        assert LAUNCHES.get("maxsim") == 1
        # the plain version on the card's tensors: separate elementwise
        # products and sums round as on the host, in a fraction of the time
        pk, pr = vk.maxsim_plain(*dev, **kw)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(k.cpu().numpy().view(np.int32),
                                      pk.cpu().numpy().view(np.int32))
        np.testing.assert_array_equal(r.cpu().numpy(), pr.cpu().numpy())


def _maxsim_edge_case(case):
    """A MaxSim layout with docs of 0, 1, 33 and 257 tokens among short
    ones, and the case's queries: (1, 1) pairs; 3 x 5 tokens padded to
    4 x 8; NaN and inf in doc and query tokens; widths 200 (tile 8, dim
    slabs), 6 and 130 (not a multiple of 4: one float a copy), and 120
    with dim tiles of 6 (float4 copies, one dim a step)."""
    from serenedb_tpu_torch.ops import vector_kernels as vk
    rng = np.random.default_rng(47)
    dp, tile = {"dp200": (200, 8), "dp6": (6, 3), "dp130": (130, 10),
                "dp120": (120, 6)}.get(case, (128, 32))
    ndocs = 700
    cnt = rng.integers(1, 20, ndocs).astype(np.int32)
    cnt[[3, 100, 101, 400]] = (0, 1, 33, 257)
    lp = 1024
    counts = np.zeros(lp, np.int32)
    counts[:ndocs] = cnt
    offsets = np.zeros(lp, np.int32)
    offsets[1:ndocs + 1] = np.cumsum(cnt)
    ntok = int(cnt.sum())
    x = rng.standard_normal((ntok, dp)).astype(np.float32)
    slots = rng.permutation(ntok).astype(np.int32)
    rows = np.full(lp, vk.PAD_ROW, np.int32)
    rows[:ndocs] = rng.permutation(50_000)[:ndocs]
    if case == "1x1":
        q = rng.standard_normal((1, 1, dp)).astype(np.float32)
    else:
        q = np.zeros((4, 8, dp), np.float32)
        q[:3, :5] = rng.standard_normal((3, 5, dp))
    if case == "nan_inf":
        x[slots[offsets[10]], 5] = np.nan       # doc 10's first token
        x[slots[offsets[20] + 1], 7] = np.inf
        x[slots[offsets[30]], :] = -np.inf
        q[1, 2, 9] = np.inf                     # 0 · inf: NaN everywhere
        q[2, 0, 3] = np.nan
    dc = 128
    dmap = np.full(-(-ndocs // dc) * dc, ndocs, np.int32)
    dmap[:ndocs] = np.arange(ndocs)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(x.reshape(-1)), t(slots), t(offsets), t(counts), t(rows), t(q),
            t(dmap.reshape(-1, dc))), tile, int(cnt.max())


@pytest.mark.parametrize("case", ["1x1", "3x5", "nan_inf", "dp200", "dp6",
                                  "dp130", "dp120"])
def test_maxsim_edge_shapes_match_plain(cuda, case):
    from serenedb_tpu_torch.ops import vector_kernels as vk
    host, tile, tcap = _maxsim_edge_case(case)
    dev = [a.to(cuda) for a in host]
    for kkp in (8, 1024):
        kw = dict(tile=tile, tcap=tcap, kkp=kkp)
        LAUNCHES.reset()
        k, r = vk.maxsim(*dev, **kw)
        k2, r2 = vk.maxsim(*dev, **kw)
        assert LAUNCHES.get("maxsim") == 2
        pk, pr = vk.maxsim_plain(*dev, **kw)
        torch.cuda.synchronize()
        for a, b in ((pk, pr), (k2, r2)):
            np.testing.assert_array_equal(k.cpu().numpy().view(np.int32),
                                          a.cpu().numpy().view(np.int32))
            np.testing.assert_array_equal(r.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("case,groups", [("3x5", 1), ("nan_inf", 3),
                                         ("dp200", 2), ("1x1", 1)])
def test_maxsim_scratch_in_lane_ranges_matches_plain(cuda, monkeypatch, case,
                                                    groups):
    """A scratch budget of a few groups of 32 lanes: the tiles and score
    kernels run range by range over the 768 lanes, and the keys still
    equal the plain version's and one range's."""
    from serenedb_tpu_torch.ops import vector_kernels as vk
    host, tile, tcap = _maxsim_edge_case(case)
    dev = [a.to(cuda) for a in host]
    bp, sp, _ = host[5].shape
    kw = dict(tile=tile, tcap=tcap, kkp=64)
    k1, r1 = vk.maxsim(*dev, **kw)
    monkeypatch.setattr(vk, "MAXSIM_SCRATCH_BYTES",
                        groups * vk.MAXSIM_LANES * bp * sp * 4 + 4)
    assert vk.maxsim_scratch_lanes(host[6].numel(), bp * sp) == \
        groups * vk.MAXSIM_LANES
    k, r = vk.maxsim(*dev, **kw)
    pk, pr = vk.maxsim_plain(*dev, **kw)
    torch.cuda.synchronize()
    for a, b in ((pk, pr), (k1, r1)):
        np.testing.assert_array_equal(k.cpu().numpy().view(np.int32),
                                      a.cpu().numpy().view(np.int32))
        np.testing.assert_array_equal(r.cpu().numpy(), b.cpu().numpy())


def test_kmeans_kernels_match_plain(cuda):
    from serenedb_tpu_torch.ops import vector as vops
    from serenedb_tpu_torch.ops import vector_kernels as vk
    rng = np.random.default_rng(44)
    x = torch.from_numpy(rng.standard_normal((20_000, 32)).astype(np.float32))
    c = x[:64].clone()
    c[7] = c[6]                                      # tied centroids
    c[40] = 1e6                                      # an empty cluster
    xc = vops._gemm(x, c)
    LAUNCHES.reset()
    a = vk.kmeans_assign(x.to(cuda), c.to(cuda), xc.to(cuda))
    pa = vk.kmeans_assign_plain(x, c, xc)
    torch.cuda.synchronize()
    assert torch.equal(a.cpu(), pa)
    assert not (pa == 7).any() and not (pa == 40).any()
    new = vk.kmeans_update(x.to(cuda), a, c.to(cuda))
    pnew = vk.kmeans_update_plain(x, pa, c)
    torch.cuda.synchronize()
    assert LAUNCHES.get("kmeans_assign") == 1
    assert LAUNCHES.get("kmeans_update") == 1
    assert torch.equal(new.cpu().view(torch.int32), pnew.view(torch.int32))
    assert torch.equal(pnew[40], c[40]) and torch.equal(pnew[7], c[7])


def _kmeans_case(case):
    """(x, assign, centroids) on the CPU for a named kmeans_update case."""
    rng = np.random.default_rng(61)
    n, d, k = {"skewed": (300_001, 128, 64), "empty": (70_000, 32, 100),
               "d3": (50_003, 3, 16), "d130": (40_000, 130, 32),
               "large_k": (60_000, 8, 10_000),
               "misaligned": (20_000, 16, 24)}[case]
    x = (rng.standard_normal((n, d)) * 4.0 + 10.0).astype(np.float32)
    if case == "skewed":                 # >= 90 % of the rows in cluster 5
        a = np.where(rng.random(n) < 0.93, 5, rng.integers(0, k, n))
    elif case == "empty":                # every third cluster empty
        a = rng.integers(0, k // 3, n) * 3 + 1
    else:
        a = rng.integers(0, k, n)
    c = rng.standard_normal((k, d)).astype(np.float32)
    xt = torch.from_numpy(x)
    if case == "misaligned":             # x 4 bytes off a 16-byte boundary
        flat = torch.empty(n * d + 1, dtype=torch.float32)
        flat[1:] = xt.reshape(-1)
        xt = flat[1:].view(n, d)
    return xt, torch.from_numpy(a.astype(np.int32)), torch.from_numpy(c)


@pytest.mark.parametrize("case", ["skewed", "empty", "d3", "d130",
                                  "large_k", "misaligned"])
def test_kmeans_update_matches_plain_bit_for_bit(cuda, case):
    from serenedb_tpu_torch.ops import vector_kernels as vk
    x, a, c = _kmeans_case(case)
    if case == "misaligned":
        flat = torch.empty(x.numel() + 1, dtype=torch.float32, device=cuda)
        flat[1:] = x.reshape(-1).to(cuda)
        xd = flat[1:].view(x.shape)
        assert xd.data_ptr() % 16 != 0
    else:
        xd = x.to(cuda)
    ad, cd = a.to(cuda), c.to(cuda)
    LAUNCHES.reset()
    new = vk.kmeans_update(xd, ad, cd)
    again = vk.kmeans_update(xd, ad, cd)
    torch.cuda.synchronize()
    assert LAUNCHES.get("kmeans_update") == 2
    ref = vk.kmeans_update_plain(xd, ad, cd)
    assert torch.equal(new.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(new.view(torch.int32), again.view(torch.int32))
    empty = torch.bincount(a.long(), minlength=c.shape[0]) == 0
    assert torch.equal(new.cpu()[empty], c[empty])


def test_topk_and_kmeans_calls_issue_few_kernels_and_no_copy(cuda):
    """topk_rows (one-read regime): at most 5 kernels a call, no
    host-to-device copy; kmeans_update: at most its 4 kernels, no copy
    (the profiler can drop an event, never add one)."""
    from serenedb_tpu_torch.ops import vector_kernels as vk
    rng = np.random.default_rng(4)
    scores = torch.from_numpy(
        rng.random((16, 200_003)).astype(np.float32)).to(cuda)
    hits = torch.from_numpy(rng.integers(0, 3, (16, 200_003))).to(
        cuda, torch.int32)
    require = torch.ones(16, dtype=torch.int32, device=cuda)
    kernels, copies = _device_activity(
        lambda: kern.topk_rows(scores, 10, hits, require))
    assert 1 <= kernels <= 5 and copies == 0, ("topk_rows", kernels, copies)
    x = torch.from_numpy(rng.random((100_000, 64)).astype(np.float32)).to(
        cuda)
    a = torch.from_numpy(rng.integers(0, 256, 100_000).astype(np.int32)).to(
        cuda)
    c = torch.zeros((256, 64), dtype=torch.float32, device=cuda)
    kernels, copies = _device_activity(lambda: vk.kmeans_update(x, a, c))
    assert 1 <= kernels <= 4 and copies == 0, ("kmeans_update", kernels,
                                               copies)


# -- serving: contrib_flat and pool_score ------------------------------------

from serenedb_tpu_torch.ops import pool_kernels as pk  # noqa: E402


@pytest.mark.parametrize("scorer", ["bm25", "tfidf"])
def test_contrib_flat_kernel_matches_plain_bit_for_bit(cuda, scorer):
    rng = np.random.default_rng(4)
    n = 1 << 20
    tfs = rng.integers(0, 300, n).astype(np.int32)
    dls = rng.integers(1, 5000, n).astype(np.int32)
    w = rng.random(n).astype(np.float32) * 12
    tfs[-1000:], w[-1000:] = 0, 0          # padding
    args = [torch.from_numpy(a).to(cuda) for a in (tfs, dls, w)]
    before = LAUNCHES.get("contrib_flat")
    got = kern.contrib_flat(*args, 1.2, 0.75, 83.25, scorer)
    torch.cuda.synchronize()
    assert LAUNCHES.get("contrib_flat") == before + 1
    want = kern.contrib_plain(scorer, args[0].float(), args[1].float(),
                              args[2], 1.2, 0.75, kern._avg(83.25))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not got[-1000:].any()


def _pool_batch(nq, qp, cp, tp, pages, seed, sizes=None):
    """A random batch descriptor over a random region: each query's
    slices touch distinct lanes; small tf and norm ranges make many equal
    scores; rows past nq are dead (nc 0). `sizes` gives the live rows'
    lane counts (else each draws one in [cp / 4, cp - 1))."""
    rng = np.random.default_rng(seed)
    docs_pg = rng.integers(0, 50_000, (pages, 1024)).astype(np.int32)
    tfs_pg = rng.integers(1, 4, (pages, 1024)).astype(np.int32)
    norms = rng.integers(5, 9, 50_000).astype(np.int32)
    nc = np.zeros(qp, np.int32)
    cand = np.full((qp, cp), pk.PAD_DOC, np.int32)
    per_q = []
    for q in range(nq):
        n = int(sizes[q]) if sizes is not None else \
            int(rng.integers(cp // 4, cp - 1))
        nc[q] = n
        cand[q, :n] = np.sort(rng.choice(1 << 30, n, replace=False))
        sl = [rng.choice(n, int(rng.integers(1, n)) if n > 1 else 1,
                         replace=False)
              for _ in range(int(rng.integers(1, tp + 1)))]
        per_q.append(sl)
    ep = max(sum(len(s) for s in sl) for sl in per_q)
    si = np.zeros((qp, ep), np.int32)
    w = np.zeros((qp, ep), np.float32)
    lane = np.zeros((qp, ep), np.int32)
    soff = np.zeros((qp, tp + 1), np.int32)
    smax = [0] * tp
    for q, sl in enumerate(per_q):
        pos = 0
        for t, lanes in enumerate(sl):
            m = len(lanes)
            si[q, pos:pos + m] = rng.choice(pages * 1024, m, replace=False)
            w[q, pos:pos + m] = np.float32(rng.choice([1.5, 2.25]))
            lane[q, pos:pos + m] = lanes
            soff[q, t] = pos
            smax[t] = max(smax[t], m)
            pos += m
        soff[q, len(sl):] = pos
    return (docs_pg, tfs_pg, norms, si, w, lane, soff), smax, cand, nc


_CAP = pk.POOL_ROW_LANES
#: id -> (live rows, rows, cp, kk, live rows' lane counts or None, seed,
#: regime); the first five shapes and seeds are the test's earlier cases
POOL_CASES = {
    "kk16": (6, 8, 1024, 16, None, 16, "row"),
    "kk128": (6, 8, 4096, 128, None, 128, "large"),
    "kk8192": (6, 8, 16384, 8192, None, 8192, "large"),
    "kk10-cp37": (6, 8, 37, 10, None, 10, "row"),
    "kk100-cp3001": (6, 8, 3001, 100, None, 100, "large"),
    "kk32": (6, 8, 4096, 32, None, 38, "row"),
    "kk1000": (3, 4, 19_048, 1000, [19_048, 999, 5], 1003, "large"),
    "batch1": (1, 1, 19_048, 10, [19_048], 11, "row"),
    "batch64": (64, 64, 19_048, 10, None, 74, "row"),
    "skewed": (64, 64, _CAP, 10, [_CAP] + [300 + 7 * i for i in range(63)],
               74, "row"),
    "at-cap": (3, 4, _CAP, 10, [_CAP, _CAP - 1, 5], 13, "row"),
    "at-cap-kk32": (2, 3, _CAP, 32, [_CAP, 31], 34, "row"),
    "one-past-cap": (3, 4, _CAP + 1, 10, [_CAP + 1, 20, 4], 13, "large"),
    "far-past-cap": (2, 2, 1_000_000, 10, [1_000_000, 1000], 12, "large"),
    "kk-past-nc": (5, 8, 600, 32, [3, 1, 31, 32, 600], 37, "row"),
    "kk-past-nc-large": (5, 8, 600, 100, [37, 1, 99, 100, 600], 105,
                         "large"),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_score_kernel_matches_plain_bit_for_bit(cuda, case):
    """Full mode (ties, dead lanes and dead rows, kk past nc and past
    4,096, lane counts that are no power of two) and partial mode equal
    the plain version bit for bit in both regimes, at batch 1 and 64, a
    skewed batch, rows at the ROW cap, one lane past it and far past it;
    a second call gives the same bits; a ROW call allocates its outputs
    and nothing else."""
    nq, qp, cp, kk, sizes, seed, regime = POOL_CASES[case]
    assert pk.pool_regime(cp, kk) == regime
    pages = max(64, cp // 1024 + 1)     # a slice's slots are distinct
    arrays, smax, cand, nc = _pool_batch(nq, qp, cp, 4, pages, seed=seed,
                                         sizes=sizes)
    dev = [torch.from_numpy(a).to(cuda) for a in arrays]
    c_d, nc_d = torch.from_numpy(cand).to(cuda), torch.from_numpy(nc).to(cuda)
    args = (*dev, smax, cp, 1.2, 0.75, 6.5, "bm25")
    torch.cuda.synchronize()
    before = LAUNCHES.get("pool_score")
    a0 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    vals, docs = pk.pool_score(*args, c_d, nc_d, kk)
    a1 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    acc = pk.pool_score(*args)
    a2 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    torch.cuda.synchronize()
    assert LAUNCHES.get("pool_score") == before + 2
    if regime == "row":
        assert (a1 - a0, a2 - a1) == (2, 1)
    ref_v, ref_d = pk.pool_score_plain(*args, c_d, nc_d, kk)
    ref_acc = pk.pool_score_plain(*args)
    assert torch.equal(acc.view(torch.int32), ref_acc.view(torch.int32))
    assert torch.equal(docs, ref_d)
    assert torch.equal(vals.view(torch.int32), ref_v.view(torch.int32))
    v2, d2 = pk.pool_score(*args, c_d, nc_d, kk)
    assert torch.equal(d2, docs)
    assert torch.equal(v2.view(torch.int32), vals.view(torch.int32))
    assert torch.equal(pk.pool_score(*args).view(torch.int32),
                       acc.view(torch.int32))
    # ties exist among the live rows' winners, and the dead rows and the
    # slots past nc hold only the pads
    v, d = vals.cpu().numpy(), docs.cpu().numpy()
    won = [v[q, :min(int(nc[q]), kk)] for q in range(nq)]
    assert any((x[1:] == x[:-1]).any() for x in won)
    for q in range(qp):
        assert (d[q, min(int(nc[q]), kk):] == pk.PAD_DOC).all()
        assert np.isneginf(v[q, min(int(nc[q]), kk):]).all()


@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
def test_pool_score_every_cluster_size_matches_plain(cuda, monkeypatch,
                                                      blocks):
    """A query's lanes split over 1, 2, 4 or 8 blocks of a cluster (the
    entries of each slice taken in turn by the cluster's blocks and added
    through distributed shared memory, each block's best merged by the
    first) give the plain version's bits, full and partial mode."""
    arrays, smax, cand, nc = _pool_batch(7, 8, 19_048, 4, 64, seed=blocks)
    dev = [torch.from_numpy(a).to(cuda) for a in arrays]
    c_d, nc_d = torch.from_numpy(cand).to(cuda), torch.from_numpy(nc).to(cuda)
    args = (*dev, smax, 19_048, 1.2, 0.75, 6.5, "bm25")
    monkeypatch.setattr(pk, "ROW_CLUSTER", blocks)
    vals, docs = pk.pool_score(*args, c_d, nc_d, 10)
    acc = pk.pool_score(*args)
    ref_v, ref_d = pk.pool_score_plain(*args, c_d, nc_d, 10)
    assert torch.equal(docs, ref_d)
    assert torch.equal(vals.view(torch.int32), ref_v.view(torch.int32))
    assert torch.equal(acc.view(torch.int32),
                       pk.pool_score_plain(*args).view(torch.int32))


@pytest.mark.parametrize("scorer", ["bm25", "tfidf"])
@pytest.mark.parametrize("n", [(1 << 20) + 3, 4096, 5])
def test_contrib_flat_with_norms_matches_plain_bit_for_bit(cuda, scorer, n):
    """With `norms`, the second array holds doc ids: bit-equal to
    contrib_plain over the gathered norms, from three runs of one packed
    buffer (misaligned where n % 4 != 0) and from separate arrays; and
    `ragged_contribs` (one upload, one readback) gives the same bits."""
    from serenedb_tpu_torch.device import UPLOADS
    rng = np.random.default_rng(n)
    norms = torch.from_numpy(
        rng.integers(1, 5000, 70_000).astype(np.int32)).to(cuda)
    tfs = rng.integers(0, 300, n).astype(np.int32)
    docs = rng.integers(0, 70_000, n).astype(np.int32)
    w = rng.random(n).astype(np.float32) * 12
    packed = torch.from_numpy(np.concatenate(
        [tfs, docs, w.view(np.int32)])).to(cuda)
    runs = (packed[:n], packed[n:2 * n], packed[2 * n:].view(torch.float32))
    want = kern.contrib_plain(scorer, runs[0].float(),
                              norms[runs[1].long()].float(), runs[2], 1.2,
                              0.75, kern._avg(83.25))
    before = LAUNCHES.get("contrib_flat")
    got = kern.contrib_flat(*runs, 1.2, 0.75, 83.25, scorer, norms)
    apart = kern.contrib_flat(*(r.clone() for r in runs), 1.2, 0.75, 83.25,
                              scorer, norms)
    torch.cuda.synchronize()
    assert LAUNCHES.get("contrib_flat") == before + 2
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(apart.view(torch.int32), want.view(torch.int32))
    t0 = UPLOADS.get("transfers")
    host = bm25_ops.ragged_contribs(tfs, docs, w, 1.2, 0.75, 83.25, scorer,
                                    norms=norms)
    assert UPLOADS.get("transfers") - t0 == 1
    np.testing.assert_array_equal(host.view(np.int32),
                                  want.cpu().numpy().view(np.int32))


# -- the sharded tier's merge and the K13 entries ----------------------------


def _merge_inputs(S, Q, L, seed, tied):
    """(S, Q, L) candidates: docs unique within a query, pads at (-inf,
    PAD_DOC), ties across shards, -0.0 beside +0.0, a real -inf."""
    from serenedb_tpu_torch.ops.merge_kernels import PAD_DOC
    rng = np.random.default_rng(seed)
    if tied:
        scores = rng.choice(np.asarray([3.5, 1.0, 0.0, -0.0, -np.inf, 2.25],
                                       dtype=np.float32), (S, Q, L))
    else:
        scores = rng.standard_normal((S, Q, L)).astype(np.float32)
    docs = np.empty((S, Q, L), dtype=np.int32)
    for q in range(Q):
        docs[:, q, :] = rng.choice(4 * S * L, S * L, replace=False) \
            .reshape(S, L)
    pads = rng.random((S, Q, L)) < 0.25
    scores[pads] = -np.inf
    docs[pads] = PAD_DOC
    return scores, docs


@pytest.mark.parametrize("S,Q,L,k", [(4, 16, 40, 10), (2, 3, 7, 100),
                                     (4, 64, 1000, 10), (3, 2, 3000, 5000),
                                     (4, 1, 1, 1)])
@pytest.mark.parametrize("tied", [False, True])
def test_merge_topk_matches_plain_bit_for_bit(cuda, S, Q, L, k, tied):
    from serenedb_tpu_torch.ops import merge_kernels as mk
    scores, docs = _merge_inputs(S, Q, L, S * Q + L, tied)
    sc, dd = torch.from_numpy(scores).to(cuda), torch.from_numpy(docs).to(cuda)
    before = LAUNCHES.get("merge_topk")
    vals, out = mk.merge_topk(sc, dd, k)
    torch.cuda.synchronize()
    assert LAUNCHES.get("merge_topk") == before + 1
    ref_v, ref_d = mk.merge_topk_plain(sc, dd, k)
    assert torch.equal(out, ref_d)
    assert torch.equal(vals.view(torch.int32), ref_v.view(torch.int32))


@pytest.mark.parametrize("S,L", [(1, 1), (4, 8), (3, 11), (4, 256),
                                 (5, 205), (8, 1024), (3, 2731)])
@pytest.mark.parametrize("tied", [False, True])
def test_merge_topk_lanes_a_query_match_plain(cuda, S, L, tied):
    """S * L at 1, 32, 33, 1,024, 1,025, 8,192 (one block a query) and
    8,193 (the levels): bit-equal to the plain version and to a repeat,
    ties across shards and -0.0 kept, k past the real candidates (pads
    written as (-inf, PAD_DOC))."""
    from serenedb_tpu_torch.ops import merge_kernels as mk
    scores, docs = _merge_inputs(S, 5, L, S * 7 + L, tied)
    sc, dd = torch.from_numpy(scores).to(cuda), torch.from_numpy(docs).to(cuda)
    n = S * L
    for k in (1, 10, n, n + 5):
        vals, out = mk.merge_topk(sc, dd, k)
        v2, o2 = mk.merge_topk(sc, dd, k)
        ref_v, ref_d = mk.merge_topk_plain(sc, dd, k)
        torch.cuda.synchronize()
        assert torch.equal(out, ref_d) and torch.equal(o2, out)
        assert torch.equal(vals.view(torch.int32), ref_v.view(torch.int32))
        assert torch.equal(v2.view(torch.int32), vals.view(torch.int32))
    if n > 1:                        # k = n + 5: every lane, pads last
        pads = out.cpu().numpy() == mk.PAD_DOC
        assert pads.any() and (vals.cpu().numpy()[pads] == -np.inf).all()
    if tied and n >= 32:
        raw = vals.cpu().numpy().view(np.uint32)
        assert (raw == 0x80000000).any()          # a -0.0 kept


@pytest.mark.parametrize("seed", [0, 1])
def test_match_bitmap_matches_plain_bit_for_bit(cuda, seed):
    fi, store = _store(cuda)
    rng = np.random.default_rng(seed)
    nb, nr = store.block_base.shape[0], store.raw_docs.shape[0]
    row_idx = torch.from_numpy(rng.choice(nb, min(nb, 300), replace=False)
                               .astype(np.int32)).to(cuda)
    raw_idx = torch.from_numpy(rng.choice(nr, min(nr, 3), replace=False)
                               .astype(np.int32)).to(cuda)
    tail = torch.from_numpy(np.concatenate([
        rng.choice(fi.post_docs, 500), [-1, store.ndocs_pad + 1]])
        .astype(np.int32)).to(cuda)
    args = (store.block_base, store.block_gaps, store.block_tfs8, row_idx,
            store.raw_docs, raw_idx, tail, store.ndocs_pad)
    before = LAUNCHES.get("match_bitmap")
    got = kern.match_bitmap(*args)
    torch.cuda.synchronize()
    assert LAUNCHES.get("match_bitmap") == before + 1
    assert torch.equal(got, kern.match_bitmap_plain(*args))
    assert int(got.sum()) > 500


def test_k13_agg_entries_match_plain(cuda):
    """masked_count / masked_sum_float / masked_minmax / the one-hot
    chunk counts and group_count on `agg_scan`, against the same entries
    on CPU tensors (the plain version): integers equal, f32 sums bit for
    bit."""
    from serenedb_tpu_torch.ops import agg
    rng = np.random.default_rng(13)
    n, g = 100_000, 300
    rows = -(-n // 128)
    codes = np.zeros(rows * 128, np.int32)
    codes[:n] = rng.integers(0, g, n)
    mask = np.zeros(rows * 128, bool)
    mask[:n] = rng.random(n) > 0.1
    fv = (rng.standard_normal(rows * 128) * 100).astype(np.float32)
    iv = rng.integers(-2**31, 2**31, rows * 128, dtype=np.int64) \
        .astype(np.int32)
    host = [torch.from_numpy(a.reshape(rows, 128)) for a in
            (codes, mask, fv, iv)]
    (cc, cm, cf, ci), (hc, hm, hf, hi) = [t.to(cuda) for t in host], host
    before = LAUNCHES.get("agg_scan")
    assert int(agg.masked_count(cm)) == int(agg.masked_count(hm))
    assert _same_f32(agg.masked_sum_float(cf, cm),
                     agg.masked_sum_float(hf, hm))
    for g2 in (g, 60_000):
        assert _same_f32(agg.group_sum_float(cc, cm, cf, g2),
                         agg.group_sum_float(hc, hm, hf, g2))
    for op in ("min", "max"):
        for cv, hv in ((cf, hf), (ci, hi)):
            assert torch.equal(agg.masked_minmax(cv, cm, op).cpu(),
                               agg.masked_minmax(hv, hm, op))
    assert torch.equal(agg.group_count_onehot(cc, cm, g).cpu(),
                       agg.group_count_onehot(hc, hm, g))
    np.testing.assert_array_equal(agg.group_count(cc, cm, g),
                                  agg.group_count(hc, hm, g))
    torch.cuda.synchronize()
    assert LAUNCHES.get("agg_scan") >= before + 8


# -- kernels a call, from a captured CUDA graph ------------------------------
# (last in the file: no profiled test runs after a graph capture)

def _graph_activity(fn, memsets: bool = False) -> tuple:
    """(kernels, host-to-device copies) that one fn() issues, read from a
    CUDA graph that captures it (after a warm-up call): its kernel nodes
    and its memcpy nodes (and, with `memsets`, its memset nodes third),
    by libcuda's cuGraphGetNodes and cuGraphNodeGetType. A graph holds
    every launch, where a profiled window can drop events."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert drv.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert drv.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    # CU_GRAPH_NODE_TYPE_KERNEL = 0, _MEMCPY = 1, _MEMSET = 2
    if memsets:
        return kinds.count(0), kinds.count(1), kinds.count(2)
    return kinds.count(0), kinds.count(1)


@pytest.mark.parametrize("qp,lists,nprobe,kkp", [(1, 1024, 16, 16),
                                                 (64, 1024, 16, 16),
                                                 (3, 64, 48, 600),
                                                 (3, 8192, 5000, 16)])
def test_ivf_probe_kernels_a_call_match_the_plan(cuda, qp, lists, nprobe,
                                                 kkp):
    """A call launches `probe_plan(...).kernels` kernels and copies
    nothing in: PROBE_CALL_KERNELS (2) in the main path's regime (both
    stages fused), more where a stage takes the levels; the plan's bytes
    are the kernel's (`probe_bytes`)."""
    from serenedb_tpu_torch.ops import _build
    from serenedb_tpu_torch.ops import vector_kernels as vk
    host = _ivf_case(40_000, 128 if lists == 1024 else 8, lists, nprobe,
                     qp, seed=7)
    dev = [a.to(cuda) for a in host]
    kw = dict(metric="l2", l_real=lists, nprobe=nprobe, kkp=kkp)
    plan = vk.probe_plan(qp, lists, nprobe, host[7].numel(), kkp)
    if lists == 1024:
        assert plan.lists.fused and plan.rows.fused
        assert plan.kernels == vk.PROBE_CALL_KERNELS == 2
    kernels, copies = _graph_activity(lambda: vk.ivf_probe(*dev, **kw))
    assert (kernels, copies) == (plan.kernels, 0)
    lib = _build.load("vector")
    assert lib.probe_bytes(qp, lists, nprobe, host[7].numel(), kkp) == \
        plan.bytes


@pytest.mark.parametrize("S,L", [(1, 1), (4, 8), (3, 11), (4, 10),
                                 (8, 1024)])
def test_merge_topk_is_one_kernel_a_call(cuda, S, L):
    """Up to MERGE_ONE_MAX lanes a query a merge_topk call is one kernel
    (a warp's sort up to 32 lanes, a block's past it) and copies nothing
    in."""
    from serenedb_tpu_torch.ops import merge_kernels as mk
    scores, docs = _merge_inputs(S, 16, L, S + L, True)
    sc, dd = torch.from_numpy(scores).to(cuda), torch.from_numpy(docs).to(cuda)
    assert _graph_activity(lambda: mk.merge_topk(sc, dd, 10)) == (1, 0)


@pytest.mark.parametrize("qp,cp,kk", [(1, 19_048, 10), (64, 19_048, 10),
                                      (64, 19_048, 0), (8, 16384, 32)])
def test_pool_score_row_regime_is_one_kernel_a_call(cuda, qp, cp, kk):
    """A ROW-regime pool_score call, full or partial mode, is one kernel,
    with no memset and no copy in (no zeroed accumulator, no slice_max
    upload)."""
    sizes = [cp] + [cp // 3 + i for i in range(qp - 1)]
    arrays, smax, cand, nc = _pool_batch(qp, qp, cp, 3, 64, seed=qp,
                                         sizes=sizes)
    dev = [torch.from_numpy(a).to(cuda) for a in arrays]
    c_d, nc_d = torch.from_numpy(cand).to(cuda), torch.from_numpy(nc).to(cuda)
    assert pk.pool_regime(cp, kk) == "row"
    full = (c_d, nc_d, kk) if kk else ()
    assert _graph_activity(lambda: pk.pool_score(
        *dev, smax, cp, 1.2, 0.75, 6.5, "bm25", *full),
        memsets=True) == (1, 0, 0)


@pytest.mark.parametrize("G", [10_001, tk.CHAIN_ONE_MAX + 1])
def test_topn_calls_from_a_captured_graph(cuda, G):
    """One topn_scan call is 1 to 5 kernels and no copy in; one chain_topn
    call is one kernel under its one-block cap (more past it) and no copy
    in, counted from a captured graph as chip_smoke.py counts phase 10's
    top-N calls."""
    rng = np.random.default_rng(9)
    n = 2_097_152
    dc, kind, off = _key_tiles(
        cuda, rng.integers(0, 100_000, n).astype(np.int32))
    spec = tk.TopnSpec([kind], [off], 0, True, False)
    kernels, copies = _graph_activity(
        lambda: tk.topn_scan(spec, [(dc.data, dc.mask)], dc.mask, 10))
    assert 1 <= kernels <= 5 and copies == 0, (kernels, copies)
    rowcount = torch.from_numpy(rng.integers(0, 5, G)).to(cuda)
    outs = [rowcount, torch.zeros(G * 3, dtype=torch.int32, device=cuda)]
    kernels, copies = _graph_activity(
        lambda: tk.chain_topn(rowcount, rowcount, 1, 1, True, 16, outs))
    assert copies == 0, copies
    assert kernels == 1 if G <= tk.CHAIN_ONE_MAX else kernels >= 1, kernels


@pytest.mark.parametrize("which", ["topk_rows", "kmeans_update",
                                   "join_probe", "join_probe_right",
                                   "maxsim"])
def test_profiled_calls_also_count_from_a_captured_graph(cuda, which):
    """The calls whose kernels chip_smoke.py reads with torch.profiler
    capture in a CUDA graph, which it counts instead where no profiled
    window is complete: the graph holds the call's kernels and no copy
    in."""
    from serenedb_tpu_torch.ops import vector_kernels as vk
    rng = np.random.default_rng(4)
    if which == "topk_rows":
        scores = torch.from_numpy(
            rng.random((16, 200_003)).astype(np.float32)).to(cuda)
        hits = torch.from_numpy(rng.integers(0, 3, (16, 200_003))).to(
            cuda, torch.int32)
        require = torch.ones(16, dtype=torch.int32, device=cuda)
        want = 2                      # the one-read regime: pass 0, TAKE
        fn = lambda: kern.topk_rows(scores, 10, hits, require)  # noqa: E731
    elif which == "kmeans_update":
        x = torch.from_numpy(rng.random((100_000, 64)).astype(np.float32)
                             ).to(cuda)
        a = torch.from_numpy(rng.integers(0, 256, 100_000).astype(np.int32)
                             ).to(cuda)
        c = torch.zeros((256, 64), dtype=torch.float32, device=cuda)
        want = 4
        fn = lambda: vk.kmeans_update(x, a, c)  # noqa: E731
    elif which.startswith("join_probe"):
        right = which.endswith("right")
        spec, cols, prow, pc, cnt, rt = _probe_case(cuda, False, right)
        want = jk.CALL_LAUNCHES[right]
        fn = lambda: jk.join_probe(spec, cols, prow, pc, cnt,  # noqa: E731
                                   rt)
    else:
        ndocs, dp, lp = 300, 64, 512
        cnt = rng.integers(1, 12, ndocs).astype(np.int32)
        counts = np.zeros(lp, np.int32)
        counts[:ndocs] = cnt
        offsets = np.zeros(lp, np.int32)
        offsets[1:ndocs + 1] = np.cumsum(cnt)
        ntok = int(cnt.sum())
        rows = np.full(lp, vk.PAD_ROW, np.int32)
        rows[:ndocs] = rng.permutation(10_000)[:ndocs]
        dmap = np.full(3 * 128, ndocs, np.int32)
        dmap[:ndocs] = np.arange(ndocs)
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(cuda)
        args = (t(rng.standard_normal((ntok, dp)).astype(np.float32)),
                t(np.arange(max(ntok, 8), dtype=np.int32)), t(offsets),
                t(counts), t(rows),
                t(rng.standard_normal((4, 8, dp)).astype(np.float32)),
                t(dmap.reshape(3, 128)))
        want = None                   # tiles, score, then the selection
        fn = lambda: vk.maxsim(*args, tile=32,  # noqa: E731
                               tcap=int(cnt.max()), kkp=8)
    kernels, copies = _graph_activity(fn)
    assert copies == 0, copies
    assert kernels == want if want else kernels >= 3, kernels


def test_durable_reopen_on_the_card_matches_the_host_path(cuda, tmp_path):
    """A data directory written on the card (a snapshot, a WAL tail, an
    inverted index) and reopened on it: the device tier's rows equal the
    host path's, agg_scan and topn_scan launch, and every acknowledged
    row survives a crash."""
    from serenedb_tpu_torch.engine import Database
    d = str(tmp_path / "data")
    rng = np.random.default_rng(4)
    n = 50_000
    g, v = rng.integers(0, 40, n), rng.integers(-1000, 1000, n)
    db = Database(d, device=cuda)
    c = db.connect()
    c.execute("CREATE TABLE t (g INT, v BIGINT, body TEXT)")
    c.execute("INSERT INTO t VALUES " + ", ".join(
        f"({a}, {b}, 'w{a} w{b % 7}')" for a, b in zip(g, v)))
    c.execute("VACUUM")
    c.execute("INSERT INTO t VALUES (41, 5, 'w41 w5'), (42, 6, 'w42')")
    c.execute("CREATE INDEX ON t USING inverted (body) WITH "
              "(tokenizer = 'simple')")
    db.close()
    queries = ["SELECT g, count(*), sum(v), min(v) FROM t GROUP BY g "
               "ORDER BY g",
               "SELECT count(*), sum(v) FROM t WHERE v > 100",
               "SELECT g, v FROM t ORDER BY v DESC LIMIT 10",
               "SELECT count(*) FROM t WHERE body @@ 'w41 OR w3'"]
    for reopen in ("close", "crash"):
        db = Database(d, device=cuda)
        c = db.connect()
        c.execute("SET serene_result_cache = off")
        host = [c.execute(q).rows() for q in queries]
        c.execute("SET serene_device = 'gpu'")
        before = LAUNCHES.snapshot()
        dev = [c.execute(q).rows() for q in queries]
        after = LAUNCHES.snapshot()
        assert dev == host
        for k in ("agg_scan", "topn_scan"):
            assert after.get(k, 0) > before.get(k, 0), k
        if reopen == "close":
            assert host[0][-1] == (42, 1, 6, 6)
            c.execute("INSERT INTO t VALUES (43, 7, 'w43')")
            db.crash()
        else:
            assert host[0][-1] == (43, 1, 7, 7)
            db.close()


def test_native_index_build_on_the_card(cuda):
    """CREATE INDEX with the simple analyzer over ASCII text takes the
    native indexer on a card database, and its search equals the host
    WAND's."""
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.native import BUILDS
    rng = np.random.default_rng(6)
    docs = [" ".join(f"w{x}" for x in rng.zipf(1.3, 12) % 500)
            for _ in range(20_000)]
    db = Database(device=cuda)
    c = db.connect()
    c.execute("CREATE TABLE d (id INT, body TEXT)")
    c.execute("INSERT INTO d VALUES " + ", ".join(
        f"({i}, '{t}')" for i, t in enumerate(docs)))
    before = BUILDS.snapshot()
    c.execute("CREATE INDEX ON d USING inverted (body) WITH "
              "(tokenizer = 'simple')")
    after = BUILDS.snapshot()
    assert after.get("native", 0) > before.get("native", 0)
    assert after.get("python", 0) == before.get("python", 0)
    q = ("SELECT id, bm25(body) AS s FROM d WHERE body @@ 'w3 w17' "
         "ORDER BY s DESC, id LIMIT 10")
    dev = c.execute(q).rows()
    c.execute("SET serene_device = 'cpu'")
    host = c.execute(q).rows()
    assert [r[0] for r in dev] == [r[0] for r in host]
    np.testing.assert_allclose([r[1] for r in dev], [r[1] for r in host],
                               rtol=2e-3, atol=1e-3)


# -- the device mesh (ops/mesh_kernels.py) -------------------------------------


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
def test_mesh_combine_matches_plain_bit_for_bit(cuda, M, dtype):
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    rng = np.random.default_rng(M)
    n = 100_003
    if dtype.is_floating_point:
        x = rng.standard_normal((M, n)) * 10.0 ** rng.integers(-3, 8, (M, n))
        x[rng.random((M, n)) < 0.001] = np.nan
    else:
        x = rng.integers(-2**31, 2**31 - 1, (M, n))
    st = torch.from_numpy(x).to(dtype).to(cuda)
    for op in ("sum", "min", "max"):
        unsigned_opts = (False, True) if dtype == torch.int32 and \
            op != "sum" else (False,)
        for uns in unsigned_opts:
            before = LAUNCHES.get("mesh_combine")
            got = mk.mesh_combine(st, op, uns)
            torch.cuda.synchronize()
            assert LAUNCHES.get("mesh_combine") == before + 1
            assert _bits_equal(got, mk.mesh_combine_plain(st, op, uns)), \
                (op, uns)


def _combine_base(rng, dtype, M: int, n: int) -> np.ndarray:
    shape = (M, n + 8)
    if dtype == torch.int64:
        return rng.integers(-2**40, 2**40, shape)           # sums past 2^31
    if dtype == torch.float32:
        x = (rng.standard_normal(shape) * 1e3).astype(np.float32)
        x[rng.random(shape) < 0.01] = np.nan
        return x
    return rng.integers(-2**31, 2**31 - 1, shape).astype(np.int32)


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
def test_mesh_combine_parts_and_many_match_plain(cuda, M, dtype):
    """The parts form and the many-segment form against the plain version
    bit for bit: parts each in its own buffer (16-byte vectors), views at
    odd offsets (the scalar path), N = 0 and N not a multiple of 4, NaN
    in min/max, int32 as unsigned; one launch a call, none for N = 0."""
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    rng = np.random.default_rng(10 + M)
    ops = [("sum", False), ("min", False), ("max", False)]
    if dtype == torch.int32:
        ops += [("min", True), ("max", True)]
    for n in (0, 1, 7, 100_003):
        b = torch.from_numpy(_combine_base(rng, dtype, M, n)).to(cuda)
        for form in ("own", "odd", "rows"):
            if form == "own":
                parts = [b[s, :n].clone() for s in range(M)]
            elif form == "odd":
                parts = [b[s, 1 + s % 3:1 + s % 3 + n] for s in range(M)]
            else:
                parts = b[:, :n].contiguous()
            before = LAUNCHES.get("mesh_combine")
            many = mk.mesh_combine_many([(parts, op, u) for op, u in ops])
            torch.cuda.synchronize()
            assert LAUNCHES.get("mesh_combine") == before + (1 if n else 0)
            for (op, u), m in zip(ops, many):
                want = mk.mesh_combine_plain(parts, op, u)
                got = mk.mesh_combine(parts, op, u)
                torch.cuda.synchronize()
                assert got.shape == want.shape == (n,)
                assert _bits_equal(m, want) and _bits_equal(got, want), \
                    (n, form, op, u)


def test_mesh_combine_past_the_cap_is_the_fewest_launches(cuda):
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    rng = np.random.default_rng(3)
    for M, segs, want in ((4, mk.COMBINE_SEGS + 12, 2), (8, 40, 2),
                          (2, mk.COMBINE_SEGS, 1)):
        outs = [[torch.from_numpy(rng.standard_normal(1000 + i)
                                  .astype(np.float32)).to(cuda)
                 for _ in range(M)] for i in range(segs)]
        ops = ["sum", "min", "max"]
        call = [(p, ops[i % 3]) for i, p in enumerate(outs)]
        before = LAUNCHES.get("mesh_combine")
        got = mk.mesh_combine_many(call)
        torch.cuda.synchronize()
        assert LAUNCHES.get("mesh_combine") == before + want
        ref = mk.mesh_combine_many_plain(call)
        assert all(_bits_equal(g, r) for g, r in zip(got, ref))


def _synth_match(cuda, ndocs_pad: int, rows: int, raw_rows: int,
                 tails: int, seed: int):
    """A block store's planes for match_bitmap: packed rows whose docs run
    past the bitmap near its end, tf 0 pads, raw rows with -1 pads and
    docs past the bitmap, and tails likewise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, ndocs_pad, rows).astype(np.int32)
    base[: max(1, rows // 50)] = ndocs_pad - 1000
    gaps = rng.integers(0, 40, (rows, 128)).astype(np.uint16)
    tfs = rng.integers(0, 4, (rows, 128)).astype(np.uint8)
    raw = rng.integers(0, ndocs_pad, (raw_rows, 128)).astype(np.int32)
    raw[rng.random(raw.shape) < 0.1] = -1
    raw[rng.random(raw.shape) < 0.05] = ndocs_pad + 7
    tail = rng.integers(-1, ndocs_pad + 3, tails).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    return t(base), t(gaps), t(tfs), t(raw), t(tail)


def test_match_bitmap_one_launch_every_section_shape(cuda):
    """Each section empty or not (all empty too), docs past the bitmap
    dropped, a tail starting off a 16-byte boundary: bit for bit the
    plain version, one launch a call."""
    nd = 100_003                          # the zero fill's ragged end
    base, gaps, tfs, raw, tail = _synth_match(cuda, nd, 300, 6, 1001, 4)
    e = torch.empty(0, dtype=torch.int32, device=cuda)
    rows = torch.arange(300, dtype=torch.int32, device=cuda)
    raws = torch.tensor([0, 5, 2], dtype=torch.int32, device=cuda)
    for r, w, tl in ((e, e, e), (rows, e, e), (e, raws, e), (e, e, tail),
                     (rows, raws, tail), (rows.flip(0), raws, tail[1:])):
        args = (base, gaps, tfs, r, raw, w, tl, nd)
        before = LAUNCHES.get("match_bitmap")
        got = kern.match_bitmap(*args)
        torch.cuda.synchronize()
        assert LAUNCHES.get("match_bitmap") == before + 1
        assert torch.equal(got, kern.match_bitmap_plain(*args))


def test_match_bitmap_at_the_packed_corpus_size(cuda):
    """An 8,000,512-doc bitmap (the packed corpus's) over 4,000 packed
    rows, 2 raw rows and 3,000 tails: twice, equal to the plain version
    (the second call finds the first's bits in the cache's memory)."""
    nd = 8_000_512
    base, gaps, tfs, raw, tail = _synth_match(cuda, nd, 4000, 2, 3000, 5)
    rows = torch.arange(4000, dtype=torch.int32, device=cuda)
    raws = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    args = (base, gaps, tfs, rows, raw, raws, tail, nd)
    want = kern.match_bitmap_plain(*args)
    for _ in range(2):
        before = LAUNCHES.get("match_bitmap")
        got = kern.match_bitmap(*args)
        torch.cuda.synchronize()
        assert LAUNCHES.get("match_bitmap") == before + 1
        assert torch.equal(got, want) and int(got.sum()) > 100_000


@pytest.mark.parametrize("R", [1, 8, 1000])
@pytest.mark.parametrize("fill", [0.0, 0.2, 1.0])
def test_mesh_agg_partials_matches_plain(cuda, R, fill):
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    rng = np.random.default_rng(R)
    vals = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (R, 128))
                            .astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((R, 128)) >= fill).to(cuda)
    for lo, hi in ((-2**31, 2**31 - 1), (1000, 2**29), (0, 0)):
        c, p = mk.mesh_agg_partials(vals, mask, lo, hi)
        rc, rp = mk.mesh_agg_partials_plain(vals, mask, lo, hi)
        torch.cuda.synchronize()
        assert torch.equal(c, rc) and torch.equal(p, rp)


@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["bm25", "saturation"])
def test_mesh_score_blocks_match_plain_bit_for_bit(cuda, M, mode):
    """Each shard's plane bit-equal to the plain version's, padded and
    under-filled shards included (a shard of all-padding rows), docs met
    out of order and many entries a doc."""
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    from serenedb_tpu_torch.parallel import mesh as pmesh
    rng = np.random.default_rng(M)
    p, nd = 200_000, 50_000
    docs = torch.from_numpy(rng.integers(0, nd, p).astype(np.int32)).to(cuda)
    tfs = torch.from_numpy(rng.integers(1, 30, p).astype(np.int32)).to(cuda)
    norms = torch.from_numpy(rng.integers(1, 400, nd).astype(np.int32)
                             ).to(cuda)
    rows = 8 * M
    g = rng.integers(0, p, (rows, 128)).astype(np.int32)
    g[rng.random((rows, 128)) < 0.1] = -1
    g[-(rows // M):] = -1                       # the last shard: padding
    gidx = torch.from_numpy(g).to(cuda)
    bt = torch.from_numpy(rng.integers(0, 5, rows).astype(np.int32)).to(cuda)
    idf = torch.from_numpy(rng.random(5).astype(np.float32) * 3).to(cuda)
    for a, b in pmesh.shard_slices(rows, M):
        before = LAUNCHES.get("mesh_score_blocks")
        got = mk.mesh_score_blocks(docs, tfs, norms, gidx[a:b], bt[a:b],
                                   idf, 37.5, nd, mode)
        again = mk.mesh_score_blocks(docs, tfs, norms, gidx[a:b], bt[a:b],
                                     idf, 37.5, nd, mode)
        ref = mk.mesh_score_blocks_plain(docs, tfs, norms, gidx[a:b],
                                         bt[a:b], idf, 37.5, nd, mode)
        torch.cuda.synchronize()
        assert LAUNCHES.get("mesh_score_blocks") == before + 2
        assert _bits_equal(got, ref) and _bits_equal(again, got)


def _score_shape(shape: str, mode: str, dev):
    """Inputs of mesh_score_blocks (args, kwargs) at one shape the card
    must take: 'sparse' (8,000,512 docs, ~600,000 entries, a BM25
    shard's), 'heavy' (E far above ndocs, one doc with 100,000+ entries),
    'edges' (docs on bin edges, ndocs not a multiple of a bin),
    'unsorted' rows, an all-'padding' shard, 'empty' (E = 0), 'sorted'
    (one posting list, no padding: every slice read in place) and
    'lists' (posting lists padded to rows of 128: slices in place and
    slices bucketed in one call)."""
    rng = np.random.default_rng(len(shape))
    nd = {"sparse": 8_000_512, "sorted": 8_000_512, "lists": 117_440_512,
          "heavy": 3_001, "edges": 3 * 2048 + 5}.get(shape, 50_000)
    P = {"sparse": 2_400_000, "sorted": 2_400_000, "lists": 4_000_000,
         "heavy": 300_000}.get(shape, 200_000)
    docs = rng.integers(0, nd, P).astype(np.int32)
    if shape in ("sparse", "sorted"):     # doc-sorted posting lists
        docs = np.sort(docs.reshape(4, -1), axis=1).reshape(-1)
    if shape == "lists":
        cuts = np.sort(rng.choice(P, 40, replace=False))
        docs = np.concatenate([np.sort(x) for x in np.split(docs, cuts)])
    if shape == "heavy":
        docs[rng.permutation(P)[:100_500]] = 1234
    if shape == "edges":
        docs = rng.choice(np.asarray([0, 2047, 2048, 4095, 4096, 6143, 6144,
                                      nd - 1], np.int32), P)
    tfs = rng.integers(1, 60, P).astype(np.int32)
    norms = rng.integers(1, 500, nd).astype(np.int32)
    rows = {"sparse": 4_671, "sorted": 4_671, "heavy": P // 128,
            "empty": 0}.get(shape, 1_000)
    if shape in ("sparse", "sorted"):
        g = np.arange(600_000, 600_000 + rows * 128).reshape(rows, 128)
    elif shape == "heavy":
        g = np.arange(rows * 128).reshape(rows, 128)
    elif shape == "lists":
        bounds = np.r_[0, cuts, P]
        g = np.concatenate([np.r_[np.arange(x, y), np.full(-(y - x) % 128,
                                                            -1)]
                            for x, y in zip(bounds[:-1], bounds[1:])])
        g = g.reshape(-1, 128)
        rows = g.shape[0]
    else:
        g = rng.integers(0, P, (rows, 128))
        if shape != "unsorted":
            g = np.sort(g, axis=None).reshape(rows, 128)
    g = g.astype(np.int32)
    if shape not in ("sorted", "lists"):
        g[rng.random(g.shape) < 0.05] = -1
    if shape == "padding":
        g[:] = -1
    bt = rng.integers(0, 4, rows).astype(np.int32)
    idf = (rng.random(4) * 3).astype(np.float32)
    T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return ((T(docs), T(tfs), T(norms), T(g), T(bt), T(idf), 41.25, nd,
             mode), {})


@pytest.mark.parametrize("shape", ["sparse", "heavy", "edges", "unsorted",
                                   "padding", "empty", "sorted", "lists"])
@pytest.mark.parametrize("mode", ["bm25", "saturation"])
def test_mesh_score_blocks_shapes_bit_for_bit(cuda, shape, mode):
    """Bit-equal to the plain version and to a second call at every shape
    the design must take (ndocs far above E and far below it, bin edges,
    unsorted rows, an all-padding shard, no entries, slices read in
    place and bucketed)."""
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    a, kw = _score_shape(shape, mode, cuda)
    before = LAUNCHES.get("mesh_score_blocks")
    got = mk.mesh_score_blocks(*a, **kw)
    again = mk.mesh_score_blocks(*a, **kw)
    ref = mk.mesh_score_blocks_plain(*a, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.get("mesh_score_blocks") == before + 2
    assert _bits_equal(got, ref) and _bits_equal(again, got)


@pytest.mark.parametrize("R", [195_313, 4_225])
@pytest.mark.parametrize("fill", [0.0, 0.2, 1.0])
def test_mesh_agg_partials_card_grid_bit_for_bit(cuda, R, fill):
    """A card-sized grid at one shard of q1's 100M rows and at R not a
    multiple of a block's rows: equal to the plain version, the same on
    a second call, and at fill 0 over the full range the count is R * 128
    exactly."""
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    rng = np.random.default_rng(R)
    vals = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (R, 128))
                            .astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((R, 128)) >= fill).to(cuda)
    for lo, hi in ((-2**31, 2**31 - 1), (1000, 2**29), (0, 0)):
        c, p = mk.mesh_agg_partials(vals, mask, lo, hi)
        c2, p2 = mk.mesh_agg_partials(vals, mask, lo, hi)
        rc, rp = mk.mesh_agg_partials_plain(vals, mask, lo, hi)
        torch.cuda.synchronize()
        assert torch.equal(c, rc) and torch.equal(p, rp)
        assert torch.equal(c2, c) and torch.equal(p2, p)
        if fill == 0.0 and lo == -2**31:
            assert int(c) == R * 128


@pytest.mark.parametrize("shape", ["sparse", "heavy", "empty", "sorted"])
@pytest.mark.parametrize("mode", ["bm25", "saturation"])
def test_mesh_score_blocks_is_two_kernels_and_no_memset(cuda, shape, mode):
    """A mesh_score_blocks call from a captured graph: two kernels (at
    most three allowed), no memset, no copy in."""
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    a, kw = _score_shape(shape, mode, cuda)
    assert _graph_activity(lambda: mk.mesh_score_blocks(*a, **kw),
                           memsets=True) == (2, 0, 0)


@pytest.mark.parametrize("R", [195_313, 1, 0])
def test_mesh_agg_partials_is_one_kernel_and_no_memset(cuda, R):
    """A mesh_agg_partials call from a captured graph: one kernel, no
    memset (the count's counter resets itself), no copy in; the count
    right on every replay."""
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    rng = np.random.default_rng(7)
    vals = torch.from_numpy(rng.integers(0, 2**20, (R, 128))
                            .astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((R, 128)) > 0.3).to(cuda)
    call = lambda: mk.mesh_agg_partials(vals, mask, 10, 2**19)  # noqa
    assert _graph_activity(call, memsets=True) == (1, 0, 0)
    rc, rp = mk.mesh_agg_partials_plain(vals, mask, 10, 2**19)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        c, p = call()
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(c, rc) and torch.equal(p, rp)
    c, p = call()
    torch.cuda.synchronize()
    assert torch.equal(c, rc) and torch.equal(p, rp)


def test_score_plan_matches_the_kernel_sizes(cuda):
    """ops/mesh_kernels.score_plan's bytes are the library's
    `score_bytes`."""
    from serenedb_tpu_torch.ops import _build
    from serenedb_tpu_torch.ops import mesh_kernels as mk
    lib = _build.load("mesh")
    for E in (0, 1, 2047, 2049, 597_888, 29_360_128, 2**31 - 1):
        for nd in (1, 2048, 6_149, 8_000_512, 117_440_512, 2**31 - 1):
            assert lib.score_bytes(E, nd) == mk.score_plan(E, nd).bytes


def test_mesh_builders_on_a_virtual_card_mesh(cuda):
    """The three builders over a 4-wide virtual mesh on the card equal
    the same builders' plain run on the CPU, bit for bit."""
    from serenedb_tpu_torch.parallel import mesh as pmesh
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 2**30, (64, 128)).astype(np.int32)
    mask = rng.random((64, 128)) > 0.2
    p = 8 * 128
    fd = np.sort(rng.integers(0, p, p)).astype(np.int32)
    ft = rng.integers(1, 5, p).astype(np.int32)
    nm = rng.integers(5, 50, p).astype(np.int32)
    gidx = np.arange(p, dtype=np.int32).reshape(-1, 128)
    bt = np.zeros(p // 128, np.int32)
    idf = np.asarray([1.7], np.float32)
    codes = rng.integers(0, 16, (64, 128)).astype(np.int32)
    outs = {}
    with pmesh.virtual_devices(4):
        for dev in (cuda, torch.device("cpu")):
            T = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
            m = pmesh.make_mesh(4, base=dev)
            a = pmesh.sharded_agg_step(m)(T(vals), T(mask), 1000, 2**29)
            b = pmesh.sharded_bm25_topk(m, p, 10)(
                T(fd), T(ft), T(nm), T(gidx), T(bt), T(idf), 20.0)
            c = pmesh.sharded_query_step(m, 16)(
                T(vals % 100), T(mask), T(codes), T(fd), T(ft), T(gidx),
                T(bt))
            outs[dev.type] = [t.cpu() for t in (*a, *b, *c)]
    for x, y in zip(outs["cuda"], outs["cpu"]):
        assert _bits_equal(x, y)


# -- scan_eval and statements split across launches -------------------------

from serenedb_tpu_torch.exec import device_split  # noqa: E402
from serenedb_tpu_torch.ops import scan_kernels as sk  # noqa: E402


def _cmp(code, f=False):
    """A comparison op: its code goes in the op's arg."""
    return (ak.OP_CMP_F if f else ak.OP_CMP_I, C[code], 0)


#: derive programs over _scan_cols' slots, by output kind: an int32
#: product that wraps, an int8 product wrapped at 8 bits, an f32 sum with
#: NaN/inf/-0.0, and a boolean (stored 0/1 in int8)
_DERIVE = [
    (ak.COL_I32, (_COL(2), _COL(0), (ak.OP_MUL_I, 0, 0), _COL(1),
                  (ak.OP_SUB_I, 0, 0))),
    (ak.COL_I8, (_COL(3), _COL(3), (ak.OP_MUL_I, 0, 0),
                 (ak.OP_WRAP8, 0, 0))),
    (ak.COL_F32, (_COL(4), _COL(1), (ak.OP_I2F, 0, 0), (ak.OP_ADD_F, 0, 0),
                  (ak.OP_F32, 0, ak.f32_bits(0.25)), (ak.OP_MUL_F, 0, 0))),
    (ak.COL_I8, _PRED),
]
#: mask programs over _scan_cols' slots
_MASKS = [_PRED, (_COL(4), (ak.OP_F32, 0, ak.f32_bits(-20.0)),
                  _cmp(">=", True)),
          (_COL(5), _I(3), _cmp("<>"))]


def _prep_spec(kinds, offs, mode="both"):
    """A prepare over _scan_cols' six slots: the four derive programs
    (slots 6-9; the boolean one not stored), a fifth reading the first
    and the f32 tile (slot 10), then mask passes, one of them reading
    the boolean tile and one the fifth tile; 'derive' and 'mask' keep
    one kind of pass."""
    der = [sk.Derive(prog, out, i != 3) for i, (out, prog) in
           enumerate(_DERIVE)]
    der.append(sk.Derive((_COL(6), _COL(8), (ak.OP_F2I, 0, 0),
                          (ak.OP_ADD_I, 0, 0)), ak.COL_I32))
    preds = list(_MASKS) + [(_COL(9), (ak.OP_TOBOOL_I, 0, 0)),
                            (_COL(10), _I(-10**6), _cmp(">"))]
    if mode == "derive":
        return sk.EvalSpec(kinds, offs, [sk.Derive(d.prog, d.out)
                                         for d in der])
    if mode == "mask":
        return sk.EvalSpec(kinds, offs, preds=list(_MASKS))
    return sk.EvalSpec(kinds, offs, der, preds)


def _same_prep(got, ref, rowmask):
    """A card prepare against the plain version's: every tile bit for
    bit (f32 NaN meeting NaN), the validity and the mask equal."""
    (tiles, mask), (rtiles, rmask) = got, ref
    torch.cuda.synchronize()
    assert len(tiles) == len(rtiles)
    for t, r in zip(tiles, rtiles):
        assert (t is None) == (r is None)
        if t is None:
            continue
        assert t[0].dtype == r[0].dtype and t[0].shape == r[0].shape
        assert _same_f32(t[0], r[0]) if t[0].dtype == torch.float32 else \
            torch.equal(t[0].cpu(), r[0].cpu())
        assert torch.equal(t[1].cpu(), r[1].cpu())
        assert not t[0][~t[1]].any()
    assert (mask is rowmask) == (rmask is rowmask)
    assert torch.equal(mask.cpu(), rmask.cpu())


@pytest.mark.parametrize("tiles", [(0, None), (7, 300), (5, 6), (1, 2)])
def test_scan_eval_matches_plain_bit_for_bit(cuda, tiles):
    """One launch of derive and mask passes over every decode kind (FOR8,
    FOR16, int32, int8, f32 with NaN/inf/-0.0, dictionary codes), NULLs
    in every slot, each output kind, a derived tile read by a later
    derive and by a mask pass, one not stored, on the whole table and on
    ragged tile ranges (the chunk slices a split hands it): the kernel's
    tiles and mask equal the plain version's, bit for bit."""
    dcs, kinds, offs, rowmask = _scan_cols(cuda)
    a, b = tiles
    b = rowmask.shape[0] if b is None else b
    cols = [(dc.data[a:b], dc.mask[a:b]) for dc in dcs]
    rm = rowmask[a:b]
    spec = _prep_spec(kinds, offs)
    LAUNCHES.reset()
    got = sk.scan_eval(spec, cols, rm)
    assert LAUNCHES.snapshot() == {"scan_eval": 1}
    assert spec.plan.n_stages == 3
    _same_prep(got, sk.scan_eval_plain(spec, cols, rm), rm)
    if b - a > 100:
        assert 0 < int(got[1].sum()) < int(rm.sum())


@pytest.mark.parametrize("n,shift", [(1, 0), (127, 0), (128 * 3 + 5, 0),
                                      (9, 0), (17, 0), (128 * 3 + 5, 1),
                                      (1024 * 2 + 1, 0), (1024 * 4 + 517, 0),
                                      (1024 * 4 + 517, 1)])
def test_scan_eval_ragged_rows_and_misaligned_bases(cuda, n, shift):
    """Row counts that are no whole vector (1, 127, 128k+5, one past 8 and
    16 rows, one past two of a block's 1,024-row tiles, a partial tile
    after four) and bases one element off their 16-byte alignment: the
    kernel takes the tail and the scalar path itself, bit for bit."""
    dcs, kinds, offs, rowmask = _scan_cols(cuda)
    cols = [(dc.data.reshape(-1)[shift: shift + n],
             dc.mask.reshape(-1)[shift: shift + n]) for dc in dcs]
    rm = rowmask.reshape(-1)[shift: shift + n]
    spec = _prep_spec(kinds, offs)
    _same_prep(sk.scan_eval(spec, cols, rm), sk.scan_eval_plain(
        spec, cols, rm), rm)


@pytest.mark.parametrize("mode", ["mask", "derive"])
def test_scan_eval_mask_only_and_derive_only(cuda, mode):
    """A prepare of mask passes only (one output, the mask) and one of
    derive passes only (the row mask returned as it is, never written)."""
    dcs, kinds, offs, rowmask = _scan_cols(cuda)
    cols = [(dc.data, dc.mask) for dc in dcs]
    spec = _prep_spec(kinds, offs, mode)
    got = sk.scan_eval(spec, cols, rowmask)
    _same_prep(got, sk.scan_eval_plain(spec, cols, rowmask), rowmask)
    assert (got[1] is rowmask) == (mode == "derive")
    # the mask; or five tiles (three of 4 bytes, two of 1) and validities
    assert spec.plan.row_bytes == (1 if mode == "mask" else 19)


def test_scan_eval_past_16_stages_and_192_ops(cuda):
    """20 derived values that 20 mask passes read (more than the 16
    stages: four written and read back), over 18 input slots and 300 ops
    in all: one launch, bit for bit."""
    dcs, kinds, offs, rowmask = _scan_cols(cuda)
    cols = [(dc.data, dc.mask) for dc in dcs] * 3
    kinds, offs = kinds * 3, offs * 3
    ints = [s for s in range(18) if kinds[s] != ak.COL_F32]
    der, preds = [], []
    for k in range(20):
        a, b, c = (ints[(k + i) % len(ints)] for i in (0, 5, 9))
        body = (_COL(a), _COL(b), (ak.OP_MUL_I, 0, 0), _COL(c),
                (ak.OP_SUB_I, 0, 0))
        if k % 3 == 2:
            body += ((ak.OP_I2F, 0, 0), _COL(16), (ak.OP_ADD_F, 0, 0))
        else:
            body += (_I(k), (ak.OP_ADD_I, 0, 0)) + \
                (((ak.OP_WRAP8, 0, 0),) if k % 3 else ())
        der.append(sk.Derive(body, (ak.COL_I32, ak.COL_I8,
                                    ak.COL_F32)[k % 3], k in (2, 17)))
        cmp = ((ak.OP_F32, 0, ak.f32_bits(-1e9)), _cmp(">", True)) \
            if k % 3 == 2 else (_I(-100), _cmp(">"))
        preds.append((_COL(18 + k),) + cmp + (
            _COL(18 + (k + 1) % 20), (ak.OP_IS_NULL, 0, 0),
            (ak.OP_OR, 0, 0)))
    spec = sk.EvalSpec(kinds, offs, der, preds)
    assert sum(map(len, [d.prog for d in der] + preds)) > ak.MAX_OPS
    LAUNCHES.reset()
    got = sk.scan_eval(spec, cols, rowmask)
    assert LAUNCHES.snapshot() == {"scan_eval": 1}
    assert spec.plan.n_stages == sk.MAX_STAGES
    _same_prep(got, sk.scan_eval_plain(spec, cols, rowmask), rowmask)


def test_scan_eval_chains_a_prepare_past_128_slots(cuda):
    """140 predicates over 144 slots (_scan_cols' six, 24 times over):
    the scan keeps 8, the other 132 mask passes read more slots than a
    scan_eval launch takes, so the prepare is two launches, the second
    narrowing the first's row mask; the statement's outputs on the card
    are its plain versions' on the CPU."""
    dcs, kinds, offs, rowmask = _scan_cols(cuda)
    cols = [(dc.data, dc.mask) for dc in dcs] * 24
    low = [-99, -29990, -2**31 + 10**6, -127, None, -1]
    preds = []
    for s in range(140):
        if s % 6 == 4:
            preds.append((_COL(s), (ak.OP_F32, 0, ak.f32_bits(-1e30)),
                          _cmp(">", True)))
        else:
            preds.append((_COL(s), _I(low[s % 6]), _cmp(">")))
    split = device_split.plan_scan(ak.ScanSpec(
        kinds * 24, offs * 24, preds, [], False, 1,
        [ak.ScanAgg(ak.AGG_COUNT, (_COL(0),)),
         ak.ScanAgg(ak.AGG_SUM_I, (_COL(2), _COL(0), (ak.OP_MUL_I, 0, 0)))]))
    assert isinstance(split, device_split.Split) and len(split.prep) == 2
    cpu = [(d.cpu(), m.cpu()) for d, m in cols]
    for a, b in ((0, rowmask.shape[0]), (3, 200)):
        LAUNCHES.reset()
        got = device_split.agg_scan(split, cols, rowmask, None, a, b)
        assert LAUNCHES.snapshot() == {"scan_eval": 2, "agg_scan": 1}
        ref = device_split.agg_scan(split, cpu, rowmask.cpu(), None, a, b)
        torch.cuda.synchronize()
        _assert_raw_equal((got[0].cpu(), [[t.cpu() for t in o]
                                          for o in got[1]]), ref)


def test_scan_eval_runs_a_24_deep_chain_in_one_launch(cuda):
    """A sum 24 deep over 24 slots: three derived tiles in a chain, the
    first two read only by the next derive (kept in stages, not stored),
    one scan_eval launch a chunk; the statement's outputs are the plain
    versions' on the CPU."""
    dcs, kinds, offs, rowmask = _scan_cols(cuda)
    cols = [(dc.data, dc.mask) for dc in dcs] * 4
    ints = [s for s in range(24) if (kinds * 4)[s] != ak.COL_F32]
    deep = tuple(_COL(s) for s in ints + ints[:4]) + \
        ((ak.OP_ADD_I, 0, 0),) * (len(ints) + 3)
    split = device_split.plan_scan(ak.ScanSpec(
        kinds * 4, offs * 4, [], [], False, 1,
        [ak.ScanAgg(ak.AGG_SUM_I, deep)]))
    (_slots, ev), = split.prep
    assert len(ev.derived) == 3 and \
        [d.stored for d in ev.derived] == [False, False, True]
    LAUNCHES.reset()
    got = device_split.agg_scan(split, cols, rowmask, None, 0,
                                rowmask.shape[0])
    assert LAUNCHES.snapshot() == {"scan_eval": 1, "agg_scan": 1}
    ref = device_split.agg_scan(split, [(d.cpu(), m.cpu()) for d, m in cols],
                                rowmask.cpu(), None, 0, rowmask.shape[0])
    torch.cuda.synchronize()
    _assert_raw_equal((got[0].cpu(), [[t.cpu() for t in o]
                                      for o in got[1]]), ref)


def _wide_spec(kinds, offs, G, keys):
    """A statement past one launch over _scan_cols' six slots read three
    times over (18 slots): 20 aggregates, among them f32 sums and
    programs 12 deep; 10 predicates, one of them 11 deep. Integer ops
    read integer slots only, as compile_expr types them."""
    ints = [s for s, k in enumerate(kinds) if k != ak.COL_F32]

    def deep(depth, base):
        return tuple(_COL(ints[(base + i) % len(ints)])
                     for i in range(depth)) + \
            ((ak.OP_ADD_I, 0, 0),) * (depth - 1)
    aggs = [ak.ScanAgg(ak.AGG_SUM_I, (_COL(s),)) for s in ints[::2]]
    aggs += [ak.ScanAgg(ak.AGG_SUM_I, deep(12, 1)),
             ak.ScanAgg(ak.AGG_MAX_I, deep(9, 2)),
             ak.ScanAgg(ak.AGG_SUM_F, _ARGS[ak.AGG_SUM_F]),
             ak.ScanAgg(ak.AGG_SUM_F, (_COL(10), _COL(13), (ak.OP_I2F, 0, 0),
                                       (ak.OP_ADD_F, 0, 0))),
             ak.ScanAgg(ak.AGG_MIN_F, (_COL(16),)),
             ak.ScanAgg(ak.AGG_COUNT, (_COL(15),)),
             ak.ScanAgg(ak.AGG_PRESENCE, None, 17, ak.KEY_INT, 0, 8)]
    aggs += [ak.ScanAgg(ak.AGG_MIN_I, (_COL(i),)) for i in (6, 8, 12, 14)]
    preds = [(_COL(i), _I(-120), _cmp(">"))
             for i in (0, 6, 12, 2, 8, 14, 3, 9, 15)]
    preds.append(deep(11, 7) + (_I(-10**9), _cmp(">")))
    return ak.ScanSpec(kinds, offs, preds, keys, False, G, aggs)


@pytest.mark.parametrize("mode", ["scalar", "small", "sort"])
def test_split_statement_matches_its_plain_versions(cuda, mode):
    """A statement past one launch (derived tiles, mask passes, two
    agg_scan launches) gives on the card the bits its plain versions
    give on the CPU: every output, f32 sums included (the SMALL and the
    SORT regime's orders), over a chunk slice as the planner runs it."""
    dcs, kinds, offs, rowmask = _scan_cols(cuda)
    cols = [(dc.data, dc.mask) for dc in dcs] * 3
    keys, G = [], 1
    if mode == "small":
        keys, G = [(ak.KEY_INT, 5, 0, 8), (ak.KEY_INT, 3, -128, 16)], 128
    elif mode == "sort":
        keys, G = [(ak.KEY_INT, 1, -30000, 60001)], 60001
    split = device_split.plan_scan(_wide_spec(kinds * 3, offs * 3, G, keys))
    assert isinstance(split, device_split.Split)
    assert split.prep[0][1].derived and split.prep[0][1].preds and \
        len(split.launches) == 2
    want = {"scalar": ak.REGIME_SCALAR, "small": ak.REGIME_SMALL,
            "sort": ak.REGIME_SORT}[mode]
    assert {ak.split(ln.spec, 1).regime for ln in split.launches
            if ln.spec.has_float_sum()} == {want}
    cpu = [(d.cpu(), m.cpu()) for d, m in cols]
    for a, b in ((0, rowmask.shape[0]), (3, 200)):
        LAUNCHES.reset()
        got = device_split.agg_scan(split, cols, rowmask, None, a, b)
        assert LAUNCHES.get("scan_eval") == 1 and \
            LAUNCHES.get("agg_scan") == 2
        ref = device_split.agg_scan(split, cpu, rowmask.cpu(), None, a, b)
        torch.cuda.synchronize()
        _assert_raw_equal((got[0].cpu(), [[t.cpu() for t in o]
                                          for o in got[1]]), ref)


def test_split_top_n_matches_its_plain_versions(cuda):
    """A filtered top-N past one launch (a predicate 11 deep, 10
    predicates over 18 slots): the same indices and survivor count on the
    card as its plain versions on the CPU."""
    dcs, kinds, offs, rowmask = _scan_cols(cuda)
    cols = [(dc.data, dc.mask) for dc in dcs] * 3
    spec = _wide_spec(kinds * 3, offs * 3, 1, [])
    split = device_split.plan_topn(tk.TopnSpec(
        spec.col_kinds, spec.col_offsets, 1, True, False, spec.preds))
    assert isinstance(split, device_split.Split) and \
        split.prep[0][1].derived
    got = device_split.topn_scan(split, cols, rowmask, 100)
    ref = device_split.topn_scan(split, [(d.cpu(), m.cpu()) for d, m in cols],
                                 rowmask.cpu(), 100)
    torch.cuda.synchronize()
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, ref))
