"""The batched ragged path and the posting pool on the port, against the
JAX package, on the CPU.

`topk_batch(ragged=True)` takes `_ragged_resolve` in both packages here
(the reference because JAX runs on its CPU backend, the port on any
device), so the same corpora and queries, made from a numpy seed, go
through the reference's ragged path and pool and through the port's
(`device="cpu"`: `contrib_flat` and `pool_score` run their plain
versions). Scores hold to rtol 1e-5 / atol 1e-6 and ids are equal but
where scores tie within that, the port's search rule (test_torch_search):
XLA's simplifier moves the reference's contributions by an ulp at times
(its own note, serenedb_tpu/ops/bm25.py `contrib_expr`), where the
port's routes compute one expression; at k = 10 on these corpora the bits
agree. Among themselves the port's four routes (plane, host ragged, pool
full, pool partial) are bit-identical, as the reference's are.

Both packages set `DENSE_HBM_BUDGET` to 0, so these small corpora score
in the packed regime, where the ragged path runs.
"""

import threading
import time
import types

import numpy as np
import pytest

import serenedb_tpu.ops.bm25 as ref_bm25
import serenedb_tpu_torch.ops.bm25 as port_bm25
from serenedb_tpu.engine import Database as RefDatabase
from serenedb_tpu.exec.device_pipeline import DEVICE_CACHE as REF_CACHE
from serenedb_tpu.search.analysis import get_analyzer as ref_analyzer
from serenedb_tpu.search.posting_pool import POOL as REF_POOL
from serenedb_tpu.search.query import parse_query as ref_parse
from serenedb_tpu.search.searcher import MultiSearcher as RefMulti
from serenedb_tpu.search.searcher import SegmentSearcher as RefSeg
from serenedb_tpu.search.segment import build_field_index as ref_build
from serenedb_tpu.utils import metrics as ref_metrics
from serenedb_tpu.utils.config import REGISTRY as REF_SETTINGS
from serenedb_tpu_torch.device import LAUNCHES, UPLOADS
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.exec.device_pipeline import DEVICE_CACHE
from serenedb_tpu_torch.obs import device as obs_device
from serenedb_tpu_torch.search import posting_pool
from serenedb_tpu_torch.search.analysis import get_analyzer
from serenedb_tpu_torch.search.batcher import SearchBatcher
from serenedb_tpu_torch.ops import bm25_kernels as kern
from serenedb_tpu_torch.ops import pool_kernels as pool_kernels_mod
from serenedb_tpu_torch.search.posting_pool import POOL
from serenedb_tpu_torch.search.query import parse_query
from serenedb_tpu_torch.search.searcher import MultiSearcher, SegmentSearcher
from serenedb_tpu_torch.search.segment import build_field_index
from serenedb_tpu_torch.utils import faults, metrics
from serenedb_tpu_torch.utils.config import REGISTRY as SETTINGS

RTOL, ATOL = 1e-5, 1e-6
WORDS = ("apple banana cherry quick brown fox jumps over lazy dog search "
         "engine database index query term").split()


class _both:
    """Set a GLOBAL setting in both packages for the scope."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.old = [(reg, n, reg.get_global(n))
                    for reg in (REF_SETTINGS, SETTINGS)
                    for n in self.values]
        for reg, n, _ in self.old:
            reg.set_global(n, self.values[n])

    def __exit__(self, *exc):
        for reg, n, v in self.old:
            reg.set_global(n, v)
        return False


@pytest.fixture(autouse=True)
def _ragged_regime(monkeypatch):
    """The packed regime in both packages, and empty pools around every
    test."""
    monkeypatch.setattr(ref_bm25, "DENSE_HBM_BUDGET", 0)
    monkeypatch.setattr(port_bm25, "DENSE_HBM_BUDGET", 0)
    REF_POOL.clear()
    POOL.clear()
    yield
    REF_POOL.clear()
    POOL.clear()


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(3, 24)))
            for _ in range(n)]


def _segs(n=700, seed=11, docs=None):
    """One corpus as a reference and a port SegmentSearcher."""
    docs = _texts(n, seed) if docs is None else docs
    ra, pa = ref_analyzer("text"), get_analyzer("text")
    return (RefSeg(ref_build(docs, ra), ra, len(docs)),
            SegmentSearcher(build_field_index(docs, pa), pa, len(docs),
                            device="cpu"), ra, pa)


def _bits_equal(a, b):
    return (np.array_equal(a[0].view(np.uint32), b[0].view(np.uint32))
            and np.array_equal(a[1], b[1]))


def _close(got, want, what):
    """Scores to the search rule; ids equal, but where scores tie within
    it (an ulp can order two such docs either way)."""
    assert len(got[1]) == len(want[1]), what
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL,
                               err_msg=str(what))
    ws = want[0].astype(np.float64)
    for j in np.flatnonzero(got[1] != want[1]):
        assert np.isclose(ws, ws[j], rtol=RTOL, atol=ATOL).sum() > 1, \
            (what, j)


QS = ["apple | dog", "banana | fox | dog", "cherry | term | engine",
      "apple"]


@pytest.mark.parametrize("k", [3, 10, 5000])
@pytest.mark.parametrize("pool", [True, False])
def test_ragged_batch_equals_reference(k, pool):
    """The port's ragged batch against the reference's, pool on and off,
    cold and warm."""
    ref, port, ra, pa = _segs()
    with _both(serene_posting_pool=pool):
        for rep in range(2):
            want = ref.topk_batch([ref_parse(q, ra) for q in QS], k,
                                  ragged=True)
            got = port.topk_batch([parse_query(q, pa) for q in QS], k,
                                  ragged=True)
            for i, q in enumerate(QS):
                _close(got[i], want[i], (k, pool, rep, q))


STARVED = ["apple | banana | cherry | quick | brown | fox",
           "dog | fox | lazy | brown | jumps | over",
           "search | engine | database | index | query | term",
           "apple | dog",
           "query | term | jumps | over | lazy | cherry"]


@pytest.mark.parametrize("pages", [8, 16])
def test_starved_budget_partial_residency_equals_reference(pages):
    """A starved page budget: partial residency and LRU eviction
    mid-stream, in both packages; the port equals the reference query by
    query and is bit-equal to its own pool-off path, and it counts the
    same hits, misses, evictions and partial queries as the reference."""
    ref, port, ra, pa = _segs(n=3000, seed=5)
    with _both(serene_posting_pool=False):
        oracle = [port.topk_batch([parse_query(q, pa)], 5000,
                                  ragged=True)[0] for q in STARVED]
    names = ("POSTING_POOL_HITS", "POSTING_POOL_MISSES",
             "POSTING_POOL_EVICTIONS", "POSTING_POOL_PARTIAL",
             "POSTING_POOL_DEVICE_QUERIES")
    with _both(serene_posting_pages=pages):
        r0 = [getattr(ref_metrics, n).value for n in names]
        p0 = [getattr(metrics, n).value for n in names]
        for rep in range(2):
            for i, q in enumerate(STARVED):
                want = ref.topk_batch([ref_parse(q, ra)], 5000,
                                      ragged=True)[0]
                got = port.topk_batch([parse_query(q, pa)], 5000,
                                      ragged=True)[0]
                _close(got, want, (pages, rep, q))
                assert _bits_equal(got, oracle[i]), (pages, rep, q)
        rd = [getattr(ref_metrics, n).value - v for n, v in zip(names, r0)]
        pd = [getattr(metrics, n).value - v for n, v in zip(names, p0)]
        assert pd == rd
        assert pd[2] > 0                   # evictions
        assert (pd[3] > 0) == (pages == 8)  # partial queries at 8 pages
        assert POOL.stats()["pages_used"] <= pages


def test_two_segments_equal_reference():
    """Global idf/avgdl over two segments: the merged ragged results of
    both packages agree, and the port's equal its own solo dispatches."""
    ra, pa = ref_analyzer("text"), get_analyzer("text")
    rm, pm = RefMulti(ra), MultiSearcher(pa)
    base = 0
    for si in range(2):
        docs = _texts(300 + 40 * si, 20 + si)
        rm.add_segment(RefSeg(ref_build(docs, ra), ra, len(docs)), base)
        pm.add_segment(SegmentSearcher(build_field_index(docs, pa), pa,
                                       len(docs), device="cpu"), base)
        base += len(docs)
    qs = ["apple", "apple | dog", "cherry | term", "banana | fox | dog"]
    for pool in (True, False):
        with _both(serene_posting_pool=pool):
            for k in (10, 5000):
                want = rm.topk_batch([ref_parse(q, ra) for q in qs], k,
                                     ragged=True)
                got = pm.topk_batch([parse_query(q, pa) for q in qs], k,
                                    ragged=True)
                solo = [pm.topk_batch([parse_query(q, pa)], k)[0]
                        for q in qs]
                for i, q in enumerate(qs):
                    _close(got[i], want[i], (pool, k, q))
                    assert _bits_equal(got[i], solo[i]), (pool, k, q)


def test_port_routes_are_bit_identical():
    """Plane (`ragged=False`), host ragged (`contrib_flat`), pool full
    and pool partial give the same bits per query, tie order included;
    each route launches what it should."""
    docs = _texts(3000, 5)
    docs[::13] = ["apple banana apple"] * len(docs[::13])     # ties
    _, port, _, pa = _segs(docs=docs)
    nodes = [parse_query(q, pa) for q in STARVED + QS]
    LAUNCHES.reset()
    plane = [port.topk_batch([n], 5000)[0] for n in nodes]
    assert LAUNCHES.get("bm25_accumulate.plain") > 0
    with _both(serene_posting_pool=False):
        LAUNCHES.reset()
        host = port.topk_batch(nodes, 5000, ragged=True)
        assert LAUNCHES.get("contrib_flat.plain") == 1
        assert LAUNCHES.get("pool_score.plain") == 0
    LAUNCHES.reset()
    full = port.topk_batch(nodes, 5000, ragged=True)
    assert LAUNCHES.get("pool_score.plain") == 1
    assert LAUNCHES.get("contrib_flat.plain") == 0
    POOL.clear()
    with _both(serene_posting_pages=8):
        p0 = metrics.POSTING_POOL_PARTIAL.value
        part = [port.topk_batch([n], 5000, ragged=True)[0] for n in nodes]
        assert metrics.POSTING_POOL_PARTIAL.value > p0
    for i in range(len(nodes)):
        for route in (host, full, part):
            assert _bits_equal(route[i], plane[i]), i


def test_ragged_admission_follows_the_card_cost_model():
    """`ragged_admits`: with the pool on, every query up to
    RAGGED_ENTRY_CAP; with it off, the host route only while a query's
    postings cost less than its share of the planes, a share that shrinks
    with the batch; a declined query keeps the plane route's bits."""
    _, port, _, pa = _segs(n=1200)
    S = SegmentSearcher
    cap1 = (S.PLANE_BASE_MS + S.PLANE_MS_PER_QUERY - S.HOST_BASE_MS) / \
        S.HOST_MS_PER_ENTRY
    with _both(serene_posting_pool=True):
        assert port.ragged_admits(S.RAGGED_ENTRY_CAP, 64)
        assert not port.ragged_admits(S.RAGGED_ENTRY_CAP + 1, 1)
    with _both(serene_posting_pool=False):
        assert port.ragged_admits(int(cap1), 1)
        assert not port.ragged_admits(int(cap1) + 1, 1)
        caps = [max(e for e in range(0, 20_000, 50)
                    if port.ragged_admits(e, b)) for b in (1, 8, 64)]
        assert caps[0] > caps[1] > caps[2] > 0
        nodes = [parse_query(q, pa) for q in QS]
        plane = port.topk_batch(nodes, 10)
        LAUNCHES.reset()
        port.ragged_admits = lambda e, b: False
        try:
            declined = port.topk_batch(nodes, 10, ragged=True)
        finally:
            del port.ragged_admits
        assert LAUNCHES.get("contrib_flat.plain") == 0
        assert all(_bits_equal(a, b) for a, b in zip(declined, plane))


def test_ragged_memo_charge_clears_past_cap(monkeypatch):
    """Crossing RAGGED_MEMO_BYTES_CAP clears every ragged memo — plan
    slices, candidate tables, plain-store slices and the pool's batch
    descriptor memo — then restarts the byte count."""
    monkeypatch.setattr(SegmentSearcher, "RAGGED_MEMO_BYTES_CAP", 100)
    plan = types.SimpleNamespace(_ragged_slices={"x": 1},
                                 _ragged_accum=("c", ["i"]))
    store = types.SimpleNamespace(
        _plan_cache={"k": plan, "none": None},
        _ragged_plain={(2, 7): ("d", "t", None)},
        _pool_batch_memo={"mk": {"si": 1}})
    SegmentSearcher._ragged_memo_charge(store, 60)
    assert store._ragged_memo_bytes == 60
    assert hasattr(plan, "_ragged_accum")
    SegmentSearcher._ragged_memo_charge(store, 60)
    assert store._ragged_memo_bytes == 60
    assert not hasattr(plan, "_ragged_accum")
    assert not hasattr(plan, "_ragged_slices")
    assert store._ragged_plain == {}
    assert store._pool_batch_memo == {}


def test_memo_stays_bounded_in_flight(monkeypatch):
    """Under a small cap, a stream of novel query shapes keeps the
    accounted memo bytes at or below the cap and the batch memo at or
    below its entry cap."""
    monkeypatch.setattr(SegmentSearcher, "RAGGED_MEMO_BYTES_CAP", 32 << 10)
    _, port, _, pa = _segs()
    terms = ["apple", "banana", "cherry", "dog", "fox", "term", "engine",
             "lazy", "quick", "brown", "search", "index"]
    store = port._device_store()
    for i in range(len(terms) - 1):
        port.topk_batch([parse_query(f"{terms[i]} | {terms[i + 1]}", pa)],
                        5000, ragged=True)
        assert getattr(store, "_ragged_memo_bytes", 0) <= 32 << 10
        assert len(getattr(store, "_pool_batch_memo", {})) <= \
            posting_pool._BATCH_MEMO_CAP


def test_warm_repeat_uploads_no_posting_bytes_and_launches_once():
    """A warm repeat of a coalesced batch uploads 0 bytes and makes one
    `pool_score` launch, and returns the cold bits."""
    _, port, _, pa = _segs()
    nodes = [parse_query(q, pa) for q in QS[:3]]
    out1 = port.topk_batch(nodes, 5000, ragged=True)   # faults pages in
    port.topk_batch(nodes, 5000, ragged=True)          # warms the memo
    LAUNCHES.reset()
    b0 = UPLOADS.get("bytes")
    out3 = port.topk_batch(nodes, 5000, ragged=True)
    assert UPLOADS.get("bytes") == b0, "warm repeat uploaded bytes"
    assert LAUNCHES.snapshot() == {"pool_score.plain": 1}
    for i in range(len(nodes)):
        assert _bits_equal(out3[i], out1[i]), i


class _PoisonWrap:
    """Real scoring, except batches holding the poison node raise."""

    def __init__(self, seg, poison):
        self.seg, self.poison = seg, poison

    def topk_batch(self, nodes, k, scorer="bm25", mesh_n=0, ragged=False):
        if any(n is self.poison for n in nodes):
            raise ValueError("poisoned query")
        return self.seg.topk_batch(nodes, k, scorer, mesh_n=mesh_n,
                                   ragged=ragged)

    def topk(self, node, k, scorer="bm25", mesh_n=0):
        return self.topk_batch([node], k, scorer, mesh_n)[0]

    def probe_topk(self, node, k, scorer="bm25", mesh_n=0):
        return None


def _race(batcher, searcher, nodes, results, errors):
    bar = threading.Barrier(len(nodes))

    def run(node, slot):
        bar.wait(timeout=30)
        try:
            results[slot] = batcher.submit(searcher, node, 5000, "bm25", 0,
                                           0.5, 128)
        except ValueError as e:
            errors[slot] = e
    ts = [threading.Thread(target=run, args=(n, i))
          for i, n in enumerate(nodes)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]


def test_poisoned_batch_member_fails_only_its_caller():
    _, port, _, pa = _segs()
    good = [parse_query(q, pa) for q in QS[:2]]
    poison = parse_query("cherry | term", pa)
    ref = [port.topk_batch([n], 5000, ragged=True)[0] for n in good]
    results, errors = {}, {}
    _race(SearchBatcher(), _PoisonWrap(port, poison), good + [poison],
          results, errors)
    assert set(errors) == {2}
    for i in range(2):
        assert _bits_equal(results[i][0], ref[i]), i


def test_pool_dispatch_fault_retries_serially_bit_exact():
    """An armed `posting_pool_dispatch` fault fails the coalesced
    dispatch; the batcher's serial retry (the plane path) still hands
    every caller the pool-off bits."""
    _, port, _, pa = _segs()
    nodes = [parse_query(q, pa) for q in QS[:3]]
    with _both(serene_posting_pool=False):
        ref = [port.topk_batch([n], 5000, ragged=True)[0] for n in nodes]
    faults.arm_from_spec("posting_pool_dispatch")
    try:
        results, errors = {}, {}
        _race(SearchBatcher(), port, nodes, results, errors)
    finally:
        faults.clear()
    assert not errors and len(results) == len(nodes)
    for i in range(len(nodes)):
        assert _bits_equal(results[i][0], ref[i]), i


def _make_dbs(n=600, seed=7):
    rng = np.random.default_rng(seed)
    vals = []
    for i in range(n):
        if i % 97 == 0:
            vals.append(f"({i}, NULL)")
        elif i % 13 == 0:
            vals.append(f"({i}, 'apple banana apple')")
        else:
            body = " ".join(rng.choice(WORDS, rng.integers(3, 24)))
            vals.append(f"({i}, '{body}')")
    conns = []
    for db in (RefDatabase(), Database(device="cpu")):
        c = db.connect()
        c.execute("CREATE TABLE docs (id INT, body TEXT)")
        c.execute("INSERT INTO docs VALUES " + ", ".join(vals))
        c.execute("CREATE INDEX ON docs USING inverted (body)")
        c.execute("SET serene_result_cache = off")
        conns.append(c)
    return conns


#: tests/test_posting_pool.py's QUERIES (which hold test_search_batch's)
SQL_QUERIES = [
    ("SELECT id, bm25(body) AS s FROM docs WHERE body @@ 'apple' "
     "ORDER BY s DESC LIMIT 10"),
    ("SELECT id, bm25(body) AS s FROM docs WHERE body @@ 'apple & banana' "
     "ORDER BY s DESC LIMIT 10"),
    ("SELECT id, bm25(body) AS s FROM docs WHERE body ## 'quick brown' "
     "ORDER BY s DESC LIMIT 10"),
    ("SELECT id, bm25(body) AS s FROM docs WHERE body @@ 'apple | dog' "
     "AND id < 300 ORDER BY s DESC, id LIMIT 10"),
    ("SELECT id, bm25(body) AS s FROM docs WHERE body @@ 'banana' "
     "ORDER BY s DESC LIMIT 10"),
    ("SELECT id FROM docs WHERE body @@ 'zzzznothing' "
     "ORDER BY bm25(body) DESC LIMIT 5"),
    ("SELECT id, bm25(body) AS s FROM docs WHERE body @@ 'quick & fox' "
     "ORDER BY s DESC LIMIT 5000"),
    ("SELECT id, tfidf(body) AS s FROM docs WHERE body @@ 'cherry | dog' "
     "ORDER BY s DESC LIMIT 10"),
    ("SELECT id, bm25(body) AS s FROM docs WHERE body @@ 'apple | dog' "
     "ORDER BY s DESC, id LIMIT 5000"),
    ("SELECT id, bm25(body) AS s FROM docs "
     "WHERE body @@ 'banana | fox | engine' ORDER BY s DESC, id LIMIT 5000"),
]


def _same_rows(got, want, q):
    assert len(got) == len(want), q
    if not got or len(got[0]) == 1:
        assert got == want, q
        return
    assert [r[0] for r in got] == [r[0] for r in want], q
    np.testing.assert_allclose([r[-1] for r in got], [r[-1] for r in want],
                               rtol=RTOL, atol=ATOL, err_msg=q)


@pytest.fixture(scope="module")
def dbs():
    return _make_dbs()


@pytest.mark.parametrize("pool", [True, False])
def test_sql_queries_equal_reference(dbs, pool):
    """The reference suite's statements through both packages' SQL, pool
    on and off; the port's pool engages when on."""
    ref, port = dbs
    with _both(serene_posting_pool=pool):
        d0 = metrics.POSTING_POOL_DEVICE_QUERIES.value
        for q in SQL_QUERIES:
            _same_rows(port.execute(q).rows(), ref.execute(q).rows(), q)
        assert (metrics.POSTING_POOL_DEVICE_QUERIES.value > d0) == pool


def test_sdb_posting_pool_rows_match_reference(dbs):
    """After the same statement, sdb_posting_pool's rows agree in table,
    terms, pages, bytes and hits, and the stats section carries the
    pool."""
    q = ("SELECT id, bm25(body) AS s FROM docs "
         "WHERE body @@ 'apple | dog' ORDER BY s DESC, id LIMIT 5000")
    sel = ("SELECT table_name, terms, pages, bytes, hits "
           "FROM sdb_posting_pool")
    ref, port = dbs
    for _ in range(2):
        ref.execute(q)
        port.execute(q)
    rows = port.execute(sel).rows()
    assert rows and rows == ref.execute(sel).rows()
    assert rows[0][0] == "docs" and rows[0][1] > 0 and rows[0][4] > 0
    st = obs_device.stats_section()["posting_pool"]
    assert st["pages_used"] > 0 and st["resident_terms"] > 0
    assert sum(POOL.device_bytes().values()) == st["pages"] * 8192
    with _both(serene_posting_pool=False):
        POOL.clear()
        port.execute(q)
        assert port.execute("SELECT count(*) FROM sdb_posting_pool").rows() \
            == [(0,)]


def test_column_cache_trades_its_budget_with_the_pools():
    """The device column cache's cap is the envelope less the pools' live
    pages (floor a quarter), and over its cap it offers the eviction to
    a colder pool tail first: with the same cap and the same pool
    residency, the port shows the reference's caps and evictions."""
    ref, port, ra, pa = _segs(n=3000, seed=5)
    REF_CACHE.clear()
    DEVICE_CACHE.clear()
    try:
        with _both(serene_device_cache_mb=1, serene_device_cache_trade=True):
            ref.topk_batch([ref_parse(q, ra) for q in STARVED], 5000,
                           ragged=True)
            port.topk_batch([parse_query(q, pa) for q in STARVED], 5000,
                            ragged=True)
            assert POOL.live_bytes() == REF_POOL.live_bytes() > 0
            assert DEVICE_CACHE.stats()["cap_bytes"] == \
                REF_CACHE.stats()["cap_bytes"] == \
                (1 << 20) - POOL.live_bytes()
            obs = []
            for step in range(6):
                if step == 4:
                    # the pools warmer than the cache's tail: the cache
                    # evicts its own
                    time.sleep(0.01)
                    ref.topk_batch([ref_parse(STARVED[0], ra)], 5000,
                                   ragged=True)
                    port.topk_batch([parse_query(STARVED[0], pa)], 5000,
                                    ragged=True)
                row = []
                for cache, pool, m in ((REF_CACHE, REF_POOL, ref_metrics),
                                       (DEVICE_CACHE, POOL, metrics)):
                    e0 = m.DEVICE_CACHE_EVICTIONS.value
                    v0 = m.POSTING_POOL_EVICTIONS.value
                    cache.put(((900, 1, 0), f"c{step}", "arr", None),
                              np.zeros(1, np.int8), 300 << 10)
                    st = cache.stats()
                    row.append((st["entries"], st["bytes"], st["cap_bytes"],
                                pool.live_bytes(),
                                m.DEVICE_CACHE_EVICTIONS.value - e0,
                                m.POSTING_POOL_EVICTIONS.value - v0))
                assert row[1] == row[0], (step, row)
                obs.append(row[1])
            assert any(r[5] for r in obs), obs     # the pool shed pages
            assert any(r[4] for r in obs), obs     # the cache shed its own
            assert obs[-1][2] == max(1 << 18, (1 << 20) - obs[-1][3])
    finally:
        REF_CACHE.clear()
        DEVICE_CACHE.clear()


@pytest.mark.parametrize("cp,kk,regime", [
    (1, 0, "row"), (1, 1, "row"), (2048, 10, "row"), (2049, 10, "row"),
    (19_048, 10, "row"), (19_048, 0, "row"), (19_048, 32, "row"),
    (19_048, 33, "large"), (19_048, 1000, "large"), (19_048, 8192, "large"),
    (pool_kernels_mod.POOL_ROW_LANES, 10, "row"),
    (pool_kernels_mod.POOL_ROW_LANES, 32, "row"),
    (pool_kernels_mod.POOL_ROW_LANES + 1, 10, "large"),
    (pool_kernels_mod.POOL_ROW_LANES, 0, "row"),
    (pool_kernels_mod.POOL_ROW_LANES + 1, 0, "large"),
    (2_000_000, 10, "large")])
def test_pool_regime_at_its_edges(cp, kk, regime):
    """ROW while kk <= 32 and cp <= POOL_ROW_LANES (both caps from card
    timings: csrc/pool.cu asserts that a block then holds a whole row);
    LARGE past either."""
    assert pool_kernels_mod.POOL_ROW_KK == 32
    assert pool_kernels_mod.pool_regime(cp, kk) == regime


def _pool_case(seed, sizes, cp, tp):
    """A batch descriptor of len(sizes) queries over a random region (rows
    whose size is 0 are dead), small tf and norm ranges for ties."""
    rng = np.random.default_rng(seed)
    pages = 8
    docs_pg = rng.integers(0, 5000, (pages, 1024)).astype(np.int32)
    tfs_pg = rng.integers(1, 4, (pages, 1024)).astype(np.int32)
    norms = rng.integers(5, 9, 5000).astype(np.int32)
    qp = len(sizes)
    cand = np.full((qp, cp), pool_kernels_mod.PAD_DOC, np.int32)
    slices = []
    for q, n in enumerate(sizes):
        cand[q, :n] = np.sort(rng.choice(1 << 30, n, replace=False))
        slices.append([rng.choice(n, int(rng.integers(1, n + 1)),
                                  replace=False) for _ in range(tp)]
                      if n else [])
    ep = max(1, max(sum(len(x) for x in sl) for sl in slices))
    si = np.zeros((qp, ep), np.int32)
    w = np.zeros((qp, ep), np.float32)
    lane = np.zeros((qp, ep), np.int32)
    soff = np.zeros((qp, tp + 1), np.int32)
    smax = [0] * tp
    for q, sl in enumerate(slices):
        pos = 0
        for t, lanes in enumerate(sl):
            m = len(lanes)
            si[q, pos:pos + m] = rng.choice(pages * 1024, m, replace=False)
            w[q, pos:pos + m] = rng.choice([1.5, 2.25])
            lane[q, pos:pos + m] = lanes
            soff[q, t] = pos
            smax[t] = max(smax[t], m)
            pos += m
        soff[q, len(sl):] = pos
    return (docs_pg, tfs_pg, norms, si, w, lane, soff), smax, cand, \
        np.int32(sizes)


@pytest.mark.parametrize("scorer", ["bm25", "tfidf"])
@pytest.mark.parametrize("sizes,cp,kk", [
    ([40, 7, 0, 40], 40, 10), ([40, 7, 0, 40], 40, 32),
    ([300, 1, 2], 300, 33), ([300, 1, 2], 300, 0), ([1], 1, 1),
    ([0, 0], 16, 4)])
def test_pool_score_plain_follows_the_host_add_order_and_tie_order(
        scorer, sizes, cp, kk):
    """The plain version, which the kernels equal bit for bit, is each
    lane's contributions added in slice order from +0.0 (the host ragged
    path's `acc[ix] += c`), then each row's kk best live lanes by (score
    desc, doc asc) with (-inf, PAD_DOC) pads, written out as loops."""
    import torch
    pk = pool_kernels_mod
    arrays, smax, cand, nc = _pool_case(len(sizes) + kk, sizes, cp, 3)
    docs_pg, tfs_pg, norms, si, w, lane, soff = arrays
    t = [torch.from_numpy(a) for a in arrays]
    args = (*t, smax, cp, 1.2, 0.75, 6.5, scorer)
    got = pk.pool_score(*args, torch.from_numpy(cand), torch.from_numpy(nc),
                        kk) if kk else pk.pool_score(*args)
    slot = si.reshape(-1).astype(np.int64)
    c = kern.contrib_plain(
        scorer, torch.from_numpy(tfs_pg.reshape(-1)[slot]).float(),
        torch.from_numpy(norms[docs_pg.reshape(-1)[slot]]).float(),
        torch.from_numpy(w.reshape(-1)), 1.2, 0.75,
        kern._avg(6.5)).numpy().reshape(si.shape)
    acc = np.zeros((len(sizes), cp), np.float32)
    for q in range(len(sizes)):
        for s in range(soff.shape[1] - 1):
            for e in range(soff[q, s], soff[q, s + 1]):
                acc[q, lane[q, e]] = np.float32(acc[q, lane[q, e]] +
                                                c[q, e])
    if not kk:
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      acc.view(np.int32))
        return
    for q in range(len(sizes)):
        order = sorted(range(nc[q]), key=lambda i: (-acc[q, i], cand[q, i]))
        top = order[:kk]
        want_v = np.full(kk, -np.inf, np.float32)
        want_d = np.full(kk, pk.PAD_DOC, np.int32)
        want_v[:len(top)] = acc[q, top] + np.float32(0.0)   # -0.0 as +0.0
        want_d[:len(top)] = cand[q, top]
        np.testing.assert_array_equal(got[0][q].numpy().view(np.int32),
                                      want_v.view(np.int32))
        np.testing.assert_array_equal(got[1][q].numpy(), want_d)
