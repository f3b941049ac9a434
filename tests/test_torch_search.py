"""The port's search slice against the JAX package's, on the CPU.

One corpus, made from a numpy seed, is indexed by the reference; its
FieldIndex crosses to the port as numpy arrays (`carry.py`), and the same
queries go through both packages' `SegmentSearcher.topk_batch` — the dense
regime, and the packed regime forced by a zero dense budget in both. The
port runs its plain PyTorch versions on CPU tensors.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from serenedb_tpu.ops import bm25 as ref_bm25
from serenedb_tpu.search.analysis import get_analyzer as ref_analyzer
from serenedb_tpu.search.query import parse_query as ref_parse
from serenedb_tpu.search.searcher import SegmentSearcher as RefSearcher
from serenedb_tpu.search.segment import build_field_index as ref_build
from serenedb_tpu_torch.carry import field_index_from_reference
from serenedb_tpu_torch.device import LAUNCHES, resolve_device
from serenedb_tpu_torch.ops import bm25 as port_bm25
from serenedb_tpu_torch.parallel import virtual_devices
from serenedb_tpu_torch.search.analysis import get_analyzer
from serenedb_tpu_torch.search.query import parse_query
from serenedb_tpu_torch.search.searcher import SegmentSearcher
from serenedb_tpu_torch.search.segment import build_field_index

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FI_FIELDS = ("terms", "doc_freq", "offsets", "post_docs", "post_tfs",
             "pos_offsets", "positions", "norms", "block_max_tf",
             "block_offsets")

QUERIES = ["t0", "t1 | t2", "t3 & t4", "t5 | t30 | t0", '"t1 t2"', "t9",
           "t1*", "t2 & !t3", "t7 & t8 & t9", "t50", "t0 & t1",
           "(t1 | t6) & t2", "t33 | t44", "nosuchterm", "t4 & nosuchterm"]


def _corpus(n_docs=3000, vocab=60, seed=3):
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(vocab)]
    lens = rng.integers(3, 20, n_docs)
    z = rng.zipf(1.3, size=int(lens.sum())) % vocab
    docs, pos = [], 0
    for ln in lens:
        docs.append(" ".join(words[x] for x in z[pos:pos + ln]))
        pos += ln
    return docs


def _fi_arrays(fi):
    out = {name: getattr(fi, name) for name in FI_FIELDS}
    out["total_tokens"] = fi.total_tokens
    return out


@pytest.fixture(scope="module")
def searchers():
    docs = _corpus()
    ran = ref_analyzer("simple")
    rfi = ref_build(docs, ran)
    pfi = field_index_from_reference(_fi_arrays(rfi))
    pan = get_analyzer("simple")
    return (RefSearcher(rfi, ran, len(docs)),
            SegmentSearcher(pfi, pan, len(docs), device="cpu"), ran, pan)


def _compare(ref_out, port_out, queries):
    assert len(ref_out) == len(port_out)
    for q, (rs, rd), (ps, pd) in zip(queries, ref_out, port_out):
        assert len(rs) == len(ps), q
        np.testing.assert_allclose(ps, rs, rtol=RTOL, atol=ATOL, err_msg=q)
        for j in np.flatnonzero(rd != pd):
            # ids may differ only where scores tie within the tolerance
            assert np.isclose(rs, rs[j], rtol=RTOL, atol=ATOL).sum() > 1, q


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("regime", ["dense", "packed"])
def test_topk_batch_matches_reference(searchers, monkeypatch, regime, k):
    rs, ps, ran, pan = searchers
    if regime == "packed":
        monkeypatch.setattr(ref_bm25, "DENSE_HBM_BUDGET", 0)
        monkeypatch.setattr(port_bm25, "DENSE_HBM_BUDGET", 0)
    store = ps._device_store()
    fits = port_bm25.dense_fits(store.ndocs_pad, len(ps.index.doc_freq))
    assert fits == (regime == "dense")
    before = LAUNCHES.snapshot()
    ref_out = rs.topk_batch([ref_parse(q, ran) for q in QUERIES], k)
    port_out = ps.topk_batch([parse_query(q, pan) for q in QUERIES], k)
    after = LAUNCHES.snapshot()
    # the device half ran, through the plain versions (CPU tensors)
    kernels = ("build_dense", "topk_rows") if regime == "dense" else \
        ("bm25_accumulate", "topk_rows")
    for name in kernels[1:]:
        assert after.get(name + ".plain", 0) > before.get(name + ".plain", 0)
    assert not any(n in after for n in ("build_dense", "bm25_accumulate",
                                        "topk_rows"))
    _compare(ref_out, port_out, QUERIES)


@pytest.mark.parametrize("scorer", ["tfidf", "lm_dirichlet",
                                    "jelinek_mercer", "dfi"])
def test_topk_batch_scorers_match_reference(searchers, monkeypatch, scorer):
    rs, ps, ran, pan = searchers
    monkeypatch.setattr(ref_bm25, "DENSE_HBM_BUDGET", 0)
    monkeypatch.setattr(port_bm25, "DENSE_HBM_BUDGET", 0)
    qs = QUERIES[:9]
    ref_out = rs.topk_batch([ref_parse(q, ran) for q in qs], 10, scorer)
    port_out = ps.topk_batch([parse_query(q, pan) for q in qs], 10, scorer)
    _compare(ref_out, port_out, qs)


def test_dense_store_builds_through_plain_build_dense(searchers):
    rs, ps, ran, pan = searchers
    ps._dense_cache = {}
    before = LAUNCHES.get("build_dense.plain")
    ps.topk_batch([parse_query("t0 | t1", pan)], 10)
    assert LAUNCHES.get("build_dense.plain") == before + 1


def test_acc_entry_cap_splits_the_batch_like_the_reference(searchers,
                                                           monkeypatch):
    rs, ps, ran, pan = searchers
    monkeypatch.setattr(ref_bm25, "DENSE_HBM_BUDGET", 0)
    monkeypatch.setattr(port_bm25, "DENSE_HBM_BUDGET", 0)
    nd_pad = ps._device_store().ndocs_pad
    monkeypatch.setattr(RefSearcher, "ACC_ENTRY_CAP", 3 * nd_pad)
    monkeypatch.setattr(SegmentSearcher, "ACC_ENTRY_CAP", 3 * nd_pad)
    ref_out = rs.topk_batch([ref_parse(q, ran) for q in QUERIES], 10)
    port_out = ps.topk_batch([parse_query(q, pan) for q in QUERIES], 10)
    _compare(ref_out, port_out, QUERIES)


def test_cpu_topk_wand_and_filters_match_reference(searchers):
    rs, ps, ran, pan = searchers
    for q in QUERIES:
        rn, pn = ref_parse(q, ran), parse_query(q, pan)
        np.testing.assert_array_equal(ps.eval_filter(pn), rs.eval_filter(rn))
        r_shape, p_shape = rs._query_shape(rn), ps._query_shape(pn)
        assert r_shape == p_shape
        tids, req = p_shape[0], p_shape[1]
        if not tids:
            continue
        (a, b), (c, d) = rs.cpu_topk_wand(tids, 10, require_all=req), \
            ps.cpu_topk_wand(tids, 10, require_all=req)
        np.testing.assert_array_equal(c, a)
        np.testing.assert_array_equal(d, b)


def test_fuzzy_and_regex_queries_match_reference(searchers):
    rs, ps, ran, pan = searchers
    qs = ["t1~1", "/t[12]./", "t2*"]
    ref_out = rs.topk_batch([ref_parse(q, ran) for q in qs], 10)
    port_out = ps.topk_batch([parse_query(q, pan) for q in qs], 10)
    _compare(ref_out, port_out, qs)


@pytest.mark.parametrize("analyzer", ["simple", "text"])
def test_build_field_index_equals_reference(analyzer):
    """The reference takes its native C++ indexer for "simple" over ASCII
    text and its Python path for "text"; the port always takes the Python
    path, which must give the same arrays."""
    docs = _corpus(n_docs=500, seed=8) + ["", None, "T1 t2 t2 T3"]
    rfi = ref_build(docs, ref_analyzer(analyzer))
    pfi = build_field_index(docs, get_analyzer(analyzer))
    for name in FI_FIELDS:
        r, p = getattr(rfi, name), getattr(pfi, name)
        if name == "terms":
            assert [str(t) for t in r] == [str(t) for t in p]
        else:
            assert r.dtype == p.dtype, name
            np.testing.assert_array_equal(p, r, err_msg=name)
    assert pfi.total_tokens == rfi.total_tokens


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import serenedb_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "serenedb_tpu_torch.__path__, 'serenedb_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'serenedb_tpu' or "
        "m.startswith('serenedb_tpu.') or "
        "(m.startswith('jax') and sys.modules[m] is not None)]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fi = build_field_index(["a b", "b c"], get_analyzer("simple"))
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentSearcher(fi, get_analyzer("simple"), 2).topk_batch(
            [parse_query("a", get_analyzer("simple"))], 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_embedding_analyzers_say_they_are_not_ported():
    """The model-backed analyzers (tests/test_analysis.py:237-290 and
    sqllogic's analyzer_model_backed.test): `CREATE TEXT SEARCH
    DICTIONARY ... (template = 'classification' | 'nearest_neighbors')`,
    an index over each, and the tokens and rows they give, equal to the
    reference's; the refusals of a template without labels or vocabulary
    too."""
    from serenedb_tpu import errors as rerrors
    from serenedb_tpu.engine import Database as RDatabase
    from serenedb_tpu.search import analysis as ranalysis
    from serenedb_tpu_torch import errors
    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.search import analysis
    setup = [
        "CREATE TEXT SEARCH DICTIONARY topic (template = 'classification',"
        " labels = 'sports: football basketball goalkeeper; tech: "
        "compiler software kernel')",
        "CREATE TEXT SEARCH DICTIONARY topic2 (template = "
        "'classification', top = 2, labels = 'sports: football; tech: "
        "compiler')",
        "CREATE TEXT SEARCH DICTIONARY fixup (template = "
        "'nearest_neighbors', vocab = 'football basketball compiler "
        "software kernel', top = 1)",
        "CREATE TABLE posts (id INT, body TEXT)",
        "INSERT INTO posts VALUES (1, 'great football match last night'), "
        "(2, 'compiler bug in the kernel'), (3, 'basketball finals'), "
        "(4, 'new software release')",
        "CREATE INDEX ON posts USING inverted (body topic)",
        "CREATE TABLE raw (id INT, body TEXT)",
        "INSERT INTO raw VALUES (1, 'footbal compilr'), (2, 'basketbal')",
        "CREATE INDEX ON raw USING inverted (body fixup)"]
    queries = ["SELECT id FROM posts WHERE body ## 'sports' ORDER BY id",
               "SELECT id FROM posts WHERE body ## 'tech' ORDER BY id",
               "SELECT id FROM raw WHERE body ## 'football' ORDER BY id",
               "SELECT id FROM raw WHERE body ## 'basketball' ORDER BY id"]
    texts = ["football match", "compiler bug", "sports", "", "footbal",
             "compilr kernel", "basketbal"]
    rc, pc = RDatabase().connect(), Database(device="cpu").connect()
    try:
        for sql in setup:
            rc.execute(sql)
            pc.execute(sql)
        for q in queries:
            assert pc.execute(q).rows() == rc.execute(q).rows(), q
        for name in ("topic", "topic2", "fixup"):
            ra, pa = ranalysis.get_analyzer(name), analysis.get_analyzer(name)
            assert type(pa).__name__ == type(ra).__name__
            for t in texts:
                assert [(x.term, x.position) for x in pa.tokenize(t)] == \
                    [(x.term, x.position) for x in ra.tokenize(t)], (name, t)
    finally:
        for c in (rc, pc):
            for sql in ("DROP TABLE posts", "DROP TABLE raw",
                        "DROP TEXT SEARCH DICTIONARY topic",
                        "DROP TEXT SEARCH DICTIONARY topic2",
                        "DROP TEXT SEARCH DICTIONARY fixup"):
                c.execute(sql)
    with pytest.raises(errors.SqlError) as pe:
        analysis.ClassificationAnalyzer({})
    with pytest.raises(rerrors.SqlError) as re_:
        ranalysis.ClassificationAnalyzer({})
    assert pe.value.sqlstate == re_.value.sqlstate == "22023"
    with pytest.raises(errors.SqlError) as pe:
        analysis.NearestNeighborsAnalyzer([""])
    with pytest.raises(rerrors.SqlError) as re_:
        ranalysis.NearestNeighborsAnalyzer([""])
    assert pe.value.sqlstate == re_.value.sqlstate == "22023"


#: require-free queries: the shapes that take the mesh branch
MESH_QUERIES = ["t0", "t1 | t2", "t5 | t30 | t0", "t9", "t1*", "t50",
                "t33 | t44", "nosuchterm"]


def test_mesh_branch_runs_per_shard(searchers):
    """mesh_n = 2 over a virtual mesh of 8 devices. With a conjunction in
    the batch neither package takes its mesh branch (the reference's
    condition), and the two agree. With require-free queries the port
    runs `bm25_accumulate` once a shard and sums the planes with one
    `mesh_combine`; its top-k is held against the reference's
    single-device top-k, since the reference's own mesh branch
    (`score_topk_mesh`) fails under the installed JAX (shard_map's
    out_specs tuple against `lax.top_k`'s list)."""
    rs, ps, ran, pan = searchers
    with virtual_devices(8):
        ref_out = rs.topk_batch([ref_parse(q, ran) for q in QUERIES], 10,
                                mesh_n=2)
        port_out = ps.topk_batch([parse_query(q, pan) for q in QUERIES],
                                 10, mesh_n=2)
        _compare(ref_out, port_out, QUERIES)
        before = LAUNCHES.snapshot()
        port_out = ps.topk_batch([parse_query(q, pan)
                                  for q in MESH_QUERIES], 10, mesh_n=2)
        after = LAUNCHES.snapshot()
    ref_out = rs.topk_batch([ref_parse(q, ran) for q in MESH_QUERIES], 10)
    _compare(ref_out, port_out, MESH_QUERIES)
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    assert delta.get("bm25_accumulate.plain") == 2
    assert delta.get("mesh_combine.plain") == 1