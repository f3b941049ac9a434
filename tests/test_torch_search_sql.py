"""Search through SQL on the port against the JAX package, on the CPU.

The same statements, over tables made from a numpy seed, run through both
packages' `Database.connect().execute`: `@@` filters, bm25()/tfidf() top-k
and ts_headline over an inverted index (one segment, then two after an
INSERT), and the b-tree, primary-key and geo scans. `EXPLAIN` must show
the same scan nodes, and the rows must be equal. Scores follow PR 1's
search rule (rtol 1e-5, atol 1e-6; ids differ only where scores tie
within it): the port's dense GEMM sums in torch's order and the
reference's in XLA's, which may contract a product into an fma.
"""

import numpy as np
import pytest

from serenedb_tpu.engine import Database as RefDatabase
from serenedb_tpu.exec.shard import combine_mode as rcombine_mode
from serenedb_tpu_torch.device import LAUNCHES
from serenedb_tpu_torch.engine import Database

RTOL, ATOL = 1e-5, 1e-6
WORDS = ("apple banana cherry date elder fig grape hazel iris juniper kiwi "
         "lemon mango nectar olive peach quince rose sage thyme").split()


def _docs(n=400, seed=21):
    rng = np.random.default_rng(seed)
    z = rng.zipf(1.4, size=n * 14) % len(WORDS)
    lens = rng.integers(2, 14, n)
    out, pos = [], 0
    for ln in lens:
        out.append(" ".join(WORDS[i] for i in z[pos:pos + ln]))
        pos += ln
    return out


def _pair(setup):
    conns = []
    for db in (RefDatabase(), Database(device="cpu")):
        c = db.connect()
        for st in setup:
            c.execute(st)
        conns.append(c)
    return conns


def _same_rows(got, want, scored: bool, q: str) -> None:
    """Equal rows; with `scored`, the last column is a score: within the
    tolerance, and the rows may swap only where scores tie within it."""
    assert len(got) == len(want), q
    if not scored:
        assert got == want, q
        return
    gs = np.asarray([r[-1] for r in got], np.float64)
    ws = np.asarray([r[-1] for r in want], np.float64)
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL, err_msg=q)
    for j, (g, w) in enumerate(zip(got, want)):
        if g[:-1] != w[:-1]:
            assert np.isclose(ws, ws[j], rtol=RTOL, atol=ATOL).sum() > 1, q


def _check(conns, q: str, scored=False) -> None:
    ref, port = conns
    assert port.execute("EXPLAIN " + q).rows() == \
        ref.execute("EXPLAIN " + q).rows(), q
    _same_rows(port.execute(q).rows(), ref.execute(q).rows(), scored, q)


FILTERS = ["apple & banana", "cherry | date", "!apple", "fig & !grape",
           '"apple banana"', "app*", "mango~1", "(kiwi | lemon) & olive",
           "nosuchword"]
TOPK = [("bm25", "apple"), ("bm25", "apple | banana | cherry"),
        ("bm25", "apple & banana"), ("tfidf", "grape | hazel"),
        ("bm25", '"apple banana"'), ("tfidf", "iris & !juniper")]


@pytest.fixture(scope="module")
def text_conns():
    docs = _docs()
    return _pair(["CREATE TABLE docs (id INT, body TEXT)",
                  "INSERT INTO docs VALUES " + ", ".join(
                      f"({i}, '{d}')" for i, d in enumerate(docs)),
                  "CREATE INDEX dx ON docs USING inverted (body)"])


@pytest.mark.parametrize("query", FILTERS)
def test_search_filters_equal_reference(text_conns, query):
    _check(text_conns, f"SELECT count(*) FROM docs WHERE body @@ '{query}'")
    _check(text_conns, f"SELECT id FROM docs WHERE body @@ '{query}' "
                       "AND id < 200 ORDER BY id")


@pytest.mark.parametrize("scorer,query", TOPK)
def test_scored_topk_equals_reference(text_conns, scorer, query):
    _check(text_conns, f"SELECT id, {scorer}(body) AS s FROM docs WHERE "
                       f"body @@ '{query}' ORDER BY s DESC, id LIMIT 10",
           scored=True)


def test_headline_and_phrase_operator_equal_reference(text_conns):
    _check(text_conns, "SELECT id, ts_headline(body, 'apple & cherry') "
                       "FROM docs WHERE body @@ 'apple & cherry' ORDER BY id "
                       "LIMIT 5")
    _check(text_conns, "SELECT count(*) FROM docs WHERE body ## 'apple "
                       "banana'")


def test_search_scan_runs_the_scoring_kernels_plain_version(text_conns):
    before = LAUNCHES.snapshot()
    text_conns[1].execute("SELECT id, bm25(body) AS s FROM docs WHERE body "
                          "@@ 'peach | quince' ORDER BY s DESC LIMIT 3")
    after = LAUNCHES.snapshot()
    assert after.get("topk_rows.plain", 0) > before.get("topk_rows.plain", 0)


def test_multi_segment_index_after_insert_equals_reference():
    docs = _docs(300, seed=22)
    more = _docs(60, seed=23)
    conns = _pair(["CREATE TABLE docs (id INT, body TEXT)",
                   "INSERT INTO docs VALUES " + ", ".join(
                       f"({i}, '{d}')" for i, d in enumerate(docs)),
                   "CREATE INDEX dx ON docs USING inverted (body)"])
    for c in conns:
        c.execute("INSERT INTO docs VALUES " + ", ".join(
            f"({1000 + i}, '{d}')" for i, d in enumerate(more)))
    for scorer, query in TOPK:
        _check(conns, f"SELECT id, {scorer}(body) AS s FROM docs WHERE body "
                      f"@@ '{query}' ORDER BY s DESC, id LIMIT 10",
               scored=True)
    _check(conns, "SELECT count(*) FROM docs WHERE body @@ 'sage | thyme'")
    segs = []
    for c in conns:
        t = c.db.resolve_table(["docs"])
        segs.append(len(t.indexes["dx"].searcher("body").segments))
    assert segs == [2, 2]


def test_device_shard_combine_is_refused_not_served_by_the_host():
    conns = _pair(["CREATE TABLE docs (id INT, body TEXT)",
                   "INSERT INTO docs VALUES " + ", ".join(
                       f"({i}, '{d}')" for i, d in enumerate(_docs(80))),
                   "CREATE INDEX dx ON docs USING inverted (body)",
                   "INSERT INTO docs VALUES (500, 'apple apple')",
                   "SET serene_shards = 2",
                   "SET serene_shard_combine = 'device'"])
    """The device combine over a two-segment index: the cross-shard merge
    is one `merge_topk` launch a statement, and the rows equal the
    reference's device combine and both packages' host combine."""
    from serenedb_tpu_torch.device import LAUNCHES
    q = ("SELECT id, bm25(body) AS s FROM docs WHERE body @@ 'apple' ORDER "
         "BY s DESC LIMIT 3")
    before = LAUNCHES.get("merge_topk.plain")
    _check(conns, q, scored=True)
    assert LAUNCHES.get("merge_topk.plain") > before
    device_rows = conns[1].execute(q).rows()
    conns[1].execute("SET serene_shard_combine = 'host'")
    conns[0].execute("SET serene_shard_combine = 'host'")
    _check(conns, q, scored=True)
    assert conns[1].execute(q).rows() == device_rows


def test_auto_shard_combine_is_host_on_a_host_with_many_cards(monkeypatch):
    """A host with 4 initialised cards: the port's mesh spans them, so
    'auto' resolves to the device combine, as the reference's does with
    more than one device (before the mesh was ported it stayed on the
    host combine, hence the name); the rows equal the reference's."""
    import torch

    from serenedb_tpu_torch.exec.shard import combine_mode
    from serenedb_tpu_torch.parallel.mesh import device_count_if_initialized
    assert device_count_if_initialized() == 0 or torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert device_count_if_initialized() == 4
    conns = _pair(["CREATE TABLE docs (id INT, body TEXT)",
                   "INSERT INTO docs VALUES " + ", ".join(
                       f"({i}, '{d}')" for i, d in enumerate(_docs(80))),
                   "CREATE INDEX dx ON docs USING inverted (body)",
                   "INSERT INTO docs VALUES (500, 'apple apple')",
                   "SET serene_shards = 2",
                   "SET serene_shard_combine = 'auto'"])
    assert combine_mode(conns[1].settings) == "device" == \
        rcombine_mode(conns[0].settings)
    _check(conns, "SELECT id, bm25(body) AS s FROM docs WHERE body @@ "
                  "'apple' ORDER BY s DESC LIMIT 3", scored=True)


def test_btree_and_pk_scans_equal_reference():
    rng = np.random.default_rng(24)
    keys = rng.permutation(3000)
    conns = _pair(["CREATE TABLE t (k INT PRIMARY KEY, a INT, s TEXT)",
                   "INSERT INTO t VALUES " + ", ".join(
                       f"({int(k)}, {int(k) % 37}, 'w{int(k) % 11}')"
                       for k in keys),
                   "CREATE INDEX ta ON t USING btree (a)",
                   "CREATE TABLE c (a INT, b TEXT, v INT, "
                   "PRIMARY KEY (a, b))",
                   "INSERT INTO c VALUES " + ", ".join(
                       f"({i // 10}, 'k{i % 10}', {i})" for i in range(500))])
    for q in ["SELECT * FROM t WHERE k = 1234",
              "SELECT k, s FROM t WHERE a = 7 ORDER BY k",
              "SELECT count(*) FROM t WHERE a = 36",
              "SELECT sum(a), count(*) FROM t WHERE k > 100 AND k <= 900",
              "SELECT v FROM c WHERE a = 5 AND b = 'k3'",
              "SELECT count(*) FROM c WHERE a >= 3 AND a < 5"]:
        _check(conns, q)
    plan = str(conns[1].execute("EXPLAIN SELECT * FROM t WHERE k = 1234")
               .rows())
    assert "PkScan" in plan
    assert "BtreeScan" in str(conns[1].execute(
        "EXPLAIN SELECT k FROM t WHERE a = 7").rows())


def test_geo_scan_equals_reference():
    rng = np.random.default_rng(25)
    pts = rng.uniform([-179, -85], [179, 85], size=(3000, 2))
    conns = _pair(["CREATE TABLE gp (id INT, loc TEXT)",
                   "INSERT INTO gp VALUES " + ", ".join(
                       f"({i}, 'POINT({x:.5f} {y:.5f})')"
                       for i, (x, y) in enumerate(pts)),
                   "CREATE INDEX ON gp USING geo (loc)"])
    poly = "POLYGON((10 10, 40 10, 40 40, 10 40, 10 10))"
    for q in [f"SELECT count(*) FROM gp WHERE st_intersects(loc, '{poly}')",
              f"SELECT id FROM gp WHERE st_intersects(loc, '{poly}') "
              "ORDER BY id",
              "SELECT count(*) FROM gp WHERE st_dwithin(loc, 'POINT(0 0)', "
              "2000000)"]:
        _check(conns, q)
    assert "GeoScan" in str(conns[1].execute(
        "EXPLAIN SELECT id FROM gp WHERE st_intersects(loc, "
        f"'{poly}')").rows())
