"""The plain references against answers worked out by hand on tiny
tables and corpora, and the comparisons against answers altered."""

import math

import numpy as np
import pytest

from portbench.reference import clickbench_hits as H
from portbench.reference import msmarco_bm25 as M


def _table():
    return {
        "AdvEngineID": {"data": np.array([0, 2, 0, 5, 2, 0, 2, 0], np.int16),
                        "dictionary": None},
        "ResolutionWidth": {"data": np.arange(10, 90, 10, dtype=np.int16),
                            "dictionary": None},
        "SearchPhrase": {"data": np.array([0, 1, 2, 1, 0, 2, 1, 0], np.int32),
                         "dictionary": np.array(["", "a", "b"], object)},
    }


@pytest.mark.parametrize("sql,rows", [
    ("SELECT COUNT(*) FROM hits WHERE AdvEngineID <> 0;", [(4,)]),
    ("SELECT SUM(AdvEngineID), COUNT(*), AVG(ResolutionWidth) FROM hits;",
     [(11, 8, 45.0)]),
    ("SELECT AdvEngineID, COUNT(*) FROM hits WHERE AdvEngineID <> 0 "
     "GROUP BY AdvEngineID ORDER BY COUNT(*) DESC;", [(2, 3), (5, 1)]),
    ("SELECT SearchPhrase, COUNT(*) AS c FROM hits WHERE SearchPhrase <> '' "
     "GROUP BY SearchPhrase ORDER BY c DESC LIMIT 10;", [("a", 3), ("b", 2)]),
    ("SELECT SUM(ResolutionWidth), SUM(ResolutionWidth + 1), "
     "SUM(ResolutionWidth + 2) FROM hits;", [(360, 368, 376)]),
    ("SELECT SearchPhrase, COUNT(*) AS c FROM hits GROUP BY SearchPhrase "
     "ORDER BY c DESC LIMIT 1", [("", 3)]),
])
def test_hits_answers_by_hand(sql, rows):
    r = H.evaluate(sql, _table())
    assert r.rows[:r.expected] == rows or sorted(r.rows[:r.expected]) == \
        sorted(rows)
    assert H.compare([list(x) for x in rows], r) == (0, 0.0)


def test_hits_ties_may_come_in_either_order():
    sql = ("SELECT SearchPhrase, COUNT(*) AS c FROM hits GROUP BY "
           "SearchPhrase ORDER BY c DESC LIMIT 2")
    r = H.evaluate(sql, _table())      # '' and 'a' tie at 3
    assert H.compare([["a", 3], ["", 3]], r)[0] == 0
    assert H.compare([["", 3], ["a", 3]], r)[0] == 0
    assert H.compare([["b", 2], ["", 3]], r)[0] > 0     # not a top-2 group
    assert H.compare([["a", 3], ["a", 3]], r)[0] > 0    # repeated
    assert H.compare([["a", 3]], r)[0] > 0              # a row missing


def test_hits_wrong_answers_are_caught():
    sql = "SELECT SUM(AdvEngineID), COUNT(*), AVG(ResolutionWidth) FROM hits;"
    r = H.evaluate(sql, _table())
    assert H.compare([[11, 8, 45.0]], r) == (0, 0.0)
    assert H.compare([[12, 8, 45.0]], r)[0] == 1
    wrong, err = H.compare([[11, 8, 45.0 * (1 + 1e-6)]], r)
    assert wrong == 0 and err == pytest.approx(1e-6)


def test_hits_control_wraps_int32_sums():
    t = {"ResolutionWidth": {"data": np.full(4, 1 << 30, np.int64),
                             "dictionary": None}}
    sql = "SELECT SUM(ResolutionWidth) FROM hits"
    assert H.evaluate(sql, t).rows == [(1 << 32,)]
    assert H.evaluate(sql, t, "low").rows == [(0,)]


def test_hits_least_bytes_by_hand():
    t = _table()
    sql = "SELECT COUNT(*) FROM hits WHERE AdvEngineID <> 0;"
    # AdvEngineID spans 0..5: 3 bits x 8 rows = 3 bytes; one 8-byte result
    assert H.least_bytes(sql, t, H.evaluate(sql, t)) == 3 + 8
    sql = ("SELECT SearchPhrase, COUNT(*) AS c FROM hits WHERE SearchPhrase "
           "<> '' GROUP BY SearchPhrase ORDER BY c DESC LIMIT 10;")
    # codes 0..2: 2 bits x 8 = 2 bytes; results 'a', 3, 'b', 2: 1+8+1+8
    assert H.least_bytes(sql, t, H.evaluate(sql, t)) == 2 + 18
    ref = H.Reference({"tables": {"hits": t}}, {"table": "hits"})
    assert ref.least_bytes_all([sql, sql], [1.0, 0.5]) == 1.5 * 20


def _corpus():
    spelling = np.full((4, 6), ord(" "), np.uint8)
    for r, w in enumerate(["aa", "bb", "cc", "dd"]):
        spelling[r, :2] = np.frombuffer(w.encode(), np.uint8)
    tokens = np.array([0, 1, 1, 1, 2, 2, 2, 2, 3], np.int32)
    return {"corpus": {"tokens": tokens, "offsets": np.array([0, 3, 5, 9]),
                       "spelling": spelling}}


CFG = {"bm25": {"k1": 1.2, "b": 0.75}}
SQL = "SELECT id FROM passages WHERE body @@ 'bb | cc' ORDER BY s DESC"


def test_bm25_scores_by_hand():
    ref = M.Reference(_corpus(), CFG)
    idf = math.log(1 + (3 - 2 + 0.5) / (2 + 0.5))     # both terms: df 2
    # avgdl 3; doc 0: tf 2, dl 3; doc 1: two terms tf 1, dl 2; doc 2: tf 3,
    # dl 4
    want = {0: idf * 2.2 * 2 / (2 + 1.2),
            1: 2 * idf * 2.2 / (1 + 1.2 * (0.25 + 0.5)),
            2: idf * 2.2 * 3 / (3 + 1.2 * (0.25 + 1.0))}
    docs, s = ref.scores(ref.terms(SQL))
    assert list(docs) == [0, 1, 2]
    np.testing.assert_allclose(s, [want[0], want[1], want[2]], rtol=1e-12)
    top = ref.top(SQL)
    assert [d for d, _ in top] == [1, 2, 0]


def test_bm25_comparison():
    ref = M.Reference(_corpus(), CFG)
    top = ref.top(SQL)
    assert ref.compare(SQL, top) == (0, 0.0, 0.0)
    f32 = [(d, float(np.float32(v))) for d, v in top]
    w, gap, err = ref.compare(SQL, f32)
    assert w == 0 and gap == 0.0 and 0 < err < 1e-7
    swapped = [top[1], top[0], top[2]]
    w, gap, _ = ref.compare(SQL, swapped)
    assert w == 0 and gap > 0.01
    assert ref.compare(SQL, top[:2])[0] == 1            # a row missing
    assert ref.compare(SQL, top + [(3, 0.0)])[0] >= 1   # not a match


def test_bf16_rounding():
    def r(x):
        return M.bf16(np.array([np.float32(x)]))[0]
    assert r(1.0) == 1.0
    assert r(1 + 3 * 2 ** -9) == np.float32(1 + 2 ** -7)   # to nearest
    assert r(1 + 2 ** -8) == 1.0                             # a tie: even
    assert r(1 + 3 * 2 ** -8) == np.float32(1 + 2 ** -6)     # a tie: even


def test_bm25_least_bytes_by_hand():
    ref = M.Reference(_corpus(), CFG)
    # 4 postings x (doc id 0..2: 2 bits + tf 1..3: 2 bits); 3 passages
    # touched x (lengths 2..4: 2 bits) = 22 bits = 3 bytes; a 3-row top
    assert ref.least_bytes(SQL) == 3 + 3 * 12
    assert ref.least_bytes_all([SQL, SQL], [0.25, 1.0]) == 1.25 * 39


class _Bytes:
    """A reference whose every statement moves `per` bytes at the least."""

    def __init__(self, per):
        self.per = per

    def least_bytes_all(self, sqls, shares):
        return sum(w * self.per for w in shares)


@pytest.mark.parametrize("metric", ["scan_roofline.sql",
                                    "score_roofline.search"])
def test_roofline_counts_straddling_statements_by_their_share(metric):
    """A slice from 10 s to 18 s with 1 s of kernels: a statement inside
    counts whole, one that straddles either end by the share of its time
    inside, one outside or failed not at all."""
    from portbench import harness, trace
    from portbench.peaks import HBM_BYTES_PER_S
    sl = trace.Slice(10.0, 18.0, device=[(11.0, 12.0, "k", "kernel")])
    records = [(0, 0, 8.0, 12.0, None, []),     # half inside
               (1, 0, 12.0, 16.0, None, []),    # inside
               (2, 0, 14.0, 22.0, None, []),    # half inside
               (3, 0, 2.0, 6.0, None, []),      # before the slice
               (0, 0, 12.0, 13.0, "ERROR", [])]  # failed
    per = 0.01 * HBM_BYTES_PER_S
    run = harness.Run(None, 0, 30.0, 0.0, 0.0, 30.0, records, ["s"],
                      None, _Bytes(per), sl)
    assert [w for _, w in run.slice_shares()] == [0.5, 1.0, 0.5]
    got = harness._reader(metric).read(run)
    assert got == pytest.approx(100.0 * 2 * 0.01)
    # a statement alone that spans the slice counts its slice's share
    run.records = [(0, 0, 6.0, 22.0, None, [])]
    assert harness._reader(metric).read(run) == pytest.approx(0.5)
