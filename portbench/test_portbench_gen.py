"""The generators repeat exactly from a seed, and their text reads back
as the tokens the reference scores."""

import re

import numpy as np
import pytest

from portbench import harness

HITS = {"rows": 20_000}
MARCO = {"passages": 2_000, "vocabulary": 5_000, "queries": 50}


def _gen(workload, seed, over, columns=None):
    cell = harness.Cell.find(harness.bench_file(), workload)
    return cell.gen.generate(seed, dict(cell.config, **over), columns, "cpu")


def _same(a, b):
    assert a.keys() == b.keys()
    for t in a:
        assert a[t].keys() == b[t].keys()
        for c in a[t]:
            np.testing.assert_array_equal(a[t][c]["data"], b[t][c]["data"])
            if a[t][c]["dictionary"] is not None:
                assert list(a[t][c]["dictionary"]) == \
                    list(b[t][c]["dictionary"])


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 3])
def test_hits_repeats_from_its_seed(seed):
    a = _gen("hits_100m.agg_mix", seed, HITS)
    b = _gen("hits_100m.agg_mix", seed, HITS)
    _same(a["tables"], b["tables"])
    c = _gen("hits_100m.agg_mix", seed + 1, HITS)
    assert not np.array_equal(a["tables"]["hits"]["UserID"]["data"],
                              c["tables"]["hits"]["UserID"]["data"])


def test_hits_columns_do_not_depend_on_each_other():
    full = _gen("hits_100m.agg_mix", 7, HITS)["tables"]["hits"]
    part = _gen("hits_100m.agg_mix", 7, HITS,
                {"AdvEngineID", "SearchPhrase"})["tables"]["hits"]
    assert set(part) == {"AdvEngineID", "SearchPhrase"}
    for c in part:
        np.testing.assert_array_equal(part[c]["data"], full[c]["data"])


def test_hits_distributions_and_types():
    t = _gen("hits_100m.agg_mix", 3, HITS)["tables"]["hits"]
    adv = t["AdvEngineID"]["data"]
    assert adv.dtype == np.int16 and (adv != 0).sum() == 126
    assert adv.min() == 0 and adv.max() <= 63
    sp = t["SearchPhrase"]
    d = sp["dictionary"]
    # the published counts in proportion to 20,000 of 99,997,497 rows
    assert list(d) == sorted(d) and d[0] == "" and len(d) == 1_204
    assert len(np.unique(sp["data"])) == 1_204   # every phrase and ''
    assert 0.67 < (sp["data"] == 0).mean() < 0.73
    assert len(np.unique(t["UserID"]["data"])) == 3_526
    rw = t["ResolutionWidth"]["data"]
    assert rw.min() >= 0 and rw.max() <= 3999
    assert t["EventTime"]["data"].dtype == np.int64


def test_hits_configuration_holds_the_published_counts():
    """The counts that ClickBench's published answers give: 630,500
    non-zero AdvEngineID rows (queries.sql line 2), 17,630,976 distinct
    UserID (line 5) and 6,019,103 distinct SearchPhrase (line 6)."""
    cols = harness.Cell.find(harness.bench_file(),
                             "hits_100m.agg_mix").config["columns"]
    assert cols["AdvEngineID"]["nonzero"] == 630_500
    assert cols["UserID"]["distinct"] == 17_630_976
    assert cols["SearchPhrase"]["distinct"] == 6_019_103


@pytest.mark.parametrize("seed", [1, 2**31 + 99])
def test_msmarco_repeats_from_its_seed(seed):
    a = _gen("msmarco_1m.search_batched", seed, MARCO)
    b = _gen("msmarco_1m.search_batched", seed, MARCO)
    _same(a["tables"], b["tables"])
    assert a["pools"] == b["pools"]
    np.testing.assert_array_equal(a["corpus"]["tokens"],
                                  b["corpus"]["tokens"])


def test_msmarco_text_reads_back_as_its_tokens():
    d = _gen("msmarco_1m.search_batched", 5, MARCO)
    body = d["tables"]["passages"]["body"]
    text = body["dictionary"][body["data"]]
    c = d["corpus"]
    rank = {w.tobytes().decode().rstrip(): r
            for r, w in enumerate(c["spelling"])}
    assert len(rank) == len(c["spelling"])        # every spelling distinct
    for i in (0, 17, len(text) - 1):
        words = re.findall(r"[a-z0-9_]+", text[i])
        want = c["tokens"][c["offsets"][i]:c["offsets"][i + 1]]
        assert [rank[w] for w in words] == list(want)


def test_msmarco_query_shapes_do_not_depend_on_the_seed():
    a = _gen("msmarco_1m.search_batched", 1, MARCO)["corpus"]["query_terms"]
    b = _gen("msmarco_1m.search_batched", 2, MARCO)["corpus"]["query_terms"]
    assert [list(x) for x in a] == [list(x) for x in b]
    assert all(2 <= len(q) <= 8 and len(set(q)) == len(q) for q in a)
