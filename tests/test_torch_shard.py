"""The port's sharded execution tier against the JAX package's, on the CPU.

The inputs are those of tests/test_multichip.py: its `_mk_conn` tables (l
with 6,000 rows, r with 3,000, seed 11, NULL keys, dictionary strings,
`serene_morsel_rows = 1024`) loaded into a reference `Database` and —
through `carry.memtable_from_reference` — into the port's
`Database(device="cpu")` with `serene_device = 'gpu'`, and its `QUERIES`,
`JOIN_Q` and search corpus. Under `serene_shards` 2/4 and
`serene_shard_combine` host/device the port's fused join runs per-shard
`join_probe` launches with an exact host combine, or one launch over the
concatenated shard spans; a multi-segment search merges its shards'
top-k with `merge_topk`. Here every one of them runs its plain version.

Checked against the reference: rows (by `repr`) in every cell of combine
× shards × workers × zonemap; the warm dispatch counts; the EXPLAIN
ANALYZE `Shards:` line and the JSON `Shard Combine` key; the trace spans;
the exported gauges; the result cache across combines; the search merges
bit for bit, ties and -0.0 included; the inadmissible merge.
"""

import json

import numpy as np
import pytest

from serenedb_tpu.engine import Database as RDatabase
from serenedb_tpu.search.index import find_index as r_find_index
from serenedb_tpu.search.query import parse_query as r_parse_query
from serenedb_tpu.search.searcher import (
    _device_merge_topk as r_device_merge, merge_segment_topk as r_heap)
from serenedb_tpu.utils import metrics as rmetrics
from serenedb_tpu.utils.config import REGISTRY as RSETTINGS
from serenedb_tpu_torch.carry import memtable_from_reference
from serenedb_tpu_torch.device import LAUNCHES
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.exec import shard as pshard
from serenedb_tpu_torch.ops.merge_kernels import PAD_DOC, merge_topk
from serenedb_tpu_torch.parallel import mesh as pmesh
from serenedb_tpu_torch.search.index import find_index
from serenedb_tpu_torch.search.query import parse_query
from serenedb_tpu_torch.search.searcher import (_device_merge_topk,
                                                merge_segment_topk)
from serenedb_tpu_torch.utils import metrics
from serenedb_tpu_torch.utils.config import REGISTRY as PSETTINGS

import torch

from test_multichip import JOIN_Q, QUERIES, SEARCH_QUERIES, _mk_conn

_SETUP = ["SET serene_result_cache = off", "SET serene_morsel_rows = 1024",
          "SET serene_parallel_min_rows = 1024",
          "SET serene_device = 'gpu'", "SET serene_device_fused = on"]


def _pair(nl=6000, nr=3000, seed=11):
    """(reference conn, port conn) over the same l and r."""
    rc = _mk_conn(nl=nl, nr=nr, seed=seed)
    pdb = Database(device="cpu")
    for name in ("l", "r"):
        batch = rc.db.schemas["main"].tables[name].full_batch()
        pdb.schemas["main"].tables[name] = memtable_from_reference(
            name, {n: (c.data, c.validity, c.dictionary, c.type.id.name)
                   for n in batch.names for c in [batch.column(n)]})
    pc = pdb.connect()
    for s in _SETUP:
        pc.execute(s)
    return rc, pc


def _both(conns, sql):
    for c in conns:
        c.execute(sql)


def _rows(c, q):
    return repr(c.execute(q).rows())


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("zonemap", ["on", "off"])
@pytest.mark.parametrize("combine", ["device", "host"])
def test_shard_parity_matrix(combine, zonemap):
    """combine device/host × shards 1/2/4 × workers 1/4 per zonemap leg:
    every cell of the port equal to the reference's cell."""
    rc, pc = _pair()
    _both((rc, pc), f"SET serene_zonemap = {zonemap}")
    _both((rc, pc), f"SET serene_shard_combine = {combine}")
    for q in QUERIES:
        for workers in (1, 4):
            _both((rc, pc), f"SET serene_workers = {workers}")
            for shards in (1, 2, 4):
                _both((rc, pc), f"SET serene_shards = {shards}")
                assert _rows(pc, q) == _rows(rc, q), \
                    (q, combine, shards, workers, zonemap)
        _both((rc, pc), "SET serene_shards = 1")


def _offloads(m, q, c):
    before = m.DEVICE_OFFLOADS.value
    cd = m.COLLECTIVE_DISPATCHES.value
    out = _rows(c, q)
    return out, m.DEVICE_OFFLOADS.value - before, \
        m.COLLECTIVE_DISPATCHES.value - cd


def test_warm_dispatch_counts(pair):
    """Warm: ONE dispatch under the device combine (the build outputs are
    cached), one per shard under the host combine — the reference's
    counts, and the port's launches say the same."""
    rc, pc = pair
    try:
        _both(pair, "SET serene_shards = 4")
        for combine, launches in (("device", 1), ("host", 4)):
            _both(pair, f"SET serene_shard_combine = {combine}")
            _rows(rc, JOIN_Q)
            _rows(pc, JOIN_Q)                 # cold: build + probes
            ns0 = metrics.COLLECTIVE_COMBINE_NS.value
            r_out, r_off, r_coll = _offloads(rmetrics, JOIN_Q, rc)
            LAUNCHES.reset()
            p_out, p_off, p_coll = _offloads(metrics, JOIN_Q, pc)
            assert p_out == r_out
            assert (p_off, p_coll) == (r_off, r_coll), combine
            assert LAUNCHES.get("join_probe.plain") == launches
            assert LAUNCHES.get("agg_scan.plain") == 0   # build cached
            if combine == "device":
                assert p_off == 1 and p_coll == 1
                assert metrics.COLLECTIVE_COMBINE_NS.value > ns0
            else:
                assert p_off >= 4 and p_coll == 0
    finally:
        _both(pair, "SET serene_shards = 1")


@pytest.mark.parametrize("combine", ["device", "host"])
def test_ragged_last_shard(combine):
    rc, pc = _pair(nl=4097, nr=1500, seed=23)
    _both((rc, pc), f"SET serene_shard_combine = {combine}")
    ref = _rows(pc, JOIN_Q)
    _both((rc, pc), "SET serene_shards = 4")
    assert _rows(pc, JOIN_Q) == _rows(rc, JOIN_Q) == ref


@pytest.mark.parametrize("q", [
    "SELECT count(*), sum(v) FROM l WHERE ts < -1",
    "SELECT sk, sum(v) FROM l WHERE ts < -1 GROUP BY sk ORDER BY sk",
    "SELECT count(*), sum(v), sum(w) FROM l JOIN r ON l.ik = r.ik "
    "WHERE ts < -1",
    # the probe's zone maps keep only the first blocks: shards 2, 3 empty
    "SELECT l.sk, count(*), sum(v), max(w) FROM l JOIN r ON l.ik = r.ik "
    "WHERE ts < 1500 GROUP BY l.sk ORDER BY l.sk",
])
def test_empty_and_all_pruned_shards(pair, q):
    try:
        _both(pair, "SET serene_shards = 4")
        for combine in ("device", "host"):
            _both(pair, f"SET serene_shard_combine = {combine}")
            assert _rows(pair[1], q) == _rows(pair[0], q), (q, combine)
    finally:
        _both(pair, "SET serene_shards = 1")


def test_write_invalidation():
    rc, pc = _pair()
    q = "SELECT count(*), sum(v), sum(w) FROM l JOIN r ON l.ik = r.ik"
    _both((rc, pc), "SET serene_shards = 2")
    _both((rc, pc), "SET serene_shard_combine = device")
    first = _rows(pc, q)
    assert first == _rows(rc, q)
    _both((rc, pc), "INSERT INTO r VALUES (1, 'alpha', 7)")
    second = _rows(pc, q)
    assert second != first
    assert second == _rows(rc, q)
    _both((rc, pc), "SET serene_shard_combine = host")
    assert _rows(pc, q) == second


def test_result_cache_shared_across_combines(pair):
    rc, pc = pair
    try:
        _both(pair, "SET serene_result_cache = on")
        _both(pair, "SET serene_shards = 4")
        _both(pair, "SET serene_shard_combine = host")
        ref = _rows(pc, JOIN_Q)
        assert ref == _rows(rc, JOIN_Q)
        h0 = metrics.RESULT_CACHE_HITS.value
        _both(pair, "SET serene_shard_combine = device")
        assert _rows(pc, JOIN_Q) == ref
        assert metrics.RESULT_CACHE_HITS.value > h0
    finally:
        _both(pair, "SET serene_result_cache = off")
        _both(pair, "SET serene_shards = 1")


def _shards_line(c, q):
    text = "\n".join(r[0] for r in c.execute(f"EXPLAIN ANALYZE {q}").rows())
    lines = [ln.strip() for ln in text.splitlines() if "Shards:" in ln]
    assert lines, text
    return lines


@pytest.mark.parametrize("combine", ["device", "host"])
def test_explain_analyze_shards_line(pair, combine):
    try:
        _both(pair, "SET serene_shards = 4")
        _both(pair, f"SET serene_shard_combine = {combine}")
        got = _shards_line(pair[1], JOIN_Q)
        assert got == _shards_line(pair[0], JOIN_Q)
        assert any(f"combine={combine}" in ln for ln in got)
    finally:
        _both(pair, "SET serene_shards = 1")


def _json_combines(c, q):
    doc = json.loads(c.execute(
        f"EXPLAIN (ANALYZE, FORMAT JSON) {q}").rows()[0][0])

    def walk(node):
        yield node
        for kid in node.get("Plans", []):
            yield from walk(kid)
    return [n.get("Shard Combine") for n in walk(doc[0]["Plan"])
            if "Shard Combine" in n]


@pytest.mark.parametrize("combine", ["device", "host"])
def test_explain_json_shard_combine_key(pair, combine):
    try:
        _both(pair, "SET serene_shards = 4")
        _both(pair, f"SET serene_shard_combine = {combine}")
        got = _json_combines(pair[1], JOIN_Q)
        assert got == _json_combines(pair[0], JOIN_Q)
        assert combine in got
    finally:
        _both(pair, "SET serene_shards = 1")


def _span_names(c, q):
    c.execute(q)
    from serenedb_tpu.obs.trace import FLIGHT as RFLIGHT
    from serenedb_tpu_torch.obs.trace import FLIGHT as PFLIGHT
    flight = PFLIGHT if isinstance(c.db, Database) else RFLIGHT
    entry = flight.get(c._active_trace.trace_id)
    return {s["name"] for s in entry["spans"]}


@pytest.mark.parametrize("combine", ["device", "host"])
def test_trace_spans(pair, combine):
    try:
        _both(pair, "SET serene_trace = on")
        _both(pair, "SET serene_shards = 4")
        _both(pair, f"SET serene_shard_combine = {combine}")
        tier = {"collective_dispatch", "shard_pipeline"}
        got = _span_names(pair[1], JOIN_Q) & tier
        assert got == _span_names(pair[0], JOIN_Q) & tier
        assert got == ({"collective_dispatch"} if combine == "device"
                       else {"shard_pipeline"})
    finally:
        _both(pair, "SET serene_trace = off")
        _both(pair, "SET serene_shards = 1")


def test_exported_collective_gauges():
    from serenedb_tpu.obs.export import prometheus_text as r_prom
    from serenedb_tpu.obs.export import stats_json as r_stats
    from serenedb_tpu_torch.obs.export import prometheus_text, stats_json
    for prom, stats in ((prometheus_text, stats_json), (r_prom, r_stats)):
        text = prom()
        assert "serenedb_collective_dispatches" in text
        assert "serenedb_collective_combine_ns" in text
        snap = stats()["metrics"]
        assert "CollectiveDispatches" in snap
        assert "CollectiveCombineNs" in snap


def test_one_card_mesh_entries():
    cpu = torch.device("cpu")
    assert pmesh.shard_devices(4, base=cpu) is None
    assert pmesh.data_mesh_width(4, base=cpu) == 1
    assert pmesh.data_mesh_width(1, base=cpu) == 1


def test_a_mesh_without_a_card_or_a_base_raises(monkeypatch):
    """Outside a connection and a build scope, the mesh's base device is
    `cuda:0`, as for every entry point: with no card that raises instead
    of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (pmesh.devices, pmesh.device_count, pmesh.make_mesh,
                 lambda: pmesh.data_mesh(4), lambda: pmesh.shard_devices(4),
                 lambda: pmesh.data_mesh_width(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pmesh.virtual_devices(4):
        with pytest.raises(RuntimeError):
            pmesh.devices()


# -- search: the cross-shard merge -------------------------------------------


def _search_pair():
    """tests/test_multichip.py `_search_conn`'s corpus in both packages:
    2,000 docs, then four appends of 100 (a multi-segment index)."""
    conns = []
    for db in (RDatabase(), Database(device="cpu")):
        c = db.connect()
        c.execute("CREATE TABLE docs (id INT, body TEXT)")
        words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
        rng = np.random.default_rng(5)
        vals = ", ".join(f"({i}, '{' '.join(rng.choice(words, 5))}')"
                         for i in range(2000))
        c.execute(f"INSERT INTO docs VALUES {vals}")
        c.execute("CREATE INDEX ON docs USING inverted (body)")
        for j in range(4):
            vals = ", ".join(f"({10000 + 100 * j + i}, "
                             f"'{' '.join(rng.choice(words, 5))}')"
                             for i in range(100))
            c.execute(f"INSERT INTO docs VALUES {vals}")
            c.execute("SELECT count(*) FROM docs WHERE body @@ 'alpha'")
        c.execute("SET serene_result_cache = off")
        conns.append((db, c))
    return conns


@pytest.fixture(scope="module")
def search_pair():
    return _search_pair()


def test_search_combine_parity_engine(search_pair):
    (_rdb, rc), (_pdb, pc) = search_pair
    pc.execute("SET serene_device = 'gpu'")
    try:
        for q in SEARCH_QUERIES:
            for shards in (1, 2, 4):
                for combine in ("device", "host"):
                    _both((rc, pc), f"SET serene_shards = {shards}")
                    _both((rc, pc), f"SET serene_shard_combine = {combine}")
                    for workers in (1, 4):
                        _both((rc, pc), f"SET serene_workers = {workers}")
                        assert _rows(pc, q) == _rows(rc, q), \
                            (q, shards, combine, workers)
    finally:
        _both((rc, pc), "SET serene_shards = 1")


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def test_multisearcher_combine_parity_direct(search_pair):
    """topk and cpu_topk through the MultiSearcher: under every shard
    count and combine, bit-equal to the reference's and to shards = 1;
    the device combine launches `merge_topk` once a call, the host
    combine never."""
    (rdb, _rc), (pdb, _pc) = search_pair
    rms = r_find_index(rdb.resolve_table(["docs"]), "body") \
        .searchers["body"]
    pms = find_index(pdb.resolve_table(["docs"]), "body").searchers["body"]
    assert len(pms.segments) == len(rms.segments) > 2
    assert pms.device == torch.device("cpu")
    rnode = r_parse_query("alpha | gamma", rms.analyzer)
    pnode = parse_query("alpha | gamma", pms.analyzer)
    prior = [(reg, reg.get_global(n)) for reg in (RSETTINGS, PSETTINGS)
             for n in ("serene_shards", "serene_shard_combine")]
    try:
        for reg in (RSETTINGS, PSETTINGS):
            reg.set_global("serene_shards", 1)
        base = pms.topk(pnode, 10), pms.cpu_topk(pnode, 10)
        for shards in (1, 2, 4):
            for combine in ("device", "host"):
                for reg in (RSETTINGS, PSETTINGS):
                    reg.set_global("serene_shards", shards)
                    reg.set_global("serene_shard_combine", combine)
                ref = rms.topk(rnode, 10), rms.cpu_topk(rnode, 10)
                before = metrics.COLLECTIVE_DISPATCHES.value
                LAUNCHES.reset()
                got = pms.topk(pnode, 10), pms.cpu_topk(pnode, 10)
                for (s, d), (rs, rd), (bs, bd) in zip(got, ref, base):
                    assert np.array_equal(_bits(s), _bits(rs))
                    assert np.array_equal(d, rd)
                    assert np.array_equal(_bits(s), _bits(bs))
                    assert np.array_equal(d, bd)
                merged = 2 if combine == "device" and shards > 1 else 0
                assert metrics.COLLECTIVE_DISPATCHES.value - before \
                    == merged
                assert LAUNCHES.get("merge_topk.plain") == merged
    finally:
        for (reg, v), n in zip(prior, ("serene_shards",
                                       "serene_shard_combine") * 2):
            reg.set_global(n, v)


def _crafted(seed=3, segs=5):
    """test_device_merge_tie_order_exact's segments: score ties across
    shards, a -0.0 / +0.0 pair."""
    rng = np.random.default_rng(seed)
    seg_outs, bases, base = [], [], 0
    for _ in range(segs):
        n = int(rng.integers(3, 9))
        sc = rng.choice(np.asarray(
            [2.5, 2.5, 1.25, 0.0, -0.0, 3.75], dtype=np.float32), n)
        dd = np.sort(rng.choice(50, n, replace=False)).astype(np.int64)
        seg_outs.append([(sc, dd)])
        bases.append(base)
        base += 50
    return seg_outs, bases


@pytest.mark.parametrize("k", [1, 7, 25, 60])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_device_merge_tie_order_exact(k, n_shards):
    seg_outs, bases = _crafted()
    ref = r_heap(seg_outs, bases, 1, k)
    r_dev = r_device_merge(seg_outs, bases, 1, k, n_shards)
    got = _device_merge_topk(seg_outs, bases, 1, k, n_shards, device="cpu")
    assert got is not None and r_dev is not None
    for other in (ref, r_dev, merge_segment_topk(seg_outs, bases, 1, k)):
        assert np.array_equal(got[0][1], other[0][1])
        assert np.array_equal(_bits(got[0][0]), _bits(other[0][0]))


def test_device_merge_inadmissible_falls_back():
    """The reference's admission: a doc id at the padding sentinel, a NaN
    score, one shard group — None, so the host heap merges."""
    pad = [[(np.asarray([1.0], np.float32),
             np.asarray([2**31 - 1], np.int64))],
           [(np.asarray([2.0], np.float32), np.asarray([3], np.int64))]]
    nan = [[(np.asarray([np.nan], np.float32), np.asarray([1], np.int64))],
           [(np.asarray([2.0], np.float32), np.asarray([3], np.int64))]]
    for seg_outs, n_shards in ((pad, 2), (nan, 2), (_crafted()[0], 1)):
        bases = [0] * len(seg_outs)
        assert r_device_merge(seg_outs, bases, 1, 5, n_shards) is None
        assert _device_merge_topk(seg_outs, bases, 1, 5, n_shards,
                                  device="cpu") is None


def _heap_of(scores, docs, k):
    """The reference's heap merge over (S, Q, L) candidates, pads out."""
    S, Q, _L = scores.shape
    seg_outs = []
    for s in range(S):
        row = []
        for q in range(Q):
            live = docs[s, q] != PAD_DOC
            row.append((scores[s, q][live], docs[s, q][live].astype(
                np.int64)))
        seg_outs.append(row)
    return r_heap(seg_outs, [0] * S, Q, k)


@pytest.mark.parametrize("S,L,kk", [(4, 10, 10), (1, 1, 1), (8, 1024, 10),
                                    (3, 2731, 5), (2, 5000, 9000)])
def test_merge_scratch_is_none_up_to_one_block(S, L, kk):
    """Up to MERGE_ONE_MAX lanes a query a call takes no scratch (one
    kernel); past it the key array and the levels' second buffer."""
    from serenedb_tpu_torch.ops import merge_kernels as mk
    from serenedb_tpu_torch.ops import select
    got = mk.merge_scratch(S, 16, L, kk)
    if S * L <= mk.MERGE_ONE_MAX:
        assert got == (0, 0)
    else:
        assert got == select.scratch(16, S * L, 1, kk, mk.MERGE_SORT_FLOOR)
        assert got[0] >= 16 * S * L


@pytest.mark.parametrize("seed", range(6))
def test_merge_topk_plain_against_the_heap(seed):
    """Random and tied (S, Q, L) candidates, docs unique within a query,
    with pads, -0.0, -inf and k past any shard's candidates: the plain
    version's rows are the heap's bit for bit, pads trimmed."""
    rng = np.random.default_rng(seed)
    S, Q, L = int(rng.integers(2, 5)), int(rng.integers(1, 6)), \
        int(rng.integers(1, 12))
    pool = np.asarray([3.5, 1.0, 1.0, 0.0, -0.0, -np.inf, 2.25],
                      dtype=np.float32)
    scores = rng.choice(pool, (S, Q, L)) if seed % 2 else \
        rng.standard_normal((S, Q, L)).astype(np.float32)
    docs = np.empty((S, Q, L), dtype=np.int32)
    for q in range(Q):
        docs[:, q, :] = rng.choice(10 * S * L, S * L, replace=False) \
            .reshape(S, L)
    pads = rng.random((S, Q, L)) < 0.3
    scores[pads] = -np.inf
    docs[pads] = PAD_DOC
    for k in (1, 3, L, S * L + 4):
        LAUNCHES.reset()
        vals, dd = merge_topk(torch.from_numpy(scores),
                              torch.from_numpy(docs), k)
        assert LAUNCHES.get("merge_topk.plain") == 1
        assert vals.shape == (Q, min(k, S * L))
        ref = _heap_of(scores, docs, k)
        for q in range(Q):
            real = dd[q].numpy() != PAD_DOC
            assert np.array_equal(dd[q].numpy()[real], ref[q][1])
            assert np.array_equal(_bits(vals[q].numpy()[real]),
                                  _bits(ref[q][0]))
            # pads come after every real candidate
            assert not real[np.argmin(real):].any() or real.all()


def test_auto_combine_resolves_to_host_on_one_card():
    prior = PSETTINGS.get_global("serene_shard_combine")
    try:
        PSETTINGS.set_global("serene_shard_combine", "auto")
        assert pshard.combine_mode(None) == "host"
    finally:
        PSETTINGS.set_global("serene_shard_combine", prior)
