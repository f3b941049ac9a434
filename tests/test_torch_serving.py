"""The serving front ends on the port against the JAX package, on the CPU.

The same requests — `_bulk`, `_search` (match, bool, term, query_string),
`_msearch`, `_count`, `_analyze`, taken from tests/test_es_api.py and
tests/test_lucene.py — go to the reference's servers and to the port's
(`Database(device="cpu")`): through `FrontDoor` (HTTP and the PG wire on
one loop), through `LegacyHttpServer`, and to `EsApi` in process. The
responses must be equal, with `took` left out and scores held to the
port's search rule (rtol 1e-5, atol 1e-6). The PG wire is spoken in raw bytes.

Both packages set `DENSE_HBM_BUDGET` to 0, so `_msearch` items coalesce
into ragged batches that reach the posting pool. Every server listens on
port 0 and is stopped by its fixture; every socket has a time limit.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import serenedb_tpu.ops.bm25 as ref_bm25
import serenedb_tpu_torch.ops.bm25 as port_bm25
from serenedb_tpu.engine import Database as RefDatabase
from serenedb_tpu.server.es_api import EsApi as RefEsApi
from serenedb_tpu.server.frontdoor import FrontDoor as RefFrontDoor
from serenedb_tpu.server.http_server import \
    LegacyHttpServer as RefLegacyHttpServer
from serenedb_tpu.server.pgwire import PgServer as RefPgServer
from serenedb_tpu.utils.config import REGISTRY as REF_SETTINGS
from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.obs import device as obs_device
from serenedb_tpu_torch.server import EsApi, HttpServer, PgServer
from serenedb_tpu_torch.server.client import PgClient, decode_row
from serenedb_tpu_torch.server.frontdoor import FrontDoor
from serenedb_tpu_torch.server.http_server import LegacyHttpServer
from serenedb_tpu_torch.utils import metrics
from serenedb_tpu_torch.utils.config import REGISTRY as SETTINGS

RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 30
WORDS = ("apple banana cherry quick brown fox jumps over lazy dog search "
         "engine database index query term").split()


def _bulk_body(n=120, seed=3):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        doc = {"id": i,
               "title": " ".join(rng.choice(WORDS, rng.integers(2, 6))),
               "body": " ".join(rng.choice(WORDS, rng.integers(3, 24))),
               "pages": int(rng.integers(10, 500))}
        if i % 11 == 0:
            doc["body"] = "quick brown fox jumps"           # ties
        lines.append(json.dumps({"index": {"_index": "books",
                                           "_id": str(i)}}))
        lines.append(json.dumps(doc))
    return "\n".join(lines) + "\n"


def _ndjson(items):
    return "\n".join(json.dumps(x) for x in items) + "\n"


MSEARCH = _ndjson([
    {"index": "books"}, {"query": {"match": {"body": "quick fox"}}},
    {"index": "books"}, {"query": {"match": {"body": "lazy dog"}},
                         "size": 5},
    {}, {"query": {"match": {"body": "apple banana"}}},
    {"index": "books"}, {"query": {"match": {"body": "search engine"}},
                         "size": 50},
    {"index": "nosuch"}, {"query": {"match_all": {}}},
    {"index": "books"}, {"query": {"term": {"title": "cherry"}}},
])

#: (name, method, path, body, ndjson) — read-only requests, after the load
REQUESTS = [
    ("count", "GET", "/books/_count", None, False),
    ("count_query", "POST", "/books/_count",
     {"query": {"match": {"body": "fox"}}}, False),
    ("match", "POST", "/books/_search",
     {"query": {"match": {"body": "quick fox"}}}, False),
    ("match_size", "POST", "/books/_search",
     {"query": {"match": {"body": "lazy dog cherry"}}, "size": 40}, False),
    ("bool", "POST", "/books/_search",
     {"query": {"bool": {"must": [{"match": {"body": "quick"}}],
                         "filter": [{"range": {"pages": {"gte": 100}}}]}}},
     False),
    ("term", "POST", "/books/_search",
     {"query": {"term": {"title": "fox"}}, "size": 20}, False),
    ("query_string", "POST", "/books/_search",
     {"query": {"query_string": {"default_field": "body",
                                 "query": "quick -fox"}}}, False),
    ("query_string_fields", "POST", "/books/_search",
     {"query": {"query_string": {"default_field": "body",
                                 "query": "title:(fox^5 OR dog)"}}}, False),
    ("query_string_and", "POST", "/books/_search",
     {"query": {"query_string": {"default_field": "body",
                                 "query": "quick fox",
                                 "default_operator": "AND"}}}, False),
    ("sort", "POST", "/books/_search",
     {"query": {"match": {"body": "dog"}}, "sort": [{"pages": "asc"}],
      "size": 7}, False),
    ("msearch", "POST", "/_msearch", MSEARCH, True),
    ("msearch_index", "POST", "/books/_msearch", MSEARCH, True),
    ("analyze", "POST", "/_analyze",
     {"analyzer": "standard", "text": "The Quick Brown Foxes"}, False),
    ("get_doc", "GET", "/books/_doc/7", None, False),
    ("missing_index", "POST", "/nosuch/_search", {}, False),
]


def _request(port, method, path, body=None, ndjson=False):
    data, headers = None, {}
    if body is not None:
        data = body.encode() if isinstance(body, str) else \
            json.dumps(body).encode()
        headers["Content-Type"] = "application/x-ndjson" if ndjson \
            else "application/json"
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                               headers=headers, method=method)
    try:
        with urllib.request.urlopen(r, timeout=TIMEOUT) as resp:
            raw = resp.read().decode()
            return resp.status, json.loads(raw)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _same(got, want, path="$"):
    """Equal JSON, `took` left out, floats to the search rule."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        keys = set(want) - {"took"}
        assert set(got) - {"took"} == keys, (path, sorted(got), sorted(want))
        for k in keys:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), path
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


class _Stack:
    """One package's servers over one database: a FrontDoor hosting HTTP
    and a PgServer, and a LegacyHttpServer beside it."""

    def __init__(self, db, front_cls, pg_cls, legacy_cls):
        self.db = db
        self.pg = pg_cls(db, "127.0.0.1", 0)
        self.front = front_cls(db, http_port=0, pg=self.pg)
        self.legacy = legacy_cls(db, "127.0.0.1", 0)
        self.front.start()
        self.legacy.start()

    def stop(self):
        self.legacy.stop()
        self.front.stop()


@pytest.fixture(scope="module")
def stacks():
    # the result cache off in both packages: every request executes, and
    # these requests leave no entries in the process-wide caches
    cache = [(reg, reg.get_global("serene_result_cache"))
             for reg in (REF_SETTINGS, SETTINGS)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_bm25, "DENSE_HBM_BUDGET", 0)
        mp.setattr(port_bm25, "DENSE_HBM_BUDGET", 0)
        for reg, _ in cache:
            reg.set_global("serene_result_cache", False)
        ref = _Stack(RefDatabase(), RefFrontDoor, RefPgServer,
                     RefLegacyHttpServer)
        port = _Stack(Database(device="cpu"), FrontDoor, PgServer,
                      LegacyHttpServer)
        try:
            for st in (ref, port):
                status, body = _request(st.front.port, "PUT", "/books")
                assert status == 200, body
                status, body = _request(st.front.port, "POST", "/_bulk",
                                        _bulk_body(), ndjson=True)
                assert status == 200 and not body["errors"], body
                assert _request(st.front.port, "POST",
                                "/books/_refresh")[0] == 200
            yield ref, port
        finally:
            port.stop()
            ref.stop()
            for reg, old in cache:
                reg.set_global("serene_result_cache", old)


@pytest.mark.parametrize("server", ["front", "legacy"])
@pytest.mark.parametrize("name,method,path,body,ndjson", REQUESTS,
                         ids=[r[0] for r in REQUESTS])
def test_es_responses_equal_reference(stacks, server, name, method, path,
                                      body, ndjson):
    ref, port = stacks
    want = _request(getattr(ref, server).port, method, path, body, ndjson)
    got = _request(getattr(port, server).port, method, path, body, ndjson)
    assert got[0] == want[0], (name, got, want)
    _same(got[1], want[1])


def test_msearch_in_process_coalesces_into_the_pool(stacks):
    """`EsApi.msearch` in process over the same database: equal to the
    reference's and to each item run alone; the items reach the posting
    pool."""
    ref, port = stacks
    body = _ndjson([
        {"index": "books"}, {"query": {"match": {"body": "database index"}},
                             "size": 30},
        {"index": "books"}, {"query": {"match": {"body": "term query"}}},
        {"index": "books"}, {"query": {"match": {"body": "jumps over"}},
                             "size": 3}])
    d0 = metrics.POSTING_POOL_DEVICE_QUERIES.value
    got = EsApi(port.db).msearch(body)
    _same(got, RefEsApi(ref.db).msearch(body))
    assert metrics.POSTING_POOL_DEVICE_QUERIES.value > d0
    api = EsApi(port.db)
    lines = body.strip().split("\n")
    for i, resp in enumerate(got["responses"]):
        head, q = json.loads(lines[2 * i]), json.loads(lines[2 * i + 1])
        if resp["status"] == 200:
            _same(resp, {**api.search(head.get("index", "books"), q),
                         "status": 200})


def test_device_and_stats_carry_the_posting_pool(stacks):
    _, port = stacks
    _request(port.front.port, "POST", "/_msearch", MSEARCH, True)
    status, dev = _request(port.front.port, "GET", "/device")
    assert status == 200 and dev["posting_pool"]["pages_used"] > 0
    status, stats = _request(port.front.port, "GET", "/_stats")
    assert status == 200 and "posting_pool" in stats["device"]
    assert obs_device.stats_section()["posting_pool"]["resident_terms"] > 0


PG_STATEMENTS = [
    ("SELECT \"_id\", bm25(body) AS s FROM books WHERE body @@ 'quick | fox' "
     "ORDER BY s DESC, \"_id\" LIMIT 10"),
    "SELECT count(*) FROM books WHERE body @@ 'lazy & dog'",
    "SELECT \"_id\", pages FROM books WHERE pages < 40 ORDER BY pages, \"_id\"",
    "SELECT nosuch FROM books",
]


def _rows(msgs):
    """(kind, payload) messages with every DataRow decoded to text."""
    return [(kind, decode_row(p) if kind == b"D" else p)
            for kind, p in msgs]


@pytest.mark.parametrize("sql", PG_STATEMENTS)
def test_pg_wire_bytes_equal_reference(stacks, sql):
    """The same statement over the PG wire of both front doors: the same
    messages, byte for byte, but the score text, which holds to the
    search rule; and the port's rows equal its own `execute`."""
    ref, port = stacks
    got, want = [], []
    for st, out in ((ref, want), (port, got)):
        c = PgClient(st.pg.port, "tester", timeout=TIMEOUT)
        try:
            out.extend(_rows(c.query(sql)))
        finally:
            c.close()
    assert [m[0] for m in got] == [m[0] for m in want]
    for (kind, g), (_, w) in zip(got, want):
        if kind == b"D" and "bm25" in sql:
            assert g[0] == w[0]
            np.testing.assert_allclose(float(g[1]), float(w[1]), rtol=RTOL,
                                       atol=ATOL)
        else:
            assert g == w, kind
    if "nosuch" not in sql:
        rows = port.db.connect().execute(sql).rows()
        data = [m[1] for m in got if m[0] == b"D"]
        assert len(data) == len(rows)
        assert [r[0] for r in data] == [str(r[0]) for r in rows]


def test_http_server_facade_picks_the_front_door(stacks):
    _, port = stacks
    srv = HttpServer(port.db, port=0)
    srv.start()
    try:
        assert isinstance(srv._impl, FrontDoor)
        status, body = _request(srv.port, "GET", "/books/_count")
        assert status == 200 and body["count"] == 120
    finally:
        srv.stop()
