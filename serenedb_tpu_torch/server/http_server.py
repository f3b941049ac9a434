"""Copied from serenedb_tpu/server/http_server.py.

HTTP routing for the ES-compatible API (+ /_sql and health) and the
legacy thread-per-connection server.

Reference analog: server/network/http/ (h1 codec + router with :param
patterns; SURVEY.md §2.2). The route table lives here as a PURE
request→response function (`Router.handle`: bytes in, status/bytes out,
no transport knowledge), shared by BOTH transports:

- `server/frontdoor.py` — the asyncio front door (default,
  `serene_frontdoor = on`): connections are event-loop tasks, the
  route runs on the executor via run_in_executor.
- `LegacyHttpServer` below — stdlib ThreadingHTTPServer, kept ONE
  release as the bit-identity parity oracle (`serene_frontdoor = off`);
  same Router, so the two paths cannot drift.

`HttpServer` is the facade every caller constructs; the setting picks
the transport at construction time.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .. import errors
from ..engine import Database
from ..utils import log, metrics
from ..utils.config import REGISTRY as _settings
from .es_api import EsApi, EsError

JSON_CTYPE = "application/json"


def _json_body(body: str) -> Optional[dict]:
    if not body.strip():
        return None
    try:
        return json.loads(body)
    except json.JSONDecodeError as e:
        raise EsError(400, "parsing_exception", f"invalid JSON: {e}")


def encode_payload(payload) -> bytes:
    data = (json.dumps(payload) if not isinstance(payload, (str, bytes))
            else payload)
    return data.encode() if isinstance(data, str) else data


class Router:
    """The entire HTTP surface as a pure function: (method, target,
    body) → (status, body bytes, content type). No sockets, no
    threads — both transports call this and nothing else, which is
    what makes the frontdoor-on/off parity a structural guarantee
    rather than a test hope."""

    def __init__(self, es: EsApi):
        self.es = es

    def handle(self, method: str, target: str,
               body: bytes = b"") -> tuple[int, bytes, str]:
        url = urlparse(target)
        parts = [p for p in url.path.split("/") if p]
        try:
            raw = body.decode() if isinstance(body, (bytes, bytearray)) \
                else (body or "")
            status, payload, ctype = self._route(
                method, parts, parse_qs(url.query), raw)
        except EsError as e:
            status, payload, ctype = e.status, e.body(), JSON_CTYPE
        except errors.SqlError as e:
            status, payload, ctype = 400, {"error": {
                "type": "sql_exception", "reason": e.message,
                "sqlstate": e.sqlstate}, "status": 400}, JSON_CTYPE
        except Exception as e:  # pragma: no cover
            log.error("http", f"internal error: {e!r}")
            status, payload, ctype = 500, {
                "error": {"type": "internal_error",
                          "reason": str(e)}, "status": 500}, JSON_CTYPE
        return status, encode_payload(payload), ctype

    # -- routing -----------------------------------------------------------

    def _route(self, method: str, p: list[str], q: dict,
               body: str) -> tuple[int, object, str]:
        es = self.es
        if not p:
            return 200, {"name": "serenedb_tpu", "cluster_name":
                         "serenedb_tpu", "version": {"number": "8.0.0"},
                         "tagline": "You Know, for Search"}, JSON_CTYPE
        if p[0] == "_cluster" and len(p) > 1 and p[1] == "health":
            return 200, es.cluster_health(), JSON_CTYPE
        if p[0] == "trace" and method == "GET" and \
                (len(p) == 1 or
                 (len(p) == 2 and (p[1] == "last" or p[1].isdigit()))):
            # flight-recorder timelines as Chrome trace-event JSON:
            # /trace lists recorded entries, /trace/<id> (or
            # /trace/last) returns one timeline loadable in Perfetto /
            # chrome://tracing. Deliberately NARROW (exact /trace, or a
            # numeric/last second segment, GET only) so an ES index
            # named "trace" keeps its whole /trace/_search, /trace/_doc
            # ... API surface — the same tradeoff as /metrics above.
            from ..obs.trace import FLIGHT, chrome_trace, flight_summary
            if len(p) == 1:
                return 200, [flight_summary(e)
                             for e in FLIGHT.snapshot()], JSON_CTYPE
            entry = FLIGHT.last() if p[1] == "last" \
                else FLIGHT.get(int(p[1]))
            if entry is None:
                raise EsError(404, "resource_not_found_exception",
                              f"no recorded trace [{p[1]}] (the "
                              "flight recorder keeps the last "
                              "serene_flight_recorder_queries "
                              "completed queries)")
            return 200, chrome_trace(entry), JSON_CTYPE
        if p == ["device"] and method == "GET":
            # device telemetry (obs/device.py): per-device dispatch /
            # transfer / HBM-estimate rows, the XLA compile ledger and
            # cache summaries. Exactly GET /device — deeper paths still
            # reach the ES API for an index of that name (the /metrics
            # tradeoff).
            from ..obs.device import stats_section
            return 200, stats_section(), JSON_CTYPE
        if p == ["progress"] and method == "GET":
            # live query progress (sdb_query_progress as JSON): one
            # object per running statement with its current operator,
            # morsel/row/byte counters and accounted live/peak bytes.
            # Exactly GET /progress — deeper paths still reach the ES
            # API for an index of that name (the /metrics tradeoff).
            from ..obs.resources import ACTIVE
            return 200, ACTIVE.snapshot(), JSON_CTYPE
        if p == ["metrics"] and method == "GET":
            # Prometheus exposition: the whole gauge registry (one
            # consistent snapshot) + per-statement series (obs/export).
            # Exactly /metrics — deeper paths (/metrics/_doc/1) still
            # reach the ES API for an index of that name.
            from ..obs.export import prometheus_text
            return 200, prometheus_text(), \
                "text/plain; version=0.0.4; charset=utf-8"
        if p[0] == "_cat" and len(p) > 1:
            if p[1] == "indices":
                rows = es.cat_indices()
            elif p[1] == "health":
                rows = es.cat_health()
            elif p[1] == "count":
                rows = es.cat_count(p[2] if len(p) > 2 else None)
            else:
                raise EsError(400, "illegal_argument_exception",
                              f"unknown _cat endpoint [{p[1]}]")
            if "format" in q and q["format"][0] == "json":
                return 200, rows, JSON_CTYPE
            if p[1] == "indices":
                # fixed 4-column layout — positional consumers rely on
                # docs.count being field 4
                text = "\n".join(
                    f"{r['health']} {r['status']} {r['index']} "
                    f"{r['docs.count']}" for r in rows) + "\n"
            else:
                text = "\n".join(" ".join(str(v) for v in r.values())
                                 for r in rows) + "\n"
            return 200, text, "text/plain"
        if p[0] == "_msearch" and method == "POST":
            return 200, es.msearch(body), JSON_CTYPE
        if p[0] == "_analyze" and method in ("GET", "POST"):
            return 200, es.analyze(_json_body(body)), JSON_CTYPE
        if p[0] == "_bulk" and method == "POST":
            return 200, es.bulk(body), JSON_CTYPE
        if p[0] == "_search" and len(p) > 1 and p[1] == "scroll":
            b = _json_body(body) or {}
            if method == "DELETE":
                return 200, es.delete_scroll(
                    b.get("scroll_id", [])), JSON_CTYPE
            size = b.get("size")
            sid = b.get("scroll_id", "")
            if isinstance(sid, list):
                sid = sid[0] if sid else ""
            return 200, es.search_scroll_next(
                str(sid), int(size) if size is not None else None,
                b.get("scroll")), JSON_CTYPE
        if p[0] == "_stats":
            # ES index stats, extended with the engine's observability
            # section (gauge snapshot + sdb_stat_statements) — ES
            # clients read _all/indices and ignore the extra keys
            from ..obs.export import stats_json
            payload = es.stats()
            payload.update(stats_json())
            return 200, payload, JSON_CTYPE
        if p[0] == "_mget" and method == "POST":
            b = _json_body(body) or {}
            return 200, es.mget(b.get("index"), b), JSON_CTYPE
        if p[0] == "_sql" and method == "POST":
            b = _json_body(body) or {}
            # fresh connection per request: /_sql session state (BEGIN,
            # SET, failed-txn) must never poison the shared API connection
            conn = es.db.connect()
            res = conn.execute(b.get("query", ""))
            return 200, {
                "columns": [{"name": n} for n in res.names],
                "rows": [list(r) for r in res.rows()]}, JSON_CTYPE
        if p[0] == "_test" and len(p) > 1:
            return self._test_endpoint(method, p[1:], q, body)
        if p[0].startswith("_"):
            raise EsError(400, "illegal_argument_exception",
                          f"unknown endpoint [{p[0]}]")

        index = p[0]
        rest = p[1:]
        if not rest:
            if method == "PUT":
                return 200, es.create_index(index, _json_body(body)), \
                    JSON_CTYPE
            if method == "DELETE":
                return 200, es.delete_index(index), JSON_CTYPE
            if method == "HEAD":
                return (200 if es.exists(index) else 404), "", JSON_CTYPE
            if method == "GET":
                return 200, es.mapping(index), JSON_CTYPE
            raise EsError(405, "method_not_allowed",
                          f"{method} not allowed on /{index}")
        verb = rest[0]
        if verb == "_doc":
            if method in ("PUT", "POST"):
                doc = _json_body(body) or {}
                doc_id = rest[1] if len(rest) > 1 else None
                return 201, es.index_doc(index, doc, doc_id), JSON_CTYPE
            if method == "GET" and len(rest) > 1:
                r = es.get_doc(index, rest[1])
                return (200 if r.get("found") else 404), r, JSON_CTYPE
            if method == "DELETE" and len(rest) > 1:
                return 200, es.delete_doc(index, rest[1]), JSON_CTYPE
            raise EsError(405, "method_not_allowed",
                          f"{method} on _doc requires an id")
        if verb == "_delete_by_query" and method == "POST":
            return 200, es.delete_by_query(index, _json_body(body)), \
                JSON_CTYPE
        if verb == "_update" and method == "POST" and len(rest) > 1:
            return 200, es.update_doc(index, rest[1],
                                      _json_body(body) or {}), JSON_CTYPE
        if verb == "_search":
            b = _json_body(body)
            if "scroll" in q:
                return 200, es.search_scroll_start(
                    index, b, q["scroll"][0]), JSON_CTYPE
            return 200, es.search(index, b), JSON_CTYPE
        if verb == "_mget" and method == "POST":
            return 200, es.mget(index, _json_body(body) or {}), JSON_CTYPE
        if verb == "_msearch" and method == "POST":
            return 200, es.msearch(body, default_index=index), JSON_CTYPE
        if verb == "_analyze" and method in ("GET", "POST"):
            return 200, es.analyze(_json_body(body), index), JSON_CTYPE
        if verb == "_stats":
            return 200, es.stats(index), JSON_CTYPE
        if verb == "_count":
            return 200, es.count(index, _json_body(body)), JSON_CTYPE
        if verb == "_refresh":
            return 200, es.refresh(index), JSON_CTYPE
        if verb == "_mapping":
            return 200, es.mapping(index), JSON_CTYPE
        if verb == "_bulk" and method == "POST":
            # index-scoped bulk: inject default _index
            lines = []
            for ln in body.split("\n"):
                if not ln.strip():
                    continue
                obj = json.loads(ln)
                op = next(iter(obj))
                if op in ("index", "create", "delete", "update") and \
                        isinstance(obj[op], dict) and "_index" not in obj[op]:
                    obj[op]["_index"] = index
                lines.append(json.dumps(obj))
            return 200, es.bulk("\n".join(lines)), JSON_CTYPE
        raise EsError(400, "illegal_argument_exception",
                      f"unknown verb [{verb}]")

    def _test_endpoint(self, method: str, parts: list[str], q: dict,
                       body: str) -> tuple[int, object, str]:
        """Transport test endpoints (reference:
        server/network/http/test/handlers.h: /_test/{echo,ping,...})."""
        if parts[0] == "ping":
            return 200, {"ok": True}, JSON_CTYPE
        if parts[0] == "echo":
            return 200, body or "{}", JSON_CTYPE
        if parts[0] == "sleep":
            # deterministic slow handler for transport concurrency
            # tests (serialized-per-connection vs concurrent-across-
            # connections); capped so a stray client can't park an
            # executor thread for long
            ms = min(2000, int(q.get("ms", ["100"])[0]))
            time.sleep(ms / 1000.0)
            return 200, {"ok": True, "slept_ms": ms}, JSON_CTYPE
        raise EsError(404, "not_found", f"unknown test [{parts[0]}]")


class Handler(BaseHTTPRequestHandler):
    server_version = "serenedb-tpu/0.1"
    protocol_version = "HTTP/1.1"
    router: Router = None  # class attr set by LegacyHttpServer

    def log_message(self, fmt, *args):
        log.debug("http", fmt % args)

    def _body(self) -> bytes:
        ln = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(ln) if ln else b""

    def _dispatch(self, method: str):
        with metrics.HTTP_CONNECTIONS.scoped():
            status, data, ctype = self.router.handle(
                method, self.path, self._body())
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-Elastic-Product", "Elasticsearch")
            self.end_headers()
            self.wfile.write(data)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_PUT(self):
        self._dispatch("PUT")

    def do_DELETE(self):
        self._dispatch("DELETE")

    def do_HEAD(self):
        self._dispatch("HEAD")


class LegacyHttpServer:
    """stdlib ThreadingHTTPServer transport — one OS thread per
    connection. Kept ONE release as the parity oracle for the asyncio
    front door (`serene_frontdoor = off`); scheduled for removal once
    the frontdoor has soaked."""

    def __init__(self, db: Database, host: str = "127.0.0.1",
                 port: int = 0):
        self.db = db
        handler = type("BoundHandler", (Handler,),
                       {"router": Router(EsApi(db))})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="serene-http", daemon=True)
        self._thread.start()
        log.info("http", f"listening on port {self.port} (legacy "
                 "thread-per-connection tier)")

    def stop(self):
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=10)
            if self._thread.is_alive():  # pragma: no cover
                # the known legacy leak (a stuck per-connection thread
                # outlives shutdown) — loud, because the frontdoor was
                # built to make this impossible
                log.error("http", "legacy HTTP thread leaked past "
                          "shutdown (use serene_frontdoor=on)")
        self.httpd.server_close()


class HttpServer:
    """The facade every caller constructs: `serene_frontdoor` (GLOBAL,
    default on) picks the asyncio front door; off falls back to the
    legacy ThreadingHTTPServer parity oracle. Same constructor, same
    start()/stop()/.port surface either way."""

    def __init__(self, db: Database, host: str = "127.0.0.1",
                 port: int = 0):
        self.db = db
        if bool(_settings.get_global("serene_frontdoor")):
            from .frontdoor import FrontDoor
            self._impl = FrontDoor(db, host=host, http_port=port)
        else:
            self._impl = LegacyHttpServer(db, host, port)

    @property
    def port(self) -> int:
        return self._impl.port

    def start(self):
        self._impl.start()

    def stop(self):
        self._impl.stop()
