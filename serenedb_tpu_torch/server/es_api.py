"""Copied from serenedb_tpu/server/es_api.py.

Elasticsearch-compatible REST API.

Reference analog: server/network/http/es/ — `_bulk`, `_doc`, `_search`
(+DSL→engine translation), `_count`, `_cat/*`, `_cluster/*`, `_mapping`,
`_refresh` (handlers.cpp:1383-1458, dsl.cpp; SURVEY.md §2.2).

Model: an ES index is a table whose columns grow dynamically from indexed
documents (`_id` TEXT + `_source` TEXT + one column per scalar field);
text fields get inverted indexes and the DSL translates onto the engine's
search surface (match → `@@` OR-query, match_phrase → `##`, bool →
AND/OR/NOT, range/term → SQL predicates) with BM25 scores.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Any, Optional

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..columnar.column import Batch, Column
from ..engine import Connection, Database, MemTable, StoredTable


class EsError(Exception):
    def __init__(self, status: int, kind: str, reason: str):
        super().__init__(reason)
        self.status = status
        self.kind = kind
        self.reason = reason

    def body(self) -> dict:
        return {"error": {"type": self.kind, "reason": self.reason},
                "status": self.status}


class EsApi:
    def __init__(self, db: Database):
        self.db = db
        self.conn = db.connect()
        # reentrant: update_doc holds it across a read-merge-write
        # while _index_doc_locked may re-enter via create_index
        self._lock = threading.RLock()
        self._scrolls: dict[str, dict] = {}
        #: per-thread READ connections (see _rconn)
        self._tl = threading.local()

    def _rconn(self) -> Connection:
        """Per-thread read connection for the search paths. Concurrent
        _search/_msearch items run on server and worker-pool threads, and
        a Connection carries per-statement session state (the
        CURRENT_CONNECTION contextvar target, now() stability, cancel
        flag) — sharing self.conn across threads would race it. Reads get
        a thread-cached connection instead; writes keep self.conn under
        self._lock. Thread count is bounded (pool workers + HTTP handler
        threads), and dead threads' connections retire via their weakref
        finalizers."""
        conn = getattr(self._tl, "conn", None)
        if conn is None:
            conn = self._tl.conn = self.db.connect()
        return conn

    # -- index management --------------------------------------------------

    def _table(self, index: str, create: bool = False) -> MemTable:
        key = index.lower()
        with self.db.lock:
            t = self.db.schemas["main"].tables.get(key)
        if t is None:
            if not create:
                raise EsError(404, "index_not_found_exception",
                              f"no such index [{index}]")
            self.create_index(index)
            with self.db.lock:
                t = self.db.schemas["main"].tables.get(key)
        return t

    def create_index(self, index: str, body: Optional[dict] = None) -> dict:
        if not re.match(r"^[a-z][a-z0-9_\-]*$", index):
            raise EsError(400, "invalid_index_name_exception",
                          f"invalid index name [{index}]")
        with self._lock:
            try:
                self.conn.execute(
                    f'CREATE TABLE "{index}" ("_id" TEXT, "_source" TEXT)')
            except errors.SqlError as e:
                if e.sqlstate == errors.DUPLICATE_TABLE:
                    raise EsError(400, "resource_already_exists_exception",
                                  f"index [{index}] already exists")
                raise
            props = ((body or {}).get("mappings", {}) or {}) \
                .get("properties", {}) or {}
            t = self._table(index)
            for fname, fdef in props.items():
                ftype = (fdef or {}).get("type", "text")
                self._ensure_column(t, fname, _es_type_to_sql(ftype),
                                    text_index=(ftype != "dense_vector"))
                if ftype == "dense_vector":
                    dims = int((fdef or {}).get("dims", 0))
                    opts = f" WITH (dim = {dims})" if dims else ""
                    self.conn.execute(
                        f'CREATE INDEX ON {_ident(t.name)} USING ivf '
                        f'({_ident(fname)}){opts}')
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": index}

    def delete_index(self, index: str) -> dict:
        self._table(index)
        self.conn.execute(f'DROP TABLE "{index}"')
        return {"acknowledged": True}

    def exists(self, index: str) -> bool:
        try:
            self._table(index)
            return True
        except EsError:
            return False

    def mapping(self, index: str) -> dict:
        t = self._table(index)
        props = {}
        for name, typ in zip(t.column_names, t.column_types):
            if name.startswith("_"):
                continue
            props[name] = {"type": _sql_type_to_es(typ)}
        return {index: {"mappings": {"properties": props}}}

    def _ensure_column(self, t: MemTable, name: str, typ: dt.SqlType,
                       text_index: bool = True):
        if name in t.column_names:
            return
        # quiesced([t]) — not db.lock — excludes concurrent DML writers
        # of THIS table: a read-modify-write under db.lock alone would
        # republish a stale batch over rows an insert just committed
        with self.db.quiesced([t]):
            full = t.full_batch()
            if name in full.names:
                return
            col = Column.from_pylist([None] * full.num_rows, typ)
            t.replace(Batch(list(full.names) + [name],
                            list(full.columns) + [col]),
                      rows_preserved=True)
        if text_index and typ.is_string and not name.startswith("_"):
            # text fields get inverted indexes so match/bm25 use the TPU
            # scoring path (refreshed by maintenance / _refresh)
            try:
                self.conn.execute(
                    f'CREATE INDEX ON "{t.name}" USING inverted ("{name}")')
            except errors.SqlError:
                pass
            if isinstance(t, StoredTable) and self.db.store is not None:
                from ..storage.store import table_def
                key = t.key
                tdef = table_def(key, t.table_id, t.column_names,
                                 t.column_types, getattr(t, "table_meta", {}),
                                 self.db.store.ticks.current())
                self.db.store.write_snapshot(t.table_id, t.full_batch())
                tdef["checkpoint_tick"] = self.db.store.ticks.current()
                self.db.store.update_meta(
                    lambda m: m["tables"].__setitem__(key, tdef))

    # -- document indexing -------------------------------------------------

    def index_doc(self, index: str, doc: dict,
                  doc_id: Optional[str] = None) -> dict:
        with self._lock:
            return self._index_doc_locked(index, doc, doc_id)

    def _index_doc_locked(self, index: str, doc: dict,
                          doc_id: Optional[str] = None) -> dict:
        """index_doc body; caller holds self._lock."""
        t = self._table(index, create=True)
        doc_id = doc_id or _gen_id()
        self._delete_by_id(t, doc_id)
        row = {"_id": doc_id, "_source": json.dumps(doc)}
        for k, v in doc.items():
            if isinstance(v, list) and v and \
                    all(isinstance(x, (int, float)) and
                        not isinstance(x, bool) for x in v):
                # numeric arrays = dense vectors, stored as JSON text
                self._ensure_column(t, k, dt.VARCHAR, text_index=False)
                row[k] = json.dumps(v)
                continue
            if isinstance(v, (dict, list)):
                continue  # other objects/arrays live in _source only
            self._ensure_column(t, k, _value_sql_type(v))
            row[k] = v
        incoming = Batch.from_pydict(
            {name: [row.get(name)] for name in t.column_names})
        self.conn._insert_batch(t, incoming)
        return {"_index": index, "_id": doc_id, "result": "created",
                "_version": 1, "_shards": {"total": 1, "successful": 1,
                                           "failed": 0}}

    def update_doc(self, index: str, doc_id: str, body: dict) -> dict:
        """_update: partial-document merge, script-free (reference: the ES
        update action). `doc` merges into the existing source; a missing
        doc falls back to `upsert` (or 404 without one);
        doc_as_upsert=true uses `doc` for both. Read-merge-write runs
        under one lock so concurrent updates never lose fields."""
        if not isinstance(body, dict):
            raise EsError(400, "parsing_exception",
                          "_update body must be a JSON object")
        partial = body.get("doc")
        upsert = body.get("upsert")
        if partial is not None and not isinstance(partial, dict):
            raise EsError(400, "parsing_exception",
                          "_update doc must be a JSON object")
        if upsert is not None and not isinstance(upsert, dict):
            raise EsError(400, "parsing_exception",
                          "_update upsert must be a JSON object")
        if partial is None and upsert is None:
            raise EsError(400, "illegal_argument_exception",
                          "_update requires doc or upsert")
        can_create = upsert is not None or bool(body.get("doc_as_upsert"))
        self._table(index, create=can_create)   # 404 unless upserting
        with self._lock:
            existing = self.get_doc(index, doc_id)
            if existing.get("found"):
                merged = dict(existing["_source"])
                merged.update(partial or {})
                result = "updated"
                if merged == existing["_source"]:
                    result = "noop"
            elif body.get("doc_as_upsert") and partial is not None:
                merged = dict(partial)
                result = "created"
            elif upsert is not None:
                merged = dict(upsert)
                result = "created"
            else:
                raise EsError(404, "document_missing_exception",
                              f"[{doc_id}]: document missing")
            if result != "noop":
                self._index_doc_locked(index, merged, doc_id)
        return {"_index": index, "_id": doc_id, "result": result,
                "_version": 1,
                "_shards": {"total": 1,
                            "successful": 0 if result == "noop" else 1,
                            "failed": 0}}

    def get_doc(self, index: str, doc_id: str) -> dict:
        t = self._table(index)
        full = t.full_batch(["_id", "_source"])
        ids = full.column("_id").to_pylist()
        try:
            i = ids.index(doc_id)
        except ValueError:
            return {"_index": index, "_id": doc_id, "found": False}
        return {"_index": index, "_id": doc_id, "found": True,
                "_source": json.loads(full.column("_source").decode(i))}

    def delete_doc(self, index: str, doc_id: str) -> dict:
        t = self._table(index)
        with self._lock:
            n = self._delete_by_id(t, doc_id)
        return {"_index": index, "_id": doc_id,
                "result": "deleted" if n else "not_found"}

    def _delete_by_id(self, t: MemTable, doc_id: str) -> int:
        esc = doc_id.replace("'", "''")
        res = self.conn.execute(
            f'DELETE FROM "{t.name}" WHERE "_id" = \'{esc}\'')
        return int(res.command_tag.split()[-1])

    def bulk(self, body: str) -> dict:
        lines = [ln for ln in body.split("\n") if ln.strip()]
        items = []
        had_errors = False
        i = 0
        while i < len(lines):
            action = json.loads(lines[i])
            i += 1
            op = next(iter(action))
            meta = action[op] if isinstance(action[op], dict) else {}
            index = meta.get("_index")
            doc_id = meta.get("_id")
            # consume the doc line BEFORE validation so a failed item never
            # desyncs the ndjson stream
            doc_line = None
            if op in ("index", "create", "update") and i < len(lines):
                doc_line = lines[i]
                i += 1
            try:
                if index is not None and \
                        not re.match(r"^[a-z][a-z0-9_\-]*$", str(index)):
                    raise EsError(400, "invalid_index_name_exception",
                                  f"invalid index name [{index}]")
                if op in ("index", "create"):
                    doc = json.loads(doc_line)
                    r = self.index_doc(index, doc, doc_id)
                    items.append({op: {**r, "status": 201}})
                elif op == "delete":
                    r = self.delete_doc(index, doc_id)
                    items.append({op: {**r, "status": 200}})
                elif op == "update":
                    r = self.update_doc(index, doc_id,
                                        json.loads(doc_line))
                    items.append({op: {**r, "status": 200}})
                else:
                    raise EsError(400, "illegal_argument_exception",
                                  f"unknown bulk op [{op}]")
            except EsError as e:
                had_errors = True
                items.append({op: {"_index": index, "_id": doc_id,
                                   "status": e.status,
                                   "error": e.body()["error"]}})
            except errors.SqlError as e:
                # per-item failure, never abort a partially-applied batch
                had_errors = True
                items.append({op: {"_index": index, "_id": doc_id,
                                   "status": 400,
                                   "error": {"type": "mapper_parsing_exception",
                                             "reason": e.message}}})
        return {"took": 1, "errors": had_errors, "items": items}

    # -- search ------------------------------------------------------------

    def delete_by_query(self, index: str, body: Optional[dict]) -> dict:
        """_delete_by_query: DSL → DELETE (reference: the ES task-based
        deletion; ours is synchronous). max_docs caps the deletion by
        _id order."""
        t = self._table(index)
        body = body or {}
        if not isinstance(body, dict):
            raise EsError(400, "parsing_exception",
                          "_delete_by_query body must be a JSON object")
        q = body.get("query")
        if q is None:
            raise EsError(400, "parsing_exception",
                          "_delete_by_query requires a query")
        where, _ = self._translate_query(q)
        max_docs = body.get("max_docs")
        with self._lock:
            if max_docs is not None:
                # cap via an id subselect (deterministic by _id order)
                inner = f'SELECT "_id" FROM {_ident(t.name)}'
                if where:
                    inner += f" WHERE {where}"
                inner += f' ORDER BY "_id" LIMIT {int(max_docs)}'
                sql = (f'DELETE FROM {_ident(t.name)} WHERE "_id" IN '
                       f"({inner})")
            else:
                sql = f"DELETE FROM {_ident(t.name)}"
                if where:
                    sql += f" WHERE {where}"
            res = self.conn.execute(sql)
        deleted = int(res.command_tag.split()[-1])
        return {"took": 1, "timed_out": False, "total": deleted,
                "deleted": deleted, "failures": []}

    def refresh(self, index: Optional[str] = None) -> dict:
        self.conn.execute(f'VACUUM REFRESH "{index}"' if index
                          else "VACUUM REFRESH")
        return {"_shards": {"total": 1, "successful": 1, "failed": 0}}

    def count(self, index: str, body: Optional[dict] = None) -> dict:
        self._table(index)  # 404 for unknown index, not a SQL error
        where, _ = self._translate_query((body or {}).get("query"))
        sql = f'SELECT count(*) FROM "{index}"'
        if where:
            sql += f" WHERE {where}"
        n = self._rconn().execute(sql).scalar()
        return {"count": int(n),
                "_shards": {"total": 1, "successful": 1, "failed": 0}}

    def search(self, index: str, body: Optional[dict] = None) -> dict:
        body = body or {}
        t = self._table(index)
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        if "knn" in body:
            return self._search_knn(index, body, size, from_)
        if "_id" not in t.column_names or "_source" not in t.column_names:
            # a plain SQL table is not an ES document index — surface a
            # clear contract error instead of a cryptic 42703
            raise EsError(
                400, "illegal_argument_exception",
                f"[{index}] is a SQL table, not an ES document index — "
                "query it over the PG wire, or ingest documents through "
                "the ES API (_doc/_bulk) to search here")
        where, score_col = self._translate_query(body.get("query"))
        multi_claims = score_col if isinstance(score_col, list) else None
        cols = '"_id", "_source"'
        order = ""
        if score_col and multi_claims is None:
            cols += f", {score_col} AS _score"
            order = " ORDER BY _score DESC"
        sort = body.get("sort")
        if sort:
            order = " ORDER BY " + ", ".join(_sort_clause(s) for s in sort)
            multi_claims = None     # explicit sort: no score ordering
        sql = f'SELECT {cols} FROM "{index}"'
        if where:
            sql += f" WHERE {where}"
        if multi_claims is not None:
            # multi-field scoring, rank-first (Lucene BooleanQuery: doc
            # score = sum of its matching clauses' scores): one scored
            # pass per claim builds the score map, then the page is
            # assembled with BOUNDED fetches — scored candidates probe
            # WHERE membership in rank-ordered chunks with early exit,
            # and the zero-score tail pages through ORDER BY/LIMIT. No
            # whole-table id fetch, whatever the index size.
            scores: dict[str, float] = {}
            for f, w, pred in multi_claims:
                pass_sql = (f'SELECT "_id", bm25({_ident(f)}) '
                            f'FROM "{index}" WHERE {pred}')
                for did, sc in self._rconn().execute(pass_sql).rows():
                    if sc:
                        scores[did] = scores.get(did, 0.0) + w * float(sc)
            total_sql = f'SELECT count(*) FROM "{index}"'
            if where:
                total_sql += f" WHERE {where}"
            total = int(self._rconn().execute(total_sql).scalar())
            page = self._multi_claim_page(index, where, scores,
                                          from_ + size)[from_:from_ + size]
            rows = []
            if page:
                lits = ", ".join(_sql_str(d) for d in page)
                src = dict(self._rconn().execute(
                    f'SELECT "_id", "_source" FROM "{index}" '
                    f'WHERE "_id" IN ({lits})').rows())
                rows = [(d, src.get(d), scores.get(d, 0.0)) for d in page]
            score_col = "multi"
        else:
            sql += order + f" LIMIT {size} OFFSET {from_}"
            rows = list(self._rconn().execute(sql).rows())
            total_sql = f'SELECT count(*) FROM "{index}"'
            if where:
                total_sql += f" WHERE {where}"
            total = int(self._rconn().execute(total_sql).scalar())
        hits = []
        max_score = 0.0
        for row in rows:
            score = float(row[2]) if score_col and len(row) > 2 and \
                row[2] is not None else 1.0
            max_score = max(max_score, score)
            hits.append({"_index": index, "_id": row[0], "_score": score,
                         "_source": json.loads(row[1]) if row[1] else {}})
        return {
            "took": 1, "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": total, "relation": "eq"},
                     "max_score": max_score if hits else None,
                     "hits": hits},
        }

    def _multi_claim_page(self, index: str, where: str,
                          scores: dict[str, float],
                          needed: int) -> list[str]:
        """First `needed` WHERE-matching ids in (-score, id) order,
        fetched boundedly: positive-scored candidates are membership-
        checked in rank-ordered chunks (early exit once the page is
        covered), the zero-score middle pages via ORDER BY "_id" LIMIT,
        and negative-scored candidates close the ranking."""
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        pos = [d for d, s in ranked if s > 0]
        neg = [d for d, s in ranked if s < 0]

        def matching(cands: list, stop_at) -> list:
            out: list[str] = []
            for i in range(0, len(cands), 500):
                if stop_at is not None and len(out) >= stop_at:
                    break
                chunk = cands[i:i + 500]
                cond = '"_id" IN (%s)' % ", ".join(
                    _sql_str(d) for d in chunk)
                if where:
                    cond = f"({where}) AND {cond}"
                hit = {r[0] for r in self._rconn().execute(
                    f'SELECT "_id" FROM "{index}" WHERE {cond}').rows()}
                out.extend(d for d in chunk if d in hit)
            return out

        head = matching(pos, needed)
        if len(head) >= needed:
            return head[:needed]
        # ids whose accumulated score is exactly 0.0 (zero boosts) rank
        # with the unscored tail — they must stay IN the ORDER BY window
        scored_set = {d for d, s in scores.items() if s != 0.0}
        rest = needed - len(head)
        mid_sql = f'SELECT "_id" FROM "{index}"'
        if where:
            mid_sql += f" WHERE {where}"
        # over-fetch by the candidate count: every scored id that sneaks
        # into the window gets filtered back out client-side
        mid_sql += f' ORDER BY "_id" LIMIT {rest + len(scored_set)}'
        mid = [r[0] for r in self._rconn().execute(mid_sql).rows()
               if r[0] not in scored_set][:rest]
        seq = head + mid
        if len(seq) < needed and neg:
            seq += matching(neg, needed - len(seq))
        return seq[:needed]

    def _search_knn(self, index: str, body: dict, size: int,
                    from_: int) -> dict:
        """kNN search, optionally hybrid with a text query via RRF fusion
        (reference BASELINE config 5: BM25 + kNN with RRF top-k)."""
        knn = body["knn"]
        field = knn.get("field")
        qvec = json.dumps(knn.get("query_vector", []))
        k = int(knn.get("k", size))
        cand = max(k, int(knn.get("num_candidates", k * 4)))
        dist = f"vec_l2({_ident(field)}, {_sql_str(qvec)})"
        # no IS NOT NULL guard: it would block the IvfScan pushdown, and
        # both paths already handle NULL vectors (valid mask / NULLS LAST)
        sql = (f'SELECT "_id", "_source", {dist} AS _dist FROM '
               f'{_ident(index)} '
               f"ORDER BY _dist LIMIT {cand}")
        nprobe = knn.get("nprobe")
        conn = self._rconn()
        if nprobe is not None:
            conn.execute(f"SET serene_nprobe = {int(nprobe)}")
        try:
            knn_rows = [r for r in conn.execute(sql).rows()
                        if r[2] is not None]
        finally:
            if nprobe is not None:
                # 0 = back to the sdb_nprobe / built-in default chain
                conn.execute("SET serene_nprobe = 0")
        knn_ranked = [(r[0], r[1]) for r in knn_rows]
        if body.get("query") is None:
            hits = []
            page = knn_ranked[:k][from_:from_ + size]
            for off, (doc_id, src) in enumerate(page):
                d = float(knn_rows[from_ + off][2])
                hits.append({"_index": index, "_id": doc_id,
                             "_score": 1.0 / (1.0 + d),
                             "_source": json.loads(src) if src else {}})
            return _hits_response(hits, min(len(knn_ranked), k))
        # hybrid: text query ranking + knn ranking → reciprocal rank fusion
        text_res = self.search(index, {"query": body["query"],
                                       "size": cand, "from": 0})
        text_ranked = [(h["_id"], json.dumps(h["_source"]))
                       for h in text_res["hits"]["hits"]]
        RRF_K = 60
        scores: dict[str, float] = {}
        sources: dict[str, str] = {}
        for rank, (doc_id, src) in enumerate(knn_ranked):
            scores[doc_id] = scores.get(doc_id, 0.0) + 1.0 / (RRF_K + rank + 1)
            sources[doc_id] = src
        for rank, (doc_id, src) in enumerate(text_ranked):
            scores[doc_id] = scores.get(doc_id, 0.0) + 1.0 / (RRF_K + rank + 1)
            sources[doc_id] = src
        fused = sorted(scores.items(), key=lambda kv: -kv[1])
        hits = []
        for doc_id, score in fused[from_:from_ + size]:
            src = sources[doc_id]
            hits.append({"_index": index, "_id": doc_id, "_score": score,
                         "_source": json.loads(src) if src else {}})
        return _hits_response(hits, len(fused))

    # -- scroll ------------------------------------------------------------
    # (reference: ES _search?scroll + _search/scroll continuation)

    def _parse_keepalive(self, keep: str) -> float:
        import re as _re
        m = _re.match(r"^(\d+)(ms|s|m|h)?$", keep or "")
        if not m:
            return 60.0
        mult = {"ms": 0.001, "s": 1, "m": 60, "h": 3600}.get(
            m.group(2) or "s", 1)
        return min(float(m.group(1)) * mult, 24 * 3600)

    def _prune_scrolls(self):
        import time as _time
        now = _time.monotonic()
        for sid in [s for s, st in self._scrolls.items()
                    if st["expires"] < now]:
            del self._scrolls[sid]

    def search_scroll_start(self, index: str, body: Optional[dict],
                            keep: str) -> dict:
        import time as _time
        body = dict(body or {})
        size = int(body.get("size", 10))
        t = self._table(index)
        # materialize the whole match set up front (scroll = deep
        # pagination: the window must cover every hit, not a cap)
        body["size"] = max(t.row_count(), 1)
        body["from"] = 0
        res = self.search(index, body)
        hits = res["hits"]["hits"]
        sid = _gen_id()
        with self._lock:
            self._prune_scrolls()
            self._scrolls[sid] = {
                "hits": hits[size:],
                "total": res["hits"]["total"]["value"],
                "size": size,
                "keep": self._parse_keepalive(keep),
                "expires": _time.monotonic() + self._parse_keepalive(keep)}
        res["hits"]["hits"] = hits[:size]
        res["_scroll_id"] = sid
        return res

    def search_scroll_next(self, scroll_id: str,
                           size: Optional[int] = None,
                           keep: Optional[str] = None) -> dict:
        import time as _time
        with self._lock:
            self._prune_scrolls()
            st = self._scrolls.get(scroll_id)
            if st is None:
                raise EsError(404, "search_context_missing_exception",
                              f"No search context found for id [{scroll_id}]")
            # an active continuation refreshes the keepalive (ES semantics)
            ttl = self._parse_keepalive(keep) if keep else st["keep"]
            st["expires"] = _time.monotonic() + ttl
            page_size = size if size is not None else st["size"]
            page = st["hits"][:page_size]
            st["hits"] = st["hits"][page_size:]
            total = st["total"]
        out = _hits_response(page, total)
        out["_scroll_id"] = scroll_id
        return out

    def delete_scroll(self, scroll_ids) -> dict:
        if isinstance(scroll_ids, str):
            scroll_ids = [scroll_ids]
        freed = 0
        with self._lock:
            for sid in scroll_ids:
                if self._scrolls.pop(str(sid), None) is not None:
                    freed += 1
        return {"succeeded": freed > 0, "num_freed": freed}

    def mget(self, index: Optional[str], body: dict) -> dict:
        """ES shapes: {"ids": [...]} (index-scoped) or
        {"docs": [{"_index": ..., "_id": ...}, ...]} (per-doc index)."""
        wanted: list[tuple[str, str]] = []       # (index, id)
        if body.get("ids") is not None:
            if index is None:
                raise EsError(400, "action_request_validation_exception",
                              "index is missing")
            wanted = [(index, str(i)) for i in body["ids"]]
        else:
            for d in body.get("docs", []):
                doc_index = d.get("_index", index)
                doc_id = d.get("_id")
                if doc_index is None or doc_id is None:
                    raise EsError(400,
                                  "action_request_validation_exception",
                                  "_index and _id are required in docs")
                wanted.append((str(doc_index), str(doc_id)))
        lookups: dict[str, dict] = {}
        for idx_name in {w[0] for w in wanted}:
            t = self._table(idx_name)
            full = t.full_batch(["_id", "_source"])
            lookups[idx_name] = dict(zip(full.column("_id").to_pylist(),
                                         full.column("_source").to_pylist()))
        docs = []
        for idx_name, doc_id in wanted:
            src = lookups[idx_name].get(doc_id)
            if src is not None or doc_id in lookups[idx_name]:
                docs.append({"_index": idx_name, "_id": doc_id,
                             "found": True,
                             "_source": json.loads(src or "{}")})
            else:
                docs.append({"_index": idx_name, "_id": doc_id,
                             "found": False})
        return {"docs": docs}

    def stats(self, index: Optional[str] = None) -> dict:
        if index is not None:
            self._table(index)   # 404 for unknown index
        out = {}
        with self.db.lock:
            tables = list(self.db.schemas["main"].tables.items())
        for name, t in tables:
            if "_id" not in t.column_names:
                continue
            if index is not None and name != index.lower():
                continue
            out[name] = {"primaries": {
                "docs": {"count": t.row_count(), "deleted": 0},
                "store": {"size_in_bytes": sum(
                    c.data.nbytes for c in t.full_batch().columns)}}}
        return {"_all": {"primaries": {"docs": {"count": sum(
            v["primaries"]["docs"]["count"] for v in out.values())}}},
            "indices": out}

    def msearch(self, body: str, default_index: Optional[str] = None) -> dict:
        """_msearch: ndjson header/body pairs. Per-item errors are inline
        (ES semantics: a bad item never fails the whole request). Reference
        analog: the multi-search REST action the bulk/_msearch clients use."""
        # keep line positions: an EMPTY header line is valid ES syntax
        # ("use defaults"), so blanks must not be stripped before pairing
        lines = body.split("\n")
        # pop only the empty element from the terminal newline — a blank
        # line elsewhere is an empty header (valid) or empty body (error)
        if lines and not lines[-1].strip():
            lines.pop()
        if len(lines) % 2:
            raise EsError(400, "parsing_exception",
                          "_msearch body must be header/body line pairs")
        # two phases: (1) parse every header/body pair serially — a
        # malformed item becomes its own inline error response without
        # touching its siblings; (2) execute the valid items CONCURRENTLY
        # on the shared worker pool, so their top-k scans arrive at the
        # search batcher together and coalesce into shared scoring
        # dispatches (search/batcher.py). run_item swallows per-item
        # failures into inline responses — exceptions never cross item
        # boundaries, so a poisoned body in a coalesced batch can't fail
        # the request or its siblings (the batcher additionally retries a
        # failed dispatch serially per query).
        items: list[tuple] = []   # ("q", index, query) | ("err", response)
        for i in range(0, len(lines), 2):
            try:
                header = json.loads(lines[i]) if lines[i].strip() else {}
                if not lines[i + 1].strip():
                    raise EsError(400, "parsing_exception",
                                  "_msearch search body must not be empty")
                query = json.loads(lines[i + 1])
                if not isinstance(header, dict) or not isinstance(query, dict):
                    raise EsError(400, "parsing_exception",
                                  "_msearch lines must be JSON objects")
                index = header.get("index", default_index)
                if not index:
                    raise EsError(400, "illegal_argument_exception",
                                  "no index specified for _msearch item")
                if isinstance(index, list):
                    if len(index) != 1:
                        raise EsError(400, "illegal_argument_exception",
                                      "multi-index _msearch items are not "
                                      "supported")
                    index = index[0]
                items.append(("q", str(index), query))
            except json.JSONDecodeError as e:
                items.append(("err", {"error": {
                    "type": "parsing_exception",
                    "reason": f"invalid JSON: {e}"}, "status": 400}))
            except EsError as e:
                items.append(("err", {"error": e.body()["error"],
                                      "status": e.status}))

        def run_item(item: tuple) -> dict:
            if item[0] == "err":
                return item[1]
            try:
                return {**self.search(item[1], item[2]), "status": 200}
            except EsError as e:
                return {"error": e.body()["error"], "status": e.status}
            except errors.SqlError as e:
                return {"error": {
                    "type": "sql_exception", "reason": e.message,
                    "sqlstate": e.sqlstate}, "status": 400}

        from ..parallel.pool import parallel_map
        responses = parallel_map(None, run_item, items)
        return {"took": 1, "responses": responses}

    def analyze(self, body: Optional[dict],
                default_index: Optional[str] = None) -> dict:
        """_analyze: run an analyzer over text and return the tokens
        (reference: the analyzer-introspection REST action). ES's
        "standard" maps to our "simple" (lowercase word split, no
        stemming)."""
        from ..search.analysis import dictionary_exists, get_analyzer
        body = body or {}
        if not isinstance(body, dict):
            raise EsError(400, "parsing_exception",
                          "_analyze body must be a JSON object")
        text = body.get("text", "")
        if isinstance(text, list):
            text = " ".join(str(t) for t in text)
        name = body.get("analyzer")
        if name is None and default_index is not None:
            # ES precedence: explicit analyzer > field's analyzer > index
            # default — resolve through the index's inverted indexes
            t = self._table(default_index)   # 404 for unknown index
            field = body.get("field")
            name = "text"
            for idx in getattr(t, "indexes", {}).values():
                fn = getattr(idx, "analyzer_name_for", None)
                if fn is None:
                    continue
                if field is not None:
                    if field in getattr(idx, "columns", ()):
                        name = fn(field)
                        break
                elif idx.columns:
                    name = fn(idx.columns[0])
                    break
        name = str(name if name is not None else "standard")
        if name == "standard" and not dictionary_exists("standard"):
            name = "simple"   # ES "standard" = lowercase word split
        try:
            an = get_analyzer(name)
        except errors.SqlError:
            raise EsError(400, "illegal_argument_exception",
                          f"failed to find global analyzer [{name}]")
        return {"tokens": [
            {"token": t.term, "start_offset": t.start,
             "end_offset": t.end, "type": "<ALPHANUM>",
             "position": t.position}
            for t in an.tokenize(str(text))]}

    def cat_health(self) -> list[dict]:
        h = self.cluster_health()
        return [{"cluster": h["cluster_name"], "status": h["status"],
                 "node.total": str(h["number_of_nodes"]),
                 "shards": str(h["active_shards"]),
                 "unassign": str(h["unassigned_shards"])}]

    def cat_count(self, index: Optional[str] = None) -> list[dict]:
        if index is not None:
            return [{"count": str(self._table(index).row_count())}]
        total = sum(int(r["docs.count"]) for r in self.cat_indices())
        return [{"count": str(total)}]

    def cat_indices(self) -> list[dict]:
        out = []
        with self.db.lock:
            tables = list(self.db.schemas["main"].tables.items())
        for name, t in tables:
            if "_id" not in t.column_names:
                continue
            out.append({"health": "green", "status": "open", "index": name,
                        "pri": "1", "rep": "0",
                        "docs.count": str(t.row_count())})
        return out

    def cluster_health(self) -> dict:
        return {"cluster_name": "serenedb_tpu", "status": "green",
                "timed_out": False, "number_of_nodes": 1,
                "number_of_data_nodes": 1, "active_primary_shards": 1,
                "active_shards": 1, "unassigned_shards": 0}

    # -- query DSL ---------------------------------------------------------

    def _translate_query(self, q: Optional[dict],
                         ) -> tuple[str, Optional[str]]:
        """DSL → (SQL where clause, score expression or None). Stateless
        per call: concurrent searches on server threads must not share
        translation state."""
        if q is None:
            return "", None
        score_fields: list = []     # (field, boost, predicate_sql) triples
        where = self._tr(q, score_fields)
        score = _score_expr(score_fields)
        return where, score

    def _tr(self, q: dict, score_fields: list[str]) -> str:
        if not isinstance(q, dict) or len(q) != 1:
            raise EsError(400, "parsing_exception", "malformed query")
        kind, body = next(iter(q.items()))
        if kind == "match_all":
            return "TRUE"
        if kind == "match":
            field, spec = next(iter(body.items()))
            text = spec.get("query") if isinstance(spec, dict) else spec
            op = (spec.get("operator", "or") if isinstance(spec, dict)
                  else "or").lower()
            terms = [w for w in re.findall(r"\w+", str(text))]
            joiner = " & " if op == "and" else " | "
            pred = _ts_query(field, joiner.join(terms) or '""')
            score_fields.append((field, 1.0, pred))
            return pred
        if kind == "match_phrase":
            field, spec = next(iter(body.items()))
            text = spec.get("query") if isinstance(spec, dict) else spec
            pred = f'{_ident(field)} ## {_sql_str(str(text))}'
            score_fields.append((field, 1.0, pred))
            return pred
        if kind == "query_string":
            field = body.get("default_field", "_all")
            query = body.get("query", "")
            if field == "_all":
                raise EsError(400, "parsing_exception",
                              "query_string requires default_field")
            from ..search.lucene import (LuceneError, lower_to_sql,
                                         parse_lucene)
            try:
                ast = parse_lucene(
                    str(query),
                    str(body.get("default_operator", "OR")))
                sql, claims = lower_to_sql(ast, field, _ident)
            except LuceneError as e:
                raise EsError(400, "parsing_exception", str(e))
            # boost-weighted score claims: each scoring text leaf carries
            # its own predicate, so multi-field queries can score via
            # per-claim passes (Lucene: score = sum of matching clauses)
            score_fields.extend(claims)
            return sql
        if kind == "term":
            field, spec = next(iter(body.items()))
            value = spec.get("value") if isinstance(spec, dict) else spec
            return f'{_ident(field)} = {_sql_lit(value)}'
        if kind == "terms":
            field, values = next(iter(body.items()))
            lits = ", ".join(_sql_lit(v) for v in values)
            return f'{_ident(field)} IN ({lits})'
        if kind == "range":
            field, spec = next(iter(body.items()))
            parts = []
            for op_name, sym in (("gt", ">"), ("gte", ">="), ("lt", "<"),
                                 ("lte", "<=")):
                if op_name in spec:
                    parts.append(f'{_ident(field)} {sym} {_sql_lit(spec[op_name])}')
            return "(" + " AND ".join(parts) + ")" if parts else "TRUE"
        if kind == "exists":
            return f'{_ident(body.get("field"))} IS NOT NULL'
        if kind == "bool":
            clauses = []
            for must in _as_list(body.get("must")) + \
                    _as_list(body.get("filter")):
                clauses.append(self._tr(must, score_fields))
            shoulds = [self._tr(s, score_fields) for s in _as_list(body.get("should"))]
            if shoulds:
                clauses.append("(" + " OR ".join(shoulds) + ")")
            for must_not in _as_list(body.get("must_not")):
                # prohibited clauses never score (ES occur semantics) —
                # and must not drag their fields into the multi-claim path
                clauses.append(f"NOT ({self._tr(must_not, [])})")
            return "(" + " AND ".join(clauses) + ")" if clauses else "TRUE"
        if kind == "prefix":
            field, spec = next(iter(body.items()))
            value = spec.get("value") if isinstance(spec, dict) else spec
            pred = _ts_query(field, f"{value}*")
            score_fields.append((field, 1.0, pred))
            return pred
        if kind == "ids":
            lits = ", ".join(_sql_lit(v) for v in body.get("values", []))
            return f'"_id" IN ({lits})'
        if kind == "geo_bounding_box":
            field, spec = _geo_field(kind, body)
            tl = _es_point(spec.get("top_left"))
            br = _es_point(spec.get("bottom_right"))
            left, top = tl
            right, bottom = br
            poly = (f"POLYGON(({left!r} {bottom!r}, {right!r} {bottom!r}, "
                    f"{right!r} {top!r}, {left!r} {top!r}, "
                    f"{left!r} {bottom!r}))")
            return f'ST_Contains({_sql_str(poly)}, {_ident(field)})'
        if kind == "geo_distance":
            dist_m = _es_distance_m(body.get("distance"))
            field, origin = _geo_field(kind, body, extra=("distance",))
            lon, lat = _es_point(origin)
            pt = f"POINT({lon!r} {lat!r})"
            return (f'ST_DWithin({_ident(field)}, {_sql_str(pt)}, '
                    f'{dist_m!r})')
        if kind == "geo_polygon":
            field, spec = _geo_field(kind, body)
            pts = [_es_point(p) for p in spec.get("points", [])]
            if len(pts) < 3:
                raise EsError(400, "parsing_exception",
                              "geo_polygon needs at least 3 points")
            if pts[0] != pts[-1]:
                pts.append(pts[0])
            ring = ", ".join(f"{lon!r} {lat!r}" for lon, lat in pts)
            return f'ST_Contains({_sql_str(f"POLYGON(({ring}))")}, ' \
                   f'{_ident(field)})'
        if kind == "geo_shape":
            field, spec = _geo_field(kind, body)
            shape = spec.get("shape") if isinstance(spec, dict) else None
            if shape is None:
                raise EsError(400, "parsing_exception",
                              "geo_shape requires a shape")
            relation = str(spec.get("relation", "intersects")).lower()
            fn = {"intersects": "ST_Intersects", "within": "ST_Within",
                  "contains": "ST_Contains",
                  "disjoint": "ST_Disjoint"}.get(relation)
            if fn is None:
                raise EsError(400, "parsing_exception",
                              f"unknown geo_shape relation [{relation}]")
            return (f'{fn}({_ident(field)}, '
                    f'{_sql_str(json.dumps(shape))})')
        raise EsError(400, "parsing_exception",
                      f"unsupported query type [{kind}]")


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


_GEO_OPTION_KEYS = ("validation_method", "ignore_unmapped", "_name",
                    "boost", "distance_type")


def _geo_field(kind: str, body: dict, extra: tuple = ()) -> tuple:
    """The (field, spec) pair of a geo query, skipping ES option keys;
    missing/ambiguous field answers parsing_exception, not a 500."""
    if not isinstance(body, dict):
        raise EsError(400, "parsing_exception", f"malformed {kind}")
    fields = [(k, v) for k, v in body.items()
              if k not in _GEO_OPTION_KEYS and k not in extra]
    if len(fields) != 1:
        raise EsError(400, "parsing_exception",
                      f"{kind} requires exactly one field")
    field, spec = fields[0]
    if kind != "geo_distance" and not isinstance(spec, dict):
        raise EsError(400, "parsing_exception", f"malformed {kind}")
    return field, spec


def _es_point(v) -> tuple:
    """ES point input ({'lat','lon'} / [lon,lat] / 'lat,lon' / WKT /
    geohash-free subset) → (lon, lat)."""
    from ..geo.shapes import parse_any
    try:
        g = parse_any(v)
    except Exception:
        raise EsError(400, "parsing_exception", f"invalid point {v!r}")
    if g.kind != "point":
        raise EsError(400, "parsing_exception", "expected a point")
    return g.coords


_DIST_UNITS_M = {
    "mm": 0.001, "cm": 0.01, "m": 1.0, "km": 1000.0,
    "in": 0.0254, "ft": 0.3048, "yd": 0.9144, "mi": 1609.344,
    "nmi": 1852.0, "nauticalmiles": 1852.0, "meters": 1.0,
    "kilometers": 1000.0, "miles": 1609.344, "feet": 0.3048,
    "yards": 0.9144, "inches": 0.0254,
}


def _es_distance_m(v) -> float:
    """'200km' / '1.5mi' / numeric meters → meters."""
    if v is None:
        raise EsError(400, "parsing_exception",
                      "geo_distance requires a distance")
    if isinstance(v, (int, float)):
        return float(v)
    m = re.match(r"^\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]*)\s*$", str(v))
    if not m:
        raise EsError(400, "parsing_exception", f"invalid distance {v!r}")
    unit = m.group(2).lower() or "m"
    scale = _DIST_UNITS_M.get(unit)
    if scale is None:
        raise EsError(400, "parsing_exception",
                      f"unknown distance unit [{unit}]")
    return float(m.group(1)) * scale


def _hits_response(hits: list[dict], total: int) -> dict:
    return {
        "took": 1, "timed_out": False,
        "_shards": {"total": 1, "successful": 1, "skipped": 0, "failed": 0},
        "hits": {"total": {"value": total, "relation": "eq"},
                 "max_score": max((h["_score"] for h in hits), default=None),
                 "hits": hits},
    }


def _ident(name) -> str:
    """Validated, quoted SQL identifier — ES field names come from untrusted
    request bodies and must never inject SQL."""
    s = str(name)
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_\-.]*$", s) or len(s) > 255:
        raise EsError(400, "illegal_argument_exception",
                      f"invalid field name [{s[:64]}]")
    return '"' + s + '"'


def _ts_query(field: str, q: str) -> str:
    return f"{_ident(field)} @@ {_sql_str(q)}"


def _sql_str(s: str) -> str:
    return "'" + s.replace("'", "''") + "'"


def _sql_lit(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return str(v)
    return _sql_str(str(v))


def _sort_clause(s) -> str:
    if isinstance(s, str):
        return _ident(s)
    field, spec = next(iter(s.items()))
    order = spec.get("order", "asc") if isinstance(spec, dict) else spec
    if str(order).lower() not in ("asc", "desc"):
        raise EsError(400, "illegal_argument_exception",
                      f"invalid sort order [{order}]")
    return f'{_ident(field)} {str(order).upper()}'


def _score_expr(score_fields: list):
    """Scoring plan from (field, boost, predicate) text claims.

    One distinct field → a SQL score expression (`bm25(f) [* w]`) the
    engine evaluates inline, pushing top-k into the index scan. Several
    fields → the claims list itself: the caller runs one scored pass per
    claim and sums weighted scores per doc (Lucene: a document's score
    is the sum of its matching clauses' scores; bm25() on a cross-field
    scan would be unclaimable and evaluate to 0)."""
    if not score_fields:
        return None
    fields = {f for f, _, _ in score_fields}
    if len(fields) == 1:
        f = next(iter(fields))
        w = max(b for _, b, _ in score_fields)
        term = f"bm25({_ident(f)})"
        return f"{term} * {w!r}" if w != 1.0 else term
    return list(score_fields)


def _value_sql_type(v) -> dt.SqlType:
    if isinstance(v, bool):
        return dt.BOOL
    if isinstance(v, int):
        return dt.BIGINT
    if isinstance(v, float):
        return dt.DOUBLE
    return dt.VARCHAR


def _es_type_to_sql(es_type: str) -> dt.SqlType:
    return {
        "text": dt.VARCHAR, "keyword": dt.VARCHAR, "long": dt.BIGINT,
        "integer": dt.INT, "short": dt.SMALLINT, "byte": dt.TINYINT,
        "double": dt.DOUBLE, "float": dt.FLOAT, "boolean": dt.BOOL,
        "date": dt.TIMESTAMP,
    }.get(es_type, dt.VARCHAR)


def _sql_type_to_es(t: dt.SqlType) -> str:
    return {
        dt.TypeId.VARCHAR: "text", dt.TypeId.BIGINT: "long",
        dt.TypeId.INT: "integer", dt.TypeId.SMALLINT: "short",
        dt.TypeId.TINYINT: "byte", dt.TypeId.DOUBLE: "double",
        dt.TypeId.FLOAT: "float", dt.TypeId.BOOL: "boolean",
        dt.TypeId.TIMESTAMP: "date", dt.TypeId.DATE: "date",
    }.get(t.id, "text")


_id_counter = [0]
_id_lock = threading.Lock()


def _gen_id() -> str:
    import time
    with _id_lock:
        _id_counter[0] += 1
        return f"{int(time.time() * 1000):x}-{_id_counter[0]:x}"
