"""The plain BM25 top-10 over the generated passages, worked out again
with NumPy from the corpus's term ranks, and the comparison that holds a
served top-10 to it.

Scoring is Lucene's BM25 as the configuration states it (k1, b, idf =
ln(1 + (N - df + 0.5) / (df + 0.5)), dl a passage's word count, avgdl
their mean), in float64. A query's words are split from the statement's
`@@ '...'` text on anything that is not a letter, digit or `_`, lowered,
and looked up in the vocabulary's spellings; postings come from the
corpus's token ranks, built here for the terms a check needs.

Ties: the statements order by score (and by id in the tie-broken form),
and the program's float32 scores can tie where float64 ones do not, so a
served top-10 is judged by how far each served passage's reference score
lies below the reference's score at that rank (`rank_gap`), not by ids
alone.

`precision="low"` is the control: the reference's scores rounded to
bfloat16 and ranked by them, put in the program's place.
"""

from __future__ import annotations

import re

import numpy as np

_MATCH = re.compile(r"@@\s*'((?:[^']|'')*)'")
_WORD = re.compile(r"[A-Za-z0-9_]+")
#: the sample of answered statements compared each run
SAMPLE = 192
#: and the answered statements with the most terms, added to the sample
LONGEST = 8


def query_words(sql: str) -> list[str]:
    m = _MATCH.search(sql)
    if m is None:
        raise ValueError(f"no @@ '...' in {sql!r}")
    return [w.lower() for w in _WORD.findall(m[1].replace("''", "'"))]


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even)."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(np.float32)


def _bits(span: int) -> int:
    return max(1, int(span).bit_length())


class Reference:
    """The harness's view of this configuration's reference."""

    def __init__(self, data: dict, cfg: dict):
        c = data["corpus"]
        self.tokens, self.offsets = c["tokens"], c["offsets"]
        self.n = len(self.offsets) - 1
        self.dl = np.diff(self.offsets).astype(np.float64)
        self.avgdl = float(self.offsets[-1]) / self.n
        self.k1, self.b = float(cfg["bm25"]["k1"]), float(cfg["bm25"]["b"])
        self.rank_of = {w.tobytes().decode().rstrip(): r
                        for r, w in enumerate(c["spelling"])}
        self._post: dict = {}

    # -- postings and scores ------------------------------------------------

    def terms(self, sql: str) -> list[int]:
        out = []
        for w in query_words(sql):
            r = self.rank_of.get(w)
            if r is not None and r not in out:
                out.append(r)
        return out

    def load(self, terms) -> None:
        """Build the postings of `terms` not built yet: (docs, tf)."""
        todo = sorted({int(t) for t in terms} - set(self._post))
        if not todo:
            return
        lut = np.zeros(len(self.rank_of), dtype=bool)
        lut[todo] = True
        sel = np.flatnonzero(lut[self.tokens])
        docs = np.searchsorted(self.offsets, sel, side="right") - 1
        key = self.tokens[sel].astype(np.int64) * self.n + docs
        uk, tf = np.unique(key, return_counts=True)
        term = uk // self.n
        cuts = np.searchsorted(term, todo + [len(self.rank_of)])
        for i, t in enumerate(todo):
            s, e = cuts[i], cuts[i + 1]
            self._post[t] = (uk[s:e] % self.n, tf[s:e].astype(np.float64))

    def scores(self, terms) -> tuple[np.ndarray, np.ndarray]:
        """(matching docs ascending, their float64 BM25 scores)."""
        self.load(terms)
        docs, parts = [], []
        for t in terms:
            d, tf = self._post[t]
            df = float(len(d))
            idf = np.log(1.0 + (self.n - df + 0.5) / (df + 0.5))
            norm = self.k1 * (1.0 - self.b + self.b * self.dl[d] / self.avgdl)
            docs.append(d)
            parts.append(idf * (self.k1 + 1.0) * tf / (tf + norm))
        if not docs:
            return np.zeros(0, np.int64), np.zeros(0)
        d = np.concatenate(docs)
        u, inv = np.unique(d, return_inverse=True)
        return u, np.bincount(inv, weights=np.concatenate(parts),
                              minlength=len(u))

    def top(self, sql: str, k: int = 10, precision: str = "exact") -> list:
        docs, s = self.scores(self.terms(sql))
        if precision == "low":
            s = bf16(s).astype(np.float64)
        order = np.lexsort((docs, -s))[:k]
        return [(int(docs[i]), float(s[i])) for i in order]

    # -- the comparison -----------------------------------------------------

    def compare(self, sql: str, served: list) -> tuple[int, float, float]:
        """(wrong rows, rank gap, score error) of one served top-10: rows
        missing, extra, repeated or not matching the query are wrong; the
        gap and the error are relative to the query's best score."""
        docs, s = self.scores(self.terms(sql))
        want = min(10, len(docs))
        wrong = abs(len(served) - want)
        if not len(docs):
            return wrong, 0.0, 0.0
        ranked = np.sort(s)[::-1]
        best = float(ranked[0])
        gap = err = 0.0
        seen = set()
        for pos, row in enumerate(served[:want]):
            doc, got = int(row[0]), float(row[1])
            i = int(np.searchsorted(docs, doc))
            if doc in seen or i >= len(docs) or docs[i] != doc:
                wrong += 1
                continue
            seen.add(doc)
            gap = max(gap, (float(ranked[pos]) - float(s[i])) / best)
            err = max(err, abs(got - float(s[i])) / best)
        return wrong, gap, err

    def sample(self, statements: list, answers: list, seed: int) -> list:
        """A sample of the answered statements, drawn from the seed, with
        the ones of the most terms in it."""
        rng = np.random.default_rng(int(seed))
        idx = rng.permutation(len(answers))
        chosen = list(idx[:SAMPLE])
        by_len = sorted(range(len(answers)), key=lambda i: (
            -len(query_words(statements[answers[i][0]])), i))
        for i in by_len[:LONGEST]:
            if i not in chosen:
                chosen.append(i)
        return [answers[i] for i in chosen]

    def check(self, statements: list, answers: list, seed: int,
              precision: str = "exact") -> dict:
        picked = self.sample(statements, answers, seed)
        self.load({t for i, _ in picked for t in self.terms(statements[i])})
        wrong, gap, err = 0, 0.0, 0.0
        for i, rows in picked:
            if precision == "low":
                rows = self.top(statements[i], precision="low")
            w, g, e = self.compare(statements[i], rows)
            wrong, gap, err = wrong + w, max(gap, g), max(err, e)
        return {"wrong_rows": wrong, "rank_gap": gap, "score_err": err,
                "answers_compared": len(picked)}

    def control(self, statements: list, seed: int = 0) -> dict:
        """The control on as many statements as a run compares."""
        answers = [(i, None) for i in range(len(statements))]
        return self.check(statements, answers, seed, precision="low")

    # -- the roofline's bytes -------------------------------------------------

    def least_bytes_all(self, sqls: list, shares: list) -> float:
        """`least_bytes` summed over statements, each times its share,
        their postings built in one pass over the corpus."""
        self.load({t for sql in sqls for t in self.terms(sql)})
        return sum(w * self.least_bytes(sql) for sql, w in zip(sqls, shares))

    def least_bytes(self, sql: str) -> int:
        """The postings of the query's terms (doc id and tf at the bits of
        their ranges), the norm of every passage they touch (at the bits of
        the passage lengths' range), and the top-10 written (8-byte id,
        4-byte score)."""
        terms = self.terms(sql)
        self.load(terms)
        posts = [self._post[t] for t in terms]
        if not posts:
            return 0
        n_post = sum(len(d) for d, _ in posts)
        max_tf = max(int(tf.max()) for _, tf in posts if len(tf))
        touched = len(np.unique(np.concatenate([d for d, _ in posts])))
        dl_bits = _bits(int(self.dl.max()) - int(self.dl.min()))
        per_post = _bits(self.n - 1) + _bits(max_tf - 1)
        return (n_post * per_post + touched * dl_bits + 7) // 8 + \
            min(10, touched) * 12
