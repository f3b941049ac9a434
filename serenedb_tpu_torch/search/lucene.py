"""Copied from serenedb_tpu/search/lucene.py.

Full Lucene query-string parser (ES `query_string` surface).

Reference analog: libs/iresearch/include/iresearch/parser/lucene_parser
— the reference parses the full Lucene syntax into its filter tree. Here
the same grammar parses into a small AST that the ES layer lowers to SQL
(text leaves become `field @@ '<engine query>'` claims against the
inverted index; ranges become SQL comparisons; boosts weight the score
expression).

Grammar (Lucene classic query parser):

    query     := or_expr
    or_expr   := and_expr (('OR' | '||') and_expr)*
    and_expr  := clause (('AND' | '&&') clause)*     -- adjacency uses the
                                                        default operator
    clause    := ('+' | '-' | 'NOT' | '!')? primary ('^' NUMBER)?
    primary   := '(' query ')'
               | FIELD ':' primary                    -- field override,
                                                        incl. field groups
               | '"' ... '"' ('~' INT)?               -- phrase [slop]
               | ('[' | '{') val 'TO' val (']' | '}') -- range
               | '/' regex '/'
               | WORD ('~' INT?)?                     -- term [fuzzy]
                 (WORD may contain * and ? wildcards)

`+`/`-` occur semantics follow ES: within one boolean list, if any
required (+) clause exists, plain clauses become optional (scoring-only)
and do not constrain matching; prohibited (-) clauses always exclude.
Escapes: backslash before any special character makes it literal.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field
from typing import Optional

from .. import errors

__all__ = ["parse_lucene", "LuceneError", "LTerm", "LPhrase", "LRange",
           "LRegex", "LBool", "LMatchAll"]


class LuceneError(errors.SqlError):
    def __init__(self, msg: str):
        super().__init__(errors.SYNTAX_ERROR,
                         f"query_string parse error: {msg}")


# ------------------------------------------------------------------- AST

@dataclass
class LTerm:
    """Single word; may carry * / ? wildcards; fuzzy > 0 means `~N`."""
    text: str
    field: Optional[str] = None
    boost: float = 1.0
    fuzzy: int = 0


@dataclass
class LPhrase:
    text: str
    field: Optional[str] = None
    boost: float = 1.0
    slop: int = 0


@dataclass
class LRange:
    lo: Optional[str]            # None = unbounded (`*`)
    hi: Optional[str]
    incl_lo: bool
    incl_hi: bool
    field: Optional[str] = None
    boost: float = 1.0


@dataclass
class LRegex:
    pattern: str
    field: Optional[str] = None
    boost: float = 1.0


@dataclass
class LMatchAll:
    """Bare `*` is match-all; `field:*` is an existence check (ES exists
    query), recorded via `field`."""
    boost: float = 1.0
    field: Optional[str] = None


@dataclass
class LBool:
    """`occur` runs parallel to `clauses`: '+' must, '-' must_not,
    '' should."""
    clauses: list = dc_field(default_factory=list)
    occur: list = dc_field(default_factory=list)

    def add(self, clause, occ: str) -> None:
        self.clauses.append(clause)
        self.occur.append(occ)


# ----------------------------------------------------------------- lexer

_SPECIAL = set('+-!(){}[]^"~*?:\\/')

_TOK_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<and>AND\b|&&)
  | (?P<or>OR\b|\|\|)
  | (?P<not>NOT\b)
  | (?P<plus>\+)
  | (?P<minus>-)
  | (?P<bang>!)
  | (?P<lp>\()
  | (?P<rp>\))
  | (?P<lb>\[)
  | (?P<lc>\{)
  | (?P<rb>\])
  | (?P<rc>\})
  | (?P<caret>\^)
  | (?P<tilde>~)
  | (?P<colon>:)
  | (?P<quote>"(?:\\.|[^"\\])*"?)
  | (?P<regex>/(?:\\.|[^/\\])*/?)
  | (?P<word>(?:\\.|[^\s+\-!(){}\[\]^"~:\\/])
             (?:\\.|[^\s!(){}\[\]^"~:\\/])*)
""", re.VERBOSE)
# word: '+'/'-' are operators only at clause start — inside a word
# ("state-of-the-art", "2020-01-01", "C++") they are literal, so the
# continuation class re-admits them.


@dataclass
class _Tok:
    kind: str
    text: str


def _lex(q: str) -> list[_Tok]:
    out: list[_Tok] = []
    i = 0
    while i < len(q):
        m = _TOK_RE.match(q, i)
        if m is None:
            raise LuceneError(f"unexpected character {q[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append(_Tok(kind, m.group()))
    return out


def _unescape(s: str) -> str:
    return re.sub(r"\\(.)", r"\1", s)


# ---------------------------------------------------------------- parser

class _Parser:
    def __init__(self, toks: list[_Tok], default_operator: str):
        self.toks = toks
        self.i = 0
        self.default_and = default_operator.upper() == "AND"

    def peek(self) -> Optional[_Tok]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> _Tok:
        t = self.peek()
        if t is None:
            raise LuceneError("unexpected end of query")
        self.i += 1
        return t

    # query := or_expr
    def parse(self):
        if not self.toks:
            return LMatchAll()
        node = self.parse_or()
        if self.peek() is not None:
            raise LuceneError(f"unexpected {self.peek().text!r}")
        return node

    def parse_or(self):
        parts = [self.parse_and()]
        while self.peek() is not None and self.peek().kind == "or":
            self.next()
            parts.append(self.parse_and())
        if len(parts) == 1:
            return parts[0]
        b = LBool()
        for p in parts:
            b.add(p, "")
        return b

    def parse_and(self):
        """A run of clauses joined by AND/&& or adjacency (default op)."""
        clauses: list[tuple[object, str, bool]] = []  # (node, occ, and_join)
        first = True
        while True:
            t = self.peek()
            if t is None or t.kind in ("or", "rp"):
                break
            and_join = False
            if t.kind == "and":
                self.next()
                and_join = True
                t = self.peek()
                if t is None or t.kind in ("or", "rp"):
                    raise LuceneError("dangling AND")
            node, occ = self.parse_clause()
            clauses.append((node, occ, and_join and not first))
            first = False
        if not clauses:
            raise LuceneError("empty clause list")
        if len(clauses) == 1 and clauses[0][1] == "":
            return clauses[0][0]
        b = LBool()
        for node, occ, and_join in clauses:
            if occ == "":
                # explicit AND joins force must on both sides; adjacency
                # uses the default operator
                occ = "+" if (and_join or self.default_and) else ""
            b.add(node, occ)
        # Lucene: `a AND b` makes BOTH sides required — patch the clause
        # preceding an and_join
        for k, (node, occ, and_join) in enumerate(clauses):
            if and_join and k > 0 and b.occur[k - 1] == "":
                b.occur[k - 1] = "+"
        return b

    def parse_clause(self):
        occ = ""
        t = self.peek()
        if t is not None and t.kind in ("plus", "minus", "not", "bang"):
            self.next()
            occ = "+" if t.kind == "plus" else "-"
        node = self.parse_primary()
        # boost
        t = self.peek()
        if t is not None and t.kind == "caret":
            self.next()
            w = self.next()
            try:
                boost = float(w.text)
            except ValueError:
                raise LuceneError(f"bad boost {w.text!r}")
            _set_boost(node, boost)
        return node, occ

    def parse_primary(self):
        t = self.next()
        if t.kind == "lp":
            node = self.parse_or()
            if self.peek() is None or self.peek().kind != "rp":
                raise LuceneError("missing ')'")
            self.next()
            return node
        if t.kind == "word":
            # field:primary ?
            nxt = self.peek()
            if nxt is not None and nxt.kind == "colon":
                self.next()
                field = _unescape(t.text)
                sub = self.parse_primary()
                _set_field(sub, field)
                return sub
            return self._word_term(t.text)
        if t.kind == "quote":
            body = t.text[1:]
            if body.endswith('"'):
                body = body[:-1]
            node = LPhrase(_unescape(body))
            nxt = self.peek()
            if nxt is not None and nxt.kind == "tilde":
                self.next()
                n = self._fuzz_number()
                # bare `"..."~` defaults like Lucene; floats truncate
                node.slop = 2 if n is None else int(n)
            return node
        if t.kind == "regex":
            body = t.text[1:]
            if body.endswith("/"):
                body = body[:-1]
            return LRegex(body)
        if t.kind in ("lb", "lc"):
            return self._range(incl_lo=(t.kind == "lb"))
        if t.kind == "minus":
            # a bare interior '-' (e.g. `a - b`) — treat as a literal term
            return self._word_term("-")
        raise LuceneError(f"unexpected {t.text!r}")

    def _fuzz_number(self) -> Optional[float]:
        """Consume a numeric token after '~' (int or legacy float
        fuzziness like 0.8) if present."""
        w = self.peek()
        if w is not None and w.kind == "word" and \
                re.fullmatch(r"\d+(\.\d+)?", w.text):
            self.next()
            return float(w.text)
        return None

    def _word_term(self, raw: str):
        nxt = self.peek()
        fuzzy = 0
        if nxt is not None and nxt.kind == "tilde":
            self.next()
            n = self._fuzz_number()
            if n is None:
                fuzzy = 1
            elif n < 1:      # legacy float similarity (0..1) — AUTO-ish
                fuzzy = 1
            else:
                fuzzy = max(1, min(int(n), 2))
        text = _unescape(raw)
        if text == "*" and fuzzy == 0:
            return LMatchAll()
        return LTerm(text, fuzzy=fuzzy)

    def _range(self, incl_lo: bool):
        def val() -> Optional[str]:
            t = self.next()
            if t.kind == "quote":
                body = t.text[1:]
                return _unescape(body[:-1] if body.endswith('"') else body)
            if t.kind == "word":
                v = _unescape(t.text)
                return None if v == "*" else v
            if t.kind == "minus":      # negative numbers: [-5 TO 5]
                w = self.next()
                if w.kind != "word":
                    raise LuceneError("bad range endpoint")
                return "-" + _unescape(w.text)
            raise LuceneError(f"bad range endpoint {t.text!r}")

        lo = val()
        to = self.next()
        if not (to.kind == "word" and to.text.upper() == "TO"):
            raise LuceneError("range must use 'TO'")
        hi = val()
        closer = self.next()
        if closer.kind not in ("rb", "rc"):
            raise LuceneError("unterminated range")
        return LRange(lo, hi, incl_lo, closer.kind == "rb")


def _set_field(node, field: str) -> None:
    if isinstance(node, LBool):
        for c in node.clauses:
            _set_field(c, field)
    elif node.field is None:
        node.field = field


def _set_boost(node, boost: float) -> None:
    if isinstance(node, LBool):
        for c in node.clauses:
            _set_boost(c, boost)
    else:
        node.boost = boost


def parse_lucene(q: str, default_operator: str = "OR"):
    """Parse a Lucene query string into the L* AST."""
    return _Parser(_lex(q), default_operator).parse()


# ------------------------------------------------- lowering to SQL text

def _engine_escape_term(t: str) -> str:
    """A Lucene word (may contain * / ? wildcards) → a token the engine
    query parser (query.parse_query) understands. Engine metacharacters
    inside the word are dropped to spaces (they cannot appear in analyzed
    terms anyway)."""
    return re.sub(r'[&|!()"/~]', " ", t).strip()


def _sqlq(s: str) -> str:
    return "'" + s.replace("'", "''") + "'"


def lower_to_sql(node, default_field: str, quote_ident) -> tuple[str, list]:
    """AST → (SQL boolean expression,
             [(field, boost, predicate_sql), ...] score claims).

    Text leaves lower to `field @@ '<engine query>'`; ranges to SQL
    comparisons (numeric when both endpoints parse as numbers). The
    claims list carries each scoring text leaf's field, boost and its
    own predicate SQL, so the caller can build either a single score
    expression (one field) or per-field scored passes (multi-field).
    must_not leaves never claim (ES: prohibited clauses don't score)."""
    claims: list[tuple[str, float, str]] = []

    def fld(n) -> str:
        return n.field if getattr(n, "field", None) else default_field

    def num(v: Optional[str]) -> Optional[float]:
        if v is None:
            return None
        try:
            return float(v)
        except ValueError:
            return None

    def rec(n, scoring: bool = True) -> str:
        def claim(f: str, boost: float, pred: str) -> str:
            # must_not clauses never contribute to scoring (ES occur
            # semantics), so their fields stay out of the claims list
            if scoring:
                claims.append((f, boost, pred))
            return pred

        if isinstance(n, LMatchAll):
            if n.field is not None:       # field:* = exists (ES)
                return f"{quote_ident(n.field)} IS NOT NULL"
            return "TRUE"
        if isinstance(n, LTerm):
            f = fld(n)
            term = _engine_escape_term(n.text)
            if not term:
                return "TRUE"
            if n.fuzzy and not ("*" in term or "?" in term):
                # fuzzy cannot combine with wildcards (ES drops it too)
                term = f"{term}~{n.fuzzy}"
            return claim(f, n.boost, f"{quote_ident(f)} @@ {_sqlq(term)}")
        if isinstance(n, LPhrase):
            f = fld(n)
            body = n.text.replace('"', " ")
            q = f'"{body}"' + (f"~{n.slop}" if n.slop else "")
            return claim(f, n.boost, f"{quote_ident(f)} @@ {_sqlq(q)}")
        if isinstance(n, LRegex):
            f = fld(n)
            return claim(f, n.boost,
                         f"{quote_ident(f)} @@ {_sqlq('/' + n.pattern + '/')}")
        if isinstance(n, LRange):
            f = quote_ident(fld(n))
            parts = []
            lo_n, hi_n = num(n.lo), num(n.hi)
            numeric = (n.lo is None or lo_n is not None) and \
                      (n.hi is None or hi_n is not None) and \
                      not (n.lo is None and n.hi is None)
            if n.lo is not None:
                lit = repr(lo_n) if numeric else _sqlq(n.lo)
                parts.append(f"{f} >{'=' if n.incl_lo else ''} {lit}")
            if n.hi is not None:
                lit = repr(hi_n) if numeric else _sqlq(n.hi)
                parts.append(f"{f} <{'=' if n.incl_hi else ''} {lit}")
            return "(" + " AND ".join(parts) + ")" if parts else "TRUE"
        if isinstance(n, LBool):
            musts = [rec(c, scoring) for c, o in zip(n.clauses, n.occur)
                     if o == "+"]
            nots = [rec(c, False) for c, o in zip(n.clauses, n.occur)
                    if o == "-"]
            shoulds = [rec(c, scoring) for c, o in zip(n.clauses, n.occur)
                       if o == ""]
            parts = list(musts)
            if shoulds and not musts:
                parts.append("(" + " OR ".join(shoulds) + ")")
            # ES semantics: with musts present, shoulds are scoring-only
            parts.extend(f"NOT ({x})" for x in nots)
            return "(" + " AND ".join(parts) + ")" if parts else "TRUE"
        raise LuceneError(f"cannot lower {type(n).__name__}")

    sql = rec(node)
    return sql, claims
