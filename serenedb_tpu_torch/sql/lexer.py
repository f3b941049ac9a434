"""Copied from serenedb_tpu/sql/lexer.py.

SQL lexer.

Reference analog: the reference parses SQL with its DuckDB fork's PEG parser
(SURVEY.md §3.2 "Parse"); here a small hand-rolled lexer feeds a
recursive-descent parser (sql/parser.py). PG-flavored: '' string escapes,
$$-quoted strings, "ident" quoting, ::casts, PG operators including the
full-text operators (##, @@) the reference exposes
(reference: examples/demo0/README.md, server/connector/functions/ts_*).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..errors import SqlError


class T(enum.Enum):
    IDENT = "ident"
    NUMBER = "number"
    STRING = "string"
    PARAM = "param"       # $1, $2 …
    OP = "op"
    EOF = "eof"


@dataclass
class Token:
    kind: T
    value: str
    pos: int

    def __repr__(self):
        return f"{self.kind.name}:{self.value!r}"


_OPERATORS = sorted([
    "::", "<=", ">=", "<>", "!=", "||", "##", "@@", "<->", "<#>", "<=>",
    "~*", "!~*", "!~",
    "->>", "->", "#>>", "#>", "?|", "?&", "?", "@>", "<@", "^",
    "(", ")", ",", ";", "+", "-", "*", "/", "%", "<", ">", "=", ".", "~",
    "[", "]", ":",
    # PG bitwise / math operators: & | # << >> (infix), |/ ||/ @ (prefix)
    "&", "|", "#", "<<", ">>", "|/", "||/", "@",
], key=len, reverse=True)  # longest match first (<=> before <=)


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SqlError("42601", "unterminated /* comment")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlError("42601", "unterminated string literal")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            toks.append(Token(T.STRING, "".join(buf), i))
            i = j + 1
            continue
        if c == "$" and i + 1 < n and (sql[i + 1] == "$" or sql[i + 1].isalpha()):
            # dollar-quoted string $tag$...$tag$
            j = sql.find("$", i + 1)
            if j < 0:
                raise SqlError("42601", "unterminated dollar-quoted string")
            tag = sql[i:j + 1]
            end = sql.find(tag, j + 1)
            if end < 0:
                raise SqlError("42601", "unterminated dollar-quoted string")
            toks.append(Token(T.STRING, sql[j + 1:end], i))
            i = end + len(tag)
            continue
        if c == "$" and i + 1 < n and sql[i + 1].isdigit():
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            toks.append(Token(T.PARAM, sql[i + 1:j], i))
            i = j
            continue
        if c == '"':
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlError("42601", "unterminated quoted identifier")
                if sql[j] == '"':
                    if j + 1 < n and sql[j + 1] == '"':
                        buf.append('"')
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            toks.append(Token(T.IDENT, "".join(buf), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    if j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                        seen_exp = True
                        j += 2
                    else:
                        break
                else:
                    break
            toks.append(Token(T.NUMBER, sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            # E'...' escape strings: PG backslash escapes (\n \t \r \b \f
            # \\ \' \xHH \uXXXX); '' still escapes a quote
            if word.upper() == "E" and j < n and sql[j] == "'":
                k = j + 1
                buf = []
                while True:
                    if k >= n:
                        raise SqlError("42601",
                                       "unterminated string literal")
                    ch = sql[k]
                    if ch == "'":
                        if k + 1 < n and sql[k + 1] == "'":
                            buf.append("'")
                            k += 2
                            continue
                        break
                    if ch == "\\" and k + 1 < n:
                        nxt = sql[k + 1]
                        simple = {"n": "\n", "t": "\t", "r": "\r",
                                  "b": "\b", "f": "\f", "\\": "\\",
                                  "'": "'"}
                        if nxt in simple:
                            buf.append(simple[nxt])
                            k += 2
                            continue
                        if nxt in "01234567":
                            # octal \o \oo \ooo
                            m = k + 1
                            while m < min(k + 4, n) and \
                                    sql[m] in "01234567":
                                m += 1
                            buf.append(chr(int(sql[k + 1:m], 8) & 0xFF))
                            k = m
                            continue
                        if nxt in "xX":
                            # \x with 1–2 hex digits (PG rule)
                            m = k + 2
                            while m < min(k + 4, n) and \
                                    sql[m] in "0123456789abcdefABCDEF":
                                m += 1
                            if m > k + 2:
                                buf.append(chr(int(sql[k + 2:m], 16)))
                                k = m
                                continue
                        if nxt in "uU":
                            width = 4 if nxt == "u" else 8
                            hx = sql[k + 2:k + 2 + width]
                            if len(hx) == width:
                                try:
                                    cp = int(hx, 16)
                                except ValueError:
                                    cp = None
                                if cp is not None:
                                    if 0xD800 <= cp <= 0xDFFF or \
                                            cp > 0x10FFFF:
                                        # PG rejects surrogates/overflow
                                        # at parse time — stored lone
                                        # surrogates poison every later
                                        # read of the row
                                        raise SqlError(
                                            "42601",
                                            "invalid Unicode escape "
                                            f"value \\{nxt}{hx}")
                                    buf.append(chr(cp))
                                    k += 2 + width
                                    continue
                        buf.append(nxt)   # unknown escape: literal char
                        k += 2
                        continue
                    buf.append(ch)
                    k += 1
                toks.append(Token(T.STRING, "".join(buf), i))
                i = k + 1
                continue
            toks.append(Token(T.IDENT, word, i))
            i = j
            continue
        for op in _OPERATORS:
            if sql.startswith(op, i):
                toks.append(Token(T.OP, op, i))
                i += len(op)
                break
        else:
            raise SqlError("42601", f"unexpected character {c!r} at position {i}")
    toks.append(Token(T.EOF, "", n))
    return toks
