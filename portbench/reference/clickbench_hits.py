"""The plain answers to ClickBench statements over the generated `hits`
table, worked out again with NumPy, and the comparison that holds a
served answer to them.

The reference reads a small SQL subset, the one that ClickBench's
single-table aggregates use:

    SELECT item, ... FROM t [WHERE col op literal [AND ...]]
    [GROUP BY col, ...] [ORDER BY key [ASC|DESC], ...] [LIMIT n]

where an item is a column or COUNT(*) / COUNT(col) / SUM / AVG / MIN /
MAX of `col`, `col + int` or `col - int`, optionally `AS alias`, and an
ORDER BY key is an alias, a column or an item's text. It imports NumPy
and the standard library only.

`precision="low"` is the control: every integer sum wraps as an int32
accumulator would and AVG is divided in float32. It has to fail the
comparison.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

_SELECT = re.compile(
    r"^SELECT\s+(?P<items>.*?)\s+FROM\s+(?P<table>\w+)"
    r"(?:\s+WHERE\s+(?P<where>.*?))?(?:\s+GROUP\s+BY\s+(?P<group>.*?))?"
    r"(?:\s+ORDER\s+BY\s+(?P<order>.*?))?(?:\s+LIMIT\s+(?P<limit>\d+))?$",
    re.I | re.S)
_AGG = re.compile(r"^(COUNT|SUM|AVG|MIN|MAX)\s*\((.*)\)$", re.I | re.S)
_ARG = re.compile(r"^(\w+)(?:\s*([+-])\s*(\d+))?$")
_COND = re.compile(r"^(\w+)\s*(<>|!=|<=|>=|=|<|>)\s*('(?:[^']|'')*'|-?\d+)$")
_AND = re.compile(r"\s+AND\s+", re.I)
#: 2 ** 53: sums below it are exact in float64 weights
_EXACT = float(1 << 53)


def _split(text: str) -> list[str]:
    """Split on commas outside parentheses."""
    out, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur).strip())
    return out


def _norm(text: str) -> str:
    return re.sub(r"\s+", "", text).upper()


@dataclass
class Item:
    text: str
    alias: str
    agg: str | None = None       # COUNT, SUM, AVG, MIN, MAX; None: a column
    column: str | None = None    # None for COUNT(*)
    offset: int = 0              # the `+ k` of `col + k`


@dataclass
class Query:
    items: list
    table: str
    conds: list = field(default_factory=list)    # (column, op, literal)
    group: list = field(default_factory=list)    # column names
    order: list = field(default_factory=list)    # (item index, desc)
    limit: int | None = None


def parse(sql: str) -> Query:
    m = _SELECT.match(sql.strip().rstrip(";").strip())
    if m is None:
        raise ValueError(f"outside the reference's SQL subset: {sql!r}")
    items = []
    for raw in _split(m["items"]):
        am = re.match(r"^(.*?)\s+AS\s+(\w+)$", raw, re.I | re.S)
        expr, alias = (am[1].strip(), am[2]) if am else (raw, raw)
        fm = _AGG.match(expr)
        if fm is None:
            items.append(Item(expr, alias, column=expr))
            continue
        arg = fm[2].strip()
        if arg == "*":
            items.append(Item(expr, alias, agg=fm[1].upper()))
            continue
        gm = _ARG.match(arg)
        if gm is None:
            raise ValueError(f"outside the reference's SQL subset: {arg!r}")
        off = int(gm[3] or 0) * (-1 if gm[2] == "-" else 1)
        items.append(Item(expr, alias, fm[1].upper(), gm[1], off))
    q = Query(items, m["table"])
    if m["where"]:
        for part in _AND.split(m["where"].strip()):
            cm = _COND.match(part.strip())
            if cm is None:
                raise ValueError(f"outside the reference's subset: {part!r}")
            lit = cm[3]
            lit = lit[1:-1].replace("''", "'") if lit.startswith("'") \
                else int(lit)
            q.conds.append((cm[1], cm[2], lit))
    if m["group"]:
        q.group = [g.strip() for g in _split(m["group"])]
    if m["order"]:
        for part in _split(m["order"]):
            km = re.match(r"^(.*?)(?:\s+(ASC|DESC))?$", part.strip(), re.I)
            key, desc = km[1].strip(), (km[2] or "").upper() == "DESC"
            q.order.append((_item_index(q.items, key), desc))
    if m["limit"]:
        q.limit = int(m["limit"])
    return q


def _item_index(items: list, key: str) -> int:
    for i, it in enumerate(items):
        if it.alias == key or _norm(it.text) == _norm(key):
            return i
    raise ValueError(f"ORDER BY {key!r} names no select item")


@dataclass
class Result:
    """Every group of a statement in its ORDER BY order (before LIMIT)."""
    rows: list
    group_items: list      # indices of the select items that are GROUP BY keys
    order: list            # (item index, desc)
    limit: int | None

    @property
    def expected(self) -> int:
        return len(self.rows) if self.limit is None else \
            min(self.limit, len(self.rows))


def _mask(q: Query, table: dict, n: int) -> np.ndarray:
    mask = np.ones(n, dtype=bool)
    ops = {"=": np.equal, "<>": np.not_equal, "!=": np.not_equal,
           "<": np.less, "<=": np.less_equal, ">": np.greater,
           ">=": np.greater_equal}
    for col, op, lit in q.conds:
        c = table[col]
        if c["dictionary"] is not None:
            if op not in ("=", "<>", "!="):
                raise ValueError("string comparisons other than = and <>")
            hit = np.flatnonzero(c["dictionary"] == lit)
            if len(hit) == 0:
                mask &= op != "="
                continue
            mask &= ops[op](c["data"], int(hit[0]))
        else:
            mask &= ops[op](c["data"], lit)
    return mask


def _groups(q: Query, table: dict, rows: int, masked):
    """(group index of each selected row, number of groups, the key
    values of each group as a list per GROUP BY column)."""
    if not q.group:
        return np.zeros(rows, dtype=np.int64), 1, []
    key = np.zeros(rows, dtype=np.int64)
    spans = []
    for name in q.group:
        v = masked(name).astype(np.int64)
        lo, hi = (int(v.min()), int(v.max())) if len(v) else (0, 0)
        spans.append((lo, hi - lo + 1))
        key = key * (hi - lo + 1) + (v - lo)
    width = int(np.prod([s for _, s in spans], dtype=object))
    if width <= 1 << 26:
        counts = np.bincount(key, minlength=width)
        used = np.flatnonzero(counts)
        remap = np.full(width, -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        gidx, ukeys = remap[key], used.astype(np.int64)
    else:
        ukeys, gidx = np.unique(key, return_inverse=True)
    values, rest = [], ukeys
    for (lo, span) in reversed(spans):
        values.append(rest % span + lo)
        rest = rest // span
    values.reverse()
    out = []
    for name, v in zip(q.group, values):
        d = table[name]["dictionary"]
        out.append([str(s) for s in d[v]] if d is not None
                   else [int(x) for x in v])
    return gidx, len(ukeys), out


def _group_sum(v: np.ndarray, gidx: np.ndarray, g: int) -> np.ndarray:
    """Exact int64 sums of integer `v` by group."""
    if len(v) and float(np.abs(v.astype(np.int64)).max()) * len(v) < _EXACT:
        return np.rint(np.bincount(gidx, weights=v.astype(np.float64),
                                   minlength=g)).astype(np.int64)
    out = np.zeros(g, dtype=np.int64)
    np.add.at(out, gidx, v.astype(np.int64))
    return out


def _wrap32(x: np.ndarray) -> np.ndarray:
    return ((x.astype(np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def evaluate(sql: str, table: dict, precision: str = "exact") -> Result:
    """Every group of `sql` over `table` ({column: {"data",
    "dictionary"}}), ordered as the statement orders them."""
    q = parse(sql)
    n = len(next(iter(table.values()))["data"])
    mask = _mask(q, table, n) if q.conds else None
    rows = n if mask is None else int(mask.sum())
    cache: dict = {}

    def masked(col: str) -> np.ndarray:
        if col not in cache:
            d = table[col]["data"]
            cache[col] = d if mask is None else d[mask]
        return cache[col]

    gidx, g, keys = _groups(q, table, rows, masked)
    counts = np.bincount(gidx, minlength=g).astype(np.int64)
    sums: dict = {}
    low = precision == "low"
    cols, group_items = [], []
    for i, it in enumerate(q.items):
        if it.agg is None:
            if it.column not in q.group:
                raise ValueError(f"{it.column} is neither grouped nor "
                                 "aggregated")
            cols.append(keys[q.group.index(it.column)])
            group_items.append(i)
            continue
        if it.agg == "COUNT":
            cols.append([int(x) for x in counts])
            continue
        v = masked(it.column)
        if it.agg in ("MIN", "MAX"):
            fill = np.iinfo(np.int64).max if it.agg == "MIN" else \
                np.iinfo(np.int64).min
            out = np.full(g, fill, dtype=np.int64)
            (np.minimum if it.agg == "MIN" else np.maximum).at(
                out, gidx, v.astype(np.int64))
            cols.append([int(x) + it.offset for x in out])
            continue
        if it.column not in sums:
            sums[it.column] = _group_sum(v, gidx, g)
        s = sums[it.column] + it.offset * counts
        if it.agg == "SUM":
            cols.append([int(x) for x in (_wrap32(s) if low else s)])
        elif low:   # AVG in float32
            cols.append([float(np.float32(a) / np.float32(c)) if c else None
                         for a, c in zip(s, counts)])
        else:
            cols.append([int(a) / int(c) if c else None
                         for a, c in zip(s, counts)])
    rows = list(zip(*cols)) if cols else []
    if not q.group and not rows:
        rows = [()]
    for idx, desc in reversed(q.order):
        rows.sort(key=lambda r, i=idx: (r[i] is None, r[i]), reverse=desc)
    return Result(rows, group_items, q.order, q.limit)


def _close(a, b) -> tuple[bool, float]:
    """(equal, relative error): exact for int and str, relative for
    float."""
    if isinstance(b, float) or isinstance(a, float):
        if a is None or b is None:
            return a is b, 0.0 if a is b else float("inf")
        err = abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)
        return True, err
    return a == b, 0.0


def compare(served: list, ref: Result) -> tuple[int, float]:
    """(wrong values, widest relative error of a float) of one served
    answer against the reference's groups. Groups whose ORDER BY keys
    tie may come in any order; everything else must match."""
    wrong, worst = abs(len(served) - ref.expected), 0.0
    gi = ref.group_items
    by_key = {tuple(r[i] for i in gi): r for r in ref.rows} if gi else None
    seen = set()
    for pos, row in enumerate(served[:ref.expected]):
        if by_key is not None:
            key = tuple(row[i] for i in gi)
            if key in seen:
                wrong += 1
            seen.add(key)
            want = by_key.get(key)
        else:
            want = ref.rows[pos]
        if want is None or len(want) != len(row):
            wrong += 1
            continue
        for a, b in zip(row, want):
            ok, err = _close(a, b)
            wrong += not ok
            worst = max(worst, err)
        if ref.order:   # the sort keys at this rank, ties interchangeable
            for idx, _ in ref.order:
                ok, err = _close(row[idx], ref.rows[pos][idx])
                wrong += not ok
                worst = max(worst, err)
    return wrong, worst


def _bits(span: int) -> int:
    """Bits that hold every value of a range `span` wide (at least 1)."""
    return max(1, int(span).bit_length())


def columns_read(sql: str, names) -> list[str]:
    """The table's columns that a statement names."""
    return [c for c in names if re.search(rf"\b{re.escape(c)}\b", sql)]


def least_bytes(sql: str, table: dict, ref: Result) -> int:
    """The bytes a statement must move at the least: each column it reads
    once, every value at the bits its range in the table needs (a string
    at its dictionary code's bits), and each result value once (8 bytes a
    number, a string's own bytes)."""
    total = 0
    for name in columns_read(sql, table):
        c = table[name]
        n = len(c["data"])
        if c["dictionary"] is not None:
            bits = _bits(len(c["dictionary"]) - 1)
        else:
            bits = _bits(int(c["data"].max()) - int(c["data"].min()))
        total += (n * bits + 7) // 8
    for row in ref.rows[:ref.expected]:
        total += sum(len(v.encode()) if isinstance(v, str) else 8
                     for v in row)
    return total


class Reference:
    """The harness's view of this configuration's reference."""

    def __init__(self, data: dict, cfg: dict):
        self.table = data["tables"][cfg["table"]]
        self._cache: dict = {}

    def result(self, sql: str, precision: str = "exact") -> Result:
        key = (sql, precision)
        if key not in self._cache:
            self._cache[key] = evaluate(sql, self.table, precision)
        return self._cache[key]

    def least_bytes(self, sql: str) -> int:
        return least_bytes(sql, self.table, self.result(sql))

    def least_bytes_all(self, sqls: list, shares: list) -> float:
        """`least_bytes` summed over statements, each times its share."""
        return sum(w * self.least_bytes(sql) for sql, w in zip(sqls, shares))

    def check(self, statements: list, answers: list, seed: int,
              precision: str = "exact") -> dict:
        """Every distinct answer the window brought back, against the
        reference. `answers` are (statement index, rows)."""
        wrong, worst, seen = 0, 0.0, set()
        for idx, rows in answers:
            key = (idx, repr(rows))
            if key in seen:
                continue
            seen.add(key)
            w, e = compare(rows, self.result(statements[idx], precision))
            wrong, worst = wrong + w, max(worst, e)
        return {"wrong_values": wrong, "avg_rel_err": worst,
                "answers_compared": len(seen)}

    def control(self, statements: list) -> dict:
        """The control: the reference in int32 / float32 put in the
        program's place, judged by the same comparison."""
        answers = []
        for i, sql in enumerate(statements):
            r = self.result(sql, "low")
            answers.append((i, r.rows[:r.expected]))
        return self.check(statements, answers, 0)
