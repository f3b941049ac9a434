"""Copied from serenedb_tpu/sql/parser.py.

Recursive-descent SQL parser.

Covers the statement surface the engine executes (SELECT with joins/group/
order/limit, DDL for tables/indexes/schemas/views, INSERT/UPDATE/DELETE,
SET/SHOW, COPY, EXPLAIN, VACUUM, transactions) plus the SereneDB full-text
operators: `col ## 'phrase'` (phrase match) and `col @@ 'query'` (ts query),
mirroring the reference's SQL search surface
(reference: server/connector/functions/ts_*.cpp, examples/demo0/README.md).
"""

from __future__ import annotations

from typing import Optional

from .. import errors
from ..errors import SqlError
from . import ast
from .lexer import T, Token, tokenize

_KEYWORDS_STOP_ALIAS = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "UNION",
    "EXCEPT", "INTERSECT", "ON", "USING", "JOIN", "INNER", "LEFT", "RIGHT",
    "FULL", "CROSS", "NATURAL", "AS", "AND", "OR", "NOT", "SET", "WITH",
    "ASC", "DESC",
    "NULLS", "INTO", "VALUES", "RETURNING", "THEN", "ELSE", "END", "WHEN",
    "CASE", "IS", "IN", "BETWEEN", "LIKE", "ILIKE", "BY",
}

_COMPARE_OPS = {"=", "<>", "!=", "<", "<=", ">", ">=", "##", "@@",
                "<->", "<#>", "<=>", "~", "~*", "!~", "!~*"}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind is not T.EOF:
            self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind is T.IDENT and t.value.upper() in words

    def accept_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.accept_kw(word):
            raise errors.syntax(
                f"expected {word} near {self.peek().value!r}")

    def at_op(self, op: str) -> bool:
        t = self.peek()
        return t.kind is T.OP and t.value == op

    def accept_op(self, op: str) -> bool:
        if self.at_op(op):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise errors.syntax(f"expected {op!r} near {self.peek().value!r}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind is not T.IDENT:
            raise errors.syntax(f"expected identifier near {t.value!r}")
        self.next()
        return t.value

    def _explain_bool_opt(self) -> bool:
        """Optional boolean value of an EXPLAIN list option (PG: a bare
        option means ON; ON/OFF/TRUE/FALSE/1/0 are accepted values)."""
        t = self.peek()
        if t.kind is T.IDENT and t.value.upper() in (
                "ON", "OFF", "TRUE", "FALSE"):
            self.next()
            return t.value.upper() in ("ON", "TRUE")
        if t.kind is T.NUMBER and t.value in ("0", "1"):
            self.next()
            return t.value == "1"
        return True

    # -- entry points ------------------------------------------------------

    def parse_statements(self) -> list[ast.Statement]:
        stmts = []
        while self.peek().kind is not T.EOF:
            if self.accept_op(";"):
                continue
            start = self.peek().pos
            st = self.parse_statement()
            end = (self.peek().pos if self.peek().kind is not T.EOF
                   else len(self.sql))
            # per-statement source slice (view definitions, pg_stat_activity)
            st.source_sql = self.sql[start:end].rstrip().rstrip(";")
            if getattr(st, "body_pos", None) is not None:
                st.body_sql = self.sql[st.body_pos:end].rstrip().rstrip(";")
            stmts.append(st)
            if self.peek().kind is not T.EOF:
                self.expect_op(";")
        return stmts

    def parse_statement(self) -> ast.Statement:
        if self.at_kw("SELECT", "WITH") or self.at_op("("):
            return self.parse_select()
        if self.at_kw("CREATE"):
            return self.parse_create()
        if self.at_kw("DROP"):
            return self.parse_drop()
        if self.at_kw("INSERT"):
            return self.parse_insert()
        if self.at_kw("DELETE"):
            return self.parse_delete()
        if self.at_kw("UPDATE"):
            return self.parse_update()
        if self.at_kw("SET"):
            return self.parse_set()
        if self.at_kw("RESET"):
            self.next()
            if self.at_kw("ROLE"):
                self.next()
                return ast.SetRole(None)
            name = self.ident()
            return ast.SetStmt(name.lower(), "DEFAULT")
        if self.at_kw("SHOW"):
            self.next()
            parts = [self.ident()]
            while self.accept_op("."):
                parts.append(self.ident())
            return ast.ShowStmt(".".join(parts).lower())
        if self.at_kw("BEGIN", "START"):
            self.next()
            self.accept_kw("TRANSACTION") or self.accept_kw("WORK")
            return ast.Transaction("begin")
        if self.at_kw("COMMIT", "END"):
            self.next()
            self.accept_kw("TRANSACTION") or self.accept_kw("WORK")
            return ast.Transaction("commit")
        if self.at_kw("ROLLBACK", "ABORT"):
            self.next()
            self.accept_kw("TRANSACTION") or self.accept_kw("WORK")
            if self.accept_kw("TO"):
                self.accept_kw("SAVEPOINT")
                return ast.Transaction("rollback_to", self.ident())
            return ast.Transaction("rollback")
        if self.at_kw("SAVEPOINT"):
            self.next()
            return ast.Transaction("savepoint", self.ident())
        if self.at_kw("RELEASE"):
            self.next()
            self.accept_kw("SAVEPOINT")
            return ast.Transaction("release", self.ident())
        if self.at_kw("EXPLAIN"):
            self.next()
            analyze = False
            fmt = "text"
            if self.accept_op("("):
                # PG option-list form: EXPLAIN (ANALYZE [ON|OFF],
                # FORMAT {TEXT|JSON}, ...) — boolean options take an
                # optional value, FORMAT takes a required one
                while True:
                    opt = self.ident().lower()
                    if opt == "format":
                        fmt = self.ident().lower()
                        if fmt not in ("text", "json"):
                            raise errors.unsupported(
                                f"EXPLAIN format {fmt.upper()}")
                    elif opt in ("analyze", "analyse"):
                        analyze = self._explain_bool_opt()
                    elif opt in ("verbose", "costs", "timing",
                                 "summary", "buffers"):
                        self._explain_bool_opt()   # accepted, no-op
                    else:
                        raise errors.syntax(
                            f'unrecognized EXPLAIN option "{opt}"')
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            else:
                analyze = self.accept_kw("ANALYZE")
            return ast.Explain(self.parse_statement(), analyze, fmt)
        if self.at_kw("ALTER"):
            return self.parse_alter()
        if self.at_kw("GRANT", "REVOKE"):
            grant = self.ident().upper() == "GRANT"
            privs = [self.ident().lower()]
            while self.accept_op(","):
                privs.append(self.ident().lower())
            if self.at_kw("TO" if grant else "FROM") and len(privs) == 1:
                # GRANT <role> TO <member> — role membership
                self.next()
                member = self.ident()
                return ast.GrantRevoke(grant, [], [], member,
                                       granted_role=privs[0])
            self.expect_kw("ON")
            self.accept_kw("TABLE")
            table = self.qualified_name()
            self.expect_kw("TO" if grant else "FROM")
            role = self.ident()
            return ast.GrantRevoke(grant, privs, table, role)
        if self.at_kw("COPY"):
            return self.parse_copy()
        if self.at_kw("VACUUM"):
            return self.parse_vacuum()
        if self.at_kw("TRUNCATE"):
            self.next()
            self.accept_kw("TABLE")
            return ast.Truncate(self.qualified_name())
        if self.at_kw("LISTEN"):
            self.next()
            return ast.ListenStmt(self.ident().lower())
        if self.at_kw("UNLISTEN"):
            self.next()
            if self.accept_op("*"):
                return ast.ListenStmt("", "unlisten_all")
            return ast.ListenStmt(self.ident().lower(), "unlisten")
        if self.at_kw("NOTIFY"):
            self.next()
            channel = self.ident().lower()
            payload = ""
            if self.accept_op(","):
                t = self.next()
                if t.kind is not T.STRING:
                    raise errors.syntax("NOTIFY payload must be a string")
                payload = t.value
            return ast.NotifyStmt(channel, payload)
        if self.at_kw("VALUES"):
            return self.parse_select()
        raise errors.syntax(f"unsupported statement near {self.peek().value!r}")

    # -- SELECT ------------------------------------------------------------

    def parse_select(self):
        """SELECT / VALUES / set-operation chain / WITH prologue."""
        ctes: dict = {}
        if self.accept_kw("WITH"):
            recursive = bool(self.accept_kw("RECURSIVE"))
            while True:
                name = self.ident()
                cols = None
                if self.accept_op("("):
                    cols = [self.ident()]
                    while self.accept_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                self.expect_kw("AS")
                self.expect_op("(")
                body = self.parse_select()
                self.expect_op(")")
                if recursive or cols is not None:
                    body = ast.CteDef(body, cols, recursive)
                ctes[name.lower()] = body
                if not self.accept_op(","):
                    break
        node = self._parse_intersect_chain()
        while self.at_kw("UNION", "EXCEPT"):
            op = self.ident().lower()
            all_ = bool(self.accept_kw("ALL"))
            self.accept_kw("DISTINCT")
            self._reject_unparenthesized_tail(node)
            # INTERSECT binds tighter than UNION/EXCEPT (PG gram.y)
            right = self._parse_intersect_chain()
            node = ast.SetOp(op, all_, node, right)
        if isinstance(node, ast.SetOp):
            # PG grammar: a trailing ORDER BY/LIMIT binds to the whole set
            # operation, but the greedy core parse attaches it to the last
            # arm — steal it back from the rightmost unparenthesized
            # Select (unless that arm was parenthesized)
            last = node.right
            while isinstance(last, ast.SetOp):
                last = last.right
            if isinstance(last, ast.Select) and \
                    not getattr(last, "_parens", False):
                node.order_by = last.order_by
                node.limit = last.limit
                node.offset = last.offset
                last.order_by, last.limit, last.offset = [], None, None
            if self.accept_kw("ORDER"):
                self.expect_kw("BY")
                node.order_by.append(self.parse_order_item())
                while self.accept_op(","):
                    node.order_by.append(self.parse_order_item())
            while self.at_kw("LIMIT", "OFFSET", "FETCH"):
                if self.accept_kw("LIMIT"):
                    if not self.accept_kw("ALL"):
                        node.limit = self.parse_expr()
                elif self.accept_kw("OFFSET"):
                    node.offset = self.parse_expr()
                    self.accept_kw("ROWS") or self.accept_kw("ROW")
                elif self.accept_kw("FETCH"):
                    # FETCH {FIRST|NEXT} [n] {ROW|ROWS} ONLY (SQL std)
                    if not (self.accept_kw("FIRST") or
                            self.accept_kw("NEXT")):
                        raise errors.syntax(
                            "expected FIRST or NEXT after FETCH")
                    if self.at_kw("ROW", "ROWS"):
                        node.limit = ast.Literal(1)
                    else:
                        node.limit = self.parse_expr()
                    self.accept_kw("ROWS") or self.accept_kw("ROW")
                    self.expect_kw("ONLY")
        if ctes:
            # inner (more deeply scoped) CTEs shadow outer ones; never
            # clobber a parenthesized arm's own WITH bindings
            node.ctes = {**ctes, **getattr(node, "ctes", {})}
        return node

    def _parse_intersect_chain(self):
        node = self._parse_select_core()
        while self.at_kw("INTERSECT"):
            self.next()
            all_ = bool(self.accept_kw("ALL"))
            self.accept_kw("DISTINCT")
            self._reject_unparenthesized_tail(node)
            node = ast.SetOp("intersect", all_, node,
                             self._parse_select_core())
        return node

    def _reject_unparenthesized_tail(self, node):
        if isinstance(node, ast.Select) and \
                not getattr(node, "_parens", False) and (
                node.order_by or node.limit is not None or
                node.offset is not None):
            raise errors.syntax(
                "ORDER BY/LIMIT/OFFSET in a set-operation arm needs "
                "parentheses")

    def _parse_select_core(self) -> ast.Select:
        if self.accept_op("("):
            inner = self.parse_select()
            self.expect_op(")")
            inner._parens = True  # its ORDER BY/LIMIT are scoped by parens
            return inner
        if self.at_kw("VALUES"):
            return self._parse_values_select()
        self.expect_kw("SELECT")
        distinct = False
        distinct_on = None
        if self.accept_kw("DISTINCT"):
            if self.accept_kw("ON"):
                self.expect_op("(")
                distinct_on = [self.parse_expr()]
                while self.accept_op(","):
                    distinct_on.append(self.parse_expr())
                self.expect_op(")")
            else:
                distinct = True
        else:
            self.accept_kw("ALL")
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())
        from_ = None
        if self.accept_kw("FROM"):
            from_ = self.parse_from()
        where = self.parse_expr() if self.accept_kw("WHERE") else None
        group_by: list[ast.Expr] = []
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_by.append(self.parse_expr())
            while self.accept_op(","):
                group_by.append(self.parse_expr())
        having = self.parse_expr() if self.accept_kw("HAVING") else None
        order_by: list[ast.OrderItem] = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        limit = offset = None
        while self.at_kw("LIMIT", "OFFSET", "FETCH"):
            if self.accept_kw("LIMIT"):
                if not self.accept_kw("ALL"):
                    limit = self.parse_expr()
            elif self.accept_kw("OFFSET"):
                offset = self.parse_expr()
                self.accept_kw("ROWS") or self.accept_kw("ROW")
            elif self.accept_kw("FETCH"):
                # FETCH {FIRST|NEXT} [n] {ROW|ROWS} ONLY (SQL std)
                if not (self.accept_kw("FIRST") or
                        self.accept_kw("NEXT")):
                    raise errors.syntax(
                        "expected FIRST or NEXT after FETCH")
                if self.at_kw("ROW", "ROWS"):
                    limit = ast.Literal(1)
                else:
                    limit = self.parse_expr()
                self.accept_kw("ROWS") or self.accept_kw("ROW")
                self.expect_kw("ONLY")
        return ast.Select(items, from_, where, group_by, having, order_by,
                          limit, offset, distinct, distinct_on)

    def _parse_values_select(self) -> ast.Select:
        self.expect_kw("VALUES")
        rows = [self._parse_paren_exprs()]
        while self.accept_op(","):
            rows.append(self._parse_paren_exprs())
        width = len(rows[0])
        if any(len(r) != width for r in rows):
            raise errors.syntax("VALUES lists must all be the same length")
        items = [ast.SelectItem(ast.ColumnRef([f"col{k}"])) for k in range(width)]
        sel = ast.Select(items)
        sel.values_rows = rows  # type: ignore[attr-defined]
        return sel

    def _parse_paren_exprs(self) -> list[ast.Expr]:
        self.expect_op("(")
        exprs = [self.parse_expr()]
        while self.accept_op(","):
            exprs.append(self.parse_expr())
        self.expect_op(")")
        return exprs

    def parse_select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.next()
            return ast.SelectItem(ast.Star())
        start = self.i
        expr = self.parse_expr()
        # tbl.* comes back as ColumnRef with trailing '*' handled in primary
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident()
        elif self.peek().kind is T.IDENT and \
                self.peek().value.upper() not in _KEYWORDS_STOP_ALIAS:
            alias = self.ident()
        del start
        return ast.SelectItem(expr, alias)

    def parse_order_item(self) -> ast.OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("DESC"):
            desc = True
        else:
            self.accept_kw("ASC")
        nulls_first = None
        if self.accept_kw("NULLS"):
            if self.accept_kw("FIRST"):
                nulls_first = True
            else:
                self.expect_kw("LAST")
                nulls_first = False
        return ast.OrderItem(e, desc, nulls_first)

    def _parse_like_escape(self):
        if self.accept_kw("ESCAPE"):
            t = self.next()
            # ESCAPE '' is valid PG: it DISABLES escaping
            if t.kind is not T.STRING or len(t.value) > 1:
                raise errors.syntax("ESCAPE must be a single character")
            return t.value
        return None

    def parse_from(self) -> ast.TableRef:
        ref = self.parse_table_ref()
        while True:
            if self.accept_op(","):
                right = self.parse_table_ref()
                ref = ast.JoinRef("cross", ref, right)
                continue
            kind = None
            natural = False
            if self.accept_kw("CROSS"):
                self.expect_kw("JOIN")
                ref = ast.JoinRef("cross", ref, self.parse_table_ref())
                continue
            if self.accept_kw("NATURAL"):
                # NATURAL [INNER|LEFT|RIGHT|FULL [OUTER]] JOIN: USING
                # over the shared column names, resolved at bind time
                natural = True
            if self.accept_kw("INNER"):
                kind = "inner"
                self.expect_kw("JOIN")
            elif self.accept_kw("LEFT"):
                kind = "left"
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
            elif self.accept_kw("RIGHT"):
                kind = "right"
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
            elif self.accept_kw("FULL"):
                kind = "full"
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
            elif self.accept_kw("JOIN"):
                kind = "inner"
            else:
                if natural:
                    raise errors.syntax("expected JOIN after NATURAL")
                break
            right = self.parse_table_ref()
            if natural:
                ref = ast.JoinRef(kind, ref, right, using=["*natural*"])
                continue
            if self.accept_kw("ON"):
                cond = self.parse_expr()
                ref = ast.JoinRef(kind, ref, right, condition=cond)
            elif self.accept_kw("USING"):
                self.expect_op("(")
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                ref = ast.JoinRef(kind, ref, right, using=cols)
            else:
                raise errors.syntax("JOIN requires ON or USING")
        return ref

    def parse_table_ref(self) -> ast.TableRef:
        if self.accept_op("("):
            inner = self.parse_select()
            self.expect_op(")")
            alias = self._table_alias()
            cols = None
            if alias is not None and self.at_op("("):
                # FROM (VALUES …) v(a, b) — column aliases (PG)
                self.next()
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            return ast.SubqueryRef(inner, alias, cols)
        parts = [self.ident()]
        while self.accept_op("."):
            parts.append(self.ident())
        if self.at_op("("):
            self.next()
            args = []
            if not self.at_op(")"):
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            alias = self._table_alias()
            col_aliases = None
            if alias is not None and self.accept_op("("):
                col_aliases = [self.ident()]
                while self.accept_op(","):
                    col_aliases.append(self.ident())
                self.expect_op(")")
            return ast.TableFunction(".".join(parts).lower(), args, alias,
                                     col_aliases)
        alias = self._table_alias()
        return ast.NamedTable(parts, alias)

    def _table_alias(self) -> Optional[str]:
        if self.accept_kw("AS"):
            return self.ident()
        if self.peek().kind is T.IDENT and \
                self.peek().value.upper() not in _KEYWORDS_STOP_ALIAS:
            return self.ident()
        return None

    # -- expressions (precedence climbing) ---------------------------------

    def parse_expr(self) -> ast.Expr:
        return self.parse_or()

    def parse_or(self) -> ast.Expr:
        left = self.parse_and()
        if not self.at_kw("OR"):
            return left
        args = [left]
        while self.accept_kw("OR"):
            args.append(self.parse_and())
        return ast.Logical("OR", args)

    def parse_and(self) -> ast.Expr:
        left = self.parse_not()
        if not self.at_kw("AND"):
            return left
        args = [left]
        while self.accept_kw("AND"):
            args.append(self.parse_not())
        return ast.Logical("AND", args)

    def parse_not(self) -> ast.Expr:
        if self.accept_kw("NOT"):
            return ast.UnaryOp("NOT", self.parse_not())
        return self.parse_predicate()

    #: PG "any other operator" precedence level: below + - , above the
    #: comparisons (gram.y); desugared to functions at parse time
    _OTHER_OPS = {"&": "bitand", "|": "bitor", "#": "bitxor",
                  "<<": "bitshiftleft", ">>": "bitshiftright"}

    def parse_other_ops(self) -> ast.Expr:
        left = self.parse_additive_chain()
        while self.peek().kind is T.OP and \
                self.peek().value in self._OTHER_OPS:
            fn = self._OTHER_OPS[self.next().value]
            left = ast.FuncCall(fn, [left, self.parse_additive_chain()])
        return left

    def parse_predicate(self) -> ast.Expr:
        left = self.parse_other_ops()
        while True:
            if self.accept_kw("IS"):
                negated = bool(self.accept_kw("NOT"))
                if self.accept_kw("NULL"):
                    left = ast.IsNull(left, negated)
                elif self.accept_kw("TRUE"):
                    # IS [NOT] TRUE is null-safe (PG): NULL IS NOT TRUE
                    # is true, not NULL — spell it with DISTINCT FROM
                    left = ast.FuncCall(
                        "is_distinct_from" if negated
                        else "is_not_distinct_from",
                        [left, ast.Literal(True)])
                elif self.accept_kw("FALSE"):
                    left = ast.FuncCall(
                        "is_distinct_from" if negated
                        else "is_not_distinct_from",
                        [left, ast.Literal(False)])
                elif self.accept_kw("UNKNOWN"):
                    # IS [NOT] UNKNOWN == IS [NOT] NULL over a boolean
                    left = ast.IsNull(left, negated)
                elif self.accept_kw("DISTINCT"):
                    self.expect_kw("FROM")
                    right = self.parse_additive_chain()
                    left = ast.FuncCall(
                        "is_not_distinct_from" if negated else "is_distinct_from",
                        [left, right])
                else:
                    raise errors.syntax("expected NULL after IS")
                continue
            negated = False
            save = self.i
            if self.accept_kw("NOT"):
                negated = True
            if self.accept_kw("IN"):
                self.expect_op("(")
                if self.at_kw("SELECT", "WITH", "VALUES"):
                    sub = self.parse_select()
                    self.expect_op(")")
                    left = ast.InSubquery(left, sub, negated)
                    continue
                items = [self.parse_expr()]
                while self.accept_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                left = ast.InList(left, items, negated)
                continue
            if self.accept_kw("BETWEEN"):
                low = self.parse_additive_chain()
                self.expect_kw("AND")
                high = self.parse_additive_chain()
                left = ast.Between(left, low, high, negated)
                continue
            if self.accept_kw("LIKE"):
                left = ast.Like(left, self.parse_additive_chain(),
                                negated, False,
                                escape=self._parse_like_escape())
                continue
            if self.accept_kw("ILIKE"):
                left = ast.Like(left, self.parse_additive_chain(),
                                negated, True,
                                escape=self._parse_like_escape())
                continue
            if self.at_kw("SIMILAR") and \
                    self.peek(1).kind is T.IDENT and \
                    self.peek(1).value.upper() == "TO":
                self.next()
                self.next()
                e = ast.FuncCall("__similar_to",
                                 [left, self.parse_additive_chain()])
                left = ast.UnaryOp("NOT", e) if negated else e
                continue
            if negated:
                self.i = save
                break
            t = self.peek()
            op = None
            if t.kind is T.IDENT and t.value.upper() == "OPERATOR" and \
                    self.peek(1).kind is T.OP and self.peek(1).value == "(":
                # psql spells operators as OPERATOR(pg_catalog.~)
                self.next()
                self.next()
                while self.peek().kind is T.IDENT:
                    self.ident()
                    self.expect_op(".")
                opt = self.next()
                if opt.kind is not T.OP or opt.value == ")":
                    raise errors.syntax("expected operator in OPERATOR()")
                op = opt.value
                self.expect_op(")")
                if op not in _COMPARE_OPS:
                    raise errors.unsupported(f"OPERATOR({op})")
            elif t.kind is T.OP and t.value in _COMPARE_OPS:
                op = t.value
                self.next()
            if op is None:
                break
            if self.at_kw("ANY", "SOME", "ALL"):
                quant = self.next().value.upper()
                quant = "ANY" if quant == "SOME" else quant
                self.expect_op("(")
                if self.at_kw("SELECT", "WITH", "VALUES"):
                    sub = self.parse_select()
                    self.expect_op(")")
                    if quant == "ANY" and op == "=":
                        left = ast.InSubquery(left, sub, False)
                    elif quant == "ALL" and op in ("<>", "!="):
                        left = ast.InSubquery(left, sub, True)
                    else:
                        # general op ANY/ALL (subquery): gather the
                        # subquery column and fold with the same
                        # three-valued __quant_cmp as the array form
                        left = ast.FuncCall(
                            "__quant_cmp",
                            [ast.Literal(op), ast.Literal(quant), left,
                             ast.ArraySubquery(sub)])
                    continue
                arr = self.parse_expr()
                self.expect_op(")")
                left = ast.FuncCall("__quant_cmp",
                                    [ast.Literal(op), ast.Literal(quant),
                                     left, arr])
                continue
            right = self.parse_other_ops()
            left = ast.BinaryOp(op, left, right)
            continue
        return left

    #: PG json/containment operators desugared to functions at parse time
    #: (reference: DuckDB fork maps -> / ->> onto json_extract family)
    _JSON_OPS = {"->": "json_getelem", "->>": "json_getelem_text",
                 "#>": "json_getpath", "#>>": "json_getpath_text",
                 "@>": "contains_op", "<@": "contained_op",
                 "?": "json_exists_op", "?|": "json_exists_any",
                 "?&": "json_exists_all"}

    def parse_additive_chain(self) -> ast.Expr:
        left = self.parse_multiplicative()
        while True:
            if self.at_op("+") or self.at_op("-") or self.at_op("||"):
                op = self.next().value
                left = ast.BinaryOp(op, left, self.parse_multiplicative())
            elif self.peek().kind is T.OP and \
                    self.peek().value in self._JSON_OPS:
                fn = self._JSON_OPS[self.next().value]
                left = ast.FuncCall(fn, [left, self.parse_multiplicative()])
            else:
                return left

    def parse_multiplicative(self) -> ast.Expr:
        left = self.parse_unary()
        while True:
            if self.at_op("*") or self.at_op("/") or self.at_op("%"):
                op = self.next().value
                left = ast.BinaryOp(op, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> ast.Expr:
        # PG precedence: unary minus binds TIGHTER than ^ (gram.y UMINUS),
        # so -2^2 = (-2)^2 = 4; the ^ loop therefore sits ABOVE the unary
        # parser and below * (parse_multiplicative calls parse_unary)
        left = self._parse_signed()
        while self.at_op("^"):
            self.next()
            right = self._parse_signed()
            left = ast.FuncCall("power", [left, right])
        return left

    def _parse_signed(self) -> ast.Expr:
        if self.accept_op("-"):
            return ast.UnaryOp("-", self._parse_signed())
        if self.accept_op("+"):
            return self._parse_signed()
        # PG prefix operators: ~ bitwise not, |/ sqrt, ||/ cbrt, @ abs
        if self.accept_op("~"):
            return ast.FuncCall("bitnot", [self._parse_signed()])
        if self.accept_op("|/"):
            return ast.FuncCall("sqrt", [self._parse_signed()])
        if self.accept_op("||/"):
            return ast.FuncCall("cbrt", [self._parse_signed()])
        if self.accept_op("@"):
            return ast.FuncCall("abs", [self._parse_signed()])
        return self.parse_postfix()

    def parse_postfix(self) -> ast.Expr:
        e = self.parse_primary()
        while True:
            if self.accept_op("::"):
                e = ast.Cast(e, self._type_name())
            elif self.at_kw("COLLATE"):
                # COLLATE pg_catalog.default etc. — single collation, no-op
                self.next()
                self.ident()
                while self.accept_op("."):
                    self.ident()
            elif self.accept_op("["):
                # arr[i] — 1-based element access, desugared to a function
                idx = self.parse_expr()
                self.expect_op("]")
                e = ast.FuncCall("array_get", [e, idx])
            else:
                return e

    def _type_name(self) -> str:
        name = self.ident()
        # psql qualifies pseudo-types: ::pg_catalog.regclass
        while self.at_op(".") and name.upper() in ("PG_CATALOG",
                                                   "INFORMATION_SCHEMA"):
            self.next()
            name = self.ident()
        if name.upper() == "DOUBLE" and self.at_kw("PRECISION"):
            self.next()
            name = "DOUBLE"
        if name.upper() == "TIMESTAMP" and self.at_kw("WITHOUT", "WITH"):
            # TIMESTAMP WITH[OUT] TIME ZONE — single timestamp type
            self.next()
            self.expect_kw("TIME")
            self.expect_kw("ZONE")
        if self.accept_op("("):  # VARCHAR(n), DECIMAL(p,s) — swallow params
            while not self.at_op(")"):
                self.next()
            self.expect_op(")")
        if self.at_op("["):      # INT[] array type
            self.next()
            self.expect_op("]")
            name = name + "[]"
        return name

    def parse_primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind is T.NUMBER:
            self.next()
            text = t.value
            if "." in text or "e" in text or "E" in text:
                return ast.Literal(float(text))
            v = int(text)
            return ast.Literal(v)
        if t.kind is T.STRING:
            self.next()
            return ast.Literal(t.value)
        if t.kind is T.PARAM:
            self.next()
            return ast.Param(int(t.value))
        if self.accept_op("("):
            if self.at_kw("SELECT", "WITH"):
                inner = self.parse_select()
                self.expect_op(")")
                return ast.Subquery(inner)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind is not T.IDENT:
            raise errors.syntax(f"unexpected token {t.value!r}")
        upper = t.value.upper()
        if upper == "NULL":
            self.next()
            return ast.Literal(None)
        if upper == "TRUE":
            self.next()
            return ast.Literal(True)
        if upper == "FALSE":
            self.next()
            return ast.Literal(False)
        if upper == "CASE":
            return self.parse_case()
        if upper in ("CURRENT_USER", "SESSION_USER", "CURRENT_ROLE",
                     "CURRENT_CATALOG", "CURRENT_SCHEMA", "CURRENT_DATE",
                     "CURRENT_TIMESTAMP", "LOCALTIMESTAMP") and not (
                self.peek(1).kind is T.OP and self.peek(1).value == "("):
            # PG reserved niladic functions: bare keyword, no parens
            self.next()
            fname = {"CURRENT_ROLE": "current_user",
                     "LOCALTIMESTAMP": "current_timestamp"}.get(
                upper, upper.lower())
            return ast.FuncCall(fname, [])
        if upper == "ARRAY" and self.peek(1).kind is T.OP and \
                self.peek(1).value == "(":
            # ARRAY(subquery): first output column gathered into an array
            self.next()
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            return ast.ArraySubquery(sub)
        if upper == "ARRAY" and self.peek(1).kind is T.OP and \
                self.peek(1).value == "[":
            self.next()
            self.expect_op("[")
            items = []
            if not self.at_op("]"):
                items.append(self.parse_expr())
                while self.accept_op(","):
                    items.append(self.parse_expr())
            self.expect_op("]")
            # array-ness is syntactic, not sniffed from values: elements
            # that are themselves array-producing expressions splice as
            # nested arrays; plain strings never do
            array_funcs = {"make_array", "__make_array", "array_append", "array_cat",
                           "array_agg", "string_to_array"}
            splice = [i for i, it in enumerate(items)
                      if isinstance(it, ast.FuncCall)
                      and it.name.lower() in array_funcs]
            return ast.FuncCall("__make_array",
                                [ast.Literal(",".join(map(str, splice)))]
                                + items)
        if upper == "EXISTS" and self.peek(1).kind is T.OP and \
                self.peek(1).value == "(":
            self.next()
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            return ast.Exists(sub)
        if upper == "CAST":
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("AS")
            tn = self._type_name()
            self.expect_op(")")
            return ast.Cast(e, tn)
        if upper == "EXTRACT":
            self.next()
            self.expect_op("(")
            t_fld = self.peek()
            fld = self.next().value if t_fld.kind in (T.IDENT, T.STRING) \
                else self.ident()
            self.expect_kw("FROM")
            e = self.parse_expr()
            self.expect_op(")")
            return ast.FuncCall("extract", [ast.Literal(fld.lower()), e])
        if upper == "INTERVAL":
            self.next()
            lit = self.next()
            if lit.kind is not T.STRING:
                raise errors.syntax("INTERVAL requires a string literal")
            return ast.Cast(ast.Literal(lit.value), "INTERVAL")
        if upper == "POSITION" and self.peek(1).kind is T.OP and \
                self.peek(1).value == "(":
            # PG: position(substr IN str) = strpos(str, substr)
            self.next()
            self.expect_op("(")
            sub = self.parse_additive_chain()
            if self.accept_kw("IN"):
                s = self.parse_expr()
                self.expect_op(")")
                return ast.FuncCall("strpos", [s, sub])
            args = [sub]
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return ast.FuncCall("position", args)
        if upper == "TRIM" and self.peek(1).kind is T.OP and \
                self.peek(1).value == "(":
            # PG: trim([LEADING|TRAILING|BOTH] [chars] FROM str)
            #     also trim(str) / trim(str, chars)
            save = self.i
            self.next()
            self.expect_op("(")
            side = "both"
            if self.at_kw("LEADING", "TRAILING", "BOTH"):
                side = self.next().value.lower()
            if self.accept_kw("FROM"):      # trim(LEADING FROM s)
                s = self.parse_expr()
                self.expect_op(")")
                fn = {"leading": "ltrim", "trailing": "rtrim",
                      "both": "btrim"}[side]
                return ast.FuncCall(fn, [s])
            first = self.parse_expr()
            if self.accept_kw("FROM"):
                s = self.parse_expr()
                self.expect_op(")")
                fn = {"leading": "ltrim", "trailing": "rtrim",
                      "both": "btrim"}[side]
                return ast.FuncCall(fn, [s, first])
            if side != "both":
                raise errors.syntax("expected FROM in trim()")
            # plain call form: rewind and let the generic path handle it
            self.i = save
        if upper == "SUBSTRING" and self.peek(1).kind is T.OP and \
                self.peek(1).value == "(":
            # PG: substring(str FROM n [FOR k]) — also plain (s, n[, k])
            self.next()
            self.expect_op("(")
            s = self.parse_expr()
            if self.at_kw("FROM") or self.at_kw("FOR"):
                from_kw = bool(self.accept_kw("FROM"))
                if not from_kw:
                    self.expect_kw("FOR")
                first = self.parse_expr()
                if from_kw:
                    args = [s, first]
                    if self.accept_kw("FOR"):
                        args.append(self.parse_expr())
                else:  # substring(s FOR k) = substr(s, 1, k)
                    args = [s, ast.Literal(1), first]
                self.expect_op(")")
                return ast.FuncCall("substr", args)
            args = [s]
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return ast.FuncCall("substr", args)
        if upper == "OVERLAY" and self.peek(1).kind is T.OP and \
                self.peek(1).value == "(":
            # PG: overlay(str PLACING repl FROM n [FOR k])
            save = self.i
            self.next()
            self.expect_op("(")
            s = self.parse_expr()
            if self.accept_kw("PLACING"):
                repl = self.parse_expr()
                self.expect_kw("FROM")
                start = self.parse_expr()
                args = [s, repl, start]
                if self.accept_kw("FOR"):
                    args.append(self.parse_expr())
                self.expect_op(")")
                return ast.FuncCall("overlay", args)
            self.i = save   # plain overlay(a, b, c[, d]) call form
        if upper in ("DATE", "TIMESTAMP") and self.peek(1).kind is T.STRING:
            self.next()
            lit = self.next()
            return ast.Cast(ast.Literal(lit.value), upper)
        # identifier: column ref or function call
        parts = [self.ident()]
        while self.accept_op("."):
            if self.at_op("*"):
                self.next()
                return ast.Star(table=parts[-1])
            parts.append(self.ident())
        if self.at_op("("):
            self.next()
            if len(parts) > 1 and parts[0].lower() in ("pg_catalog",
                                                       "information_schema"):
                parts = parts[1:]
            name = ".".join(parts).lower()
            distinct = False
            star = False
            args: list[ast.Expr] = []
            if self.at_op("*"):
                self.next()
                star = True
            elif not self.at_op(")"):
                if self.accept_kw("DISTINCT"):
                    distinct = True
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            agg_order = None
            if self.accept_kw("ORDER"):
                # ordered-set aggregates: string_agg(x, s ORDER BY k)
                self.expect_kw("BY")
                agg_order = [self.parse_order_item()]
                while self.accept_op(","):
                    agg_order.append(self.parse_order_item())
            self.expect_op(")")
            call = ast.FuncCall(name, args, distinct, star,
                                agg_order=agg_order)
            if self.at_kw("FILTER"):
                self.next()
                self.expect_op("(")
                self.expect_kw("WHERE")
                call.filter = self.parse_expr()
                self.expect_op(")")
            if self.at_kw("OVER"):
                if call.filter is not None:
                    raise errors.unsupported("FILTER with window functions")
                if call.agg_order:
                    raise errors.unsupported(
                        "ORDER BY inside a window function call")
                self.next()
                self.expect_op("(")
                partition = []
                order = []
                if self.accept_kw("PARTITION"):
                    self.expect_kw("BY")
                    partition.append(self.parse_expr())
                    while self.accept_op(","):
                        partition.append(self.parse_expr())
                if self.accept_kw("ORDER"):
                    self.expect_kw("BY")
                    order.append(self.parse_order_item())
                    while self.accept_op(","):
                        order.append(self.parse_order_item())
                frame = None
                if self.at_kw("ROWS", "RANGE", "GROUPS"):
                    frame = self.parse_window_frame()
                self.expect_op(")")
                return ast.WindowFunc(call, partition, order, frame)
            return call
        return ast.ColumnRef(parts)

    def parse_window_frame(self):
        """ROWS frames: (start_off, end_off) offsets, None = unbounded.
        RANGE is accepted only in its default-frame spellings; GROUPS is
        unsupported (PG parity: ROWS covers the reference workloads)."""
        mode = self.ident().upper()
        if mode == "GROUPS":
            raise errors.unsupported("GROUPS window frames")

        def bound(is_end: bool):
            if self.accept_kw("UNBOUNDED"):
                if self.accept_kw("PRECEDING"):
                    return None, "preceding"
                self.expect_kw("FOLLOWING")
                return None, "following"
            if self.accept_kw("CURRENT"):
                self.expect_kw("ROW")
                return 0, "current"
            t = self.peek()
            if t.kind is not T.NUMBER:
                raise errors.syntax("expected frame bound")
            nv = self.next().value
            if self.accept_kw("PRECEDING"):
                return -int(nv), "preceding"
            self.expect_kw("FOLLOWING")
            return int(nv), "following"

        if self.accept_kw("BETWEEN"):
            s_off, s_kind = bound(False)
            self.expect_kw("AND")
            e_off, e_kind = bound(True)
        else:
            s_off, s_kind = bound(False)
            e_off, e_kind = 0, "current"
        if s_kind == "following" and s_off is None:
            raise errors.syntax(
                "frame start cannot be UNBOUNDED FOLLOWING")
        if e_kind == "preceding" and e_off is None:
            raise errors.syntax(
                "frame end cannot be UNBOUNDED PRECEDING")
        # PG 42P20: the frame start may not lie after the frame end
        if s_kind == "current" and e_kind == "preceding":
            raise SqlError("42P20", "frame starting from current row "
                                    "cannot have preceding rows")
        if s_kind == "following" and e_kind in ("current", "preceding"):
            raise SqlError("42P20", "frame starting from following row "
                                    "cannot have preceding rows")
        if s_off is not None and e_off is not None and s_off > e_off:
            raise SqlError("42P20", "frame start cannot be after "
                                    "frame end")
        if mode == "RANGE":
            # only the default-frame spellings of RANGE are supported
            if (s_off, e_off) == (None, 0) and s_kind == "preceding":
                return None
            raise errors.unsupported(
                "RANGE window frames (use ROWS)")
        return (s_off, e_off)

    def parse_case(self) -> ast.Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        branches = []
        while self.accept_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            branches.append((cond, self.parse_expr()))
        else_ = self.parse_expr() if self.accept_kw("ELSE") else None
        self.expect_kw("END")
        return ast.Case(operand, branches, else_)

    # -- DDL/DML -----------------------------------------------------------

    def qualified_name(self) -> list[str]:
        parts = [self.ident()]
        while self.accept_op("."):
            parts.append(self.ident())
        return parts

    def parse_create(self) -> ast.Statement:
        self.expect_kw("CREATE")
        or_replace = False
        if self.accept_kw("OR"):
            self.expect_kw("REPLACE")
            or_replace = True
        if self.accept_kw("SCHEMA"):
            ine = self._if_not_exists()
            return ast.CreateSchema(self.ident(), ine)
        if self.accept_kw("VIEW"):
            name = self.qualified_name()
            self.expect_kw("AS")
            body_pos = self.peek().pos   # token-accurate body start —
            # quoted identifiers containing ' as ' can't fool this
            st = ast.CreateView(name, self.parse_select(), or_replace)
            st.body_pos = body_pos
            return st
        if self.accept_kw("INDEX"):
            ine = self._if_not_exists()
            idx_name = None
            if not self.at_kw("ON"):
                idx_name = self.ident()
            self.expect_kw("ON")
            table = self.qualified_name()
            using = None   # default resolved by column type at exec
            if self.accept_kw("USING"):
                using = self.ident().lower()
            self.expect_op("(")
            cols = []
            col_toks: dict = {}
            while True:
                col = self.ident()
                cols.append(col)
                # optional per-column tokenizer/dictionary name — inverted
                # indexes only (reference: USING inverted(text imdb_en));
                # ASC/DESC stay syntax errors for other index types
                if self.peek().kind is T.IDENT and not self.at_op(","):
                    if using is not None and using != "inverted":
                        raise errors.syntax(
                            f"unexpected {self.peek().value!r} in index "
                            "column list")
                    col_toks[col] = self.ident()
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            opts = self._with_options()
            return ast.CreateIndex(idx_name, table, cols, using, ine, opts,
                                   col_toks)
        if self.at_kw("TEXT"):
            # CREATE TEXT SEARCH DICTIONARY name (key = value, ...)
            self.next()
            self.expect_kw("SEARCH")
            self.expect_kw("DICTIONARY")
            ine = self._if_not_exists()
            name = self.ident()
            opts: dict = {}
            if self.accept_op("("):
                while True:
                    key = self.ident().lower()
                    self.expect_op("=")
                    t = self.next()
                    if t.kind is T.NUMBER:
                        opts[key] = float(t.value) if "." in t.value \
                            else int(t.value)
                    elif t.kind is T.IDENT and t.value.upper() in \
                            ("TRUE", "FALSE"):
                        opts[key] = t.value.upper() == "TRUE"
                    else:
                        opts[key] = t.value
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            return ast.CreateTsDictionary(name, opts, ine)
        if self.accept_kw("ROLE") or self.accept_kw("USER"):
            ine = self._if_not_exists()
            name = self.ident()
            password = None
            login = True
            superuser = False
            while True:
                if self.accept_kw("PASSWORD"):
                    t = self.next()
                    password = t.value
                elif self.accept_kw("LOGIN"):
                    login = True
                elif self.accept_kw("NOLOGIN"):
                    login = False
                elif self.accept_kw("SUPERUSER"):
                    superuser = True
                elif self.accept_kw("WITH"):
                    continue
                else:
                    break
            return ast.CreateRole(name, password, login, superuser, ine)
        if self.accept_kw("TYPE"):
            ine = self._if_not_exists()
            name = self.ident()
            self.expect_kw("AS")
            self.expect_kw("ENUM")
            self.expect_op("(")
            labels = []
            if not self.at_op(")"):
                t = self.next()
                if t.kind is not T.STRING:
                    raise errors.syntax("enum labels must be string literals")
                labels.append(t.value)
                while self.accept_op(","):
                    t = self.next()
                    if t.kind is not T.STRING:
                        raise errors.syntax(
                            "enum labels must be string literals")
                    labels.append(t.value)
            self.expect_op(")")
            return ast.CreateType(name, "enum", labels, None, ine)
        if self.accept_kw("DOMAIN"):
            ine = self._if_not_exists()
            name = self.ident()
            self.expect_kw("AS")
            base = self._type_name()
            return ast.CreateType(name, "domain", [], base, ine)
        if self.accept_kw("SEQUENCE"):
            ine = self._if_not_exists()
            name = self.qualified_name()
            start = 1
            increment = 1
            while self.peek().kind is T.IDENT and \
                    self.peek().value.upper() in ("START", "INCREMENT"):
                word = self.ident().upper()
                self.accept_kw("WITH") or self.accept_kw("BY")
                sign = -1 if self.accept_op("-") else 1
                t = self.next()
                if t.kind is not T.NUMBER:
                    raise errors.syntax("expected number in SEQUENCE options")
                if word == "START":
                    start = sign * int(t.value)
                else:
                    increment = sign * int(t.value)
            return ast.CreateSequence(name, start, increment, ine)
        self.expect_kw("TABLE")
        ine = self._if_not_exists()
        name = self.qualified_name()
        if self.at_kw("AS") or (self.at_kw("USING", "WITH") and False):
            pass
        columns: list[ast.ColumnDef] = []
        pk: list[str] = []
        if self.accept_op("("):
            while True:
                if self.accept_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    self.expect_op("(")
                    pk = [self.ident()]
                    while self.accept_op(","):
                        pk.append(self.ident())
                    self.expect_op(")")
                else:
                    columns.append(self._column_def())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        engine = "columnar"
        if self.accept_kw("USING"):
            engine = self.ident().lower()
        opts = self._with_options()
        if "engine" in opts:
            engine = str(opts.pop("engine")).lower()
        as_query = None
        if self.accept_kw("AS"):
            as_query = self.parse_select()
        pk = pk or [c.name for c in columns if c.primary_key]
        return ast.CreateTable(name, columns, engine, ine, opts, as_query, pk)

    def _column_def(self) -> ast.ColumnDef:
        name = self.ident()
        type_name = self._type_name()
        d = ast.ColumnDef(name, type_name)
        while True:
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                d.not_null = True
            elif self.accept_kw("NULL"):
                pass
            elif self.accept_kw("PRIMARY"):
                self.expect_kw("KEY")
                d.primary_key = True
                d.not_null = True
            elif self.accept_kw("DEFAULT"):
                d.default = self.parse_expr()
            elif self.accept_kw("TOKENIZER"):  # search-table column analyzer
                d.tokenizer = self.next().value
            else:
                break
        return d

    def _if_not_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _with_options(self) -> dict:
        opts: dict = {}
        if self.accept_kw("WITH"):
            self.expect_op("(")
            while True:
                key = self.ident().lower()
                self.expect_op("=")
                t = self.next()
                if t.kind is T.NUMBER:
                    opts[key] = float(t.value) if "." in t.value else int(t.value)
                else:
                    opts[key] = t.value
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return opts

    def parse_drop(self) -> ast.Drop:
        self.expect_kw("DROP")
        if self.accept_kw("TABLE"):
            kind = "table"
        elif self.accept_kw("INDEX"):
            kind = "index"
        elif self.accept_kw("SCHEMA"):
            kind = "schema"
        elif self.accept_kw("VIEW"):
            kind = "view"
        elif self.accept_kw("SEQUENCE"):
            kind = "sequence"
        elif self.accept_kw("TYPE") or self.accept_kw("DOMAIN"):
            kind = "type"
        elif self.accept_kw("ROLE") or self.accept_kw("USER"):
            if_exists = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            return ast.DropRole(self.ident(), if_exists)
        elif self.at_kw("TEXT"):
            self.next()
            self.expect_kw("SEARCH")
            self.expect_kw("DICTIONARY")
            if_exists = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            return ast.Drop("tsdictionary", [self.ident()], if_exists,
                            False)
        else:
            raise errors.unsupported("DROP of that object kind")
        if_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        name = self.qualified_name()
        cascade = bool(self.accept_kw("CASCADE"))
        self.accept_kw("RESTRICT")
        return ast.Drop(kind, name, if_exists, cascade)

    def parse_insert(self) -> ast.Insert:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self.qualified_name()
        columns = None
        if self.accept_op("("):
            columns = [self.ident()]
            while self.accept_op(","):
                columns.append(self.ident())
            self.expect_op(")")
        if self.at_kw("VALUES"):
            self.next()
            rows = [self._parse_insert_row()]
            while self.accept_op(","):
                rows.append(self._parse_insert_row())
            oc = self._parse_on_conflict()
            return ast.Insert(table, columns, rows,
                              returning=self._parse_returning(),
                              on_conflict=oc)
        if self.at_kw("SELECT"):
            q = self.parse_select()
            oc = self._parse_on_conflict()
            return ast.Insert(table, columns, None, q,
                              returning=self._parse_returning(),
                              on_conflict=oc)
        raise errors.syntax("expected VALUES or SELECT in INSERT")

    def _parse_insert_row(self) -> list[ast.Expr]:
        """A VALUES row where a bare DEFAULT element is allowed."""
        self.expect_op("(")
        exprs = []
        while True:
            if self.at_kw("DEFAULT"):
                self.next()
                exprs.append(ast.DefaultMarker())
            else:
                exprs.append(self.parse_expr())
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return exprs

    def _parse_on_conflict(self) -> Optional[tuple]:
        if not self.at_kw("ON"):
            return None
        self.next()
        self.expect_kw("CONFLICT")
        target = []
        if self.accept_op("("):
            target.append(self.ident().lower())
            while self.accept_op(","):
                target.append(self.ident().lower())
            self.expect_op(")")
        self.expect_kw("DO")
        if self.accept_kw("NOTHING"):
            return ("nothing", target, [])
        self.expect_kw("UPDATE")
        self.expect_kw("SET")
        assigns = []
        while True:
            col = self.ident()
            self.expect_op("=")
            assigns.append((col, self.parse_expr()))
            if not self.accept_op(","):
                break
        return ("update", target, assigns)

    def _parse_returning(self) -> list:
        if not self.accept_kw("RETURNING"):
            return []
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())
        return items

    def parse_delete(self) -> ast.Delete:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        table = self.qualified_name()
        using_ref = None
        if self.accept_kw("USING"):
            using_ref = self.parse_from()
        where = self.parse_expr() if self.accept_kw("WHERE") else None
        return ast.Delete(table, where,
                          returning=self._parse_returning(),
                          using_ref=using_ref)

    def parse_update(self) -> ast.Update:
        self.expect_kw("UPDATE")
        table = self.qualified_name()
        self.expect_kw("SET")
        assigns = []
        while True:
            col = self.ident()
            self.expect_op("=")
            if self.at_kw("DEFAULT"):
                self.next()
                assigns.append((col, ast.DefaultMarker()))
            else:
                assigns.append((col, self.parse_expr()))
            if not self.accept_op(","):
                break
        from_ref = None
        if self.accept_kw("FROM"):
            from_ref = self.parse_from()
        where = self.parse_expr() if self.accept_kw("WHERE") else None
        return ast.Update(table, assigns, where,
                          returning=self._parse_returning(),
                          from_ref=from_ref)

    def parse_set(self) -> ast.Statement:
        self.expect_kw("SET")
        self.accept_kw("SESSION") or self.accept_kw("LOCAL")
        if self.at_kw("ROLE"):
            self.next()
            if self.accept_kw("NONE"):
                return ast.SetRole(None)
            return ast.SetRole(self.ident())
        name = self.ident().lower()
        if not (self.accept_op("=") or self.accept_kw("TO")):
            raise errors.syntax("expected = or TO in SET")
        t = self.peek()
        if t.kind is T.IDENT and t.value.upper() == "DEFAULT":
            self.next()
            return ast.SetStmt(name, "DEFAULT")
        if t.kind is T.STRING:
            self.next()
            return ast.SetStmt(name, t.value)
        if t.kind is T.NUMBER:
            self.next()
            return ast.SetStmt(name, float(t.value) if "." in t.value else int(t.value))
        if t.kind is T.OP and t.value == "-":
            # negative numeric value (PG: SET log_min_duration... = -1)
            self.next()
            t2 = self.peek()
            if t2.kind is T.NUMBER:
                self.next()
                return ast.SetStmt(
                    name, -float(t2.value) if "." in t2.value
                    else -int(t2.value))
            raise errors.syntax("bad SET value")
        if t.kind is T.IDENT:
            self.next()
            v = t.value
            if v.upper() in ("ON", "TRUE"):
                return ast.SetStmt(name, True)
            if v.upper() in ("OFF", "FALSE"):
                return ast.SetStmt(name, False)
            return ast.SetStmt(name, v)
        raise errors.syntax("bad SET value")

    def parse_alter(self):
        self.expect_kw("ALTER")
        if self.accept_kw("ROLE") or self.accept_kw("USER"):
            name = self.ident()
            set_pw, password = False, None
            login = superuser = None
            n_opts = 0
            while True:
                n_opts += 1
                if self.accept_kw("PASSWORD"):
                    if set_pw:
                        raise errors.syntax(
                            "conflicting or redundant options")
                    set_pw = True
                    if self.accept_kw("NULL"):
                        password = None
                    else:
                        t = self.next()
                        if t.kind is not T.STRING:
                            raise errors.syntax(
                                "PASSWORD requires a string or NULL")
                        password = t.value
                elif self.accept_kw("LOGIN", "NOLOGIN"):
                    if login is not None:
                        raise errors.syntax(
                            "conflicting or redundant options")
                    login = self.toks[self.i - 1].value.upper() == "LOGIN"
                elif self.accept_kw("SUPERUSER", "NOSUPERUSER"):
                    if superuser is not None:
                        raise errors.syntax(
                            "conflicting or redundant options")
                    superuser = self.toks[self.i - 1].value.upper() == \
                        "SUPERUSER"
                elif n_opts == 1 and self.accept_kw("WITH"):
                    continue
                else:
                    n_opts -= 1
                    break
            if n_opts == 0:
                raise errors.syntax("ALTER ROLE requires at least one option")
            return ast.AlterRole(name, set_pw, password, login, superuser)
        self.expect_kw("TABLE")
        if_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        table = self.qualified_name()
        if self.accept_kw("ADD"):
            self.accept_kw("COLUMN")
            ine = self._if_not_exists()
            col = self.ident()
            tn = self._type_name()
            return ast.AlterTable(table, "add_column", col, tn,
                                  if_exists=if_exists, if_not_exists=ine)
        if self.accept_kw("DROP"):
            self.accept_kw("COLUMN")
            ife2 = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                ife2 = True
            col = self.ident()
            return ast.AlterTable(table, "drop_column", col,
                                  if_exists=if_exists, col_if_exists=ife2)
        if self.accept_kw("RENAME"):
            if self.accept_kw("COLUMN"):
                col = self.ident()
                self.expect_kw("TO")
                return ast.AlterTable(table, "rename_column", col,
                                      new_name=self.ident(),
                                      if_exists=if_exists)
            self.expect_kw("TO")
            return ast.AlterTable(table, "rename_table",
                                  new_name=self.ident(), if_exists=if_exists)
        raise errors.unsupported("that ALTER TABLE action")

    def parse_copy(self) -> ast.CopyStmt:
        self.expect_kw("COPY")
        query = None
        table: list[str] = []
        columns = None
        if self.at_op("("):
            # COPY ( query ) TO ... (PG: queries export, never import)
            self.accept_op("(")
            query = self.parse_select()
            self.expect_op(")")
        else:
            table = self.qualified_name()
            if self.accept_op("("):
                columns = [self.ident()]
                while self.accept_op(","):
                    columns.append(self.ident())
                self.expect_op(")")
        if self.accept_kw("FROM"):
            if query is not None:
                raise errors.syntax("COPY query is only allowed with TO")
            direction = "from"
        else:
            self.expect_kw("TO")
            direction = "to"
        t = self.peek()
        if t.kind is T.STRING:
            target = self.next().value
        elif self.accept_kw("STDIN"):
            target = "STDIN"
        elif self.accept_kw("STDOUT"):
            target = "STDOUT"
        else:
            raise errors.syntax("expected filename, STDIN or STDOUT")
        opts: dict = {}
        if self.accept_op("("):
            while True:
                key = self.ident().lower()
                if self.peek().kind in (T.IDENT, T.STRING, T.NUMBER):
                    opts[key] = self.next().value
                else:
                    opts[key] = True
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        elif self.accept_kw("WITH"):
            if self.accept_op("("):
                while True:
                    key = self.ident().lower()
                    if self.peek().kind in (T.IDENT, T.STRING, T.NUMBER):
                        opts[key] = self.next().value
                    else:
                        opts[key] = True
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
        return ast.CopyStmt(table, columns, direction, target, opts,
                            query=query)

    def parse_vacuum(self) -> ast.VacuumStmt:
        self.expect_kw("VACUUM")
        verbs = []
        while self.at_kw("REFRESH", "COMPACT", "CLEANUP", "FULL", "ANALYZE"):
            verbs.append(self.ident().lower())
        table = None
        if self.peek().kind is T.IDENT:
            table = self.qualified_name()
        return ast.VacuumStmt(table, verbs)


_PARSE_CACHE: dict = {}
_PARSE_CACHE_MAX = 512


def parse(sql: str) -> list[ast.Statement]:
    """Parse with a copy-on-read AST cache (the reference caches parse
    trees the same way: PEG parser cache, server_engine.cpp:310-314).
    Deep copies are handed out because the planner mutates ASTs."""
    import copy
    cached = _PARSE_CACHE.get(sql)
    if cached is None:
        cached = Parser(sql).parse_statements()
        if len(_PARSE_CACHE) >= _PARSE_CACHE_MAX:
            _PARSE_CACHE.clear()
        _PARSE_CACHE[sql] = cached
    return copy.deepcopy(cached)


def parse_one(sql: str) -> ast.Statement:
    stmts = parse(sql)
    if len(stmts) != 1:
        raise errors.syntax("expected a single statement")
    return stmts[0]
