"""Copied from serenedb_tpu/sql/ast.py.

Parsed (unbound) AST for SQL statements and expressions."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


# -- expressions -----------------------------------------------------------

class Expr:
    pass


@dataclass
class Literal(Expr):
    value: Any           # python value; None for NULL
    type_hint: Optional[str] = None


@dataclass
class ColumnRef(Expr):
    parts: list[str]     # possibly qualified: [table, column] or [column]


@dataclass
class Star(Expr):
    table: Optional[str] = None


@dataclass
class Param(Expr):
    index: int           # 1-based


@dataclass
class BinaryOp(Expr):
    op: str              # '+', '-', '*', '/', '%', '||', '=', '<>', '<', ...
    left: Expr
    right: Expr


@dataclass
class UnaryOp(Expr):
    op: str              # '-', 'NOT'
    operand: Expr


@dataclass
class Logical(Expr):
    op: str              # 'AND' | 'OR'
    args: list[Expr]


@dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    operand: Expr
    items: list[Expr]
    negated: bool = False


@dataclass
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class Like(Expr):
    operand: Expr
    pattern: Expr
    negated: bool = False
    case_insensitive: bool = False
    escape: Optional[str] = None   # LIKE ... ESCAPE 'c' 


@dataclass
class FuncCall(Expr):
    name: str
    args: list[Expr]
    distinct: bool = False
    star: bool = False   # count(*)
    filter: Optional[Expr] = None   # aggregate FILTER (WHERE ...)
    agg_order: Optional[list] = None  # string_agg(x, s ORDER BY ...)


@dataclass
class WindowFunc(Expr):
    func: "FuncCall"
    partition_by: list = None
    order_by: list = None     # list[OrderItem]
    #: ROWS frame as (start, end) row offsets relative to the current
    #: row; None member = unbounded in that direction; whole-field None =
    #: the default frame (RANGE UNBOUNDED PRECEDING .. CURRENT ROW)
    frame: "tuple | None" = None

    def __post_init__(self):
        if self.partition_by is None:
            self.partition_by = []
        if self.order_by is None:
            self.order_by = []


@dataclass
class Cast(Expr):
    operand: Expr
    type_name: str


@dataclass
class Case(Expr):
    operand: Optional[Expr]          # CASE <operand> WHEN ... or searched CASE
    branches: list[tuple[Expr, Expr]]
    else_: Optional[Expr]


@dataclass
class Subquery(Expr):
    query: "Select"
    # EXISTS/IN-subquery support comes with joins


# -- statements ------------------------------------------------------------

class Statement:
    pass


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class TableRef:
    pass


@dataclass
class NamedTable(TableRef):
    parts: list[str]                 # [schema, table] or [table]
    alias: Optional[str] = None


@dataclass
class TableFunction(TableRef):
    name: str
    args: list[Expr]
    alias: Optional[str] = None
    col_aliases: Optional[list[str]] = None   # FROM fn(...) t(a, b)


@dataclass
class SubqueryRef(TableRef):
    query: "Select"
    alias: Optional[str] = None
    col_aliases: Optional[list[str]] = None   # FROM (…) v(a, b)


@dataclass
class JoinRef(TableRef):
    kind: str                        # 'inner' | 'left' | 'right' | 'cross'
    left: TableRef
    right: TableRef
    condition: Optional[Expr] = None
    using: Optional[list[str]] = None


@dataclass
class OrderItem:
    expr: Expr
    desc: bool = False
    nulls_first: Optional[bool] = None


@dataclass
class Select(Statement):
    items: list[SelectItem]
    from_: Optional[TableRef] = None
    where: Optional[Expr] = None
    group_by: list[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    distinct: bool = False
    distinct_on: Optional[list[Expr]] = None      # DISTINCT ON (exprs)
    ctes: dict = field(default_factory=dict)      # name -> Select (WITH)


@dataclass
class SetOp(Statement):
    op: str                    # 'union' | 'intersect' | 'except'
    all: bool
    left: "Select | SetOp"
    right: "Select | SetOp"
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    ctes: dict = field(default_factory=dict)


@dataclass
class CteDef:
    """A WITH binding that needs more than plain inlining: an explicit
    column list and/or RECURSIVE iteration (PG: base UNION [ALL] step)."""
    query: "Select | SetOp"
    cols: Optional[list[str]] = None
    recursive: bool = False


@dataclass
class Exists(Expr):
    query: "Select"
    negated: bool = False


@dataclass
class InSubquery(Expr):
    operand: Expr
    query: "Select"
    negated: bool = False


@dataclass
class ArraySubquery(Expr):
    """ARRAY(SELECT ...): first output column gathered into an array."""
    query: "Select"


@dataclass
class DefaultMarker(Expr):
    """Bare DEFAULT in INSERT VALUES / UPDATE SET — replaced by the
    column's default expression (or NULL) at execution."""


@dataclass
class ColumnDef:
    name: str
    type_name: str
    not_null: bool = False
    primary_key: bool = False
    default: Optional[Expr] = None
    tokenizer: Optional[str] = None   # search-table column analyzer


@dataclass
class CreateTable(Statement):
    name: list[str]
    columns: list[ColumnDef]
    engine: str = "columnar"          # 'columnar' | 'search'  (reference: table_options.h:160)
    if_not_exists: bool = False
    options: dict = field(default_factory=dict)
    as_query: Optional[Select] = None
    primary_key: list[str] = field(default_factory=list)


@dataclass
class CreateIndex(Statement):
    name: Optional[str]
    table: list[str]
    columns: list[str]
    using: str = "inverted"    # 'inverted' | 'btree' | 'ivf' | 'maxsim' | ...
    if_not_exists: bool = False
    options: dict = field(default_factory=dict)
    column_tokenizers: dict = field(default_factory=dict)


@dataclass
class CreateSchema(Statement):
    name: str
    if_not_exists: bool = False


@dataclass
class AlterTable(Statement):
    table: list[str]
    action: str               # add_column | drop_column | rename_column | rename_table
    column: Optional[str] = None
    type_name: Optional[str] = None
    new_name: Optional[str] = None
    if_exists: bool = False          # table-level: ALTER TABLE IF EXISTS
    col_if_exists: bool = False      # column-level: DROP COLUMN IF EXISTS
    if_not_exists: bool = False


@dataclass
class CreateTsDictionary(Statement):
    name: str
    options: dict
    if_not_exists: bool = False


@dataclass
class CreateType(Statement):
    """CREATE TYPE name AS ENUM (labels) / CREATE DOMAIN name AS base."""
    name: str
    kind: str                     # 'enum' | 'domain'
    labels: list = field(default_factory=list)   # enum labels, in order
    base: Optional[str] = None    # domain base type name
    if_not_exists: bool = False


@dataclass
class CreateSequence(Statement):
    name: list[str]
    start: int = 1
    increment: int = 1
    if_not_exists: bool = False


@dataclass
class Drop(Statement):
    kind: str          # 'table' | 'index' | 'schema' | 'view' | 'sequence'
    name: list[str]
    if_exists: bool = False
    cascade: bool = False


@dataclass
class Insert(Statement):
    table: list[str]
    columns: Optional[list[str]]
    values: Optional[list[list[Expr]]]
    query: Optional[Select] = None
    returning: list = field(default_factory=list)   # list[SelectItem]
    #: ON CONFLICT: (action, target_cols, assignments) where action is
    #: "nothing" | "update"; assignments may reference excluded.col
    on_conflict: Optional[tuple] = None


@dataclass
class Delete(Statement):
    table: list[str]
    where: Optional[Expr] = None
    returning: list = field(default_factory=list)
    using_ref: Optional[TableRef] = None   # DELETE ... USING <tables>


@dataclass
class Update(Statement):
    table: list[str]
    assignments: list[tuple[str, Expr]]
    where: Optional[Expr] = None
    returning: list = field(default_factory=list)
    from_ref: Optional[TableRef] = None    # UPDATE ... FROM <tables>


@dataclass
class CreateView(Statement):
    name: list[str]
    query: Select
    or_replace: bool = False


@dataclass
class SetStmt(Statement):
    name: str
    value: Any                        # python literal or 'DEFAULT'


@dataclass
class ShowStmt(Statement):
    name: str                         # setting name or 'all' / 'tables'


@dataclass
class ListenStmt(Statement):
    channel: str
    action: str = "listen"        # listen | unlisten | unlisten_all


@dataclass
class NotifyStmt(Statement):
    channel: str
    payload: str = ""


@dataclass
class Transaction(Statement):
    action: str                       # begin|commit|rollback|savepoint|
                                      # rollback_to|release
    savepoint: Optional[str] = None


@dataclass
class Explain(Statement):
    inner: Statement
    analyze: bool = False
    format: str = "text"              # 'text' | 'json' (PG FORMAT option)


@dataclass
class CopyStmt(Statement):
    table: list[str]
    columns: Optional[list[str]]
    direction: str                    # 'from' | 'to'
    target: str                       # filename or STDIN/STDOUT
    options: dict = field(default_factory=dict)
    query: Optional[Statement] = None  # COPY (SELECT ...) TO ...


@dataclass
class VacuumStmt(Statement):
    table: Optional[list[str]] = None
    verbs: list[str] = field(default_factory=list)   # refresh/compact/cleanup


@dataclass
class Truncate(Statement):
    table: list[str]


@dataclass
class CreateRole(Statement):
    name: str
    password: Optional[str] = None
    login: bool = True
    superuser: bool = False
    if_not_exists: bool = False


@dataclass
class DropRole(Statement):
    name: str
    if_exists: bool = False


@dataclass
class AlterRole(Statement):
    name: str
    set_password: bool = False     # PASSWORD clause present
    password: object = None        # None with set_password = clear it
    login: object = None           # None = unchanged
    superuser: object = None       # None = unchanged


@dataclass
class GrantRevoke(Statement):
    grant: bool                       # True=GRANT, False=REVOKE
    privileges: list[str]             # select/insert/update/delete/all
    table: list[str]                  # [] for role-membership grants
    role: str
    granted_role: Optional[str] = None   # GRANT <granted_role> TO <role>


@dataclass
class SetRole(Statement):
    name: Optional[str]               # None = RESET ROLE
