"""Copied from serenedb_tpu/functions/volatility.py.

Scalar-function volatility classification (PG's volatility classes).

Reference analog: PostgreSQL's provolatile — every function is
IMMUTABLE (pure: same arguments, same result, forever), STABLE (fixed
within one statement but free to change between statements: now(),
current_setting(), subquery expressions over table state the plan walk
cannot see) or VOLATILE (every evaluation may differ: random(),
nextval(), clock_timestamp()).

Three consumers, three different bars:

- bind-time literal folding (binder._fold_if_const): STABLE is foldable
  — binding happens once per statement, so folding now() IS its
  statement-stability. Only VOLATILE must re-evaluate per call.
- analysis-time folding (binder.fold_constant, the zone-map interval
  extractor): only IMMUTABLE folds. A stable value folded during
  analysis could disagree with the per-row evaluation (a scan crossing
  midnight must not prune blocks with the stale day).
- the result cache (cache/result.py): only IMMUTABLE may appear in a
  cached plan. STABLE results vary between statements even when no
  table changed (the publication tuples in the cache key capture data
  state, not wall-clock state), and VOLATILE must never be replayed.

Anything not classified here defaults to IMMUTABLE — the scalar library
(functions/scalar.py) is pure by construction; stateful functions are
the enumerated exceptions. Name-prefix rules catch whole families:
`sdb_*` table/introspection helpers are VOLATILE (they read live engine
state), `pg_*` catalog readers are STABLE (they read the catalog, which
the cache key does not observe).
"""

from __future__ import annotations

IMMUTABLE = "immutable"
STABLE = "stable"
VOLATILE = "volatile"

#: every evaluation may return a different value — never folded, never
#: cached, evaluated once per row when used as a column DEFAULT
VOLATILE_FUNCS = frozenset({
    "random", "setseed",
    "nextval", "setval",
    "gen_random_uuid", "uuid_generate_v4",
    "clock_timestamp", "timeofday",
    "ai_embed",          # remote model call
    "set_config",
    # secret-store mutators (functions/embedfns.py): SELECT-invoked
    # side effects must run on every execution, never replay
    "create_secret", "drop_secret",
})

#: pinned within one statement, free to drift between statements —
#: foldable at bind time (once per statement), never cacheable across
#: statements, never folded during predicate analysis
STABLE_FUNCS = frozenset({
    "now", "current_timestamp", "transaction_timestamp",
    "statement_timestamp", "current_date", "current_time",
    "localtime", "localtimestamp", "age",
    "currval", "lastval",
    "current_setting", "current_user", "session_user", "user",
    "current_schema", "current_schemas", "current_database",
    "current_catalog", "current_role", "inet_client_addr",
    "inet_server_addr", "txid_current", "version",
    "to_regclass", "to_regtype", "to_regproc", "to_regnamespace",
    # subquery expression forms (binder-synthesized BoundFunc names):
    # they embed nested plans over tables the outer plan walk cannot
    # see, so a cached statement must never contain one
    "scalar_subquery", "array_subquery", "in_subquery", "exists",
})


def volatility(name: str) -> str:
    """Volatility class of a function by its bound name. Synthesized
    binder names (cast/not/and/or/like/is_null/op*) are pure and fall
    through to the IMMUTABLE default."""
    n = name.lower()
    if n in VOLATILE_FUNCS:
        return VOLATILE
    if n in STABLE_FUNCS:
        return STABLE
    if n.startswith("sdb_"):
        return VOLATILE
    if n.startswith("pg_"):
        return STABLE
    return IMMUTABLE


def is_immutable(name: str) -> bool:
    return volatility(name) is IMMUTABLE
