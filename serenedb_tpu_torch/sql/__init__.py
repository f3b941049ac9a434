"""Copied from serenedb_tpu/sql/__init__.py."""

from . import ast, binder, expr, lexer, parser, planner

__all__ = ["ast", "binder", "expr", "lexer", "parser", "planner"]
