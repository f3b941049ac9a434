"""Copied from serenedb_tpu/server/__init__.py."""
from .es_api import EsApi
from .http_server import HttpServer
from .pgwire import PgServer

__all__ = ["EsApi", "HttpServer", "PgServer"]
