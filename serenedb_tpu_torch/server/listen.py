"""Copied from serenedb_tpu/server/listen.py.

Listen-spec parsing: tcp and unix-socket endpoints.

Reference analog: server/network/listen_spec.h:31-60 — the reference
accepts repeated --listen flags with tcp:// and unix:// schemes; the
same spec grammar is accepted here:

    tcp://HOST:PORT      explicit TCP endpoint
    unix:///path.sock    unix domain socket (also unix:/path.sock)
    HOST:PORT            bare TCP
    :PORT / PORT         TCP on all interfaces / default host
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ListenSpec:
    kind: str                   # "tcp" | "unix"
    host: Optional[str] = None  # tcp only
    port: Optional[int] = None  # tcp only
    path: Optional[str] = None  # unix only

    def __str__(self) -> str:
        if self.kind == "unix":
            return f"unix://{self.path}"
        return f"tcp://{self.host}:{self.port}"


def parse_listen_spec(spec: str, default_host: str = "127.0.0.1"
                      ) -> ListenSpec:
    s = spec.strip()
    if s.startswith("unix://"):
        path = s[len("unix://"):]
        if not path:
            raise ValueError(f"empty unix socket path in {spec!r}")
        return ListenSpec("unix", path=path)
    if s.startswith("unix:"):
        path = s[len("unix:"):]
        if not path:
            raise ValueError(f"empty unix socket path in {spec!r}")
        return ListenSpec("unix", path=path)
    if s.startswith("tcp://"):
        s = s[len("tcp://"):]
    if s.isdigit():
        return ListenSpec("tcp", host=default_host, port=int(s))
    try:
        # [v6]:port / host:port / :port
        if s.startswith("["):
            close = s.index("]")
            host = s[1:close]
            rest = s[close + 1:]
            if not rest.startswith(":"):
                raise ValueError
            return ListenSpec("tcp", host=host, port=int(rest[1:]))
        host, sep, port = s.rpartition(":")
        if not sep:
            raise ValueError
        return ListenSpec("tcp", host=host or "0.0.0.0", port=int(port))
    except ValueError:
        raise ValueError(f"cannot parse listen spec {spec!r}")
