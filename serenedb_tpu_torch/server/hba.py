"""Copied from serenedb_tpu/server/hba.py (the upstream source file this
docstring names is given by its path in the SereneDB tree).

Host-based authentication: pg_hba.conf-style rules.

Reference analog: server/network/pg/hba.cpp in SereneDB — SereneDB
parses a pg_hba.conf-compatible rule list (configurable at boot and at
runtime via SET hba) and resolves the auth method for each incoming
connection by first match. This module re-implements that contract:

    # type  database  user  address       method
    host    all       all   127.0.0.1/32  trust
    hostssl all       app   0.0.0.0/0     scram-sha-256
    host    all       all   all           reject

- type: local (unix-socket peers only — PG semantics), host (TCP),
  hostssl (TLS only), hostnossl (non-TLS only); host-family rules never
  match unix peers and local rules never match TCP peers
- database/user: 'all', a name, or a comma-separated list
- address: CIDR ('10.0.0.0/8'), bare IP (host mask), 'all', or
  'samehost' (any of this machine's addresses); 'samenet' is rejected
  loudly (interface enumeration is out of scope)
- method: trust, reject, scram-sha-256, password (cleartext), md5
  (treated as password-equivalent: we never store md5 hashes)

First matching rule decides; NO match rejects the connection (PG
semantics: "no pg_hba.conf entry for host ...").
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass
from typing import Optional

METHODS = {"trust", "reject", "scram-sha-256", "password", "md5"}


class HbaError(ValueError):
    pass


@dataclass
class HbaRule:
    conn_type: str                 # local | host | hostssl | hostnossl
    databases: list[str]           # ['all'] or names
    users: list[str]
    network: Optional[ipaddress._BaseNetwork]  # None = all/local
    method: str
    line_no: int = 0
    samehost: bool = False         # match any of this machine's addresses

    def matches(self, database: str, user: str, addr: Optional[str],
                tls: bool) -> bool:
        is_unix = addr is not None and not _is_ip(addr)
        if self.conn_type == "hostssl" and not tls:
            return False
        if self.conn_type == "hostnossl" and tls:
            return False
        if self.conn_type == "local":
            # PG: local rules match unix-socket peers ONLY
            if addr is not None and not is_unix:
                return False
        elif is_unix:
            # PG: host/hostssl/hostnossl never match unix peers — a
            # 'host all all all trust' line must not fail open for them
            return False
        if "all" not in self.databases and database not in self.databases:
            return False
        if "all" not in self.users and user not in self.users:
            return False
        if self.samehost:
            return addr is not None and _is_local_address(addr)
        if self.network is not None and self.conn_type != "local":
            if addr is None:
                return False
            try:
                ip = ipaddress.ip_address(addr)
            except ValueError:
                return False
            if ip.version != self.network.version:
                # PG matches IPv4-mapped IPv6 against v4 rules
                if ip.version == 6 and getattr(ip, "ipv4_mapped", None):
                    ip = ip.ipv4_mapped
                    if ip.version != self.network.version:
                        return False
                else:
                    return False
            if ip not in self.network:
                return False
        return True


def _is_ip(addr: str) -> bool:
    try:
        ipaddress.ip_address(addr)
        return True
    except ValueError:
        return False


def _is_loopback(addr: str) -> bool:
    try:
        return ipaddress.ip_address(addr).is_loopback
    except ValueError:
        return True   # unix-socket style path → local


def parse_hba(text: str) -> list[HbaRule]:
    """Parse pg_hba.conf content. Raises HbaError on malformed lines —
    a broken auth config must fail loudly, not fall open."""
    rules: list[HbaRule] = []
    for ln_no, line in enumerate(text.splitlines(), 1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        fields = line.split()
        conn_type = fields[0]
        if conn_type == "local":
            if len(fields) != 4:
                raise HbaError(f"line {ln_no}: local rules take "
                               "4 fields (type db user method)")
            db_f, user_f, method = fields[1], fields[2], fields[3]
            network = None
        elif conn_type in ("host", "hostssl", "hostnossl"):
            if len(fields) == 5:
                db_f, user_f, addr_f, method = fields[1:5]
            elif len(fields) == 6:   # address + separate netmask
                db_f, user_f, addr_f, mask_f, method = fields[1:6]
                addr_f = f"{addr_f}/{_mask_bits(mask_f, ln_no)}"
            else:
                raise HbaError(f"line {ln_no}: host rules take 5 fields")
            if addr_f == "samenet":
                # PG matches any directly-connected subnet; interface
                # enumeration is out of scope — fail loudly rather than
                # silently narrowing the rule's meaning
                raise HbaError(f"line {ln_no}: samenet is not supported")
            if addr_f in ("all", "samehost"):
                network = None
                if addr_f == "samehost":
                    rules.append(HbaRule(conn_type, db_f.split(","),
                                         user_f.split(","), None,
                                         _check_method(fields[-1], ln_no),
                                         ln_no, samehost=True))
                    continue
            else:
                try:
                    if "/" in addr_f:
                        network = ipaddress.ip_network(addr_f, strict=False)
                    else:
                        network = ipaddress.ip_network(addr_f)
                except ValueError as e:
                    raise HbaError(f"line {ln_no}: bad address: {e}")
        else:
            raise HbaError(f"line {ln_no}: unknown connection type "
                           f"{conn_type!r}")
        rules.append(HbaRule(conn_type, db_f.split(","), user_f.split(","),
                             network, _check_method(method, ln_no), ln_no))
    return rules


def _check_method(method: str, ln_no: int) -> str:
    if method not in METHODS:
        raise HbaError(f"line {ln_no}: unknown auth method {method!r}")
    return method


def _is_local_address(addr: str) -> bool:
    """True if addr is one of this machine's addresses (PG samehost)."""
    try:
        ip = ipaddress.ip_address(addr)
    except ValueError:
        return True   # unix-socket path → local
    if ip.is_loopback:
        return True
    if getattr(ip, "ipv4_mapped", None) and ip.ipv4_mapped.is_loopback:
        return True
    return str(ip) in _machine_addresses()


_MACHINE_ADDRS: Optional[set] = None


def _machine_addresses() -> set:
    global _MACHINE_ADDRS
    if _MACHINE_ADDRS is None:
        import socket
        addrs = set()
        try:
            for info in socket.getaddrinfo(socket.gethostname(), None):
                addrs.add(str(ipaddress.ip_address(info[4][0])))
        except (socket.gaierror, ValueError, OSError):
            pass
        _MACHINE_ADDRS = addrs
    return _MACHINE_ADDRS


def _mask_bits(mask: str, ln_no: int) -> int:
    try:
        return ipaddress.ip_network(f"0.0.0.0/{mask}").prefixlen
    except ValueError:
        raise HbaError(f"line {ln_no}: bad netmask {mask!r}")


def match_rule(rules: list[HbaRule], database: str, user: str,
               addr: Optional[str], tls: bool) -> Optional[HbaRule]:
    """First matching rule, or None (→ reject per PG semantics)."""
    for r in rules:
        if r.matches(database, user, addr, tls):
            return r
    return None
