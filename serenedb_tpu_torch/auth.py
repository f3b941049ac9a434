"""Copied from serenedb_tpu/auth.py.

Roles and ACLs.

Reference analog: server/auth/{acl,role_closure}.cpp + the RBAC statements
in server/pg/commands/rbac.cpp and AclMode bitmask checks at catalog
snapshot reads (SURVEY.md §2.4). Model: flat roles with per-table privilege
sets; the built-in superuser role `serene` (and any SUPERUSER role)
bypasses checks; `public` grants apply to every role.
"""

from __future__ import annotations

import threading
from typing import Optional

from . import errors, scram

PRIVILEGES = {"select", "insert", "update", "delete"}
SUPERUSER = "serene"


class Roles:
    def __init__(self):
        self._lock = threading.Lock()
        self.roles: dict[str, dict] = {
            SUPERUSER: {"password": None, "login": True, "superuser": True}}
        # acls[table_key][role] = set of privileges
        self.acls: dict[str, dict[str, set]] = {}
        # memberships[member] = roles granted to it (GRANT role TO member)
        self.memberships: dict[str, set] = {}

    # -- role management ---------------------------------------------------

    def create(self, name: str, password: Optional[str], login: bool,
               superuser: bool, if_not_exists: bool):
        key = name.lower()
        with self._lock:
            if key in self.roles:
                if if_not_exists:
                    return
                raise errors.SqlError(errors.DUPLICATE_OBJECT,
                                      f'role "{name}" already exists')
            entry = {"password": None, "login": login,
                     "superuser": superuser}
            if password is not None:
                # only the SCRAM verifier is stored, never the plaintext
                # (reference: PG stores scram-sha-256 verifiers in
                # pg_authid.rolpassword)
                entry["scram"] = scram.build_verifier(password)
            self.roles[key] = entry

    def alter(self, name: str, set_password: bool = False,
              password: Optional[str] = None, login=None, superuser=None):
        """ALTER ROLE: rotate/clear credentials, flip LOGIN/SUPERUSER.
        Passwords become SCRAM verifiers; the bootstrap superuser can
        change its password but never lose LOGIN/SUPERUSER."""
        key = name.lower()
        with self._lock:
            r = self.roles.get(key)
            if r is None:
                raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                      f'role "{name}" does not exist')
            if key == SUPERUSER and (login is False or superuser is False):
                raise errors.SqlError(
                    errors.FEATURE_NOT_SUPPORTED,
                    "cannot demote the bootstrap superuser")
            if set_password:
                r["password"] = None
                if password is None:
                    r.pop("scram", None)
                else:
                    r["scram"] = scram.build_verifier(password)
            if login is not None:
                r["login"] = login
            if superuser is not None:
                r["superuser"] = superuser

    def drop(self, name: str, if_exists: bool):
        key = name.lower()
        with self._lock:
            if key not in self.roles:
                if if_exists:
                    return
                raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                      f'role "{name}" does not exist')
            if key == SUPERUSER:
                raise errors.SqlError(errors.FEATURE_NOT_SUPPORTED,
                                      "cannot drop the bootstrap superuser")
            del self.roles[key]
            for acl in self.acls.values():
                acl.pop(key, None)
            self.memberships.pop(key, None)
            for g in self.memberships.values():
                g.discard(key)

    def exists(self, name: str) -> bool:
        with self._lock:
            return name.lower() in self.roles

    def scram_verifier(self, name: str) -> Optional[dict]:
        with self._lock:
            r = self.roles.get(name.lower())
            return dict(r["scram"]) if r and r.get("scram") else None

    def is_superuser(self, name: str) -> bool:
        with self._lock:
            r = self.roles.get(name.lower())
            return bool(r and r.get("superuser"))

    def can_login(self, name: str) -> bool:
        with self._lock:
            r = self.roles.get(name.lower())
            return bool(r and r.get("login", True))

    def has_password(self, name: str) -> bool:
        with self._lock:
            r = self.roles.get(name.lower())
            return bool(r and (r.get("scram") or
                               r.get("password") is not None))

    def check_password(self, name: str, password: str) -> bool:
        """Cleartext check; SCRAM-only roles verify by re-deriving the
        stored key. Fails CLOSED when no credential is on record — a
        cleartext exchange against a passwordless role must not succeed
        (the HBA 'password' method made this path reachable)."""
        with self._lock:
            r = self.roles.get(name.lower())
            if r is None or not r.get("login", True):
                return False
            stored = r.get("password")
            verifier = r.get("scram")
        if stored is not None:
            return stored == password
        if verifier:
            from . import scram
            return scram.verify_cleartext(verifier, password)
        return False

    # -- grants ------------------------------------------------------------

    def grant(self, table_key: str, role: str, privileges: list[str],
              revoke: bool = False):
        role = role.lower()
        privs = set()
        for p in privileges:
            if p == "all":
                privs |= PRIVILEGES
            elif p in PRIVILEGES:
                privs.add(p)
            else:
                raise errors.SqlError("0LP01",
                                      f"unknown privilege {p!r}")
        with self._lock:
            if role != "public" and role not in self.roles:
                raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                      f'role "{role}" does not exist')
            acl = self.acls.setdefault(table_key, {})
            cur = acl.setdefault(role, set())
            if revoke:
                cur -= privs
            else:
                cur |= privs

    def grant_role(self, granted: str, member: str,
                   revoke: bool = False):
        """Role membership: `GRANT granted TO member` — member inherits
        granted's privileges transitively (reference: auth::RoleClosure,
        server/auth/role_closure.cpp)."""
        granted, member = granted.lower(), member.lower()
        with self._lock:
            for r in (granted, member):
                if r not in self.roles:
                    raise errors.SqlError(
                        errors.UNDEFINED_OBJECT,
                        f'role "{r}" does not exist')
            ms = self.memberships.setdefault(member, set())
            if revoke:
                ms.discard(granted)
            else:
                if member in self._closure(granted):
                    raise errors.SqlError(
                        "0LP01", f'role "{member}" is a member of role '
                                 f'"{granted}"')  # cycle
                ms.add(granted)

    def _closure(self, role: str) -> set:
        """role + every role reachable through memberships (under lock
        or on a consistent snapshot)."""
        out, stack = set(), [role]
        while stack:
            r = stack.pop()
            if r in out:
                continue
            out.add(r)
            stack.extend(self.memberships.get(r, ()))
        return out

    def allowed(self, role: str, table_key: str, privilege: str) -> bool:
        role = role.lower()
        with self._lock:
            r = self.roles.get(role)
            if r and r.get("superuser"):
                return True
            acl = self.acls.get(table_key, {})
            for g in self._closure(role):
                if privilege in acl.get(g, ()):
                    return True
            return privilege in acl.get("public", ())

    def require(self, role: str, table_key: str, privilege: str):
        if not self.allowed(role, table_key, privilege):
            raise errors.SqlError(
                errors.INSUFFICIENT_PRIVILEGE,
                f"permission denied for table {table_key.split('.')[-1]}")

    # -- persistence -------------------------------------------------------

    def to_meta(self) -> dict:
        with self._lock:
            return {
                "roles": {k: dict(v) for k, v in self.roles.items()},
                "acls": {t: {r: sorted(p) for r, p in acl.items()}
                         for t, acl in self.acls.items()},
                "memberships": {m: sorted(g)
                                for m, g in self.memberships.items() if g},
            }

    def load_meta(self, meta: dict):
        with self._lock:
            if meta.get("roles"):
                self.roles = {k: dict(v) for k, v in meta["roles"].items()}
                self.roles.setdefault(
                    SUPERUSER,
                    {"password": None, "login": True, "superuser": True})
            self.acls = {t: {r: set(p) for r, p in acl.items()}
                         for t, acl in meta.get("acls", {}).items()}
            self.memberships = {m: set(g) for m, g in
                                meta.get("memberships", {}).items()}
