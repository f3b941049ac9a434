"""Copied from serenedb_tpu/scram.py.

SCRAM-SHA-256 (RFC 5802/7677) for the PG wire protocol.

Reference analog: the reference's PG auth accepts cleartext and SCRAM
(server/pg/auth*, SURVEY.md §2.2 "PG wire session"); PG itself defaults to
scram-sha-256. Verifiers are stored, never the password: the role meta
holds (salt, iterations, StoredKey, ServerKey) exactly like pg_authid's
rolpassword SCRAM verifier.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import secrets
import unicodedata

ITERATIONS = 4096
MECHANISM = "SCRAM-SHA-256"


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _hmac(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


# RFC 3454 table B.1 (commonly-mapped-to-nothing), as in pg_saslprep
_MAP_TO_NOTHING = {
    0x00AD, 0x034F, 0x1806, 0x180B, 0x180C, 0x180D, 0x200B, 0x200C,
    0x200D, 0x2060, 0xFEFF, *range(0xFE00, 0xFE10),
}


def saslprep(password: str) -> str:
    """RFC 4013 stringprep for SCRAM passwords, matching pg_saslprep:
    non-ASCII spaces -> space, strip mapped-to-nothing chars, NFKC.
    Like PG, falls back to the raw string when the result would be
    prohibited (control chars) or empty."""
    if all(ord(c) < 0x80 for c in password):
        return password
    out = []
    for c in password:
        if ord(c) in _MAP_TO_NOTHING:
            continue
        out.append(" " if unicodedata.category(c) == "Zs" else c)
    normalized = unicodedata.normalize("NFKC", "".join(out))
    if not normalized or any(
            unicodedata.category(c) in ("Cc", "Cf") or
            0xFDD0 <= ord(c) <= 0xFDEF or (ord(c) & 0xFFFE) == 0xFFFE
            for c in normalized):
        return password
    return normalized


def build_verifier(password: str, salt: bytes = None,
                   iterations: int = ITERATIONS) -> dict:
    """PG-style SCRAM verifier parts, base64-encoded for meta storage."""
    salt = salt or secrets.token_bytes(16)
    salted = hashlib.pbkdf2_hmac("sha256", saslprep(password).encode(),
                                 salt, iterations)
    client_key = _hmac(salted, b"Client Key")
    return {
        "salt": base64.b64encode(salt).decode(),
        "iterations": iterations,
        "stored_key": base64.b64encode(_h(client_key)).decode(),
        "server_key": base64.b64encode(
            _hmac(salted, b"Server Key")).decode(),
    }


class ScramServer:
    """One authentication exchange. Usage:
    first() -> server-first-message; final() -> (ok, server-final)."""

    def __init__(self, verifier: dict):
        self.verifier = verifier
        self.client_first_bare = None
        self.server_first = None
        self.nonce = None

    def first(self, client_first: str) -> str:
        # gs2 header: 'n' (no channel binding) or 'y' (client supports none
        # advertised); 'p=' would demand TLS channel binding we don't have
        if client_first[:2] not in ("n,", "y,"):
            raise ValueError("unsupported gs2 channel-binding flag")
        rest = client_first.split(",", 2)[2]
        self.client_first_bare = rest
        attrs = dict(a.split("=", 1) for a in rest.split(",") if "=" in a)
        cnonce = attrs.get("r", "")
        if not cnonce:
            raise ValueError("missing client nonce")
        self.nonce = cnonce + base64.b64encode(
            secrets.token_bytes(18)).decode()
        self.server_first = (
            f"r={self.nonce},s={self.verifier['salt']},"
            f"i={self.verifier['iterations']}")
        return self.server_first

    def final(self, client_final: str) -> tuple[bool, str]:
        attrs = dict(a.split("=", 1) for a in client_final.split(",")
                     if "=" in a)
        if attrs.get("r") != self.nonce:
            return False, ""
        proof_b64 = attrs.get("p", "")
        without_proof = client_final.rsplit(",p=", 1)[0]
        auth_message = (f"{self.client_first_bare},{self.server_first},"
                        f"{without_proof}").encode()
        stored_key = base64.b64decode(self.verifier["stored_key"])
        client_signature = _hmac(stored_key, auth_message)
        try:
            proof = base64.b64decode(proof_b64)
        except Exception:
            return False, ""
        if len(proof) != len(client_signature):
            return False, ""
        client_key = bytes(a ^ b for a, b in zip(proof, client_signature))
        if not hmac.compare_digest(_h(client_key), stored_key):
            return False, ""
        server_key = base64.b64decode(self.verifier["server_key"])
        server_sig = base64.b64encode(
            _hmac(server_key, auth_message)).decode()
        return True, f"v={server_sig}"


def client_exchange(password: str, username: str = ""):
    """Minimal SCRAM client (for tests/tools): returns (client_first,
    continue_fn(server_first) -> client_final, verify_fn(server_final) ->
    bool)."""
    cnonce = base64.b64encode(secrets.token_bytes(18)).decode()
    bare = f"n=,r={cnonce}"
    state = {}

    def cont(server_first: str) -> str:
        attrs = dict(a.split("=", 1) for a in server_first.split(",")
                     if "=" in a)
        salt = base64.b64decode(attrs["s"])
        iters = int(attrs["i"])
        nonce = attrs["r"]
        if not nonce.startswith(cnonce):
            raise ValueError("server nonce does not extend client nonce")
        salted = hashlib.pbkdf2_hmac("sha256",
                                     saslprep(password).encode(), salt,
                                     iters)
        client_key = _hmac(salted, b"Client Key")
        without_proof = f"c=biws,r={nonce}"
        auth_message = f"{bare},{server_first},{without_proof}".encode()
        sig = _hmac(_h(client_key), auth_message)
        proof = bytes(a ^ b for a, b in zip(client_key, sig))
        state["server_sig"] = base64.b64encode(
            _hmac(_hmac(salted, b"Server Key"), auth_message)).decode()
        return f"{without_proof},p={base64.b64encode(proof).decode()}"

    def verify(server_final: str) -> bool:
        return server_final == f"v={state['server_sig']}"

    return f"n,,{bare}", cont, verify


def verify_cleartext(verifier: dict, password: str) -> bool:
    """Check a cleartext password against a stored SCRAM verifier by
    re-deriving the stored key with the verifier's salt/iterations
    (constant-time compare). Powers HBA method=password for roles whose
    password exists only as a SCRAM verifier."""
    import hmac as hmac_mod
    try:
        salt = base64.b64decode(verifier["salt"])
        iterations = int(verifier["iterations"])
        salted = hashlib.pbkdf2_hmac("sha256", saslprep(password).encode(),
                                     salt, iterations)
        stored = base64.b64decode(verifier["stored_key"])
        return hmac_mod.compare_digest(_h(_hmac(salted, b"Client Key")),
                                       stored)
    except (KeyError, ValueError, TypeError):
        return False
