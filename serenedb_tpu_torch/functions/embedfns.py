"""Copied from serenedb_tpu/functions/embedfns.py.

ai_embed(): text → embedding vectors via a provider registry.

Reference analog: server/connector/functions/embedding/{embedding,provider,
provider_openai}.cpp — ai_embed(text, model, secret_name) resolving a
provider by model protocol and batch-embedding through it.

Providers here:
- local[:dim] — deterministic signed char-trigram feature hashing,
  L2-normalized (no network; the offline default, and the only provider
  exercised by tests — this image has zero egress).
- openai:<model> / http:<url> — real HTTP providers; constructing the
  request requires a secret created with create_secret(), and the call
  surfaces a clear SqlError when the network is unreachable.

Vectors render as JSON array text — the engine's vector representation
(search/ivf.parse_vector), so ai_embed output feeds vec_* operators and
IVF indexes directly.
"""

from __future__ import annotations

import hashlib
import json
import math

import numpy as np

from .. import errors
from ..columnar import dtypes as dt
from ..sql.expr import make_string_column, propagate_nulls, string_values
from .scalar import FunctionResolution, _REGISTRY, register


def _db():
    from ..engine import CURRENT_CONNECTION
    conn = CURRENT_CONNECTION.get()
    return None if conn is None else conn.db


def _secrets(db) -> dict:
    s = getattr(db, "secrets", None)
    if s is None:
        s = db.secrets = {}
    return s


def local_embed(text: str, dim: int = 64) -> np.ndarray:
    """Signed char-trigram feature hashing, L2-normalized. Deterministic
    across processes (blake2b, not PYTHONHASHSEED-dependent)."""
    v = np.zeros(dim, dtype=np.float64)
    t = f"  {text.lower()} "
    for i in range(len(t) - 2):
        h = hashlib.blake2b(t[i:i + 3].encode(), digest_size=8).digest()
        x = int.from_bytes(h, "big")
        v[x % dim] += 1.0 if (x >> 63) & 1 else -1.0
    n = math.sqrt(float((v * v).sum()))
    return v / n if n > 0 else v


def _parse_model(model: str) -> tuple[str, str]:
    """'local:128' / 'openai:text-embedding-3-small' / 'http:<url>' →
    (provider, param)."""
    s = (model or "local").strip()
    proto, _, rest = s.partition(":")
    proto = proto.lower()
    if proto in ("local", "openai", "http", "https"):
        return proto, rest
    raise errors.SqlError("22023",
                          f"ai_embed: unknown provider {proto!r} "
                          "(expected local / openai / http)")


def _http_embed(provider: str, param: str, texts: list[str],
                secret: str) -> list[list[float]]:
    import urllib.error
    import urllib.request
    if provider == "openai":
        url = "https://api.openai.com/v1/embeddings"
        payload = {"model": param or "text-embedding-3-small",
                   "input": texts}
        headers = {"Authorization": f"Bearer {secret}",
                   "Content-Type": "application/json"}
    else:
        url = (("https:" if provider == "https" else "http:") + param)
        payload = {"input": texts}
        headers = {"Authorization": f"Bearer {secret}",
                   "Content-Type": "application/json"}
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read().decode())
    except (urllib.error.URLError, OSError) as e:
        raise errors.SqlError(
            "58030", f"ai_embed: provider request failed: {e}")
    try:
        if "data" in body:   # OpenAI shape
            return [d["embedding"] for d in body["data"]]
        return body["embeddings"]
    except (KeyError, TypeError):
        raise errors.SqlError("58030",
                              "ai_embed: malformed provider response")


@register("ai_embed")
def _ai_embed(ts):
    if not ts or len(ts) > 3:
        return None

    def _local_dim(param: str) -> int:
        try:
            dim = int(param) if param else 64
        except ValueError:
            raise errors.SqlError(
                "22023", f"ai_embed: invalid local dim {param!r}")
        if not (1 <= dim <= 4096):
            raise errors.SqlError("22023",
                                  "ai_embed: dim must be in [1, 4096]")
        return dim

    def impl(cols, n):
        texts = string_values(cols[0])
        valid = propagate_nulls(cols)
        models = (string_values(cols[1]) if len(cols) > 1
                  else ["local"] * n)
        snames = (string_values(cols[2]) if len(cols) > 2
                  else [None] * n)
        out = [""] * n
        live = [i for i in range(n) if valid is None or valid[i]]
        # group rows by (model, secret): local rows embed inline, each
        # remote group goes out as ONE batched provider request
        groups: dict[tuple, list[int]] = {}
        for i in live:
            groups.setdefault((str(models[i]), snames[i]), []).append(i)
        for (model, sname), idxs in groups.items():
            provider, param = _parse_model(model)
            if provider == "local":
                dim = _local_dim(param)
                for i in idxs:
                    vec = local_embed(str(texts[i]), dim)
                    out[i] = json.dumps([round(float(x), 6) for x in vec])
                continue
            if len(cols) < 3:
                raise errors.SqlError(
                    "22023", "ai_embed: remote providers need a secret "
                             "name: ai_embed(text, model, secret_name)")
            db = _db()
            secret = _secrets(db).get(sname) if db is not None else None
            if secret is None:
                raise errors.SqlError(
                    "22023", f"ai_embed: secret '{sname}' not found — "
                             "create_secret(name, value) first")
            vecs = _http_embed(provider, param,
                               [str(texts[i]) for i in idxs], secret)
            if len(vecs) != len(idxs):
                raise errors.SqlError("58030",
                                      "ai_embed: provider returned "
                                      f"{len(vecs)} vectors for "
                                      f"{len(idxs)} inputs")
            for i, vec in zip(idxs, vecs):
                out[i] = json.dumps(vec)
        return make_string_column(
            np.asarray(out, dtype=object).astype(str), valid)
    return FunctionResolution(dt.VARCHAR, impl)


@register("create_secret")
def _create_secret(ts):
    if len(ts) != 2:
        return None

    def impl(cols, n):
        db = _db()
        if db is None:
            raise errors.SqlError("55000", "no database in scope")
        names = string_values(cols[0])
        values = string_values(cols[1])
        for i in range(n):
            _secrets(db)[str(names[i])] = str(values[i])
        return make_string_column(
            np.asarray(["ok"] * n, dtype=object).astype(str), None)
    return FunctionResolution(dt.VARCHAR, impl)


@register("drop_secret")
def _drop_secret(ts):
    if len(ts) != 1:
        return None

    def impl(cols, n):
        db = _db()
        if db is None:
            raise errors.SqlError("55000", "no database in scope")
        names = string_values(cols[0])
        from ..columnar.column import Column
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            out[i] = _secrets(db).pop(str(names[i]), None) is not None
        return Column(dt.BOOL, out)
    return FunctionResolution(dt.BOOL, impl)
