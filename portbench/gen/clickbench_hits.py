"""ClickBench's `hits` table from the seed, on the device, a column at a
time and only the columns asked for (`columns`): each column has a
generator of its own, so a mix that reads more columns sees the same
values in the ones it shares.

Distributions follow `configs/clickbench_hits.json` ("draw"). A column
with `distinct` holds exactly that many distinct values (each value once
at a seeded row, the rest drawn); one with `nonzero` exactly that many
non-zero rows. Both counts are the table's at `counts_at_rows` rows, and
a table cut to fewer rows (the tests) holds them in proportion. Strings
come as a sorted dictionary and int32 codes into it, with no Python
object a row.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import draw


def _covering(g, n: int, k: int, cdf: torch.Tensor, where=None):
    """n zipf ranks below k in which every rank appears at least once:
    rank r at a seeded row of its own (among the rows `where` marks, when
    given), the other rows drawn from `cdf`."""
    rank = draw.zipf(g, n, cdf)
    rows = torch.arange(n, device=cdf.device) if where is None \
        else torch.nonzero(where).squeeze(1)
    k = min(k, len(rows))
    pick = rows[torch.randperm(len(rows), generator=g,
                               device=cdf.device)[:k]]
    rank[pick] = torch.arange(k, device=cdf.device)
    return rank


def _sorted_pool(k: int) -> tuple[np.ndarray, np.ndarray]:
    """'' and the k phrases 'phrase <i>', sorted, and each phrase's code
    (its place in the sorted pool; '' is code 0)."""
    text = np.char.add("phrase ", np.arange(k).astype(str))
    order = np.argsort(text, kind="stable")
    code_of = np.empty(k, dtype=np.int32)
    code_of[order] = np.arange(1, k + 1, dtype=np.int32)
    pool = np.empty(k + 1, dtype=object)
    pool[0] = ""
    pool[1:] = text[order].astype(object)
    return pool, code_of


def _count(spec: dict, key: str, scale: float) -> int:
    return max(1, round(int(spec[key]) * scale))


def _phrases(seed: int, spec: dict, n: int, scale: float, device) -> dict:
    """`empty_share` of rows '' and the rest a zipf over `distinct` - 1
    phrases, each phrase on some row; which phrase is how frequent is
    drawn from the seed."""
    k = _count(spec, "distinct", scale) - 1   # '' is one of the values
    g = draw.generator(seed, "SearchPhrase", device)
    empty = torch.rand(n, generator=g, device=device) < spec["empty_share"]
    rank = _covering(g, n, k, draw.zipf_cdf(k, spec["a"], device), ~empty)
    perm = torch.randperm(k, generator=g, device=device)
    pool, code_of = _sorted_pool(k)
    codes = torch.from_numpy(code_of).to(device)[perm[rank]]
    codes = torch.where(empty, torch.zeros_like(codes), codes)
    return {"type": spec["type"], "data": draw.to_numpy(codes, np.int32),
            "dictionary": pool}


def _column(seed: int, name: str, spec: dict, n: int, scale: float,
            device) -> dict:
    kind = spec["draw"]
    if kind == "phrase":
        return _phrases(seed, spec, n, scale, device)
    g = draw.generator(seed, name, device)
    if kind == "zipf":
        v = draw.zipf(g, n, draw.zipf_cdf(int(spec["values"]), spec["a"],
                                          device))
    elif kind == "zipf_hash":
        k = _count(spec, "distinct", scale)
        users = torch.randint(0, 1 << 62, (k,), generator=g, device=device,
                              dtype=torch.int64)
        v = users[_covering(g, n, k, draw.zipf_cdf(k, spec["a"], device))]
    elif kind == "nonzero_rows":
        k = _count(spec, "nonzero", scale)
        pick = torch.randperm(n, generator=g, device=device)[:k]
        v = torch.zeros(n, dtype=torch.int64, device=device)
        v[pick] = torch.randint(int(spec["lo"]), int(spec["hi"]) + 1, (k,),
                                generator=g, device=device)
    elif kind == "uniform":
        v = torch.randint(int(spec["lo"]), int(spec["hi"]) + 1, (n,),
                          generator=g, device=device)
    elif kind == "uniform_seconds":
        v = torch.randint(int(spec["lo"]), int(spec["hi"]) + 1, (n,),
                          generator=g, device=device,
                          dtype=torch.int64) * 1_000_000
    else:
        raise ValueError(f"unknown draw {kind!r} for {name}")
    dtype = {"BIGINT": np.int64, "INTEGER": np.int32, "SMALLINT": np.int16,
             "TIMESTAMP": np.int64}[spec["type"]]
    return {"type": spec["type"], "data": draw.to_numpy(v, dtype),
            "dictionary": None}


def generate(seed: int, cfg: dict, columns, device) -> dict:
    """{"tables": {"hits": {column: {"type", "data", "dictionary"}}}} for
    the columns named in `columns` (all when None)."""
    n = int(cfg["rows"])
    scale = min(1.0, n / int(cfg["counts_at_rows"]))
    names = [c for c in cfg["columns"] if columns is None or c in columns]
    table = {}
    for name in names:
        table[name] = _column(seed, name, cfg["columns"][name], n, scale,
                              device)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return {"tables": {cfg["table"]: table}, "pools": {}}
