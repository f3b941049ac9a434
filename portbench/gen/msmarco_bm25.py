"""MS MARCO-like passages and queries from the seed (`configs/
msmarco_bm25.json`).

A word is a term rank: rank r is drawn by a Zipf law over the
vocabulary, and its spelling is 1-5 lowercase letters, shorter for the
frequent ranks, which spelling within a length drawn from the seed. The
passages are rendered on the device as fixed 6-byte slots (a word and its
spaces), so the text is made in a few large calls; the `simple` analyzer
splits them back into the same ranks.

The query shapes (how many terms, which ranks) come from the fixed
`plan_seed`, so that every run seed does the same work; the run seed
draws the corpus, the spellings and, in the harness, the order in which
the queries are sent.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import draw

SLOT = 6          # bytes a token takes in the text: up to 5 letters, a space
_CLASS = [26 ** k for k in range(1, 6)]      # spellings of 1..5 letters


def spellings(seed: int, vocab: int, device) -> np.ndarray:
    """(vocab, SLOT) uint8: the letters of rank r's word, space-padded."""
    g = draw.generator(seed, "spelling", device)
    out = np.full((vocab, SLOT), ord(" "), dtype=np.uint8)
    start = 0
    for length, size in enumerate(_CLASS, 1):
        take = min(size, vocab - start)
        if take <= 0:
            break
        code = torch.randperm(size, generator=g, device=device)[:take]
        code = code.cpu().numpy().astype(np.int64)
        for pos in range(length - 1, -1, -1):
            out[start:start + take, pos] = ord("a") + code % 26
            code //= 26
        start += take
    if start < vocab:
        raise ValueError(f"a vocabulary of {vocab} needs longer words")
    return out


def words(table: np.ndarray, ranks) -> list[str]:
    return [table[r].tobytes().decode().rstrip() for r in ranks]


def query_plan(cfg: dict) -> list[np.ndarray]:
    """The ranks of each query's terms, from the fixed plan seed."""
    rng = np.random.default_rng(int(cfg["plan_seed"]))
    skip, vocab = int(cfg["query_skip_top"]), int(cfg["vocabulary"])
    p = 1.0 / np.arange(skip + 1, vocab + 1, dtype=np.float64) ** \
        float(cfg["zipf_a"])
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    plan = []
    for _ in range(int(cfg["queries"])):
        k = int(rng.integers(cfg["query_terms_min"],
                             cfg["query_terms_max"] + 1))
        terms: list[int] = []
        while len(terms) < k:
            r = skip + int(np.searchsorted(cdf, rng.random()))
            if r < vocab and r not in terms:
                terms.append(r)
        plan.append(np.asarray(terms, dtype=np.int64))
    return plan


def generate(seed: int, cfg: dict, columns, device) -> dict:
    n, vocab = int(cfg["passages"]), int(cfg["vocabulary"])
    g = draw.generator(seed, "corpus", device)
    sigma = float(cfg["length_sigma"])
    mu = math.log(float(cfg["length_mean"])) - sigma * sigma / 2
    lens = torch.exp(mu + sigma * torch.randn(n, generator=g, device=device,
                                              dtype=torch.float64))
    lens = lens.round().clamp_(cfg["length_min"], cfg["length_max"])
    lens = lens.to(torch.int64)
    total = int(lens.sum())
    ranks = draw.zipf(g, total, draw.zipf_cdf(vocab, cfg["zipf_a"], device))
    table = spellings(seed, vocab, device)
    text = torch.from_numpy(table).to(device)[ranks].cpu().numpy()
    tokens = draw.to_numpy(ranks, np.int32)
    del ranks
    offsets = np.zeros(n + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(lens.cpu().numpy())
    big = text.tobytes().decode("ascii")
    del text
    bounds = (offsets * SLOT).tolist()
    body = np.empty(n, dtype=object)
    body[:] = [big[bounds[i]:bounds[i + 1]] for i in range(n)]
    del big
    dictionary, codes = np.unique(body, return_inverse=True)
    del body
    plan = query_plan(cfg)
    queries = [" | ".join(words(table, q)) for q in plan]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {
        "tables": {cfg["table"]: {
            "id": {"type": "BIGINT", "data": np.arange(n, dtype=np.int64),
                   "dictionary": None},
            "body": {"type": "TEXT", "data": codes.astype(np.int32),
                     "dictionary": dictionary},
        }},
        "pools": {"queries": queries},
        "corpus": {"tokens": tokens, "offsets": offsets, "spelling": table,
                   "query_terms": plan},
    }
