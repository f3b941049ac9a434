"""Seeded draws shared by the generators: one `torch.Generator` per
(seed, name), so adding a column or a table never changes another's
values, and draws made on the card in a few large calls.

The same seed on the same kind of device and the same PyTorch gives the
same values; the CPU and the card give different streams.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def generator(seed: int, name: str, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, name)."""
    h = hashlib.blake2b(f"{int(seed)}:{name}".encode(), digest_size=8)
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h.digest(), "little") >> 1)
    return g


def zipf_cdf(k: int, a: float, device) -> torch.Tensor:
    """The CDF of ranks 0..k-1 with P(r) proportional to (r + 1) ** -a."""
    r = torch.arange(1, k + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(r.pow(-a), 0)
    return cdf / cdf[-1]


def zipf(g: torch.Generator, n: int, cdf: torch.Tensor) -> torch.Tensor:
    """n ranks (int64, 0-based) drawn by inverse CDF."""
    u = torch.rand(n, generator=g, device=cdf.device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=len(cdf) - 1)


def to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    return t.to(getattr(torch, np.dtype(dtype).name)).cpu().numpy()

