"""Vector index arithmetic: k-means training, IVF cluster probe, MaxSim.

Port of serenedb_tpu/ops/vector.py. The host helpers (`pad_rows`,
`host_dist`, `chunk_maps`, `init_centroids`, the SQ8 quantizer) are
copies; the device programs are the hand kernels of ops/vector_kernels.py
(`ivf_probe`, `maxsim`, `kmeans_assign`, `kmeans_update`, csrc/vector.cu),
which the vector pool (search/vector_store.py) calls directly.

- kmeans: assignment = argmin over ‖x‖² − 2·X·Cᵀ + ‖c‖², the product from
  torch.matmul with TF32 off, row-chunked so the (N, K) temp stays under
  512 MB; the centroid update sums each cluster's rows in a fixed order
  (no one-hot product).
- probe / MaxSim: exact distances by the reference's `dist_tail_expr`
  chain and an exact (distance asc, row asc) selection, so `nprobe=lists`
  is bit-identical to `host_dist` + that selection (the brute oracle).

Bit-parity contract (the reference's): probe, brute oracle and cold
(pool-off) paths score identical gathered rows through the same chain;
`host_dist` mirrors it add for add in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from . import vector_kernels as vk

#: row-id pad sentinel in sort keys: dead lanes carry (+inf, _PAD_ROW)
#: so they sort behind every live row; callers filter non-finite
#: distances (matches the posting-pool _PAD_DOC idiom)
_PAD_ROW = vk.PAD_ROW

#: elements of x·cᵀ one k-means GEMM produces (a 512 MB f32 temp)
_GEMM_ELEMS = 1 << 27


def pad_rows(a: np.ndarray, multiple: int = 8) -> np.ndarray:
    pad = (-a.shape[0]) % multiple
    if pad:
        a = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
    return a


def _pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def host_dist(x: np.ndarray, q: np.ndarray, metric: str) -> np.ndarray:
    """Numpy mirror of `dist_tail_expr`: identical elementwise ops in
    the identical left-to-right order over the last axis, all f32.
    Subtract/multiply/add/sqrt/divide are correctly rounded in both
    numpy and the kernels, which never contract a product into an fma, so
    the mirror is BIT-exact against the port's kernels on any data (the
    reference's XLA:CPU may contract, so against the reference it is
    exact on grid-quantized vectors and within 1 ulp elsewhere). The
    `+ 0.0` canonicalizes -0.0 like the device programs."""
    x = np.asarray(x, np.float32)
    q = np.asarray(q, np.float32)
    d = x.shape[-1]

    def chain(terms):
        acc = None
        for t in terms:
            acc = t if acc is None else acc + t
        return acc

    if metric == "l2":
        dv = x - q
        return chain(dv[..., j] * dv[..., j] for j in range(d)) + \
            np.float32(0.0)
    if metric == "ip":
        return -chain(x[..., j] * q[..., j] for j in range(d)) + \
            np.float32(0.0)
    nx = np.sqrt(chain(x[..., j] * x[..., j] for j in range(d)))
    nq = np.sqrt(chain(q[..., j] * q[..., j] for j in range(d)))
    dot = chain(x[..., j] * q[..., j] for j in range(d))
    return (np.float32(1.0) -
            dot / np.maximum(nx * nq, np.float32(1e-9))) + np.float32(0.0)


# -- k-means ------------------------------------------------------------------

def _gemm(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x·cᵀ in full f32 (TF32 saved, cleared and restored)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(x, c.t()).contiguous()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row of x (N, D) f32: (N,) i32."""
    x = x.contiguous()
    c = centroids.contiguous()
    step = max(1, _GEMM_ELEMS // max(c.shape[0], 1))
    parts = [vk.kmeans_assign(x[a:a + step], c, _gemm(x[a:a + step], c))
             for a in range(0, x.shape[0], step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def kmeans_fit(x: torch.Tensor, init: torch.Tensor, k: int,
               iters: int) -> torch.Tensor:
    """Lloyd's k-means on x's device. x: (N, D) f32 (the caller passes
    `pad_rows` of the valid rows, as the reference does). Returns (k, D)
    centroids; an empty cluster keeps its centroid."""
    x = x.contiguous()
    c = init.contiguous()
    if c.shape[0] != k:
        raise ValueError(f"kmeans_fit: {c.shape[0]} initial centroids, k={k}")
    for _ in range(iters):
        c = vk.kmeans_update(x, assign_clusters(x, c), c)
    return c


# -- probe-grid chunk maps ----------------------------------------------------

def chunk_maps(nprobe: int, m: int, mc: int) -> tuple[np.ndarray,
                                                      np.ndarray]:
    """Host-built flattening of the (nprobe, M) probe grid into mc-lane
    scan chunks: tmap = probe-slot index, jmap = within-cluster logical
    position (pad lanes get jmap = m, dead against every count)."""
    total = nprobe * m
    nchunks = max(1, -(-total // mc))
    tm = np.full(nchunks * mc, 0, np.int32)
    jm = np.full(nchunks * mc, m, np.int32)
    flat = np.arange(total, dtype=np.int64)
    tm[:total] = (flat // m).astype(np.int32)
    jm[:total] = (flat % m).astype(np.int32)
    return tm.reshape(nchunks, mc), jm.reshape(nchunks, mc)


# -- host helpers -------------------------------------------------------------


def init_centroids(x: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """k-means++-lite init on host: random distinct samples."""
    rng = np.random.default_rng(seed)
    n = len(x)
    if n >= k:
        idx = rng.choice(n, k, replace=False)
    else:
        idx = rng.choice(max(n, 1), k, replace=True)
    return np.ascontiguousarray(x[idx], dtype=np.float32)


def sq8_quantize(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-dimension affine SQ8: x ≈ lo + (q/255)·(hi−lo), q ∈ uint8
    (reference: the IVF scalar quantizer, ivf_writer.hpp)."""
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    scale = np.where(hi > lo, hi - lo, 1.0)
    q = np.clip(np.round((x - lo) / scale * 255.0), 0, 255).astype(np.uint8)
    return q, lo.astype(np.float32), scale.astype(np.float32)


def sq8_dequantize(q: np.ndarray, lo: np.ndarray,
                   scale: np.ndarray) -> np.ndarray:
    return (lo + q.astype(np.float32) / 255.0 * scale).astype(np.float32)


def sq8_roundtrip(x: np.ndarray) -> np.ndarray:
    """Quantize+dequantize: the f32 values the device will score with."""
    q, lo, scale = sq8_quantize(x)
    return sq8_dequantize(q, lo, scale)
