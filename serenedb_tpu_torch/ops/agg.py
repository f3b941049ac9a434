"""Aggregation entries: exact scalar and grouped reductions on the device,
and the host-side key factorization (port of serenedb_tpu/ops/agg.py).

The device entries keep the reference's names and result shapes. Each
builds a one-column scan program and launches the `agg_scan` kernel
(`ops/agg_kernels.py`, `csrc/agg.cu`) on CUDA tensors — its plain version
on CPU tensors — then reshapes the kernel's outputs to the reference's:

- integer sums accumulate in int64 in the kernel (exact for any input);
  `group_sum_int_limbs` and `masked_sum_int_partials` return the
  reference's limb / half-word partials, each computed as an exact sum of
  the bytes or halves the program extracts;
- float sums add into a per-block f32 partial plane (at large G, the sums
  themselves) that `agg_fold` folds in a fixed order (no float atomics),
  so a result does not depend on thread order;
- min/max reduce order-preserving u32 images of f32 values, with the
  reference's NaN propagation and identities for empty groups.

Inputs are (R, 128) tiles as `columnar.device` uploads them: codes int32,
mask bool, values int32/int8/float32. The host half (factorize_keys,
factorize_codes, combine_sum_int_limbs) is copied from the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import agg_kernels as K

ONEHOT_MAX_GROUPS = 1024      # group_count's bound for the chunk partials
ONEHOT_CHUNK = 2048           # rows per chunk partial (f32-exactness bound)
SCATTER_SUM_MAX_ROWS = 4 << 20  # rows per group_sum_int_limbs call (int32)
SCATTER_CHUNK_TILES = SCATTER_SUM_MAX_ROWS // 128


def _col(vals: torch.Tensor) -> tuple[int, str]:
    """(decode kind, value type) of a raw value tile tensor."""
    if vals.dtype == torch.float32:
        return K.COL_F32, "f"
    if vals.dtype == torch.int8:
        return K.COL_I8, "i"
    if vals.dtype == torch.int32:
        return K.COL_I32, "i"
    raise TypeError(f"values: int32, int8 or float32 tiles, got {vals.dtype}")


def _scan(mask: torch.Tensor, aggs: list, G: int,
          vals: Optional[torch.Tensor] = None,
          codes: Optional[torch.Tensor] = None, tile_start: int = 0,
          tile_end: Optional[int] = None):
    """One agg_scan over `mask` as the row mask: no predicates, the codes
    (or one group), the value column (if any) in slot 0."""
    cols, kinds = [], []
    if vals is not None:
        kinds = [_col(vals)[0]]
        # the value's own validity is folded into `mask` by the caller
        cols = [(vals.contiguous(), torch.ones_like(mask))]
    spec = K.ScanSpec(kinds, [0] * len(kinds), factorized=codes is not None,
                      G=G, aggs=aggs)
    end = mask.shape[0] if tile_end is None else tile_end
    return K.agg_scan(spec, cols, mask.contiguous(),
                      None if codes is None else codes.contiguous(),
                      tile_start, end)


_V = ((K.OP_COL, 0, 0),)     # the value in slot 0


# -- scalar reductions -----------------------------------------------------

def masked_count(mask: torch.Tensor) -> torch.Tensor:
    """int32 count of the masked rows."""
    rowcount, _ = _scan(mask, [], 1)
    return rowcount[0].to(torch.int32)


def masked_sum_float(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """f32 sum of the masked values (integers converted to f32 first)."""
    return group_sum_float(None, mask, vals, 1)[0]


def masked_minmax(vals: torch.Tensor, mask: torch.Tensor,
                  op: str) -> torch.Tensor:
    """min or max of the masked values in their dtype; with no row, the
    identity (dtype max for min, min for max; ±inf for floats)."""
    return group_min_max(None, mask, vals, 1, op)[0]


def masked_sum_int_partials(vals: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Per-tile-row int32 partial sums split into 16-bit halves, (rows, 2)
    [hi, lo]; the host combines them as (Σhi << 16) + Σlo in int64. The
    tile row is the group code."""
    rows = vals.shape[0]
    codes = torch.arange(rows, dtype=torch.int32, device=vals.device)
    codes = codes[:, None].expand(rows, 128).contiguous()
    hi = K.ScanAgg(K.AGG_SUM_I, _V + ((K.OP_SHRA, 0, 16),))
    lo = K.ScanAgg(K.AGG_SUM_I, _V + ((K.OP_ANDI, 0, 0xFFFF),))
    _, outs = _scan(mask, [hi, lo], rows, vals, codes)
    return torch.stack([outs[0][0], outs[1][0]], dim=1).to(torch.int32)


def masked_sum_int(vals: torch.Tensor, mask: torch.Tensor) -> int:
    parts = masked_sum_int_partials(vals, mask).cpu().numpy().astype(np.int64)
    return int((parts[:, 0].sum() << 16) + parts[:, 1].sum())


# -- grouped aggregation ---------------------------------------------------

def group_count_onehot(codes: torch.Tensor, mask: torch.Tensor,
                       num_groups: int) -> torch.Tensor:
    """(C, G) f32 per-group counts of each chunk of ONEHOT_CHUNK rows
    (row-major over the tiles), each exact. One launch over the composite
    codes chunk · G + code; a code outside [0, G) counts nowhere, as the
    reference's one-hot row of it is zero."""
    n = codes.numel()
    c = max(1, -(-n // ONEHOT_CHUNK))
    flat = codes.reshape(-1)
    chunk = torch.arange(n, dtype=torch.int32,
                         device=codes.device) // ONEHOT_CHUNK
    inside = (flat >= 0) & (flat < num_groups)
    comp = torch.where(inside, chunk * num_groups + flat,
                       torch.zeros_like(flat))
    rowcount, _ = _scan((mask.reshape(-1) & inside).view(mask.shape), [],
                        c * num_groups, codes=comp.view(codes.shape))
    return rowcount.view(c, num_groups).to(torch.float32)


def group_count_scatter(codes: torch.Tensor, mask: torch.Tensor,
                        num_groups: int) -> torch.Tensor:
    """(G,) int32 count of the masked rows of each code."""
    rowcount, _ = _scan(mask, [], num_groups, codes=codes)
    return rowcount.to(torch.int32)


def group_sum_float(codes: torch.Tensor, mask: torch.Tensor,
                    vals: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(G,) f32 sums of the masked values of each code."""
    prog = _V if _col(vals)[1] == "f" else _V + ((K.OP_I2F, 0, 0),)
    _, outs = _scan(mask, [K.ScanAgg(K.AGG_SUM_F, prog)], num_groups, vals,
                    codes)
    plane = outs[0][0]
    # a plane of one row (the large-G regime) is already the sums
    return K.agg_fold(plane, num_groups) if plane.numel() > num_groups \
        else plane


def _limb_aggs() -> list:
    """The four byte limbs of each value's two's-complement bits, and
    whether it is negative: sum(v) = Σ_i (limb_i << 8i) − (neg << 32)."""
    aggs = [K.ScanAgg(K.AGG_SUM_I, _V + ((K.OP_SHRL, 0, 8 * i),
                                         (K.OP_ANDI, 0, 0xFF)))
            for i in range(4)]
    aggs.append(K.ScanAgg(K.AGG_SUM_I, _V + ((K.OP_I32, 0, 0),
                                             (K.OP_CMP_I, K.CMP_CODES["<"],
                                              0))))
    return aggs


def group_sum_int_limbs(codes: torch.Tensor, mask: torch.Tensor,
                        vals: torch.Tensor, num_groups: int,
                        tile_start: int = 0,
                        tile_end: Optional[int] = None) -> torch.Tensor:
    """(G, 5) int32: four byte-limb sums and the count of negative values
    per code (exact while a group sees < 2^31/255 rows per call)."""
    _, outs = _scan(mask, _limb_aggs(), num_groups, vals, codes,
                    tile_start, tile_end)
    return torch.stack([o[0] for o in outs], dim=1).to(torch.int32)


def group_sum_int_limbs_chunked(codes: torch.Tensor, mask: torch.Tensor,
                                vals: torch.Tensor,
                                num_groups: int) -> torch.Tensor:
    """group_sum_int_limbs per chunk of SCATTER_CHUNK_TILES tile rows:
    (C, G, 5); combine_sum_int_limbs handles the extra axis."""
    r = codes.shape[0]
    if r == 0:
        return torch.zeros((0, num_groups, 5), dtype=torch.int32,
                           device=codes.device)
    return torch.stack([
        group_sum_int_limbs(codes, mask, vals, num_groups, s,
                            min(s + SCATTER_CHUNK_TILES, r))
        for s in range(0, r, SCATTER_CHUNK_TILES)])


def group_min_max(codes: torch.Tensor, mask: torch.Tensor,
                  vals: torch.Tensor, num_groups: int,
                  op: str) -> torch.Tensor:
    """(G,) min or max of the masked values of each code, in the values'
    dtype; empty groups hold the identity (dtype max for min, min for
    max; ±inf for floats), and a NaN in a group makes its result NaN."""
    is_float = _col(vals)[1] == "f"
    if is_float:
        kind = K.AGG_MIN_F if op == "min" else K.AGG_MAX_F
    else:
        kind = K.AGG_MIN_I if op == "min" else K.AGG_MAX_I
    _, outs = _scan(mask, [K.ScanAgg(kind, _V)], num_groups, vals, codes)
    out = outs[0]
    if not is_float:
        if vals.dtype == torch.int8:
            info = torch.iinfo(torch.int8)
            ident = info.max if op == "min" else info.min
            return torch.where(out[1] > 0, out[0],
                               torch.full_like(out[0], ident)
                               ).to(torch.int8)
        return out[0]
    v = K.image_decode(out[0])
    if op == "min":
        # the kernel's MIN skips NaN rows; a NaN anywhere in the group
        # makes the reference's scatter-min NaN
        v = torch.where(out[1] > out[2], torch.full_like(v, float("nan")),
                        v)
    return v


# -- host-facing grouped API ----------------------------------------------

def group_count(codes: torch.Tensor, mask: torch.Tensor,
                num_groups: int) -> np.ndarray:
    """(G,) int64 per-group counts: the chunk partials summed on the host
    up to ONEHOT_MAX_GROUPS groups, else one scatter count."""
    if num_groups <= ONEHOT_MAX_GROUPS:
        ys = group_count_onehot(codes, mask, num_groups).cpu().numpy()
        return ys.astype(np.int64).sum(axis=0)
    return group_count_scatter(codes, mask, num_groups).cpu().numpy() \
        .astype(np.int64)


def combine_sum_int_limbs(limbs: np.ndarray) -> np.ndarray:
    """(G,5) limb sums (+neg count) → exact int64 group sums. Accepts a
    chunked (C,G,5) array too (summed in int64 first)."""
    if limbs.ndim == 3:
        limbs = limbs.astype(np.int64).sum(axis=0)
    acc = np.zeros(limbs.shape[0], dtype=np.int64)
    for limb in range(4):
        acc += limbs[:, limb].astype(np.int64) << (8 * limb)
    return acc - (limbs[:, 4].astype(np.int64) << 32)



# -- host-side key factorization ------------------------------------------

def factorize_keys(key_arrays: list[np.ndarray],
                   valids: list[Optional[np.ndarray]]) -> tuple[np.ndarray, list[np.ndarray], np.ndarray]:
    """Composite GROUP BY keys → dense codes.

    Returns (codes int32 [n], unique_key_value_columns, unique_valid (k, G)).
    NULL keys group together (PG GROUP BY semantics). Host-side O(n log n).
    """
    n = len(key_arrays[0])
    rows = []
    for arr, valid in zip(key_arrays, valids):
        a = np.asarray(arr)
        if a.dtype == np.bool_:
            a = a.astype(np.int8)
        if valid is not None:
            a = np.where(valid, a, np.zeros((), dtype=a.dtype))
            rows.append((~valid).astype(a.dtype))
        else:
            rows.append(np.zeros(n, dtype=a.dtype))
        rows.append(a)
    composite = np.stack(rows) if rows else np.zeros((0, n))
    first_idx, inverse = _unique_columns(composite)
    codes = inverse.astype(np.int32)
    uniq_cols = [np.asarray(arr)[first_idx] for arr in key_arrays]
    uniq_valid = np.stack(
        [v[first_idx] if v is not None else np.ones(len(first_idx), dtype=bool)
         for v in valids]) if valids else np.ones((0, len(first_idx)), dtype=bool)
    return codes, uniq_cols, uniq_valid


def factorize_codes(key_arrays: list[np.ndarray],
                    valids: list[Optional[np.ndarray]]
                    ) -> tuple[np.ndarray, int]:
    """Composite keys → (dense int64 codes, group count), skipping the
    unique-key-value materialization `factorize_keys` does — the join /
    set-op / DISTINCT ON consumers only need the equality classes.

    Equality semantics match the legacy row-tuple tier exactly: NULL keys
    group together (set ops / DISTINCT ON treat NULL = NULL; the join
    masks NULL-key rows out separately so NULL never matches), and every
    NaN occurrence is its own group (the lexsort `!=` comparison keeps
    NaN ≠ NaN, the same way python tuple equality does). Each key
    factorizes in its OWN dtype and only the resulting int64 code rows
    stack — a composite mixing int64 and float keys must never promote
    the ints to float64, where values beyond 2**53 would collapse.
    """
    code_rows = []
    for arr, valid in zip(key_arrays, valids):
        a = np.asarray(arr)
        if a.dtype == np.bool_:
            a = a.astype(np.int8)
        rows = []
        if valid is not None:
            a = np.where(valid, a, np.zeros((), dtype=a.dtype))
            rows.append((~valid).astype(a.dtype))
        rows.append(a)
        _, codes_k = _unique_columns(np.stack(rows))
        code_rows.append(codes_k)
    if not code_rows:
        return np.zeros(0, dtype=np.int64), 0
    if len(code_rows) == 1:
        inverse = code_rows[0]
        return inverse, int(inverse.max()) + 1 if len(inverse) else 0
    first_idx, inverse = _unique_columns(np.stack(code_rows))
    return inverse, len(first_idx)


def _unique_columns(composite: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unique over columns of a (k, n) matrix → (first-occurrence idx, inverse)."""
    n = composite.shape[1]
    if n == 0:
        return np.array([], dtype=np.int64), np.array([], dtype=np.int64)
    order = np.lexsort(composite[::-1])
    sorted_cols = composite[:, order]
    neq = np.any(sorted_cols[:, 1:] != sorted_cols[:, :-1], axis=0)
    group_of_sorted = np.concatenate([[0], np.cumsum(neq)])
    inverse = np.empty(n, dtype=np.int64)
    inverse[order] = group_of_sorted
    first_idx = np.empty(int(group_of_sorted[-1]) + 1, dtype=np.int64)
    first_idx[group_of_sorted[::-1]] = order[::-1]
    return first_idx, inverse
