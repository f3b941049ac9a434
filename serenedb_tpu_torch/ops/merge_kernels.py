"""Wrapper of the cross-shard top-k merge kernel (`csrc/merge.cu`) and its
plain PyTorch version.

`merge_topk` ← serenedb_tpu/search/searcher.py `_merge_program`: the
shards' per-query candidates (S, Q, L) — scores f32 and global docs
int32, pads at (-inf, PAD_DOC) — to each query's top kk by (score desc
with -0.0 tied to +0.0, doc asc), each output score with its raw bits.
Docs are unique within a query, so the reference's per-shard top-k, its
all_gather and its final top-k pick what one exact top-k over the union
picks; the kernel makes that one selection for the whole batch.

On a CUDA tensor the wrapper launches the kernel and counts the launch in
`device.LAUNCHES` under `merge_topk`; on a CPU tensor it calls
`merge_topk_plain` (counted as `merge_topk.plain`). There is no other
path: a build or launch failure raises. Up to MERGE_ONE_MAX lanes a query
(S * L) a call is one kernel and one output buffer, with no scratch; past
it the kernel's key array and select.cuh's levels take the scratch.
"""

from __future__ import annotations

import torch

from ..device import LAUNCHES
from . import _build, select
from .agg_kernels import _stream
from .bm25_kernels import _is_cuda

#: doc-id sentinel of pad lanes (the reference's `_PAD_DOC`)
PAD_DOC = (1 << 31) - 1
#: smallest tile of the selection levels (csrc/merge.cu MERGE_SORT_FLOOR)
MERGE_SORT_FLOOR = 32
#: lanes a query (S * L) one block sorts: a call is one kernel up to it
#: (csrc/merge.cu MERGE_ONE_MAX)
MERGE_ONE_MAX = 8192


def merge_scratch(S: int, Q: int, L: int, kk: int) -> tuple[int, int]:
    """Keys of the two selection buffers a call takes: none up to
    MERGE_ONE_MAX lanes a query, else the key array and the levels'
    second buffer (`select.scratch`)."""
    if S * L <= MERGE_ONE_MAX:
        return 0, 0
    return select.scratch(Q, S * L, 1, kk, MERGE_SORT_FLOOR)


def _check(scores: torch.Tensor, docs: torch.Tensor, k: int) -> int:
    if scores.dim() != 3 or docs.shape != scores.shape:
        raise ValueError("merge_topk: scores and docs (S, Q, L)")
    if scores.dtype != torch.float32 or docs.dtype != torch.int32:
        raise TypeError("merge_topk: scores f32, docs int32")
    if k <= 0 or scores.numel() == 0:
        raise ValueError("merge_topk: k > 0 over a non-empty candidate set")
    S, _Q, L = scores.shape
    return min(int(k), S * L)


def merge_topk_plain(scores: torch.Tensor, docs: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `merge_topk`: a stable sort by doc, then a stable
    sort by the canonical score descending, over each query's lanes in
    the kernel's order (shard-major)."""
    LAUNCHES.bump("merge_topk.plain")
    kk = _check(scores, docs, k)
    S, Q, L = scores.shape
    sc = scores.permute(1, 0, 2).reshape(Q, S * L)
    dd = docs.permute(1, 0, 2).reshape(Q, S * L)
    canon = torch.where(sc == 0, torch.zeros_like(sc), sc)   # -0.0 as +0.0
    by_doc = torch.sort(dd, dim=1, stable=True).indices
    order = torch.sort(torch.gather(canon, 1, by_doc), dim=1,
                       descending=True, stable=True).indices
    sel = torch.gather(by_doc, 1, order[:, :kk])
    return (torch.gather(sc, 1, sel).contiguous(),
            torch.gather(dd, 1, sel).contiguous())


def merge_topk(scores: torch.Tensor, docs: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's top min(k, S * L) candidates over the S shards:
    (vals (Q, kk) f32 with the raw score bits, docs (Q, kk) int32), each
    row by (score desc, doc asc); pads come last."""
    if not (scores.is_cuda and docs.is_cuda) and not _is_cuda(scores, docs):
        return merge_topk_plain(scores, docs, k)
    kk = _check(scores, docs, k)
    if not (scores.is_contiguous() and docs.is_contiguous()):
        raise ValueError("merge_topk: scores and docs must be contiguous")
    S, Q, L = scores.shape
    dev = scores.device
    out = torch.empty((2, Q, kk), dtype=torch.int32, device=dev)
    vals, out_docs = out[0].view(torch.float32), out[1]
    cap_a, cap_b = merge_scratch(S, Q, L, kk)
    keys = buf_b = 0
    if cap_a:
        scratch = torch.empty(cap_a + cap_b, dtype=torch.int64, device=dev)
        keys = scratch.data_ptr()
        buf_b = keys + cap_a * 8
    _build.check(_build.load("merge").merge_topk(
        scores.data_ptr(), docs.data_ptr(), S, Q, L, kk, keys, cap_a, buf_b,
        cap_b, vals.data_ptr(), out_docs.data_ptr(), _stream(scores)),
        "merge_topk")
    LAUNCHES.bump("merge_topk")
    return vals, out_docs
