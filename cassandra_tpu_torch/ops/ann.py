"""Exact vector search: the score of every row and the top k, kernel K10
(counterpart of the device half of cassandra_tpu/index/manager.py
`VectorIndex.ann`).

`ann_topk(m, q, k, similarity)` returns (scores f32[k], indices
int32[k]) ordered by score, higher first, and the lower index first on
equal scores (the order `lax.top_k` gives). The similarities:

  cosine     (x . q) / max(|x|, 1e-9), q already divided by its norm
             (the caller does that on the host, as the JAX package does)
  dot        x . q
  euclidean  -sum((x - q)^2)

A score of -0.0 counts as +0.0. For CUDA tensors the wrapper launches
csrc/ann.cu or raises; for CPU tensors it runs `ann_topk_plain`, the
same function in plain PyTorch. The scoring is part of the kernel and
goes to no library call. The wrapper picks the kernel's path by k alone:
up to K_FUSED the fused path (one pass over the matrix that scores the
rows and keeps each block's best in shared memory, then one block that
merges the blocks' lists: two launches), above it the select path
(scores and order keys written out, a radix select of the k-th, the
winners ordered by the round sort). Both give the same bits.
"""
from __future__ import annotations

import torch

from ..service.profiling import GLOBAL as _kprof
from . import costs, cuda_lib
from .merge import _check

SIMILARITIES = {"cosine": 0, "dot": 1, "euclidean": 2}
#: the largest k of the fused path (csrc/ann.cu K_FUSED)
K_FUSED = 256


def _sim_code(similarity: str) -> int:
    try:
        return SIMILARITIES[similarity]
    except KeyError:
        raise ValueError(f"unknown similarity {similarity!r}: want one of "
                         f"{sorted(SIMILARITIES)}") from None


def scores_plain(m: torch.Tensor, q: torch.Tensor,
                 similarity: str) -> torch.Tensor:
    """Every row's score (f32[n]) in plain PyTorch: a row-wise sum of
    products, so equal rows give bit-equal scores (a matrix-vector
    product may block rows differently and break exact ties)."""
    _sim_code(similarity)
    if similarity == "euclidean":
        s = -((m - q[None, :]) ** 2).sum(dim=1)
    else:
        s = (m * q[None, :]).sum(dim=1)
        if similarity == "cosine":
            s = s / torch.linalg.vector_norm(m, dim=1).clamp_min(1e-9)
    return torch.where(s == 0, torch.zeros_like(s), s)


def ann_topk_plain(m: torch.Tensor, q: torch.Tensor, k: int,
                   similarity: str = "cosine"):
    """Plain PyTorch K10: scores, then a stable descending sort (equal
    scores keep index order) cut to k."""
    s = scores_plain(m, q, similarity)
    idx = torch.sort(s, descending=True, stable=True).indices[:k]
    return s[idx], idx.to(torch.int32)


def _ann_cuda(m: torch.Tensor, q: torch.Tensor, k: int, similarity: str,
              fused: bool):
    dev = m.device
    if m.dim() != 2:
        raise ValueError("m must be (n, d)")
    n, d = m.shape
    _check(m, "m", torch.float32, (n, d), dev)
    _check(q, "q", torch.float32, (d,), dev)
    lib = cuda_lib.lib()
    if fused and not 1 <= k <= min(n, K_FUSED):
        raise ValueError(f"k={k}: the fused path takes 1..{min(n, K_FUSED)}")
    scratch_bytes, entry, name = (
        (lib.ctpu_ann_fused_scratch_bytes, lib.ctpu_ann_topk,
         "ctpu_ann_topk") if fused else
        (lib.ctpu_ann_select_scratch_bytes, lib.ctpu_ann_topk_select,
         "ctpu_ann_topk_select"))
    with torch.cuda.device(dev):
        out_s = torch.empty(k, dtype=torch.float32, device=dev)
        out_i = torch.empty(k, dtype=torch.int32, device=dev)
        scratch = torch.empty(int(scratch_bytes(n, k)), dtype=torch.uint8,
                              device=dev)
        vec4 = d % 4 == 0 and m.data_ptr() % 16 == 0 \
            and q.data_ptr() % 16 == 0
        rc = entry(m.data_ptr(), n, d, q.data_ptr(), _sim_code(similarity),
                   int(vec4), k, out_s.data_ptr(), out_i.data_ptr(),
                   scratch.data_ptr(), cuda_lib.stream_of(m))
        cuda_lib.check(rc, name)
        cuda_lib.count_launch("index.ann", n)
    return out_s, out_i


def ann_topk_fused_cuda(m: torch.Tensor, q: torch.Tensor, k: int,
                        similarity: str = "cosine"):
    """K10's fused path on CUDA tensors, 1 <= k <= min(n, K_FUSED)."""
    return _ann_cuda(m, q, k, similarity, fused=True)


def ann_topk_select_cuda(m: torch.Tensor, q: torch.Tensor, k: int,
                         similarity: str = "cosine"):
    """K10's select path on CUDA tensors, 1 <= k <= n (the wrapper takes
    it above K_FUSED; the tests and chip_smoke.py hold the two paths to
    the same bits at every k both take)."""
    return _ann_cuda(m, q, k, similarity, fused=False)


def ann_topk(m: torch.Tensor, q: torch.Tensor, k: int,
             similarity: str = "cosine"):
    """K10: (scores f32[k], indices int32[k]) of the k best rows of
    m (f32[n, d]) against q (f32[d]), 1 <= k <= n. CUDA tensors launch
    the kernel (the fused path up to K_FUSED, the select path above);
    CPU tensors run `ann_topk_plain`. Any other k raises on both."""
    if not 1 <= k <= m.shape[0]:
        raise ValueError(f"k={k} outside 1..{m.shape[0]}")
    if cuda_lib.is_cuda(m):
        return _ann_cuda(m, q, k, similarity, fused=k <= K_FUSED)
    return ann_topk_plain(m, q, k, similarity)


ann_topk = _kprof.wrap("index.ann", ann_topk, cost=costs.of("index.ann"))
