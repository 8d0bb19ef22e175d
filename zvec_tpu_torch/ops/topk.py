"""Blockwise scan + top-k in PyTorch.

Port of the XLA program `zvec_tpu/ops/topk.py::blockwise_topk_search`: walk
the codes in blocks, score each (Q, BLOCK) tile, fuse the filter mask as a
large-negative select, and fold the block into a running per-query top-k.
It is the flat scan for small corpora and large k; the fused CUDA kernel
(`ops/flat_scan.py`) takes the rest. Selection keeps `lax.top_k`'s tie
order (lower index first), so both packages return the same ids on ties.
"""

from __future__ import annotations

import torch

from ..typing.enum import MetricType
from .distance import similarity_matrix
from .runtime import NEG_INF, topk_desc

__all__ = ["blockwise_topk_search", "merge_topk", "apply_mask"]


def apply_mask(sim: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Fuse a validity mask into similarity scores. mask: (N,) bool (True=keep)."""
    if mask is None:
        return sim
    return torch.where(mask[None, :], sim, torch.full_like(sim, NEG_INF))


def blockwise_topk_search(
    q: torch.Tensor,
    codes: torch.Tensor,
    metric: MetricType,
    topk: int,
    mask: torch.Tensor | None = None,
    x_sq_norms: torch.Tensor | None = None,
    block_size: int = 65536,
    dequant: tuple | None = None,
    int4_packed: bool = False,
):
    """Exact top-k scan of `codes` for each query.

    Args:
      q: (Q, D) float queries, on the device of `codes`.
      codes: (N, D) codes (or (N, ceil(D/2)) packed int4).
      metric: MetricType (similarity is larger-is-better internally).
      topk: k.
      mask: optional (N,) bool; False rows can never enter the top-k.
      x_sq_norms: optional (N,) precomputed squared norms (L2/COSINE epilogues).
      block_size: rows scored per step.

    Returns:
      (sims, indices): (Q, topk) similarity (desc) and int64 row indices;
      slots with sim <= NEG_INF/2 are invalid and carry index -1.
    """
    n = codes.shape[0]
    nq = q.shape[0]
    q = q.float()
    block_size = min(block_size, n)
    cs = torch.full((nq, topk), NEG_INF, dtype=torch.float32, device=codes.device)
    ci = torch.full((nq, topk), -1, dtype=torch.int64, device=codes.device)
    for start in range(0, n, block_size):
        stop = min(start + block_size, n)
        bnorms = x_sq_norms[start:stop] if x_sq_norms is not None else None
        sim = similarity_matrix(q, codes[start:stop], metric, bnorms, dequant, int4_packed)
        sim = apply_mask(sim, mask[start:stop] if mask is not None else None)
        gidx = torch.arange(start, stop, device=codes.device).expand(nq, -1)
        all_s = torch.cat([cs, sim], dim=1)
        all_i = torch.cat([ci, gidx], dim=1)
        cs, sel = topk_desc(all_s, topk)
        ci = torch.take_along_dim(all_i, sel, dim=1)
    ci = torch.where(cs > NEG_INF / 2, ci, torch.full_like(ci, -1))
    return cs, ci


def merge_topk(sims_list, idx_list, topk: int):
    """Merge per-shard/per-segment top-k results: lists of (Q, k_i) tensors."""
    all_s = torch.cat(sims_list, dim=1).float()
    all_i = torch.cat(idx_list, dim=1).long()
    # invalid slots (idx == -1) must lose every comparison
    all_s = torch.where(all_i < 0, torch.full_like(all_s, NEG_INF), all_s)
    k = min(topk, all_s.shape[1])
    new_s, sel = topk_desc(all_s, k)
    new_i = torch.take_along_dim(all_i, sel, dim=1)
    if k < topk:
        pad = topk - k
        new_s = torch.nn.functional.pad(new_s, (0, pad), value=NEG_INF)
        new_i = torch.nn.functional.pad(new_i, (0, pad), value=-1)
    new_i = torch.where(new_s > NEG_INF / 2, new_i, torch.full_like(new_i, -1))
    return new_s, new_i
