"""Dense + sparse scoring of one multi-vector query batch.

Port of `zvec_tpu/ops/fused.py`. The JAX module compiles both fields' searches
into one XLA program and packs the four result arrays into one int32 transfer
array, because each dispatch and each fetch through its device tunnel costs a
round trip. On CUDA there is no such trip to save: here the two searches are
launched back to back on one stream and the four result tensors are returned as
they are (`_pack` / `unpack_fused` have no counterpart).

Semantics are those of `blockwise_topk_search` (or the HNSW beam) on the dense
field and `sparse_ip_topk` on the sparse field, run separately. The dense scan
is the blockwise torch scan whatever the corpus size, as in the JAX module:
this path does not launch the fused flat-scan kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..typing.enum import MetricType
from .hnsw import hnsw_search
from .sparse import sparse_ip_topk
from .topk import blockwise_topk_search

__all__ = ["fused_dense_sparse_topk", "fused_hnsw_sparse_topk"]


def fused_hnsw_sparse_topk(
    dq,  # (Q, D) f32 dense queries
    codes, norms, l0_nbrs, upper_ids, upper_nbrs, upper_down, entry_rows,
    dmask,  # (N_pad,) bool or None: dense result filter
    scan_budget,
    q_idx, q_val, doc_idx, doc_val, smask,
    dequant=None,
    *,
    topk: int,
    vocab: int,
    **beam_kw,  # metric, ef, max_steps, num_levels and the beam's knobs
):
    """HNSW beam (dense field) + padded-row sparse top-k: the common
    production multi-vector shape (dense ANN index + sparse lexical field).
    Returns (d_sims, d_ids, s_sims, s_ids), each (Q, topk)."""
    d_s, d_i = hnsw_search(
        dq, codes, norms, l0_nbrs, upper_ids, upper_nbrs, upper_down, entry_rows,
        dmask, scan_budget, dequant, topk=topk, **beam_kw,
    )
    s_s, s_i = sparse_ip_topk(q_idx, q_val, doc_idx, doc_val, smask, topk=topk, vocab=vocab)
    return d_s, d_i, s_s, s_i


def fused_dense_sparse_topk(
    dq: torch.Tensor,  # (Q, D) f32 dense queries
    codes: torch.Tensor,  # (N_pad, D) dense codes (storage dtype)
    norms: Optional[torch.Tensor],  # (N_pad,) squared norms or None
    dmask: torch.Tensor,  # (N_pad,) bool valid-row mask (dense)
    q_idx: torch.Tensor,  # (Q, Pq) int32 sparse query indices, -1 pad
    q_val: torch.Tensor,  # (Q, Pq) f32 sparse query values
    doc_idx: torch.Tensor,  # (Ns_pad, P) int32 padded doc indices
    doc_val: torch.Tensor,  # (Ns_pad, P) f32
    smask: torch.Tensor,  # (Ns_pad,) bool valid-row mask (sparse)
    dequant: Optional[Tuple[float, float]] = None,
    *,
    metric: MetricType,
    topk: int,
    vocab: int,
    int4_packed: bool = False,
):
    """Exact dense scan + exact sparse scan.
    Returns (d_sims, d_ids, s_sims, s_ids), each (Q, topk)."""
    d_s, d_i = blockwise_topk_search(
        dq, codes, metric, topk, mask=dmask, x_sq_norms=norms,
        dequant=dequant, int4_packed=int4_packed,
    )
    s_s, s_i = sparse_ip_topk(q_idx, q_val, doc_idx, doc_val, smask, topk=topk, vocab=vocab)
    return d_s, d_i, s_s, s_i
