"""Sparse vector ops in PyTorch: padded rows and gather-based dot products.

Port of `zvec_tpu/ops/sparse.py` (reference equivalents: the sparse IP metric,
`inner_product_metric.cc:527-530`; query pruning, `sparse_utility.h:147-160`;
the parallel-array representation, `index.h:47-60`).

Layout: documents pad to a fixed number of non-zeros per row (`doc_idx (N, P)
int32`, `doc_val (N, P) f32`, pad index -1). A batch of queries densifies into
a (Q, V) matrix on the device, and a score is the sum, over a row's P slots, of
the row's value times the query's weight at the row's index: a gather and a
row reduction, no sorted-list intersection.

Against the JAX module:
  * `sparse_ip_topk` holds the densified queries transposed, (V, Q), and scores
    a block of rows with `embedding_bag` (weights = the rows' values): one
    pass that reads a (Q,) line per non-zero and never materialises the
    (Q, B, P) gather of the XLA program. A short last block is scored as it is;
    the corpus is not padded to a block multiple.
  * sums over P run in another order than XLA's, so scores agree to about 1e-6
    relative, not bitwise.
  * `_signature_chunk` adds one column of every row per call, P calls: no two
    updates of a call meet in one slot, so the float sums have a fixed order on
    every device (a single `scatter_add_` of all P columns sums through atomics
    on CUDA, in no fixed order).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .runtime import NEG_INF, topk_desc

__all__ = [
    "pad_sparse_rows",
    "prune_sparse_query",
    "sparse_ip_topk",
    "sparse_ip_rows",
    "sparse_signatures",
]

_HASH_MULT = 2654435761  # Knuth's multiplicative hash, taken mod 2^32


def pad_sparse_rows(
    rows: List[Optional[Dict[int, float]]], max_nnz: int = 256
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad {dim: value} rows to (N, P) index/value arrays, each row sorted by
    dim. Rows over the nnz cap keep their largest-magnitude entries. Returns
    (idx, val, vocab)."""
    n = len(rows)
    nnz = max((len(r) for r in rows if r), default=1)
    p = min(max(nnz, 1), max_nnz)
    idx = np.full((n, p), -1, dtype=np.int32)
    val = np.zeros((n, p), dtype=np.float32)
    vocab = 1
    for i, r in enumerate(rows):
        if not r:
            continue
        if len(r) > p:
            items = sorted(r.items(), key=lambda kv: -abs(kv[1]))[:p]
            items.sort()
        else:
            items = sorted(r.items())  # keys are unique: the order by dim
        m = len(items)
        dims, vals = zip(*items)
        idx[i, :m] = dims
        val[i, :m] = vals
        vocab = max(vocab, dims[-1] + 1)
    return idx, val, vocab


def prune_sparse_query(
    query: Dict[int, float], filtering_budget: float = 0.0
) -> Dict[int, float]:
    """Drop low-magnitude query dims (reference `filter_sparse_query_fp16`):
    keep dims with |v| >= budget * max|v|."""
    if not query or filtering_budget <= 0.0:
        return query
    max_abs = max(abs(v) for v in query.values())
    thresh = filtering_budget * max_abs
    return {k: v for k, v in query.items() if abs(v) >= thresh}


def _densify_queries(q_idx: torch.Tensor, q_val: torch.Tensor, vocab: int) -> torch.Tensor:
    """(Q, Pq) sparse queries -> (Q, V) dense weights.

    A query's dims are unique, so a slot receives at most one non-zero; pads
    (and dims outside the vocabulary) add 0.0 to slot 0 or V-1. Any order of
    the adds gives the same bits, on the CPU and through CUDA's atomics."""
    dense = torch.zeros((q_idx.shape[0], vocab), dtype=torch.float32, device=q_idx.device)
    safe = q_idx.clamp(0, vocab - 1).long()
    vals = torch.where((q_idx >= 0) & (q_idx < vocab), q_val, 0.0)
    return dense.scatter_add_(1, safe, vals)


def _block_sims(q_dense_t: torch.Tensor, bi: torch.Tensor, bv: torch.Tensor) -> torch.Tensor:
    """(V, Q) query weights, a (B, P) block of rows -> (Q, B) dots. Each row is
    one bag: the sum over its slots of value * weights[index]. Pads carry
    value 0, so the line they read (0) adds nothing."""
    vocab = q_dense_t.shape[0]
    vals = torch.where(bi >= 0, bv, 0.0)
    sims = torch.nn.functional.embedding_bag(
        bi.clamp(0, vocab - 1), q_dense_t, per_sample_weights=vals, mode="sum"
    )
    return sims.T


def sparse_ip_topk(
    q_idx: torch.Tensor,  # (Q, Pq) int32, -1 pad
    q_val: torch.Tensor,  # (Q, Pq) f32
    doc_idx: torch.Tensor,  # (N, P) int32, -1 pad
    doc_val: torch.Tensor,  # (N, P) f32
    mask: Optional[torch.Tensor],  # (N,) bool or None
    *,
    topk: int,
    vocab: int,
    block_size: int = 8192,
):
    """Sparse IP top-k: returns (sims (Q, topk) desc, indices int64, -1 pad).

    The running top-k comes first in every merge, so equal scores go to the
    lower row index whatever the block size: the answer does not depend on it."""
    n = doc_idx.shape[0]
    nq = q_idx.shape[0]
    dev = doc_idx.device
    q_dense_t = _densify_queries(q_idx, q_val, vocab).T.contiguous()  # (V, Q)
    cs = torch.full((nq, topk), NEG_INF, dtype=torch.float32, device=dev)
    ci = torch.full((nq, topk), -1, dtype=torch.int64, device=dev)
    for lo in range(0, n, block_size):
        hi = min(lo + block_size, n)
        sims = _block_sims(q_dense_t, doc_idx[lo:hi], doc_val[lo:hi])
        if mask is not None:
            sims = torch.where(mask[lo:hi][None, :], sims, NEG_INF)
        gidx = torch.arange(lo, hi, device=dev).expand(nq, -1)
        cs, sel = topk_desc(torch.cat([cs, sims], dim=1), topk)
        ci = torch.cat([ci, gidx], dim=1).gather(1, sel)
    ci = torch.where(cs > NEG_INF / 2, ci, -1)
    return cs, ci


def _rows_sims(q_dense: torch.Tensor, rows_i: torch.Tensor, rows_v: torch.Tensor) -> torch.Tensor:
    """q_dense (Q, V); per-query gathered rows (Q, M, P) -> (Q, M) dots."""
    nq, m, p = rows_i.shape
    safe = rows_i.clamp(0, q_dense.shape[1] - 1).long()
    w = q_dense.gather(1, safe.reshape(nq, m * p)).reshape(nq, m, p)
    return (w * torch.where(rows_i >= 0, rows_v, 0.0)).sum(-1)


def sparse_ip_rows(
    q_idx: torch.Tensor,
    q_val: torch.Tensor,
    doc_idx: torch.Tensor,  # (Q, M, P) gathered rows per query
    doc_val: torch.Tensor,
    *,
    vocab: int,
) -> torch.Tensor:
    """Per-query gathered sparse rows -> (Q, M) IP (the graph build's exact
    rescoring of proposed candidates)."""
    return _rows_sims(_densify_queries(q_idx, q_val, vocab), doc_idx, doc_val)


def _signature_chunk(doc_idx: torch.Tensor, doc_val: torch.Tensor, *, sig_dims: int) -> torch.Tensor:
    """(B, P) sparse rows -> (B, S) feature-hash signatures: every value is
    added, with a hashed sign, into a hashed slot. The hash kernel (Weinberger
    et al., ICML'09) is an unbiased estimator of the sparse dot:
    sig(a).sig(b) ~= a.b.

    The hash is the uint32 product of the JAX module, here in int64 and masked
    to 32 bits (a dim is below 2^31, so the product stays below 2^63). A pad's
    value is zeroed, so the slot it hashes to gains nothing."""
    h = (doc_idx.clamp_min(0).long() * _HASH_MULT) & 0xFFFFFFFF
    slot = (h >> 7) & (sig_dims - 1)
    sign = torch.where((h & (1 << 6)) != 0, 1.0, -1.0)
    vals = torch.where(doc_idx >= 0, doc_val * sign, 0.0)
    out = torch.zeros((doc_idx.shape[0], sig_dims), dtype=torch.float32, device=doc_idx.device)
    for p in range(doc_idx.shape[1]):
        # one update per row and call: nothing collides, and a slot's sum runs
        # over p ascending, the order of the JAX module's scatter on the CPU
        out.scatter_add_(1, slot[:, p : p + 1], vals[:, p : p + 1])
    return out


def sparse_signatures(
    doc_idx: torch.Tensor, doc_val: torch.Tensor, sig_dims: int = 256, chunk: int = 1 << 17
) -> np.ndarray:
    """Device (N, P) sparse rows -> HOST (N, S) f32 signature matrix, chunked.

    The dense twin of the sparse corpus: k-means bucketing and per-bucket
    candidate scoring run on signatures (`core/hnsw_sparse.py`, the clustered
    build), with exact sparse rescoring after: the scalable replacement for
    the O(N^2) full-corpus kNN."""
    n = doc_idx.shape[0]
    out = np.empty((n, sig_dims), np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out[lo:hi] = _signature_chunk(doc_idx[lo:hi], doc_val[lo:hi], sig_dims=sig_dims).cpu().numpy()
    return out
