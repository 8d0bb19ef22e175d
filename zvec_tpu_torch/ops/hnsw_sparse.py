"""Sparse-vector graph beam search in PyTorch.

Port of `zvec_tpu/ops/hnsw_sparse.py` (reference equivalent:
`src/core/algorithm/hnsw_sparse/`, HNSW traversal with a sparse dot-product
distance calculator, `hnsw_sparse_dist_calculator.h:22`).

The same batched lockstep beam as the dense one (`ops/hnsw.py`), but scoring
gathers padded sparse rows and dots them against the densified query
(`ops/sparse.py`). The graph is single-level (NSW-style) with a small probed
entry set in place of the upper-level descent: with sparse lexical data the
hierarchy's long-range hops are covered by scoring a fixed sample of entry
candidates.

The JAX `lax.while_loop` becomes a Python loop whose condition costs one host
sync per step. Every selection is `topk_desc` (ties to the lower index, the
order `lax.top_k` gives) and every sort is stable, so both packages traverse
alike. The visited set is one bit per row in int32 words (bit 31 is the sign
bit); fresh bits of one step are disjoint after the in-step dedup, so the
scatter-add acts as a scatter-or, and integer adds give the same word in any
order.
"""

from __future__ import annotations

from typing import Optional

import torch

from .hnsw import _BITS, _SORT_SENTINEL, _shift_dup
from .runtime import NEG_INF, topk_desc
from .sparse import _densify_queries, _rows_sims

__all__ = ["hnsw_sparse_search"]


def hnsw_sparse_search(
    q_idx: torch.Tensor,  # (Q, Pq) int32, -1 pad
    q_val: torch.Tensor,  # (Q, Pq) f32
    doc_idx: torch.Tensor,  # (N_pad, P) int32
    doc_val: torch.Tensor,  # (N_pad, P) f32
    l0_nbrs: torch.Tensor,  # (N_pad, M0) int32, -1 pad
    entry_ids: torch.Tensor,  # (E,) distinct probe entry candidates
    mask: Optional[torch.Tensor],  # (N_pad,) bool result filter or None
    scan_budget: int,
    *,
    ef: int,
    topk: int,
    max_steps: int,
    vocab: int,
    frontier: int = 1,
):
    """Batched beam over the single-level sparse graph (`sparse_beam_core` of
    the JAX module). Returns (sims (Q, topk) desc, ids (Q, topk) int64, -1 pad).
    Filtered rows are traversed but never enter the result set."""
    nq = q_idx.shape[0]
    n_pad = doc_idx.shape[0]
    dev = doc_idx.device
    words = (n_pad + 31) // 32
    q_dense = _densify_queries(q_idx, q_val, vocab)
    entry_ids = entry_ids.long()

    # score the probe entry set; its best rows are the first candidates
    e = entry_ids.shape[0]
    ent_i, ent_v = doc_idx[entry_ids], doc_val[entry_ids]  # (E, P), shared by every query
    w = q_dense.index_select(1, ent_i.clamp(0, vocab - 1).long().reshape(-1)).reshape(nq, e, -1)
    ent_sims = (w * torch.where(ent_i >= 0, ent_v, 0.0)[None]).sum(-1)  # (Q, E)

    kw = max(ef, topk)
    k0 = min(ef, e)
    top_es, top_epos = topk_desc(ent_sims, k0)
    top_ei = entry_ids[top_epos]

    cand_s = torch.full((nq, ef), NEG_INF, dtype=torch.float32, device=dev)
    cand_i = torch.full((nq, ef), -1, dtype=torch.long, device=dev)
    cand_s[:, :k0] = top_es
    cand_i[:, :k0] = top_ei
    cand_x = torch.zeros((nq, ef), dtype=torch.bool, device=dev)  # expanded flags

    ent_ok = mask[top_ei] if mask is not None else torch.ones_like(top_ei, dtype=torch.bool)
    res_s = torch.full((nq, kw), NEG_INF, dtype=torch.float32, device=dev)
    res_i = torch.full((nq, kw), -1, dtype=torch.long, device=dev)
    res_s[:, :k0] = torch.where(ent_ok, top_es, NEG_INF)
    res_i[:, :k0] = torch.where(ent_ok, top_ei, -1)

    bits = torch.tensor(_BITS, dtype=torch.int32, device=dev)
    visited = torch.zeros((nq, words), dtype=torch.int32, device=dev)
    # the entries are distinct rows: their bits are disjoint, add == or
    visited.scatter_add_(1, top_ei >> 5, bits[top_ei & 31])

    scanned = torch.full((nq,), e, dtype=torch.int32, device=dev)
    done = torch.zeros(nq, dtype=torch.bool, device=dev)

    step = 0
    while step < max_steps and not bool(done.all()):
        # 1. the F best unexpanded candidates per query
        avail = ~cand_x & (cand_i >= 0)
        f_sims, f_pos = topk_desc(torch.where(avail, cand_s, NEG_INF), frontier)
        f_ids = cand_i.gather(1, f_pos)
        f_ok = f_sims > NEG_INF / 2

        # 2. termination: candidates exhausted, best candidate cannot beat
        #    the worst result when full, or scan budget hit
        res_min, res_full = res_s[:, -1], res_i[:, -1] >= 0
        done = done | ~avail.any(dim=1) | (res_full & (f_sims[:, 0] < res_min)) | (scanned >= scan_budget)
        active = ~done
        act = active[:, None]

        # 3. mark the chosen candidates expanded
        chosen = torch.zeros_like(cand_x).scatter_(1, f_pos, f_ok)
        cand_x = cand_x | (chosen & act)

        # 4. gather neighbour ids (Q, F*M0)
        nbrs3 = l0_nbrs[f_ids.clamp_min(0)]  # (Q, F, M0)
        valid = ((nbrs3 >= 0) & f_ok[:, :, None]).reshape(nq, -1) & act
        nbrs_safe = nbrs3.reshape(nq, -1).long().clamp_min(0)

        if frontier > 1:
            # in-step dedup (two frontier nodes may share a neighbour) keeps
            # the bitset scatter-add sound; lanes keep their order, so ties in
            # the merges below fall as in the JAX module
            key = torch.where(valid, nbrs_safe, _SORT_SENTINEL)
            key_sorted, order = torch.sort(key, dim=1, stable=True)
            dup = torch.empty_like(valid).scatter_(1, order, _shift_dup(key_sorted))
            valid = valid & ~dup

        # 5. visited test + set
        word_idx = nbrs_safe >> 5
        bit = bits[nbrs_safe & 31]
        fresh = valid & ((visited.gather(1, word_idx) & bit) == 0)
        visited.scatter_add_(1, word_idx, torch.where(fresh, bit, 0))

        # 6. score every neighbour, keep the fresh ones
        sims = _rows_sims(q_dense, doc_idx[nbrs_safe], doc_val[nbrs_safe])
        sims = torch.where(fresh, sims, NEG_INF)
        scanned = scanned + fresh.sum(dim=1, dtype=torch.int32)

        # 7. merge into the candidate set (traversal is unfiltered)
        all_s = torch.cat([cand_s, sims], dim=1)
        all_i = torch.cat([cand_i, torch.where(fresh, nbrs_safe, -1)], dim=1)
        all_x = torch.cat([cand_x, torch.zeros_like(fresh)], dim=1)
        new_s, sel = topk_desc(all_s, ef)
        cand_s = torch.where(act, new_s, cand_s)
        cand_i = torch.where(act, all_i.gather(1, sel), cand_i)
        cand_x = torch.where(act, all_x.gather(1, sel), cand_x)

        # 8. merge into the results (filter applied at insert)
        rsims = torch.where(mask[nbrs_safe] & fresh, sims, NEG_INF) if mask is not None else sims
        rids = torch.where(rsims > NEG_INF / 2, nbrs_safe, -1)
        nr_s, rsel = topk_desc(torch.cat([res_s, rsims], dim=1), kw)
        res_s = torch.where(act, nr_s, res_s)
        res_i = torch.where(act, torch.cat([res_i, rids], dim=1).gather(1, rsel), res_i)
        step += 1

    hnsw_sparse_search.last_steps = step
    res_s, res_i = res_s[:, :topk], res_i[:, :topk]
    res_i = torch.where(res_s > NEG_INF / 2, res_i, -1)
    return res_s, res_i


hnsw_sparse_search.last_steps = 0  # beam steps the last call ran (one host sync each)
