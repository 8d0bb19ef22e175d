"""HNSW device ops in PyTorch: batched greedy descent + L0 beam search (with
an optional in-beam per-group harvest), and the batched kNN-graph build steps
(exact or cluster-local candidates, prune, NN-descent round, merge + prune).

Port of `zvec_tpu/ops/hnsw.py`. Queries run in lockstep batches; each beam
step gathers the padded neighbour lists of F frontier nodes per query, scores
them in one batched product, tests and sets a visited set, and folds the
results into the running top-ef with `topk_desc` (lower index first on ties,
the order `lax.top_k` gives, so both packages traverse alike). The JAX
`lax.while_loop` becomes a Python loop whose condition costs one host sync per
step. Filtered-search semantics match the reference: filtered nodes are
traversed but never enter the result set (`hnsw_algorithm.cc:188-195,270`).

The build's forward kNN pass scores every batch with the fused flat scan
(`ops/flat_scan.py::flat_scan_topk`, the CUDA kernel on the card) for
knn_k <= 127, and with the exact blockwise torch scan above that.

The clustered build (layers past 2M rows) takes its candidates from k-means
buckets instead of full scans: `assign_top2_blocked` (two nearest centroids
per row, blocked over N; fp32, bf16 or int8 rows; it also serves the IVF SOAR
spill, `ops/kmeans.py::assign_top2`), `bucket_knn_all` (exact top-kc inside
every bucket), then `merge_prune_batch_out`, `nn_descent_round` and
`merge_prune_chunk_out`, which share one prune body (`_merge_prune_ids`) with
`merge_prune_step`. Build codes may be fp32, bf16 or symmetric int8; they keep
their dtype on every gather and are multiplied in float32.

Graph layout (tensors on one device):
  codes      (N_pad, D)          vectors (f32 / f16 / int8 / packed int4)
  l0_nbrs    (N_pad, M0) int32   level-0 adjacency, -1 padded
  per upper level l >= 1 (compact arrays over the N_l member nodes):
    ids_l    (N_l,)  int64       member node ids (row -> id)
    nbrs_l   (N_l, Mu) int64     adjacency as rows into level l, -1 padded
    down_l   (N_l,)  int64       row of the same node in level l-1
                                 (level 1's down_l is the node id itself)

Routed traversal: the beam may walk a reduced-precision code tier (int8 or
bf16 codes of an fp32 index) and re-rank its final working set once against
the fp32 tier (`refine_codes` / `refine_norms`), so returned scores stay
fp32-exact.

Left out against the JAX module: the bf16 hi/lo product splits (an MXU pass
trick; products here are full float32, TF32 off), `approx_max_k` (accepted
and run exact, in the beam's merges and in `bucket_knn_all`), and the packed
D2H transfer (`hnsw_search_packed`, a TPU workaround: this returns tensors).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..typing.enum import MetricType
from .distance import unpack_nibbles
from .runtime import NEG_INF, topk_desc

__all__ = [
    "hnsw_search",
    "prune_scored",
    "knn_build_step",
    "merge_prune_step",
    "merge_prune_batch_out",
    "merge_prune_chunk_out",
    "nn_descent_round",
    "bucket_knn_all",
    "assign_top2_blocked",
]

_HASH_MULT = 2654435761  # Knuth multiplicative hash of the visited index
_SORT_SENTINEL = 2**30  # dedup key of invalid lanes: sorts after every real key
# bit i of an int32 visited word; bit 31 is the sign bit
_BITS = [1 << i for i in range(31)] + [-(1 << 31)]


def _exact_dots(subscripts, a, b):
    """Dot products at full operand precision: both sides go to float32 and
    multiply there (TF32 is off, `ops/runtime.py`).

    bf16 x bf16: every product is exact in float32 and the sum accumulates
    in float32, which is what the JAX module's one native pass computes.
    int8 x int8: exact, |dot| <= D * 127^2 < 2^24 up to D = 1024.
    f32 x bf16 (or bf16 x f32): the JAX module splits the f32 side into bf16
    hi + lo halves, two passes that drop the f32 side's low 8 mantissa bits;
    that split is left out on purpose. The product here is the full float32
    one, so mixed scores differ from the JAX module's below 1e-5 relative."""
    return torch.einsum(subscripts, a.float(), b.float())


def _batched_sims(q, vecs, metric, norms=None, dequant=None, int4_packed=False):
    """q: (Q, D); vecs: (Q, M, D) -> (Q, M) similarity (larger = closer).

    `dequant=(scale, bias)` dequantizes gathered integer codes on the fly:
    dot(q, s*c + b) = s*dot(q, c) + b*sum(q). `int4_packed`: vecs holds two
    int4 codes per byte ((Q, M, ceil(D/2)) int8); the dot splits into the
    even / odd nibble planes."""
    if int4_packed:
        lo, hi = unpack_nibbles(vecs)
        d2 = vecs.shape[-1]
        q_even = q[:, 0 : 2 * d2 : 2]
        q_odd = q[:, 1 : 2 * d2 : 2]
        if q_odd.shape[1] < d2:
            q_odd = torch.nn.functional.pad(q_odd, (0, d2 - q_odd.shape[1]))
        dots = _exact_dots("qd,qmd->qm", q_even, lo) + _exact_dots("qd,qmd->qm", q_odd, hi)
        if dequant is not None:
            dots = dequant[0] * dots + dequant[1] * q.sum(-1, keepdim=True)
        return _sims_from_dots(q, dots, metric, norms)
    dots = _exact_dots("qd,qmd->qm", q, vecs)
    if dequant is not None:
        dots = dequant[0] * dots + dequant[1] * q.sum(-1, keepdim=True)
    return _sims_from_dots(q, dots, metric, norms)


def _sims_from_dots(q, dots, metric, norms):
    if metric == MetricType.IP:
        return dots
    if metric == MetricType.L2:
        q_sq = (q * q).sum(-1, keepdim=True)
        return -(q_sq + norms - 2.0 * dots)
    if metric == MetricType.COSINE:
        q_n = torch.sqrt((q * q).sum(-1, keepdim=True))
        denom = q_n * torch.sqrt(norms)
        return torch.where(denom > 0, dots / torch.where(denom > 0, denom, 1.0), 1.0)
    raise ValueError(f"unsupported metric {metric}")


def _visit_index(ids, visited_bits: int):
    """Node ids -> visited-set positions. visited_bits=0 keeps the exact
    id-indexed set; > 0 hashes into 2**visited_bits slots (the uint32
    product of the JAX code, taken mod 2^32 by the mask)."""
    if visited_bits <= 0:
        return ids
    return (ids * _HASH_MULT) & ((1 << visited_bits) - 1)


def _shift_dup(x):
    """True where an entry equals its left neighbour along dim 1."""
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[:, 1:] = x[:, 1:] == x[:, :-1]
    return dup


def _grouped_merge(grp_s, grp_i, grp_g, add_s, add_i, add_g, group_topk: int):
    """Merge scored rows into a per-group-capped result buffer: at most
    `group_topk` best rows per group code, then the best R rows overall
    (R = the buffer's width); the batched form of the reference's per-group
    heaps (`hnsw_context.h:25-230`). One stable two-key sort (group, then
    similarity descending) lays each group out best first; the rank within a
    group is a cumulative count less the count at the group's start, so there
    is no loop over groups."""
    r = grp_s.shape[1]
    s = torch.cat([grp_s, add_s], dim=1)
    i = torch.cat([grp_i, add_i], dim=1)
    g = torch.cat([grp_g, add_g], dim=1)
    invalid = (i < 0) | (g < 0)
    gkey = torch.where(invalid, _SORT_SENTINEL, g)
    neg_s = torch.where(invalid, float("inf"), -s)  # invalid rows sink last
    # lexicographic (gkey, neg_s): stable sort on the minor key, then on the major
    o_minor = torch.sort(neg_s, dim=1, stable=True).indices
    gk_srt, o_major = torch.sort(gkey.gather(1, o_minor), dim=1, stable=True)
    order = o_minor.gather(1, o_major)
    s_srt = s.gather(1, order)
    id_srt = i.gather(1, order)
    boundary = torch.ones_like(invalid)
    boundary[:, 1:] = gk_srt[:, 1:] != gk_srt[:, :-1]
    # the byte-map beam may score a within-step duplicate twice; equal
    # (group, sim, id) rows sort next to each other: null the repeats so a
    # group cannot fill its quota with copies
    counted = (gk_srt < _SORT_SENTINEL) & ~(_shift_dup(id_srt) & (id_srt >= 0))
    cnt = counted.long()
    before = torch.cumsum(cnt, dim=1) - cnt  # counted rows left of each lane
    # the count at each group's start, carried along the group by a running
    # max (the counts never decrease, so a later group's start dominates)
    base = torch.cummax(torch.where(boundary, before, 0), dim=1).values
    keep = counted & (before - base < group_topk)
    new_s, sel = topk_desc(torch.where(keep, s_srt, NEG_INF), r)
    ok = new_s > NEG_INF / 2
    return (
        new_s,
        torch.where(ok, id_srt.gather(1, sel), -1),
        torch.where(ok, gk_srt.gather(1, sel), -1),
    )


def hnsw_search(
    q: torch.Tensor,  # (Q, D) f32
    codes: torch.Tensor,  # (N_pad, D)
    norms: torch.Tensor,  # (N_pad,)
    l0_nbrs: torch.Tensor,  # (N_pad, M0)
    upper_ids: Sequence[torch.Tensor],  # per level 1..L: (N_l,)
    upper_nbrs: Sequence[torch.Tensor],  # per level 1..L: (N_l, Mu)
    upper_down: Sequence[torch.Tensor],  # per level 1..L: (N_l,)
    entry_rows: Sequence[int],  # (L+1,) entry row per level (row at top used)
    mask: Optional[torch.Tensor],  # (N_pad,) bool result filter or None
    scan_budget: int,
    dequant=None,
    refine_codes: Optional[torch.Tensor] = None,  # (N_pad, D) fp32 exact tier
    refine_norms: Optional[torch.Tensor] = None,  # (N_pad,) fp32
    *,
    metric: MetricType,
    ef: int,
    topk: int,
    max_steps: int,
    num_levels: int,
    frontier: int = 1,
    int4_packed: bool = False,
    visited_bits: int = 0,
    visited_bytes: bool = False,
    approx_merge: bool = False,  # accepted; the merges always run exact
    done_frac: float = 1.0,
    group_codes: Optional[torch.Tensor] = None,  # (N_pad,) int group codes, -1 = none
    group_cap: int = 0,  # width R of the per-group result buffer (0 = off)
    group_topk: int = 0,  # rows kept per group
):
    """Batched HNSW search (`_beam_core` with `hnsw_search` and
    `hnsw_search_grouped` of the JAX module).
    Returns (sims (Q, topk) desc, ids (Q, topk) int64, -1 pad).

    group_cap > 0 with `group_codes` also harvests, while the beam runs, a
    (Q, R) buffer of the best `group_topk` rows per group code over every row
    the beam scored (reference in-traversal grouping,
    `hnsw_algorithm.cc:102-104`), and returns (sims, ids, grp_sims, grp_ids,
    grp_codes). The buffer is harvest only: it never steers the traversal or
    its termination, so the cost does not grow with the number of groups.

    `refine_codes` / `refine_norms` (routed traversal): the beam navigates on
    `codes` (int8 or bf16), then the whole working set (kw = max(ef, topk)
    rows per query) is scored once against this fp32 tier and the top-k
    taken from those scores.

    visited_bytes=True keeps the (hashed) visited set as a byte map: a set
    is duplicate-safe, so the per-step dedup sort is elided and a
    within-step duplicate may be scored twice (its copies are nulled after
    the merge). done_frac < 1.0 stops the batch once that fraction of
    queries has terminated; a cut-off query keeps the best it has found."""
    del approx_merge
    nq = q.shape[0]
    dev = codes.device
    q = q.float()

    def sims_of(ids):
        return _batched_sims(q, codes[ids], metric, norms[ids], dequant, int4_packed)

    # ---- greedy descent through the upper levels (ef = 1) ----
    if num_levels > 0:
        cur_row = torch.full((nq,), int(entry_rows[num_levels]), dtype=torch.long, device=dev)
        for lvl in range(num_levels - 1, -1, -1):
            ids_l, nbrs_l = upper_ids[lvl], upper_nbrs[lvl]
            cur_sim = sims_of(ids_l[cur_row][:, None])[:, 0]
            while True:
                nrows = nbrs_l[cur_row]  # (Q, Mu)
                sims = sims_of(ids_l[nrows.clamp_min(0)])
                sims = torch.where(nrows >= 0, sims, NEG_INF)
                best = sims.argmax(dim=1, keepdim=True)  # first max, as jnp.argmax
                best_sim = sims.gather(1, best)[:, 0]
                better = best_sim > cur_sim
                cur_row = torch.where(better, nrows.gather(1, best)[:, 0], cur_row)
                cur_sim = torch.where(better, best_sim, cur_sim)
                if not bool(better.any()):
                    break
            cur_row = upper_down[lvl][cur_row]  # drop to the next level's rows
        entry_ids = cur_row  # level-1 down rows are node ids at level 0
    else:
        entry_ids = torch.full((nq,), int(entry_rows[0]), dtype=torch.long, device=dev)

    # ---- level-0 beam ----
    n_pad = codes.shape[0]
    nbits = n_pad if visited_bits <= 0 else (1 << visited_bits)
    words = (nbits + 31) // 32
    entry_sim = sims_of(entry_ids[:, None])[:, 0]

    # The working result set is ef wide. Unfiltered with ef >= topk it is
    # the candidate set itself (both are the running top-ef of every scored
    # node), so the result merge is elided.
    kw = max(ef, topk)
    track_res = mask is not None or topk > ef
    if track_res:
        entry_ok = mask[entry_ids] if mask is not None else torch.ones(nq, dtype=torch.bool, device=dev)
        res_s = torch.full((nq, kw), NEG_INF, dtype=torch.float32, device=dev)
        res_i = torch.full((nq, kw), -1, dtype=torch.long, device=dev)
        res_s[:, 0] = torch.where(entry_ok, entry_sim, NEG_INF)
        res_i[:, 0] = torch.where(entry_ok, entry_ids, -1)
    cand_s = torch.full((nq, ef), NEG_INF, dtype=torch.float32, device=dev)
    cand_i = torch.full((nq, ef), -1, dtype=torch.long, device=dev)
    cand_s[:, 0] = entry_sim
    cand_i[:, 0] = entry_ids
    cand_x = torch.zeros((nq, ef), dtype=torch.bool, device=dev)  # expanded flags

    grouped = group_cap > 0 and group_codes is not None
    if grouped:
        group_codes = group_codes.long()
        g_ok = mask[entry_ids] if mask is not None else torch.ones(nq, dtype=torch.bool, device=dev)
        grp_s = torch.full((nq, group_cap), NEG_INF, dtype=torch.float32, device=dev)
        grp_i = torch.full((nq, group_cap), -1, dtype=torch.long, device=dev)
        grp_g = torch.full((nq, group_cap), -1, dtype=torch.long, device=dev)
        grp_s[:, 0] = torch.where(g_ok, entry_sim, NEG_INF)
        grp_i[:, 0] = torch.where(g_ok, entry_ids, -1)
        grp_g[:, 0] = torch.where(g_ok, group_codes[entry_ids], -1)

    use_bytes = visited_bytes and visited_bits > 0
    qrows = torch.arange(nq, device=dev)
    entry_vix = _visit_index(entry_ids, visited_bits)
    if use_bytes:
        # one extra column takes the writes of lanes that are not fresh
        visited = torch.zeros((nq, nbits + 1), dtype=torch.bool, device=dev)
        visited[qrows, entry_vix] = True
    else:
        bits = torch.tensor(_BITS, dtype=torch.int32, device=dev)
        visited = torch.zeros((nq, words), dtype=torch.int32, device=dev)
        visited[qrows, entry_vix >> 5] = bits[entry_vix & 31]
    scanned = torch.ones(nq, dtype=torch.int32, device=dev)
    done = torch.zeros(nq, dtype=torch.bool, device=dev)
    min_done = nq if done_frac >= 1.0 else min(nq, int(math.ceil(done_frac * nq)))

    step = 0
    while step < max_steps and int(done.sum()) < min_done:
        # 1. the F best unexpanded candidates per query
        avail = ~cand_x & (cand_i >= 0)
        f_sims, f_pos = topk_desc(torch.where(avail, cand_s, NEG_INF), frontier)
        f_ids = cand_i.gather(1, f_pos)
        f_ok = f_sims > NEG_INF / 2

        # 2. termination: candidates exhausted, best candidate cannot beat
        #    the worst result when full, or scan budget hit
        if track_res:
            res_min, res_full = res_s[:, -1], res_i[:, -1] >= 0
        else:
            res_min, res_full = cand_s[:, -1], cand_i[:, -1] >= 0
        done = done | ~avail.any(dim=1) | (res_full & (f_sims[:, 0] < res_min)) | (scanned >= scan_budget)
        active = ~done

        # 3. mark the chosen candidates expanded
        chosen = torch.zeros_like(cand_x).scatter_(1, f_pos, f_ok)
        cand_x = cand_x | (chosen & active[:, None])

        # 4. gather neighbour ids (Q, F*M0)
        nbrs3 = l0_nbrs[f_ids.clamp_min(0)]  # (Q, F, M0)
        valid = ((nbrs3 >= 0) & f_ok[:, :, None]).reshape(nq, -1) & active[:, None]
        nbrs_safe = nbrs3.reshape(nq, -1).long().clamp_min(0)
        vix = _visit_index(nbrs_safe, visited_bits)

        # 5. visited test + set
        if use_bytes:
            fresh = valid & ~visited.gather(1, vix)
            visited.scatter_(1, torch.where(fresh, vix, nbits), True)
        else:
            if frontier > 1 or visited_bits > 0:
                # intra-step dedup on the visit index (two frontier nodes may
                # share a neighbour; hashed collisions collapse too): one
                # stable sort, and everything downstream stays in sorted order
                key = torch.where(valid, vix, _SORT_SENTINEL)
                key_sorted, order = torch.sort(key, dim=1, stable=True)
                nbrs_safe = nbrs_safe.gather(1, order)
                valid = (key_sorted < _SORT_SENTINEL) & ~_shift_dup(key_sorted)
                vix = torch.where(valid, key_sorted, _visit_index(nbrs_safe, visited_bits))
            word_idx = vix >> 5
            bit = bits[vix & 31]
            fresh = valid & ((visited.gather(1, word_idx) & bit) == 0)
            # unique fresh bits: scatter-add acts as scatter-or
            visited.scatter_add_(1, word_idx, torch.where(fresh, bit, 0))

        # 6. score every neighbour, keep the fresh ones
        sims = torch.where(fresh, sims_of(nbrs_safe), NEG_INF)
        scanned = scanned + fresh.sum(dim=1, dtype=torch.int32)

        # 7. merge into the candidate set (traversal is unfiltered)
        all_s = torch.cat([cand_s, sims], dim=1)
        all_i = torch.cat([cand_i, torch.where(fresh, nbrs_safe, -1)], dim=1)
        all_x = torch.cat([cand_x, torch.zeros_like(fresh)], dim=1)
        new_s, sel = topk_desc(all_s, ef)
        new_i = all_i.gather(1, sel)
        new_x = all_x.gather(1, sel)
        if use_bytes:
            # a within-step duplicate reaches the merge as an equal-sim copy,
            # placed next to its twin; null the repeats
            dup = _shift_dup(new_i) & (new_i >= 0)
            new_s = torch.where(dup, NEG_INF, new_s)
            new_i = torch.where(dup, -1, new_i)
            new_x = new_x & ~dup
        act = active[:, None]
        cand_s = torch.where(act, new_s, cand_s)
        cand_i = torch.where(act, new_i, cand_i)
        cand_x = torch.where(act, new_x, cand_x)

        # 8. merge into the results (filter applied at insert)
        if track_res:
            rsims = torch.where(mask[nbrs_safe] & fresh, sims, NEG_INF) if mask is not None else sims
            rids = torch.where(rsims > NEG_INF / 2, nbrs_safe, -1)
            nr_s, rsel = topk_desc(torch.cat([res_s, rsims], dim=1), kw)
            nr_i = torch.cat([res_i, rids], dim=1).gather(1, rsel)
            if use_bytes:
                rdup = _shift_dup(nr_i) & (nr_i >= 0)
                nr_s = torch.where(rdup, NEG_INF, nr_s)
                nr_i = torch.where(rdup, -1, nr_i)
            res_s = torch.where(act, nr_s, res_s)
            res_i = torch.where(act, nr_i, res_i)

        # 9. per-group harvest: every scored row that passes the filter
        #    competes for its group's quota
        if grouped:
            g_ok = (mask[nbrs_safe] & fresh) if mask is not None else fresh
            ng_s, ng_i, ng_g = _grouped_merge(
                grp_s, grp_i, grp_g,
                torch.where(g_ok, sims, NEG_INF),
                torch.where(g_ok, nbrs_safe, -1),
                torch.where(g_ok, group_codes[nbrs_safe], -1),
                group_topk,
            )
            grp_s = torch.where(act, ng_s, grp_s)
            grp_i = torch.where(act, ng_i, grp_i)
            grp_g = torch.where(act, ng_g, grp_g)
        step += 1

    hnsw_search.last_steps = step
    if not track_res:
        res_s, res_i = cand_s, cand_i
    if refine_codes is not None:
        safe = res_i.clamp_min(0)
        ex = _batched_sims(q, refine_codes[safe], metric, refine_norms[safe])
        res_s, sel = topk_desc(torch.where(res_i >= 0, ex, NEG_INF), topk)
        res_i = res_i.gather(1, sel)
    else:
        res_s, res_i = res_s[:, :topk], res_i[:, :topk]
    res_i = torch.where(res_s > NEG_INF / 2, res_i, -1)
    if grouped:
        return res_s, res_i, grp_s, grp_i, grp_g
    return res_s, res_i


hnsw_search.last_steps = 0  # beam steps the last call ran (one host sync each)


# ---------------------------------------------------------------------------
# Batched kNN-graph construction: exact kNN candidate lists + the reference's
# heuristic prune, every node in parallel (the GPU-literature recipe,
# CAGRA/GGNN), then reverse links and a final merge prune.
# ---------------------------------------------------------------------------


def _prune_thresh(cand_sims, metric, alpha: float = 1.0):
    """Dominance threshold per candidate, with the optional Vamana-style
    alpha relaxation: candidate i conflicts with kept j iff
    d(i, j) <= d(i, base) / alpha. L2 sims are -d^2 (scale 1/alpha^2);
    COSINE sims are cos (1 - cos transforms affinely); IP ignores alpha."""
    if alpha == 1.0:
        return cand_sims
    if metric == MetricType.L2:
        return cand_sims * (1.0 / (alpha * alpha))
    if metric == MetricType.COSINE:
        return 1.0 - (1.0 - cand_sims) / alpha
    return cand_sims


def _prune_keep(
    pair, cand_sims, cand_valid, max_out: int, chunk: int = 8, metric=None,
    alpha: float = 1.0,
):
    """Keep candidate i (desc-sim order) iff no already-kept j dominates it
    (sim(i, j) >= thresh(i)); stop at max_out (reference `update_neighbors`,
    `hnsw_algorithm.cc:394-430`).

    Block-sequential: conflicts against earlier blocks' keeps collapse into
    one (B, G, C) test per block of `chunk` candidates, and the G decisions
    inside a block run one by one. Keeps are identical to the naive
    per-candidate walk."""
    thresh = _prune_thresh(cand_sims, metric, alpha) if metric is not None else cand_sims
    b, c = cand_sims.shape
    pad = (-c) % chunk
    if pad:
        pair = torch.nn.functional.pad(pair, (0, pad, 0, pad), value=NEG_INF)
        thresh = torch.nn.functional.pad(thresh, (0, pad), value=NEG_INF)
        cand_valid = torch.cat([cand_valid, cand_valid.new_zeros((b, pad))], dim=1)
    keep = torch.zeros((b, c + pad), dtype=torch.bool, device=cand_sims.device)
    count = torch.zeros(b, dtype=torch.int32, device=cand_sims.device)
    for lo in range(0, c + pad, chunk):
        hi = lo + chunk
        pair_blk = pair[:, lo:hi, :]  # (B, G, C)
        pair_intra = pair_blk[:, :, lo:hi]  # (B, G, G)
        th_blk = thresh[:, lo:hi]
        # conflicts with every candidate kept in EARLIER blocks (this
        # block's keeps are still False here)
        conf = (keep[:, None, :] & (pair_blk >= th_blk[:, :, None])).any(dim=2)
        for g in range(chunk):
            good = cand_valid[:, lo + g] & ~conf[:, g] & (count < max_out)
            keep[:, lo + g] = good
            count += good
            # a kept g dominates any later i of this block with
            # sim(i, g) >= thresh(i)
            conf = conf | (good[:, None] & (pair_intra[:, :, g] >= th_blk))
    return keep[:, :c]


def _pairwise_sims(vecs, norms2, metric):
    """vecs (B, C, D), norms2 (B, C) -> (B, C, C) similarity."""
    dots = _exact_dots("bcd,bed->bce", vecs, vecs)
    if metric == MetricType.IP:
        return dots
    if metric == MetricType.L2:
        return -(norms2[:, :, None] + norms2[:, None, :] - 2.0 * dots)
    if metric == MetricType.COSINE:
        nn = torch.sqrt(norms2)
        denom = nn[:, :, None] * nn[:, None, :]
        return torch.where(denom > 0, dots / torch.where(denom > 0, denom, 1.0), 1.0)
    raise ValueError(f"unsupported metric {metric}")


def _stable_rank(tier):
    """Positions sorted by tier, ties in original order (jnp.argsort stable)."""
    return torch.sort(tier, dim=1, stable=True).indices


def _compact_keep(keep, ids, sims, max_out: int):
    """Compact kept candidates (desc-sim order preserved) to (B, max_out)."""
    rank = _stable_rank((~keep).to(torch.uint8))  # kept first, order-stable
    ids_c = torch.where(keep, ids, -1).gather(1, rank)[:, :max_out]
    sims_c = torch.where(keep, sims, NEG_INF).gather(1, rank)[:, :max_out]
    return ids_c, sims_c


def _compact_keep_backfill(
    keep, valid, ids, sims, max_out: int,
    pair=None, metric=None, backfill_alpha: float = 0.0,
):
    """Compact kept candidates, then backfill the remaining slots with the
    best dominance-pruned (but valid) candidates (hnswlib's
    keepPrunedConnections). backfill_alpha > 0 inserts a second,
    alpha-relaxed prune round over the pruned pool whose survivors rank
    ahead of the rest."""
    if backfill_alpha and pair is not None:
        pruned = valid & ~keep
        keep2 = _prune_keep(
            pair, torch.where(pruned, sims, NEG_INF), pruned, max_out,
            metric=metric, alpha=backfill_alpha,
        )
        tier = torch.where(keep, 0, torch.where(keep2, 1, torch.where(valid, 2, 3)))
        last = 3
    else:
        tier = torch.where(keep, 0, torch.where(valid, 1, 2))
        last = 2
    tier = tier.to(torch.int8)
    rank = _stable_rank(tier)
    tier_c = tier.gather(1, rank)[:, :max_out]
    ids_c = ids.gather(1, rank)[:, :max_out]
    sims_c = sims.gather(1, rank)[:, :max_out]
    ids_c = torch.where(tier_c < last, ids_c, -1)
    sims_c = torch.where(tier_c < last, sims_c, NEG_INF)
    return ids_c, sims_c


def _dup_mask(ids):
    """(B, C) ids (any order) -> True at every occurrence AFTER the first of
    a repeated id."""
    order = torch.sort(ids, dim=1, stable=True).indices
    dup_sorted = _shift_dup(ids.gather(1, order))
    return torch.empty_like(dup_sorted).scatter_(1, order, dup_sorted)


def _sim_to_base(base, bnorm2, vecs, nrm2, metric):
    """sim(base_b, cand_bc): base (B, D), vecs (B, C, D) -> (B, C)."""
    dots = _exact_dots("bd,bcd->bc", base, vecs)
    if metric == MetricType.IP:
        return dots
    if metric == MetricType.L2:
        return -(bnorm2[:, None] + nrm2 - 2.0 * dots)
    if metric == MetricType.COSINE:
        denom = torch.sqrt(bnorm2)[:, None] * torch.sqrt(nrm2)
        return torch.where(denom > 0, dots / torch.where(denom > 0, denom, 1.0), 1.0)
    raise ValueError(f"unsupported metric {metric}")


def _pad_cols(ids, width):
    if ids.shape[1] < width:  # fewer candidates than out-degree
        ids = torch.nn.functional.pad(ids, (0, width - ids.shape[1]), value=-1)
    return ids


def prune_scored(
    rows,  # (B,) base node rows
    cand_ids,  # (B, C) candidate rows, DESC by sim, -1 pad
    cand_sims,  # (B, C) similarity to base
    codes,  # (N_pad, D)
    norms2,  # (N_pad,) squared norms
    *,
    metric: MetricType,
    max_out: int,
    alpha: float = 1.0,
    backfill_alpha: float = 0.0,
):
    """Heuristic prune of pre-scored desc-sorted candidates -> (B, max_out)
    ids (-1 pad). Self / duplicate candidates fall to the dominance rule."""
    valid = (cand_ids >= 0) & (cand_ids != rows[:, None])
    safe = cand_ids.clamp_min(0)
    pair = _pairwise_sims(codes[safe], norms2[safe], metric)
    sims = torch.where(valid, cand_sims, NEG_INF)
    keep = _prune_keep(pair, sims, valid, max_out, metric=metric, alpha=alpha)
    ids_c, _ = _compact_keep_backfill(
        keep, valid, cand_ids, sims, max_out,
        pair=pair, metric=metric, backfill_alpha=backfill_alpha,
    )
    return _pad_cols(ids_c, max_out)


def knn_build_step(
    rows,  # (B,) node rows of this batch (pad = repeat a real row)
    codes,  # (N_pad, D) f32, N_pad % 1024 == 0
    norms2,  # (N_pad,) squared norms (f32)
    mask,  # (N_pad,) int8, 1 = real row
    adj,  # (N, max_out) int32 adjacency, updated in place
    *,
    metric: MetricType,
    knn_k: int,
    max_out: int,
    use_kernel: bool = True,
    alpha: float = 1.0,
    backfill_alpha: float = 0.0,
    exact_tf32: bool = False,
    scan_codes=None,  # (N_pad, D') codes zero-padded to D' >= D columns for the scan; None = codes
):
    """One build batch: exact top-(knn_k+1) scan for the batch's nodes
    (self-matches included; the prune drops them), heuristic prune to
    max_out forward neighbours, scatter into `adj` (in place: the JAX
    version donates the buffer). knn_k <= 127 rides the fused flat scan,
    whose stage one is the CUDA kernel for CUDA tensors (one TF32 product
    with `exact_tf32`, for +-1 codes); larger pools use the exact blockwise
    scan. Zero columns change no key, so `scan_codes` (16-byte rows for the
    kernel's copies) gives the scan of `codes`; the prune reads `codes`."""
    if scan_codes is None:
        scan_codes = codes
    q = scan_codes[rows].float()
    if use_kernel:
        from .flat_scan import flat_scan_topk

        scan_norms = torch.sqrt(norms2) if metric == MetricType.COSINE else norms2
        sims, ids = flat_scan_topk(q, scan_codes, scan_norms, mask, metric=metric, topk=knn_k + 1,
                                   exact_tf32=exact_tf32)
    else:
        from .topk import blockwise_topk_search

        sims, ids = blockwise_topk_search(
            q, scan_codes, metric, knn_k + 1,
            mask=mask != 0, x_sq_norms=norms2, block_size=131072,
        )
    out_ids = prune_scored(
        rows, ids, sims, codes, norms2, metric=metric, max_out=max_out,
        alpha=alpha, backfill_alpha=backfill_alpha,
    )
    adj[rows] = out_ids.to(adj.dtype)
    return adj


def _merge_prune_ids(
    rows,  # (B,) base node rows
    cand_ids,  # (B, C) candidate rows, any order, -1 pad
    codes,
    norms2,
    *,
    metric: MetricType,
    max_out: int,
    alpha: float = 1.0,
    backfill_alpha: float = 0.0,
    window: int = 0,
):
    """The prune every merge phase shares: score the candidates against the
    base, sort desc (stable), drop self / pad / repeated ids, heuristic-prune,
    compact with backfill -> (B, max_out) int64 ids, -1 pad. `window` > 0 lets
    only the best `window` scored candidates reach the prune, which bounds the
    (B, C, C) pair buffer. Gathered codes keep their dtype (`_exact_dots`
    multiplies them in float32)."""
    rows = rows.long()
    cand_ids = cand_ids.long()
    valid = (cand_ids >= 0) & (cand_ids != rows[:, None])
    safe = cand_ids.clamp_min(0)
    vecs = codes[safe]
    nrm2 = norms2[safe]
    sims = _sim_to_base(codes[rows], norms2[rows], vecs, nrm2, metric)
    sims = torch.where(valid, sims, NEG_INF)
    order = torch.sort(-sims, dim=1, stable=True).indices
    if 0 < window < order.shape[1]:
        order = order[:, :window]
    ids_o = cand_ids.gather(1, order)
    sims_o = sims.gather(1, order)
    # forward + reverse (or two neighbours' lists) can repeat an id: keep the first
    valid_o = valid.gather(1, order) & ~_dup_mask(ids_o)
    vecs_o = vecs.gather(1, order[:, :, None].expand(-1, -1, vecs.shape[2]))
    pair = _pairwise_sims(vecs_o, nrm2.gather(1, order), metric)
    sims_o = torch.where(valid_o, sims_o, NEG_INF)
    keep = _prune_keep(pair, sims_o, valid_o, max_out, metric=metric, alpha=alpha)
    ids_c, _ = _compact_keep_backfill(
        keep, valid_o, ids_o, sims_o, max_out,
        pair=pair, metric=metric, backfill_alpha=backfill_alpha,
    )
    return _pad_cols(ids_c, max_out)


def merge_prune_step(
    rows,  # (B,)
    cand_ids,  # (B, C) forward + reverse candidates, unsorted
    codes,
    norms2,
    adj,  # (N, max_out) int32, updated in place
    **kw,  # metric, max_out, alpha, backfill_alpha
):
    """Final per-node prune over forward + reverse candidates, scattered
    into `adj`."""
    adj[rows] = _merge_prune_ids(rows, cand_ids, codes, norms2, **kw).to(adj.dtype)
    return adj


def merge_prune_chunk_out(rows_mat, cand_mat, codes, norms2, **kw):
    """`merge_prune_step` over (NB, B) rows with their (NB, B, C) candidates
    passed in, emitting the pruned ids (NB, B, max_out) int32 instead of
    scattering them. One prune per batch, no host sync in between."""
    return torch.stack([
        _merge_prune_ids(rows, cand, codes, norms2, **kw).int()
        for rows, cand in zip(rows_mat, cand_mat)
    ])


def merge_prune_batch_out(rows_mat, cand_full, codes, norms2, **kw):
    """Forward prune straight from the device-resident candidate table
    `cand_full` (n + 1, C): each batch of `rows_mat` (NB, B) gathers its rows'
    candidate lanes and emits pruned ids -> (NB, B, max_out) int32."""
    return torch.stack([
        _merge_prune_ids(rows, cand_full[rows.long()], codes, norms2, **kw).int()
        for rows in rows_mat
    ])


def nn_descent_round(rows_mat, fwd_full, codes, norms2, *, max_out: int, expand: int, **kw):
    """One NN-descent round (Dong et al., WWW'11) over (NB, B) rows: a node's
    candidates are its own neighbours and the neighbours of `expand` of them,
    scored exactly against the node and pruned again. It heals the boundary
    errors of cluster-local candidates (a true neighbour in the next k-means
    cell is two hops away in the first graph).

    `fwd_full` is the (n + 1, m0) adjacency, sim-desc per row, whose last row
    is all -1 (pads expand to it). The expanded neighbours are taken at
    stride m0 // expand across the ranked list: the best ones mostly share
    the node's cell and offer again what it has. Only the best 2 * max_out
    scored candidates reach the prune. Returns (NB, B, max_out) int32."""
    dump = fwd_full.shape[0] - 1
    stride = max(1, fwd_full.shape[1] // expand)
    out = []
    for rows in rows_mat:
        nbrs = fwd_full[rows.long()].long()  # (B, m0)
        picked = torch.where(nbrs >= 0, nbrs, dump)[:, ::stride][:, :expand]
        cand = torch.cat([nbrs, fwd_full[picked].long().reshape(nbrs.shape[0], -1)], dim=1)
        out.append(
            _merge_prune_ids(
                rows, cand, codes, norms2, max_out=max_out, window=2 * max_out, **kw
            ).int()
        )
    return torch.stack(out)


def bucket_knn_all(
    bucket_rows,  # (NB, Mp) member rows per bucket, -1 pad
    bucket_slot,  # (NB, Mp) 0 = primary member, 1 = spill member
    cand,  # (n + 1, 2*kc) int32, updated in place; row n takes the pads' writes
    codes,
    norms2,
    *,
    metric: MetricType,
    kc: int,
):
    """Per-bucket exact kNN: each bucket scores its members against each
    other, one (Mp, Mp) block, and every member's top-kc in-bucket neighbours
    go into its slot's half of its row of the candidate table (slot s holds
    lanes [s*kc, (s+1)*kc), unsorted by contract). The JAX module takes
    `approx_max_k` here; this takes the exact top-kc on every device.

    Whole rows are read, spliced and written back: a row is in a bucket at
    most once (its two nearest centroids differ), so only the dump row can
    repeat among one bucket's destinations, and nothing reads it."""
    n_dump = cand.shape[0] - 1
    for rows_b, slot_b in zip(bucket_rows.long(), bucket_slot):
        valid = rows_b >= 0
        safe = rows_b.clamp_min(0)
        sims = _pairwise_sims(codes[safe][None], norms2[safe][None], metric)[0]
        sims = torch.where(valid[None, :], sims, NEG_INF)
        sims.fill_diagonal_(NEG_INF)
        s, idx = topk_desc(sims, kc)
        ids = torch.where(s > NEG_INF / 2, rows_b[idx], -1).to(cand.dtype)
        dest = torch.where(valid, safe, n_dump)
        cur = cand[dest]
        cand[dest] = torch.where(
            slot_b[:, None] == 0,
            torch.cat([ids, cur[:, kc:]], dim=1),
            torch.cat([cur[:, :kc], ids], dim=1),
        )
    return cand


def _assign_top2_scan(x: torch.Tensor, cents: torch.Tensor, cnorm2: torch.Tensor) -> torch.Tensor:
    """Two nearest centroids of each row of one block, (B, 2) int32. The
    rank-equivalent distance ||c||^2 - 2 x.c drops ||x||^2, constant per row;
    a double argmin (the first index masked out for the second) in place of
    a top-2 sort, ties to the lower index as in the JAX scan."""
    score = cnorm2[None, :] - 2.0 * _exact_dots("nd,kd->nk", x, cents)
    i1 = torch.argmin(score, dim=1)
    s2 = score.scatter(1, i1[:, None], float("inf"))
    i2 = torch.argmin(s2, dim=1)
    return torch.stack([i1, i2], dim=1).to(torch.int32)


def assign_top2_blocked(data: torch.Tensor, cents: torch.Tensor, block: int = 16384) -> torch.Tensor:
    """Two nearest centroids per row, blocked over N so the (N, K) distance
    matrix never materializes; a non-divisible N runs its remainder as one
    smaller block. Rows may be fp32, bf16 or int8 codes (each exact in
    float32, where they are multiplied); the centroids stay fp32.
    Returns (N, 2) int32 on the device of `data`."""
    cents = cents.to(device=data.device, dtype=torch.float32)
    cnorm2 = (cents * cents).sum(-1)
    return torch.cat(
        [
            _assign_top2_scan(data[lo : lo + block], cents, cnorm2)
            for lo in range(0, data.shape[0], block)
        ]
    )
