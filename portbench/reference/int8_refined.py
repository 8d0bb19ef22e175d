"""The plain reference of an int8-resident FLAT index with its float32
refine, under squared L2: the rule `configs/quantized/deep10m_int8_refined.json`
states, in float64, blocked over rows so that it runs at millions of rows.

1. One global affine quantizer fit on every value of the rows: the 0.001 and
   0.999 quantiles (linear interpolation between order statistics, as
   `numpy.quantile` takes them), bias at their centre, scale their range /
   254; codes clip(round((x - bias) / scale), -127, 127), halves to even.
2. The candidates: each query's top C rows by the squared L2 distance
   between the float32 query and the dequantized codes (code * scale +
   bias); the query is never quantized.
3. The answer: the top k of the candidates by the squared L2 distance
   between the query and the float32 rows, each scored with it.

Departures from the reference engine (zvec's integer quantizer and its
`BasicRefiner`):

- zvec fits its int8 range from an entropy histogram of the values; this
  follows the quantile rule the configuration states.
- Every number here is float64. The engine fits its bounds in float64 but
  encodes and scores in float32: a value whose float64 quotient (x - bias) /
  scale lies within float32 rounding of a half step (~1e-5 of the values)
  may take the neighbouring code there, and its distances err by ~1e-7.
  Where candidates differ, the row's codes differ or the distances tie
  within that.
- Rows at one distance are ranked by `torch.topk` and a stable sort here,
  not by the engine's rule (on gaussian rows they do not occur).
- Squared L2 only: the metric the configuration states.

`hold` is the rule an answer is held to this reference by, for those
departures: ids equal but for ties within `TIE` and rows whose codes differ.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

QMAX = 127  # codes in [-127, 127]
REFINE_FACTOR = 10  # candidates a query per answer: the program's default refiner_scale_factor
CLIP = 0.999  # the upper quantile of the range; the lower is 1 - CLIP
BLOCK_ELEMS = 1 << 27  # float64 distances held at once (1 GiB)
TIE = 1e-6  # relative: float32 distances of ~2D err by ~1e-7 of the distance
SPARE = 8  # places to rank past an answer, for rows a differing code moves


class Refined(NamedTuple):
    """`search`'s answer (Q, k + spare) and candidates (Q, factor * k + spare)."""

    dist: torch.Tensor  # float64 distances to the float32 rows, ascending; inf past the rows
    ids: torch.Tensor  # row ids, -1 past the rows
    cand_dist: torch.Tensor  # float64 distances to the dequantized codes, ascending
    cand_ids: torch.Tensor  # the candidates' row ids, -1 past the rows the mask keeps


def quantile(values: torch.Tensor, p: float) -> float:
    """The p-quantile of every value: the order statistics at floor and ceil
    of p * (n - 1), interpolated linearly in float64."""
    v = values.reshape(-1)
    pos = p * (v.numel() - 1)
    lo = math.floor(pos)
    a = float(torch.kthvalue(v, lo + 1).values)
    b = float(torch.kthvalue(v, min(lo + 2, v.numel())).values)
    return a + (pos - lo) * (b - a)


def fit_quantizer(x: torch.Tensor) -> Tuple[float, float]:
    """(scale, bias) of the global affine int8 quantizer of the rows x."""
    lo, hi = quantile(x, 1.0 - CLIP), quantile(x, CLIP)
    if hi <= lo:
        hi = lo + 1e-6
    return (hi - lo) / (2 * QMAX), (hi + lo) / 2.0


def encode(x: torch.Tensor, scale: float, bias: float) -> torch.Tensor:
    """The codes of the rows x, as float64 integers in [-127, 127]."""
    return torch.clamp(torch.round((x.double() - bias) / scale), -QMAX, QMAX)


def candidates(x: torch.Tensor, q: torch.Tensor, c: int, scale: float, bias: float,
               mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's top c rows of x (N, D) by the float64 squared distance of
    the query to the dequantized codes, among the rows where `mask` (N,) is
    True: distances ascending (Q, c) and row ids (Q, c), inf and -1 past the
    rows kept."""
    n, nq = x.shape[0], q.shape[0]
    c = min(c, n)
    qd = q.double()
    qn = (qd * qd).sum(1, keepdim=True)
    best_d = torch.full((nq, c), math.inf, dtype=torch.float64, device=x.device)
    best_i = torch.full((nq, c), -1, dtype=torch.int64, device=x.device)
    block = max(1, BLOCK_ELEMS // max(nq, 1))
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        y = encode(x[lo:hi], scale, bias) * scale + bias
        d = qn + (y * y).sum(1)[None, :] - 2.0 * (qd @ y.T)
        if mask is not None:
            d.masked_fill_(~mask[None, lo:hi], math.inf)
        ids = torch.arange(lo, hi, device=x.device).expand(nq, -1)
        all_d, all_i = torch.cat([best_d, d], 1), torch.cat([best_i, ids], 1)
        best_d, sel = torch.topk(all_d, c, dim=1, largest=False, sorted=True)
        best_i = torch.gather(all_i, 1, sel)
    best_i = torch.where(best_d.isfinite(), best_i, torch.full_like(best_i, -1))
    return best_d, best_i


def code_distances(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor, scale: float, bias: float) -> torch.Tensor:
    """Float64 squared distance of each query (Q, D) to the dequantized codes
    of each of its rows ids (Q, m); NaN where the id is not a row of x."""
    ok = (ids >= 0) & (ids < x.shape[0])
    y = encode(x[torch.where(ok, ids, torch.zeros_like(ids))], scale, bias) * scale + bias
    d = ((y - q.double()[:, None, :]) ** 2).sum(-1)
    return torch.where(ok, d, torch.full_like(d, math.nan))


def refine(x: torch.Tensor, q: torch.Tensor, cand_ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of each query's candidates by the float64 squared distance
    to the float32 rows: distances ascending (Q, k) and row ids (Q, k), inf
    and -1 past the valid candidates."""
    valid = cand_ids >= 0
    rows = x[cand_ids.clamp(min=0)].double()
    d = ((rows - q.double()[:, None, :]) ** 2).sum(-1)
    d = torch.where(valid, d, torch.full_like(d, math.inf))
    d, order = torch.sort(d, dim=1, stable=True)
    ids = torch.gather(cand_ids, 1, order)
    d, ids = d[:, :k], ids[:, :k]
    return d, torch.where(d.isfinite(), ids, torch.full_like(ids, -1))


def search(x: torch.Tensor, q: torch.Tensor, k: int, scale: float, bias: float, factor: int = REFINE_FACTOR,
           mask: Optional[torch.Tensor] = None, spare: int = 0) -> Refined:
    """The answer of the int8 index with its refine for the queries q (Q, D)
    over the float32 rows x (N, D) under the quantizer (scale, bias, as
    `fit_quantizer` gives them): factor * k candidates a query by the
    dequantized codes, re-ranked against the rows. With `spare`, each
    ranking goes on `spare` places past its own length (the answer past k,
    the candidates past factor * k), the refine still over the first factor
    * k candidates."""
    cand_d, cand_i = candidates(x, q, factor * k + spare, scale, bias, mask)
    d, ids = refine(x, q, cand_i[:, : factor * k], k + spare)
    return Refined(d, ids, cand_d, cand_i)


def hold(pks, scores, ref_ids, ref_dist, dist_of, flipped, score_rows=None) -> dict:
    """Hold answers (pks (Q, m) int64, -1 where none; scores (Q, m)) to the
    reference's ranking (ref_ids, ref_dist (Q, >= m), ascending: its answer,
    then the rows after it, `SPARE` of them) under the distance
    `dist_of(ids) -> (Q, m) float64`. Rows whose codes differ from the
    reference's (`flipped(ids)`) may be in or out; the j other rows of an
    answer have to be the first j of the reference's other rows, but for
    ties within TIE of the j-th's distance. Scores are held to `dist_of`
    where `score_rows(ids)` (default: every valid id) is True. Returns the
    rows in one answer and not the other's first m, the rows that break the
    rule, and the widest score gap relative to the distance (floored at 1)."""
    m = pks.shape[1]
    valid, ref_valid = pks >= 0, ref_ids[:, :m] >= 0
    f_got = flipped(pks)
    others = (ref_ids >= 0) & ~flipped(ref_ids)
    rank = others.long().cumsum(1) - 1  # among the reference's other rows
    j = (valid & ~f_got).sum(1, keepdim=True)
    edge = torch.minimum(j - 1, rank.max(1, keepdim=True).values)
    cut = torch.where(others & (rank == edge), ref_dist, torch.full_like(ref_dist, math.inf)).min(1, keepdim=True).values
    first = others & (rank < j)
    d = dist_of(pks)
    in_first = (pks[:, :, None] == torch.where(first, ref_ids, -2)[:, None, :]).any(-1)
    in_got = (ref_ids[:, :, None] == pks[:, None, :]).any(-1)
    unexplained = (valid & ~f_got & ~in_first & ~(d <= cut * (1 + TIE))).sum() + (
        first & ~in_got & ~(ref_dist >= cut * (1 - TIE))).sum()
    differ = (valid & ~(pks[:, :, None] == ref_ids[:, None, :m]).any(-1)).sum() + (ref_valid & ~in_got[:, :m]).sum()
    judged = valid if score_rows is None else valid & score_rows(pks)
    gap = ((scores - d).abs() / d.clamp(min=1.0))[judged]
    return {"differ": int(differ), "unexplained": int(unexplained),
            "score_gap": float(gap.max()) if gap.numel() else 0.0,
            "answers": int(valid.sum()), "missing_answers": int((ref_valid & ~valid).sum())}
