"""The comparison that decides `correct`.

Every answer of every timed call (the window's, and with `--trace 1` the
traced calls') is held to the plain reference (`reference/exact.py`) on the
arrays the generators made. Two numbers are compared, each against the limit
its cell's `limits/<cell>.json` gives (`rank_gap` only where the cell's
answers are exact):

- `score_gap`: the widest gap between a returned score and the float64
  squared distance of the query to the row the returned pk names, as a share
  of that distance (floored at 1). A missing answer (fewer than the k the
  rows allow), a pk that names no row, a pk twice in one answer, or a row the
  call's filter does not keep reads 1.0. It covers the pk mapping of the host
  API, the scores of the engine and the kernels.
- `rank_gap`: the widest gap, position by position, between the float64
  distances of the returned rows (sorted) and the reference's exact top-k, as
  a share of the reference's (floored at 1); a bad answer reads 1.0. Zero
  where the answer is the exact top-k; ties within rounding read ~1e-7.

Recall@k against the reference's top-k is measured beside them, for the
end-to-end metric `recall_at_10`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .reference.exact import exact_topk, row_distances
from .reference.filter import row_mask

BAD = 1.0  # the gap a missing or wrong answer reads


class Checker:
    def __init__(self, x: torch.Tensor, queries: torch.Tensor, fields: Dict[str, np.ndarray], k: int):
        self.x, self.queries, self.fields, self.k = x, queries, fields, k
        self._ref: Dict[int, tuple] = {}
        self.score_gap = 0.0
        self.rank_gap = 0.0
        self.hits = 0.0
        self.recall_queries = 0
        self.answers = 0
        self.missing = self.unknown = self.duplicate = self.outside_filter = 0

    def reference(self, call):
        """The exact top-k of the call's queries under its filter: float64
        distances, row ids, and the filter's row mask (None for none)."""
        if call.combo not in self._ref:
            mask = None
            if call.clauses:
                keep = row_mask(call.clauses, self.fields, self.x.shape[0])
                mask = torch.from_numpy(keep).to(self.x.device)
            d, i = exact_topk(self.x, self.queries[call.lo : call.hi], self.k, mask)
            self._ref[call.combo] = (d, i, mask)
        return self._ref[call.combo]

    def add(self, call, pks: np.ndarray, scores: np.ndarray, window: bool) -> None:
        """Hold one call's answers (pks (Q, k), scores (Q, k)) to the
        reference; `window` calls count towards recall."""
        dev = self.x.device
        ref_d, ref_i, mask = self.reference(call)
        p = torch.from_numpy(pks).to(dev)
        s = torch.from_numpy(scores).to(dev)
        n, k = self.x.shape[0], self.k
        q = self.queries[call.lo : call.hi]

        expected = (ref_i >= 0).sum(1, keepdim=True)
        due = torch.arange(k, device=dev)[None, :] < expected
        in_range = (p >= 0) & (p < n)
        missing = (p == -1) & due
        unknown = ~in_range & (p != -1)
        earlier = torch.tril(torch.ones(k, k, dtype=torch.bool, device=dev), diagonal=-1)
        duplicate = ((p[:, :, None] == p[:, None, :]) & earlier[None]).any(-1) & in_range
        outside = torch.zeros_like(in_range)
        if mask is not None:
            outside = in_range & ~mask[p.clamp(0, n - 1)]
        bad = missing | unknown | duplicate | outside | (in_range & s.isnan())

        d = row_distances(self.x, q, p)
        gap = (s - d).abs() / d.clamp(min=1.0)
        gap = torch.where(bad, torch.full_like(gap, BAD), torch.where(in_range, gap, torch.zeros_like(gap)))
        self.score_gap = max(self.score_gap, float(gap.max()))

        got = torch.where(bad | ~in_range, torch.full_like(d, float("inf")), d).sort(1).values
        ref = torch.where(ref_i >= 0, ref_d, torch.full_like(ref_d, float("inf")))
        rgap = (got - ref) / ref.clamp(min=1.0)
        rgap = torch.where(got.isinf() & ref.isfinite(), torch.full_like(rgap, BAD), rgap)
        rgap = torch.where(ref.isinf(), torch.zeros_like(rgap), rgap)
        self.rank_gap = max(self.rank_gap, float(rgap.max()))

        if window:
            hit = ((p[:, :, None] == ref_i[:, None, :]) & (ref_i[:, None, :] >= 0)).any(-1) & ~bad
            self.hits += float((hit.sum(1) / expected[:, 0].clamp(min=1)).sum())
            self.recall_queries += p.shape[0]
        self.answers += int(in_range.sum())
        self.missing += int(missing.sum())
        self.unknown += int(unknown.sum())
        self.duplicate += int(duplicate.sum())
        self.outside_filter += int(outside.sum())

    def recall(self) -> Optional[float]:
        return self.hits / self.recall_queries if self.recall_queries else None

    def numbers(self) -> Dict[str, float]:
        return {"score_gap": self.score_gap, "rank_gap": self.rank_gap}

    def counts(self) -> Dict[str, int]:
        return {"answers": self.answers, "missing": self.missing, "unknown_pk": self.unknown,
                "duplicate_pk": self.duplicate, "outside_filter": self.outside_filter}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """[(name, value, limit, within)] for each number the limits name."""
    return [(name, numbers[name], limit, numbers[name] <= limit) for name, limit in limits.items()]
