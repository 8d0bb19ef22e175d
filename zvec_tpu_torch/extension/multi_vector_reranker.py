"""RRF and weighted rerankers for multi-vector queries.

The contract (reference `python/zvec/extension/multi_vector_reranker.py` and
its test oracle `python/tests/detail/distance_helper.py:158-203`):

  RRF       score(doc) = sum over fields of 1 / (k + rank + 1), k = 60 by
            default, rank counted from 0 in each field's result list.
  Weighted  score(doc) = sum over fields of weight_f * norm(score_f), with
            L2 -> 1 - 2 atan(s) / pi, IP -> 0.5 + atan(s) / pi,
            COSINE -> 1 - s / 2; a field without a weight counts 1.0.

Both give the `topn` best documents, each carrying its fused score. Documents
with equal fused scores keep the order in which they were first seen (fields
in query order, then rank), so the answer does not depend on a heap's
internals.

Written as one rank fusion over numpy arrays: every (field, rank) entry maps
to the slot of its document, the contributions are summed per slot in entry
order (`np.add.at` on float64, the same sums a running Python total gives),
and one stable sort ranks the slots.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np

from ..model.doc import Doc
from ..typing.enum import MetricType
from .rerank_function import RerankFunction

__all__ = ["RrfReRanker", "WeightedReRanker"]


def _fuse(
    query_results: Dict[str, List[Doc]],
    contribution: Callable[[str, int, Doc], float],
    topn: int,
) -> List[Doc]:
    """Sum `contribution(field, rank, doc)` per document id and return the
    `topn` best documents, ties in first-seen order."""
    slot_of_id: Dict[str, int] = {}
    seen: List[Doc] = []  # the first Doc met for each slot
    slots: List[int] = []
    amounts: List[float] = []
    for field, docs in query_results.items():
        for rank, doc in enumerate(docs):
            slot = slot_of_id.setdefault(doc.id, len(seen))
            if slot == len(seen):
                seen.append(doc)
            slots.append(slot)
            amounts.append(contribution(field, rank, doc))
    totals = np.zeros(len(seen), dtype=np.float64)
    np.add.at(totals, np.asarray(slots, dtype=np.int64), np.asarray(amounts, dtype=np.float64))
    best = np.argsort(-totals, kind="stable")[:topn]
    return [seen[i]._replace(score=float(totals[i])) for i in best]


class RrfReRanker(RerankFunction):
    """Reciprocal rank fusion: only the ranks count, never the scores."""

    def __init__(
        self,
        topn: int = 10,
        rerank_field: Optional[str] = None,
        rank_constant: int = 60,
    ):
        super().__init__(topn=topn, rerank_field=rerank_field)
        self._rank_constant = rank_constant

    @property
    def rank_constant(self) -> int:
        return self._rank_constant

    def rerank(self, query_results: Dict[str, List[Doc]]) -> List[Doc]:
        k = self._rank_constant
        return _fuse(query_results, lambda field, rank, doc: 1.0 / (k + rank + 1), self.topn)


class WeightedReRanker(RerankFunction):
    """Weighted sum of the fields' scores, each mapped to [0, 1] by metric."""

    def __init__(
        self,
        topn: int = 10,
        rerank_field: Optional[str] = None,
        metric: MetricType = MetricType.L2,
        weights: Optional[Dict[str, float]] = None,
    ):
        super().__init__(topn=topn, rerank_field=rerank_field)
        self._weights = weights or {}
        self._metric = MetricType(metric)

    @property
    def weights(self) -> Dict[str, float]:
        return self._weights

    @property
    def metric(self) -> MetricType:
        return self._metric

    def rerank(self, query_results: Dict[str, List[Doc]]) -> List[Doc]:
        return _fuse(
            query_results,
            lambda field, rank, doc: self._normalize_score(doc.score, self._metric)
            * self._weights.get(field, 1.0),
            self.topn,
        )

    @staticmethod
    def _normalize_score(score: float, metric: MetricType) -> float:
        if metric == MetricType.L2:
            return 1.0 - 2 * math.atan(score) / math.pi
        if metric == MetricType.IP:
            return 0.5 + math.atan(score) / math.pi
        if metric == MetricType.COSINE:
            return 1.0 - score / 2.0
        raise ValueError("Unsupported metric type")
