"""Refiner: full-precision re-scoring of quantized candidates.

Reference equivalent: `BasicRefiner` (`src/core/utility/basic_refiner.cc:23`)
+ the refine duality in segments (quantized index block + full-precision flat
block, `segment.cc:1645-1700`). Query param `is_using_refiner` overscans the
quantized index by `refiner_scale_factor` then re-ranks the candidates on
exact fp32 scores.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from ..typing.enum import MetricType

__all__ = ["refine"]


def refine(
    data_fn: Callable[[], np.ndarray],
    queries: np.ndarray,
    cand_idx: np.ndarray,  # (Q, C) candidate local indices, -1 padded
    metric: MetricType,
    topk: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-score candidates at full precision. Returns (sims (Q, topk) desc,
    idx (Q, topk))."""
    data = data_fn()
    nq, c = cand_idx.shape
    safe = np.clip(cand_idx, 0, None)
    cand_vecs = data[safe].astype(np.float32)  # (Q, C, D)
    q = queries.astype(np.float32)
    dots = np.einsum("qd,qcd->qc", q, cand_vecs)
    if metric == MetricType.IP:
        sims = dots
    elif metric == MetricType.L2:
        sims = -(
            (q**2).sum(1)[:, None]
            + (cand_vecs**2).sum(2)
            - 2.0 * dots
        )
    elif metric == MetricType.COSINE:
        qn = np.sqrt((q**2).sum(1))[:, None]
        cn = np.sqrt((cand_vecs**2).sum(2))
        denom = qn * cn
        sims = np.where(denom > 0, dots / np.where(denom > 0, denom, 1.0), 1.0)
    else:
        raise ValueError(f"unsupported metric {metric}")
    sims = np.where(cand_idx >= 0, sims, -np.inf)
    order = np.argsort(-sims, axis=1, kind="stable")[:, :topk]
    out_s = np.take_along_axis(sims, order, 1).astype(np.float32)
    out_i = np.take_along_axis(cand_idx, order, 1)
    out_i = np.where(out_s > -np.inf, out_i, -1)
    if out_s.shape[1] < topk:
        pad = topk - out_s.shape[1]
        out_s = np.pad(out_s, ((0, 0), (0, pad)), constant_values=-np.inf)
        out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
    return out_s, out_i
