"""Device compute layer: PyTorch tensor code and the hand-written CUDA scan.

`distance` and `topk` are the torch forms of the JAX package's XLA programs;
`flat_scan` holds the fused group-max scan kernel (`csrc/flat_scan.cu`) that
replaces the Pallas kernel of `zvec_tpu/ops/flat_pallas.py`.
"""

from .distance import (
    ip_matrix,
    l2_norms,
    similarity_matrix,
    similarity_to_score,
    score_to_similarity,
    squared_l2_matrix,
)
from .topk import blockwise_topk_search, merge_topk

__all__ = [
    "ip_matrix",
    "squared_l2_matrix",
    "l2_norms",
    "similarity_matrix",
    "similarity_to_score",
    "score_to_similarity",
    "blockwise_topk_search",
    "merge_topk",
]
