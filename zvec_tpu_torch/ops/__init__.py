"""Device compute layer: PyTorch tensor code and the hand-written CUDA scan.

`distance`, `topk`, `hnsw` (the HNSW beam and build steps, the blocked top-2
assignment) and `kmeans` are the torch forms of the JAX package's XLA
programs; `flat_scan` holds the three kernels that replace
`zvec_tpu/ops/flat_pallas.py::flat_scan_topk` (the group-max scan
`csrc/flat_scan.cu`, the merge `csrc/flat_merge.cu` and stage two
`csrc/flat_rescore.cu`).
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
