"""Extension points ported so far: the reranker base classes and the RRF /
weighted multi-vector rerankers.

Embedding functions (BM25, the local and hosted providers) are not ported.
"""

from .multi_vector_reranker import RrfReRanker, WeightedReRanker
from .rerank_function import ReRanker, RerankFunction

__all__ = ["ReRanker", "RerankFunction", "RrfReRanker", "WeightedReRanker"]
