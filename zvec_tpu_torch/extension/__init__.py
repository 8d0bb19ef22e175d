"""Extension points ported so far: the reranker base classes.

Embedding functions and the RRF / weighted multi-vector rerankers are not
ported yet.
"""

from .rerank_function import ReRanker, RerankFunction

__all__ = ["ReRanker", "RerankFunction"]
