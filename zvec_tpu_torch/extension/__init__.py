"""Extension points: embedding functions (BM25, the local and hosted
providers), the reranker base classes and the RRF / weighted multi-vector
rerankers."""

from .bm25_embedding_function import BM25EmbeddingFunction
from .embedding_function import (
    DenseEmbeddingFunction,
    SparseEmbeddingFunction,
)
from .multi_vector_reranker import RrfReRanker, WeightedReRanker
from .providers import (
    DefaultLocalDenseEmbedding,
    DefaultLocalReRanker,
    DefaultLocalSparseEmbedding,
    OpenAIDenseEmbedding,
    OpenAIFunctionBase,
    QwenDenseEmbedding,
    QwenFunctionBase,
    QwenReRanker,
    QwenSparseEmbedding,
    SentenceTransformerFunctionBase,
)
from .rerank_function import ReRanker, RerankFunction

__all__ = [
    "BM25EmbeddingFunction",
    "DenseEmbeddingFunction",
    "SparseEmbeddingFunction",
    "ReRanker",
    "RerankFunction",
    "RrfReRanker",
    "WeightedReRanker",
    "OpenAIFunctionBase",
    "OpenAIDenseEmbedding",
    "QwenFunctionBase",
    "QwenDenseEmbedding",
    "QwenSparseEmbedding",
    "QwenReRanker",
    "SentenceTransformerFunctionBase",
    "DefaultLocalDenseEmbedding",
    "DefaultLocalSparseEmbedding",
    "DefaultLocalReRanker",
]
