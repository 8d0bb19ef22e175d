"""Provider-backed embedding functions and rerankers.

Reference equivalents: `python/zvec/extension/{openai,qwen,
sentence_transformer}_embedding_function.py` and the model-based rerankers.
All providers are OPTIONAL: network/model dependencies import lazily via
`require_module`, so the core package stays dependency-free. Protocol parity:
each class implements DenseEmbeddingFunction / SparseEmbeddingFunction /
RerankFunction.

Copied from `zvec_tpu/extension/providers.py` with one difference: the local
sentence-transformers classes default to the port's device
(`ops/runtime.device()`: the card, or the CPU when `ZVEC_TORCH_DEVICE=cpu`
asks for it; with neither, they raise), where the JAX package defaults to
"cpu".
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..ops.runtime import device as default_device
from ..tool.util import require_module
from .embedding_function import DenseEmbeddingFunction, SparseEmbeddingFunction
from .rerank_function import RerankFunction

__all__ = [
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


class OpenAIFunctionBase:
    """Shared OpenAI client plumbing (lazy `openai` import)."""

    def __init__(self, model: str, api_key: Optional[str] = None, base_url: Optional[str] = None):
        openai = require_module("openai", "pip install openai")
        self.model = model
        self._client = openai.OpenAI(api_key=api_key, base_url=base_url)


class OpenAIDenseEmbedding(OpenAIFunctionBase, DenseEmbeddingFunction):
    def __init__(
        self,
        model: str = "text-embedding-3-small",
        dimension: int = 1536,
        api_key: Optional[str] = None,
        base_url: Optional[str] = None,
    ):
        super().__init__(model, api_key, base_url)
        self._dimension = dimension

    @property
    def dimension(self) -> int:
        return self._dimension

    def embed_documents(self, texts: List[str]) -> List[np.ndarray]:
        resp = self._client.embeddings.create(
            model=self.model, input=texts, dimensions=self._dimension
        )
        return [np.asarray(d.embedding, dtype=np.float32) for d in resp.data]

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed_documents([text])[0]


class QwenFunctionBase:
    """DashScope-backed Qwen models (lazy `dashscope` import)."""

    def __init__(self, model: str, api_key: Optional[str] = None):
        self._dashscope = require_module("dashscope", "pip install dashscope")
        if api_key:
            self._dashscope.api_key = api_key
        self.model = model


class QwenDenseEmbedding(QwenFunctionBase, DenseEmbeddingFunction):
    def __init__(
        self,
        model: str = "text-embedding-v3",
        dimension: int = 1024,
        api_key: Optional[str] = None,
    ):
        super().__init__(model, api_key)
        self._dimension = dimension

    @property
    def dimension(self) -> int:
        return self._dimension

    def embed_documents(self, texts: List[str]) -> List[np.ndarray]:
        resp = self._dashscope.TextEmbedding.call(
            model=self.model, input=texts, dimension=self._dimension
        )
        return [
            np.asarray(e["embedding"], dtype=np.float32)
            for e in resp.output["embeddings"]
        ]

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed_documents([text])[0]


class QwenSparseEmbedding(QwenFunctionBase, SparseEmbeddingFunction):
    def __init__(self, model: str = "text-embedding-v3", api_key: Optional[str] = None):
        super().__init__(model, api_key)

    def embed_documents(self, texts: List[str]) -> List[Dict[int, float]]:
        resp = self._dashscope.TextEmbedding.call(
            model=self.model, input=texts, output_type="sparse"
        )
        out = []
        for e in resp.output["embeddings"]:
            sparse = e.get("sparse_embedding", {})
            out.append({int(k): float(v) for k, v in sparse.items()})
        return out

    def embed_query(self, text: str) -> Dict[int, float]:
        return self.embed_documents([text])[0]


class QwenReRanker(QwenFunctionBase, RerankFunction):
    """Model-based cross-encoder reranker via DashScope."""

    def __init__(
        self,
        model: str = "gte-rerank",
        topn: int = 10,
        rerank_field: Optional[str] = None,
        api_key: Optional[str] = None,
        query: Optional[str] = None,
    ):
        QwenFunctionBase.__init__(self, model, api_key)
        RerankFunction.__init__(self, topn=topn, rerank_field=rerank_field)
        self.query = query

    def rerank(self, query_results):
        docs_by_id = {}
        for _, docs in query_results.items():
            for doc in docs:
                docs_by_id.setdefault(doc.id, doc)
        docs = list(docs_by_id.values())
        texts = [str(d.field(self.rerank_field)) for d in docs]
        resp = self._dashscope.TextReRank.call(
            model=self.model,
            query=self.query or "",
            documents=texts,
            top_n=self.topn,
        )
        out = []
        for r in resp.output["results"]:
            doc = docs[r["index"]]
            out.append(doc._replace(score=float(r["relevance_score"])))
        return out


class SentenceTransformerFunctionBase:
    """Local sentence-transformers models (lazy import)."""

    def __init__(self, model: str, device: Optional[str] = None):
        st = require_module(
            "sentence_transformers", "pip install sentence-transformers"
        )
        self._model = st.SentenceTransformer(model, device=device or str(default_device()))


class DefaultLocalDenseEmbedding(SentenceTransformerFunctionBase, DenseEmbeddingFunction):
    def __init__(self, model: str = "all-MiniLM-L6-v2", device: Optional[str] = None):
        super().__init__(model, device)

    @property
    def dimension(self) -> int:
        return int(self._model.get_sentence_embedding_dimension())

    def embed_documents(self, texts: List[str]) -> List[np.ndarray]:
        vecs = self._model.encode(texts, convert_to_numpy=True)
        return [v.astype(np.float32) for v in vecs]

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed_documents([text])[0]


class DefaultLocalSparseEmbedding(SparseEmbeddingFunction):
    """Local sparse embedding: BM25 over a fitted corpus (no network)."""

    def __init__(self, corpus: Optional[List[str]] = None, **bm25_kwargs):
        from .bm25_embedding_function import BM25EmbeddingFunction

        self._bm25 = BM25EmbeddingFunction(**bm25_kwargs)
        if corpus:
            self._bm25.fit(corpus)

    def fit(self, corpus: List[str]):
        self._bm25.fit(corpus)
        return self

    def embed_documents(self, texts: List[str]) -> List[Dict[int, float]]:
        return self._bm25.embed_documents(texts)

    def embed_query(self, text: str) -> Dict[int, float]:
        return self._bm25.embed_query(text)


class DefaultLocalReRanker(SentenceTransformerFunctionBase, RerankFunction):
    """Local cross-encoder reranker (sentence-transformers CrossEncoder)."""

    def __init__(
        self,
        model: str = "cross-encoder/ms-marco-MiniLM-L-6-v2",
        topn: int = 10,
        rerank_field: Optional[str] = None,
        query: Optional[str] = None,
        device: Optional[str] = None,
    ):
        st = require_module(
            "sentence_transformers", "pip install sentence-transformers"
        )
        RerankFunction.__init__(self, topn=topn, rerank_field=rerank_field)
        self._model = st.CrossEncoder(model, device=device or str(default_device()))
        self.query = query

    def rerank(self, query_results):
        docs_by_id = {}
        for _, docs in query_results.items():
            for doc in docs:
                docs_by_id.setdefault(doc.id, doc)
        docs = list(docs_by_id.values())
        pairs = [
            (self.query or "", str(d.field(self.rerank_field))) for d in docs
        ]
        scores = self._model.predict(pairs)
        order = np.argsort(-np.asarray(scores))[: self.topn]
        return [docs[i]._replace(score=float(scores[i])) for i in order]
