"""Embedding function protocols (copied from `zvec_tpu/extension/
embedding_function.py`).

Reference: `python/zvec/extension/embedding_function.py:23,88` — abstract
protocols for dense and sparse text embedders. The local BM25 sparse embedder
(`bm25_embedding_function.py`) and the provider shims (`providers.py`) implement
them; all of it is host code.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Union

import numpy as np

__all__ = ["DenseEmbeddingFunction", "SparseEmbeddingFunction"]


class DenseEmbeddingFunction(ABC):
    """Text -> dense vector embedder protocol."""

    @property
    @abstractmethod
    def dimension(self) -> int:
        ...

    @abstractmethod
    def embed_documents(self, texts: List[str]) -> List[np.ndarray]:
        ...

    @abstractmethod
    def embed_query(self, text: str) -> np.ndarray:
        ...

    def __call__(self, texts: Union[str, List[str]]):
        if isinstance(texts, str):
            return self.embed_query(texts)
        return self.embed_documents(texts)


class SparseEmbeddingFunction(ABC):
    """Text -> sparse vector ({dim: weight}) embedder protocol."""

    @abstractmethod
    def embed_documents(self, texts: List[str]) -> List[Dict[int, float]]:
        ...

    @abstractmethod
    def embed_query(self, text: str) -> Dict[int, float]:
        ...

    def __call__(self, texts: Union[str, List[str]]):
        if isinstance(texts, str):
            return self.embed_query(texts)
        return self.embed_documents(texts)
