"""ReRanker base protocol (reference `python/zvec/extension/rerank_function.py`)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from ..model.doc import Doc

__all__ = ["RerankFunction", "ReRanker"]


class RerankFunction(ABC):
    """Base class for re-rankers merging multi-vector query results."""

    def __init__(self, topn: int = 10, rerank_field: Optional[str] = None):
        if topn <= 0:
            raise ValueError(f"topn must be positive, got {topn}")
        self._topn = topn
        self._rerank_field = rerank_field

    @property
    def topn(self) -> int:
        return self._topn

    @property
    def rerank_field(self) -> Optional[str]:
        return self._rerank_field

    @abstractmethod
    def rerank(self, query_results: Dict[str, List[Doc]]) -> List[Doc]:
        """Merge per-field result lists into one ranked list."""


# user-facing alias matching the reference export name
ReRanker = RerankFunction
