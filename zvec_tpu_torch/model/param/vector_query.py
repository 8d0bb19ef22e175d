"""VectorQuery — one per-field vector similarity query.

Parity with reference `python/zvec/model/param/vector_query.py:40-103`:
query by explicit vector OR by document id (vector fetched at execute time);
providing both is an error.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

from ..doc import VectorType
from .param import FlatQueryParam, HnswQueryParam, IVFQueryParam

__all__ = ["VectorQuery", "GroupByVectorQuery"]


@dataclass(frozen=True)
class VectorQuery:
    field_name: str
    id: Optional[str] = None
    vector: VectorType = None
    param: Optional[Union[HnswQueryParam, IVFQueryParam, FlatQueryParam]] = None

    def __post_init__(self) -> None:
        # reference raises at construction (`vector_query.py:99-103`)
        self._validate()

    def has_id(self) -> bool:
        return self.id is not None

    def has_vector(self) -> bool:
        return self.vector is not None and len(self.vector) > 0

    def _validate(self) -> None:
        if self.field_name is None:
            raise ValueError("Field name cannot be empty")
        if self.id and self.vector is not None and len(self.vector) > 0:
            raise ValueError("Cannot provide both id and vector")
        if not self.has_id() and not self.has_vector():
            raise ValueError("VectorQuery requires either id or vector")


@dataclass(frozen=True)
class GroupByVectorQuery(VectorQuery):
    """A VectorQuery carrying group-by parameters (reference typed query
    object `src/include/zvec/db/doc.h:370`): best `group_topk` docs for each
    of the top `group_count` groups keyed by `group_by_field`. Usable
    anywhere a VectorQuery is — including in a multi-vector list with a
    reranker (grouped fused search)."""

    group_by_field: str = ""
    group_count: int = 10
    group_topk: int = 2

    def _validate(self) -> None:
        super()._validate()
        if not self.group_by_field:
            raise ValueError("GroupByVectorQuery requires group_by_field")
        if self.group_count <= 0 or self.group_topk <= 0:
            raise ValueError("group_count and group_topk must be positive")
