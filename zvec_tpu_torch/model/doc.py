"""Doc — the user-facing record type.

Parity with reference `python/zvec/model/doc.py:26-173`: id/score/fields/vectors.
Deliberate divergence: dense vectors are kept as ndarray SNAPSHOT COPIES (the
reference normalizes to plain python lists) so the write path never pays a
list->float64->fp32 round trip per doc; `Doc.vector()` on a user-constructed
Doc therefore returns an ndarray, not a list. Sparse vectors normalize to
{int dim -> float} dicts as in the reference.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Union

import numpy as np

__all__ = ["Doc", "VectorType"]

# dense: list/ndarray; sparse: {int dim -> float}
VectorType = Union[list, np.ndarray, Dict[int, float], None]


def _normalize_vector(vec):
    if vec is None:
        return None
    if isinstance(vec, np.ndarray):
        # Keep the ndarray (snapshot copy decouples from caller mutation).
        # The reference Doc flattens to python lists; we keep the array so
        # the write path (validate -> WAL encode -> forward store) never
        # pays a list->array round trip per doc (~20us/doc at 128d).
        return vec.copy()
    if isinstance(vec, dict):
        return {int(k): float(v) for k, v in vec.items()}
    return vec


class Doc:
    """A document: unique string id, optional relevance score, scalar fields,
    and named vectors (dense list or sparse dict)."""

    __slots__ = ("id", "score", "vectors", "fields")

    def __init__(
        self,
        id: str,
        score: Optional[float] = None,
        vectors: Optional[Dict[str, VectorType]] = None,
        fields: Optional[Dict[str, Any]] = None,
    ):
        self.id = id
        self.score = score
        self.vectors = (
            {name: _normalize_vector(v) for name, v in vectors.items()}
            if vectors
            else {}
        )
        self.fields = dict(fields) if fields else {}

    def has_field(self, name: str) -> bool:
        return name in self.fields

    def has_vector(self, name: str) -> bool:
        return name in self.vectors

    def vector(self, name: str):
        return self.vectors.get(name) if self.vectors else None

    def field(self, name: str):
        return self.fields.get(name) if self.fields else None

    def vector_names(self) -> list:
        return list(self.vectors.keys()) if self.vectors else []

    def field_names(self) -> list:
        return list(self.fields.keys()) if self.fields else []

    def __repr__(self) -> str:
        try:
            return json.dumps(
                {
                    "id": self.id,
                    "score": self.score,
                    "fields": _jsonable(self.fields),
                    "vectors": _jsonable(self.vectors),
                },
                indent=2,
                ensure_ascii=False,
            )
        except Exception as e:  # pragma: no cover
            return f"<Doc error during repr: {e}>"

    def _replace(self, **changes) -> "Doc":
        d = Doc.__new__(Doc)
        d.id = changes.get("id", self.id)
        d.score = changes.get("score", self.score)
        d.fields = changes.get("fields", dict(self.fields))
        d.vectors = changes.get("vectors", dict(self.vectors))
        return d


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    return obj
