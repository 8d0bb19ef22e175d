"""Collection schema: scalar FieldSchema + VectorSchema + CollectionSchema.

Parity with reference `python/zvec/model/schema/field_schema.py` and
`collection_schema.py`: scalar and vector fields are declared separately, names
must be unique across both; vector fields default to `FlatIndexParam()`
(`field_schema.py:231-233` — the code default, despite the docstring).
`CollectionStats` mirrors `src/include/zvec/db/stats.h:25-32`.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Union

from ..typing.enum import DataType
from .param.param import (
    FlatIndexParam,
    HnswIndexParam,
    IndexParam,
    InvertIndexParam,
    IVFIndexParam,
    VectorIndexParam,
)

__all__ = [
    "FieldSchema",
    "VectorSchema",
    "CollectionSchema",
    "CollectionStats",
    "SUPPORT_VECTOR_DATA_TYPE",
    "SUPPORT_SCALAR_DATA_TYPE",
]

SUPPORT_VECTOR_DATA_TYPE = [
    DataType.VECTOR_BINARY32,
    DataType.VECTOR_BINARY64,
    DataType.VECTOR_FP16,
    DataType.VECTOR_FP32,
    DataType.VECTOR_FP64,
    DataType.VECTOR_INT8,
    DataType.VECTOR_INT16,
    DataType.VECTOR_INT4,
    DataType.SPARSE_VECTOR_FP16,
    DataType.SPARSE_VECTOR_FP32,
]

SUPPORT_SCALAR_DATA_TYPE = [
    DataType.INT32,
    DataType.INT64,
    DataType.UINT32,
    DataType.UINT64,
    DataType.FLOAT,
    DataType.DOUBLE,
    DataType.STRING,
    DataType.BOOL,
    DataType.ARRAY_INT32,
    DataType.ARRAY_INT64,
    DataType.ARRAY_UINT32,
    DataType.ARRAY_UINT64,
    DataType.ARRAY_FLOAT,
    DataType.ARRAY_DOUBLE,
    DataType.ARRAY_STRING,
    DataType.ARRAY_BOOL,
]


class FieldSchema:
    """A scalar (non-vector) field: name, data type, nullability, optional
    inverted-index configuration."""

    __slots__ = ("_name", "_data_type", "_nullable", "_index_param")

    def __init__(
        self,
        name: str,
        data_type: DataType,
        nullable: bool = False,
        index_param: Optional[InvertIndexParam] = None,
    ):
        if name is None or not isinstance(name, str):
            raise ValueError(
                f"schema validate failed: field name must be str, got {type(name).__name__}"
            )
        if data_type not in SUPPORT_SCALAR_DATA_TYPE:
            raise ValueError(
                f"schema validate failed: scalar_field's data_type must be one of "
                f"{', '.join(str(dt) for dt in SUPPORT_SCALAR_DATA_TYPE)}, "
                f"but field[{name}]'s data_type is {data_type}"
            )
        if index_param is not None and not isinstance(index_param, InvertIndexParam):
            raise ValueError(
                f"schema validate failed: scalar field [{name}] only supports "
                f"InvertIndexParam, got {type(index_param).__name__}"
            )
        self._name = name
        self._data_type = DataType(data_type)
        self._nullable = bool(nullable)
        self._index_param = index_param

    @property
    def name(self) -> str:
        return self._name

    @property
    def data_type(self) -> DataType:
        return self._data_type

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def index_param(self) -> Optional[InvertIndexParam]:
        return self._index_param

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "data_type": self.data_type.name,
            "nullable": self.nullable,
            "index_param": (
                self.index_param.to_dict() if self.index_param is not None else None
            ),
        }

    def __repr__(self) -> str:
        return json.dumps(self.to_dict(), indent=2, ensure_ascii=False)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, FieldSchema)
            and self.name == other.name
            and self.data_type == other.data_type
            and self.nullable == other.nullable
            and self.index_param == other.index_param
        )

    def __hash__(self) -> int:
        return hash((self.name, self.data_type, self.nullable))


class VectorSchema:
    """A vector field: name, vector data type, dimensionality, index config.

    `dimension` must be > 0 for dense vectors; sparse vectors may use 0.
    """

    __slots__ = ("_name", "_data_type", "_dimension", "_index_param")

    def __init__(
        self,
        name: str,
        data_type: DataType,
        dimension: Optional[int] = 0,
        index_param: Optional[VectorIndexParam] = None,
    ):
        if name is None or not isinstance(name, str):
            raise ValueError(
                f"schema validate failed: field name must be str, got {type(name).__name__}"
            )
        if dimension is None:
            dimension = 0
        if not isinstance(dimension, int) or dimension < 0:
            raise ValueError("schema validate failed: vector's dimension must be >= 0")
        if data_type not in SUPPORT_VECTOR_DATA_TYPE:
            raise ValueError(
                f"schema validate failed: vector's data_type must be one of "
                f"{', '.join(str(dt) for dt in SUPPORT_VECTOR_DATA_TYPE)}, "
                f"but field[{name}]'s data_type is {data_type}"
            )
        if DataType(data_type).is_dense_vector and dimension <= 0:
            raise ValueError(
                f"schema validate failed: dense vector [{name}] requires dimension > 0"
            )
        if index_param is None:
            # reference parity: vector fields are HNSW-indexed by default
            # (`python/zvec/model/schema/field_schema.py:191-193`)
            index_param = HnswIndexParam()
        if not isinstance(index_param, (HnswIndexParam, FlatIndexParam, IVFIndexParam)):
            raise ValueError(
                f"schema validate failed: vector field [{name}] requires a vector "
                f"index param, got {type(index_param).__name__}"
            )
        dt = DataType(data_type)
        if dt in (DataType.VECTOR_BINARY32, DataType.VECTOR_BINARY64):
            # binary vectors score hamming, full stop (the reference reaches
            # its hamming metric only via binary data, `hamming_metric.cc`)
            from ..typing.enum import IndexType, MetricType, QuantizeType

            if index_param.index_type == IndexType.IVF:
                raise ValueError(
                    f"schema validate failed: binary vector [{name}] supports "
                    "FLAT/HNSW indexes (k-means centroids are not binary)"
                )
            if index_param.metric_type in (MetricType.UNDEFINED, MetricType.IP):
                index_param.metric_type = MetricType.HAMMING  # default coercion
            if index_param.metric_type != MetricType.HAMMING:
                raise ValueError(
                    f"schema validate failed: binary vector [{name}] requires "
                    f"MetricType.HAMMING, got {index_param.metric_type!r}"
                )
            if index_param.quantize_type not in (None, QuantizeType.UNDEFINED, 0):
                raise ValueError(
                    f"schema validate failed: binary vector [{name}] cannot be "
                    "re-quantized"
                )
        self._name = name
        self._data_type = dt
        self._dimension = dimension
        self._index_param = index_param

    @property
    def name(self) -> str:
        return self._name

    @property
    def data_type(self) -> DataType:
        return self._data_type

    @property
    def dimension(self) -> int:
        return self._dimension

    @property
    def index_param(self) -> VectorIndexParam:
        return self._index_param

    @property
    def is_sparse(self) -> bool:
        return self._data_type.is_sparse_vector

    def _with_index_param(self, index_param: VectorIndexParam) -> "VectorSchema":
        return VectorSchema(self._name, self._data_type, self._dimension, index_param)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "data_type": self.data_type.name,
            "dimension": self.dimension,
            "index_param": (
                self.index_param.to_dict() if self.index_param is not None else None
            ),
        }

    def __repr__(self) -> str:
        return json.dumps(self.to_dict(), indent=2, ensure_ascii=False)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, VectorSchema)
            and self.name == other.name
            and self.data_type == other.data_type
            and self.dimension == other.dimension
            and self.index_param == other.index_param
        )

    def __hash__(self) -> int:
        return hash((self.name, self.data_type, self.dimension))


class CollectionSchema:
    """A collection's structure: name + scalar fields + vector fields.

    Field names must be unique across scalars and vectors.
    """

    def __init__(
        self,
        name: str,
        fields: Optional[Union[FieldSchema, List[FieldSchema]]] = None,
        vectors: Optional[Union[VectorSchema, List[VectorSchema]]] = None,
        max_doc_count_per_segment: int = 10_000_000,
    ):
        if name is None or not isinstance(name, str):
            raise ValueError(
                f"schema validate failed: collection name must be str, got {type(name).__name__}"
            )
        if not name:
            # reference `schema.cc:231-232`
            raise ValueError("schema validate failed: name is empty")
        self._name = name
        self._fields: List[FieldSchema] = []
        self._vectors: List[VectorSchema] = []
        self.max_doc_count_per_segment = int(max_doc_count_per_segment)

        seen: set = set()
        for idx, f in enumerate(_as_list(fields, "fields")):
            if not isinstance(f, FieldSchema):
                raise TypeError(
                    f"schema validate failed: invalid field type in 'fields' list, "
                    f"expected FieldSchema, got {type(f).__name__} at index {idx}"
                )
            if f.name in seen:
                raise ValueError(
                    f"schema validate failed: duplicate field name '{f.name}': "
                    "field names must be unique"
                )
            seen.add(f.name)
            self._fields.append(f)
        for idx, v in enumerate(_as_list(vectors, "vectors")):
            if not isinstance(v, VectorSchema):
                raise TypeError(
                    f"schema validate failed: invalid field type in 'vectors' list, "
                    f"expected VectorSchema, got {type(v).__name__} at index {idx}"
                )
            if v.name in seen:
                raise ValueError(
                    f"schema validate failed: duplicate field name '{v.name}': "
                    "field names must be unique"
                )
            seen.add(v.name)
            self._vectors.append(v)

    # create-time validation rules (reference `constants.h:43-47` regexes +
    # size caps, enforced by C++ create — the python CollectionSchema object
    # itself stays permissive, matching the reference's layering)
    _NAME_RE = re.compile(r"^[a-zA-Z0-9_-]{3,64}$")
    _FIELD_RE = re.compile(r"^[a-zA-Z0-9_-]{1,32}$")
    MAX_DENSE_DIM = 20000  # kMaxDenseDimSize
    MAX_FIELDS = 1024  # kMaxScalarFieldSize
    MAX_VECTORS = 5  # kMaxVectorFieldSize

    def validate_for_create(self) -> None:
        """Strict schema validation applied by `create_and_open` (reference
        `schema.cc` validate + `constants.h:43-47`). Divergence from the
        reference: zero-vector (scalar-only) collections are ALLOWED here —
        a deliberate superset (NoVectorQueryExecutor serves them)."""
        if not self._NAME_RE.match(self._name):
            raise ValueError(
                f"schema validate failed: collection name '{self._name}' must "
                "match [a-zA-Z0-9_-]{3,64}"
            )
        if len(self._fields) > self.MAX_FIELDS:
            raise ValueError(
                f"schema validate failed: at most {self.MAX_FIELDS} scalar "
                f"fields, got {len(self._fields)}"
            )
        if len(self._vectors) > self.MAX_VECTORS:
            raise ValueError(
                f"schema validate failed: at most {self.MAX_VECTORS} vector "
                f"fields, got {len(self._vectors)}"
            )
        for f in self._fields:
            if not self._FIELD_RE.match(f.name):
                raise ValueError(
                    f"schema validate failed: field name '{f.name}' must "
                    "match [a-zA-Z0-9_-]{1,32}"
                )
        for v in self._vectors:
            if not self._FIELD_RE.match(v.name):
                raise ValueError(
                    f"schema validate failed: vector name '{v.name}' must "
                    "match [a-zA-Z0-9_-]{1,32}"
                )
            if not v.is_sparse and v.dimension > self.MAX_DENSE_DIM:
                raise ValueError(
                    f"schema validate failed: dense vector [{v.name}] "
                    f"dimension {v.dimension} exceeds {self.MAX_DENSE_DIM}"
                )

    @property
    def name(self) -> str:
        return self._name

    @property
    def fields(self) -> List[FieldSchema]:
        return list(self._fields)

    @property
    def vectors(self) -> List[VectorSchema]:
        return list(self._vectors)

    def field(self, name: str) -> Optional[FieldSchema]:
        for f in self._fields:
            if f.name == name:
                return f
        return None

    def vector(self, name: str) -> Optional[VectorSchema]:
        for v in self._vectors:
            if v.name == name:
                return v
        return None

    def field_names(self) -> List[str]:
        return [f.name for f in self._fields]

    def vector_names(self) -> List[str]:
        return [v.name for v in self._vectors]

    # ---- internal mutation used by DDL (add/drop/alter column, create/drop index)
    def _add_field(self, f: FieldSchema) -> None:
        if self.field(f.name) or self.vector(f.name):
            raise ValueError(f"duplicate field name '{f.name}'")
        # column DDL enters here post-create: enforce the same name rule
        # as create time (reference add_column name matrix,
        # `test_collection_ddl.py:1256-1273`)
        if not self._FIELD_RE.match(f.name):
            raise ValueError(
                f"schema validate failed: field name [{f.name}] must "
                "match [a-zA-Z0-9_-]{1,32}"
            )
        self._fields.append(f)

    def _drop_field(self, name: str) -> None:
        self._fields = [f for f in self._fields if f.name != name]

    def _replace_field(self, old_name: str, f: FieldSchema) -> None:
        self._fields = [f if x.name == old_name else x for x in self._fields]

    def _replace_vector(self, name: str, v: VectorSchema) -> None:
        self._vectors = [v if x.name == name else x for x in self._vectors]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "max_doc_count_per_segment": self.max_doc_count_per_segment,
            "fields": [f.to_dict() for f in self._fields],
            "vectors": [v.to_dict() for v in self._vectors],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CollectionSchema":
        fields = [
            FieldSchema(
                f["name"],
                DataType[f["data_type"]],
                f.get("nullable", False),
                _index_param_from_dict(f.get("index_param")),
            )
            for f in d.get("fields", [])
        ]
        vectors = [
            VectorSchema(
                v["name"],
                DataType[v["data_type"]],
                v.get("dimension", 0),
                _index_param_from_dict(v.get("index_param")),
            )
            for v in d.get("vectors", [])
        ]
        return cls(
            d["name"],
            fields,
            vectors,
            d.get("max_doc_count_per_segment", 10_000_000),
        )

    def __repr__(self) -> str:
        return json.dumps(self.to_dict(), indent=2, ensure_ascii=False)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, CollectionSchema)
            and self.name == other.name
            and self._fields == other._fields
            and self._vectors == other._vectors
        )


class CollectionStats:
    """Runtime stats: total doc count + per-indexed-column completeness
    (reference `src/include/zvec/db/stats.h:25-32`), plus per-field engine
    lifetime stats rolled up across segments (reference per-runner `Stats`,
    `index_runner.h:52-140`: build/search counts and timings)."""

    def __init__(
        self,
        doc_count: int = 0,
        index_completeness: Optional[Dict[str, float]] = None,
        index_stats: Optional[Dict[str, Dict[str, Any]]] = None,
    ):
        self.doc_count = doc_count
        self.index_completeness = index_completeness or {}
        self.index_stats = index_stats or {}

    def __repr__(self) -> str:
        return json.dumps(
            {
                "doc_count": self.doc_count,
                "index_completeness": self.index_completeness,
                "index_stats": self.index_stats,
            },
            indent=2,
        )


def _as_list(value, what):
    if value is None:
        return []
    if isinstance(value, (FieldSchema, VectorSchema)):
        return [value]
    if isinstance(value, list):
        return value
    raise TypeError(
        f"schema validate failed: invalid '{what}' type, got {type(value).__name__}"
    )


def _index_param_from_dict(d: Optional[Dict[str, Any]]) -> Optional[IndexParam]:
    if d is None:
        return None
    from ..typing.enum import IndexType, MetricType, QuantizeType

    t = IndexType[d["index_type"]]
    if t == IndexType.INVERT:
        return InvertIndexParam(
            d.get("enable_range_optimization", False),
            d.get("enable_extended_wildcard", False),
        )
    metric = MetricType[d["metric_type"]] if isinstance(d.get("metric_type"), str) else MetricType(d.get("metric_type", MetricType.IP))
    quant = QuantizeType[d["quantize_type"]] if isinstance(d.get("quantize_type"), str) else QuantizeType(d.get("quantize_type", QuantizeType.UNDEFINED))
    if t == IndexType.HNSW:
        return HnswIndexParam(
            metric,
            d.get("m", 50),
            d.get("ef_construction", 500),
            quant,
            knn_k=d.get("knn_k"),
            prune_alpha=d.get("prune_alpha", 1.0),
            backfill_alpha=d.get("backfill_alpha", 0.0),
            clustered_build=d.get("clustered_build"),
            brute_force_threshold=d.get("brute_force_threshold", 1000),
            max_scan_ratio=d.get("max_scan_ratio", 0.0),
            route_quantize=d.get("route_quantize", "auto"),
        )
    if t == IndexType.IVF:
        return IVFIndexParam(
            metric,
            d.get("n_list", 0),
            d.get("n_iters", 10),
            d.get("use_soar", False),
            quant,
        )
    if t == IndexType.FLAT:
        return FlatIndexParam(metric, quant)
    raise ValueError(f"unknown index type {t}")
