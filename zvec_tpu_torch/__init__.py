"""zvec_tpu_torch — the PyTorch / CUDA port of zvec_tpu.

The same in-process vector database as `zvec_tpu` (schema'd collections,
WAL + versioned manifests + crash recovery, SQL-like filters) with its device
layer in PyTorch and its fused flat-scan kernel hand-written in CUDA for
Hopper (`csrc/flat_scan.cu`). `zvec_tpu` stays the reference: collections
written by either package open in the other.

This slice supports dense FLAT fields (fp32, fp16, int8, int4 and binary
codes). Collections with HNSW or IVF indexes or sparse fields, multi-vector
queries and multi-GPU sharding raise `NotImplementedError` until they are
ported; embedding functions and rerankers are not exported yet.
"""

from . import model as model
from .model import param as param
from .model.collection import Collection
from .model.doc import Doc
from .model.param import (
    AddColumnOption,
    AlterColumnOption,
    CollectionOption,
    FlatIndexParam,
    HnswIndexParam,
    HnswQueryParam,
    IndexOption,
    InvertIndexParam,
    IVFIndexParam,
    IVFQueryParam,
    OptimizeOption,
)
from .model.param.vector_query import VectorQuery
from .model.schema import CollectionSchema, CollectionStats, FieldSchema, VectorSchema
from .typing import (
    DataType,
    IndexType,
    MetricType,
    QuantizeType,
    Status,
    StatusCode,
    ZvecError,
)
from .typing.enum import LogLevel, LogType
from .zvec import create_and_open, init, open

# submodule alias matching the reference's `zvec.schema`
from .model import schema as schema  # noqa: E402  (import order is deliberate)

__version__ = "0.1.0"

__all__ = [
    # lifecycle
    "create_and_open",
    "init",
    "open",
    # core classes
    "Collection",
    "Doc",
    # schema
    "CollectionSchema",
    "FieldSchema",
    "VectorSchema",
    "CollectionStats",
    # parameters
    "VectorQuery",
    "InvertIndexParam",
    "HnswIndexParam",
    "FlatIndexParam",
    "IVFIndexParam",
    "CollectionOption",
    "IndexOption",
    "OptimizeOption",
    "AddColumnOption",
    "AlterColumnOption",
    "HnswQueryParam",
    "IVFQueryParam",
    # typing
    "DataType",
    "IndexType",
    "MetricType",
    "QuantizeType",
    "Status",
    "StatusCode",
    "ZvecError",
    "LogLevel",
    "LogType",
    # submodules
    "model",
    "param",
    "schema",
]
