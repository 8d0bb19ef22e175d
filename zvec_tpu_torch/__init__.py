"""zvec_tpu_torch — the PyTorch / CUDA port of zvec_tpu.

The same in-process vector database as `zvec_tpu` (schema'd collections,
WAL + versioned manifests + crash recovery, SQL-like filters) with its device
layer in PyTorch and its fused flat-scan kernel hand-written in CUDA for
Hopper (`csrc/flat_scan.cu`). `zvec_tpu` stays the reference: collections
written by either package open in the other.

Dense fields run with FLAT, HNSW or IVF indexes (fp32, fp16, int8, int4 and
binary codes); HNSW is the default index of a vector field, as in the
reference. Its graph is built on the card (an exact kNN graph whose forward
pass runs the CUDA flat scan) and searched with a batched beam. IVF trains
k-means on the card (SOAR-spilled lists optional) and probes its lists in
batches there. Layers of more than 2,000,000 rows take the clustered build
(k-means buckets, per-bucket exact kNN, one NN-descent round).
`Collection.group_by_query` runs on every index; on an HNSW field it harvests
the groups inside the beam.

Sparse fields run with FLAT (the exact scan) or HNSW (a single-level graph
with a probed entry set; from 200,000 rows on its build takes candidates from
k-means buckets of feature-hash signatures). A query over several vector
fields is fused by `RrfReRanker` or `WeightedReRanker`; a dense + sparse pair
is scored in one go per segment.

An HNSW field with `route_quantize="int8"` or `"bf16"` walks its graph on
reduced-precision codes and re-ranks on the fp32 codes. Text reaches a field
through the embedding functions (`BM25EmbeddingFunction`, the OpenAI, Qwen and
local sentence-transformers providers). `zvec_tpu_torch.tools` holds the
command-line build, recall and bench tools; `zvec_tpu_torch.examples` holds
runnable examples.

`init(mesh_devices=N)` shards sealed segments over N corpus shards, placed
round-robin over the cards there are (`parallel/mesh.py`): one process, no
launcher; every engine searches each shard and merges the per-shard top-k.
"""

from . import model as model
from .extension import (
    BM25EmbeddingFunction,
    DefaultLocalDenseEmbedding,
    DefaultLocalReRanker,
    DefaultLocalSparseEmbedding,
    DenseEmbeddingFunction,
    OpenAIDenseEmbedding,
    OpenAIFunctionBase,
    QwenDenseEmbedding,
    QwenFunctionBase,
    QwenReRanker,
    QwenSparseEmbedding,
    ReRanker,
    RrfReRanker,
    SentenceTransformerFunctionBase,
    SparseEmbeddingFunction,
    WeightedReRanker,
)
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
from .model.param.vector_query import GroupByVectorQuery, VectorQuery
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
from .tool import require_module
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
    "GroupByVectorQuery",
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
    # extensions
    "BM25EmbeddingFunction",
    "DenseEmbeddingFunction",
    "SparseEmbeddingFunction",
    "ReRanker",
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
    "require_module",
    # submodules
    "model",
    "param",
    "schema",
]
