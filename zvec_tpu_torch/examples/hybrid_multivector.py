"""Dense + sparse multi-vector fusion with BM25.

Text goes through `BM25EmbeddingFunction` into a sparse field, which is fused
with a dense field by `RrfReRanker` in one query.

Run: python -m zvec_tpu_torch.examples.hybrid_multivector
"""

from __future__ import annotations

import shutil
import tempfile
from typing import List, Optional

import numpy as np

import zvec_tpu_torch
from zvec_tpu_torch import (
    BM25EmbeddingFunction,
    CollectionSchema,
    DataType,
    Doc,
    FieldSchema,
    FlatIndexParam,
    MetricType,
    RrfReRanker,
    VectorQuery,
    VectorSchema,
)

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "vector databases index embeddings for similarity search",
    "TPUs accelerate dense matrix multiplication",
    "a fast auburn fox leaped over a sleepy canine",
    "sparse retrieval scores lexical overlap with BM25",
    "approximate nearest neighbor graphs trade recall for speed",
]


def main(path: Optional[str] = None) -> List[str]:
    """Returns the ids of the fused top-3, in order."""
    tmp = tempfile.mkdtemp(prefix="zvec_hybrid_") if path is None else None
    path = path or f"{tmp}/docs"
    rng = np.random.default_rng(0)

    bm25 = BM25EmbeddingFunction().fit(CORPUS)
    sparse_vecs = bm25.embed_documents(CORPUS)
    dense_vecs = rng.standard_normal((len(CORPUS), 32)).astype(np.float32)

    schema = CollectionSchema(
        "docs",
        fields=[FieldSchema("text", DataType.STRING)],
        vectors=[
            VectorSchema("dense", DataType.VECTOR_FP32, 32, FlatIndexParam(MetricType.COSINE)),
            VectorSchema("lexical", DataType.SPARSE_VECTOR_FP32, 0, FlatIndexParam(MetricType.IP)),
        ],
    )
    coll = zvec_tpu_torch.create_and_open(path, schema)
    coll.insert(
        [
            Doc(
                id=str(i),
                vectors={"dense": dense_vecs[i], "lexical": sparse_vecs[i]},
                fields={"text": CORPUS[i]},
            )
            for i in range(len(CORPUS))
        ]
    )

    query_text = "fox jumping over dogs"
    hits = coll.query(
        [
            VectorQuery("dense", vector=dense_vecs[0]),  # e.g. an embedding of the query
            VectorQuery("lexical", vector=bm25.embed_query(query_text)),
        ],
        topk=6,
        reranker=RrfReRanker(topn=3),
    )
    print(f"query: {query_text!r}")
    for h in hits:
        print(f"  {h.id}  rrf={h.score:.4f}  {h.field('text')}")
    coll.destroy()
    if tmp is not None:
        shutil.rmtree(tmp, ignore_errors=True)
    return [h.id for h in hits]


if __name__ == "__main__":
    main()
