"""Quickstart: create a collection, insert docs, hybrid search.

Run: python -m zvec_tpu_torch.examples.quickstart
"""

from __future__ import annotations

import shutil
import tempfile
from typing import List, Optional

import numpy as np

import zvec_tpu_torch
from zvec_tpu_torch import (
    CollectionSchema,
    DataType,
    Doc,
    FieldSchema,
    HnswIndexParam,
    HnswQueryParam,
    InvertIndexParam,
    MetricType,
    QuantizeType,
    VectorQuery,
    VectorSchema,
)


def main(path: Optional[str] = None) -> List[str]:
    """Returns the ids of the filtered top-5, in order."""
    tmp = tempfile.mkdtemp(prefix="zvec_quickstart_") if path is None else None
    path = path or f"{tmp}/products"
    zvec_tpu_torch.init()

    schema = CollectionSchema(
        "products",
        fields=[
            FieldSchema("title", DataType.STRING),
            FieldSchema(
                "price",
                DataType.DOUBLE,
                index_param=InvertIndexParam(enable_range_optimization=True),
            ),
            FieldSchema("tags", DataType.ARRAY_STRING, nullable=True),
        ],
        vectors=[
            VectorSchema(
                "emb",
                DataType.VECTOR_FP32,
                64,
                HnswIndexParam(
                    MetricType.COSINE, m=16, quantize_type=QuantizeType.INT8
                ),
            )
        ],
    )
    coll = zvec_tpu_torch.create_and_open(path, schema)

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((1000, 64)).astype(np.float32)
    coll.insert(
        [
            Doc(
                id=f"p{i}",
                vectors={"emb": vecs[i]},
                fields={
                    "title": f"product {i}",
                    "price": float(i % 200),
                    "tags": ["sale"] if i % 10 == 0 else ["regular"],
                },
            )
            for i in range(1000)
        ]
    )
    print("inserted:", coll.stats.doc_count, "docs")

    hits = coll.query(
        VectorQuery("emb", vector=vecs[42], param=HnswQueryParam(ef=200)),
        topk=5,
        filter="price < 100 AND tags CONTAIN_ANY ('sale')",
        output_fields=["title", "price"],
    )
    for h in hits:
        print(f"  {h.id}  score={h.score:.4f}  {h.fields}")

    coll.flush()
    coll.destroy()
    if tmp is not None:
        shutil.rmtree(tmp, ignore_errors=True)
    return [h.id for h in hits]


if __name__ == "__main__":
    main()
