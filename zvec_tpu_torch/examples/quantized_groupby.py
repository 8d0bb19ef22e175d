"""INT8-quantized cosine search, refined re-ranking, and group-by.

Mirrors the reference's Cohere-style workload shape (cosine metric +
Int8 converter, `tools/core/README.md:95-131`) plus the C++-only
GroupByQuery surface (`python_collection.cc:203`).

Run: python -m zvec_tpu_torch.examples.quantized_groupby
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np

import zvec_tpu_torch
from zvec_tpu_torch import (
    CollectionSchema,
    DataType,
    Doc,
    FieldSchema,
    HnswIndexParam,
    HnswQueryParam,
    MetricType,
    QuantizeType,
    VectorQuery,
    VectorSchema,
)

N, D = 5000, 64


def main(path: Optional[str] = None) -> Dict[str, object]:
    """Returns the ids it printed: the plain, refined and filtered top-k, and
    the group-by answer (topic -> ids)."""
    tmp = tempfile.mkdtemp(prefix="zvec_quantized_groupby_") if path is None else None
    path = path or f"{tmp}/articles"
    zvec_tpu_torch.init()

    # int8-quantized cosine HNSW: codes live on the device at 1/4 fp32 size
    # and score asymmetrically (fp32 query vs int8 codes, dequant folded in)
    schema = CollectionSchema(
        "articles",
        fields=[FieldSchema("topic", DataType.STRING)],
        vectors=[
            VectorSchema(
                "emb",
                DataType.VECTOR_FP32,
                D,
                HnswIndexParam(
                    MetricType.COSINE, m=24, quantize_type=QuantizeType.INT8
                ),
            )
        ],
    )
    col = zvec_tpu_torch.create_and_open(path, schema)

    rng = np.random.default_rng(11)
    topics = ["science", "sports", "finance", "art"]
    centers = {t: rng.standard_normal(D).astype(np.float32) * 3 for t in topics}
    docs = []
    for i in range(N):
        t = topics[i % len(topics)]
        v = centers[t] + rng.standard_normal(D).astype(np.float32)
        docs.append(Doc(id=f"a{i}", fields={"topic": t}, vectors={"emb": v}))
    for lo in range(0, N, 1000):
        col.insert(docs[lo : lo + 1000])
    col.optimize()  # seal + build the quantized graph

    q = centers["science"] + 0.5 * rng.standard_normal(D).astype(np.float32)

    # plain quantized search
    hits = col.query(VectorQuery("emb", vector=q), topk=5)
    print("int8 cosine top-5:", [(h.id, round(h.score, 4)) for h in hits])

    # refined search: quantized scan overscans, then exact fp32 re-rank
    refined = col.query(
        VectorQuery("emb", vector=q, param=HnswQueryParam(is_using_refiner=True)),
        topk=5,
    )
    print("refined top-5:    ", [(h.id, round(h.score, 4)) for h in refined])

    # hybrid: filter to one topic
    sports = col.query(
        VectorQuery("emb", vector=q), topk=3, filter="topic = 'sports'",
        output_fields=["topic"],
    )
    if not all(h.fields["topic"] == "sports" for h in sports):
        raise AssertionError("the filter let another topic through")
    print("filtered (sports):", [h.id for h in sports])

    # group-by: best 2 docs from each of the 3 closest topics
    grouped = col.group_by_query(
        VectorQuery("emb", vector=q),
        group_by_field="topic",
        group_count=3,
        group_topk=2,
        output_fields=["topic"],
    )
    by_topic: Dict[str, List[str]] = {}
    for h in grouped:
        by_topic.setdefault(h.fields["topic"], []).append(h.id)
    print("group-by:", by_topic)
    if not (len(by_topic) == 3 and all(len(v) == 2 for v in by_topic.values())):
        raise AssertionError("group-by did not return 3 groups of 2")
    print("OK")
    col.destroy()
    if tmp is not None:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "plain": [h.id for h in hits],
        "refined": [h.id for h in refined],
        "filtered": [h.id for h in sports],
        "group_by": by_topic,
    }


if __name__ == "__main__":
    main()
