"""Offline collection build from a vector file.

Reference equivalent: `tools/core/local_builder.cc` (YAML-configured offline
index build from .vecs files). Usage:

  python -m zvec_tpu_torch.tools.build --output PATH --vectors base.fvecs \\
      --field emb --index hnsw --metric l2 [--m 16] [--ef-construction 200] \\
      [--quantize int8] [--n-list 1024] [--limit N]
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", required=True)
    parser.add_argument("--vectors", required=True)
    parser.add_argument("--field", default="emb")
    parser.add_argument("--index", choices=["flat", "hnsw", "ivf"], default="hnsw")
    parser.add_argument("--metric", choices=["l2", "ip", "cosine"], default="l2")
    parser.add_argument("--m", type=int, default=16)
    parser.add_argument("--ef-construction", type=int, default=200)
    parser.add_argument("--n-list", type=int, default=0)
    parser.add_argument(
        "--quantize", choices=["none", "fp16", "int8", "int4"], default="none"
    )
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--batch", type=int, default=1000)
    args = parser.parse_args(argv)

    import zvec_tpu_torch
    from zvec_tpu_torch import (
        CollectionSchema,
        DataType,
        Doc,
        FlatIndexParam,
        HnswIndexParam,
        IVFIndexParam,
        MetricType,
        QuantizeType,
        VectorSchema,
    )

    from .io import load_vectors

    metric = {"l2": MetricType.L2, "ip": MetricType.IP, "cosine": MetricType.COSINE}[
        args.metric
    ]
    quant = {
        "none": QuantizeType.UNDEFINED,
        "fp16": QuantizeType.FP16,
        "int8": QuantizeType.INT8,
        "int4": QuantizeType.INT4,
    }[args.quantize]

    data = load_vectors(args.vectors, args.limit)
    n, dim = data.shape

    if args.index == "hnsw":
        ip = HnswIndexParam(metric, args.m, args.ef_construction, quant)
    elif args.index == "ivf":
        ip = IVFIndexParam(metric, args.n_list, quantize_type=quant)
    else:
        ip = FlatIndexParam(metric, quant)

    schema = CollectionSchema(
        "bench",
        vectors=[VectorSchema(args.field, DataType.VECTOR_FP32, dim, ip)],
        max_doc_count_per_segment=max(n, 1000),
    )
    coll = zvec_tpu_torch.create_and_open(args.output, schema)
    t0 = time.perf_counter()
    for s in range(0, n, args.batch):
        e = min(s + args.batch, n)
        coll.insert(
            [Doc(id=str(i), vectors={args.field: data[i]}) for i in range(s, e)]
        )
    insert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    coll.optimize()  # seal + build the index
    build_s = time.perf_counter() - t0
    coll.flush()
    coll._impl.close()
    print(
        json.dumps(
            {
                "docs": n,
                "dim": dim,
                "insert_s": round(insert_s, 2),
                "index_build_s": round(build_s, 2),
                "path": args.output,
            }
        )
    )


if __name__ == "__main__":
    main()
