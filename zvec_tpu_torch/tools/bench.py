"""Bench harness: QPS + avg latency + latency percentiles.

Reference equivalent: `tools/core/bench.cc` + `bench_result.h:81-95` (QPS,
avg latency, histogram/percentiles under N concurrent streams). Usage:

  python -m zvec_tpu_torch.tools.bench --collection PATH --field emb \\
      --queries q.fvecs [--topk 10] [--batch 1] [--seconds 10] [--ef 300]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def percentiles(latencies_ms, ps=(50, 90, 95, 99, 99.9)):
    arr = np.asarray(latencies_ms)
    return {f"p{p}": float(np.percentile(arr, p)) for p in ps}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--collection", required=True)
    parser.add_argument("--field", required=True)
    parser.add_argument("--queries", required=True)
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--ef", type=int, default=None)
    parser.add_argument("--nprobe", type=int, default=None)
    parser.add_argument("--filter", default=None)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)

    import zvec_tpu_torch
    from zvec_tpu_torch import HnswQueryParam, IVFQueryParam

    from .io import load_vectors

    queries = load_vectors(args.queries, args.limit).astype(np.float32)
    coll = zvec_tpu_torch.open(args.collection)
    param = None
    if args.ef is not None:
        param = HnswQueryParam(ef=args.ef)
    elif args.nprobe is not None:
        param = IVFQueryParam(nprobe=args.nprobe)

    impl = coll._impl
    # warmup (compile)
    impl.query_field(args.field, queries[: args.batch], args.topk, args.filter, param)

    latencies = []
    done_queries = 0
    qi = 0
    t_end = time.perf_counter() + args.seconds
    while time.perf_counter() < t_end:
        batch = queries[qi : qi + args.batch]
        if len(batch) < args.batch:
            qi = 0
            batch = queries[: args.batch]
        t0 = time.perf_counter()
        impl.query_field(args.field, batch, args.topk, args.filter, param)
        latencies.append((time.perf_counter() - t0) * 1e3)
        done_queries += len(batch)
        qi += args.batch

    total_s = sum(latencies) / 1e3
    result = {
        "qps": done_queries / total_s,
        "avg_latency_ms": float(np.mean(latencies)),
        "batch": args.batch,
        "queries": done_queries,
        **percentiles(latencies),
    }
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
