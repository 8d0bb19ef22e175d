"""Recall harness: recall@{1,10,50,100} vs ground truth.

Reference equivalent: `tools/core/recall.cc` (multi-topk recall against a
neighbors file). Usage:

  python -m zvec_tpu_torch.tools.recall --collection PATH --field emb \\
      --queries q.fvecs --ground-truth gt.ivecs [--ef 300] [--topk 1,10,50,100]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def compute_recall(got_ids: np.ndarray, gt: np.ndarray, topks) -> dict:
    out = {}
    for k in topks:
        hits = 0
        for row_got, row_gt in zip(got_ids, gt):
            hits += len(set(row_got[:k].tolist()) & set(row_gt[:k].tolist()))
        out[f"recall@{k}"] = hits / (len(gt) * k)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--collection", required=True)
    parser.add_argument("--field", required=True)
    parser.add_argument("--queries", required=True)
    parser.add_argument("--ground-truth", required=True)
    parser.add_argument("--topk", default="1,10,50,100")
    parser.add_argument("--ef", type=int, default=None)
    parser.add_argument("--nprobe", type=int, default=None)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)

    import zvec_tpu_torch
    from zvec_tpu_torch import HnswQueryParam, IVFQueryParam, VectorQuery

    from .io import load_vectors

    topks = [int(k) for k in args.topk.split(",")]
    max_k = max(topks)
    queries = load_vectors(args.queries, args.limit)
    gt = load_vectors(args.ground_truth, args.limit).astype(np.int64)

    coll = zvec_tpu_torch.open(args.collection)
    param = None
    if args.ef is not None:
        param = HnswQueryParam(ef=args.ef)
    elif args.nprobe is not None:
        param = IVFQueryParam(nprobe=args.nprobe)

    got = np.full((len(queries), max_k), -1, dtype=np.int64)
    t0 = time.perf_counter()
    for i, q in enumerate(queries):
        res = coll.query(
            VectorQuery(args.field, vector=q, param=param), topk=max_k
        )
        for j, doc in enumerate(res):
            got[i, j] = int(doc.id) if doc.id.isdigit() else hash(doc.id)
    elapsed = time.perf_counter() - t0

    result = compute_recall(got, gt, topks)
    result["queries"] = len(queries)
    result["avg_latency_ms"] = elapsed / len(queries) * 1e3
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
