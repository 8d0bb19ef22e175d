"""Corpus sharding: one collection split over several devices.

Sealed segment codes split into N contiguous shards placed round-robin over
the CUDA cards there are (all of them on the CPU without a card); every query
runs on each shard and the per-shard top-k merge. One process drives every
device; no launcher. N defaults to 8 shards, the JAX example's 8-device mesh.

Run: python -m zvec_tpu_torch.examples.mesh_sharding
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
    FlatIndexParam,
    MetricType,
    VectorQuery,
    VectorSchema,
)
from zvec_tpu_torch.utils.config import GlobalConfig

N, D = 20_000, 64


def main(path: Optional[str] = None, n_shards: int = 8) -> List[str]:
    """Returns the ids of the sharded top-5, in order."""
    tmp = tempfile.mkdtemp(prefix="zvec_mesh_") if path is None else None
    path = path or f"{tmp}/sharded"
    config = GlobalConfig.instance()
    prev = config.mesh_devices
    # opt in to sharding: sealed segments split over n_shards shards
    # (collection_mesh() in parallel/mesh.py)
    config.mesh_devices = n_shards
    try:
        zvec_tpu_torch.init()
        schema = CollectionSchema(
            "sharded",
            vectors=[VectorSchema("emb", DataType.VECTOR_FP32, D, FlatIndexParam(MetricType.L2))],
        )
        col = zvec_tpu_torch.create_and_open(path, schema)

        rng = np.random.default_rng(3)
        X = rng.standard_normal((N, D)).astype(np.float32)
        for lo in range(0, N, 1000):
            col.insert([Doc(id=str(i), vectors={"emb": X[i]}) for i in range(lo, lo + 1000)])
        col.optimize()  # seal -> the codes split over the shards

        # show the placement: the engine's code table, one block per shard
        eng = col._impl._segments_snapshot()[0].engine_for("emb")
        eng._ensure_fresh()
        shards = eng._st.codes
        print(f"code table: {len(shards)} shards of {shards[0].shape[0]} rows on "
              f"{sorted({str(c.device) for c in shards})}")

        q = rng.standard_normal(D).astype(np.float32)
        hits = col.query(VectorQuery("emb", vector=q), topk=5)
        exact = np.argsort(((X - q) ** 2).sum(1))[:5]
        ids = [h.id for h in hits]
        print("sharded top-5:", ids)
        print("exact   top-5:", [str(i) for i in exact])
        assert [int(i) for i in ids] == exact.tolist()
        print("OK — per-shard scans merged on one device match the exact oracle")
        col._impl.close()
        return ids
    finally:
        config.mesh_devices = prev
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
