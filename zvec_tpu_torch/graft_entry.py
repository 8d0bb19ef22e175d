"""Entry points of the port, after the JAX package's `__graft_entry__.py`.

`entry()` returns a single-device step of the flagship search path (the
blockwise exact scan + top-k) and its inputs, on the port's device
(`ops/runtime.device`).

`dryrun_multichip(n)` builds an n-slot ('batch', 'corpus') mesh, runs one
sharded exact query step (per-shard top-k, then the merge) and one sharded
k-means step on tiny shapes, then drives the FLAT, HNSW, IVF and sparse HNSW
paths through the public API with `mesh_devices = n`: every engine shards its
sealed segment over n shards and must find each query's own document first.
It runs on the card (the n shards placed round-robin over the cards there
are), or on the CPU when `ZVEC_TORCH_DEVICE=cpu` asks for it.
"""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch


def entry():
    from .ops.runtime import device
    from .ops.topk import blockwise_topk_search
    from .typing import MetricType

    dev = device()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32)).to(dev)
    mask = torch.ones(4096, dtype=torch.bool, device=dev)

    def fn(q, codes, mask):
        return blockwise_topk_search(q, codes, MetricType.L2, 10, mask=mask, block_size=1024)

    return fn, (q, codes, mask)


def _fill(zt, path, name, field, dtype, dim, param, rows, prefix):
    schema = zt.CollectionSchema(name, vectors=[zt.VectorSchema(field, dtype, dim, param)])
    col = zt.create_and_open(path, schema)
    for lo in range(0, len(rows), 1024):
        col.insert([zt.Doc(id=f"{prefix}{i}", vectors={field: rows[i]})
                    for i in range(lo, min(lo + 1024, len(rows)))])
    col.flush()
    col.optimize()
    return col


def _engine(col, field):
    eng = col._impl._segments_snapshot()[0].engine_for(field)
    eng._ensure_fresh()
    return eng


def dryrun_multichip(n_devices: int) -> dict:
    """The sharded paths on `n_devices` shards; raises on a wrong answer.
    Returns what ran: the mesh, the k-means inertia, and the devices of
    each engine's shards."""
    import zvec_tpu_torch as zt
    from zvec_tpu_torch.parallel.mesh import make_mesh, sharded_flat_search, sharded_kmeans_step
    from zvec_tpu_torch.typing import MetricType
    from zvec_tpu_torch.utils.config import GlobalConfig

    batch_axis = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, batch_axis=batch_axis)
    rng = np.random.default_rng(0)
    n_rows = 64 * n_devices
    queries = rng.standard_normal((8, 32)).astype(np.float32)
    codes = rng.standard_normal((n_rows, 32)).astype(np.float32)

    # sharded query step: per-shard exact top-k, then the merge
    _, ids = sharded_flat_search(mesh, torch.from_numpy(queries), torch.from_numpy(codes), MetricType.L2, topk=5)
    d = ((queries[0][None] - codes) ** 2).sum(1)
    if set(ids[0].tolist()) != set(np.argsort(d)[:5].tolist()):
        raise AssertionError("sharded search disagrees with the oracle")

    # sharded index-training step: one Lloyd iteration, sums added in shard order
    centroids = rng.standard_normal((16, 32)).astype(np.float32)
    _, inertia = sharded_kmeans_step(mesh, torch.from_numpy(codes), torch.from_numpy(centroids))
    if not np.isfinite(float(inertia)):
        raise AssertionError("non-finite k-means inertia")

    # collection-level sharding through the public API
    prev = GlobalConfig.instance().mesh_devices
    GlobalConfig.instance().mesh_devices = n_devices
    tmp = tempfile.mkdtemp(prefix="zvec_dryrun_")
    placed = {}
    try:
        d_dim = 16
        X = rng.standard_normal((512, d_dim)).astype(np.float32)
        col = _fill(zt, f"{tmp}/flat", "dryrun", "emb", zt.DataType.VECTOR_FP32, d_dim,
                    zt.FlatIndexParam(MetricType.L2), X, "pk")
        res = col.query(zt.VectorQuery("emb", vector=X[7]), topk=3)
        if not res or res[0].id != "pk7":
            raise AssertionError(f"FLAT: {[doc.id for doc in res]}")
        placed["flat"] = [str(c.device) for c in _engine(col, "emb")._st.codes]
        col._impl.close()

        Xh = rng.standard_normal((2048, d_dim)).astype(np.float32)
        col = _fill(zt, f"{tmp}/hnsw", "dryrun_hnsw", "emb", zt.DataType.VECTOR_FP32, d_dim,
                    zt.HnswIndexParam(MetricType.L2, m=8, ef_construction=50), Xh, "h")
        eng = _engine(col, "emb")
        if not eng._dev.get("sharded"):
            raise AssertionError("HNSW engine did not build per-shard graphs")
        res = col.query(zt.VectorQuery("emb", vector=Xh[42], param=zt.HnswQueryParam(ef=64)), topk=3)
        if not res or res[0].id != "h42":
            raise AssertionError(f"HNSW: {[doc.id for doc in res]}")
        placed["hnsw"] = [str(c.device) for c in eng._codes]
        col._impl.close()

        Xv = rng.standard_normal((2048, d_dim)).astype(np.float32)
        col = _fill(zt, f"{tmp}/ivf", "dryrun_ivf", "emb", zt.DataType.VECTOR_FP32, d_dim,
                    zt.IVFIndexParam(MetricType.L2, n_list=32, n_iters=3), Xv, "v")
        eng = _engine(col, "emb")
        if eng._smesh is None:
            raise AssertionError("IVF engine did not shard its lists")
        res = col.query(zt.VectorQuery("emb", vector=Xv[17], param=zt.IVFQueryParam(nprobe=8)), topk=3)
        if not res or res[0].id != "v17":
            raise AssertionError(f"IVF: {[doc.id for doc in res]}")
        placed["ivf"] = [str(c.device) for c in eng._lists_codes]
        col._impl.close()

        sp_rows = []
        for _ in range(2048):
            dims = rng.choice(300, 8, replace=False)
            sp_rows.append({int(t): float(rng.random() + 0.1) for t in dims})
        col = _fill(zt, f"{tmp}/sparse", "dryrun_sp", "sv", zt.DataType.SPARSE_VECTOR_FP32, 0,
                    zt.HnswIndexParam(MetricType.IP, m=8, ef_construction=50), sp_rows, "s")
        eng = _engine(col, "sv")
        if eng._smesh is None or eng._l0 is None:
            raise AssertionError("sparse HNSW engine did not build per-shard graphs")
        res = col.query(zt.VectorQuery("sv", vector=sp_rows[5], param=zt.HnswQueryParam(ef=64)), topk=3)
        if not res or res[0].id != "s5":
            raise AssertionError(f"sparse HNSW: {[doc.id for doc in res]}")
        placed["sparse_hnsw"] = [str(t.device) for t in eng._doc_idx]
        col._impl.close()
    finally:
        GlobalConfig.instance().mesh_devices = prev
        shutil.rmtree(tmp, ignore_errors=True)

    summary = {"mesh": mesh.shape, "inertia": float(inertia), "shards": placed}
    print(
        f"dryrun_multichip OK on {n_devices} shards (mesh {mesh.shape}), inertia={float(inertia):.1f}, "
        f"FLAT / HNSW / IVF / sparse HNSW sharded and merged: {placed['flat']}"
    )
    return summary
