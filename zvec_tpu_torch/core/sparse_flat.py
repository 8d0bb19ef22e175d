"""Sparse FLAT engine: exact sparse-IP scan on the card.

Port of `zvec_tpu/core/sparse_flat.py` (reference equivalent:
`src/core/algorithm/flat_sparse/`, brute force over sparse postings). Docs
live as padded index/value tensors on the device; every query batch densifies
there and the scan is a gather + reduce (`ops/sparse.py`). Sparse vectors
support the IP metric only (`distance_helper.py:148-150`). Under a
collection mesh (`init(mesh_devices=S)`, at least 512 rows) the padded rows
split into S contiguous shards, one per mesh device, and a query batch scans
every shard before the per-shard top-k merge
(`parallel/mesh.py::sharded_sparse_topk`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..model.param.param import FlatQueryParam
from ..ops.runtime import bucket_queries, device, round_up
from ..ops.sparse import pad_sparse_rows, prune_sparse_query, sparse_ip_topk
from ..typing.enum import MetricType
from .interface import VectorIndexEngine, device_row_mask

__all__ = ["SparseFlatEngine"]

_ROW_ALIGN = 512
_QUERY_NNZ_PAD = 64


class SparseFlatEngine(VectorIndexEngine):
    """Engine over one segment's sparse vector column."""

    query_param_class = FlatQueryParam

    def __init__(self, metric: MetricType = MetricType.IP, dimension: int = 0, params=None):
        super().__init__(MetricType.IP, dimension, params)
        self._n = 0
        # (n_pad, P) int32 (-1 pad) and f32 rows; one (n_pad / S, P) tensor per
        # shard under a mesh
        self._doc_idx: Optional[torch.Tensor] = None
        self._doc_val: Optional[torch.Tensor] = None
        self._n_pad = 0
        self._vocab = 1
        self._smesh = None  # the collection mesh when the rows are sharded

    def _mesh(self):
        from ..parallel.mesh import collection_mesh

        return collection_mesh()

    def _rebuild(self, rows: List[Optional[Dict[int, float]]]) -> None:
        self._n = len(rows)
        if self._n == 0:
            self._doc_idx = None
            return
        idx, val, vocab = pad_sparse_rows(list(rows))
        mesh = self._mesh()
        self._smesh = mesh if (mesh is not None and self._n >= _ROW_ALIGN) else None
        s_count = self._smesh.shape["corpus"] if self._smesh is not None else 1
        n_pad = self._n_pad = round_up(self._n, _ROW_ALIGN * s_count)
        pidx = np.full((n_pad, idx.shape[1]), -1, dtype=np.int32)
        pval = np.zeros((n_pad, val.shape[1]), dtype=np.float32)
        pidx[: self._n] = idx
        pval[: self._n] = val
        if self._smesh is not None:
            from ..parallel.mesh import shard_rows

            self._doc_idx = shard_rows(pidx, self._smesh)
            self._doc_val = shard_rows(pval, self._smesh)
        else:
            dev = device()
            self._doc_idx = torch.from_numpy(pidx).to(dev)
            self._doc_val = torch.from_numpy(pval).to(dev)
        self._vocab = int(round_up(max(vocab, 1), 128))

    def _prep_query_arrays(self, queries, param=None):
        """Prune + pad sparse dict queries to (nq_bucket, pq) int32/f32
        arrays (shared by `search`, the graph beam and the dense+sparse
        pair, `ops/fused.py`)."""
        budget = getattr(param, "filtering_budget", 0.0) if param else 0.0
        pruned = [prune_sparse_query(q or {}, budget) for q in queries]
        pq = max(max((len(q) for q in pruned), default=1), 1)
        pq = min(round_up(pq, 8), _QUERY_NNZ_PAD * 8)
        nq_pad = bucket_queries(len(queries))
        q_idx = np.full((nq_pad, pq), -1, dtype=np.int32)
        q_val = np.zeros((nq_pad, pq), dtype=np.float32)
        for i, q in enumerate(pruned):
            items = sorted(q.items(), key=lambda kv: -abs(kv[1]))[:pq]
            for j, (k, v) in enumerate(sorted(items)):
                q_idx[i, j] = k
                q_val[i, j] = v
        return q_idx, q_val

    def device_mask(self, mask: Optional[np.ndarray]) -> torch.Tensor:
        """The (n_pad,) row filter on the device: pad rows out, then `mask`
        (one tensor per shard under a mesh)."""
        if self._smesh is not None:
            return device_row_mask(mask, self._n, self._n_pad, mesh=self._smesh)
        return device_row_mask(mask, self._n, self._n_pad, dev=self._doc_idx.device)

    def _exact_scan(self, q_idx: np.ndarray, q_val: np.ndarray, dmask: torch.Tensor, k: int):
        """`sparse_ip_topk` over the whole column (over every shard, then
        the merge, under a mesh) -> host (sims, idx int64)."""
        if self._smesh is not None:
            from ..parallel.mesh import sharded_sparse_topk

            sims, idx = sharded_sparse_topk(
                self._smesh, torch.from_numpy(q_idx), torch.from_numpy(q_val),
                self._doc_idx, self._doc_val, dmask, topk=k, vocab=self._vocab,
            )
            return sims.cpu().numpy(), idx.cpu().numpy()
        dev = self._doc_idx.device
        sims, idx = sparse_ip_topk(
            torch.from_numpy(q_idx).to(dev),
            torch.from_numpy(q_val).to(dev),
            self._doc_idx,
            self._doc_val,
            dmask,
            topk=k,
            vocab=self._vocab,
        )
        return sims.cpu().numpy(), idx.cpu().numpy()

    @staticmethod
    def _pad_results(sims: np.ndarray, idx: np.ndarray, topk: int):
        """Widen (Q, k) results to topk columns; empty slots score -inf."""
        if sims.shape[1] < topk:
            pad = topk - sims.shape[1]
            sims = np.pad(sims, ((0, 0), (0, pad)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        return np.where(idx >= 0, sims, -np.inf), idx

    def search(
        self,
        queries,  # list of {dim: value} dicts
        topk: int,
        mask: Optional[np.ndarray] = None,
        param=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        self._ensure_fresh()
        if isinstance(queries, dict):
            queries = [queries]
        nq = len(queries)
        self.stats.search_count += 1
        self.stats.queries_served += nq
        if self._n == 0:
            return (
                np.full((nq, topk), -np.inf, np.float32),
                np.full((nq, topk), -1, np.int64),
            )
        t0 = time.perf_counter()
        q_idx, q_val = self._prep_query_arrays(queries, param)
        sims, idx = self._exact_scan(q_idx, q_val, self.device_mask(mask), min(topk, self._n))
        sims, idx = self._pad_results(sims[:nq], idx[:nq], topk)
        self.stats.total_search_secs += time.perf_counter() - t0
        return sims, idx
