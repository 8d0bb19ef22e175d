"""IVF engine: k-means lists, batched probe on the card.

Port of `zvec_tpu/core/ivf.py`. Reference behaviour (`src/core/algorithm/
ivf/`): train k-means centroids (`ivf_builder.cc`), assign vectors to
inverted lists, search = centroid search -> scan nprobe lists -> heap merge
(`ivf_searcher.cc:183-250`), with a brute-force fallback below a
small-corpus threshold (`ivf_searcher.cc:185`) and optional SOAR spilled
assignment (`use_soar`, `index_params.h:252-258`).

Layout: lists are padded to one length L (long lists split into virtual
sublists that share their centroid), so a probe step is one gather of a
(Q, L, D) block and one batched product; pad and filter masks are fused and
quantized codes keep the dequant in the epilogue. The trained state (the
centroids, the row -> list assignment with SOAR secondaries, the quantizer)
is written to `ivf_{field}.npz` with the JAX package's keys, so an index
trained by either package reopens in the other without retraining.

Under a collection mesh (`init(mesh_devices=S)`, at least 1,000 rows) the
virtual lists are padded to a multiple of S with dummy lists (masked out of
the centroid top-k by `cent_valid`) and split into S contiguous shards, one
per mesh device; every shard probes its own nearest lists and the per-shard
top-k merge (`parallel/mesh.py::sharded_ivf_probe`).

Left out against the JAX engine: the 512-query probe blocks above 3 GB of
lists, a workaround for 16 GB of device memory.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..model.param.param import IVFQueryParam, QueryParam
from ..ops.distance import similarity_matrix, unpack_nibbles
from ..ops.kmeans import assign_top2, kmeanspp_seed, lloyd, stratified_train
from ..ops.quantize import QuantParams, decode, encode, pack_int4, train_quantizer
from ..ops.runtime import NEG_INF, bucket_queries, device, topk_desc
from ..ops.topk import blockwise_topk_search
from ..typing.enum import IndexType, MetricType, QuantizeType
from .interface import VectorIndexEngine, device_row_mask, register_engine, rescan_deficient
from .refiner import refine

__all__ = ["IvfEngine", "ivf_probe_core"]

_BRUTE_FORCE_THRESHOLD = 1000
_DEFAULT_NPROBE = 10


def ivf_probe_core(
    q: torch.Tensor,  # (Q, D)
    centroids: torch.Tensor,  # (K, D)
    lists_codes: torch.Tensor,  # (K, L, D) storage dtype, or (K, L, ceil(D/2)) packed int4
    lists_norms: torch.Tensor,  # (K, L) dequantized squared norms
    lists_ids: torch.Tensor,  # (K, L) int32 row ids, -1 pad
    mask: Optional[torch.Tensor],  # (N,) bool or None
    dequant,  # (scale, bias) or None
    *,
    metric: MetricType,
    nprobe: int,
    topk: int,
    int4_packed: bool = False,
    cent_valid: Optional[torch.Tensor] = None,  # (K,) bool: dummy-list mask
    max_scan: int = 0,  # cap on scanned rows per query; 0 = unbounded
):
    """Top-nprobe centroids, then one probed list per step: gather the
    (Q, L, D) codes, score them in one batched product, mask pad / filter /
    budget, and fold into a running top-k. `cent_valid` masks padding lists
    out of the centroid top-k (the sharded probe's dummy lists). Returns
    (sims (Q, k) desc, ids (Q, k) int32, -1 invalid)."""
    q = q.float()
    nq = q.shape[0]
    lmax = lists_codes.shape[1]
    dev = q.device
    cent_sims = similarity_matrix(q, centroids, metric)  # (Q, K)
    if cent_valid is not None:
        cent_sims = torch.where(cent_valid[None, :], cent_sims, NEG_INF)
    _, sel = topk_desc(cent_sims, nprobe)  # (Q, nprobe)

    q_sq = (q * q).sum(-1, keepdim=True)  # (Q, 1)
    q_n = torch.sqrt(q_sq)
    k = min(topk, nprobe * lmax)
    if int4_packed:
        d2 = lists_codes.shape[-1]
        q_even = q[:, 0 : 2 * d2 : 2]
        q_odd = q[:, 1 : 2 * d2 : 2]
        if q_odd.shape[1] < d2:  # odd D: the phantom nibble is 0
            q_odd = torch.nn.functional.pad(q_odd, (0, d2 - q_odd.shape[1]))
        q_even, q_odd = q_even[:, :, None], q_odd[:, :, None]

    cs = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=dev)
    ci = torch.full((nq, k), -1, dtype=lists_ids.dtype, device=dev)
    scanned = torch.zeros((nq,), dtype=torch.int32, device=dev)
    # one probed list per step keeps the gathered block (Q, L, D) (the
    # reference scans the nprobe lists of a query one after another too,
    # `ivf_searcher.cc:183-250`)
    for p in range(nprobe):
        lst = sel[:, p]  # (Q,)
        codes = lists_codes[lst]  # (Q, L, Dc)
        norms = lists_norms[lst]  # (Q, L)
        ids = lists_ids[lst]  # (Q, L)
        if int4_packed:
            lo, hi = unpack_nibbles(codes)
            dots = (torch.bmm(lo.float(), q_even) + torch.bmm(hi.float(), q_odd))[..., 0]
            if dequant is not None:
                dots = dequant[0] * dots + dequant[1] * q.sum(-1, keepdim=True)
        else:
            if codes.dtype != torch.float32:
                codes = codes.float()
                if dequant is not None:
                    codes = codes * dequant[0] + dequant[1]
            dots = torch.bmm(codes, q[:, :, None])[..., 0]
        if metric == MetricType.IP:
            sims = dots
        elif metric == MetricType.L2:
            sims = -(q_sq + norms - 2.0 * dots)
        else:  # COSINE; a zero-norm row scores 1.0
            denom = q_n * torch.sqrt(norms)
            sims = torch.where(denom > 0, dots / torch.where(denom > 0, denom, 1.0), 1.0)
        valid = ids >= 0
        if max_scan > 0:
            # per-query scan budget: a list that STARTS under budget is
            # scanned in full (`ivf_searcher.cc:222-237` checks at the loop head)
            active = scanned < max_scan  # (Q,)
            scanned = scanned + torch.where(active, valid.sum(1, dtype=torch.int32), 0)
            valid = valid & active[:, None]
        if mask is not None:
            valid = valid & mask[ids.clamp_min(0).long()]
        sims = torch.where(valid, sims, NEG_INF)
        all_s = torch.cat([cs, sims], dim=1)
        all_i = torch.cat([ci, ids], dim=1)
        cs, pos = topk_desc(all_s, k)
        ci = torch.take_along_dim(all_i, pos, dim=1)
    ci = torch.where(cs > NEG_INF / 2, ci, -1)
    return cs, ci


def _dedupe_topk(sims: np.ndarray, idx: np.ndarray, topk: int):
    """Keep-first dedupe of (desc-sorted) candidate rows, then truncate."""
    nq = sims.shape[0]
    out_s = np.full((nq, topk), -np.inf, dtype=np.float32)
    out_i = np.full((nq, topk), -1, dtype=np.int64)
    for qi in range(nq):
        seen = set()
        w = 0
        for s, i in zip(sims[qi], idx[qi]):
            if i < 0 or i in seen:
                continue
            seen.add(i)
            out_s[qi, w] = s
            out_i[qi, w] = i
            w += 1
            if w == topk:
                break
    return out_s, out_i


@register_engine(IndexType.IVF)
class IvfEngine(VectorIndexEngine):
    query_param_class = IVFQueryParam

    def __init__(self, metric: MetricType, dimension: int, params=None):
        super().__init__(metric, dimension, params)
        self.n_list = params.n_list if params is not None else 0
        self.n_iters = params.n_iters if params is not None else 10
        self.use_soar = bool(params.use_soar) if params is not None else False
        self.quantize = (
            QuantizeType(params.quantize_type)
            if params is not None
            else QuantizeType.UNDEFINED
        )
        self._qparams: Optional[QuantParams] = None
        self._dequant = None
        self._n = 0
        self._centroids: Optional[torch.Tensor] = None  # (KV, D) per virtual list
        self._lists_codes: Optional[torch.Tensor] = None
        self._lists_norms: Optional[torch.Tensor] = None
        self._lists_ids: Optional[torch.Tensor] = None
        self._flat_ids: Optional[np.ndarray] = None  # host slot -> row map
        self._cent_valid = None  # per shard (KV / S,) bool under a mesh
        self._smesh = None  # the collection mesh when the lists are sharded
        self._int4_packed = False
        self._extra_probes = 0
        self._loaded_aux = None
        self._trained = None  # host copies for persistence
        # seconds of the last training by phase, and of the last dump_aux
        self.build_times: Dict[str, float] = {}

    # ------------- build -------------
    def _effective_n_list(self, n: int) -> int:
        if self.n_list > 0:
            return min(self.n_list, max(1, n))
        # auto heuristic: ~4*sqrt(N), capped (reference default constant 1024)
        return int(min(1024, max(1, 4 * np.sqrt(n))))

    def _rebuild(self, data: np.ndarray) -> None:
        data = np.asarray(data, dtype=np.float32)
        self._n = data.shape[0]
        if self._n == 0:
            self._centroids = None
            return
        self.build_times = {}
        if (
            self._loaded_aux is not None
            and int(self._loaded_aux["n"]) == self._n
        ):
            centroids = self._loaded_aux["centroids"]
            assign_rows = self._loaded_aux["assign_rows"]
            assign_lists = self._loaded_aux["assign_lists"]
            qp = self._loaded_aux.get("qparams")
            if qp is not None and qp.size:
                self._qparams = QuantParams(float(qp[0]), float(qp[1]), int(qp[2]))
        else:
            centroids, assign_rows, assign_lists = self._train(data)
        t0 = time.perf_counter()
        self._assemble_lists(data, centroids, assign_rows, assign_lists)
        self.build_times["assemble"] = time.perf_counter() - t0
        self._trained = {
            "n": np.int64(self._n),
            "centroids": centroids,
            "assign_rows": assign_rows.astype(np.int64),
            "assign_lists": assign_lists.astype(np.int64),
            "qparams": np.asarray(
                [self._qparams.scale, self._qparams.bias, self._qparams.qtype]
            )
            if self._qparams
            else np.zeros(0),
        }

    def _train(self, data: np.ndarray):
        """k-means (stratified seeds at K >= 256, else kmeans++) and Lloyd on
        the card, then the SOAR spill and the quantizer. Returns (centroids,
        assign_rows, assign_lists) on the host."""
        t0 = time.perf_counter()
        k = self._effective_n_list(self._n)
        rng = np.random.default_rng(0xC0FFEE + self._n)
        if k >= 256:
            # stratified two-level training at large K (reference
            # StratifiedCluster role)
            seeds = stratified_train(data, k, rng, iters=self.n_iters)
        else:
            seeds = kmeanspp_seed(data, k, rng)
        x = torch.tensor(data, device=device())  # a copy: `data` may be a read-only view
        cents, assign1 = lloyd(x, torch.from_numpy(seeds), iters=self.n_iters)
        centroids = cents.cpu().numpy()
        assign1 = assign1.cpu().numpy()
        t1 = time.perf_counter()
        self.build_times["kmeans"] = t1 - t0
        if self.use_soar and centroids.shape[0] > 1:
            a2 = assign_top2(x, cents).cpu().numpy()
            t2 = time.perf_counter()
            self.build_times["assign_top2"] = t2 - t1
            # Spill-ratio gate (the boundary condition real SOAR carries,
            # `index_params.h:252-258` / ScaNN's spilling): only points
            # whose second centroid is within tau of the first spill a
            # secondary copy. Unconditional top-2 degenerates on clustered
            # corpora: a centroid near the global mean is never anyone's
            # FIRST choice but everyone's second.
            tau2 = 1.44  # (d2/d1)^2 <= 1.44, i.e. d2 <= 1.2*d1
            d1 = np.empty(self._n, np.float32)
            d2 = np.empty(self._n, np.float32)
            CH = 1 << 20
            for lo in range(0, self._n, CH):
                hi = min(lo + CH, self._n)
                xb = data[lo:hi]
                for dst, ci in ((d1, a2[lo:hi, 0]), (d2, a2[lo:hi, 1])):
                    c = centroids[ci]
                    dst[lo:hi] = (
                        np.einsum("ij,ij->i", xb, xb)
                        - 2.0 * np.einsum("ij,ij->i", xb, c)
                        + np.einsum("ij,ij->i", c, c)
                    )
            spill = d2 <= tau2 * np.maximum(d1, 1e-12)
            rows = np.arange(self._n)
            assign_rows = np.concatenate([rows, rows[spill]])
            assign_lists = np.concatenate([a2[:, 0], a2[spill, 1]])
            self.build_times["spill"] = time.perf_counter() - t2
        else:
            assign_rows = np.arange(self._n)
            assign_lists = assign1
        del x, cents
        if self.quantize in (QuantizeType.INT8, QuantizeType.INT4):
            store = data
            if self.metric == MetricType.COSINE:
                nrm = np.linalg.norm(store, axis=1, keepdims=True)
                store = np.where(nrm > 0, store / np.where(nrm > 0, nrm, 1), store)
            self._qparams = train_quantizer(store, self.quantize)
        return centroids, assign_rows, assign_lists

    def _assemble_lists(self, data, centroids, assign_rows, assign_lists) -> None:
        k = centroids.shape[0]
        store = data
        if self.metric == MetricType.COSINE and self.quantize != QuantizeType.UNDEFINED:
            nrm = np.linalg.norm(store, axis=1, keepdims=True)
            store = np.where(nrm > 0, store / np.where(nrm > 0, nrm, 1), store)
        codes = encode(store, self.quantize, self._qparams)
        deq_norms = (decode(codes, self._qparams) ** 2).sum(1)

        # vectorized list assembly: stable-sort entries by list, then each
        # entry's slot is its rank within its list
        assign_rows = np.asarray(assign_rows, dtype=np.int64)
        assign_lists = np.asarray(assign_lists, dtype=np.int64)
        counts = np.bincount(assign_lists, minlength=k)
        n_entries = len(assign_rows)

        # Bucketed padding: a skewed cluster must not inflate every list to
        # its length (one 100k-row list at K = 1024 would pad to
        # (1024, 100k, D)). Lists longer than a bucket split into virtual
        # sublists sharing the (replicated) centroid, so memory stays
        # O(N*D + K*B*D); the centroid top-k spends extra probes on heavy
        # clusters (the reference instead scans variable-length list
        # blocks, `ivf_entity.cc:587-734`). The cap of 4096 rows bounds the
        # per-step (Q, L, D) gather of the probe.
        bucket = int(
            np.ceil(
                max(
                    8,
                    min(
                        counts.max(initial=1),
                        2 * n_entries / max(k, 1) + 8,
                        4096,
                    ),
                )
                / 8
            )
            * 8
        )
        n_chunks = np.maximum(1, -(-counts // bucket))  # ceil_div, >=1
        v_of_list = np.zeros(k + 1, dtype=np.int64)
        np.cumsum(n_chunks, out=v_of_list[1:])
        kv = int(v_of_list[-1])
        lmax = int(min(max(counts.max(initial=1), 1), bucket))

        order = np.argsort(assign_lists, kind="stable")
        sorted_lists = assign_lists[order]
        sorted_rows = assign_rows[order]
        starts = np.zeros(k + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slots = np.arange(len(order)) - starts[sorted_lists]
        v_lists = v_of_list[sorted_lists] + slots // bucket
        v_slots = slots % bucket

        lists_codes = np.zeros((kv, lmax, data.shape[1]), dtype=codes.dtype)
        lists_norms = np.zeros((kv, lmax), dtype=np.float32)
        lists_ids = np.full((kv, lmax), -1, dtype=np.int32)
        lists_codes[v_lists, v_slots] = codes[sorted_rows]
        lists_norms[v_lists, v_slots] = deq_norms[sorted_rows]
        lists_ids[v_lists, v_slots] = sorted_rows
        # host flat view of slot -> global row (-1 padding): the linear-scan
        # path maps scan positions back to rows without a device trip
        self._flat_ids = lists_ids.reshape(-1).copy()
        self._int4_packed = self.quantize == QuantizeType.INT4
        if self._int4_packed:
            # nibble-pack list codes (2 per byte): half the memory and scan traffic
            lists_codes = pack_int4(lists_codes.reshape(kv * lmax, -1)).reshape(kv, lmax, -1)
        v_centroids = np.repeat(centroids, n_chunks, axis=0).astype(np.float32)
        # nprobe compensation: a real list split into C chunks needs C probes
        # to be scanned fully (all C share the centroid similarity, so they
        # rank adjacently) — widen the probe count by the worst split so
        # "nprobe lists" keeps the reference's full-list-scan semantics.
        self._extra_probes = int(n_chunks.max(initial=1)) - 1
        if self._extra_probes > 8:
            # one pathological list widens EVERY query's effective nprobe:
            # surface the skew instead of silently paying it
            logging.getLogger("zvec_tpu_torch").warning(
                "ivf: worst list splits into %d chunks of %d rows; every "
                "query's effective nprobe widens by %d — consider more "
                "centroids (num_centroids) for this distribution",
                self._extra_probes + 1,
                bucket,
                self._extra_probes,
            )

        self._dequant = (
            (float(np.float32(self._qparams.scale)), float(np.float32(self._qparams.bias)))
            if self._qparams is not None
            else None
        )
        mesh = self._mesh()
        self._smesh = mesh if (mesh is not None and self._n >= _BRUTE_FORCE_THRESHOLD) else None
        if self._smesh is not None:
            # the virtual lists split over the shards; dummy lists pad KV to
            # a multiple of S and never win the centroid top-k
            from ..parallel.mesh import shard_rows

            s_count = self._smesh.shape["corpus"]
            padn = -(-kv // s_count) * s_count - kv
            if padn:
                v_centroids = np.pad(v_centroids, ((0, padn), (0, 0)))
                lists_codes = np.pad(lists_codes, ((0, padn), (0, 0), (0, 0)))
                lists_norms = np.pad(lists_norms, ((0, padn), (0, 0)))
                lists_ids = np.pad(lists_ids, ((0, padn), (0, 0)), constant_values=-1)
            cent_valid = np.zeros(kv + padn, dtype=bool)
            cent_valid[:kv] = True
            # the slot -> row map over the padded list buffer
            self._flat_ids = lists_ids.reshape(-1).copy()
            self._centroids = shard_rows(v_centroids, self._smesh)
            self._lists_codes = shard_rows(lists_codes, self._smesh)
            self._lists_norms = shard_rows(lists_norms, self._smesh)
            self._lists_ids = shard_rows(lists_ids, self._smesh)
            self._cent_valid = shard_rows(cent_valid, self._smesh)
            return
        dev = device()
        self._centroids = torch.from_numpy(v_centroids).to(dev)
        self._lists_codes = torch.from_numpy(lists_codes).to(dev)
        self._lists_norms = torch.from_numpy(lists_norms).to(dev)
        self._lists_ids = torch.from_numpy(lists_ids).to(dev)
        self._cent_valid = None

    def _mesh(self):
        from ..parallel.mesh import collection_mesh

        return collection_mesh()

    def _linear_scan(self, qpad, mask, scan_k):
        """Exact scan over the list-concatenated code buffer ((KV, L, D)
        viewed flat), padding and filter fused as a mask; scan positions map
        back to global rows through the host flat-id table. Serves the
        brute-force fallback, explicit is_linear queries, and the
        filtered-probe safety net. Under a mesh every shard scans its lists'
        buffer and the per-shard top-k merge: the positions are those of the
        padded buffer, shard after shard."""
        ids = self._flat_ids
        valid = ids >= 0
        if mask is not None:
            valid = valid & np.asarray(mask, dtype=bool)[np.clip(ids, 0, None)]
        k = min(scan_k, int(valid.sum()) or 1)
        if self._smesh is not None:
            from ..parallel.mesh import sharded_flat_search

            sims, pos = sharded_flat_search(
                self._smesh,
                torch.from_numpy(np.ascontiguousarray(qpad)),
                [c.reshape(c.shape[0] * c.shape[1], -1) for c in self._lists_codes],
                self.metric,
                k,
                mask=device_row_mask(valid, len(valid), mesh=self._smesh),
                x_sq_norms=[nr.reshape(-1) for nr in self._lists_norms],
                dequant=self._dequant,
                int4_packed=self._int4_packed,
            )
        else:
            kv, lmax = self._lists_ids.shape
            dev = self._lists_codes.device
            sims, pos = blockwise_topk_search(
                torch.from_numpy(np.ascontiguousarray(qpad)).to(dev),
                self._lists_codes.reshape(kv * lmax, -1),
                self.metric,
                k,
                mask=device_row_mask(valid, len(valid), dev=dev),
                x_sq_norms=self._lists_norms.reshape(kv * lmax),
                dequant=self._dequant,
                int4_packed=self._int4_packed,
            )
        sims = sims.cpu().numpy()
        pos = pos.cpu().numpy()
        idx = np.where(pos >= 0, ids[np.clip(pos, 0, None)], -1)
        return sims, idx.astype(np.int64)

    # ------------- search -------------
    def _search_impl(self, queries, topk, mask, param):
        nq = queries.shape[0]
        if self._n == 0:
            return (
                np.full((nq, topk), -np.inf, np.float32),
                np.full((nq, topk), -1, np.int64),
            )
        nprobe = (
            param.nprobe if isinstance(param, IVFQueryParam) else _DEFAULT_NPROBE
        )
        # per-query scanned-row budget (`ivf_searcher_context.h:75-77`:
        # max_scan_count = ceil(N * scan_ratio), floored by the brute-force
        # threshold so a bounded probe never returns less than the bf path)
        max_scan = 0
        if isinstance(param, IVFQueryParam):
            max_scan = int(param.max_scan_count)
            if not max_scan and param.max_scan_ratio:
                max_scan = int(np.ceil(self._n * param.max_scan_ratio))
            if max_scan:
                max_scan = max(max_scan, _BRUTE_FORCE_THRESHOLD)
        quantized = self.quantize != QuantizeType.UNDEFINED
        # refine-by-default on quantized indexes (reference full-precision
        # refine block pairing, `segment.cc:1591-1700`); opt out with
        # is_using_refiner=False
        use_refiner = quantized and (
            param.refiner_enabled(True) if isinstance(param, QueryParam) else True
        )
        out_topk = topk
        if use_refiner:
            topk = min(topk * getattr(param, "refiner_scale_factor", 10), self._n)

        # brute-force fallback: a tiny corpus or an explicit linear search
        # scans the list-concatenated codes once instead of probing every
        # list (`ivf_searcher.cc:185` threshold behaviour)
        linear = self._n < _BRUTE_FORCE_THRESHOLD or getattr(param, "is_linear", False)
        # every virtual list, the dummy lists of a sharded engine included
        kv = sum(c.shape[0] for c in self._centroids) if self._smesh is not None else self._centroids.shape[0]
        nprobe = min(nprobe + self._extra_probes, kv)
        # pad the batch to a bucket, as the JAX engine does
        nq_pad = bucket_queries(nq)
        qpad = np.zeros((nq_pad, queries.shape[1]), np.float32)
        qpad[:nq] = queries
        # SOAR spilling duplicates rows across lists: overscan and dedupe
        scan_k = 2 * topk if self.use_soar else topk
        if linear:
            sims, idx = self._linear_scan(qpad, mask, scan_k)
        elif self._smesh is not None:
            from ..parallel.mesh import sharded_ivf_probe

            s_dev, i_dev = sharded_ivf_probe(
                self._smesh,
                torch.from_numpy(qpad),
                self._centroids,
                self._lists_codes,
                self._lists_norms,
                self._lists_ids,
                self._cent_valid,
                None if mask is None else device_row_mask(mask, self._n),
                self._dequant,
                metric=self.metric,
                nprobe=nprobe,
                topk=scan_k,
                int4_packed=self._int4_packed,
                max_scan=max_scan,
            )
            sims, idx = s_dev.cpu().numpy(), i_dev.cpu().numpy().astype(np.int64)
        else:
            dev = self._centroids.device
            s_dev, i_dev = ivf_probe_core(
                torch.from_numpy(qpad).to(dev),
                self._centroids,
                self._lists_codes,
                self._lists_norms,
                self._lists_ids,
                None if mask is None else device_row_mask(mask, self._n, dev=dev),
                self._dequant,
                metric=self.metric,
                nprobe=nprobe,
                topk=scan_k,
                int4_packed=self._int4_packed,
                max_scan=max_scan,
            )
            sims, idx = s_dev.cpu().numpy(), i_dev.cpu().numpy().astype(np.int64)
        if self.use_soar:
            sims, idx = _dedupe_topk(sims, idx, topk)
        sims, idx = sims[:nq], idx[:nq]  # drop bucket-padding rows
        if mask is not None and not linear:
            # Filtered-probe safety net (deliberate improvement over the
            # reference, which returns whatever the nprobe lists contain —
            # possibly nothing): queries whose probed lists supplied fewer
            # valid hits than the filter allows fall back to the exact
            # masked scan over all lists.
            def _all_lists():
                fs, fi = self._linear_scan(qpad, mask, scan_k)
                if self.use_soar:
                    fs, fi = _dedupe_topk(fs, fi, topk)
                return fs, fi

            sims, idx = rescan_deficient(sims, idx, topk, mask, _all_lists)
        if use_refiner:
            sims, idx = refine(self._data_fn, queries, idx, self.metric, out_topk)
            idx = idx.astype(np.int64)
            topk = out_topk
        if sims.shape[1] < topk:
            pad = topk - sims.shape[1]
            sims = np.pad(sims, ((0, 0), (0, pad)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        sims = sims[:, :topk]
        idx = idx[:, :topk]
        sims = np.where(idx >= 0, sims, -np.inf)
        return sims, idx

    # ------------- persistence -------------
    def dump_aux(self, directory, prefix):
        if self._trained is None:
            self._ensure_fresh()
        t0 = time.perf_counter()
        fname = f"ivf_{prefix}.npz"
        np.savez_compressed(os.path.join(directory, fname), **self._trained)
        self.build_times["dump_aux"] = time.perf_counter() - t0
        return {"file": fname, "type": "ivf"}

    def load_aux(self, directory, descriptor):
        path = os.path.join(directory, descriptor.get("file", ""))
        if os.path.exists(path):
            self._loaded_aux = dict(np.load(path))
