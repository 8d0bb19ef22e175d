"""Sparse HNSW engine: NSW-style graph over sparse vectors.

Port of `zvec_tpu/core/hnsw_sparse.py` (reference equivalent:
`src/core/algorithm/hnsw_sparse/`, graph ANN over sparse postings, IP metric).
The build is a batched kNN-graph construction, the design of the dense engine:
every node takes its exact top neighbours from a scan of the corpus (no
sequential insertion), reverse edges are added on the host, and each node
keeps its top-m0 by dot (IP is symmetric, so reverse-edge scores come free
from the forward pass). Neighbours keep the top-M closest: the reference's
dominance prune needs candidate-to-candidate distances, which for sparse rows
cost more than they save, and the richer entry probe set compensates. Search
runs the batched sparse beam (`ops/hnsw_sparse.py`) from a probed entry set.

From `_CLUSTERED_AUTO_ROWS` rows on, the full scan (quadratic, and a gather
with no matrix product in it) gives way to the clustered signature build
(`_build_graph_clustered`). `build_times` holds the seconds of the last build
by phase, `build_info` what it ran.

Under a collection mesh (`init(mesh_devices=S)`) every shard of the sparse
FLAT engine's rows owns a graph over its own row range, built by the exact
forward pass over that range (`_build_graph_range`) with 32 entry rows drawn
per shard; a query runs the beam on every shard before the per-shard top-k
merge (`parallel/mesh.py::sharded_sparse_beam`). A graph file written under
another shard count (or none) is rebuilt, as the JAX engine does.

Left out against the JAX engine: the environment overrides of the size rule
(`_force_clustered` is the test hook) and the fetch-one-behind pipelining of
the rescoring (the results stay on the card and are copied once).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..model.param.param import HnswQueryParam
from ..ops.hnsw import _dup_mask, assign_top2_blocked, bucket_knn_all
from ..ops.hnsw_sparse import hnsw_sparse_search
from ..ops.kmeans import lloyd
from ..ops.runtime import NEG_INF
from ..ops.sparse import sparse_ip_rows, sparse_ip_topk, sparse_signatures
from ..typing.enum import MetricType
from .hnsw import _lap, _to_dev
from .interface import rescan_deficient
from .sparse_flat import SparseFlatEngine

__all__ = ["SparseHnswEngine"]

_BRUTE_FORCE_THRESHOLD = 1000
_ENTRY_PROBES = 32
# from this many rows on, the build takes its candidates from signature buckets
_CLUSTERED_AUTO_ROWS = 200_000
_SIG_DIMS = 256
_FORWARD_BATCH = 512  # nodes per scan of the exact forward pass
_RESCORE_BATCH = 1024  # nodes per exact rescoring of proposed candidates
_BUCKET_CHUNK = 1024  # buckets per bucket_knn_all call


def _reverse_merge_l0(
    fwd_i: np.ndarray, fwd_s: np.ndarray, n: int, m0: int
) -> np.ndarray:
    """Reverse edges + merge (host, vectorized): every forward edge
    (u, v, s) also proposes (v, u, s); keep each node's top-m0."""
    k = fwd_i.shape[1]
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = fwd_i.ravel()
    sim = fwd_s.ravel()
    valid = (dst >= 0) & (dst != src)
    nodes = np.concatenate([src[valid], dst[valid]])
    cands = np.concatenate([dst[valid], src[valid]])
    sims = np.concatenate([sim[valid], sim[valid]])
    # sort by (node, cand) to drop duplicate pairs, then by (node, -sim)
    order = np.lexsort((cands, nodes))
    nodes, cands, sims = nodes[order], cands[order], sims[order]
    first = np.ones(nodes.shape[0], dtype=bool)
    first[1:] = (nodes[1:] != nodes[:-1]) | (cands[1:] != cands[:-1])
    nodes, cands, sims = nodes[first], cands[first], sims[first]
    order = np.lexsort((-sims, nodes))
    nodes, cands = nodes[order], cands[order]
    start = np.searchsorted(nodes, np.arange(n, dtype=np.int32))
    rank = np.arange(nodes.shape[0], dtype=np.int64) - start[nodes]
    keep = rank < m0
    l0 = np.full((n, m0), -1, dtype=np.int32)
    l0[nodes[keep], rank[keep]] = cands[keep]
    return l0


class SparseHnswEngine(SparseFlatEngine):
    """Sparse graph engine; falls back to the exact scan below the brute-force
    threshold (inherited from SparseFlatEngine)."""

    query_param_class = HnswQueryParam

    def __init__(self, metric: MetricType = MetricType.IP, dimension: int = 0, params=None):
        super().__init__(metric, dimension, params)
        self.m = getattr(params, "m", 16) if params is not None else 16
        self.ef_construction = (
            getattr(params, "ef_construction", 200) if params is not None else 200
        )
        self._l0: Optional[torch.Tensor] = None  # (n_pad, m0) int32 on the device
        self._entries: Optional[torch.Tensor] = None  # (E,) probe rows
        self._aux_l0: Optional[np.ndarray] = None  # the host adjacency dump_aux writes
        self._aux_entries: Optional[np.ndarray] = None  # per-shard entry rows, under a mesh
        self._entry_hint: Optional[np.ndarray] = None  # medoids of a clustered build
        self._loaded_aux: Optional[Dict[str, np.ndarray]] = None
        self._force_clustered = False  # take the clustered build below the size rule
        # seconds of the last graph build by phase, and of the last dump_aux
        self.build_times: Dict[str, float] = {}
        # what the last build ran: clustered or not and, for a clustered build,
        # K, mp, kc and the members dropped past mp
        self.build_info: Dict[str, Any] = {}

    # ------------- build -------------
    def _rebuild(self, rows: List[Optional[Dict[int, float]]]) -> None:
        self.build_times, self.build_info = {}, {}
        self._entry_hint = None
        t0 = time.perf_counter()
        super()._rebuild(rows)
        if self._n < _BRUTE_FORCE_THRESHOLD:
            self._l0 = None
            return
        if self._smesh is not None:
            _lap(self.build_times, "pad_rows", t0)
            self._rebuild_sharded_graph()
            return
        dev = self._doc_idx.device
        _lap(self.build_times, "pad_rows", t0, dev)
        aux = self._loaded_aux
        if aux is not None and ("shards" in aux or int(aux["n"]) != self._n):
            aux = None  # a graph of another layout or of other rows: build anew
        l0 = aux["l0"] if aux is not None else self._build_graph()
        n_pad = self._doc_idx.shape[0]
        pl0 = np.full((n_pad, l0.shape[1]), -1, dtype=np.int32)
        pl0[: self._n] = l0
        self._l0 = _to_dev(pl0, dev)
        hint = self._entry_hint
        if hint is None and aux is not None and aux.get("entries") is not None:
            hint = self._entry_hint = np.asarray(aux["entries"])  # kept for the next dump_aux
        if hint is not None and len(hint):
            # clustered build: probe per-cluster medoids (coverage of every
            # topic component) instead of random rows
            entries = hint.astype(np.int32)
        else:
            rng = np.random.default_rng(0xBEEF + self._n)
            entries = rng.choice(self._n, min(_ENTRY_PROBES, self._n), replace=False).astype(np.int32)
        self._entries = _to_dev(entries, dev)
        self._aux_l0 = l0

    def _rebuild_sharded_graph(self) -> None:
        """Mesh mode: every shard owns an independent graph over its
        contiguous global row range (the dense engine's recipe); neighbour
        ids and the 32 entry rows of each shard are LOCAL to it. The entry
        draws are the JAX engine's, draw for draw (`0xBEEF + n`)."""
        from ..parallel.mesh import shard_rows

        mesh = self._smesh
        s_count = mesh.shape["corpus"]
        n_pad = self._n_pad
        R = n_pad // s_count
        m0 = 2 * self.m
        aux = self._loaded_aux
        if aux is not None and int(aux["n"]) == self._n and int(aux.get("shards", 0)) == s_count:
            pl0, entries = aux["l0"], aux["entries"]
        else:
            t0 = time.perf_counter()
            self.build_info = {"clustered": False}
            pl0 = np.full((n_pad, m0), -1, dtype=np.int32)
            entries = np.zeros(s_count * _ENTRY_PROBES, dtype=np.int32)
            rng = np.random.default_rng(0xBEEF + self._n)
            for s in range(s_count):
                cnt = min((s + 1) * R, self._n) - s * R
                if cnt <= 0:
                    continue  # an empty shard: pad rows only (the mask keeps it out)
                pl0[s * R : s * R + cnt] = self._build_graph_range(s, cnt, m0)
                pick = rng.choice(cnt, min(_ENTRY_PROBES, cnt), replace=False).astype(np.int32)
                entries[s * _ENTRY_PROBES : (s + 1) * _ENTRY_PROBES] = np.resize(pick, _ENTRY_PROBES)
            _lap(self.build_times, "forward_knn", t0)
        self._l0 = shard_rows(pl0, mesh)
        self._entries = shard_rows(entries, mesh)
        self._aux_l0 = pl0
        self._aux_entries = entries

    def _build_graph_range(self, s: int, cnt: int, m0: int) -> np.ndarray:
        """The kNN graph of shard s's first `cnt` rows: forward exact
        top-(m0+1) over that shard's rows, then the reverse merge on the
        host. Returns (cnt, m0) LOCAL adjacency."""
        doc_idx, doc_val = self._doc_idx[s], self._doc_val[s]
        dev = doc_idx.device
        k = min(m0 + 1, cnt)
        dmask = torch.arange(doc_idx.shape[0], device=dev) < cnt
        fwd_s, fwd_i = [], []
        for lo in range(0, cnt, _FORWARD_BATCH):
            hi = min(lo + _FORWARD_BATCH, cnt)
            sims, cand = sparse_ip_topk(
                doc_idx[lo:hi], doc_val[lo:hi], doc_idx, doc_val, dmask, topk=k, vocab=self._vocab,
            )
            fwd_s.append(sims)
            fwd_i.append(cand.int())
        fwd_i = torch.cat(fwd_i).cpu().numpy()
        fwd_s = torch.cat(fwd_s).cpu().numpy()
        return _reverse_merge_l0(fwd_i, fwd_s, cnt, m0)

    def _build_graph(self) -> np.ndarray:
        """Batched kNN-graph build: forward exact top-(m0+1) per node (the
        corpus scan, a fixed batch of nodes at a time), then symmetric reverse
        edges + per-node top-m0 merge on the host. From `_CLUSTERED_AUTO_ROWS`
        rows on the clustered signature build takes over."""
        n = self._n
        if self._force_clustered or n >= _CLUSTERED_AUTO_ROWS:
            return self._build_graph_clustered()
        self.build_info = {"clustered": False}
        times = self.build_times
        dev = self._doc_idx.device
        m0 = 2 * self.m
        k = min(m0 + 1, n)  # +1: self lands in its own top-k
        dmask = self.device_mask(None)

        # ---- forward pass: docs are their own queries (already padded) ----
        t0 = time.perf_counter()
        fwd_s, fwd_i = [], []
        for lo in range(0, n, _FORWARD_BATCH):
            hi = min(lo + _FORWARD_BATCH, n)
            sims, cand = sparse_ip_topk(
                self._doc_idx[lo:hi], self._doc_val[lo:hi], self._doc_idx, self._doc_val,
                dmask, topk=k, vocab=self._vocab,
            )
            fwd_s.append(sims)
            fwd_i.append(cand.int())
        fwd_i = torch.cat(fwd_i).cpu().numpy()
        fwd_s = torch.cat(fwd_s).cpu().numpy()
        t0 = _lap(times, "forward_knn", t0, dev)
        l0 = _reverse_merge_l0(fwd_i, fwd_s, n, m0)
        _lap(times, "reverse_merge", t0)
        return l0

    def _build_graph_clustered(self) -> np.ndarray:
        """Scalable kNN-graph candidates for 1M+ docs: every doc gets a dense
        twin via feature-hash signatures (`ops/sparse.sparse_signatures`,
        sig(a).sig(b) ~= a.b), and the dense engine's clustered machinery runs
        on them as it is: k-means buckets + top-2 spilled assignment
        (`assign_top2_blocked`) + per-bucket exact scoring (`bucket_knn_all`).
        Proposed candidates are re-scored with EXACT sparse dots, expanded one
        neighbour-of-neighbour round (NN-descent repair of signature noise and
        bucket-boundary misses), and reverse-merged.

        Reference analog: the posting-driven candidate
        generation (`src/core/algorithm/hnsw_sparse/`, streamer_entity ~1001)."""
        n, m0 = self._n, 2 * self.m
        k = min(m0 + 1, n)
        times = self.build_times
        dev = self._doc_idx.device
        t0 = time.perf_counter()

        sig = sparse_signatures(self._doc_idx, self._doc_val, _SIG_DIMS)[:n]
        sig_dev = _to_dev(sig, dev)
        norms_dev = _to_dev(np.einsum("ij,ij->i", sig, sig), dev)
        t0 = _lap(times, "signatures", t0, dev)

        rng = np.random.default_rng(0x5BA5)
        K = int(min(16384, max(64, n // 1250), n // 4))
        sub_n = min(262_144, n)
        sub = sig[rng.choice(n, sub_n, replace=False)]
        seeds = sig[rng.choice(n, K, replace=False)]
        cents, _ = lloyd(_to_dev(sub, dev), _to_dev(seeds, dev), iters=6, block=min(16384, sub_n))
        t0 = _lap(times, "kmeans", t0, dev)
        asn = assign_top2_blocked(sig_dev, cents, block=16384).cpu().numpy()
        t0 = _lap(times, "assign_top2", t0, dev)

        # bucket pack (host): primary + spill members, like the dense path
        sizes = np.bincount(asn[:, 0], minlength=K) + np.bincount(asn[:, 1], minlength=K)
        mp = int(min(8192, max(256, -(-int(np.percentile(sizes, 98)) // 128) * 128)))
        rows_bkt = np.full((K, mp), -1, np.int32)
        slot_bkt = np.zeros((K, mp), np.int32)
        fill = np.zeros(K, np.int64)
        for s in (0, 1):
            order = np.argsort(asn[:, s], kind="stable")
            clusters = asn[order, s]
            bounds = np.searchsorted(clusters, np.arange(K + 1))
            for c in range(K):
                lo, hi = bounds[c], bounds[c + 1]
                take = min(hi - lo, mp - fill[c])
                if take <= 0:
                    continue
                rows_bkt[c, fill[c] : fill[c] + take] = order[lo : lo + take]
                slot_bkt[c, fill[c] : fill[c] + take] = s
                fill[c] += take
        t0 = _lap(times, "bucket_pack", t0)

        kc = max(32, min(64, m0))
        cand = torch.full((n + 1, 2 * kc), -1, dtype=torch.int32, device=dev)
        for lo in range(0, K, _BUCKET_CHUNK):
            cand = bucket_knn_all(
                _to_dev(rows_bkt[lo : lo + _BUCKET_CHUNK], dev),
                _to_dev(slot_bkt[lo : lo + _BUCKET_CHUNK], dev),
                cand, sig_dev, norms_dev, metric=MetricType.IP, kc=kc,
            )
        cand_host = cand[:n].cpu().numpy()
        del cand, sig_dev, norms_dev
        t0 = _lap(times, "bucket_knn", t0, dev)
        self.build_info = {
            "clustered": True, "K": K, "mp": mp, "kc": kc,
            "dropped": int(sizes.sum() - fill.sum()),
        }

        # exact sparse rescore of the signature-proposed candidates, then
        # one neighbour-of-neighbour expansion round re-scored the same way
        fwd_i, fwd_s = self._rescore_topk_batched(cand_host, k)
        t0 = _lap(times, "rescore", t0, dev)
        # candidates = own edges U edges of the `expand` best neighbours
        expand = min(2, fwd_i.shape[1])
        nn2 = [
            np.where(fwd_i[:, e : e + 1] >= 0, fwd_i[np.clip(fwd_i[:, e], 0, None)], -1)
            for e in range(expand)
        ]
        fwd_i, fwd_s = self._rescore_topk_batched(np.concatenate([fwd_i] + nn2, axis=1), k)
        t0 = _lap(times, "expansion_round", t0, dev)
        l0 = _reverse_merge_l0(fwd_i, fwd_s, n, m0)
        t0 = _lap(times, "reverse_merge", t0)

        # Entry coverage: a kNN graph over well-separated topic clusters is
        # DISCONNECTED, and random entry probes miss whole clusters
        # (P(no entry in a 1/T-mass cluster) = (1-1/T)^probes). The per-cluster
        # medoids (member with the highest signature dot to its primary
        # centroid) are the entry hint; _rebuild probes these instead of
        # random rows. Teleport edges in the last 2 slots give the beam an
        # escape hatch (dense-build recipe).
        cents_h = cents.cpu().numpy()
        med_score = np.einsum("ij,ij->i", sig, cents_h[asn[:, 0]])
        order = np.argsort(asn[:, 0], kind="stable")
        bounds = np.searchsorted(asn[order, 0], np.arange(K + 1))
        medoids, csizes = [], []
        for c in range(K):
            lo, hi = bounds[c], bounds[c + 1]
            if hi <= lo:
                continue
            members = order[lo:hi]
            medoids.append(members[np.argmax(med_score[members])])
            csizes.append(hi - lo)
        med = np.asarray(medoids, np.int32)
        # biggest clusters first; cap the probe set
        self._entry_hint = med[np.argsort(-np.asarray(csizes))][: max(_ENTRY_PROBES, 128)]
        if n > 2048 and m0 >= 8 and l0.shape[1] >= 4:
            rng_t = np.random.default_rng(0x5BA6)
            rand = (np.arange(n, dtype=np.int64)[:, None] + rng_t.integers(1, n, (n, 2))) % n
            l0[:, -2:] = rand.astype(np.int32)
        _lap(times, "medoids", t0)
        return l0

    def _rescore_topk_batched(self, cand_host: np.ndarray, k: int):
        """EXACT sparse top-k over proposed candidates, batched on the device:
        (n, C) candidate ids -> (fwd_i (n, k), fwd_s (n, k)), best first,
        repeated ids and the node itself dropped. The batches' results stay
        on the device and are copied to the host once."""
        n = cand_host.shape[0]
        doc_idx, doc_val = self._doc_idx, self._doc_val
        dev = doc_idx.device
        cand_dev = _to_dev(cand_host, dev)
        out_s, out_i = [], []
        for lo in range(0, n, _RESCORE_BATCH):
            node_ids = torch.arange(lo, min(lo + _RESCORE_BATCH, n), device=dev)
            cand_ids = cand_dev[node_ids].long()
            safe = cand_ids.clamp_min(0)
            sims = sparse_ip_rows(
                doc_idx[node_ids], doc_val[node_ids], doc_idx[safe], doc_val[safe],
                vocab=self._vocab,
            )
            valid = (cand_ids >= 0) & (cand_ids != node_ids[:, None])
            sims = torch.where(valid, sims, NEG_INF)
            order = torch.sort(-sims, dim=1, stable=True).indices
            ids_o = cand_ids.gather(1, order)
            sims_o = sims.gather(1, order)
            keep = (sims_o > NEG_INF / 2) & ~_dup_mask(ids_o)
            sims_o = torch.where(keep, sims_o, NEG_INF)
            ids_o = torch.where(keep, ids_o, -1)
            # kept-first re-compaction: duplicates were voided above, so the
            # top-k slice must skip them, not count them
            rank = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
            out_i.append(ids_o.gather(1, rank)[:, :k].int())
            out_s.append(sims_o.gather(1, rank)[:, :k])
        fwd_i = np.full((n, k), -1, np.int32)
        fwd_s = np.full((n, k), NEG_INF, np.float32)
        got_i, got_s = torch.cat(out_i).cpu().numpy(), torch.cat(out_s).cpu().numpy()
        fwd_i[:, : got_i.shape[1]] = got_i  # fewer than k candidates: the rest stays empty
        fwd_s[:, : got_s.shape[1]] = got_s
        return fwd_i, fwd_s

    def _queries_from_rows(self, rows):
        """The beam's query arrays: padded like the flat scan's, never pruned."""
        return self._prep_query_arrays(rows, None)

    # ------------- search -------------
    def search(self, queries, topk, mask=None, param=None):
        self._ensure_fresh()
        if isinstance(queries, dict):
            queries = [queries]
        nq = len(queries)
        is_linear = bool(getattr(param, "is_linear", False))
        if self._l0 is None or is_linear or self._n < _BRUTE_FORCE_THRESHOLD:
            return super().search(queries, topk, mask, param)

        self.stats.search_count += 1
        self.stats.queries_served += nq
        t0 = time.perf_counter()
        ef = getattr(param, "ef", 300) if param is not None else 300
        ef = max(ef, topk)
        q_idx, q_val = self._queries_from_rows(queries)
        dmask = self.device_mask(mask)
        dev = None if self._smesh is not None else self._doc_idx.device
        k = min(topk, self._n)
        if self._smesh is not None:
            from ..parallel.mesh import sharded_sparse_beam

            R = self._n_pad // self._smesh.shape["corpus"]
            sims, idx = sharded_sparse_beam(
                self._smesh,
                torch.from_numpy(q_idx),
                torch.from_numpy(q_val),
                self._doc_idx,
                self._doc_val,
                self._l0,
                self._entries,
                dmask,
                min(max(10000, int(0.1 * R)), R),  # per shard
                ef=ef,
                topk=k,
                max_steps=ef + 64,
                vocab=self._vocab,
                frontier=4,
            )
        else:
            sims, idx = hnsw_sparse_search(
                torch.from_numpy(q_idx).to(dev),
                torch.from_numpy(q_val).to(dev),
                self._doc_idx,
                self._doc_val,
                self._l0,
                self._entries,
                dmask,
                min(max(10000, int(0.1 * self._n)), self._n),
                ef=ef,
                topk=k,
                max_steps=ef + 64,
                vocab=self._vocab,
                frontier=4,
            )
        sims = sims[:nq].cpu().numpy()
        idx = idx[:nq].cpu().numpy()
        if mask is not None:
            # same safety net as dense HNSW: the ef-capped beam can strand
            # inside the query's neighbourhood when the filter excludes it;
            # deficient queries get an exact masked scan over the SAME
            # (unpruned) query arrays the beam used
            sims, idx = rescan_deficient(
                sims, idx, k, np.asarray(mask)[: self._n],
                lambda: self._exact_scan(q_idx, q_val, dmask, k),
            )
        sims, idx = self._pad_results(sims, idx, topk)
        self.stats.total_search_secs += time.perf_counter() - t0
        return sims, idx

    # ------------- persistence -------------
    def dump_aux(self, directory, prefix):
        if self._l0 is None:
            self._ensure_fresh()
        if self._aux_l0 is None:
            return {}
        t0 = time.perf_counter()
        fname = f"hnsw_sparse_{prefix}.npz"
        payload = {"n": np.int64(self._n), "l0": self._aux_l0}
        if self._smesh is not None:
            # sharded layout: l0 holds per-shard LOCAL ids over the padded
            # rows; a reopen under another shard count rebuilds instead
            payload["shards"] = np.int64(self._smesh.shape["corpus"])
            payload["entries"] = self._aux_entries
        elif self._entry_hint is not None and len(self._entry_hint):
            # clustered-build medoid entries must survive reopen: random
            # re-probes on a topic-clustered graph lose whole components
            payload["entries"] = np.asarray(self._entry_hint, np.int32)
        np.savez_compressed(os.path.join(directory, fname), **payload)
        self.build_times["dump_aux"] = time.perf_counter() - t0
        return {"file": fname, "type": "hnsw_sparse", "m": self.m}

    def load_aux(self, directory, descriptor):
        path = os.path.join(directory, descriptor.get("file", ""))
        if os.path.exists(path):
            self._loaded_aux = dict(np.load(path))
