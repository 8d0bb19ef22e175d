"""Multi-GPU scale-out: corpus sharding over a grid of devices.

Port of `zvec_tpu/parallel/mesh.py` (the reference's only parallelism is
intra-process threads + per-segment Acero plans, SURVEY §2.9; the scale-out
axis here is corpus size). One process drives every device, as the JAX
package's single controller drives its mesh: a sealed segment's rows split
into S contiguous shards, shard j's tensors live on its device, every shard
runs the port's own single-device search on them (the fused flat scan, the
beam, the IVF probe, the sparse scan or beam), and the per-shard top-k go to
one merge device (`Tensor.to`, a peer copy between cards), where `merge_topk`
keeps the best k. Shards are concatenated shard-major, so equal scores go to
the lower shard, as `lax.top_k` over the reference's all_gather gives them.
k-means sums and counts are one-hot products per shard, added in shard order
on the merge device (no atomics, so a step is repeatable on the card).

A `Mesh` is a (batch, corpus) grid of `torch.device`s: query batches split
over 'batch', corpus rows over 'corpus'. Shards run one after another; on one
card that is all there is, and on several cards the host-synced beams
serialize across them.

Deliberate difference: the reference's `collection_mesh()` returns None
(unsharded) when fewer than N devices exist. Here N shards are placed
round-robin over the cards there are (several shards on one card, or all of
them on the CPU when `ZVEC_TORCH_DEVICE=cpu` asks for it), so
`init(mesh_devices=N)` always shards.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.runtime import device as runtime_device
from ..ops.topk import merge_topk
from ..typing.enum import MetricType

__all__ = [
    "Mesh",
    "make_mesh",
    "collection_mesh",
    "corpus_sharding",
    "shard_rows",
    "sharded_flat_search",
    "sharded_hnsw_search",
    "sharded_ivf_probe",
    "sharded_sparse_topk",
    "sharded_sparse_beam",
    "sharded_kmeans_step",
]

_FLAT_BLOCK = 131072  # rows per step of the blockwise shard scan (the FLAT engine's)


class Mesh:
    """A (batch, corpus) grid of torch devices. `shape` reads like the JAX
    mesh's (`mesh.shape["corpus"]`); corpus shard j lives on `devices[j]`,
    and per-shard results merge on `merge_device`."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid = [[torch.device(d) for d in row] for row in grid]
        if not self.grid or not self.grid[0] or len({len(r) for r in self.grid}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {"batch": len(self.grid), "corpus": len(self.grid[0])}

    @property
    def devices(self) -> List[torch.device]:
        """The device of each corpus shard (the grid's first batch row)."""
        return self.grid[0]

    @property
    def merge_device(self) -> torch.device:
        return self.grid[0][0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for row in self.grid for d in row]})"


def make_mesh(
    n_devices: Optional[int] = None, batch_axis: int = 1, device=None
) -> Mesh:
    """2D mesh ('batch', 'corpus') of `n_devices` slots. Slot j takes
    `cuda:{j % device_count}`; every slot is the CPU only when
    `ZVEC_TORCH_DEVICE=cpu` asks for it, and with no card and no such request
    this raises (`ops/runtime.device`). `device` pins every slot to one
    device."""
    if device is not None:
        devs = [torch.device(device)]
    elif runtime_device().type == "cpu":
        devs = [runtime_device()]
    else:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = n_devices or len(devs)
    if batch_axis < 1 or n % batch_axis:
        raise ValueError(f"{n} devices do not split into {batch_axis} batch rows")
    corpus = n // batch_axis
    slots = [devs[j % len(devs)] for j in range(n)]
    return Mesh([slots[i * corpus : (i + 1) * corpus] for i in range(batch_axis)])


_collection_mesh_cache: dict = {}


def collection_mesh() -> Optional[Mesh]:
    """Collection-level mesh, governed by `GlobalConfig.mesh_devices`
    (`zvec_tpu_torch.init(mesh_devices=N)`). None when N <= 1. Engines
    consult it to split sealed segments into N corpus shards, so every query
    fans out over the shards and merges their top-k (the analog of the
    reference's per-segment plan union, `query_planner.cc:344-448`)."""
    from ..utils.config import GlobalConfig

    n = int(getattr(GlobalConfig.instance(), "mesh_devices", 0) or 0)
    if n <= 1:
        return None
    if n not in _collection_mesh_cache:
        _collection_mesh_cache[n] = make_mesh(n, batch_axis=1)
    return _collection_mesh_cache[n]


def shard_rows(t, mesh: Mesh) -> List[torch.Tensor]:
    """Split a host array or a tensor into S contiguous row blocks of equal
    size; block j goes to shard j's device. The row count must divide by S
    (every engine pads its rows to a multiple of S first)."""
    s = mesh.shape["corpus"]
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    n = t.shape[0]
    if n % s:
        raise ValueError(f"{n} rows do not split into {s} shards")
    r = n // s
    return [t[j * r : (j + 1) * r].to(dev) for j, dev in enumerate(mesh.devices)]


def corpus_sharding(mesh: Mesh, ndim: int = 2):
    """The placement of corpus-sharded rows: a callable that splits an
    array's first axis over the shards (`shard_rows`), whatever its rank."""
    del ndim
    return functools.partial(shard_rows, mesh=mesh)


def _split(x, mesh: Mesh):
    """Per-shard list of `x`: a global array or tensor is split by rows, a
    list or tuple is already one entry per shard, None stays None."""
    if x is None:
        return [None] * mesh.shape["corpus"]
    if isinstance(x, (list, tuple)):
        return list(x)
    return shard_rows(x, mesh)


def _to(dev: torch.device, x):
    """Move a tensor, or a list of them, to `dev` (None stays None)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [_to(dev, v) for v in x]
    return x.to(dev)


def _query_blocks(q, mesh: Mesh) -> List[torch.Tensor]:
    """The query batch split over the 'batch' axis (Q must divide by it)."""
    if isinstance(q, np.ndarray):
        q = torch.from_numpy(np.ascontiguousarray(q))
    b = mesh.shape["batch"]
    if q.shape[0] % b:
        raise ValueError(f"{q.shape[0]} queries do not split into {b} batch rows")
    return list(torch.chunk(q, b)) if b > 1 else [q]


def _fan_out(mesh: Mesh, queries, topk: int, shard_fn, *more_queries):
    """Run `shard_fn(j, dev, q_block, *more)` -> (sims, global ids) on every
    corpus shard for every batch block, merge each block's per-shard top-k
    on its merge device, and stack the blocks on the mesh's merge device."""
    blocks = list(zip(*[_query_blocks(x, mesh) for x in (queries,) + more_queries]))
    out_s, out_i = [], []
    for i, qb in enumerate(blocks):
        parts_s, parts_i = [], []
        for j, dev in enumerate(mesh.grid[i]):
            res = shard_fn(j, dev, *[_to(dev, x) for x in qb])
            if res is None:  # an empty shard contributes nothing
                continue
            parts_s.append(res[0].to(mesh.grid[i][0]))
            parts_i.append(res[1].to(mesh.grid[i][0]))
        m_s, m_i = merge_topk(parts_s, parts_i, topk)
        out_s.append(m_s.to(mesh.merge_device))
        out_i.append(m_i.to(mesh.merge_device))
    if len(out_s) == 1:
        return out_s[0], out_i[0]
    return torch.cat(out_s), torch.cat(out_i)


def _offset(ids: torch.Tensor, base: int) -> torch.Tensor:
    """Local shard rows -> global rows; -1 stays -1."""
    return torch.where(ids >= 0, ids.long() + base, -1)


def sharded_flat_search(
    mesh: Mesh,
    queries,  # (Q, D); Q divisible by the batch axis
    codes,  # (N, D) global, or one (R, D) tensor per shard
    metric: MetricType,
    topk: int,
    mask=None,  # (N,) bool (or per shard)
    x_sq_norms=None,  # (N,) f32 (or per shard)
    dequant: Optional[Tuple[float, float]] = None,
    int4_packed: bool = False,
    exact_tf32: bool = False,  # +-1 codes: the kernel's one-pass product
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sharded top-k: every shard scans its rows with the FLAT engine's
    own scan (the fused CUDA kernel where the single-device rule takes it:
    codes on the card, R % 1024 == 0, R >= 100,000, k <= 32; the blockwise
    torch scan elsewhere), then the per-shard top-k merge. Returns (sims
    (Q, topk) desc, global row ids, -1 padded). Every storage type of the
    FLAT engine: fp32 / fp16 / int8 / packed int4 with the dequant epilogue."""
    from ..core.flat import kernel_takes
    from ..ops.flat_scan import flat_scan_topk
    from ..ops.topk import blockwise_topk_search

    codes_s = _split(codes, mesh)
    mask_s = _split(mask, mesh)
    norms_s = _split(x_sq_norms, mesh)
    r = codes_s[0].shape[0]
    k = min(topk, r)

    def scan(j, dev, q):
        c, m, nr = codes_s[j].to(dev), _to(dev, mask_s[j]), _to(dev, norms_s[j])
        if nr is not None and kernel_takes(c, dequant, r, k):
            kn = torch.sqrt(nr) if metric == MetricType.COSINE else nr  # ||x|| for cosine
            m8 = m.to(torch.int8) if m is not None else torch.ones(r, dtype=torch.int8, device=dev)
            s, i = flat_scan_topk(
                q, c, kn, m8, metric=metric, topk=k, dequant=dequant,
                int4_dim=q.shape[1] if int4_packed else None, exact_tf32=exact_tf32,
            )
        else:
            s, i = blockwise_topk_search(
                q, c, metric, k, mask=m, x_sq_norms=nr, block_size=_FLAT_BLOCK,
                dequant=dequant, int4_packed=int4_packed,
            )
        return s, _offset(i, j * r)

    return _fan_out(mesh, queries, topk, scan)


def _levels_per_shard(arrays, mesh: Mesh, per_shard: bool):
    """Upper-level arrays as one list of levels per shard. The global form is
    the reference's: a tuple over levels of corpus-sharded arrays."""
    if per_shard:
        return [list(a) if a is not None else None for a in arrays]
    split = [shard_rows(a, mesh) for a in arrays]
    return [[lv[j] for lv in split] for j in range(mesh.shape["corpus"])]


def sharded_hnsw_search(
    mesh: Mesh,
    queries,  # (Q, D) f32
    codes,  # (S*R, D) contiguous global rows, or one (R, D) tensor per shard
    norms,  # (S*R,), or per shard
    l0_nbrs,  # (S*R, M0) per-shard LOCAL rows, or per shard
    upper_ids,  # per level (S*U_l,) local L0 ids; or per shard: a list over its levels
    upper_nbrs,  # per level (S*U_l, Mu) local level rows; or per shard
    upper_down,  # per level (S*U_l,) local rows one level down; or per shard
    entry_rows,  # (S*(L+1),) entry row per level; or per shard: (L_s+1,) rows
    mask,  # (S*R,) bool or None; or per shard
    scan_budget: int,  # per-shard budget
    dequant=None,
    *,
    metric: MetricType,
    ef: int,
    topk: int,
    max_steps: int,
    num_levels,  # int (the global form), or one int per shard
    frontier: int = 4,
    int4_packed: bool = False,
    visited_bits: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corpus-sharded HNSW search: every shard owns an independent subgraph
    over its contiguous global row range [j*R, (j+1)*R); each runs the
    batched beam (`ops/hnsw.py::hnsw_search`) on its own graph, then the
    per-shard top-k merge. The union of per-shard beams dominates one graph
    over the whole corpus at equal ef (each beam covers a smaller corpus).

    Two layouts: the reference's global one (tensors stacked over shards,
    every shard padded to one level count with pass-through levels), or one
    entry per shard in every graph argument (`codes` a list), where each
    shard keeps its own level count and an empty shard is None. A
    pass-through level scores the entry once and drops to the level below,
    so both give the same ids. Returns (sims (Q, topk) desc, GLOBAL row ids,
    -1 padded)."""
    from ..ops.hnsw import hnsw_search

    s_count = mesh.shape["corpus"]
    per_shard = isinstance(codes, (list, tuple))
    codes_s, norms_s = _split(codes, mesh), _split(norms, mesh)
    l0_s, mask_s = _split(l0_nbrs, mesh), _split(mask, mesh)
    uids = _levels_per_shard(upper_ids, mesh, per_shard)
    unbrs = _levels_per_shard(upper_nbrs, mesh, per_shard)
    udown = _levels_per_shard(upper_down, mesh, per_shard)
    if per_shard:
        entries = [None if e is None else [int(v) for v in e] for e in entry_rows]
        levels = list(num_levels) if isinstance(num_levels, (list, tuple)) else [num_levels] * s_count
    else:
        ent = np.asarray(entry_rows.cpu() if torch.is_tensor(entry_rows) else entry_rows)
        entries = [[int(v) for v in row] for row in ent.reshape(s_count, -1)]
        levels = [int(num_levels)] * s_count
    r = next(c.shape[0] for c in codes_s if c is not None)

    def beam(j, dev, q):
        if codes_s[j] is None:
            return None
        s, i = hnsw_search(
            q, codes_s[j].to(dev), norms_s[j].to(dev), l0_s[j].to(dev),
            _to(dev, uids[j]), _to(dev, unbrs[j]), _to(dev, udown[j]), entries[j],
            _to(dev, mask_s[j]), scan_budget, dequant,
            metric=metric, ef=ef, topk=topk, max_steps=max_steps,
            num_levels=levels[j], frontier=frontier, int4_packed=int4_packed,
            visited_bits=visited_bits,
        )
        return s, _offset(i, j * r)

    return _fan_out(mesh, queries, topk, beam)


def sharded_ivf_probe(
    mesh: Mesh,
    queries,  # (Q, D) f32
    centroids,  # (KV, D) virtual-list centroids, corpus-sharded (or per shard)
    lists_codes,  # (KV, L, D), corpus-sharded
    lists_norms,  # (KV, L)
    lists_ids,  # (KV, L) GLOBAL row ids (-1 pad)
    cent_valid,  # (KV,) bool: shard-pad dummy lists are False
    mask,  # (N,) bool or None, replicated (ids are global)
    dequant,
    *,
    metric: MetricType,
    nprobe: int,
    topk: int,
    int4_packed: bool = False,
    max_scan: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corpus-sharded IVF probe: the virtual lists split over the shards;
    every shard probes its local top-nprobe lists (the union covers the
    global top-nprobe, so recall >= the single-device probe) under the same
    per-shard `max_scan` budget, then the per-shard top-k merge. List ids
    are global rows, so no offset."""
    from ..core.ivf import ivf_probe_core

    cents_s, codes_s = _split(centroids, mesh), _split(lists_codes, mesh)
    norms_s, ids_s = _split(lists_norms, mesh), _split(lists_ids, mesh)
    valid_s = _split(cent_valid, mesh)

    def probe(j, dev, q):
        cents = cents_s[j].to(dev)
        return ivf_probe_core(
            q, cents, codes_s[j].to(dev), norms_s[j].to(dev), ids_s[j].to(dev),
            _to(dev, mask), dequant,
            metric=metric, nprobe=min(nprobe, cents.shape[0]), topk=topk,
            int4_packed=int4_packed, cent_valid=_to(dev, valid_s[j]), max_scan=max_scan,
        )

    return _fan_out(mesh, queries, topk, probe)


def sharded_sparse_topk(
    mesh: Mesh,
    q_idx,  # (Q, Pq) int32
    q_val,  # (Q, Pq) f32
    doc_idx,  # (N, P) int32, corpus-sharded (or per shard)
    doc_val,  # (N, P) f32
    mask,  # (N,) bool
    *,
    topk: int,
    vocab: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sharded sparse-IP top-k: every shard scans its padded rows
    (`ops/sparse.py::sparse_ip_topk`), then the per-shard top-k merge (the
    sparse analog of `sharded_flat_search`)."""
    from ..ops.sparse import sparse_ip_topk

    di_s, dv_s, m_s = _split(doc_idx, mesh), _split(doc_val, mesh), _split(mask, mesh)
    r = di_s[0].shape[0]
    k = min(topk, r)

    def scan(j, dev, qi, qv):
        s, i = sparse_ip_topk(
            qi, qv, di_s[j].to(dev), dv_s[j].to(dev), _to(dev, m_s[j]), topk=k, vocab=vocab
        )
        return s, _offset(i, j * r)

    return _fan_out(mesh, q_idx, topk, scan, q_val)


def sharded_sparse_beam(
    mesh: Mesh,
    q_idx,  # (Q, Pq)
    q_val,
    doc_idx,  # (N, P) corpus-sharded (or per shard)
    doc_val,
    l0_nbrs,  # (N, M0) per-shard LOCAL rows
    entry_ids,  # (S*E,) per-shard LOCAL entry rows
    mask,  # (N,) bool
    scan_budget: int,  # per-shard budget
    *,
    ef: int,
    topk: int,
    max_steps: int,
    vocab: int,
    frontier: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corpus-sharded sparse NSW beam: every shard owns an independent
    subgraph over its contiguous global row range and runs the sparse beam
    (`ops/hnsw_sparse.py::hnsw_sparse_search`) from its own entry rows, then
    the per-shard top-k merge."""
    from ..ops.hnsw_sparse import hnsw_sparse_search

    di_s, dv_s = _split(doc_idx, mesh), _split(doc_val, mesh)
    l0_s, e_s, m_s = _split(l0_nbrs, mesh), _split(entry_ids, mesh), _split(mask, mesh)
    r = di_s[0].shape[0]

    def beam(j, dev, qi, qv):
        s, i = hnsw_sparse_search(
            qi, qv, di_s[j].to(dev), dv_s[j].to(dev), l0_s[j].to(dev), e_s[j].to(dev),
            _to(dev, m_s[j]), scan_budget,
            ef=ef, topk=topk, max_steps=max_steps, vocab=vocab, frontier=frontier,
        )
        return s, _offset(i, j * r)

    return _fan_out(mesh, q_idx, topk, beam, q_val)


def sharded_kmeans_step(
    mesh: Mesh, data, centroids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration over the mesh: the rows split over every device of
    the grid (batch-major, as P(("batch", "corpus"))); each block assigns its
    rows and forms one-hot sums and counts, which add up in block order on
    the merge device; then the centroid update (an empty cluster keeps its
    centroid). Returns (new centroids (K, D), inertia ())."""
    from ..ops.distance import squared_l2_matrix

    if isinstance(data, np.ndarray):
        data = torch.from_numpy(np.ascontiguousarray(data))
    if isinstance(centroids, np.ndarray):
        centroids = torch.from_numpy(np.ascontiguousarray(centroids))
    slots = [d for row in mesh.grid for d in row]
    if data.shape[0] % len(slots):
        raise ValueError(f"{data.shape[0]} rows do not split over {len(slots)} devices")
    merge = mesh.merge_device
    cents = centroids.to(device=merge, dtype=torch.float32)
    k = cents.shape[0]
    sums = torch.zeros_like(cents)
    counts = torch.zeros(k, dtype=torch.float32, device=merge)
    inertia = torch.zeros((), dtype=torch.float32, device=merge)
    for x, dev in zip(torch.chunk(data, len(slots)), slots):
        x = x.to(device=dev, dtype=torch.float32)
        d2 = squared_l2_matrix(x, cents.to(dev))  # (n, K)
        a = torch.argmin(d2, dim=1)  # the first minimum, as jnp.argmin
        best = d2.gather(1, a[:, None])[:, 0]
        one_hot = (a[:, None] == torch.arange(k, device=dev)).float()
        sums = sums + (one_hot.T @ x).to(merge)
        counts = counts + one_hot.sum(0).to(merge)
        inertia = inertia + best.sum().to(merge)
    new = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), cents)
    return new, inertia
