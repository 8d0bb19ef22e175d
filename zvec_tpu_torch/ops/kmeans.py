"""K-means on the card: kmeans++ seeding, then Lloyd iterations as products.

Port of `zvec_tpu/ops/kmeans.py` (reference `KmeansCluster` with kmeans++
seeding, `src/core/algorithm/cluster/kmeans_cluster.cc:29-108`). Assignment
is one (block, D) x (D, K) product per block of rows; the centroid update is
a one-hot product summed block by block in a fixed order. It is deliberately
not `index_add_` / `scatter_add_`: on CUDA those sum through atomics in no
fixed order, and two trainings on one card would give different centroids.
Seeding runs on the host in numpy, draw for draw as in the JAX package, so
one `rng` gives the same seeds in both.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .distance import squared_l2_matrix
from .hnsw import assign_top2_blocked
from .runtime import device

__all__ = ["kmeanspp_seed", "lloyd", "assign", "assign_top2", "stratified_train"]


def kmeanspp_seed(
    data: np.ndarray, k: int, rng: np.random.Generator, sample: int = 16384
) -> np.ndarray:
    """kmeans++ seeding on a subsample (the role of the reference's K-MC²
    approximate seeding — both avoid full-corpus D² sampling)."""
    n = data.shape[0]
    if n > sample:
        idx = rng.choice(n, sample, replace=False)
        pts = data[idx].astype(np.float32)
    else:
        pts = data.astype(np.float32)
    m = pts.shape[0]
    k = min(k, m)
    centroids = np.empty((k, pts.shape[1]), dtype=np.float32)
    centroids[0] = pts[rng.integers(m)]
    d2 = ((pts - centroids[0]) ** 2).sum(1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centroids[i] = pts[rng.choice(m, p=probs)]
        d2 = np.minimum(d2, ((pts - centroids[i]) ** 2).sum(1))
    return centroids


def lloyd(
    data: torch.Tensor, centroids: torch.Tensor, iters: int = 10, block: int = 65536
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iters` Lloyd iterations, blocked over N so the (N, K) distance matrix
    never materializes. Empty clusters keep their centroid. Returns
    (centroids (K, D) f32, assigns (N,) int64) on the device of `data`.
    `lloyd.calls` counts the calls (a reopened index must not retrain)."""
    lloyd.calls += 1
    data = data.float()
    cents = centroids.to(device=data.device, dtype=torch.float32)
    n, d = data.shape
    k = cents.shape[0]
    block = min(block, n)
    for _ in range(iters):
        sums = torch.zeros((k, d), dtype=torch.float32, device=data.device)
        counts = torch.zeros((k,), dtype=torch.float32, device=data.device)
        for lo in range(0, n, block):
            x = data[lo : lo + block]
            a = torch.argmin(squared_l2_matrix(x, cents), dim=1)
            one_hot = (a[:, None] == torch.arange(k, device=a.device)).float()
            sums = sums + one_hot.T @ x
            counts = counts + one_hot.sum(0)
        cents = torch.where(
            counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), cents
        )
    return cents, assign(data, cents, block)


lloyd.calls = 0


def stratified_train(
    data: np.ndarray,
    k: int,
    rng: np.random.Generator,
    iters: int = 10,
) -> np.ndarray:
    """Two-level stratified k-means (reference `StratifiedCluster`,
    `src/core/algorithm/cluster/`): cluster into ~sqrt(k) coarse strata, then
    train centroids within each stratum proportionally to its mass. Cheaper
    than flat k-means at large K and gives better-balanced lists. The Lloyd
    passes run on `device()`."""
    dev = device()
    n = data.shape[0]
    k = min(k, n)
    k1 = max(int(np.sqrt(k)), 1)
    coarse_seeds = kmeanspp_seed(data, k1, rng)
    _, assign1 = lloyd(
        torch.tensor(data, device=dev),
        torch.from_numpy(coarse_seeds),
        iters=max(iters // 2, 2),
    )
    assign1 = assign1.cpu().numpy()
    counts = np.bincount(assign1, minlength=k1).astype(np.float64)
    # allocate fine centroids proportionally (>=1 per non-empty stratum)
    alloc = np.maximum((counts / max(counts.sum(), 1) * k).astype(np.int64), 1)
    alloc[counts == 0] = 0
    while alloc.sum() > k:
        alloc[np.argmax(alloc)] -= 1
    while 0 < alloc.sum() < k:
        alloc[np.argmax(counts - alloc)] += 1
    out = []
    for s in range(k1):
        if alloc[s] == 0:
            continue
        pts = data[assign1 == s]
        if len(pts) == 0:
            continue
        if alloc[s] == 1 or len(pts) <= alloc[s]:
            out.append(pts[: max(int(alloc[s]), 1)])
            continue
        seeds = kmeanspp_seed(pts, int(alloc[s]), rng)
        fine, _ = lloyd(
            torch.from_numpy(pts).to(dev),
            torch.from_numpy(seeds),
            iters=max(iters // 2, 2),
        )
        out.append(fine.cpu().numpy())
    cents = np.concatenate(out, axis=0)[:k]
    if len(cents) < k:  # top up from data points
        extra = data[rng.choice(n, k - len(cents), replace=False)]
        cents = np.concatenate([cents, extra], axis=0)
    return cents.astype(np.float32)


def assign(data: torch.Tensor, centroids: torch.Tensor, block: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment (N,) int64, ties to the lower index,
    blocked over N."""
    data = data.float()
    cents = centroids.to(device=data.device, dtype=torch.float32)
    return torch.cat(
        [
            torch.argmin(squared_l2_matrix(data[lo : lo + block], cents), dim=1)
            for lo in range(0, data.shape[0], block)
        ]
    )


def assign_top2(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Two nearest centroids per point (N, 2) int32 — the spilled assignment
    behind the reference's `use_soar` option (`index_params.h:252-258`),
    through the blocked top-2 of `ops/hnsw.py`."""
    return assign_top2_blocked(data, centroids, block=16384)
