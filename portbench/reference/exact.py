"""Exact top-k under squared L2, and the float64 distance of given rows.

`exact_topk` picks `k + EXTRA` candidates a query from float32 distances
(products with TF32 off) and ranks them by their float64 distances. The
float32 distances are off by ~1e-4 at most on these vectors (|q - x|^2 ~ 100
to 400), so a row of the true top-k leaves the candidates only where more
than EXTRA rows tie with it within that: the ranking is the float64 one.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

EXTRA = 22  # candidates beyond k a query re-ranked in float64
BLOCK_ELEMS = 1 << 28  # float32 distances held at once (1 GiB)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products on or off for the duration."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties away), as
    the card's tensor cores take their inputs; used where no card is."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def sq_l2_f32(q: torch.Tensor, x: torch.Tensor, xn: torch.Tensor, tf32_products: bool = False) -> torch.Tensor:
    """(Q, N) float32 squared distances |q|^2 + |x|^2 - 2 q.x. With
    `tf32_products` the product q.x runs in TF32: on the card's tensor
    cores, and emulated by rounding the inputs on the CPU."""
    if tf32_products and q.device.type != "cuda":
        prod = round_tf32(q) @ round_tf32(x).T
    else:
        with tf32(tf32_products):
            prod = q @ x.T
    return (q * q).sum(1, keepdim=True) + xn[None, :] - 2.0 * prod


def sq_l2_f64(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Float64 squared distances of q (Q, D) to rows (Q, C, D)."""
    diff = rows.double() - q.double()[:, None, :]
    return (diff * diff).sum(-1)


def exact_topk(
    x: torch.Tensor, q: torch.Tensor, k: int, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k rows of x (N, D) for each query of q (Q, D) under
    squared L2, among the rows where `mask` (N,) is True: float64 distances
    ascending (Q, k) and row ids (Q, k), -1 past the rows the mask keeps."""
    n = x.shape[0]
    c = min(k + EXTRA, n)
    xn = (x * x).sum(1)
    block = max(1, BLOCK_ELEMS // n)
    out_d, out_i = [], []
    for lo in range(0, q.shape[0], block):
        qb = q[lo : lo + block]
        d = sq_l2_f32(qb, x, xn)
        if mask is not None:
            d.masked_fill_(~mask[None, :], float("inf"))
        cand = torch.topk(d, c, dim=1, largest=False).indices
        valid = torch.gather(d, 1, cand).isfinite()
        d64 = sq_l2_f64(qb, x[cand])
        d64 = torch.where(valid, d64, torch.full_like(d64, float("inf")))
        d64, order = torch.sort(d64, dim=1, stable=True)
        ids = torch.gather(cand, 1, order)
        d64, ids = d64[:, :k], ids[:, :k]
        ids = torch.where(d64.isfinite(), ids, torch.full_like(ids, -1))
        out_d.append(d64)
        out_i.append(ids)
    return torch.cat(out_d), torch.cat(out_i)


def row_distances(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Float64 squared distance of each query (Q, D) to each of its rows
    ids (Q, k); NaN where the id is not a row of x."""
    n = x.shape[0]
    ok = (ids >= 0) & (ids < n)
    d = sq_l2_f64(q, x[torch.where(ok, ids, torch.zeros_like(ids))])
    return torch.where(ok, d, torch.full_like(d, float("nan")))
