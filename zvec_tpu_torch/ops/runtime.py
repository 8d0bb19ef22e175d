"""Device and padding helpers shared by the device ops.

Float32 products stay float32 on the card: TF32 keeps about three decimal
digits, and exact search needs full-precision scores (the torch form of the
JAX package's `Precision.HIGHEST` rule).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "device",
    "round_up",
    "cdiv",
    "NEG_INF",
    "QUERY_BUCKETS",
    "bucket_queries",
    "topk_desc",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Query batches pad to these row counts so every engine sees a few distinct
# batch shapes (kept from `zvec_tpu/ops/runtime.py` so both packages pad alike).
QUERY_BUCKETS = (1, 8, 32, 128, 512)

NEG_INF = float(np.finfo(np.float32).min)  # large-negative sentinel, avoids NaN from inf-inf


@functools.cache
def device() -> torch.device:
    """The device that holds engine state: the first CUDA card, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def bucket_queries(nq: int) -> int:
    for b in QUERY_BUCKETS:
        if nq <= b:
            return b
    return round_up(nq, QUERY_BUCKETS[-1])


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def topk_desc(x: torch.Tensor, k: int):
    """Top-k along the last axis, largest first, ties to the lower index
    (the order `lax.top_k` gives, so both packages rank ties alike)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
