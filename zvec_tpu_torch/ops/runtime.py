"""Device and padding helpers shared by the device ops.

Float32 products stay float32 on the card: TF32 keeps about three decimal
digits, and exact search needs full-precision scores (the torch form of the
JAX package's `Precision.HIGHEST` rule).

Engine state lives on the first CUDA card. The CPU is used only when the
caller asks for it with the environment variable `ZVEC_TORCH_DEVICE=cpu`,
which a process's subprocesses inherit; a machine that shows no card raises
instead of running the database on the CPU unasked.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

__all__ = [
    "DEVICE_ENV",
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


DEVICE_ENV = "ZVEC_TORCH_DEVICE"  # "cpu" or "cuda"; unset means "cuda"


@functools.cache
def device() -> torch.device:
    """The device that holds engine state: the first CUDA card, or the CPU
    when `ZVEC_TORCH_DEVICE=cpu` asks for it. Read once per process (the
    first engine fixes it). Raises RuntimeError when the card is wanted and
    none is visible, ValueError on another value."""
    want = os.environ.get(DEVICE_ENV, "cuda").strip().lower() or "cuda"
    if want == "cpu":
        return torch.device("cpu")
    if want != "cuda":
        raise ValueError(f"{DEVICE_ENV}={want!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "zvec_tpu_torch: no CUDA card is visible (torch.cuda.is_available() is "
            f"False). Set {DEVICE_ENV}=cpu to run on the CPU."
        )
    return torch.device("cuda")


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
