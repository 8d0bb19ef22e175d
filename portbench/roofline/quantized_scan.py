"""The least time of an int8 flat scan that keeps each query's candidates
for a refine: the scan of a quantized FLAT index with its default overscan.

The larger of

- operations: 2 x 2*Q*N*D FLOP, two passes at the TF32 tensor-core peak.
  Int8 codes are exact in TF32, but TF32 rounds a float32 query to a 10-bit
  mantissa, which the configuration forbids ("the query is never
  quantized"): the query split into a TF32 high part and the TF32 rest,
  each against the exact codes, is the least that keeps it float32;
- bytes: the int8 codes (N*D), the norms (N*4) and the row mask (N*1) read
  once, the queries (Q*D*4) read once, and the (Q, refine * k) candidates'
  scores and ids (4 + 4 bytes) written once, at the memory rate.

N is the rows of the collection, not the port's padded rows. The refine
itself, on the host, is not in it.
"""

from __future__ import annotations

from .. import peaks
from ..reference.int8_refined import REFINE_FACTOR


def least_time(nq: int, n: int, dim: int, k: int, refine_factor: int = REFINE_FACTOR) -> dict:
    flop = 2 * 2.0 * nq * n * dim
    nbytes = n * dim + n * 4 + n + nq * dim * 4 + nq * refine_factor * k * 8
    t_ops = flop / peaks.TF32_FLOPS
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    return {"seconds": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": nbytes}
