"""The least time of an exact float32 flat scan with its top-k.

Copied from `chip_smoke.py:559-572` (`_bound`) for float32 codes, without
its last term, the (tile, k, Q) winners that the port's stage one writes:
those are one implementation's, and the least time has to read the same
whatever implements the scan. The larger of

- operations: 3 x 2*Q*N*D FLOP (the exact float32 product as three TF32
  passes) at the TF32 tensor-core peak;
- bytes: the codes (N*D*4), norms (N*4), row mask (N*1) and queries
  (Q*D*4) read once, and the (Q, k) scores and ids (4 + 4 bytes) written
  once, at the memory rate.

N is the rows of the collection, not the port's padded rows.
"""

from __future__ import annotations

from .. import peaks


def least_time(nq: int, n: int, dim: int, k: int) -> dict:
    flop = 3 * 2.0 * nq * n * dim
    nbytes = n * dim * 4 + n * 4 + n + nq * dim * 4 + nq * k * 8
    t_ops = flop / peaks.TF32_FLOPS
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    return {"seconds": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": nbytes}
