"""The least time of the useful work of an exact float32 scan under a filter:
the top-k of the queries among the rows the filter keeps.

The larger of

- operations: 3 x 2*Q*N_pass*D FLOP (the exact float32 product as three TF32
  passes) at the TF32 tensor-core peak;
- bytes: the passing rows' codes (N_pass*D*4) and norms (N_pass*4), the row
  mask (N*1), the queries (Q*D*4) read once, and the (Q, k) scores and ids
  (4 + 4 bytes) written once, at the memory rate.

N_pass is counted by the harness from the call's filter on the generators'
fields, N is the rows of the collection, so the least time reads the same
whether an implementation scans every row or only the passing ones. With
every row passing it is `roofline/flat_scan.py`'s.
"""

from __future__ import annotations

from .. import peaks


def least_time(nq: int, n_pass: int, n: int, dim: int, k: int) -> dict:
    flop = 3 * 2.0 * nq * n_pass * dim
    nbytes = n_pass * dim * 4 + n_pass * 4 + n + nq * dim * 4 + nq * k * 8
    t_ops = flop / peaks.TF32_FLOPS
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    return {"seconds": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": nbytes}
