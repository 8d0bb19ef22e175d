"""Dense distance matrices in PyTorch.

Port of `zvec_tpu/ops/distance.py`: every metric reduces to one float32
matrix product (queries x codes^T) plus an elementwise epilogue. TF32 is off
(`ops/runtime.py`), so products on the card keep full float32.

Score conventions (must match the reference oracles in
`python/tests/detail/distance_helper.py:58-115`):
  - L2     -> SQUARED euclidean distance, ascending (smaller = closer)
  - COSINE -> 1 - cosine_similarity, ascending
  - IP     -> raw dot product, DESCENDING (larger = closer)

Internally every search works on a uniform "similarity" (larger = better):
  IP: dot; L2: -squared_l2; COSINE: cosine_similarity.
`similarity_to_score` converts back to user-facing scores at the boundary.
"""

from __future__ import annotations

import torch

from ..typing.enum import MetricType

__all__ = [
    "ip_matrix",
    "squared_l2_matrix",
    "l2_norms",
    "unpack_nibbles",
    "similarity_matrix",
    "similarity_to_score",
    "score_to_similarity",
]


def l2_norms(x: torch.Tensor) -> torch.Tensor:
    """Squared L2 norm of each row. (N, D) -> (N,)."""
    x = x.float()
    return (x * x).sum(-1)


def unpack_nibbles(x: torch.Tensor):
    """Packed int4 bytes -> (lo, hi) sign-extended int32 nibble planes
    (low nibble = even element, `zvec_tpu/ops/quantize.py::pack_int4`)."""
    c = x.to(torch.int32)
    lo = ((c & 0xF) ^ 8) - 8
    hi = c >> 4  # arithmetic shift: the high nibble keeps the byte's sign
    return lo, hi


def ip_matrix(
    q: torch.Tensor,
    x: torch.Tensor,
    dequant: tuple | None = None,
    int4_packed: bool = False,
) -> torch.Tensor:
    """Inner products: (Q, D) x (N, D) -> (Q, N).

    `dequant=(scale, bias)` scores float queries against affine-quantized
    integer codes without materializing dequantized vectors:
      dot(q, c*scale + bias) = scale * dot(q, c) + bias * sum(q).

    `int4_packed`: `x` holds two int4 codes per byte ((N, ceil(D/2)) int8,
    low nibble = even element), scored as
      dot(q, c) = dot(q_even, lo_nibbles) + dot(q_odd, hi_nibbles).
    """
    q = q.float()
    if int4_packed:
        lo, hi = unpack_nibbles(x)
        d2 = x.shape[-1]
        q_even = q[:, 0 : 2 * d2 : 2]
        q_odd = q[:, 1 : 2 * d2 : 2]
        if q_odd.shape[1] < d2:  # odd logical D: pad-query column is zero
            q_odd = torch.nn.functional.pad(q_odd, (0, d2 - q_odd.shape[1]))
        dots = q_even @ lo.float().T + q_odd @ hi.float().T
    else:
        dots = q @ x.float().T
    if dequant is not None:
        scale, bias = dequant
        dots = float(scale) * dots + float(bias) * q.sum(-1, keepdim=True)
    return dots


def squared_l2_matrix(
    q: torch.Tensor,
    x: torch.Tensor,
    x_sq_norms: torch.Tensor | None = None,
    dequant: tuple | None = None,
    int4_packed: bool = False,
) -> torch.Tensor:
    """Squared euclidean distances: ||q||^2 + ||x||^2 - 2 q.x -> (Q, N).
    With `dequant`, `x_sq_norms` must be the norms of the DEQUANTIZED codes."""
    if x_sq_norms is None:
        assert not int4_packed, "packed int4 codes require precomputed norms"
        x_sq_norms = l2_norms(x)
    q_sq = l2_norms(q)
    dots = ip_matrix(q, x, dequant, int4_packed)
    d = q_sq[:, None] + x_sq_norms.float()[None, :] - 2.0 * dots
    return torch.clamp_min(d, 0.0)


def _cosine_similarity_matrix(q, x, x_sq_norms=None, dequant=None, int4_packed=False):
    if x_sq_norms is None:
        assert not int4_packed, "packed int4 codes require precomputed norms"
        x_sq_norms = l2_norms(x)
    q_sq = l2_norms(q)
    dots = ip_matrix(q, x, dequant, int4_packed)
    denom = torch.sqrt(q_sq)[:, None] * torch.sqrt(x_sq_norms.float())[None, :]
    # zero-magnitude convention: similarity 1 => distance 0
    # (`distance_helper.py:73-74` returns 0.0 when either magnitude is 0)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, dots / safe, torch.ones_like(dots))


def similarity_matrix(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: MetricType,
    x_sq_norms: torch.Tensor | None = None,
    dequant: tuple | None = None,
    int4_packed: bool = False,
) -> torch.Tensor:
    """Uniform larger-is-better similarity for any metric: (Q, N)."""
    metric = MetricType(metric)
    if metric == MetricType.IP:
        return ip_matrix(q, x, dequant, int4_packed)
    if metric == MetricType.L2:
        return -squared_l2_matrix(q, x, x_sq_norms, dequant, int4_packed)
    if metric == MetricType.COSINE:
        return _cosine_similarity_matrix(q, x, x_sq_norms, dequant, int4_packed)
    if metric == MetricType.HAMMING:
        # q and x arrive as ±1 vectors (engines unpack bit codes; see
        # quantize.bits_to_pm1): hamming = ||q - x||^2 / 4
        return -squared_l2_matrix(q, x, x_sq_norms, dequant, int4_packed) * 0.25
    raise ValueError(f"unsupported metric {metric}")


def similarity_to_score(sim, metric: MetricType):
    """Convert internal similarity back to the user-facing score convention
    (numpy arrays and tensors alike)."""
    metric = MetricType(metric)
    if metric == MetricType.IP:
        return sim
    if metric in (MetricType.L2, MetricType.HAMMING):
        return -sim  # squared L2 / hamming distance, ascending
    if metric == MetricType.COSINE:
        return 1.0 - sim  # cosine distance
    raise ValueError(f"unsupported metric {metric}")


def score_to_similarity(score, metric: MetricType):
    metric = MetricType(metric)
    if metric == MetricType.IP:
        return score
    if metric in (MetricType.L2, MetricType.HAMMING):
        return -score
    if metric == MetricType.COSINE:
        return 1.0 - score
    raise ValueError(f"unsupported metric {metric}")
