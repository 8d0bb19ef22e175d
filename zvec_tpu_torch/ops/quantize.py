"""Quantization: train/encode/decode + dequant-fused scoring params.

Reference equivalents (`src/core/quantizer/`, `src/ailego/algorithm/
integer_quantizer.{h,cc}`):
  - IntegerQuantizerConverter/Reformer: int8/int4 codes with one global
    (scale, bias) pair trained on the corpus; queries stay float and score
    asymmetrically against codes (`quantized_integer_metric.cc`).
  - HalfFloatConverter: fp16 storage.
  - CosineConverter: L2-normalize (then optionally quantize) so cosine
    reduces to IP on unit vectors (`cosine_converter.cc:383-399`).
  - MipsConverter: MIPS -> L2 augmentation (`mips_converter.cc:657`).
  - BasicRefiner: re-score quantized candidates at full precision
    (`basic_refiner.cc:23`).

TPU-native shape: codes live in HBM in their storage dtype; dequantization is
fused into the MXU matmul epilogue (dot(q, c_int) * scale + bias * sum(q)),
so the scan never materializes dequantized vectors. The trainer clips to the
[lo, hi] quantile range instead of the reference's entropy histogram — same
role (outlier-robust range fit), simpler math.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..typing.enum import QuantizeType

__all__ = [
    "QuantParams",
    "train_quantizer",
    "encode",
    "decode",
    "storage_dtype",
    "pack_int4",
    "unpack_int4",
    "pack_bits",
    "unpack_bits",
    "binarize",
    "bits_to_pm1",
]


class QuantParams(NamedTuple):
    """Global affine dequant: x ~= code * scale + bias."""

    scale: float
    bias: float
    qtype: int  # QuantizeType value

    def to_dict(self):
        return {"scale": self.scale, "bias": self.bias, "qtype": int(self.qtype)}

    @classmethod
    def from_dict(cls, d):
        return cls(d["scale"], d["bias"], d["qtype"])


_RANGES = {
    QuantizeType.INT8: (-127, 127),
    QuantizeType.INT4: (-7, 7),
}


def storage_dtype(qtype: QuantizeType):
    qtype = QuantizeType(qtype)
    if qtype == QuantizeType.FP16:
        return np.float16
    if qtype in (QuantizeType.INT8, QuantizeType.INT4):
        return np.int8
    return np.float32


def train_quantizer(
    data: np.ndarray,
    qtype: QuantizeType,
    clip_quantile: float = 0.999,
    symmetric: bool = False,
) -> Optional[QuantParams]:
    """Fit the global (scale, bias) on corpus values (quantile-clipped range,
    the role of the reference's entropy histogram training).

    `symmetric=True` pins bias=0 (scale from the |x| quantile): code-space
    dot products are then EXACTLY rank-equivalent to dequant-space ones at
    one uniform scale (and scale-free for cosine), which lets the graph
    build run directly over int8 codes — the HBM tier for corpora whose
    fp32/bf16 form exceeds device memory (10M x 768d)."""
    qtype = QuantizeType(qtype)
    if qtype not in _RANGES:
        return None
    qlo, qhi = _RANGES[qtype]
    if symmetric:
        hi = float(np.quantile(np.abs(data.astype(np.float32)), clip_quantile))
        if hi <= 0:
            hi = 1e-6
        return QuantParams(hi / qhi, 0.0, int(qtype))
    lo_q, hi_q = np.quantile(
        data.astype(np.float32), [1.0 - clip_quantile, clip_quantile]
    )
    lo, hi = float(lo_q), float(hi_q)
    if hi <= lo:
        hi = lo + 1e-6
    scale = (hi - lo) / (qhi - qlo)
    bias = (hi + lo) / 2.0  # center so codes are symmetric around 0
    return QuantParams(scale, bias, int(qtype))


def encode(
    data: np.ndarray, qtype: QuantizeType, params: Optional[QuantParams]
) -> np.ndarray:
    qtype = QuantizeType(qtype)
    if qtype == QuantizeType.FP16:
        return data.astype(np.float16)
    if qtype in _RANGES:
        qlo, qhi = _RANGES[qtype]
        codes = np.round((data.astype(np.float32) - params.bias) / params.scale)
        return np.clip(codes, qlo, qhi).astype(np.int8)
    return data.astype(np.float32)


def decode(codes: np.ndarray, params: Optional[QuantParams]) -> np.ndarray:
    if codes.dtype == np.float16:
        return codes.astype(np.float32)
    if params is None:
        return codes.astype(np.float32)
    return codes.astype(np.float32) * params.scale + params.bias


def pack_int4(codes: np.ndarray) -> np.ndarray:
    """Pack int4 codes (int8 array, values in [-8, 7]) two-per-byte:
    element 2j in the low nibble, 2j+1 in the high nibble -> (N, ceil(D/2)).

    The reference streams nibble-packed int4 the same way
    (`integer_quantizer_converter.cc:596-607`); on TPU the packed array is
    what lives in HBM — halving scan bandwidth vs int8 — and kernels unpack
    with two shifts on the VPU.
    """
    n, d = codes.shape
    if d % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.int8)], axis=1)
    lo = codes[:, 0::2].astype(np.uint8) & 0x0F
    hi = codes[:, 1::2].astype(np.uint8) & 0x0F
    return (lo | (hi << 4)).astype(np.int8)


def unpack_int4(packed: np.ndarray, d: int) -> np.ndarray:
    """Inverse of pack_int4 -> (N, d) int8 (sign-extended nibbles)."""
    lo = (packed.astype(np.int8) << 4) >> 4
    hi = packed.astype(np.int8) >> 4
    out = np.empty((packed.shape[0], packed.shape[1] * 2), np.int8)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return out[:, :d]


def pack_bits(bits: np.ndarray, word_bits: int = 32) -> np.ndarray:
    """Pack a (N, D) 0/1 bit matrix into LSB-first uint32/uint64 words —
    the reference's binary layout (`binary_quantizer.cc:40-52`: bit j of
    word i holds element 32*i + j)."""
    n, d = bits.shape
    words = -(-d // word_bits)
    padded = np.zeros((n, words * word_bits), dtype=np.uint8)
    padded[:, :d] = bits.astype(np.uint8) & 1
    packed8 = np.packbits(padded, axis=1, bitorder="little")
    dtype = np.uint32 if word_bits == 32 else np.uint64
    return packed8.view(dtype).reshape(n, words)


def unpack_bits(words: np.ndarray, d: int) -> np.ndarray:
    """Inverse of pack_bits -> (N, d) uint8 of 0/1 (LSB-first)."""
    n = words.shape[0]
    bits = np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8).reshape(n, -1),
        axis=1,
        bitorder="little",
    )
    return bits[:, :d]


def binarize(data: np.ndarray, threshold: float = 0.0) -> np.ndarray:
    """Threshold-sign bits (reference BinaryConverter,
    `binary_quantizer.cc:47`: bit = in[i] >= threshold) -> (N, D) uint8."""
    return (np.asarray(data, dtype=np.float32) >= threshold).astype(np.uint8)


def bits_to_pm1(bits: np.ndarray, dtype=np.float32) -> np.ndarray:
    """0/1 bits -> ±1 vectors. TPU-native hamming trick: for x, y in {±1}^D,
    hamming(x, y) = (D - <x, y>) / 2 = ||x - y||^2 / 4 — so binary scans ride
    the MXU as plain matmuls instead of VPU popcounts."""
    return (bits.astype(np.float32) * 2.0 - 1.0).astype(dtype)


def mips_augment(data: np.ndarray) -> Tuple[np.ndarray, float]:
    """MIPS -> L2 transform (reference `mips_converter.cc`): append
    sqrt(max_norm^2 - ||x||^2) so L2-NN on augmented vectors ranks by IP."""
    norms2 = (data.astype(np.float32) ** 2).sum(1)
    max_norm2 = float(norms2.max(initial=0.0))
    extra = np.sqrt(np.maximum(max_norm2 - norms2, 0.0))
    return np.concatenate([data, extra[:, None]], axis=1), max_norm2


def mips_augment_query(q: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [q, np.zeros((*q.shape[:-1], 1), dtype=q.dtype)], axis=-1
    )
