"""FLAT engine: exact brute-force scan on the card (+ quantized variants).

Port of `zvec_tpu/core/flat.py`. Codes are padded and moved to the device
once per data version; every query batch then runs either the fused CUDA scan
(`ops/flat_scan.py`, large corpora and small k) or the blockwise torch scan
(`ops/topk.py`). Under a collection mesh (`init(mesh_devices=N)`) the padded
rows split into N contiguous shards, one per mesh device, and a batch runs
that choice on every shard before the per-shard top-k merge
(`parallel/mesh.py::sharded_flat_search`).

Quantization (reference converter/reformer pairs, `src/core/quantizer/`):
`quantize_type` on the index params stores fp16 or int8/int4 codes on the
device and scores asymmetrically with dequant fused into the epilogue; COSINE
codes are L2-normalized before quantization (`cosine_converter.cc:383-399`);
`is_using_refiner` overscans and re-ranks against fp32 (`basic_refiner.cc`).
"""

from __future__ import annotations

import hashlib
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..model.param.param import FlatQueryParam, QueryParam
from ..ops.quantize import QuantParams, decode, encode, train_quantizer
from ..ops.runtime import bucket_queries as _bucket_queries
from ..ops.runtime import device, round_up
from ..ops.topk import blockwise_topk_search
from ..typing.enum import IndexType, MetricType, QuantizeType
from .interface import VectorIndexEngine, register_engine
from .refiner import refine

__all__ = ["FlatEngine", "kernel_takes"]

# Row padding granularity; the fused scan needs a multiple of 1024 rows.
_ROW_ALIGN = 1024
_ROW_ALIGN_BIG = 8192  # large corpora pad to the largest scan tile
_BIG_N = 100_000  # corpus size from which the fused kernel takes the scan
_BLOCK_SIZE = 131072


def kernel_takes(codes: torch.Tensor, dequant, n: int, k: int) -> bool:
    """The rule of the fused CUDA scan: codes on the card, fp32 / fp16 codes
    or int8 / nibble-packed int4 codes with the in-kernel affine-dequant
    epilogue, rows a multiple of 1024, a large corpus (n rows), small k
    (group-max extraction)."""
    dtype_ok = (dequant is None and codes.dtype in (torch.float32, torch.float16)) or (
        dequant is not None and codes.dtype == torch.int8
    )
    return dtype_ok and codes.is_cuda and codes.shape[0] % 1024 == 0 and n >= _BIG_N and k <= 32


class _State(NamedTuple):
    """One immutable device snapshot; swapped atomically by _rebuild so
    concurrent readers racing a writer always see a consistent
    (codes, norms, n, n_pad) quadruple (query-during-append safety)."""

    codes: Optional[torch.Tensor]  # (n_pad, D) device, storage dtype; a list of shards under a mesh
    norms: Optional[torch.Tensor]  # (n_pad,) device f32 (dequantized sq norms); per shard under a mesh
    n: int
    n_pad: int
    dequant: Optional[tuple]  # (scale, bias) float32 values as Python floats
    int4_packed: bool
    mesh: Optional[Any] = None  # the collection mesh the rows are sharded over


_EMPTY = _State(None, None, 0, 0, None, False)


@register_engine(IndexType.FLAT)
class FlatEngine(VectorIndexEngine):
    query_param_class = FlatQueryParam

    def __init__(self, metric: MetricType, dimension: int, params=None):
        super().__init__(metric, dimension, params)
        self.quantize = (
            QuantizeType(params.quantize_type)
            if params is not None
            else QuantizeType.UNDEFINED
        )
        # binary modes: HAMMING-metric fields hold packed bit codes;
        # QuantizeType.BINARY binarizes float codes (reference
        # BinaryConverter, `binary_converter.cc`). Both scan as ±1 vectors
        # under L2 — hamming = ||q - x||^2 / 4 on {±1}^D.
        self._hamming = self.metric == MetricType.HAMMING
        self._binary_codes = self.quantize == QuantizeType.BINARY
        if self._binary_codes and self.metric != MetricType.L2:
            raise ValueError("QuantizeType.BINARY requires MetricType.L2")
        self._st: _State = _EMPTY
        self._qparams: Optional[QuantParams] = None
        # device-resident mask cache: repeated queries with the same
        # alive/filter mask (the common case: no deletes between queries)
        # reuse one device buffer instead of re-uploading N bytes per batch
        self._mask_cache: dict = {}

    def _device_mask(self, st: _State, full_mask: np.ndarray, as_int8: bool):
        """The (n_pad,) mask on the device (one tensor per shard under a
        mesh), cached by its contents."""
        digest = hashlib.blake2b(full_mask.tobytes(), digest_size=16).digest()
        key = (id(st.codes), digest, as_int8)
        hit = self._mask_cache.get(key)
        if hit is not None:
            return hit
        host = full_mask.astype(np.int8) if as_int8 else full_mask
        if st.mesh is not None:
            from ..parallel.mesh import shard_rows

            dev = shard_rows(host, st.mesh)
        else:
            dev = torch.from_numpy(host).to(st.codes.device)
        if len(self._mask_cache) >= 8:
            self._mask_cache.clear()
        self._mask_cache[key] = dev
        return dev

    @property
    def _n(self) -> int:  # read by VectorIndexEngine._normalize_query_args
        return self._st.n

    def _prepare(self, data: np.ndarray) -> tuple:
        """Storage-side transform: cosine-normalize, then quantize.
        Returns (codes, dequant)."""
        if self._hamming:
            from ..ops.quantize import bits_to_pm1, unpack_bits

            bits = unpack_bits(np.ascontiguousarray(data), self.dimension)
            return bits_to_pm1(bits), None
        data = data.astype(np.float32, copy=False)
        if self._binary_codes:
            from ..ops.quantize import binarize, bits_to_pm1

            return bits_to_pm1(binarize(data)), None
        if self.metric == MetricType.COSINE and self.quantize != QuantizeType.UNDEFINED:
            norms = np.linalg.norm(data, axis=1, keepdims=True)
            data = np.where(norms > 0, data / np.where(norms > 0, norms, 1.0), data)
        if self.quantize in (QuantizeType.INT8, QuantizeType.INT4):
            self._qparams = train_quantizer(data, self.quantize)
            codes = encode(data, self.quantize, self._qparams)
            dequant = (
                float(np.float32(self._qparams.scale)),
                float(np.float32(self._qparams.bias)),
            )
            return codes, dequant
        if self.quantize == QuantizeType.FP16:
            return data.astype(np.float16), None
        return data, None

    def _use_kernel(self, st: _State, k: int) -> bool:
        return st.codes is not None and kernel_takes(st.codes, st.dequant, st.n, k)

    def _mesh(self):
        from ..parallel.mesh import collection_mesh

        return collection_mesh()

    def _rebuild(self, data: np.ndarray) -> None:
        n = data.shape[0]
        if n == 0:
            self._st = _EMPTY
            return
        codes, dequant = self._prepare(np.asarray(data))
        mesh = self._mesh()
        align = _ROW_ALIGN_BIG if n >= _BIG_N else _ROW_ALIGN
        # every shard holds a whole number of scan tiles
        n_pad = round_up(n, align * (mesh.shape["corpus"] if mesh is not None else 1))
        padded = np.zeros((n_pad, codes.shape[1]), dtype=codes.dtype)
        padded[:n] = codes
        deq = decode(padded, self._qparams)
        norms = (deq.astype(np.float32) ** 2).sum(1)
        int4_packed = self.quantize == QuantizeType.INT4
        if int4_packed:
            # nibble-packed residency: halves scan bandwidth vs int8
            # (`integer_quantizer_converter.cc:596-607`)
            from ..ops.quantize import pack_int4

            padded = pack_int4(padded)
        # fp16 codes stay true fp16 on the card (Hopper scores fp16 natively)
        if mesh is not None:
            # corpus-sharded residency: each mesh device holds its shard's rows
            from ..parallel.mesh import shard_rows

            dev_codes = shard_rows(padded, mesh)
            dev_norms = shard_rows(norms.astype(np.float32), mesh)
        else:
            dev = device()
            dev_codes = torch.from_numpy(np.ascontiguousarray(padded)).to(dev)
            dev_norms = torch.from_numpy(norms.astype(np.float32)).to(dev)
        self._st = _State(dev_codes, dev_norms, n, n_pad, dequant, int4_packed, mesh)

    def _search_impl(
        self,
        queries: np.ndarray,
        topk: int,
        mask: Optional[np.ndarray],
        param: Optional[QueryParam],
    ) -> Tuple[np.ndarray, np.ndarray]:
        return self._search_finalize(self._search_dispatch(queries, topk, mask, param))

    def _search_dispatch(
        self,
        queries: np.ndarray,
        topk: int,
        mask: Optional[np.ndarray],
        param: Optional[QueryParam],
    ):
        """Enqueue the device scan (CUDA launches return before the card is
        done); host post-processing happens in `_search_finalize` so callers
        can pipeline query batches."""
        st = self._st  # one consistent snapshot for this query
        nq = queries.shape[0]
        if st.n == 0:
            sims = np.full((nq, topk), -np.inf, dtype=np.float32)
            return ("empty", sims, np.full((nq, topk), -1, dtype=np.int64))

        orig_queries = queries
        scan_metric = self.metric
        if self._hamming:
            from ..ops.quantize import bits_to_pm1, unpack_bits

            queries = bits_to_pm1(unpack_bits(np.ascontiguousarray(queries), self.dimension))
            scan_metric = MetricType.L2
        elif self._binary_codes:
            from ..ops.quantize import binarize, bits_to_pm1

            queries = bits_to_pm1(binarize(queries))
            scan_metric = MetricType.L2

        quantized = self.quantize != QuantizeType.UNDEFINED
        # refine-by-default on quantized indexes (reference full-precision
        # refine block pairing, `segment.cc:1591-1700`); opt out with
        # is_using_refiner=False. BINARY is a metric CONVERSION (scores are
        # hamming distances on sign bits), not a compression of the stored
        # metric, so refine stays opt-in there.
        auto_refine = quantized and not self._binary_codes
        use_refiner = quantized and (
            param.refiner_enabled(auto_refine)
            if isinstance(param, QueryParam)
            else auto_refine
        )
        scan_k = topk
        if use_refiner:
            scan_k = min(
                topk * getattr(param, "refiner_scale_factor", 10), st.n
            )

        nq_pad = _bucket_queries(nq)
        q = np.zeros((nq_pad, queries.shape[1]), dtype=np.float32)
        q[:nq] = queries

        full_mask = np.zeros(st.n_pad, dtype=bool)
        if mask is not None:
            m = np.asarray(mask)[: st.n]
            full_mask[: len(m)] = m
        else:
            full_mask[: st.n] = True

        k = min(scan_k, st.n)
        if st.mesh is not None:
            from ..parallel.mesh import sharded_flat_search

            sims, idx = sharded_flat_search(
                st.mesh,
                torch.from_numpy(q),
                st.codes,
                scan_metric,
                k,
                mask=self._device_mask(st, full_mask, as_int8=False),
                x_sq_norms=st.norms,
                dequant=st.dequant,
                int4_packed=st.int4_packed,
                exact_tf32=self._hamming or self._binary_codes,
            )
            return ("scan", st, sims, idx, nq, topk, use_refiner, orig_queries)
        q_dev = torch.from_numpy(q).to(st.codes.device)
        if self._use_kernel(st, k):
            from ..ops.flat_scan import flat_scan_topk

            norms = st.norms
            if scan_metric == MetricType.COSINE:
                norms = torch.sqrt(st.norms)  # the scan wants ||x|| for cosine
            sims, idx = flat_scan_topk(
                q_dev,
                st.codes,
                norms,
                self._device_mask(st, full_mask, as_int8=True),
                metric=scan_metric,
                topk=k,
                dequant=st.dequant,
                int4_dim=q.shape[1] if st.int4_packed else None,
                # +-1 codes and queries: one TF32 product is exact
                exact_tf32=self._hamming or self._binary_codes,
            )
        else:
            sims, idx = blockwise_topk_search(
                q_dev,
                st.codes,
                scan_metric,
                k,
                mask=self._device_mask(st, full_mask, as_int8=False),
                x_sq_norms=st.norms,
                block_size=_BLOCK_SIZE,
                dequant=st.dequant,
                int4_packed=st.int4_packed,
            )
        return ("scan", st, sims, idx, nq, topk, use_refiner, orig_queries)

    def _search_finalize(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        if handle[0] == "empty":
            return handle[1], handle[2]
        _, st, sims, idx, nq, topk, use_refiner, orig_queries = handle
        sims = sims[:nq].cpu().numpy()
        idx = idx[:nq].cpu().numpy().astype(np.int64)
        oob = idx >= st.n
        if oob.any():  # padded rows can only surface when fully unmasked
            idx = np.where(oob, -1, idx)
            sims = np.where(oob, -np.inf, sims)

        if use_refiner:
            # exact re-rank against the unquantized store (original queries,
            # original metric — matches the reference BasicRefiner)
            sims, idx = refine(self._data_fn, orig_queries, idx, self.metric, topk)
            idx = idx.astype(np.int64)
        elif self._hamming or self._binary_codes:
            # ±1 L2 scan -> hamming similarity: hamming = l2^2 / 4
            sims = sims * 0.25

        if sims.shape[1] < topk:
            pad = topk - sims.shape[1]
            sims = np.pad(sims, ((0, 0), (0, pad)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        sims = sims[:, :topk]
        idx = idx[:, :topk]
        sims = np.where(idx >= 0, sims, -np.inf)
        return sims, idx
