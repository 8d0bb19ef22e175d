"""FLAT engine: exact brute-force scan on the card (+ quantized variants).

Port of `zvec_tpu/core/flat.py`. Codes are padded and moved to the device
once per data version; every query batch then runs either the fused CUDA scan
(`ops/flat_scan.py`: large corpora and k up to 128, the refine's overscan
among them) or the blockwise torch scan (`ops/topk.py`: small corpora, k
past 128, CPU tensors). A fused scan under a mask that passes few enough
rows to score by keys (`utils/config.py::scores_by_keys`) scans only those:
their codes are gathered into a compact buffer on the card, and the scan's
positions map back to row ids through the row list. Under a collection mesh
(`init(mesh_devices=N)`) the padded rows split into N contiguous shards, one
per mesh device, and a batch runs that choice on every shard before the
per-shard top-k merge (`parallel/mesh.py::sharded_flat_search`).

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
from ..ops.flat_scan import query_chunk
from ..ops.quantize import QuantParams, decode, encode, train_quantizer
from ..ops.runtime import bucket_queries as _bucket_queries
from ..ops.runtime import cdiv, device, round_up
from ..ops.topk import blockwise_topk_search
from ..typing.enum import IndexType, MetricType, QuantizeType
from ..utils.config import scores_by_keys
from ..utils.profiler import count, span
from .interface import VectorIndexEngine, device_row_mask, fit_row_mask, register_engine
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
    epilogue, rows a multiple of 1024, a large corpus (n rows), and k within
    the kernels' 128 lanes with stage one's output for one block of 128
    queries within its budget (`query_chunk`)."""
    dtype_ok = (dequant is None and codes.dtype in (torch.float32, torch.float16)) or (
        dequant is not None and codes.dtype == torch.int8
    )
    return (dtype_ok and codes.is_cuda and codes.shape[0] % 1024 == 0 and n >= _BIG_N
            and query_chunk(codes.shape[0], k, codes.device) > 0)


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


class _Mask(NamedTuple):
    """A scan's mask on the device. With `rows` None the scan reads every row
    and `dev` is the (n_pad,) mask (one tensor per shard under a mesh). A
    compact scan reads only the passing rows: `rows` lists them, int32 and
    ascending, padded with row 0 to n_c (n_pass rounded up to 1024, none
    where none pass), and `dev` is the (n_c,) int8 mask of the first n_pass.
    `src` is the host mask an entry cached by identity was made from: held,
    so that its id names no other array while the entry lives."""

    dev: Any
    rows: Optional[torch.Tensor] = None
    src: Optional[np.ndarray] = None


def _compact_mask(full_mask: np.ndarray, n_pass: int, dev) -> _Mask:
    n_c = round_up(n_pass, _ROW_ALIGN)
    rows = np.zeros(n_c, dtype=np.int32)
    rows[:n_pass] = np.flatnonzero(full_mask)
    mask = np.zeros(n_c, dtype=np.int8)
    mask[:n_pass] = 1
    return _Mask(torch.from_numpy(mask).to(dev), torch.from_numpy(rows).to(dev))


def _no_rows(nq: int, topk: int):
    """The handle of a scan with no row to score: -inf scores, -1 ids."""
    return ("empty", np.full((nq, topk), -np.inf, dtype=np.float32), np.full((nq, topk), -1, dtype=np.int64))


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

    def _device_mask(self, st: _State, mask: Optional[np.ndarray], fused: bool) -> _Mask:
        """The scan's mask of the rows of `st` on the device, cached. A mask
        that cannot change is cached by its identity: None (every row), or a
        read-only bool array of `st.n` rows that owns its data, as
        `CollectionImpl._row_mask` hands down. Any other mask is cached by
        its contents, a digest of the padded mask. A fused scan whose mask
        passes few enough rows to score by keys (`scores_by_keys`, the
        reference's threshold, `doc_filter.cc:120-122`) is compacted to them;
        the pass count and the row list are computed here, on a miss only."""
        fixed = mask is None or (
            isinstance(mask, np.ndarray) and not mask.flags.writeable and mask.flags.owndata
            and mask.dtype == np.bool_ and mask.shape == (st.n,)
        )
        if fixed:
            key = (id(st.codes), st.n, st.n_pad, None if mask is None else id(mask), fused)
            full_mask = None
        else:
            count("mask_digests", 1)
            full_mask = fit_row_mask(mask, st.n, st.n_pad)
            key = (id(st.codes), hashlib.blake2b(full_mask.tobytes(), digest_size=16).digest(), fused)
        hit = self._mask_cache.get(key)
        if hit is not None:
            return hit
        if full_mask is None:
            full_mask = fit_row_mask(mask, st.n, st.n_pad)
        if fused:
            n_pass = int(np.count_nonzero(full_mask))
            if scores_by_keys(n_pass, st.n):
                out = _compact_mask(full_mask, n_pass, st.codes.device)
            else:
                out = _Mask(device_row_mask(full_mask, st.n_pad, dev=st.codes.device, dtype=np.int8))
        elif st.mesh is not None:
            out = _Mask(device_row_mask(full_mask, st.n_pad, mesh=st.mesh))
        else:
            out = _Mask(device_row_mask(full_mask, st.n_pad, dev=st.codes.device))
        if mask is not None and fixed:
            out = out._replace(src=mask)
        if len(self._mask_cache) >= 8:
            self._mask_cache.clear()
        self._mask_cache[key] = out
        return out

    def device_mask(self, mask: Optional[np.ndarray], st: _State) -> torch.Tensor:
        """The (n_pad,) bool mask of a search of the rows of `st` (the
        snapshot the caller scans) on the device, through the mask cache:
        what a kernel that fuses this engine's scan with another reads."""
        return self._device_mask(st, mask, fused=False).dev

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
            return _no_rows(nq, topk)

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

        k = min(scan_k, st.n)
        fused = st.mesh is None and self._use_kernel(st, k)
        with span("mask", self.trace_detail):
            dev_mask = self._device_mask(st, mask, fused)
        rows = dev_mask.rows
        if rows is not None:
            count("scans_compacted", 1)
        count("rows_scored", st.n_pad if rows is None else rows.shape[0])
        if rows is not None and rows.shape[0] == 0:
            return _no_rows(nq, topk)
        if st.mesh is not None:
            from ..parallel.mesh import sharded_flat_search

            sims, idx = sharded_flat_search(
                st.mesh,
                torch.from_numpy(q),
                st.codes,
                scan_metric,
                k,
                mask=dev_mask.dev,
                x_sq_norms=st.norms,
                dequant=st.dequant,
                int4_packed=st.int4_packed,
                exact_tf32=self._hamming or self._binary_codes,
            )
            return ("scan", st, sims, idx, nq, topk, use_refiner, orig_queries)
        q_dev = torch.from_numpy(q).to(st.codes.device)
        if fused:
            from ..ops.flat_scan import flat_scan_topk

            if k > 32:  # a wide k: the refine's overscan, or a top-k past 32
                count("scans_wide_k", 1)
            codes, norms = st.codes, st.norms
            if rows is not None:
                # the passing rows, in the order the full scan reads them
                codes, norms = codes.index_select(0, rows), norms.index_select(0, rows)
            if scan_metric == MetricType.COSINE:
                norms = torch.sqrt(norms)  # the scan wants ||x|| for cosine
            sims, idx = flat_scan_topk(
                q_dev,
                codes,
                norms,
                dev_mask.dev,
                metric=scan_metric,
                topk=k,
                dequant=st.dequant,
                int4_dim=q.shape[1] if st.int4_packed else None,
                # +-1 codes and queries: one TF32 product is exact
                exact_tf32=self._hamming or self._binary_codes,
            )
            if rows is not None:  # positions in the compact buffer -> row ids
                idx = torch.where(idx >= 0, rows[idx.clamp(min=0)].long(), idx)
        else:
            count("scan_blocks", cdiv(st.n_pad, _BLOCK_SIZE))
            with span("blockwise", self.trace_detail):
                sims, idx = blockwise_topk_search(
                    q_dev,
                    st.codes,
                    scan_metric,
                    k,
                    mask=dev_mask.dev,
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
        sims, idx = self._fetch(sims[:nq], idx[:nq])
        idx = idx.astype(np.int64)
        oob = idx >= st.n
        if oob.any():  # padded rows can only surface when fully unmasked
            idx = np.where(oob, -1, idx)
            sims = np.where(oob, -np.inf, sims)

        if use_refiner:
            # exact re-rank against the unquantized store (original queries,
            # original metric — matches the reference BasicRefiner)
            count("refine_rows", lambda: np.count_nonzero(idx >= 0))
            with span("refine", self.trace_detail):
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
