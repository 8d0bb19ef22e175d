"""Index / query parameter classes and collection options.

Constructor signatures and defaults mirror the reference binding
(`src/binding/python/model/param/python_param.cc:172-983`) and the core defaults
(`src/include/zvec/core/interface/constants.h:21-24`: HNSW m=50, ef_construction=500,
ef_search=300; `src/include/zvec/db/index_params.h:252`: IVF n_iters=10;
`src/include/zvec/db/query_params.h:98-126`: nprobe=10, refiner scale_factor=10).
"""

from __future__ import annotations

import json
from typing import Optional

from ...typing.enum import IndexType, MetricType, QuantizeType

__all__ = [
    "IndexParam",
    "VectorIndexParam",
    "InvertIndexParam",
    "HnswIndexParam",
    "FlatIndexParam",
    "IVFIndexParam",
    "QueryParam",
    "HnswQueryParam",
    "IVFQueryParam",
    "FlatQueryParam",
    "CollectionOption",
    "SegmentOption",
    "IndexOption",
    "OptimizeOption",
    "AddColumnOption",
    "AlterColumnOption",
    "DEFAULT_HNSW_M",
    "DEFAULT_HNSW_EF_CONSTRUCTION",
    "DEFAULT_HNSW_EF_SEARCH",
    "DEFAULT_IVF_NPROBE",
    "DEFAULT_REFINER_SCALE_FACTOR",
]

# Reference defaults (`constants.h:21-24`, `query_params.h:98-126`).
DEFAULT_HNSW_M = 50
DEFAULT_HNSW_EF_CONSTRUCTION = 500
DEFAULT_HNSW_EF_SEARCH = 300
DEFAULT_IVF_NPROBE = 10
DEFAULT_REFINER_SCALE_FACTOR = 10


class _ReprMixin:
    def _repr_dict(self) -> dict:
        return {
            k: (v.name if hasattr(v, "name") else v)
            for k, v in self.__dict__.items()
            if not k.startswith("_")
        }

    def __repr__(self) -> str:
        return f"{type(self).__name__}({json.dumps(self._repr_dict())})"

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self._repr_dict().items()))))


class IndexParam(_ReprMixin):
    """Base of all index parameter classes."""

    index_type: IndexType = IndexType.UNDEFINED

    def clone(self) -> "IndexParam":
        import copy

        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        d = {"index_type": self.index_type.name}
        d.update(self._repr_dict())
        return d


class InvertIndexParam(IndexParam):
    """Inverted (scalar secondary) index parameters.

    `enable_range_optimization` enables order-preserving numeric key encoding for
    range scans; `enable_extended_wildcard` additionally indexes reversed strings
    for suffix matching (reference `src/include/zvec/db/index_params.h:63-104`).
    """

    index_type = IndexType.INVERT

    def __init__(
        self,
        enable_range_optimization: bool = False,
        enable_extended_wildcard: bool = False,
    ):
        self.enable_range_optimization = bool(enable_range_optimization)
        self.enable_extended_wildcard = bool(enable_extended_wildcard)


class VectorIndexParam(IndexParam):
    """Base of the vector index parameter classes."""

    def __init__(
        self,
        metric_type: MetricType = MetricType.IP,
        quantize_type: QuantizeType = QuantizeType.UNDEFINED,
    ):
        self.metric_type = MetricType(metric_type)
        self.quantize_type = QuantizeType(quantize_type)


class HnswIndexParam(VectorIndexParam):
    """HNSW build parameters.

    Beyond the reference's m/ef_construction (`constants.h:21-24`), the
    tuning knobs the reference exposes as `proxima.hnsw.*` params
    (`src/core/algorithm/hnsw/hnsw_params.h:22-80`) are typed fields here
    (they used to be ZVEC_HNSW_* env vars — kept as deprecated overrides,
    resolved once at engine construction so they can never go stale inside
    a jit cache):

    - ``knn_k``: candidate-pool size per node for the batched kNN-graph
      build (None = auto: min(ef_construction, size-dependent cap)). The
      analog of how much of efc the reference's insertion beam actually
      explores.
    - ``prune_alpha``: Vamana/DiskANN robust-prune relaxation; 1.0 = the
      reference's exact dominance rule (`hnsw_algorithm.cc:394-430`).
    - ``backfill_alpha``: 0 = plain by-sim backfill; >= 1.0 inserts a
      DiskANN-style second prune round (alpha-relaxed, over the pruned pool
      only) ahead of the by-sim tail, keeping backfill edges diverse
      without touching the exact primary tier.
    - ``clustered_build``: True forces the cluster-local exact-candidate
      build path, False forces the full exact scan, None = auto by size.
    - ``brute_force_threshold``: below this doc count searches scan flat
      (reference `hnsw_params.h` kDefaultBruteForceThreshold = 1000).
    - ``max_scan_ratio``: default scan-budget cap as a fraction of N for
      graph traversal (reference `hnsw_params.h:46`); 0 = engine default.
    - ``route_quantize``: reduced-precision ROUTING codes for fp32 indexes:
      the beam's per-step neighbor gathers (the dominant HBM cost at scale)
      read int8/bf16 codes, and the final working set re-ranks against the
      resident fp32 tier on device — scores stay fp32-exact. One of
      "off" | "auto" | "bf16" | "int8"; auto = int8 above 2^21 rows.
      Ignored on already-quantized indexes.
    """

    index_type = IndexType.HNSW

    def __init__(
        self,
        metric_type: MetricType = MetricType.IP,
        m: int = DEFAULT_HNSW_M,
        ef_construction: int = DEFAULT_HNSW_EF_CONSTRUCTION,
        quantize_type: QuantizeType = QuantizeType.UNDEFINED,
        *,
        knn_k: Optional[int] = None,
        prune_alpha: float = 1.0,
        backfill_alpha: float = 0.0,
        clustered_build: Optional[bool] = None,
        brute_force_threshold: int = 1000,
        max_scan_ratio: float = 0.0,
        route_quantize: str = "auto",
    ):
        super().__init__(metric_type, quantize_type)
        if m <= 0:
            raise ValueError(f"HNSW m must be positive, got {m}")
        if ef_construction <= 0:
            raise ValueError(
                f"HNSW ef_construction must be positive, got {ef_construction}"
            )
        if knn_k is not None and knn_k <= 0:
            raise ValueError(f"HNSW knn_k must be positive, got {knn_k}")
        if prune_alpha < 1.0:
            raise ValueError(f"HNSW prune_alpha must be >= 1.0, got {prune_alpha}")
        if backfill_alpha and backfill_alpha < 1.0:
            raise ValueError(
                f"HNSW backfill_alpha must be 0 (off) or >= 1.0, got {backfill_alpha}"
            )
        if brute_force_threshold < 0:
            raise ValueError(
                f"HNSW brute_force_threshold must be >= 0, got {brute_force_threshold}"
            )
        if not (0.0 <= max_scan_ratio <= 1.0):
            raise ValueError(
                f"HNSW max_scan_ratio must be in [0, 1], got {max_scan_ratio}"
            )
        if route_quantize not in ("off", "auto", "bf16", "int8"):
            raise ValueError(
                "HNSW route_quantize must be one of off/auto/bf16/int8, "
                f"got {route_quantize!r}"
            )
        self.m = int(m)
        self.ef_construction = int(ef_construction)
        self.knn_k = None if knn_k is None else int(knn_k)
        self.prune_alpha = float(prune_alpha)
        self.backfill_alpha = float(backfill_alpha)
        self.clustered_build = None if clustered_build is None else bool(clustered_build)
        self.brute_force_threshold = int(brute_force_threshold)
        self.max_scan_ratio = float(max_scan_ratio)
        self.route_quantize = route_quantize


class FlatIndexParam(VectorIndexParam):
    index_type = IndexType.FLAT

    def __init__(
        self,
        metric_type: MetricType = MetricType.IP,
        quantize_type: QuantizeType = QuantizeType.UNDEFINED,
    ):
        super().__init__(metric_type, quantize_type)


class IVFIndexParam(VectorIndexParam):
    index_type = IndexType.IVF

    def __init__(
        self,
        metric_type: MetricType = MetricType.IP,
        n_list: int = 0,
        n_iters: int = 10,
        use_soar: bool = False,
        quantize_type: QuantizeType = QuantizeType.UNDEFINED,
    ):
        super().__init__(metric_type, quantize_type)
        if n_list < 0:
            raise ValueError(f"IVF n_list must be >= 0, got {n_list}")
        self.n_list = int(n_list)  # 0 => auto (sqrt heuristic at train time)
        self.n_iters = int(n_iters)
        self.use_soar = bool(use_soar)


class QueryParam(_ReprMixin):
    """Base of per-query vector search parameters.

    `is_using_refiner=None` (default) = AUTO: quantized indexes refine
    against the full-precision forward tier by default (the reference pairs
    every quantized index with a full-precision block precisely for this,
    `segment.cc:1591-1700`); fp32 indexes don't. Pass False to force raw
    quantized scores, True to force refining."""

    def __init__(self, is_linear: bool = False, is_using_refiner=None):
        self.is_linear = bool(is_linear)
        self.is_using_refiner = (
            None if is_using_refiner is None else bool(is_using_refiner)
        )
        self.refiner_scale_factor = DEFAULT_REFINER_SCALE_FACTOR

    def refiner_enabled(self, quantized: bool) -> bool:
        if self.is_using_refiner is None:
            return quantized
        return self.is_using_refiner


class HnswQueryParam(QueryParam):
    """Per-query HNSW knobs. Beyond the reference's ef/radius
    (`hnsw_params.h:22-80`), the TPU beam exposes its own shape knobs
    (formerly ZVEC_HNSW_* env vars — kept as deprecated overrides):

    - ``frontier``: beam width F (nodes expanded per step); 0 = engine
      default (4, the measured optimum at 10M — BASELINE.md).
    - ``steps_slack``: extra lax.while_loop iterations past ef before the
      traversal force-stops (bounded-loop analog of the reference's
      unbounded candidate walk).
    - ``visited_bits``: hashed visited-bitset size as log2(bits); 0 = auto
      (exact id-indexed bitset below 2^21 rows, 21-bit hash above — the
      reference's VisitFilter bitmap->bloom switch, `visit_filter.h:39`).
    - ``visited_bytes``: store the hashed visited set as a BYTE map
      (duplicate-safe writes elide the per-step dedup sort; 8x HBM per
      slot — the reference's VisitByteMap strategy, `visit_filter.h:360`).
      Requires visited_bits > 0.
    - ``max_scan_ratio``: per-query override of the scan-budget fraction;
      0 = index/engine default.
    - ``approx_merge``: use the hardware pooled top-k (lax.approx_max_k,
      recall_target 0.98) for the beam's per-step candidate/result merges
      instead of exact lax.top_k — trades a bounded chance of dropping a
      borderline candidate for fewer VPU sort passes per step.
    - ``done_frac``: stop the batched traversal once this fraction of the
      query batch has terminated (1.0 = exact). Step counts are skewed
      across queries; the last stragglers otherwise tax every query in
      the lockstep batch. Default 0.97: measured at 10M x 128d (ef=96,
      256 GT queries, benchmarks/knobs10m_r4.json) it costs 0.0004 mean
      recall@10 (0.9508 -> 0.9504) with a per-query tail IDENTICAL to
      exact traversal (worst-decile mean 0.588 vs 0.592, p10 0.90 both —
      the tail is graph hardness, not the cutoff) and raises pipelined
      throughput 721.9 -> 1,266.4 qps. Batches smaller than 34 queries
      are unaffected (ceil(0.97*nq) = nq).
    """

    def __init__(
        self,
        ef: int = DEFAULT_HNSW_EF_SEARCH,
        radius: float = 0.0,
        is_linear: bool = False,
        is_using_refiner=None,
        *,
        frontier: int = 0,
        steps_slack: int = 64,
        visited_bits: int = 0,
        visited_bytes: bool = False,
        max_scan_ratio: float = 0.0,
        approx_merge: bool = False,
        done_frac: float = 0.97,
    ):
        super().__init__(is_linear, is_using_refiner)
        if ef <= 0:
            raise ValueError(f"HNSW ef must be positive, got {ef}")
        if frontier < 0:
            raise ValueError(f"HNSW frontier must be >= 0, got {frontier}")
        if steps_slack < 0:
            raise ValueError(f"HNSW steps_slack must be >= 0, got {steps_slack}")
        if visited_bits < 0 or visited_bits > 26:
            raise ValueError(f"HNSW visited_bits must be in [0, 26], got {visited_bits}")
        if not (0.0 <= max_scan_ratio <= 1.0):
            raise ValueError(
                f"HNSW max_scan_ratio must be in [0, 1], got {max_scan_ratio}"
            )
        if not (0.5 <= done_frac <= 1.0):
            raise ValueError(
                f"HNSW done_frac must be in [0.5, 1], got {done_frac}"
            )
        self.ef = int(ef)
        self.radius = float(radius)
        self.frontier = int(frontier)
        self.steps_slack = int(steps_slack)
        self.visited_bits = int(visited_bits)
        self.visited_bytes = bool(visited_bytes)
        self.max_scan_ratio = float(max_scan_ratio)
        self.approx_merge = bool(approx_merge)
        self.done_frac = float(done_frac)


class IVFQueryParam(QueryParam):
    """IVF probe knobs.

    - ``nprobe``: closest inverted lists to visit (reference default 10).
    - ``max_scan_count``: cap on scanned rows per query across probed
      lists; probing stops at the first list that STARTS over budget
      (`ivf_searcher.cc:222-237` loop-head check). 0 = unbounded.
    - ``max_scan_ratio``: alternative cap as a fraction of the corpus,
      `max_scan_count = ceil(N * ratio)` (`ivf_searcher_context.h:75-77`).
      Ignored when ``max_scan_count`` is set. 0 = unbounded.
    """

    def __init__(
        self,
        nprobe: int = DEFAULT_IVF_NPROBE,
        is_using_refiner=None,
        max_scan_count: int = 0,
        max_scan_ratio: float = 0.0,
    ):
        super().__init__(is_using_refiner=is_using_refiner)
        if nprobe <= 0:
            raise ValueError(f"IVF nprobe must be positive, got {nprobe}")
        if max_scan_count < 0:
            raise ValueError(
                f"IVF max_scan_count must be >= 0, got {max_scan_count}"
            )
        if not (0.0 <= max_scan_ratio <= 1.0):
            raise ValueError(
                f"IVF max_scan_ratio must be in [0, 1], got {max_scan_ratio}"
            )
        self.nprobe = int(nprobe)
        self.max_scan_count = int(max_scan_count)
        self.max_scan_ratio = float(max_scan_ratio)


class FlatQueryParam(QueryParam):
    def __init__(self, is_using_refiner=None):
        super().__init__(is_using_refiner=is_using_refiner)


class CollectionOption(_ReprMixin):
    """Collection open options (`python_param.cc:716-747`)."""

    def __init__(self, read_only: bool = False, enable_mmap: bool = True):
        self.read_only = bool(read_only)
        self.enable_mmap = bool(enable_mmap)


class SegmentOption(_ReprMixin):
    """Segment sizing knobs (`schema.h:24-25`: max 10M docs/segment, min 1000)."""

    def __init__(
        self,
        max_doc_count_per_segment: int = 10_000_000,
        min_doc_count_for_index: int = 1000,
    ):
        self.max_doc_count_per_segment = int(max_doc_count_per_segment)
        self.min_doc_count_for_index = int(min_doc_count_for_index)


class _ConcurrencyOption(_ReprMixin):
    def __init__(self, concurrency: int = 0):
        self.concurrency = int(concurrency)


class IndexOption(_ConcurrencyOption):
    pass


class OptimizeOption(_ConcurrencyOption):
    pass


class AddColumnOption(_ConcurrencyOption):
    pass


class AlterColumnOption(_ConcurrencyOption):
    pass
