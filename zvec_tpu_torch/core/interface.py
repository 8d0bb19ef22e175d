"""Engine interface + factory.

Conceptual port of the reference's module contracts
(`src/include/zvec/core/framework/index_streamer.h:36-51`: init -> open ->
add/search -> flush -> close; `index_searcher.h:42-50` for immutable load+search)
re-shaped for the card: engines are *array transformations* — data lives in a
host matrix, is copied to the card's memory once, and every search is a
batch of queries scored by kernels launched on the card. Incremental "add" is
an append to the host matrix + device cache invalidation (rebuild-on-flush
replaces in-place graph mutation).

A search's row mask (the rows it may return) reaches an engine as a host
bool array over the segment's rows; `fit_row_mask` sizes it to the engine's
rows and `device_row_mask` pads it and places it on the card or the mesh.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..model.param.param import QueryParam, VectorIndexParam
from ..typing.enum import IndexType, MetricType, QuantizeType
from ..utils.profiler import span

__all__ = [
    "EngineStats",
    "VectorIndexEngine",
    "create_engine",
    "device_row_mask",
    "fit_row_mask",
    "register_engine",
    "rescan_deficient",
]


def fit_row_mask(mask: Optional[np.ndarray], n: int, n_pad: Optional[int] = None) -> np.ndarray:
    """A host row mask as an engine of `n` rows reads it: `n_pad` (default
    `n`) bools, the first `n` from `mask` and the pad rows out. A mask sized
    from another doc-count snapshot than the engine's (the concurrent-append
    race) is cut, or lets no row past its end through; `mask` None lets all
    `n` rows through. A mask that already fits is returned as it is."""
    n_pad = n if n_pad is None else n_pad
    if mask is not None and len(mask) == n == n_pad:
        return np.asarray(mask, dtype=bool)
    full = np.zeros(n_pad, dtype=bool)
    if mask is None:
        full[:n] = True
    else:
        m = np.asarray(mask, dtype=bool)[:n]
        full[: len(m)] = m
    return full


def device_row_mask(mask: Optional[np.ndarray], n: int, n_pad: Optional[int] = None, *,
                    dev=None, mesh=None, dtype=None):
    """`fit_row_mask(mask, n, n_pad)` placed where the engine's rows live:
    split over `mesh` in contiguous row shards (a list of tensors), else a
    tensor on `dev` (on the host where `dev` is None), in `dtype` (default
    bool). It never shares memory with `mask`: engines cache it."""
    full = fit_row_mask(mask, n, n_pad)
    if dtype is not None:
        full = full.astype(dtype)
    elif full is mask:
        full = full.copy()
    if mesh is not None:
        from ..parallel.mesh import shard_rows

        return shard_rows(full, mesh)
    import torch

    t = torch.from_numpy(full)
    return t if dev is None else t.to(dev)


def rescan_deficient(sims, idx, k, mask, rescan_fn):
    """Filtered-search safety net shared by the HNSW beams and IVF probes:
    queries that returned fewer valid hits than the filter can supply get
    exact masked results from `rescan_fn()` scattered over their rows.

    `rescan_fn` must rescan the FULL query batch (same shape as the main
    search). Returns possibly-copied (sims, idx)."""
    sims = np.asarray(sims)
    idx = np.asarray(idx)
    achievable = min(k, int(np.count_nonzero(mask)), sims.shape[1])
    deficient = (idx >= 0).sum(axis=1) < achievable
    if not deficient.any():
        return sims, idx
    fsims, fidx = rescan_fn()
    fsims = np.asarray(fsims)
    fidx = np.asarray(fidx).astype(idx.dtype)
    w = min(sims.shape[1], fsims.shape[1])
    sims, idx = np.array(sims), np.array(idx)  # jax views are read-only
    rows = np.flatnonzero(deficient)
    sims[rows[:, None], np.arange(w)[None, :]] = fsims[rows][:, :w]
    idx[rows[:, None], np.arange(w)[None, :]] = fidx[rows][:, :w]
    return sims, idx


class EngineStats:
    """Per-runner lifetime stats (reference `index_runner.h:52-140`: every
    runner tracks trained/built/added counts, index size and timings)."""

    __slots__ = (
        "rows_built",
        "build_count",
        "last_build_secs",
        "total_build_secs",
        "search_count",
        "queries_served",
        "total_search_secs",
    )

    def __init__(self):
        self.rows_built = 0  # rows in the last-built snapshot
        self.build_count = 0
        self.last_build_secs = 0.0
        self.total_build_secs = 0.0
        self.search_count = 0  # search() dispatches
        self.queries_served = 0  # individual query rows
        self.total_search_secs = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {s: getattr(self, s) for s in self.__slots__}

    def merge(self, other: "EngineStats") -> "EngineStats":
        """Aggregate across segments (combined-indexer roll-up)."""
        self.rows_built += other.rows_built
        self.build_count += other.build_count
        self.last_build_secs = max(self.last_build_secs, other.last_build_secs)
        self.total_build_secs += other.total_build_secs
        self.search_count += other.search_count
        self.queries_served += other.queries_served
        self.total_search_secs += other.total_search_secs
        return self


class VectorIndexEngine:
    """One vector column's search engine over a single segment's codes.

    Subclasses implement `_search_impl`. Data access is pull-based: the engine
    holds a `data_fn` returning the current (N, D) host matrix and a version
    counter; device state is rebuilt lazily when the version moves.
    """

    index_type: IndexType = IndexType.UNDEFINED
    # QueryParam subclass this engine understands. The bare base class is
    # accepted by every engine (is_linear / is_using_refiner are universal);
    # a mismatched subclass (e.g. IVFQueryParam on an HNSW field) or an
    # IndexParam passed as a query param is rejected instead of silently
    # falling back to defaults (reference: INCOMPATIBLE_FUNCTION_ERROR_MSG,
    # `python/tests/detail/test_collection_dql.py:990-1021`).
    query_param_class: type = QueryParam
    # the detail of this engine's spans in a query's stage tree: its segment,
    # `seg_<id>` (set by `Segment.search_async`)
    trace_detail: Optional[str] = None

    def __init__(
        self,
        metric: MetricType,
        dimension: int,
        params: Optional[VectorIndexParam] = None,
    ):
        self.metric = MetricType(metric)
        self.dimension = dimension
        self.params = params
        self._data_fn: Optional[Callable[[], np.ndarray]] = None
        self._version_fn: Optional[Callable[[], int]] = None
        self._built_version = -1
        self._rebuild_lock = threading.RLock()
        self.stats = EngineStats()

    # ---- wiring ----
    def bind_data(
        self, data_fn: Callable[[], np.ndarray], version_fn: Callable[[], int]
    ) -> None:
        self._data_fn = data_fn
        self._version_fn = version_fn

    def _ensure_fresh(self) -> None:
        # Serialized: concurrent readers racing a writer must not interleave
        # two rebuilds (engines swap their device state as one snapshot; see
        # FlatEngine._State) nor rebuild the same version twice.
        with self._rebuild_lock:
            v = self._version_fn() if self._version_fn else 0
            if v != self._built_version:
                t0 = time.perf_counter()
                data = self._data_fn()
                if os.environ.get("ZVEC_BUILD_LOG") == "1":
                    print(
                        f"[engine] data fetched in "
                        f"{time.perf_counter() - t0:.1f}s",
                        flush=True,
                    )
                self._rebuild(data)
                self._built_version = v
                dt = time.perf_counter() - t0
                self.stats.rows_built = len(data) if data is not None else 0
                self.stats.build_count += 1
                self.stats.last_build_secs = dt
                self.stats.total_build_secs += dt

    # ---- to implement ----
    def _rebuild(self, data: np.ndarray) -> None:
        raise NotImplementedError

    def _search_impl(
        self,
        queries: np.ndarray,
        topk: int,
        mask: Optional[np.ndarray],
        param: Optional[QueryParam],
    ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _search_dispatch(
        self,
        queries: np.ndarray,
        topk: int,
        mask: Optional[np.ndarray],
        param: Optional[QueryParam],
    ):
        """Optional two-phase search: enqueue the device program and return an
        opaque handle for `_search_finalize`, or None if this engine only
        supports blocking search. Engines that override this let callers
        pipeline several query batches: the host work of batch i+1 overlaps
        the card's work on batch i (not measured on the card)."""
        return None

    def _search_finalize(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _fetch(self, *tensors) -> Tuple[np.ndarray, ...]:
        """The device tensors as host arrays: the host blocks on the card
        until they are written, then copies them (the span `engine.wait`)."""
        with span("engine.wait", self.trace_detail):
            return tuple(t.cpu().numpy() for t in tensors)

    def _normalize_query_args(self, queries, mask):
        if getattr(self, "_hamming", False):
            # packed binary queries: keep the uint words intact (a float32
            # cast would corrupt words past 2^24)
            queries = np.atleast_2d(np.asarray(queries))
        else:
            queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        n = getattr(self, "_n", None)
        if mask is not None and n is not None:
            mask = fit_row_mask(mask, n)
        return queries, mask

    # ---- public ----
    def search(
        self,
        queries: np.ndarray,
        topk: int,
        mask: Optional[np.ndarray] = None,
        param: Optional[QueryParam] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched top-k: returns (similarity (Q,k) desc, local indices (Q,k);
        invalid slots have index -1)."""
        self._ensure_fresh()
        queries, mask = self._normalize_query_args(queries, mask)
        t0 = time.perf_counter()
        out = self._search_impl(queries, topk, mask, param)
        self.stats.search_count += 1
        self.stats.queries_served += queries.shape[0]
        self.stats.total_search_secs += time.perf_counter() - t0
        return out

    def search_async(
        self,
        queries: np.ndarray,
        topk: int,
        mask: Optional[np.ndarray] = None,
        param: Optional[QueryParam] = None,
    ) -> Callable[[], Tuple[np.ndarray, np.ndarray]]:
        """Dispatch a search and return finalize() -> (sims, idx).

        Engines without a dispatch/finalize split run the search eagerly and
        return its (already computed) result from finalize — callers get
        pipelining where the engine supports it and identical semantics
        everywhere. Engines that override `search` wholesale (sparse: dict
        queries that must not be float32-cast) take the eager path before any
        normalization."""
        if type(self).search is not VectorIndexEngine.search or (
            type(self)._search_dispatch is VectorIndexEngine._search_dispatch
        ):
            out = self.search(queries, topk, mask, param)
            return lambda: out
        self._ensure_fresh()
        queries, mask = self._normalize_query_args(queries, mask)
        t0 = time.perf_counter()
        handle = self._search_dispatch(queries, topk, mask, param)
        if handle is None:
            out = self._search_impl(queries, topk, mask, param)
            self.stats.search_count += 1
            self.stats.queries_served += queries.shape[0]
            self.stats.total_search_secs += time.perf_counter() - t0
            return lambda: out

        def finalize():
            with span("engine.finalize", self.trace_detail):
                out = self._search_finalize(handle)
            self.stats.search_count += 1
            self.stats.queries_served += queries.shape[0]
            self.stats.total_search_secs += time.perf_counter() - t0
            return out

        return finalize

    # ---- persistence hooks (index-specific auxiliary state, e.g. HNSW graph) ----
    def dump_aux(self, directory: str, prefix: str) -> Dict[str, Any]:
        """Persist auxiliary structures; returns a descriptor dict stored in the
        segment manifest. Flat engines need none."""
        return {}

    def load_aux(self, directory: str, descriptor: Dict[str, Any]) -> None:
        pass


_REGISTRY: Dict[IndexType, type] = {}


def expected_query_param_class(index_type: IndexType) -> Optional[type]:
    """QueryParam subclass the registered engine for `index_type` accepts
    (None when the index type has no registered engine). Dense and sparse
    engines of one index type share the same param class."""
    cls = _REGISTRY.get(IndexType(index_type))
    return getattr(cls, "query_param_class", None) if cls is not None else None


def register_engine(index_type: IndexType):
    def deco(cls):
        _REGISTRY[index_type] = cls
        cls.index_type = index_type
        return cls

    return deco


def create_engine(
    params: VectorIndexParam, dimension: int, *, force_flat: bool = False
) -> VectorIndexEngine:
    """Factory: engine from index params (string-keyed plugin registry in the
    reference; enum-keyed here)."""
    # Imports deferred to avoid import cycles; importing registers the engines.
    from . import flat, hnsw, ivf  # noqa: F401

    itype = IndexType.FLAT if force_flat else params.index_type
    cls = _REGISTRY.get(itype)
    if cls is None:
        raise ValueError(f"no engine registered for {itype}")
    return cls(params.metric_type, dimension, params)
