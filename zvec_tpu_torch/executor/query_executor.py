"""Query executors: validate -> build -> execute -> merge/rerank.

Parity with the reference executor framework (`python/zvec/executor/
query_executor.py:119-307`): the factory picks No/Single/MultiVector executor
from the schema's vector count; multi-vector requires a reranker; query-by-id
fetches the stored vector first; per-field execution may run thread-parallel
(`ZVEC_QUERY_CONCURRENCY`).
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List, Optional

import numpy as np

from ..db.collection_impl import CollectionImpl
from ..extension.multi_vector_reranker import RrfReRanker, WeightedReRanker
from ..extension.rerank_function import RerankFunction
from ..model.doc import Doc
from ..model.param.vector_query import VectorQuery
from ..model.schema import CollectionSchema
from ..typing.enum import DataType

__all__ = [
    "QueryContext",
    "QueryExecutor",
    "QueryExecutorFactory",
    "NoVectorQueryExecutor",
    "SingleVectorQueryExecutor",
    "MultiVectorQueryExecutor",
]

# numpy dtype coercion per vector schema (reference DTYPE_MAP, `query_executor.py:38`)
DTYPE_MAP = {
    DataType.VECTOR_FP16: np.float16,
    DataType.VECTOR_FP32: np.float32,
    DataType.VECTOR_FP64: np.float64,
    DataType.VECTOR_INT8: np.int8,
    DataType.VECTOR_INT16: np.int16,
    DataType.VECTOR_INT4: np.int8,  # queries arrive unpacked (D values in [-8, 7])
}


class QueryContext:
    def __init__(
        self,
        topk: int = 10,
        filter: Optional[str] = None,
        queries: Optional[List[VectorQuery]] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
        reranker: Optional[RerankFunction] = None,
    ):
        self.topk = topk
        self.filter = filter
        self.queries = queries or []
        self.include_vector = include_vector
        self.output_fields = output_fields
        self.reranker = reranker


class _BuiltQuery:
    __slots__ = ("field_name", "vector", "param")

    def __init__(self, field_name: str, vector, param):
        self.field_name = field_name
        self.vector = vector
        self.param = param


class QueryExecutor(ABC):
    def __init__(self, schema: CollectionSchema):
        self._schema = schema
        # default 0 = auto: one worker per vector field (host-side mask
        # build/transfer prep of the per-field searches overlaps; the device
        # serializes kernels regardless, and the merge assembles in query
        # order so results are identical to the serial path). The reference
        # defaults to serial (`query_executor.py:122`) — auto is this
        # port's choice; set ZVEC_QUERY_CONCURRENCY=1 to match serial.
        self._concurrency = max(0, int(os.getenv("ZVEC_QUERY_CONCURRENCY", "0")))

    @abstractmethod
    def _do_validate(self, ctx: QueryContext) -> None:
        ...

    @abstractmethod
    def _do_build(self, ctx: QueryContext, impl: CollectionImpl) -> List[_BuiltQuery]:
        ...

    def _build_one(
        self, ctx: QueryContext, query: VectorQuery, impl: CollectionImpl
    ) -> _BuiltQuery:
        query._validate()
        vs = self._schema.vector(query.field_name)
        if vs is None:
            raise ValueError(f"unknown vector field '{query.field_name}'")
        if query.has_vector():
            vec = query.vector
        else:
            # query-by-id: fetch the stored vector (`query_executor.py:163-170`)
            fetched = impl.fetch([query.id])
            if query.id not in fetched:
                raise ValueError(f"query doc id '{query.id}' not found")
            vec = fetched[query.id].vector(vs.name)
            if vec is None:
                raise ValueError(
                    f"doc '{query.id}' has no vector for field '{vs.name}'"
                )
        if vs.data_type.is_sparse_vector:
            if not isinstance(vec, dict):
                raise ValueError(
                    f"sparse field '{vs.name}' requires a dict query vector"
                )
            built_vec = {int(k): float(v) for k, v in vec.items()}
        elif vs.data_type in (DataType.VECTOR_BINARY32, DataType.VECTOR_BINARY64):
            from ..db.validate import coerce_binary_vector

            built_vec, err = coerce_binary_vector(vec, vs)
            if err:
                raise ValueError(f"query vector for '{vs.name}': {err}")
        else:
            target = DTYPE_MAP.get(vs.data_type, np.float32)
            built_vec = np.asarray(vec, dtype=target)
            if built_vec.shape != (vs.dimension,):
                raise ValueError(
                    f"query vector for '{vs.name}' has shape {built_vec.shape}, "
                    f"expected ({vs.dimension},)"
                )
        return _BuiltQuery(query.field_name, built_vec, query.param)

    def _do_execute(
        self, ctx: QueryContext, built: List[_BuiltQuery], impl: CollectionImpl
    ) -> Dict[str, List[Doc]]:
        def run(bq: _BuiltQuery) -> List[Doc]:
            return impl.query(
                bq.field_name,
                bq.vector,
                topk=ctx.topk,
                filter_str=ctx.filter,
                include_vector=ctx.include_vector,
                output_fields=ctx.output_fields,
                param=bq.param,
            )

        if len(built) == 1:
            return {bq.field_name: run(bq) for bq in built}
        workers = self._concurrency
        if workers and workers > 1:
            # explicit thread fan-out (reference semantics,
            # ZVEC_QUERY_CONCURRENCY / `query_executor.py:196-211`)
            done: Dict[str, List[Doc]] = {}
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futures = {pool.submit(run, bq): bq.field_name for bq in built}
                for future in as_completed(futures):
                    done[futures[future]] = future.result()
            # assemble in query order: reranker tie-breaks must not depend
            # on thread completion order (deterministic vs serial path)
            return {bq.field_name: done[bq.field_name] for bq in built}
        # dense+sparse pair: ONE device program scoring both fields
        # (`ops/fused.py`) — a single round trip instead of two overlapped
        # ones; falls through to the overlapped path when unsupported
        fused = self._fused_pair(ctx, built, impl)
        if fused is not None:
            return fused
        # default: dispatch/finalize split — every field's search is
        # launched on the card before the first result is fetched, so the
        # host work of field i+1 overlaps the card's work on field i
        fins = [
            (
                bq.field_name,
                impl.query_dispatch(
                    bq.field_name,
                    bq.vector,
                    topk=ctx.topk,
                    filter_str=ctx.filter,
                    include_vector=ctx.include_vector,
                    output_fields=ctx.output_fields,
                    param=bq.param,
                ),
            )
            for bq in built
        ]
        return {name: fin() for name, fin in fins}

    def _split_dense_sparse_pair(self, built: List[_BuiltQuery]):
        """(dense_bq, sparse_bq) when `built` is exactly one fp32-dense +
        one sparse field, else None."""
        if len(built) != 2:
            return None
        dense = sparse = None
        for bq in built:
            vs = self._schema.vector(bq.field_name)
            if vs.data_type.is_sparse_vector:
                sparse = bq
            elif vs.data_type == DataType.VECTOR_FP32:
                dense = bq
        if dense is None or sparse is None:
            return None
        return dense, sparse

    def _fused_pair(
        self, ctx: QueryContext, built: List[_BuiltQuery], impl: CollectionImpl
    ) -> Optional[Dict[str, List[Doc]]]:
        pair = self._split_dense_sparse_pair(built)
        if pair is None:
            return None
        dense, sparse = pair
        segs = impl._segments_snapshot()
        fin = impl.fused_pair_dispatch(
            dense.field_name,
            np.asarray(dense.vector, np.float32)[None, :],
            sparse.field_name,
            [sparse.vector],
            ctx.topk,
            ctx.filter,
            dense.param,
            sparse.param,
            segs,
        )
        if fin is None:
            return None
        results = fin()
        return {
            field: impl._docs_from_results(
                sims, ids, self._schema.vector(field), segs,
                ctx.include_vector, ctx.output_fields,
            )[0]
            for field, (sims, ids) in results.items()
        }

    def _do_merge_rerank_results(
        self, ctx: QueryContext, docs_map: Dict[str, List[Doc]]
    ) -> List[Doc]:
        if not docs_map:
            raise ValueError("Query results is none")
        if len(docs_map) == 1:
            if not ctx.reranker or isinstance(
                ctx.reranker, (RrfReRanker, WeightedReRanker)
            ):
                return next(iter(docs_map.values()))
            return ctx.reranker.rerank(docs_map)
        return ctx.reranker.rerank(docs_map)

    def execute(self, ctx: QueryContext, impl: CollectionImpl) -> List[Doc]:
        self._do_validate(ctx)
        built = self._do_build(ctx, impl)
        if not built:
            # filter-only query (no VectorQuery): the reference builds a
            # query-without-vector and scans (`query_executor.py:134-142`,
            # `:267-272`) — valid on vector-bearing collections too
            return self._execute_scan(ctx, impl)
        docs = self._do_execute(ctx, built, impl)
        return self._do_merge_rerank_results(ctx, docs)

    def _execute_scan(self, ctx: QueryContext, impl: CollectionImpl) -> List[Doc]:
        """Filter-only scan: up to topk alive docs matching the filter, in
        doc order (reference `test_collection_dql.py:283-308` expects
        insertion-ordered results for vector-less queries)."""
        doc_ids = impl._filter_only_doc_ids(ctx.filter or None)[: ctx.topk]
        return [
            impl._materialize_doc(d, None, ctx.include_vector, ctx.output_fields)
            for d in doc_ids
        ]

    def execute_batch(
        self, ctxs: List[QueryContext], impl: CollectionImpl
    ) -> List[List[Doc]]:
        """Batched fused search: run many (multi-vector) queries in ONE device
        dispatch per (field, segment), then rerank each query on host.

        A single fused query costs one search on the card per vector field;
        batching B queries amortizes that to B rows of the same scan. All
        fields are launched before any is finalized, so the dense and sparse
        searches overlap on the card. Semantically identical to
        [self.execute(ctx, impl) for ctx in ctxs] (shared topk/filter/output
        options required — they parameterize the shared searches).
        """
        if not ctxs:
            return []
        head = ctxs[0]
        knobs = (head.topk, head.filter, head.include_vector,
                 tuple(head.output_fields) if head.output_fields is not None else None)
        built_groups: List[List[_BuiltQuery]] = []
        for ctx in ctxs:
            k = (ctx.topk, ctx.filter, ctx.include_vector,
                 tuple(ctx.output_fields) if ctx.output_fields is not None else None)
            if k != knobs:
                raise ValueError(
                    "batched fused queries must share topk/filter/"
                    "include_vector/output_fields"
                )
            self._do_validate(ctx)
            built = self._do_build(ctx, impl)
            if not built:
                raise ValueError("No query to execute")
            built_groups.append(built)
        # bucket rows per field, remembering which query each row belongs to
        field_rows: Dict[str, list] = {}
        field_param: Dict[str, object] = {}
        for gi, built in enumerate(built_groups):
            for bq in built:
                field_rows.setdefault(bq.field_name, []).append((gi, bq.vector))
                field_param.setdefault(bq.field_name, bq.param)
        segs = impl._segments_snapshot()
        per_field_docs: Dict[str, List[List[Doc]]] = {}
        # dense+sparse pair with every query supplying both fields: ONE
        # device program per segment for the whole batch (`ops/fused.py`)
        fused_fin = None
        if len(field_rows) == 2:
            names = list(field_rows)
            aligned = all(
                [gi for gi, _ in field_rows[f]] == list(range(len(ctxs)))
                for f in names
            )
            sparse_names = [
                f for f in names
                if self._schema.vector(f).data_type.is_sparse_vector
            ]
            dense_names = [
                f for f in names
                if self._schema.vector(f).data_type == DataType.VECTOR_FP32
            ]
            if aligned and len(sparse_names) == 1 and len(dense_names) == 1:
                df, sf = dense_names[0], sparse_names[0]
                fused_fin = impl.fused_pair_dispatch(
                    df,
                    np.stack([v for _, v in field_rows[df]], axis=0),
                    sf,
                    [v for _, v in field_rows[sf]],
                    head.topk,
                    head.filter,
                    field_param[df],
                    field_param[sf],
                    segs,
                )
        if fused_fin is not None:
            for field, (sims, ids) in fused_fin().items():
                per_field_docs[field] = impl._docs_from_results(
                    sims, ids, self._schema.vector(field), segs,
                    head.include_vector, head.output_fields,
                )
        else:
            dispatches = {}
            for field, rows in field_rows.items():
                vs = self._schema.vector(field)
                if vs.data_type.is_sparse_vector:
                    vecs = [v for _, v in rows]
                else:
                    vecs = np.stack([v for _, v in rows], axis=0)
                dispatches[field] = impl._query_field_dispatch(
                    field, vecs, head.topk, head.filter, field_param[field],
                    segs,
                )
            for field, finalize in dispatches.items():
                sims, ids = finalize()
                per_field_docs[field] = impl._docs_from_results(
                    sims, ids, self._schema.vector(field), segs,
                    head.include_vector, head.output_fields,
                )
        maps: List[Dict[str, List[Doc]]] = [dict() for _ in ctxs]
        for field, rows in field_rows.items():
            for row_idx, (gi, _) in enumerate(rows):
                maps[gi][field] = per_field_docs[field][row_idx]
        return [
            self._do_merge_rerank_results(ctx, docs_map)
            for ctx, docs_map in zip(ctxs, maps)
        ]


class NoVectorQueryExecutor(QueryExecutor):
    """Filter-only scan for schemas without vector fields."""

    def _do_validate(self, ctx: QueryContext) -> None:
        if ctx.queries:
            raise ValueError("collection has no vector fields; pass vectors=None")

    def _do_build(self, ctx, impl):
        return []

    def execute_batch(self, ctxs, impl):
        # no device program to batch: filter-only scans run sequentially
        return [self.execute(ctx, impl) for ctx in ctxs]


class SingleVectorQueryExecutor(QueryExecutor):
    def _do_validate(self, ctx: QueryContext) -> None:
        # zero queries is valid: filter-only scan (reference
        # `query_executor.py:267-272`)
        if len(ctx.queries) > 1:
            raise ValueError(
                "multiple VectorQuery on a single-vector collection"
            )
        for query in ctx.queries:
            query._validate()

    def _do_build(self, ctx, impl):
        return [self._build_one(ctx, q, impl) for q in ctx.queries]


class MultiVectorQueryExecutor(QueryExecutor):
    def _do_validate(self, ctx: QueryContext) -> None:
        # zero queries is valid: filter-only scan (reference behavior)
        names = [q.field_name for q in ctx.queries]
        if len(set(names)) != len(names):
            raise ValueError("duplicate vector fields in query")
        if len(ctx.queries) > 1 and ctx.reranker is None:
            raise ValueError(
                "multi-vector query requires a reranker (`query_executor.py:283`)"
            )

    def _do_build(self, ctx, impl):
        return [self._build_one(ctx, q, impl) for q in ctx.queries]


class QueryExecutorFactory:
    @staticmethod
    def create(schema: CollectionSchema) -> QueryExecutor:
        n = len(schema.vectors)
        if n == 0:
            return NoVectorQueryExecutor(schema)
        if n == 1:
            return SingleVectorQueryExecutor(schema)
        return MultiVectorQueryExecutor(schema)
