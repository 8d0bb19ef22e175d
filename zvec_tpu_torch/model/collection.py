"""Public Collection API.

Method-for-method parity with the reference Python surface
(`python/zvec/model/collection.py:44-379`): DDL (create_index/drop_index/
optimize/add_column/drop_column/alter_column), DML (insert/upsert/update/
delete/delete_by_filter), DQL (query/fetch), plus path/option/schema/stats
properties, flush/destroy — backed by `zvec_tpu_torch.db.CollectionImpl`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

from ..db.collection_impl import CollectionImpl
from ..executor.query_executor import QueryContext, QueryExecutorFactory
from ..extension.rerank_function import RerankFunction
from ..typing.status import Status
from .doc import Doc
from .param.param import (
    AddColumnOption,
    AlterColumnOption,
    CollectionOption,
    FlatIndexParam,
    HnswIndexParam,
    IndexOption,
    InvertIndexParam,
    IVFIndexParam,
    OptimizeOption,
)
from .param.vector_query import VectorQuery
from .schema import CollectionSchema, CollectionStats, FieldSchema

__all__ = ["Collection"]

_VECTOR_INDEX_TYPES = (HnswIndexParam, IVFIndexParam, FlatIndexParam)


class Collection:
    """An opened collection. Obtained via `zvec_tpu_torch.create_and_open()` or
    `zvec_tpu_torch.open()`; not instantiated directly."""

    def __init__(self, impl: CollectionImpl, option: Optional[CollectionOption] = None):
        self._impl = impl
        self._option = option or CollectionOption()
        self._querier = QueryExecutorFactory.create(impl.schema)

    def __reduce__(self):
        """Pickle as (path, option); unpickling re-opens the collection
        (reference `python_collection.cc:56-70` py::pickle support)."""
        from .. import zvec as _zvec

        return (_zvec.open, (self._impl.path, self._option))

    # ========== properties ==========
    @property
    def path(self) -> str:
        return self._impl.path

    @property
    def option(self) -> CollectionOption:
        return self._option

    @property
    def schema(self) -> CollectionSchema:
        return self._impl.schema

    @property
    def stats(self) -> CollectionStats:
        return self._impl.stats()

    # ========== collection DDL ==========
    def destroy(self) -> None:
        """Permanently delete the collection from disk. Irreversible."""
        self._impl.destroy()

    def flush(self) -> None:
        """Force all pending writes to durable storage."""
        self._impl.flush()

    # ========== index DDL ==========
    def create_index(
        self,
        field_name: str,
        index_param: Union[
            HnswIndexParam, IVFIndexParam, FlatIndexParam, InvertIndexParam
        ],
        option: IndexOption = IndexOption(),
    ) -> None:
        if isinstance(index_param, _VECTOR_INDEX_TYPES) and not self.schema.vector(
            field_name
        ):
            supported = ", ".join(c.__name__ for c in _VECTOR_INDEX_TYPES)
            raise ValueError(
                f"Cannot apply vector index to non-vector field '{field_name}'. "
                f"The field must be of vector type to use index types like {supported}."
            )
        self._impl.create_index(field_name, index_param, option.concurrency)
        self._refresh()

    def drop_index(self, field_name: str) -> None:
        self._impl.drop_index(field_name)
        self._refresh()

    def optimize(self, option: OptimizeOption = OptimizeOption()) -> None:
        self._impl.optimize(option.concurrency)

    # ========== column DDL ==========
    def add_column(
        self,
        field_schema: FieldSchema,
        expression: str = "",
        option: AddColumnOption = AddColumnOption(),
    ) -> None:
        self._impl.add_column(field_schema, expression)
        self._refresh()

    def drop_column(self, field_name: str) -> None:
        self._impl.drop_column(field_name)
        self._refresh()

    def alter_column(
        self,
        old_name: str,
        new_name: Optional[str] = None,
        field_schema: Optional[FieldSchema] = None,
        option: AlterColumnOption = AlterColumnOption(),
    ) -> None:
        self._impl.alter_column(old_name, new_name or "", field_schema)
        self._refresh()

    def _refresh(self) -> None:
        self._querier = QueryExecutorFactory.create(self._impl.schema)

    # ========== DML ==========
    def insert(self, docs: Union[Doc, List[Doc]]) -> Union[Status, List[Status]]:
        is_single = isinstance(docs, Doc)
        results = self._impl.insert([docs] if is_single else docs)
        return results[0] if is_single else results

    def upsert(self, docs: Union[Doc, List[Doc]]) -> Union[Status, List[Status]]:
        is_single = isinstance(docs, Doc)
        results = self._impl.upsert([docs] if is_single else docs)
        return results[0] if is_single else results

    def update(self, docs: Union[Doc, List[Doc]]) -> Union[Status, List[Status]]:
        is_single = isinstance(docs, Doc)
        results = self._impl.update([docs] if is_single else docs)
        return results[0] if is_single else results

    def delete(self, ids: Union[str, List[str]]) -> Union[Status, List[Status]]:
        is_single = isinstance(ids, str)
        results = self._impl.delete([ids] if is_single else ids)
        return results[0] if is_single else results

    def delete_by_filter(self, filter: str) -> None:
        self._impl.delete_by_filter(filter)

    # ========== DQL ==========
    def fetch(self, ids: Union[str, List[str]]) -> Dict[str, Doc]:
        ids = [ids] if isinstance(ids, str) else ids
        return self._impl.fetch(ids)

    def scan(
        self,
        columns: Optional[List[str]] = None,
        *,
        filter: Optional[str] = None,
        batch_size: int = 65536,
    ):
        """Stream the collection as Arrow RecordBatches (bulk export /
        reindex / analytics path; reference `Segment::scan`,
        `segment.cc:2627`). Deleted docs are skipped; `filter` restricts to
        matching rows; `columns` projects scalar/vector columns (the "id"
        pk column always leads). Collect with
        `pyarrow.Table.from_batches(col.scan(...))`."""
        return self._impl.scan(columns, filter, batch_size)

    def query(
        self,
        vectors: Optional[Union[VectorQuery, List[VectorQuery]]] = None,
        *,
        topk: int = 10,
        filter: Optional[str] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
        reranker: Optional[RerankFunction] = None,
    ) -> List[Doc]:
        """Vector similarity search with optional filtering and re-ranking."""
        ctx = QueryContext(
            topk=topk,
            filter=filter,
            queries=[vectors] if isinstance(vectors, VectorQuery) else vectors,
            include_vector=include_vector,
            output_fields=output_fields,
            reranker=reranker,
        )
        return self._querier.execute(ctx, self._impl)

    def batch_query(
        self,
        field_name: str,
        vectors,
        *,
        topk: int = 10,
        filter: Optional[str] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
        param=None,
    ) -> List[List[Doc]]:
        """Batched search: score a (B, D) block of queries in one device
        dispatch and return one ranked Doc list per row. The TPU-idiomatic
        face of the reference's intra-query threading (SURVEY §2.9);
        `output_fields=[]` returns id+score only (core-bench shape)."""
        return self._impl.batch_query(
            field_name,
            vectors,
            topk=topk,
            filter_str=filter,
            include_vector=include_vector,
            output_fields=output_fields,
            param=param,
        )

    def batch_fused_query(
        self,
        groups: List[List[VectorQuery]],
        *,
        topk: int = 10,
        filter: Optional[str] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
        reranker: Optional[RerankFunction] = None,
    ) -> List[List[Doc]]:
        """Batched multi-vector (fusion) search: each element of `groups` is
        the `vectors` list of one fused query; all queries' rows for a given
        field ride ONE device dispatch per segment, and per-query reranking
        (RRF/weighted) happens on host afterwards. Equivalent to
        [self.query(g, topk=..., reranker=...) for g in groups] but
        latency-amortized — the TPU-idiomatic face of running many hybrid
        dense+sparse queries concurrently (no reference analog; its Python
        surface is one query per call, `query_executor.py:119-307`)."""
        ctxs = [
            QueryContext(
                topk=topk,
                filter=filter,
                queries=[g] if isinstance(g, VectorQuery) else g,
                include_vector=include_vector,
                output_fields=output_fields,
                reranker=reranker,
            )
            for g in groups
        ]
        return self._querier.execute_batch(ctxs, self._impl)

    def batch_query_many(
        self,
        field_name: str,
        blocks,
        *,
        topk: int = 10,
        filter: Optional[str] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
        param=None,
    ) -> List[List[List[Doc]]]:
        """Pipelined batched search over several (B, D) query blocks: all
        blocks' device programs are dispatched before the first result is
        collected, overlapping upload/dispatch with device compute
        (sustained-throughput shape). Equivalent to
        [batch_query(field_name, b, ...) for b in blocks]."""
        return self._impl.batch_query_many(
            field_name,
            blocks,
            topk=topk,
            filter_str=filter,
            include_vector=include_vector,
            output_fields=output_fields,
            param=param,
        )

    def group_by_query(
        self,
        vectors: Optional[Union[VectorQuery, List[VectorQuery]]] = None,
        *,
        group_by_field: Optional[str] = None,
        group_count: int = 10,
        group_topk: int = 2,
        filter: Optional[str] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
        reranker: Optional[RerankFunction] = None,
    ) -> List[Doc]:
        """Group-by search: best `group_topk` docs for each of the top
        `group_count` groups (reference `_Collection.GroupByQuery`,
        `python_collection.cc:203`; C++-only there, exposed here).

        Accepts a `GroupByVectorQuery` (reference typed query object,
        `doc.h:370`) carrying its own group params, a plain VectorQuery with
        the group kwargs, or a LIST of queries (multi-vector grouped fused
        search — requires a reranker, like `query`)."""
        from ..model.param.vector_query import GroupByVectorQuery

        qs = vectors if isinstance(vectors, list) else [vectors]
        for q in qs:
            if isinstance(q, GroupByVectorQuery):
                group_by_field = group_by_field or q.group_by_field
                group_count = q.group_count
                group_topk = q.group_topk
                break
        if not group_by_field:
            raise ValueError("group_by_query requires group_by_field")
        if len(qs) > 1:
            return self._grouped_multi_vector(
                qs, group_by_field, group_count, group_topk,
                filter, include_vector, output_fields, reranker,
            )
        return self._impl.group_by_query(
            qs[0],
            group_by_field=group_by_field,
            group_count=group_count,
            group_topk=group_topk,
            filter_str=filter,
            include_vector=include_vector,
            output_fields=output_fields,
        )

    def _grouped_multi_vector(
        self, qs, group_by_field, group_count, group_topk,
        filter, include_vector, output_fields, reranker,
    ) -> List[Doc]:
        """Grouped fused search: rerank the multi-vector fusion at growing
        overscan until `group_count` groups hold `group_topk` docs each
        (same iterative-deepening guarantee as the single-vector path)."""
        if self._impl.schema.field(group_by_field) is None:
            raise ValueError(f"unknown group-by field '{group_by_field}'")
        total = self._impl.stats().doc_count
        overscan = max(group_count * group_topk * 4, 64)
        while True:
            res = self.query(
                qs, topk=min(overscan, max(total, 1)), filter=filter,
                include_vector=include_vector, output_fields=None,
                reranker=reranker,
            )
            groups: Dict = {}
            order: List = []
            satisfied = 0
            for doc in res:
                key = doc.fields.get(group_by_field)
                key = str(key) if isinstance(key, (list, tuple)) else key
                lst = groups.setdefault(key, [])
                if key not in order:
                    order.append(key)
                if len(lst) < group_topk:
                    lst.append(doc)
                    if len(lst) == group_topk:
                        satisfied += 1
            if satisfied >= group_count or len(res) < overscan or overscan >= total:
                break
            overscan = min(overscan * 4, max(total, 1))
        out: List[Doc] = []
        for key in order[:group_count]:
            for doc in groups[key]:
                if output_fields is not None and doc.fields:
                    doc.fields = {
                        k: v for k, v in doc.fields.items() if k in output_fields
                    }
                out.append(doc)
        return out
