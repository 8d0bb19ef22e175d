"""Segment: one storage unit of a collection.

Reference equivalent: `src/db/index/segment/segment.cc` — a segment owns its
WAL, forward store, per-vector-column engines, and a contiguous doc_id range
[doc_id_start, doc_id_start + count). Write path mirrors
`segment.cc:780-858`: WAL append is the durability point, then the doc is
applied to the forward store and the (lazily rebuilt) vector engines.

Difference on the card: vector "indexers" are array engines whose device state
rebuilds from the forward store's dense matrix on demand — incremental graph
mutation is replaced by rebuild-on-flush (the reference itself rebuilds on
create_index/merge, `segment.cc:1591-1700`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.interface import VectorIndexEngine, create_engine
from ..model.param.param import QueryParam, VectorIndexParam
from ..model.schema import CollectionSchema
from ..typing.enum import DataType, IndexType
from .forward_store import ForwardStore
from .version import SegmentMeta
from .wal import WalFile

__all__ = ["Segment"]

FORWARD_FILE = "forward.arrow"


def wal_filename(gen: int) -> str:
    return f"wal_{gen}.log"


def ckpt_filename(gen: int) -> str:
    return f"ckpt_{gen}.arrow"


class Segment:
    def __init__(
        self,
        directory: str,
        meta: SegmentMeta,
        schema: CollectionSchema,
        store: ForwardStore,
        wal: Optional[WalFile],
    ):
        self.directory = directory
        self.meta = meta
        self.schema = schema
        self.store = store
        self.wal = wal
        self._engines: Dict[str, VectorIndexEngine] = {}
        self._write_version = 0
        # field -> params used to build a full (non-flat) index on this segment
        self._built_index_params: Dict[str, VectorIndexParam] = {}
        # field -> inverted scalar index (sealed segments only)
        self._inverted: Dict[str, "InvertedColumnIndex"] = {}

    # ------------- lifecycle -------------
    @classmethod
    def create(
        cls, root: str, meta: SegmentMeta, schema: CollectionSchema
    ) -> "Segment":
        directory = os.path.join(root, meta.dirname)
        os.makedirs(directory, exist_ok=True)
        wal = WalFile(os.path.join(directory, wal_filename(meta.gen)))
        return cls(directory, meta, schema, ForwardStore(schema), wal)

    @classmethod
    def open_sealed(
        cls, root: str, meta: SegmentMeta, schema: CollectionSchema,
        use_mmap: bool = True,
    ) -> "Segment":
        directory = os.path.join(root, meta.dirname)
        store = ForwardStore.load(
            schema, os.path.join(directory, FORWARD_FILE), use_mmap
        )
        seg = cls(directory, meta, schema, store, None)
        seg._load_built_indexes()
        seg._load_inverted_indexes()
        return seg

    @classmethod
    def open_writing(
        cls, root: str, meta: SegmentMeta, schema: CollectionSchema
    ) -> "Segment":
        """Reopen the writing segment; caller replays its WAL through
        `apply_*` to reconstruct in-memory state."""
        directory = os.path.join(root, meta.dirname)
        wal = WalFile(os.path.join(directory, wal_filename(meta.gen)))
        return cls(directory, meta, schema, ForwardStore(schema), wal)

    def _load_built_indexes(self) -> None:
        from ..model.schema import _index_param_from_dict

        for field, desc in self.meta.indexes.items():
            params = _index_param_from_dict(desc.get("params"))
            vs = self.schema.vector(field)
            if vs is None or params is None:
                continue
            if vs.data_type.is_sparse_vector:
                from ..core.hnsw_sparse import SparseHnswEngine

                engine = SparseHnswEngine(params=params)
                engine.bind_data(
                    lambda f=field: self.store.sparse_rows(f),
                    lambda: self._write_version,
                )
            else:
                engine = create_engine(params, vs.dimension)
                engine.bind_data(
                    lambda f=field: self.store.dense_matrix(f),
                    lambda: self._write_version,
                )
            engine.load_aux(self.directory, desc.get("aux", {}))
            self._engines[field] = engine
            self._built_index_params[field] = params

    # ------------- write path -------------
    @property
    def doc_count(self) -> int:
        return self.store.count

    @property
    def doc_id_start(self) -> int:
        return self.meta.doc_id_start

    def contains_doc_id(self, doc_id: int) -> bool:
        return self.doc_id_start <= doc_id < self.doc_id_start + self.doc_count

    def append_wal(self, payload: bytes) -> None:
        self.wal.append(payload)

    def wal_sync(self) -> None:
        self.wal.flush()

    def apply_insert(self, pk: str, fields: Dict[str, Any], vectors: Dict[str, Any]) -> int:
        """Apply an insert (post-WAL). Returns the allocated doc_id."""
        local = self.store.append(pk, fields, vectors)
        self.meta.doc_count = self.store.count
        self._write_version += 1
        return self.doc_id_start + local

    def apply_insert_batch(self, pks, fields_list, vectors_list) -> int:
        """Batch apply_insert (bulk-insert fast path). Returns the doc_id of
        the first inserted doc; the batch gets consecutive doc_ids."""
        local = self.store.append_batch(pks, fields_list, vectors_list)
        self.meta.doc_count = self.store.count
        self._write_version += 1
        return self.doc_id_start + local

    # ------------- search path -------------
    def engine_for(self, field: str) -> VectorIndexEngine:
        engine = self._engines.get(field)
        if engine is None:
            vs = self.schema.vector(field)
            if vs.data_type.is_sparse_vector:
                from ..core.sparse_flat import SparseFlatEngine

                engine = SparseFlatEngine(params=vs.index_param)
                engine.bind_data(
                    lambda f=field: self.store.sparse_rows(f),
                    lambda: self._write_version,
                )
            else:
                # Writing segments scan flat regardless of the schema's index
                # type (the reference's brute-force-below-threshold behavior,
                # `hnsw_params.h:42`); sealed segments use their built index.
                engine = create_engine(vs.index_param, vs.dimension, force_flat=True)
                if vs.data_type in (
                    DataType.VECTOR_BINARY32,
                    DataType.VECTOR_BINARY64,
                ):
                    # packed bit words: a float32 cast would corrupt values
                    # past 2^24; the hamming engine unpacks them itself
                    engine.bind_data(
                        lambda f=field: self.store.dense_matrix(f),
                        lambda: self._write_version,
                    )
                else:
                    engine.bind_data(
                        lambda f=field: np.asarray(
                            self.store.dense_matrix(f), dtype=np.float32
                        ),
                        lambda: self._write_version,
                    )
            self._engines[field] = engine
        return engine

    def search(
        self,
        field: str,
        queries: np.ndarray,
        topk: int,
        alive_mask: Optional[np.ndarray] = None,
        param: Optional[QueryParam] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (similarity (Q,k), global doc_ids (Q,k), -1 = invalid)."""
        if self.doc_count == 0:
            if isinstance(queries, dict):
                nq = 1
            elif isinstance(queries, list):
                nq = len(queries)
            else:
                nq = np.atleast_2d(queries).shape[0]
            return (
                np.full((nq, topk), -np.inf, dtype=np.float32),
                np.full((nq, topk), -1, dtype=np.int64),
            )
        engine = self.engine_for(field)
        sims, idx = engine.search(queries, topk, alive_mask, param)
        doc_ids = np.where(idx >= 0, idx + self.doc_id_start, -1)
        return sims, doc_ids

    def search_async(
        self,
        field: str,
        queries: np.ndarray,
        topk: int,
        alive_mask: Optional[np.ndarray] = None,
        param: Optional[QueryParam] = None,
    ):
        """Two-phase search: dispatch now, returns finalize() -> (sims,
        global doc_ids). Lets callers pipeline several query batches so
        upload/dispatch overlaps device compute (see
        VectorIndexEngine.search_async)."""
        if self.doc_count == 0:
            out = self.search(field, queries, topk, alive_mask, param)
            return lambda: out
        engine = self.engine_for(field)
        engine.trace_detail = f"seg_{self.meta.segment_id}"
        fin = engine.search_async(queries, topk, alive_mask, param)

        def finalize():
            sims, idx = fin()
            doc_ids = np.where(idx >= 0, idx + self.doc_id_start, -1)
            return sims, doc_ids

        return finalize

    # ------------- fetch -------------
    def row_by_doc_id(self, doc_id: int) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
        return self.store.row(doc_id - self.doc_id_start)

    # ------------- inverted scalar indexes -------------
    def _load_inverted_indexes(self) -> None:
        from .inverted import InvertedColumnIndex

        for fs in self.schema.fields:
            path = os.path.join(self.directory, f"invert_{fs.name}.npz")
            if fs.index_param is not None and os.path.exists(path):
                try:
                    self._inverted[fs.name] = InvertedColumnIndex.load(path)
                except Exception:
                    pass

    def build_inverted_indexes(self) -> None:
        """Build + persist inverted indexes for fields declaring
        `InvertIndexParam` (sealed segments; reference `inverted_column_indexer_write.cc`)."""
        from .inverted import InvertedColumnIndex

        for fs in self.schema.fields:
            if fs.index_param is None:
                continue
            idx = InvertedColumnIndex.build(
                self.store.scalar_column(fs.name),
                self.store.null_mask(fs.name),
                fs.data_type,
                fs.index_param.enable_range_optimization,
                fs.index_param.enable_extended_wildcard,
            )
            idx.save(os.path.join(self.directory, f"invert_{fs.name}.npz"))
            self._inverted[fs.name] = idx

    def drop_inverted_index(self, field: str) -> None:
        self._inverted.pop(field, None)
        path = os.path.join(self.directory, f"invert_{field}.npz")
        if os.path.exists(path):
            os.remove(path)

    def inverted_index(self, field: str):
        return self._inverted.get(field)

    # ------------- index DDL -------------
    def build_index(self, field: str, params: VectorIndexParam) -> None:
        """Build a full index for `field` and persist its aux files.

        No-op when an identical-params index is already built on this
        segment: the segment is sealed/immutable, so the existing engine and
        its dumped aux stay valid. Without this, optimize()'s trivial path
        re-built the index `_seal_writing_segment` had just finished — a
        second multi-hour graph build at 10M (reference CreateIndexTask
        likewise skips existing indexes, `collection.cc:608-660`)."""
        existing = self._built_index_params.get(field)
        if (
            existing is not None
            and field in self._engines
            and field in self.meta.indexes
            and existing.to_dict() == params.to_dict()
        ):
            return
        vs = self.schema.vector(field)
        if vs.data_type.is_sparse_vector:
            from ..core.hnsw_sparse import SparseHnswEngine

            engine = SparseHnswEngine(params=params)
            engine.bind_data(
                lambda f=field: self.store.sparse_rows(f),
                lambda: self._write_version,
            )
        else:
            engine = create_engine(params, vs.dimension)
            engine.bind_data(
                lambda f=field: self.store.dense_matrix(f),
                lambda: self._write_version,
            )
        # force the build WITHOUT a probe search: a multi-hour 10M graph
        # must reach dump_aux below even if the first search program fails
        # (a search-staging OOM after a completed 768d build lost the whole
        # graph — the probe ran inside the build-forcing call)
        engine._ensure_fresh()
        aux = engine.dump_aux(self.directory, f"{field}")
        self._engines[field] = engine
        self._built_index_params[field] = params
        self.meta.indexes[field] = {"params": params.to_dict(), "aux": aux}

    def drop_index(self, field: str) -> None:
        self._engines.pop(field, None)
        self._built_index_params.pop(field, None)
        self.meta.indexes.pop(field, None)

    # ------------- durability -------------
    def flush(self) -> None:
        """Persist the final forward file (seal path only — checkpoints of a
        still-writing segment go through `write_checkpoint`)."""
        self.store.seal(os.path.join(self.directory, FORWARD_FILE))

    def checkpoint_path(self, gen: int) -> str:
        return os.path.join(self.directory, ckpt_filename(gen))

    def write_checkpoint(self) -> None:
        """Crash-atomic flush, phase 1 (reference `segment.cc:2079-2177`):
        write ckpt_{gen+1}.arrow and rotate to a fresh wal_{gen+1}.log, then
        bump meta.gen. The caller must commit a version next (making the new
        pair live) and then call `gc_stale_files()`. A crash before that
        commit leaves CURRENT on the old self-consistent (ckpt, WAL) pair."""
        new_gen = self.meta.gen + 1
        self.store.seal(self.checkpoint_path(new_gen))
        if self.wal is not None:
            self.wal.close()
        self.wal = WalFile(os.path.join(self.directory, wal_filename(new_gen)))
        self.wal.open_for_append()
        self.meta.gen = new_gen

    def gc_stale_files(self) -> None:
        """Remove checkpoint/WAL generations other than the committed one."""
        keep = {wal_filename(self.meta.gen), ckpt_filename(self.meta.gen)}
        for name in os.listdir(self.directory):
            if (name.startswith("wal_") or name.startswith("ckpt_")) and name not in keep:
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass

    def seal(self) -> None:
        """Seal: persist and become immutable (reference `dump`, `segment.cc:2062`)."""
        self.flush()
        if self.wal is not None:
            self.wal.close()
            self.wal = None
        self.meta.state = "sealed"
        for name in os.listdir(self.directory):
            if name.startswith("wal_") or name.startswith("ckpt_"):
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass
        self.store = ForwardStore.load(
            self.schema, os.path.join(self.directory, FORWARD_FILE)
        )
        self._write_version += 1

    def destroy(self) -> None:
        import shutil

        if self.wal is not None:
            self.wal.close()
        shutil.rmtree(self.directory, ignore_errors=True)
