"""Forward (document) store: columnar per-segment storage.

Reference equivalents: `MemoryForwardStore` (writing segment, Arrow builders)
and `MmapForwardStore` (sealed blocks, Arrow IPC / Parquet) behind
`BaseForwardStore` (`src/db/index/storage/base_forward_store.h:39-57`,
`store_helper.h` for the type mapping incl. the sparse-vector struct type).

Writing mode holds append-only host buffers (python lists + growing numpy
matrices for dense vectors); `seal()` writes one Arrow IPC file; sealed mode
reads it back memory-mapped. Dense vector columns expose a contiguous
(N, D) float32 matrix — the array that gets streamed to device HBM.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc

from ..model.schema import CollectionSchema
from ..typing.enum import DataType

__all__ = ["ForwardStore", "arrow_type_for", "write_arrow", "read_forward_table", "PK_COLUMN"]


def write_arrow(table: "pa.Table", path: str, file_format: str = None) -> None:
    """Atomically write a forward block as Arrow IPC or Parquet (the
    reference's dual `FileFormat`, `mmap_forward_store.cc:41-71`)."""
    if file_format is None:
        from ..utils.config import GlobalConfig

        file_format = GlobalConfig.instance().forward_file_format
    tmp = path + ".tmp"
    if file_format == "parquet":
        import pyarrow.parquet as pq

        pq.write_table(table, tmp)
    else:
        # IPC record batches bound child-array lengths to int32: a
        # whole-table write of a (10M, 768) fp32 column is a 7.7e9-element
        # flat child and raises ArrowCapacityError. Chunk rows so the
        # widest fixed-size-list column stays under 2^30 elements per batch
        # (2M-row floor guards variable-length sparse columns).
        maxw = 1
        for field in table.schema:
            if pa.types.is_fixed_size_list(field.type):
                maxw = max(maxw, int(field.type.list_size))
        cap = int(
            os.environ.get(
                "ZVEC_ARROW_CHUNK_ROWS", min((1 << 30) // maxw, 2_000_000)
            )
        )
        with ipc.new_file(tmp, table.schema) as writer:
            writer.write_table(table, max_chunksize=max(1, cap))
    os.replace(tmp, path)


def read_forward_table(path: str, use_mmap: bool = True) -> "pa.Table":
    """Read a forward block, sniffing IPC vs Parquet by magic bytes.
    `use_mmap=False` reads the block into heap buffers instead of
    memory-mapping (reference `CollectionOptions.enable_mmap_`,
    `options.h:24`: MmapFileReadStorage vs FileReadStorage)."""
    with open(path, "rb") as fh:
        magic = fh.read(6)
    if magic[:4] == b"PAR1":
        import pyarrow.parquet as pq

        return pq.read_table(path, memory_map=use_mmap)
    if use_mmap:
        with pa.memory_map(path) as source:
            return ipc.open_file(source).read_all()
    with pa.OSFile(path, "rb") as source:
        return ipc.open_file(source).read_all()

PK_COLUMN = "_pk"

_SCALAR_ARROW = {
    DataType.STRING: pa.string(),
    DataType.BOOL: pa.bool_(),
    DataType.INT32: pa.int32(),
    DataType.INT64: pa.int64(),
    DataType.UINT32: pa.uint32(),
    DataType.UINT64: pa.uint64(),
    DataType.FLOAT: pa.float32(),
    DataType.DOUBLE: pa.float64(),
    DataType.BINARY: pa.binary(),
}

_VECTOR_NUMPY = {
    DataType.VECTOR_FP16: np.float16,
    DataType.VECTOR_FP32: np.float32,
    DataType.VECTOR_FP64: np.float64,
    DataType.VECTOR_INT8: np.int8,
    DataType.VECTOR_INT16: np.int16,
    DataType.VECTOR_INT4: np.int8,  # nibble-packed: 2 elements per byte
    DataType.VECTOR_BINARY32: np.uint32,
    DataType.VECTOR_BINARY64: np.uint64,
}


def storage_width(vs) -> int:
    """Stored elements per row: packed words for binary vectors
    (`type.h:47-48` VECTOR_BINARY32/64 — dimension counts BITS), else the
    dimension itself."""
    if vs.data_type == DataType.VECTOR_BINARY32:
        return -(-vs.dimension // 32)
    if vs.data_type == DataType.VECTOR_BINARY64:
        return -(-vs.dimension // 64)
    if vs.data_type == DataType.VECTOR_INT4:
        return -(-vs.dimension // 2)
    return vs.dimension

_SPARSE_TYPE = pa.struct(
    [pa.field("indices", pa.list_(pa.uint32())), pa.field("values", pa.list_(pa.float32()))]
)


def arrow_type_for(dt: DataType) -> pa.DataType:
    dt = DataType(dt)
    if dt in _SCALAR_ARROW:
        return _SCALAR_ARROW[dt]
    if dt.is_array:
        return pa.list_(_SCALAR_ARROW[dt.element_type])
    if dt.is_sparse_vector:
        return _SPARSE_TYPE
    raise ValueError(f"no arrow type for {dt}")


class ForwardStore:
    """One segment's document storage (scalars + vectors)."""

    def __init__(self, schema: CollectionSchema):
        self.schema = schema
        self._count = 0
        self._writable = True
        # scalar columns: name -> list of python values (None = null)
        self._scalars: Dict[str, List[Any]] = {f.name: [] for f in schema.fields}
        self._pks: List[str] = []
        # dense vectors: name -> growing (cap, D) numpy buffer
        self._dense: Dict[str, np.ndarray] = {}
        self._dense_dtype: Dict[str, np.dtype] = {}
        # sparse vectors: name -> list of {dim: value}
        self._sparse: Dict[str, List[Optional[Dict[int, float]]]] = {}
        for v in schema.vectors:
            if v.data_type.is_sparse_vector:
                self._sparse[v.name] = []
            else:
                dt = _VECTOR_NUMPY[v.data_type]
                self._dense[v.name] = np.zeros((0, storage_width(v)), dtype=dt)
                self._dense_dtype[v.name] = np.dtype(dt)
        self._table: Optional[pa.Table] = None  # sealed-mode cache
        self._pk_cache: Optional[np.ndarray] = None  # lazy object-array of pks

    # ------------- write path -------------
    def append(self, pk: str, fields: Dict[str, Any], vectors: Dict[str, Any]) -> int:
        """Append one doc; returns its local index."""
        assert self._writable, "forward store is sealed"
        idx = self._count
        self._pks.append(pk)
        for name, col in self._scalars.items():
            col.append(fields.get(name))
        for name in self._dense:
            vec = vectors.get(name)
            buf = self._dense[name]
            if idx >= buf.shape[0]:
                new_cap = max(1024, buf.shape[0] * 2, idx + 1)
                grown = np.zeros((new_cap, buf.shape[1]), dtype=buf.dtype)
                grown[: buf.shape[0]] = buf
                self._dense[name] = grown
                buf = grown
            if vec is not None:
                buf[idx] = np.asarray(vec, dtype=buf.dtype)
        for name in self._sparse:
            vec = vectors.get(name)
            self._sparse[name].append(
                {int(k): float(v) for k, v in vec.items()} if vec else None
            )
        self._count += 1
        return idx

    def append_batch(
        self,
        pks: List[str],
        fields_list: List[Dict[str, Any]],
        vectors_list: List[Dict[str, Any]],
    ) -> int:
        """Append a batch of docs (bulk-insert fast path; one capacity check
        and one buffer slice per dense field instead of per-doc python work).
        Returns the local index of the first appended doc."""
        assert self._writable, "forward store is sealed"
        start = self._count
        n = len(pks)
        self._pks.extend(pks)
        for name, col in self._scalars.items():
            col.extend([f.get(name) for f in fields_list])
        for name in self._dense:
            buf = self._dense[name]
            need = start + n
            if need > buf.shape[0]:
                new_cap = max(1024, buf.shape[0] * 2, need)
                grown = np.zeros((new_cap, buf.shape[1]), dtype=buf.dtype)
                grown[: buf.shape[0]] = buf
                self._dense[name] = grown
                buf = grown
            dst = buf[start:need]
            for i, vecs in enumerate(vectors_list):
                vec = vecs.get(name)
                if vec is not None:
                    dst[i] = vec  # assignment casts to the storage dtype
        for name in self._sparse:
            col = self._sparse[name]
            for vecs in vectors_list:
                vec = vecs.get(name)
                col.append(
                    {int(k): float(v) for k, v in vec.items()} if vec else None
                )
        self._count += n
        return start

    # ------------- read path -------------
    @property
    def count(self) -> int:
        return self._count

    def pk(self, idx: int) -> str:
        if self._writable:
            return self._pks[idx]
        return self._table.column(PK_COLUMN)[idx].as_py()

    def pks(self) -> List[str]:
        if self._writable:
            return list(self._pks)
        return self._table.column(PK_COLUMN).to_pylist()

    def pks_for(self, indices: np.ndarray) -> List[str]:
        """Batched pk lookup — one Arrow `take` instead of per-element
        `.as_py()` (the hot path of id+score-only batched DQL). Sustained
        batched lookups (>=1024 hits/call) promote the pk column to a cached
        numpy object array: fancy-indexing it is ~20x cheaper per hit than
        Arrow take + to_pylist on the bench path."""
        idx = np.asarray(indices, dtype=np.int64)
        if self._writable:
            pk_list = self._pks
            return [pk_list[int(i)] for i in idx]
        cache = self._pk_cache
        if cache is None:
            if idx.shape[0] < 1024:
                return self._table.column(PK_COLUMN).take(pa.array(idx)).to_pylist()
            cache = np.asarray(self._table.column(PK_COLUMN).to_pylist(), dtype=object)
            self._pk_cache = cache
        return cache[idx].tolist()

    def scalar_value(self, name: str, idx: int):
        if self._writable:
            return self._scalars[name][idx]
        value = self._table.column(name)[idx].as_py()
        return value

    def scalar_take(self, name: str, idx: np.ndarray) -> list:
        """Many scalar values at once — ONE Arrow take (sealed) or one fancy
        index (writing) instead of a per-row python loop (the group-by hot
        path; reference group decode is likewise columnar,
        `vector_recall_node.cc:168-194`)."""
        if self._writable:
            vals = self._scalars[name]
            return [vals[int(i)] for i in idx]
        return self._table.column(name).take(pa.array(idx, type=pa.int64())).to_pylist()

    def scalar_column(self, name: str) -> np.ndarray:
        """Whole column as numpy (object dtype for strings/arrays); used by
        filter evaluation. Nulls come back as None (object) or NaN (floats)."""
        if self._writable:
            f = self.schema.field(name)
            return _pylist_to_numpy(self._scalars[name][: self._count], f.data_type)
        col = self._table.column(name)
        f = self.schema.field(name)
        return _arrow_to_numpy(col, f.data_type)

    def null_mask(self, name: str) -> np.ndarray:
        """True where the value IS NULL."""
        if self._writable:
            return np.array(
                [v is None for v in self._scalars[name][: self._count]], dtype=bool
            )
        col = self._table.column(name)
        return np.asarray(col.is_null().combine_chunks().to_numpy(zero_copy_only=False))

    def _storage_matrix(self, name: str) -> np.ndarray:
        """(N, W) matrix in raw storage form (INT4 stays nibble-packed)."""
        if name in self._dense:
            return self._dense[name][: self._count]
        # sealed: reconstruct from arrow fixed-size-list ONCE and cache.
        # The store is immutable here, and the refiner re-reads this matrix
        # on EVERY quantized query batch (`core/refiner.py::refine`) — at
        # 10M x 768d the reconstruction is a 30GB combine+reshape per batch
        # without the cache.
        cache = getattr(self, "_sealed_matrix_cache", None)
        if cache is None:
            cache = self._sealed_matrix_cache = {}
        if name in cache:
            return cache[name]
        vs = self.schema.vector(name)
        dt = _VECTOR_NUMPY[vs.data_type]
        w = storage_width(vs)
        col = self._table.column(name)
        if col.num_chunks > 1:
            # assemble per chunk into ONE preallocated matrix:
            # combine_chunks on a 30GB chunk-written column (the 10M x 768d
            # IPC writer chunks rows) materializes a second whole-column
            # copy before the reshape
            mat = np.empty((self._count, w), dt)
            row = 0
            for ch in col.chunks:
                flat = ch.flatten().to_numpy(zero_copy_only=False)
                cnt = len(ch)
                mat[row : row + cnt] = flat.reshape(cnt, w).astype(dt, copy=False)
                row += cnt
        else:
            flat = (
                col.combine_chunks()
                .flatten()
                .to_numpy(zero_copy_only=False)
                .astype(dt, copy=False)
            )
            mat = flat.reshape(self._count, w)
        cache[name] = mat
        return mat

    def dense_matrix(self, name: str) -> np.ndarray:
        """(N, D) matrix of a dense vector column in its storage dtype
        (INT4 columns come back nibble-unpacked to (N, D) int8; storage and
        WAL stay packed at 2 elements/byte)."""
        vs = self.schema.vector(name)
        mat = self._storage_matrix(name)
        if vs.data_type == DataType.VECTOR_INT4:
            from ..ops.quantize import unpack_int4

            mat = unpack_int4(np.ascontiguousarray(mat), vs.dimension)
        return mat

    def dense_vector(self, name: str, idx: int) -> Optional[np.ndarray]:
        vs = self.schema.vector(name)
        if name in self._dense:
            row = np.array(self._dense[name][idx])
        else:
            value = self._table.column(name)[idx].as_py()
            if value is None:
                return None
            row = np.asarray(value, dtype=_VECTOR_NUMPY[vs.data_type])
        if vs.data_type == DataType.VECTOR_INT4:
            from ..ops.quantize import unpack_int4

            row = unpack_int4(np.ascontiguousarray(row)[None, :], vs.dimension)[0]
        return row

    def sparse_vector(self, name: str, idx: int) -> Optional[Dict[int, float]]:
        if name in self._sparse:
            return self._sparse[name][idx]
        value = self._table.column(name)[idx].as_py()
        if value is None:
            return None
        return dict(zip(value["indices"], value["values"]))

    def sparse_rows(self, name: str) -> List[Optional[Dict[int, float]]]:
        if name in self._sparse:
            return self._sparse[name][: self._count]
        col = self._table.column(name).to_pylist()
        return [
            dict(zip(v["indices"], v["values"])) if v is not None else None for v in col
        ]

    def row(self, idx: int) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
        """(pk, fields, vectors) for one local index."""
        fields = {}
        for f in self.schema.fields:
            fields[f.name] = self.scalar_value(f.name, idx)
        vectors = {}
        for v in self.schema.vectors:
            if v.data_type.is_sparse_vector:
                vec = self.sparse_vector(v.name, idx)
            else:
                vec = self.dense_vector(v.name, idx)
                vec = vec.tolist() if vec is not None else None
            if vec is not None:
                vectors[v.name] = vec
        return self.pk(idx), fields, vectors

    def arrow_snapshot(self, columns: Optional[List[str]] = None) -> pa.Table:
        """Columnar snapshot of this store as an Arrow table, optionally
        projected to `columns` (reference `BaseForwardStore::fetch/scan`,
        `base_forward_store.h:39-57`). Sealed stores return (a projection
        of) the mmap'd table zero-copy; writing stores build it from the
        live buffers."""
        tbl = self.to_arrow() if self._writable else self._table
        if columns is not None:
            tbl = tbl.select(columns)
        return tbl

    # ------------- persistence -------------
    def to_arrow(self) -> pa.Table:
        arrays = {PK_COLUMN: pa.array(self._pks[: self._count], type=pa.string())}
        for f in self.schema.fields:
            at = arrow_type_for(f.data_type)
            arrays[f.name] = pa.array(
                _coerce_pylist(self._scalars[f.name][: self._count], f.data_type),
                type=at,
            )
        for v in self.schema.vectors:
            if v.data_type.is_sparse_vector:
                rows = self._sparse[v.name][: self._count]
                arrays[v.name] = pa.array(
                    [
                        {
                            "indices": sorted(r.keys()),
                            "values": [r[k] for k in sorted(r.keys())],
                        }
                        if r is not None
                        else None
                        for r in rows
                    ],
                    type=_SPARSE_TYPE,
                )
            else:
                # persist in the schema's storage dtype (fp16 → halffloat,
                # fp64 → float64) — no silent fp32 downcast
                mat = self._dense[v.name][: self._count]
                flat = pa.array(np.ascontiguousarray(mat).reshape(-1))
                arrays[v.name] = pa.FixedSizeListArray.from_arrays(
                    flat, storage_width(v)
                )
        return pa.table(arrays)

    def seal(self, path: str) -> None:
        write_arrow(self.to_arrow() if self._writable else self._table, path)

    @classmethod
    def load(
        cls, schema: CollectionSchema, path: str, use_mmap: bool = True
    ) -> "ForwardStore":
        store = cls(schema)
        store._table = read_forward_table(path, use_mmap)
        store._count = store._table.num_rows
        store._writable = False
        store._scalars = {}
        store._dense = {}
        store._sparse = {}
        return store

    def thaw(self) -> "ForwardStore":
        """Columnar sealed→writable conversion (writing-segment recovery base).
        Bulk Arrow→python per column, no per-row reconstruction (reference
        streams record batches, `segment_helper.cc:74-120`)."""
        assert not self._writable and self._table is not None
        store = ForwardStore(self.schema)
        n = self._count
        store._count = n
        store._pks = self._table.column(PK_COLUMN).to_pylist()
        for f in self.schema.fields:
            store._scalars[f.name] = self._table.column(f.name).to_pylist()
        for v in self.schema.vectors:
            if v.data_type.is_sparse_vector:
                store._sparse[v.name] = self.sparse_rows(v.name)
            else:
                mat = np.array(self._storage_matrix(v.name))  # writable copy
                store._dense[v.name] = mat
        return store

    # schema evolution hooks (add/drop column) operate on writable stores only
    def add_column(self, name: str, data_type: DataType, default=None) -> None:
        assert self._writable
        self._scalars[name] = [default] * self._count

    def drop_column(self, name: str) -> None:
        if self._writable:
            self._scalars.pop(name, None)
        elif self._table is not None and name in self._table.column_names:
            self._table = self._table.drop_columns([name])

    def rename_column(self, old: str, new: str) -> None:
        if self._writable:
            if old in self._scalars:
                self._scalars[new] = self._scalars.pop(old)
        elif self._table is not None:
            names = [new if n == old else n for n in self._table.column_names]
            self._table = self._table.rename_columns(names)


_NUMPY_SCALAR = {
    DataType.BOOL: np.bool_,
    DataType.INT32: np.int32,
    DataType.INT64: np.int64,
    DataType.UINT32: np.uint32,
    DataType.UINT64: np.uint64,
    DataType.FLOAT: np.float32,
    DataType.DOUBLE: np.float64,
}


def _coerce_pylist(values: List[Any], dt: DataType) -> List[Any]:
    if dt.is_array:
        return [
            None if v is None else (v.tolist() if isinstance(v, np.ndarray) else list(v))
            for v in values
        ]
    return [None if v is None else _np_unwrap(v) for v in values]


def _np_unwrap(v):
    return v.item() if isinstance(v, np.generic) else v


def _pylist_to_numpy(values: List[Any], dt: DataType) -> np.ndarray:
    if dt in _NUMPY_SCALAR and not any(v is None for v in values):
        return np.asarray(values, dtype=_NUMPY_SCALAR[dt])
    if dt in (DataType.FLOAT, DataType.DOUBLE):
        return np.asarray(
            [np.nan if v is None else v for v in values], dtype=np.float64
        )
    return np.asarray(values, dtype=object)


def _arrow_to_numpy(col: pa.ChunkedArray, dt: DataType) -> np.ndarray:
    if dt in _NUMPY_SCALAR and col.null_count == 0 and not dt == DataType.BOOL:
        return col.combine_chunks().to_numpy(zero_copy_only=False)
    if dt in (DataType.FLOAT, DataType.DOUBLE):
        return np.asarray(
            [np.nan if v is None else v for v in col.to_pylist()], dtype=np.float64
        )
    return np.asarray(col.to_pylist(), dtype=object)
