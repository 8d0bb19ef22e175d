"""Dataset IO: .vecs binary formats + .npy + benchmark parquet prep.

Reference equivalents: `tools/core/vecs_reader.h` — fvecs/ivecs/bvecs files
(per-row: [i32 dim][dim elements]) as used by SIFT/GIST/Deep benchmarks —
and `tools/core/convert_cohere_parquet.py` — Cohere-10M parquet shards to
vector + ground-truth-neighbor files.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "read_vecs",
    "write_vecs",
    "load_vectors",
    "read_parquet_vectors",
    "convert_parquet_dataset",
]

_DTYPES = {".fvecs": np.float32, ".ivecs": np.int32, ".bvecs": np.uint8}


def read_vecs(path: str, limit: int | None = None) -> np.ndarray:
    """Read an fvecs/ivecs/bvecs file into an (N, D) array."""
    ext = os.path.splitext(path)[1]
    dtype = _DTYPES.get(ext)
    if dtype is None:
        raise ValueError(f"unknown vecs extension '{ext}'")
    raw = np.fromfile(path, dtype=np.uint8)
    dim = int(np.frombuffer(raw[:4], dtype=np.int32)[0])
    itemsize = np.dtype(dtype).itemsize
    row_bytes = 4 + dim * itemsize
    n = len(raw) // row_bytes
    if limit is not None:
        n = min(n, limit)
    rows = raw[: n * row_bytes].reshape(n, row_bytes)
    return np.ascontiguousarray(rows[:, 4:]).view(dtype).reshape(n, dim)


def write_vecs(path: str, data: np.ndarray) -> None:
    ext = os.path.splitext(path)[1]
    dtype = _DTYPES.get(ext)
    if dtype is None:
        raise ValueError(f"unknown vecs extension '{ext}'")
    data = np.ascontiguousarray(data, dtype=dtype)
    n, d = data.shape
    dims = np.full((n, 1), d, dtype=np.int32)
    out = np.concatenate([dims.view(np.uint8).reshape(n, 4),
                          data.view(np.uint8).reshape(n, -1)], axis=1)
    out.tofile(path)


def load_vectors(path: str, limit: int | None = None) -> np.ndarray:
    """Load vectors from .npy, .Xvecs, or .parquet."""
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        return np.asarray(arr[:limit] if limit else arr)
    if path.endswith(".parquet"):
        return read_parquet_vectors(path, limit=limit)
    return read_vecs(path, limit)


def read_parquet_vectors(
    path: str, column: str = "emb", limit: int | None = None
) -> np.ndarray:
    """Read an (N, D) embedding matrix from a parquet file's list column.

    Benchmark-dataset prep parity (Cohere-10M shards ship as parquet with an
    `emb` list<float> column; reference `tools/core/convert_cohere_parquet.py`
    stacks it row-wise). Reads via pyarrow without pandas/polars."""
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    if column not in pf.schema_arrow.names:
        raise ValueError(
            f"parquet file has no column '{column}' "
            f"(found: {', '.join(pf.schema_arrow.names)})"
        )
    chunks = []
    remaining = limit
    for batch in pf.iter_batches(columns=[column]):
        col = batch.column(0)
        arr = np.asarray(col.flatten(), dtype=np.float32)
        n = len(col)
        mat = arr.reshape(n, -1)
        if remaining is not None and n > remaining:
            mat = mat[:remaining]
        chunks.append(mat)
        if remaining is not None:
            remaining -= len(mat)
            if remaining <= 0:
                break
    if not chunks:
        return np.zeros((0, 0), np.float32)
    return np.concatenate(chunks, axis=0)


def convert_parquet_dataset(
    paths: list[str],
    out_vectors: str,
    column: str = "emb",
    neighbors_column: str | None = None,
    out_neighbors: str | None = None,
    limit: int | None = None,
) -> int:
    """Convert parquet shard(s) to a vector file (+ optional ground-truth
    neighbors file) — the reference's Cohere-10M prep flow
    (`convert_cohere_parquet.py:15-60` writes vectors + neighbors_id).

    `out_vectors` may be .npy or .fvecs; `out_neighbors` is .npy (int64) or
    .ivecs. Returns the number of rows written."""
    mats, nbrs = [], []
    remaining = limit
    for p in sorted(paths):
        m = read_parquet_vectors(p, column=column, limit=remaining)
        mats.append(m)
        if neighbors_column:
            import pyarrow.parquet as pq

            tbl = pq.read_table(p, columns=[neighbors_column])
            nb = np.asarray(tbl.column(0).combine_chunks().flatten()).reshape(
                len(tbl), -1
            )
            nbrs.append(nb[: len(m)])
        if remaining is not None:
            remaining -= len(m)
            if remaining <= 0:
                break
    X = np.concatenate(mats, axis=0) if mats else np.zeros((0, 0), np.float32)
    if out_vectors.endswith(".npy"):
        np.save(out_vectors, X)
    else:
        write_vecs(out_vectors, X)
    if neighbors_column and out_neighbors:
        G = np.concatenate(nbrs, axis=0)
        if out_neighbors.endswith(".npy"):
            np.save(out_neighbors, G.astype(np.int64))
        else:
            write_vecs(out_neighbors, G.astype(np.int32))
    return len(X)
