"""Binary codec for WAL records and snapshots.

A compact tag-length-value encoding for doc write operations — the role the
reference's WAL record serialization plays (`src/db/index/storage/wal/`,
protobuf-encoded docs). Self-describing, versioned, no pickle.

Record layout (little-endian):
  [u8 op] [varint pk_len] [pk utf8]
  [varint n_fields] then per field: [varint name_len][name][u8 tag][payload]
  [varint n_vectors] then per vector: [varint name_len][name][u8 tag][payload]

Scalar payloads: NULL(no bytes) / BOOL(u8) / I64(zigzag varint) / F64(8B) /
STR(varint len + utf8) / BYTES(varint len) / typed arrays (dtype-tagged raw
little-endian bytes) / dense vector (dtype tag + varint count + raw) /
sparse vector (varint nnz + u32 indices + f32 values).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "OP_INSERT",
    "OP_UPDATE",
    "OP_UPSERT",
    "OP_DELETE",
    "encode_record",
    "decode_record",
]

OP_INSERT = 1
OP_UPDATE = 2
OP_UPSERT = 3
OP_DELETE = 4

# value tags
_T_NULL = 0
_T_BOOL = 1
_T_I64 = 2
_T_F64 = 3
_T_STR = 4
_T_BYTES = 5
_T_ARR_I32 = 6
_T_ARR_I64 = 7
_T_ARR_U32 = 8
_T_ARR_U64 = 9
_T_ARR_F32 = 10
_T_ARR_F64 = 11
_T_ARR_BOOL = 12
_T_ARR_STR = 13
_T_VEC_F32 = 20
_T_VEC_F16 = 21
_T_VEC_F64 = 22
_T_VEC_I8 = 23
_T_VEC_U32 = 24  # packed binary vector words (VECTOR_BINARY32)
_T_VEC_U64 = 25  # packed binary vector words (VECTOR_BINARY64)
_T_VEC_I16 = 26  # VECTOR_INT16
_T_SPARSE_F32 = 30
_T_U64 = 31

_ARR_DTYPES = {
    _T_ARR_I32: np.int32,
    _T_ARR_I64: np.int64,
    _T_ARR_U32: np.uint32,
    _T_ARR_U64: np.uint64,
    _T_ARR_F32: np.float32,
    _T_ARR_F64: np.float64,
    _T_ARR_BOOL: np.bool_,
}
_VEC_DTYPES = {
    _T_VEC_F32: np.float32,
    _T_VEC_F16: np.float16,
    _T_VEC_F64: np.float64,
    _T_VEC_I8: np.int8,
    _T_VEC_U32: np.uint32,
    _T_VEC_U64: np.uint64,
    _T_VEC_I16: np.int16,
}
_DTYPE_TO_ARR = {np.dtype(v): k for k, v in _ARR_DTYPES.items()}
_DTYPE_TO_VEC = {np.dtype(v): k for k, v in _VEC_DTYPES.items()}
# dtypes that default to the ARRAY tag unless the caller marks them a vector
_AMBIGUOUS_VEC_DTYPES = frozenset(
    {np.dtype(np.float64), np.dtype(np.uint32), np.dtype(np.uint64)}
)


def _write_varint(buf: bytearray, value: int) -> None:
    if value < 0:
        raise ValueError("varint must be non-negative")
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1


def _unzigzag(v: int) -> int:
    return (v >> 1) if (v & 1) == 0 else -((v + 1) >> 1)


def _write_str(buf: bytearray, s: str) -> None:
    raw = s.encode("utf-8")
    n = len(raw)
    if n < 0x80:
        buf.append(n)
    else:
        _write_varint(buf, n)
    buf += raw


def _read_str(data: memoryview, pos: int) -> Tuple[str, int]:
    n, pos = _read_varint(data, pos)
    return bytes(data[pos : pos + n]).decode("utf-8"), pos + n


def _encode_value(buf: bytearray, value: Any) -> None:
    # exact-type fast paths for the common plain-python field values (the
    # isinstance chain below still handles subclasses and numpy scalars;
    # bool is dispatched exactly so it can't fall into the int branch)
    t = type(value)
    if t is str:
        buf.append(_T_STR)
        _write_str(buf, value)
        return
    if t is float:
        buf.append(_T_F64)
        buf += struct.pack("<d", value)
        return
    if t is int:
        if value > 0x7FFFFFFFFFFFFFFF:  # uint64 range
            buf.append(_T_U64)
            buf += struct.pack("<Q", value)
        else:
            buf.append(_T_I64)
            _write_varint(buf, _zigzag(value))
        return
    if t is bool:
        buf.append(_T_BOOL)
        buf.append(1 if value else 0)
        return
    if value is None:
        buf.append(_T_NULL)
    elif isinstance(value, (bool, np.bool_)):
        buf.append(_T_BOOL)
        buf.append(1 if value else 0)
    elif isinstance(value, (int, np.integer)):
        v = int(value)
        if v > 0x7FFFFFFFFFFFFFFF:  # uint64 range
            buf.append(_T_U64)
            buf.extend(struct.pack("<Q", v))
        else:
            buf.append(_T_I64)
            _write_varint(buf, _zigzag(v))
    elif isinstance(value, (float, np.floating)):
        buf.append(_T_F64)
        buf.extend(struct.pack("<d", float(value)))
    elif isinstance(value, str):
        buf.append(_T_STR)
        _write_str(buf, value)
    elif isinstance(value, bytes):
        buf.append(_T_BYTES)
        _write_varint(buf, len(value))
        buf.extend(value)
    elif isinstance(value, np.ndarray):
        _encode_array(buf, value)
    elif isinstance(value, (list, tuple)):
        _encode_list(buf, list(value))
    elif isinstance(value, dict):
        _encode_sparse(buf, value)
    else:
        raise TypeError(f"cannot encode value of type {type(value).__name__}")


def _encode_list(buf: bytearray, value: list) -> None:
    if value and all(isinstance(v, str) for v in value):
        buf.append(_T_ARR_STR)
        _write_varint(buf, len(value))
        for s in value:
            _write_str(buf, s)
        return
    if value and all(isinstance(v, (bool, np.bool_)) for v in value):
        arr = np.asarray(value, dtype=np.bool_)
    elif value and all(isinstance(v, (int, np.integer)) for v in value):
        arr = np.asarray(value, dtype=np.int64)
    else:
        arr = np.asarray(value, dtype=np.float64)
    _encode_array(buf, arr)


def _encode_array(buf: bytearray, arr: np.ndarray, is_vector: bool = False) -> None:
    dt = arr.dtype
    if (
        dt in _DTYPE_TO_VEC
        and arr.ndim == 1
        and (is_vector or dt not in _AMBIGUOUS_VEC_DTYPES)
    ):
        tag = _DTYPE_TO_VEC[dt]
    elif dt in _DTYPE_TO_ARR:
        tag = _DTYPE_TO_ARR[dt]
    elif dt.kind == "U" or dt == object:
        _encode_list(buf, [str(x) for x in arr.tolist()])
        return
    else:
        arr = arr.astype(np.float64)
        tag = _T_ARR_F64
    buf.append(tag)
    n = arr.shape[0]
    if n < 0x80:
        buf.append(n)
    else:
        _write_varint(buf, n)
    buf += arr.tobytes()  # tobytes() is C-order regardless of layout


def _encode_sparse(buf: bytearray, value: Dict[int, float]) -> None:
    buf.append(_T_SPARSE_F32)
    items = sorted(value.items())
    _write_varint(buf, len(items))
    if items:
        idx = np.asarray([k for k, _ in items], dtype=np.uint32)
        vals = np.asarray([v for _, v in items], dtype=np.float32)
        buf.extend(idx.tobytes())
        buf.extend(vals.tobytes())


def _decode_value(data: memoryview, pos: int) -> Tuple[Any, int]:
    tag = data[pos]
    pos += 1
    if tag == _T_NULL:
        return None, pos
    if tag == _T_BOOL:
        return bool(data[pos]), pos + 1
    if tag == _T_I64:
        v, pos = _read_varint(data, pos)
        return _unzigzag(v), pos
    if tag == _T_U64:
        return struct.unpack_from("<Q", data, pos)[0], pos + 8
    if tag == _T_F64:
        return struct.unpack_from("<d", data, pos)[0], pos + 8
    if tag == _T_STR:
        return _read_str(data, pos)
    if tag == _T_BYTES:
        n, pos = _read_varint(data, pos)
        return bytes(data[pos : pos + n]), pos + n
    if tag == _T_ARR_STR:
        n, pos = _read_varint(data, pos)
        out = []
        for _ in range(n):
            s, pos = _read_str(data, pos)
            out.append(s)
        return out, pos
    if tag in _ARR_DTYPES:
        dt = np.dtype(_ARR_DTYPES[tag])
        n, pos = _read_varint(data, pos)
        nbytes = n * dt.itemsize
        arr = np.frombuffer(data[pos : pos + nbytes], dtype=dt).copy()
        return arr, pos + nbytes
    if tag in _VEC_DTYPES:
        dt = np.dtype(_VEC_DTYPES[tag])
        n, pos = _read_varint(data, pos)
        nbytes = n * dt.itemsize
        arr = np.frombuffer(data[pos : pos + nbytes], dtype=dt).copy()
        return arr, pos + nbytes
    if tag == _T_SPARSE_F32:
        n, pos = _read_varint(data, pos)
        idx = np.frombuffer(data[pos : pos + 4 * n], dtype=np.uint32)
        pos += 4 * n
        vals = np.frombuffer(data[pos : pos + 4 * n], dtype=np.float32)
        pos += 4 * n
        return {int(i): float(v) for i, v in zip(idx, vals)}, pos
    raise ValueError(f"unknown codec tag {tag}")


def encode_record(
    op: int,
    pk: str,
    fields: Optional[Dict[str, Any]] = None,
    vectors: Optional[Dict[str, Any]] = None,
) -> bytes:
    buf = bytearray()
    buf.append(op)
    raw_pk = pk.encode("utf-8")
    if len(raw_pk) < 0x80:  # inlined _write_str fast path (hot insert loop)
        buf.append(len(raw_pk))
        buf += raw_pk
    else:
        _write_varint(buf, len(raw_pk))
        buf += raw_pk
    fields = fields or {}
    vectors = vectors or {}
    _write_varint(buf, len(fields))
    for name, value in fields.items():
        _write_str(buf, name)
        _encode_value(buf, value)
    _write_varint(buf, len(vectors))
    for name, value in vectors.items():
        _write_str(buf, name)
        if isinstance(value, dict):
            _encode_sparse(buf, value)
        elif type(value) is np.ndarray:
            # vectors persist in their schema storage dtype (fp64 stays fp64 —
            # _T_VEC_F64; reference stores VECTOR_FP64 full-width)
            _encode_array(buf, value, is_vector=True)
        else:
            _encode_array(buf, np.asarray(value), is_vector=True)
    return bytes(buf)


def decode_record(raw: bytes):
    """Returns (op, pk, fields, vectors)."""
    data = memoryview(raw)
    op = data[0]
    pk, pos = _read_str(data, 1)
    nf, pos = _read_varint(data, pos)
    fields: Dict[str, Any] = {}
    for _ in range(nf):
        name, pos = _read_str(data, pos)
        value, pos = _decode_value(data, pos)
        fields[name] = value
    nv, pos = _read_varint(data, pos)
    vectors: Dict[str, Any] = {}
    for _ in range(nv):
        name, pos = _read_str(data, pos)
        value, pos = _decode_value(data, pos)
        vectors[name] = value
    return op, pk, fields, vectors
