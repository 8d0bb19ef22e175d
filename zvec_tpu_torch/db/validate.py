"""Doc validation against a collection schema.

Mirrors the reference's write-time validation (`collection.cc:1434`
`doc.validate(schema)`, schema checks in `src/db/index/common/schema.cc`).
"""

from __future__ import annotations

import re

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..model.doc import Doc
from ..model.schema import CollectionSchema
from ..typing.enum import DataType, StatusCode
from ..typing.status import Status

__all__ = ["validate_doc", "coerce_scalar", "validate_collection_path"]

_INT_RANGES = {
    DataType.INT32: (-(2**31), 2**31 - 1),
    DataType.INT64: (-(2**63), 2**63 - 1),
    DataType.UINT32: (0, 2**32 - 1),
    DataType.UINT64: (0, 2**64 - 1),
}

# dense float vectors coerce straight to their storage dtype at validation
# (integer vector dtypes keep the inspect-then-cast path: range semantics)
_FLOAT_STORE_DTYPES = {
    DataType.VECTOR_FP32: np.float32,
    DataType.VECTOR_FP64: np.float64,
    DataType.VECTOR_FP16: np.float16,
}


def _coerce_string(value):
    if type(value) is str or isinstance(value, str):
        return value, None
    return None, f"expected str, got {type(value).__name__}"


def _coerce_bool(value):
    if isinstance(value, (bool, np.bool_)):
        return bool(value), None
    return None, f"expected bool, got {type(value).__name__}"


def _make_coerce_int(dt):
    lo, hi = _INT_RANGES[dt]
    name = dt.name

    def _coerce_int(value):
        if isinstance(value, (bool, np.bool_)):
            return None, "expected integer, got bool"
        if isinstance(value, (int, np.integer)):
            v = int(value)
            if not lo <= v <= hi:
                return None, f"value {v} out of range for {name}"
            return v, None
        return None, f"expected integer, got {type(value).__name__}"

    return _coerce_int


def _coerce_float(value):
    if type(value) is float:  # hot path: exact float needs no conversion
        return value, None
    if isinstance(value, (bool, np.bool_)):
        return None, "expected number, got bool"
    if isinstance(value, (int, float, np.integer, np.floating)):
        return float(value), None
    return None, f"expected number, got {type(value).__name__}"


def _coerce_binary(value):
    if not isinstance(value, bytes):
        return None, f"expected bytes, got {type(value).__name__}"
    return value, None


def _make_coerce_array(dt):
    element_fn = _COERCE_DISPATCH[dt.element_type]

    def _coerce_array(value):
        if isinstance(value, np.ndarray):
            value = value.tolist()
        if not isinstance(value, (list, tuple)):
            return None, f"expected list, got {type(value).__name__}"
        out = []
        for i, item in enumerate(value):
            if item is None:
                out.append(None)
                continue
            coerced, err = element_fn(item)
            if err:
                return None, f"array element {i}: {err}"
            out.append(coerced)
        return out, None

    return _coerce_array


_COERCE_DISPATCH = {
    DataType.STRING: _coerce_string,
    DataType.BOOL: _coerce_bool,
    DataType.FLOAT: _coerce_float,
    DataType.DOUBLE: _coerce_float,
    DataType.BINARY: _coerce_binary,
}
for _dt in _INT_RANGES:
    _COERCE_DISPATCH[_dt] = _make_coerce_int(_dt)
for _dt in DataType:
    if _dt.is_array:
        _COERCE_DISPATCH[_dt] = _make_coerce_array(_dt)


def coerce_scalar(value: Any, dt: DataType) -> Tuple[Any, Optional[str]]:
    """Coerce `value` to data type `dt`. Returns (value, error_message)."""
    if value is None:
        return None, None
    fn = _COERCE_DISPATCH.get(dt)
    if fn is None:
        return None, f"unsupported data type {dt.name}"
    return fn(value)


def coerce_binary_vector(value, vs) -> Tuple[Optional[np.ndarray], Optional[str]]:
    """Normalize a binary vector input to packed LSB-first words.

    Accepts either the packed form (uint32/uint64 words, `dim/32` or `dim/64`
    of them — the reference wire layout, `binary_quantizer.cc:40-52`) or a
    0/1 bit array of length `dimension` (packed here for convenience)."""
    word_bits = 32 if vs.data_type == DataType.VECTOR_BINARY32 else 64
    dtype = np.uint32 if word_bits == 32 else np.uint64
    words = -(-vs.dimension // word_bits)
    if (
        isinstance(value, (list, tuple))
        and len(value) == words
        and all(isinstance(x, (int, np.integer)) for x in value)
    ):
        # python ints past int64 coerce lossily through np.asarray(list)
        try:
            return np.asarray(value, dtype=dtype), None
        except OverflowError:
            return None, "packed binary word out of range"
    arr = np.asarray(value)
    if arr.ndim != 1:
        return None, "binary vector must be 1-dimensional"
    if not np.issubdtype(arr.dtype, np.number) and arr.dtype != np.bool_:
        return None, "binary vector must be numeric"
    if arr.shape[0] == words and vs.dimension != words:
        if np.issubdtype(arr.dtype, np.floating):
            return None, "packed binary words must be integers"
        if arr.min() < 0 or (word_bits == 32 and int(arr.max()) > 0xFFFFFFFF):
            return None, "packed binary word out of range"
        return arr.astype(dtype), None
    if arr.shape[0] == vs.dimension:
        vals = np.unique(arr)
        if not np.isin(vals, (0, 1)).all():
            return None, "bit-form binary vector must contain only 0/1"
        from ..ops.quantize import pack_bits

        return pack_bits(arr[None, :].astype(np.uint8), word_bits)[0], None
    return None, (
        f"binary vector length {arr.shape[0]} matches neither packed "
        f"({words} words) nor bit ({vs.dimension}) form"
    )


def coerce_binary_queries(queries, vs) -> np.ndarray:
    """Normalize one query / a batch of queries for a binary vector field to
    a (B, words) packed array (each row via coerce_binary_vector)."""
    arr = np.asarray(queries)
    rows = [queries] if arr.ndim == 1 else list(arr)
    out = []
    for r in rows:
        packed, err = coerce_binary_vector(r, vs)
        if err:
            from ..typing.status import ZvecError

            raise ZvecError(StatusCode.INVALID_ARGUMENT, f"binary query: {err}")
        out.append(packed)
    return np.stack(out, axis=0)


def validate_doc(
    schema: CollectionSchema, doc: Doc, partial: bool = False
) -> Tuple[Optional[Dict[str, Any]], Optional[Dict[str, Any]], Status]:
    """Validate + coerce one doc. `partial=True` (updates) allows missing
    fields/vectors. Returns (fields, vectors, status)."""
    if not isinstance(doc.id, str) or not doc.id:
        return None, None, Status.error(
            StatusCode.INVALID_ARGUMENT, "doc id must be a non-empty string"
        )

    fields: Dict[str, Any] = {}
    for name, value in (doc.fields or {}).items():
        fs = schema.field(name)
        if fs is None:
            return None, None, Status.error(
                StatusCode.INVALID_ARGUMENT, f"unknown field '{name}'"
            )
        coerced, err = coerce_scalar(value, fs.data_type)
        if err:
            return None, None, Status.error(
                StatusCode.INVALID_ARGUMENT, f"field '{name}': {err}"
            )
        fields[name] = coerced

    for fs in schema.fields:
        if fs.name not in fields or fields[fs.name] is None:
            if not fs.nullable and not partial:
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT,
                    f"field '{fs.name}' is not nullable and missing",
                )

    vectors: Dict[str, Any] = {}
    for name, value in (doc.vectors or {}).items():
        vs = schema.vector(name)
        if vs is None:
            return None, None, Status.error(
                StatusCode.INVALID_ARGUMENT, f"unknown vector field '{name}'"
            )
        if vs.data_type.is_sparse_vector:
            if not isinstance(value, dict):
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT,
                    f"sparse vector '{name}' must be a dict of dim->value",
                )
            try:
                vectors[name] = {int(k): float(v) for k, v in value.items()}
            except (TypeError, ValueError):
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT,
                    f"sparse vector '{name}' has non-numeric entries",
                )
        elif vs.data_type in (DataType.VECTOR_BINARY32, DataType.VECTOR_BINARY64):
            arr, err = coerce_binary_vector(value, vs)
            if err:
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT, f"vector '{name}': {err}"
                )
            vectors[name] = arr
        elif vs.data_type == DataType.VECTOR_INT4:
            # nibble range check + pack (storage keeps 2 elements/byte;
            # reference stores DT_INT4 packed, `type_helper.cc:32`)
            arr = np.asarray(value)
            if arr.ndim != 1 or arr.shape[0] != vs.dimension:
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT,
                    f"int4 vector '{name}' must be 1-d of length {vs.dimension}",
                )
            if not np.issubdtype(arr.dtype, np.number) or (
                np.issubdtype(arr.dtype, np.floating)
                and not np.all(arr == np.round(arr))
            ):
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT,
                    f"int4 vector '{name}' must contain integers",
                )
            if arr.min() < -8 or arr.max() > 7:
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT,
                    f"int4 vector '{name}' values must be in [-8, 7]",
                )
            from ..ops.quantize import pack_int4

            vectors[name] = pack_int4(arr.astype(np.int8)[None, :])[0]
        else:
            arr = np.asarray(value)
            store_dt = _FLOAT_STORE_DTYPES.get(vs.data_type)
            if (
                store_dt is not None
                and arr.dtype != store_dt
                and arr.dtype.kind in "iuf"
            ):
                # float storage dtypes coerce here, after the numeric-kind
                # gate (strings/bools must still reject): the WAL record
                # then carries storage width (FP32 fields stop writing
                # double-width records)
                arr = arr.astype(store_dt)
            if arr.ndim != 1:
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT,
                    f"vector '{name}' must be 1-dimensional",
                )
            if arr.shape[0] != vs.dimension:
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT,
                    f"vector '{name}' dimension {arr.shape[0]} != schema {vs.dimension}",
                )
            if arr.dtype.kind not in "iufc":  # == issubdtype(_, np.number)
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT, f"vector '{name}' must be numeric"
                )
            vectors[name] = arr

    if not partial:
        for vs in schema.vectors:
            if vs.name not in vectors:
                return None, None, Status.error(
                    StatusCode.INVALID_ARGUMENT,
                    f"vector field '{vs.name}' is required",
                )

    return fields, vectors, Status.ok_status()


# create-time path rule (reference COLLECTION_PATH_REGEX, `constants.h:49`;
# enforced at `collection.cc:1719`): optional leading '/', then
# [a-zA-Z0-9_.-] path segments — rejects empty paths, spaces, specials.
_PATH_RE = re.compile(r"^/?(?:[a-zA-Z0-9_.\-]+/)*[a-zA-Z0-9_.\-]+$")


def validate_collection_path(path) -> None:
    from ..typing.status import invalid_argument

    if not isinstance(path, str) or not _PATH_RE.match(path or ""):
        raise invalid_argument(
            f"invalid collection path {path!r}: must match "
            "optional-'/' + [a-zA-Z0-9_.-] segments"
        )
