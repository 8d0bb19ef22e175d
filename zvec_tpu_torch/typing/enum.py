"""Enum catalog.

Parity with the reference binding (`src/binding/python/typing/python_type.cc:44-154`)
plus the internal-only data types the reference declares in `src/include/zvec/db/type.h:34-68`
(BINARY vectors, INT4/INT16 vectors) which its binding keeps commented out; we
expose the same public subset and keep the rest for internal use.
"""

from __future__ import annotations

from enum import IntEnum

__all__ = [
    "DataType",
    "IndexType",
    "MetricType",
    "QuantizeType",
    "StatusCode",
    "LogLevel",
    "LogType",
]


class DataType(IntEnum):
    UNDEFINED = 0

    # scalars
    BINARY = 1
    STRING = 2
    BOOL = 3
    INT32 = 4
    INT64 = 5
    UINT32 = 6
    UINT64 = 7
    FLOAT = 8
    DOUBLE = 9

    # dense vectors
    VECTOR_BINARY32 = 20
    VECTOR_BINARY64 = 21
    VECTOR_FP16 = 22
    VECTOR_FP32 = 23
    VECTOR_FP64 = 24
    VECTOR_INT4 = 25
    VECTOR_INT8 = 26
    VECTOR_INT16 = 27

    # sparse vectors
    SPARSE_VECTOR_FP32 = 40
    SPARSE_VECTOR_FP16 = 41

    # arrays of scalars
    ARRAY_BINARY = 60
    ARRAY_STRING = 61
    ARRAY_BOOL = 62
    ARRAY_INT32 = 63
    ARRAY_INT64 = 64
    ARRAY_UINT32 = 65
    ARRAY_UINT64 = 66
    ARRAY_FLOAT = 67
    ARRAY_DOUBLE = 68

    @property
    def is_vector(self) -> bool:
        return DataType.VECTOR_BINARY32 <= self <= DataType.SPARSE_VECTOR_FP16

    @property
    def is_dense_vector(self) -> bool:
        return DataType.VECTOR_BINARY32 <= self <= DataType.VECTOR_INT16

    @property
    def is_sparse_vector(self) -> bool:
        return self in (DataType.SPARSE_VECTOR_FP32, DataType.SPARSE_VECTOR_FP16)

    @property
    def is_array(self) -> bool:
        return DataType.ARRAY_BINARY <= self <= DataType.ARRAY_DOUBLE

    @property
    def is_scalar(self) -> bool:
        return DataType.BINARY <= self <= DataType.DOUBLE

    @property
    def element_type(self) -> "DataType":
        """Scalar element type for an array type."""
        _MAP = {
            DataType.ARRAY_BINARY: DataType.BINARY,
            DataType.ARRAY_STRING: DataType.STRING,
            DataType.ARRAY_BOOL: DataType.BOOL,
            DataType.ARRAY_INT32: DataType.INT32,
            DataType.ARRAY_INT64: DataType.INT64,
            DataType.ARRAY_UINT32: DataType.UINT32,
            DataType.ARRAY_UINT64: DataType.UINT64,
            DataType.ARRAY_FLOAT: DataType.FLOAT,
            DataType.ARRAY_DOUBLE: DataType.DOUBLE,
        }
        return _MAP[self]


class IndexType(IntEnum):
    UNDEFINED = 0
    HNSW = 1
    IVF = 2
    FLAT = 3
    INVERT = 4


class MetricType(IntEnum):
    # HAMMING is a documented extension past the reference's db-level enum
    # (`type.h:77-83` stops at MIPSL2=4): the reference reaches its hamming
    # metric only through the core metric factory (`hamming_metric.cc`); here
    # binary vector fields address it directly.
    UNDEFINED = 0
    COSINE = 1
    IP = 2
    L2 = 3
    HAMMING = 5


class QuantizeType(IntEnum):
    # BINARY mirrors the reference's core-level BinaryConverter
    # (`binary_converter.cc`, threshold-sign bits), absent from its db enum
    # (`type.h:70-75`).
    UNDEFINED = 0
    FP16 = 1
    INT8 = 2
    INT4 = 3
    BINARY = 4


class StatusCode(IntEnum):
    OK = 0
    NOT_FOUND = 1
    ALREADY_EXISTS = 2
    INVALID_ARGUMENT = 3
    PERMISSION_DENIED = 4
    FAILED_PRECONDITION = 5
    RESOURCE_EXHAUSTED = 6
    UNAVAILABLE = 7
    INTERNAL_ERROR = 8
    NOT_SUPPORTED = 9
    UNKNOWN = 10


class LogLevel(IntEnum):
    DEBUG = 0
    INFO = 1
    WARN = 2
    WARNING = 2
    ERROR = 3
    FATAL = 4


class LogType(IntEnum):
    CONSOLE = 0
    FILE = 1
