"""Public typing surface: enums + Status.

Mirrors the reference's enum catalog (zvec `src/binding/python/typing/python_type.cc:44-154`,
`python/zvec/typing/enum.py:21-63`) so user code written against zvec can switch
to zvec_tpu_torch unchanged.
"""

from .enum import (
    DataType,
    IndexType,
    LogLevel,
    LogType,
    MetricType,
    QuantizeType,
    StatusCode,
)
from .status import Status, ZvecError

__all__ = [
    "DataType",
    "IndexType",
    "MetricType",
    "QuantizeType",
    "StatusCode",
    "Status",
    "ZvecError",
    "LogLevel",
    "LogType",
]
