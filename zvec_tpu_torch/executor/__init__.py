from .query_executor import (
    MultiVectorQueryExecutor,
    NoVectorQueryExecutor,
    QueryContext,
    QueryExecutor,
    QueryExecutorFactory,
    SingleVectorQueryExecutor,
)

__all__ = [
    "QueryContext",
    "QueryExecutor",
    "QueryExecutorFactory",
    "NoVectorQueryExecutor",
    "SingleVectorQueryExecutor",
    "MultiVectorQueryExecutor",
]
