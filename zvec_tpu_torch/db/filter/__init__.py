"""Filter expression subsystem: parse SQL-like predicates into dense masks.

Reference equivalent: the ANTLR filter grammar + Acero planner
(`src/db/sqlengine/`, grammar `antlr/SQLParser.g4`). TPU-native shape: filters
compile to per-segment dense boolean masks that are fused into the distance
kernels as selects.
"""

from .expression import FilterError, compile_filter, compile_value_expression

__all__ = ["compile_filter", "compile_value_expression", "FilterError"]
