"""A filter evaluated on the generator's field arrays: the clauses of a call
(`gen.calls.Call.clauses`), joined by AND, as a row mask."""

from __future__ import annotations

import operator
from typing import Dict

import numpy as np

_OPS = {
    "=": operator.eq,
    "!=": operator.ne,
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
}


def row_mask(clauses, fields: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """(n,) bool: the rows every clause keeps (all rows for no clause)."""
    keep = np.ones(n, dtype=bool)
    for name, op, value in clauses or ():
        keep &= _OPS[op](fields[name], value)
    return keep
