"""The one traffic generator: a mix's parameters -> the calls of a run.

A mix (`traffic/<mix>.json`) is data:

- `batch`: queries a call; call c takes pool slice c mod (pool // batch);
- `topk`, `param` (a query parameter class of the program and its keyword
  arguments, or null), `output_fields`;
- `filter`: null, or a list of clauses {field, op, value} joined by AND, where
  a value {"cycle": [...]} takes element c mod len in call c;
- `warmup_calls`: calls made in set-up (the first ones of the cycle), so that
  every shape and every cached filter the window meets is warm;
- `trace_calls`: calls traced by the profiler after the window with
  `--trace 1`.

The calls are closed-loop: one client, the next call when the last returns.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import lcm
from typing import List, Optional

OPS = ("=", "!=", "<", "<=", ">", ">=")


@dataclass(frozen=True)
class Call:
    index: int
    lo: int  # the call's queries are pool rows [lo, hi)
    hi: int
    clauses: Optional[tuple]  # ((field, op, value), ...) or None
    combo: int  # calls with one combo ask the same queries under the same filter


def _value(v, c: int):
    return v["cycle"][c % len(v["cycle"])] if isinstance(v, dict) else v


def period(traffic: dict, pool: int) -> int:
    """Calls until the sequence repeats."""
    n = pool // traffic["batch"]
    for clause in traffic.get("filter") or []:
        if isinstance(clause["value"], dict):
            n = lcm(n, len(clause["value"]["cycle"]))
    return n


def call(traffic: dict, pool: int, c: int) -> Call:
    batch = traffic["batch"]
    slices = pool // batch
    if slices < 1:
        raise ValueError(f"batch {batch} exceeds the query pool {pool}")
    s = c % slices
    clauses = None
    if traffic.get("filter"):
        clauses = tuple((cl["field"], cl["op"], _value(cl["value"], c)) for cl in traffic["filter"])
        for _, op, _ in clauses:
            if op not in OPS:
                raise ValueError(f"unknown filter operator {op!r}")
    return Call(c, s * batch, (s + 1) * batch, clauses, c % period(traffic, pool))


def render(clauses) -> Optional[str]:
    """The filter string the program parses: `tag = 't3' AND price < 0.5`."""
    if not clauses:
        return None
    parts = []
    for name, op, value in clauses:
        lit = f"'{value}'" if isinstance(value, str) else repr(value)
        parts.append(f"{name} {op} {lit}")
    return " AND ".join(parts)


def calls(traffic: dict, pool: int, start: int, count: int) -> List[Call]:
    return [call(traffic, pool, c) for c in range(start, start + count)]
