"""Per-layer metric readers, one file per metric, found by the metric's name.

Each has `read(run) -> float | None`, where `run` is the dict the harness
fills (`run.py`): `calls` (the window's calls: `wall_s`, `engine_s`,
`steps`), `setup` (what set-up measured, the index build's `build_times`
among it), `trace` (`trace.reduce`'s result, or None) with `trace_calls`,
and `shape` (`rows`, `dim`, `batch`, `topk`). A reader that finds nothing to
read returns None, and the harness leaves the metric out.
"""
