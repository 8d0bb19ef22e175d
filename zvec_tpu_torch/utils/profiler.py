"""Profiler: hierarchical per-query stage timer producing a JSON tree.

Reference equivalent: `zvec::Profiler` (`src/db/common/profiler.h:26-105`) —
open_stage/close_stage pairs building a nested timing tree, enabled by a debug
flag or trace id.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

__all__ = ["Profiler"]


class _Stage:
    __slots__ = ("name", "start", "elapsed_ms", "children")

    def __init__(self, name: str):
        self.name = name
        self.start = time.perf_counter()
        self.elapsed_ms: Optional[float] = None
        self.children: List["_Stage"] = []

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"stage": self.name, "ms": self.elapsed_ms}
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class Profiler:
    def __init__(self, enabled: bool = False, trace_id: str = ""):
        self.enabled = enabled or bool(trace_id)
        self.trace_id = trace_id
        self._root = _Stage("query")
        self._stack: List[_Stage] = [self._root]

    def open_stage(self, name: str) -> None:
        if not self.enabled:
            return
        stage = _Stage(name)
        self._stack[-1].children.append(stage)
        self._stack.append(stage)

    def close_stage(self) -> None:
        if not self.enabled or len(self._stack) <= 1:
            return
        stage = self._stack.pop()
        stage.elapsed_ms = (time.perf_counter() - stage.start) * 1e3

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()

    def stage(self, name: str):
        profiler = self

        class _Ctx:
            def __enter__(self):
                profiler.open_stage(name)

            def __exit__(self, *exc):
                profiler.close_stage()

        return _Ctx()

    def finish(self) -> None:
        while len(self._stack) > 1:
            self.close_stage()
        self._root.elapsed_ms = (time.perf_counter() - self._root.start) * 1e3

    def to_json(self) -> str:
        d = self._root.to_dict()
        if self.trace_id:
            d["trace_id"] = self.trace_id
        return json.dumps(d)
