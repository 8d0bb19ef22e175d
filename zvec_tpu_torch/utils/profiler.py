"""Spans of the query path, and the per-query stage tree they build.

Reference equivalent of the tree: `zvec::Profiler`
(`src/db/common/profiler.h:26-105`) — open_stage/close_stage pairs building a
nested timing tree, enabled by a debug flag or trace id.

`span(name, detail)` marks one piece of a query's work. Tracing is on while a
`torch.profiler` is recording, or while an enabled `Profiler` tree is attached
to the calling thread (`CollectionImpl.debug_profiling`, or a `profiler=`
passed to `query_field`); otherwise a span costs one check and does nothing.
When on, a span

- opens a `record_function` range `zvec.<name>`, a `user_annotation` event on
  the device trace's timeline, beside the CUDA kernels it launched;
- pushes the stage `<name> <detail>` into the thread's attached tree;
- adds its seconds to in-memory totals by trace name (`span_totals`): count,
  total, and self seconds (the total less the spans opened inside it).

A full (generation 2) garbage collection that starts while a span is open on
the thread is a `gc` span of its own, inside the open one.

`count(name, value)` adds to a counter `zvec.<name>` while tracing is on, and
costs the same one check otherwise; `counter_totals` reads the counters.
`rows_passing` sums, over a call's segments, the rows that passed the filter
and the deletes; `rows_scored` the rows the engines' scans read on the card,
padding included (only the passing rows, padded to 1024, where a sparse mask
compacts a fused flat scan); `scans_compacted` the segment scans that were
compacted so; `scans_wide_k` the segment scans that took the fused kernels
at k > 32 (a quantized index's overscan for its refine, or a wide top-k);
`scan_blocks` the row blocks of the FLAT engine's blockwise scans (the scan
for k > 128, small corpora and CPU tensors); `refine_rows` the candidate
rows the refine re-scored at full precision (the valid ids of its (Q, C)
candidates).

`gc_paused()` pauses automatic garbage collection while a call builds its
answer Docs: built between collections, 10,240 Docs a call would be promoted
to the oldest generation and set off a full collection every few calls.
`gc_pauses()` counts the builds it wrapped and those that turned the
collector off.

The query entry points (`CollectionImpl.batch_query`, `query`) open the root
span `query`, from the argument checks to the last Doc. Inside it, per
segment, `filter` (the filter's mask), `vector_scan` / `bf_by_keys` (the
engine's dispatch: padding, masks, the host-to-device copies, the launches),
then `engine.finalize` (the engine's host post-processing, the refine among
it) around `engine.wait` (the host blocked on the card, then the copy of the
results), and `docs` (pk resolution and Doc building). `mask` is the row
mask's work: the AND of the alive and filter masks and its pass count, and
inside the engine's dispatch the padded mask, its digest, the device-mask
cache and the copy to the card on a miss. In the FLAT engine, `blockwise`
is the launch of the blockwise scan (the dispatch's part of a scan that
`vector_scan` or `bf_by_keys` holds), and `refine` the re-scoring of a
quantized scan's candidates against the float32 rows (inside
`engine.finalize`).
"""

from __future__ import annotations

import gc
import json
import threading
import time
from typing import Any, Dict, List, Optional

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

__all__ = ["Profiler", "count", "counter_totals", "gc_paused", "gc_pauses", "span", "span_totals"]

PREFIX = "zvec."


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
    """A query's stage tree. Its root is the `query` span that attaches it
    (`span(..., tree=...)`); the spans opened inside become its stages, each
    timed from its start to its end: a device search's stages together time
    the dispatch, the wait on the card and the host's post-processing."""

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
        """A stage of this tree, as the span `<kind> <detail>` of `name`."""
        kind, _, detail = name.partition(" ")
        return _open(kind, detail or None, self if self.enabled else None)

    def finish(self) -> None:
        while len(self._stack) > 1:
            self.close_stage()
        if self._root.elapsed_ms is None:
            self._root.elapsed_ms = (time.perf_counter() - self._root.start) * 1e3

    def to_json(self) -> str:
        d = self._root.to_dict()
        if self.trace_id:
            d["trace_id"] = self.trace_id
        return json.dumps(d)


class _Thread(threading.local):
    tree: Optional[Profiler] = None  # the tree attached to this thread
    gc: Optional["_Span"] = None  # the open `gc` span

    def __init__(self):
        self.frames: List["_Span"] = []  # the open spans, innermost last


_local = _Thread()
_lock = threading.Lock()
_totals: Dict[str, List[float]] = {}  # trace name -> [count, total s, self s]
_counters: Dict[str, List[int]] = {}  # counter name -> [value]


def _add(name: str, total: float, own: float) -> None:
    entry = _totals.get(name)
    if entry is None:  # allocates, so a collection may run: before the lock
        entry = _totals.setdefault(name, [0, 0.0, 0.0])
    with _lock:  # int and float updates only: no collection starts inside
        entry[0] += 1
        entry[1] += total
        entry[2] += own


def span_totals() -> Dict[str, Dict[str, float]]:
    """A copy of the totals by trace name (`zvec.<name>`): `count`,
    `total_s` and `self_s`, summed over every span closed while tracing was
    on, on every thread, since the process started."""
    out = {}
    for name, entry in _totals.copy().items():
        with _lock:
            count, total, own = entry
        out[name] = {"count": count, "total_s": total, "self_s": own}
    return out


def count(name: str, value) -> None:
    """Add `value` (an int, or a function returning one, called only while
    tracing is on) to the counter `zvec.<name>`, while tracing is on, as for
    `span`: a `torch.profiler` records, or a tree is attached to the thread."""
    if _local.tree is None and not _profiler_enabled():
        return
    n = int(value() if callable(value) else value)
    entry = _counters.get(PREFIX + name)
    if entry is None:  # allocates: before the lock, as in `_add`
        entry = _counters.setdefault(PREFIX + name, [0])
    with _lock:
        entry[0] += n


def counter_totals() -> Dict[str, int]:
    """A copy of the counters by name (`zvec.<name>`), summed over every
    `count` made while tracing was on, on every thread, since the process
    started."""
    out = {}
    for name, entry in _counters.copy().items():
        with _lock:
            out[name] = entry[0]
    return out


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "detail", "tree", "root", "range", "start", "inner", "prev")

    def __init__(self, name: str, detail: Optional[str], tree: Optional[Profiler], root: bool = False):
        self.name, self.detail, self.tree, self.root = name, detail, tree, root

    def __enter__(self):
        self.range = None
        if _profiler_enabled():
            self.range = record_function(PREFIX + self.name)
            self.range.__enter__()
        tree = self.tree
        if self.root:
            self.prev, _local.tree = _local.tree, tree
        elif tree is not None:
            tree.open_stage(self.name if self.detail is None else f"{self.name} {self.detail}")
        self.inner = 0.0
        self.start = time.perf_counter()
        if self.root:
            tree._root.start = self.start
        _local.frames.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        frames = _local.frames
        frames.pop()
        total = end - self.start
        if frames:
            frames[-1].inner += total
        _add(PREFIX + self.name, total, total - self.inner)
        if self.root:
            self.tree._root.elapsed_ms = total * 1e3
            _local.tree = self.prev
        elif self.tree is not None:
            self.tree.close_stage()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


def _open(name: str, detail: Optional[str], tree: Optional[Profiler]):
    if tree is None and not _profiler_enabled():
        return _OFF
    return _Span(name, detail, tree)


def span(name: str, detail: Optional[str] = None, tree: Optional[Profiler] = None):
    """The span `name` (trace name `zvec.<name>`, tree stage `<name>
    <detail>`), a context manager. `tree`, an enabled `Profiler` given by a
    query's entry point, is attached to the thread for the span's length, and
    the span is its root."""
    if tree is not None and tree.enabled:
        return _Span(name, detail, tree, root=True)
    return _open(name, detail, _local.tree)


_pause_lock = threading.Lock()
_pause_depth = 0  # builds inside `gc_paused`, on every thread
_pause_owned = False  # a build of `gc_paused` turned the collector off
_pause_counts = [0, 0]  # builds, builds that turned the collector off


class _GcPause:
    __slots__ = ()

    def __enter__(self):
        global _pause_depth, _pause_owned
        with _pause_lock:  # int updates and gc switches only: no collection starts inside
            _pause_counts[0] += 1
            if _pause_depth == 0 and gc.isenabled():
                gc.disable()
                _pause_owned = True
                _pause_counts[1] += 1
            _pause_depth += 1

    def __exit__(self, *exc):
        global _pause_depth, _pause_owned
        with _pause_lock:
            _pause_depth -= 1
            if _pause_depth == 0 and _pause_owned:
                _pause_owned = False
                gc.enable()
        return False


_GC_PAUSE = _GcPause()


def gc_paused():
    """A context manager that pauses automatic garbage collection while a
    call builds its answer Docs, which form no cycles. Process-wide and
    re-entrant: the first build to enter turns the collector off if it is
    on; the last to leave turns it back on if a build turned it off, also
    when the build raised. A collector the user disabled stays disabled."""
    return _GC_PAUSE


def gc_pauses() -> Dict[str, int]:
    """Builds wrapped by `gc_paused` since the process started (`builds`),
    and those that turned the collector off (`paused`); the rest found it
    off, by the user or an overlapping build on another thread."""
    with _pause_lock:
        builds, paused = _pause_counts
    return {"builds": builds, "paused": paused}


def _on_gc(phase: str, info: dict) -> None:
    """The `gc.callbacks` entry: a full collection that starts inside a
    span is the span `gc`. Never raises."""
    try:
        if info["generation"] != 2:
            return
        if phase == "start":
            if _local.frames and _local.gc is None:
                _local.gc = _Span("gc", None, _local.tree)
                _local.gc.__enter__()
        elif _local.gc is not None:
            s, _local.gc = _local.gc, None
            s.__exit__(None, None, None)
    except Exception:  # a callback that raises is reported on every collection
        pass


if not any(getattr(cb, "__module__", None) == __name__ for cb in gc.callbacks):  # once, reloads too
    gc.callbacks.append(_on_gc)
