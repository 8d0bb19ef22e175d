"""The device trace of the traced calls, and its reduction.

`capture` runs the traced calls under `torch.profiler` (CPU and CUDA
activity), exports the Chrome trace and reads it back; `reduce` turns the
events into what the per-layer readers and the result's `breakdown` need:

- `window_s`: the length of the harness's `portbench.trace` span;
- `busy_s`: the union of the device's kernels, copies and sets inside it;
- `device_s`: the sum of their durations (the device time of every kernel
  and copy the calls launched, whatever their names);
- `device_ops`: device seconds by operation name, the ten largest;
- `idle_gaps`: idle device seconds by what the host's calling thread was
  doing at the middle of each gap (its innermost span: an operator, a
  runtime call, or the harness's own spans), the ten largest.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "portbench.trace"
CALL = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def capture(fn: Callable, workdir: Path):
    """Run fn() under the profiler: (fn's result, the reduced trace, or None
    where the profiler saw no device)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = workdir / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return out, reduce(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _host_at(points: List[float], spans: List[dict]) -> List[Optional[str]]:
    """The innermost span (of properly nested `spans`, one thread's) that
    holds each of the ascending `points`; None where none does."""
    order = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    stack: List[dict] = []
    out, j = [], 0
    for p in points:
        while j < len(order) and order[j]["ts"] <= p:
            ev = order[j]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < ev["ts"]:
                stack.pop()
            stack.append(ev)
            j += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < p:
            stack.pop()
        out.append(stack[-1]["name"] if stack else None)
    return out


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without `void ` and its parameter list, at most
    `limit` characters (C++ template names run to a thousand). Names such
    as `Memcpy HtoD (Pageable -> Device)` and `(anonymous namespace)` keep
    their parentheses."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and (name[i - 1].isalnum() or name[i - 1] in "_>"):
            name = name[:i]
            break
    return name[:limit]


def _top(totals: Dict[str, float]) -> List[list]:
    return [[name, secs] for name, secs in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce(events: List[dict]) -> Optional[dict]:
    windows = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not windows:
        return None
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    clipped = [(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))) for e in device]
    clipped = [(lo, hi) for lo, hi in clipped if hi > lo]
    if not clipped:
        return None
    busy = _union(clipped)
    busy_us = sum(hi - lo for lo, hi in busy)

    by_op: Dict[str, float] = {}
    for e in device:
        name = short_name(e["name"])
        by_op[name] = by_op.get(name, 0.0) + float(e["dur"]) * 1e-6

    gaps, prev = [], w0
    for lo, hi in busy:
        if lo > prev:
            gaps.append((prev, lo))
        prev = max(prev, hi)
    if w1 > prev:
        gaps.append((prev, w1))
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("pid") == win.get("pid") and e.get("tid") == win.get("tid")]
    names = _host_at([(lo + hi) / 2 for lo, hi in gaps], host)
    idle: Dict[str, float] = {}
    for (lo, hi), name in zip(gaps, names):
        if name == CALL:
            name = "host python inside the call"
        elif name in (WINDOW, None):
            name = "harness between calls"
        idle[name] = idle.get(name, 0.0) + (hi - lo) * 1e-6

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_s": sum(float(e["dur"]) for e in device) * 1e-6,
        "device_ops": _top(by_op),
        "idle_gaps": _top(idle),
    }
