"""Find a cell's parts by name.

`BENCHMARK.json` names the cell, its configuration and its traffic mix; the
files are found from those names alone, so a later change adds a cell, a
configuration, a mix or a metric by adding files and entries:

- the configuration: the `file` of its entry in `configs`;
- the traffic mix: `portbench/traffic/<traffic>.json`;
- the limits of the comparison that decides `correct`:
  `portbench/limits/<cell>.json`;
- each per-layer metric's reader: `portbench/metrics/<metric>.py`, a module
  with `read(run) -> float | None`.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

HARNESS = "portbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """Import the Python file at `path` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load(root: Path, workload: str) -> Cell:
    """The cell `workload` of `root/BENCHMARK.json`, with its files read and
    its per-layer readers imported. Raises KeyError for an unknown name."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(root / HARNESS / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(root / HARNESS / "limits" / f"{workload}.json")

    def listed(metric: dict) -> bool:
        return workload in metric["workloads"] if "workloads" in metric else True

    end_to_end = [m for m in bench["end_to_end"] if listed(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [
        m for m in bench["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    readers = {
        m["name"]: load_module(
            root / HARNESS / "metrics" / f"{m['name']}.py", f"{HARNESS}_metric_{m['name'].replace('.', '_')}"
        ).read
        for m in per_layer
    }
    return Cell(workload, int(w["chips"]), config, traffic, limits, end_to_end, per_layer, readers)
