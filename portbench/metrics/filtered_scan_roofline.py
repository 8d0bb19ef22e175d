"""Kernels (`ops/flat_scan.py`: `csrc/flat_scan.cu`, `flat_merge.cu`,
`flat_rescore.cu`, and whatever else a filtered call launches): the least
time of the traced calls' useful work (`roofline/filtered_scan.py`: the
queries against the rows their filter keeps) over the device time of every
kernel and copy the traced calls launched, in %.

The rows each traced call's filter keeps are counted here, from the cell's
mix and the fields its generators make from the run's seed, with the
reference's `row_mask`, never from the program's counters. The cell and the
seed are the harness's command line (`--workload`, `--seed`); the traced
calls follow the window's, as `run.py` makes them.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _invocation():
    """(cell, seed) of the harness's command line, or None."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int)
    args, _ = parser.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None:
        return None
    return args.workload, args.seed % (1 << 64)


def read(run):
    tr = run["trace"]
    if tr is None or not run["trace_calls"] or tr["device_s"] <= 0:
        return None
    invocation = _invocation()
    if invocation is None:
        return None
    from portbench.cell import load
    from portbench.gen import calls as calls_mod
    from portbench.gen.fields import make_fields
    from portbench.reference.filter import row_mask
    from portbench.roofline import filtered_scan

    cell = load(ROOT, invocation[0])
    cfg, mix, s = cell.config, cell.traffic, run["shape"]
    fields = make_fields(cfg.get("fields", []), s["rows"], invocation[1])
    least = 0.0
    for call in calls_mod.calls(mix, cfg["query_pool"], len(run["calls"]), run["trace_calls"]):
        n_pass = int(row_mask(call.clauses, fields, s["rows"]).sum())
        least += filtered_scan.least_time(call.hi - call.lo, n_pass, s["rows"], s["dim"], s["topk"])["seconds"]
    return 100.0 * least / tr["device_s"]
