"""Read the control of a cell: the plain reference in the program's place at
TF32 (`reference/control.py`), held to the same comparison as a run, at the
cell's own size, on several seeds in one process. The benchmark's own runs
never run it; it gives the upper readings the limits of `limits/<cell>.json`
are set under.

    python3 portbench/control.py --workload <cell> --calls <n> --seeds <s1> <s2> <s3>

`--calls` is the number of calls a run of the cell makes in its window.
Prints one JSON line per seed: the numbers compared and recall@10.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--calls", type=int, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.reference.control import Tf32Control
    from portbench.run import run

    if not torch.cuda.is_available():
        print("the control is read on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        result, _ = run(ROOT, args.workload, seed, 3600.0, False, system_factory=Tf32Control,
                        max_calls=args.calls)
        print(json.dumps({"workload": args.workload, "seed": seed, "calls": args.calls,
                          "correct": result["correct"], "checks": result["checks"],
                          "recall_at_10": result["metrics"].get("recall_at_10", {}).get("value")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
