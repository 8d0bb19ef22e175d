"""The benchmark of zvec_tpu_torch, the PyTorch / CUDA port of zvec_tpu.

One command runs one cell of `BENCHMARK.json` on the card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own that the harness finds by name
(`configs/<config>.json`, `traffic/<mix>.json`, `limits/<cell>.json`,
`metrics/<metric>.py`, `roofline/<kernel>.py`). The generators (`gen/`),
the plain reference (`reference/`), the comparison that decides `correct`
(`check.py`), the trace reduction (`trace.py`) and the table of peaks
(`peaks.py`) are the yardstick; `port.py` is the one module that drives the
program, through its public API.
"""
