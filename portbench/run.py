"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (`setup_s`, from the start of this process): the rows, queries and
fields from the seed (on the card), the program's collection through its
public API (create, insert, flush, optimize: `build_s`), the mix's warm-up
calls. The window: closed-loop calls of the mix for `--seconds`, one client;
`qps` is the queries answered over the window's whole length, `p95_ms` the
95th percentile of the calls' host-clock latencies. With `--trace 1` the
window is followed by the mix's traced calls under the profiler, and the line
carries the per-layer metrics instead of the end-to-end ones. Then the
device's peak memory is read, the program released, and every answer of the
timed calls held to the plain reference (`check.py`); `correct` and the
numbers compared, beside their limits, end the line and standard error.

Exits 2 without a result where the cell's cards are not there, 3 where a
JAX module is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zvec_tpu")  # top-level module names


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _bytes_written() -> int | None:
    """Bytes this process has passed to write() (Linux `wchar`: files on any
    file system, tmpfs too, and its own output)."""
    try:
        with open("/proc/self/io") as fh:
            return next(int(line.split()[1]) for line in fh if line.startswith("wchar:"))
    except (OSError, StopIteration):
        return None


class _FullCollections:
    """A `gc.callbacks` entry: the seconds of each full (generation 2)
    collection while it is attached."""

    def __init__(self):
        self.pauses, self._start = [], 0.0

    def __call__(self, phase, info):
        if info["generation"] == 2:
            if phase == "start":
                self._start = time.perf_counter()
            else:
                self.pauses.append(time.perf_counter() - self._start)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, system_factory=None, max_calls: int | None = None):
    """Run the cell; returns (result dict, the lines of the numbers compared)."""
    import torch

    from portbench import cell as cell_mod
    from portbench import check
    from portbench import trace as trace_mod
    from portbench.gen import QUERIES, ROWS, generator
    from portbench.gen import calls as calls_mod
    from portbench.gen.fields import make_fields

    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell_mod.load(root, workload)
    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    n, dim, pool, k = cfg["rows"], cfg["dim"], cfg["query_pool"], mix["topk"]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    vectors = generator(cfg["vectors"]).vectors
    x = vectors(n, dim, seed, ROWS, dev).cpu().numpy()
    queries = vectors(pool, dim, seed, QUERIES, dev).cpu().numpy()
    fields = make_fields(cfg.get("fields", []), n, seed)
    if system_factory is None:
        from portbench.port import PortSystem as system_factory

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        workdir = Path(tmp)
        system = system_factory(cfg, mix, workdir, dev)
        setup = system.setup(x, fields)
        for call in calls_mod.calls(mix, pool, 0, mix["warmup_calls"]):
            system.query(call, queries)
        sync()
        setup_s = time.perf_counter() - t_start
        _log(f"set-up {setup_s:.3f} s: insert {setup.get('insert_s', 0):.3f} s, flush "
             f"{setup.get('flush_s', 0):.3f} s, optimize {setup['build_s']:.3f} s "
             f"{setup.get('build_times')}, {mix['warmup_calls']} warm-up calls")

        gc.collect()  # the window starts from set-up's garbage collected
        system.reset_beam_steps()
        full_gcs = _FullCollections()
        gc.callbacks.append(full_gcs)
        records, kept, attempted, failed = [], [], 0, 0
        c = 0
        t0 = time.perf_counter()
        deadline, t_end = t0 + seconds, t0
        while time.perf_counter() < deadline and (max_calls is None or c < max_calls):
            call = calls_mod.call(mix, pool, c)
            attempted += call.hi - call.lo
            e0 = system.engine_secs()
            a = time.perf_counter()
            try:
                docs = system.query(call, queries)
            except Exception:  # the run goes on to report the failure
                failed += call.hi - call.lo
                _log(traceback.format_exc())
                break
            b = time.perf_counter()
            records.append({"wall_s": b - a, "engine_s": system.engine_secs() - e0,
                            "steps": system.beam_steps(), "queries": call.hi - call.lo})
            kept.append((call, system.keep(docs), True))
            del docs
            c += 1
            t_end = time.perf_counter()
        window_s = t_end - t0
        gc.callbacks.remove(full_gcs)

        traced, n_trace = None, 0
        if trace and not failed:
            from torch.profiler import record_function

            tcalls = calls_mod.calls(mix, pool, c, mix["trace_calls"])

            def traced_calls():
                out = []
                for tc in tcalls:
                    with record_function(trace_mod.CALL):
                        out.append((tc, system.keep(system.query(tc, queries)), False))
                return out

            tkept, traced = trace_mod.capture(traced_calls, workdir)
            kept += tkept
            n_trace = len(tcalls)
            attempted += sum(tc.hi - tc.lo for tc in tcalls)

        peak = torch.cuda.max_memory_allocated() if on_card else 0
        answers = [(call, system.answers(kp, call.hi - call.lo), win) for call, kp, win in kept]
        del kept
        system.close()
        del system
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checker = check.Checker(torch.from_numpy(x).to(dev), torch.from_numpy(queries).to(dev), fields, k)
    for call, (pks, scores), win in answers:
        checker.add(call, pks, scores, win)
    sync()
    _log(f"reference and comparison {time.perf_counter() - t_ref:.3f} s")
    verdicts = check.judge(checker.numbers(), cell.limits)
    correct = bool(records) and failed == 0 and all(ok for *_, ok in verdicts)
    _log(f"window {window_s:.3f} s, {len(records)} calls; answers checked: {checker.counts()}; "
         f"beam steps at the close {records[-1]['steps'] if records else None}; "
         f"bytes written by the run {_bytes_written()}")

    lat = [r["wall_s"] for r in records]
    cuts = statistics.quantiles(lat, n=20) if len(lat) > 1 else lat * 19  # 5% steps
    if lat:
        _log(f"call ms: p50 {cuts[9] * 1e3:.3f} p95 {cuts[18] * 1e3:.3f} max {max(lat) * 1e3:.3f}; "
             f"full garbage collections in the window {len(full_gcs.pauses)}, "
             f"{sum(full_gcs.pauses) * 1e3:.1f} ms")
    values = {
        "qps": sum(r["queries"] for r in records) / window_s if records else None,
        "p95_ms": cuts[18] * 1e3 if lat else None,
        "recall_at_10": checker.recall(),
        "build_s": setup["build_s"],
        "setup_s": setup_s,
    }
    if trace:
        run_info = {"calls": records, "setup": setup, "trace": traced, "trace_calls": n_trace,
                    "shape": {"rows": n, "dim": dim, "batch": mix["batch"], "topk": k}}
        values = {m["name"]: cell.readers[m["name"]](run_info) for m in cell.per_layer}
        wanted = cell.per_layer
    else:
        wanted = cell.end_to_end
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values.get(m["name"]) is not None}

    devinfo = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": devinfo}
    if traced is not None:
        devinfo["busy_s"] = traced["busy_s"]
        devinfo["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in verdicts}
    lines = [f"check {name} {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}" for name, v, lim, ok in verdicts]
    return result, lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["ZVEC_TORCH_DEVICE"] = "cuda"
    sys.path.insert(0, str(ROOT))

    from portbench.cell import load

    chips = load(ROOT, args.workload).chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"the cell needs {chips} CUDA card(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, lines = run(ROOT, args.workload, args.seed % (1 << 64), args.seconds, bool(args.trace),
                        t_start=T_START)
    bad = forbidden_modules()
    if bad:
        _log(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}")
        return 3
    for line in lines:
        _log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
