"""The filtered cell `gist1m_flat_l2_filtered.batch_filter99` and the small
batches of `sift1m_flat_l2.small_batch`: their readers (`mask_ms`,
`scored_per_passing`, `filtered_scan_roofline`) and the least time of a
filtered scan on hand-made runs, and whole runs of both cells at a tiny size
on the CPU, where the filter keeps a tenth of the tiny rows (the cell's own
threshold keeps none of them)."""

import json
import os
import sys

os.environ.setdefault("ZVEC_TORCH_DEVICE", "cpu")  # the port on the CPU, before it is imported

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from portbench import peaks  # noqa: E402
from portbench.cell import load_module  # noqa: E402
from portbench.roofline import filtered_scan, flat_scan  # noqa: E402
from portbench.run import run  # noqa: E402
from zvec_tpu_torch.utils import profiler  # noqa: E402

from .conftest import REPO, TINY_ROWS, make_tiny_root  # noqa: E402

CELL = "gist1m_flat_l2_filtered.batch_filter99"
SMALL = "sift1m_flat_l2.small_batch"
SEED = 2**40 + 11


def reader(root, name):
    return load_module(root / "portbench" / "metrics" / f"{name}.py", f"test_filtered_metric_{name}").read


def hand_made_run(window_calls=3, trace_calls=16, device_s=0.4, rows=1_000_000):
    return {"calls": [{"wall_s": 0.05, "engine_s": 0.03, "steps": 0, "queries": 1024}] * window_calls,
            "setup": {}, "trace_calls": trace_calls, "shape": {"rows": rows, "dim": 960, "batch": 1024, "topk": 10},
            "trace": {"window_s": 1.0, "busy_s": 0.5, "device_s": device_s, "device_ops": [], "idle_gaps": []}}


def test_least_time_of_the_passing_rows():
    b = filtered_scan.least_time(1024, 10_000, 1_000_000, 960, 10)
    assert b["bound_by"] == "operations"
    assert b["flop"] == 3 * 2.0 * 1024 * 10_000 * 960
    assert b["seconds"] == pytest.approx(b["flop"] / peaks.TF32_FLOPS)
    assert b["bytes"] == 10_000 * (960 * 4 + 4) + 1_000_000 + 1024 * 960 * 4 + 1024 * 80
    assert filtered_scan.least_time(1024, 1_000_000, 1_000_000, 128, 10) == flat_scan.least_time(1024, 1_000_000, 128, 10)
    few = filtered_scan.least_time(1, 10, 1_000_000, 960, 10)
    assert few["bound_by"] == "bytes" and few["seconds"] == pytest.approx(few["bytes"] / peaks.HBM_BYTES_PER_S)


def test_roofline_counts_the_passing_rows_with_row_mask(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["portbench/run.py", "--workload", CELL, "--seed", str(SEED),
                                      "--seconds", "51", "--trace", "1"])
    # the program's counters say otherwise: the reader does not read them
    monkeypatch.setattr(profiler, "counter_totals", lambda: {"zvec.rows_passing": 1, "zvec.rows_scored": 1})
    least = filtered_scan.least_time(1024, 10_000, 1_000_000, 960, 10)["seconds"]
    got = reader(REPO, "filtered_scan_roofline")(hand_made_run())
    assert got == pytest.approx(100.0 * 16 * least / 0.4)
    assert 0.3 < 100.0 * least / 0.025 < 0.6  # a 25 ms call reads ~0.5%


def test_roofline_follows_the_traced_calls_filters(tmp_path, monkeypatch):
    root = make_tiny_root(tmp_path)
    mix_path = root / "portbench" / "traffic" / "batch_filter99.json"
    mix = json.loads(mix_path.read_text())
    mix["filter"][0]["value"] = {"cycle": [2970, 2700]}
    mix_path.write_text(json.dumps(mix))
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL, "--seed", str(SEED)])
    # three window calls: the two traced calls are calls 3 and 4, thresholds 2700 and 2970
    run_info = hand_made_run(window_calls=3, trace_calls=2, rows=TINY_ROWS)
    want = sum(filtered_scan.least_time(mix["batch"], n_pass, TINY_ROWS, 960, 10)["seconds"] for n_pass in (300, 30))
    assert reader(root, "filtered_scan_roofline")(run_info) == pytest.approx(100.0 * want / 0.4)


@pytest.mark.parametrize("case", ["no_trace", "no_traced_call", "no_device_time", "no_command_line"])
def test_roofline_finds_nothing(case, monkeypatch):
    run_info = hand_made_run()
    argv = ["run.py", "--workload", CELL, "--seed", "5"]
    if case == "no_trace":
        run_info["trace"] = None
    elif case == "no_traced_call":
        run_info["trace_calls"] = 0
    elif case == "no_device_time":
        run_info["trace"]["device_s"] = 0.0
    else:
        argv = ["pytest"]
    monkeypatch.setattr(sys, "argv", argv)
    assert reader(REPO, "filtered_scan_roofline")(run_info) is None


def span(count, total_s, self_s):
    return {"count": count, "total_s": total_s, "self_s": self_s}


def test_mask_ms_reads_the_span(monkeypatch):
    totals = {"zvec.query": span(16, 0.5, 0.01), "zvec.mask": span(32, 0.048, 0.032)}
    monkeypatch.setattr(profiler, "span_totals", lambda: dict(totals))
    assert reader(REPO, "mask_ms")(hand_made_run()) == pytest.approx(32 / 16)


@pytest.mark.parametrize("case", ["parent_program", "no_span_totals", "no_traced_call"])
def test_mask_ms_finds_nothing(case, monkeypatch):
    run_info = hand_made_run()
    if case == "parent_program":  # spans, but not `zvec.mask`
        monkeypatch.setattr(profiler, "span_totals", lambda: {"zvec.query": span(16, 0.5, 0.01)})
    elif case == "no_span_totals":
        monkeypatch.delattr(profiler, "span_totals")
    else:
        monkeypatch.setattr(profiler, "span_totals", lambda: {"zvec.query": span(16, 0.5, 0.01),
                                                              "zvec.mask": span(1, 0.1, 0.1)})
        run_info["trace_calls"] = 0
    assert reader(REPO, "mask_ms")(run_info) is None


def test_scored_per_passing_reads_the_counters(monkeypatch):
    monkeypatch.setattr(profiler, "counter_totals",
                        lambda: {"zvec.rows_passing": 16 * 10_000, "zvec.rows_scored": 16 * 1_007_616})
    assert reader(REPO, "scored_per_passing")(hand_made_run()) == pytest.approx(100.7616)


@pytest.mark.parametrize("case", ["parent_program", "nothing_scanned", "nothing_passed", "no_traced_call"])
def test_scored_per_passing_finds_nothing(case, monkeypatch):
    run_info = hand_made_run()
    totals = {"zvec.rows_passing": 10, "zvec.rows_scored": 1000}
    if case == "parent_program":
        monkeypatch.delattr(profiler, "counter_totals")
    else:
        if case == "nothing_scanned":
            del totals["zvec.rows_scored"]
        elif case == "nothing_passed":
            totals["zvec.rows_passing"] = 0
        else:
            run_info["trace_calls"] = 0
        monkeypatch.setattr(profiler, "counter_totals", lambda: dict(totals))
    assert reader(REPO, "scored_per_passing")(run_info) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark, the filter keeping rows 2,700 and above: 300 of
    3,000, a tenth, which the program answers by the masked device scan."""
    root = make_tiny_root(tmp_path_factory.mktemp("filtered"))
    mix_path = root / "portbench" / "traffic" / "batch_filter99.json"
    mix = json.loads(mix_path.read_text())
    mix["filter"][0]["value"] = 2700
    mix_path.write_text(json.dumps(mix))
    return root


def test_filtered_cell_runs(root, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL, "--seed", str(SEED)])
    result, lines = run(root, CELL, SEED, 0.3, trace=True, device="cpu")
    assert result["correct"], lines
    metrics = result["metrics"]
    assert {"mask_ms", "scored_per_passing", "host_api_ms", "engine_ms"} <= set(metrics)
    assert metrics["scored_per_passing"]["value"] == pytest.approx(3072 / 300)
    assert "filtered_scan_roofline" not in metrics  # no device trace on the CPU
    assert set(result["checks"]) == {"score_gap", "rank_gap"}


def test_filtered_cell_with_the_filter_dropped_is_not_correct(root, monkeypatch):
    from zvec_tpu_torch.db.collection_impl import CollectionImpl

    monkeypatch.setattr(CollectionImpl, "_filter_mask_for_segment",
                        lambda self, seg, filter_str: np.ones(seg.doc_count, dtype=bool))
    result, _ = run(root, CELL, SEED + 1, 0.3, trace=False, device="cpu")
    assert not result["correct"]
    assert result["checks"]["score_gap"]["value"] == 1.0


def test_small_batch_cell_runs(root):
    result, lines = run(root, SMALL, SEED, 0.3, trace=False, device="cpu")
    assert result["correct"], lines
    assert result["metrics"]["recall_at_10"]["value"] == 1.0
    traced, _ = run(root, SMALL, SEED, 0.3, trace=True, device="cpu")
    assert traced["correct"] and "mask_ms" in traced["metrics"]
