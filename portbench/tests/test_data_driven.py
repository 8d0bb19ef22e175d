"""Configurations, traffic mixes, limits and per-layer metrics added as new
files (and entries) in a copy of the benchmark: the harness finds them by
name and runs the new cells, with no file of the harness edited. One is a
filtered FLAT cell, one an HNSW cell with a query parameter and a reader of
the beam's step counter, the parts of the harness that the benchmark's own
cell does not use."""

import json
import os

os.environ.setdefault("ZVEC_TORCH_DEVICE", "cpu")  # the port on the CPU, before it is imported

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from portbench.cell import load  # noqa: E402
from portbench.run import run  # noqa: E402

from .conftest import make_tiny_root  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("dummy"))
    pb = root / "portbench"
    (pb / "configs" / "dummy_flat.json").write_text(json.dumps({
        "name": "dummy_flat", "rows": 2048, "dim": 8, "vector_field": "emb", "vector_type": "VECTOR_FP32", "vectors": "gaussian",
        "index": {"class": "FlatIndexParam", "metric_type": "L2"}, "query_pool": 256,
        "fields": [{"name": "tag", "type": "STRING", "generator": "fields_arrays", "format": "t{}"}],
        "reduced": []}))
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps({
        "batch": 32, "topk": 5, "param": None, "output_fields": [], "warmup_calls": 1, "trace_calls": 2,
        "filter": [{"field": "tag", "op": "!=", "value": {"cycle": ["t1", "t2"]}}]}))
    (pb / "limits" / "dummy_flat.dummy_mix.json").write_text(json.dumps({"score_gap": 1e-5, "rank_gap": 1e-5}))
    (pb / "metrics" / "dummy_calls.py").write_text('"""Calls in the window."""\n\n\n'
                                                  'def read(run):\n    return float(len(run["calls"]))\n')
    (pb / "configs" / "dummy_hnsw.json").write_text(json.dumps({
        "name": "dummy_hnsw", "rows": 2048, "dim": 8, "vector_field": "emb", "vector_type": "VECTOR_FP32", "vectors": "gaussian",
        "index": {"class": "HnswIndexParam", "metric_type": "L2", "m": 16, "ef_construction": 64},
        "query_pool": 256, "fields": [], "reduced": []}))
    (pb / "traffic" / "dummy_beam.json").write_text(json.dumps({
        "batch": 64, "topk": 10, "param": {"class": "HnswQueryParam", "ef": 64}, "filter": None,
        "output_fields": [], "warmup_calls": 1, "trace_calls": 2}))
    (pb / "limits" / "dummy_hnsw.dummy_beam.json").write_text(json.dumps({"score_gap": 1e-5}))
    (pb / "metrics" / "dummy_steps.py").write_text('"""Beam steps a call."""\n\n\n'
                                                  'def read(run):\n'
                                                  '    return sum(c["steps"] for c in run["calls"]) / len(run["calls"])\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_flat", "source": "a test", "file": "portbench/configs/dummy_flat.json",
                             "reduced": [], "why": "a test"})
    bench["configs"].append({"name": "dummy_hnsw", "source": "a test", "file": "portbench/configs/dummy_hnsw.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_flat.dummy_mix", "config": "dummy_flat", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    bench["workloads"].append({"name": "dummy_hnsw.dummy_beam", "config": "dummy_hnsw", "traffic": "dummy_beam",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_steps", "unit": "steps/call", "better": "lower",
                               "source": "program_counter", "layer": "Beam", "moves": "qps",
                               "workloads": ["dummy_hnsw.dummy_beam"]})
    bench["per_layer"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "Harness", "moves": "qps",
                               "workloads": ["dummy_flat.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_cell_found_by_name(root):
    cell = load(root, "dummy_flat.dummy_mix")
    assert cell.config["name"] == "dummy_flat" and cell.traffic["batch"] == 32
    assert cell.limits == {"score_gap": 1e-5, "rank_gap": 1e-5}
    assert {m["name"] for m in cell.end_to_end} == {"qps", "recall_at_10", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"host_api_ms", "engine_ms", "device_idle_pct", "dummy_calls"}
    assert "dummy_calls" not in {m["name"] for m in load(root, "sift1m_flat_l2.batch").per_layer}
    with pytest.raises(KeyError):
        load(root, "dummy_flat.other")


def test_new_cell_runs(root):
    result, lines = run(root, "dummy_flat.dummy_mix", 2**33 + 1, 0.3, trace=True, device="cpu")
    assert result["correct"], lines
    metrics = result["metrics"]
    assert metrics["dummy_calls"]["value"] >= 1 and metrics["dummy_calls"]["unit"] == "calls"
    assert "qps" not in metrics
    assert list(result)[-1] == "checks" and set(result["checks"]) == {"score_gap", "rank_gap"}
    assert len(lines) == 2 and all(line.startswith("check ") for line in lines)


def test_new_hnsw_cell_runs(root):
    result, lines = run(root, "dummy_hnsw.dummy_beam", 2**35 + 3, 0.3, trace=True, device="cpu")
    assert result["correct"], lines
    assert set(result["metrics"]) == {"host_api_ms", "engine_ms", "dummy_steps"}
    assert result["metrics"]["dummy_steps"]["value"] > 0
    assert list(result["checks"]) == ["score_gap"]


def test_filter_dropped_is_not_correct(root, monkeypatch):
    from zvec_tpu_torch.db.collection_impl import CollectionImpl

    monkeypatch.setattr(CollectionImpl, "_filter_mask_for_segment",
                        lambda self, seg, filter_str: np.ones(seg.doc_count, dtype=bool))
    result, _ = run(root, "dummy_flat.dummy_mix", 2**33 + 2, 0.3, trace=False, device="cpu")
    assert not result["correct"]
    assert result["checks"]["score_gap"]["value"] == 1.0
