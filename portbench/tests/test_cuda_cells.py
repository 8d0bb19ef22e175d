"""On the card, at a small size: whole runs of the cells
`gist1m_flat_l2_filtered.batch_filter99` and `sift1m_flat_l2.small_batch`
come out correct with their per-layer metrics read from the device trace and
the program's spans and counters, and the control (real TF32 on the tensor
cores) comes out not correct. The filtered cell keeps D = 960 and its
1,024-query calls over 131,072 rows, enough for the brute-force-by-keys
demotion to take the fused scan, under a filter that keeps 1% of them.
Marked `cuda`; without a card these skip. Run them on the card with
`python -m pytest portbench/tests/test_cuda_cells.py -q`."""

import json
import sys

import pytest
import torch

from portbench.reference.control import Tf32Control
from portbench.run import run

from .conftest import make_tiny_root

pytestmark = pytest.mark.cuda
FILTERED = "gist1m_flat_l2_filtered.batch_filter99"
SMALL = "sift1m_flat_l2.small_batch"
ROWS = {"gist1m_flat_l2_filtered": 131072, "sift1m_flat_l2": 16384}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("small_cells"))
    for path in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["rows"], cfg["query_pool"] = ROWS[cfg["name"]], 2560
        path.write_text(json.dumps(cfg))
    for path in (root / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["batch"] *= 8  # back to the cell's own batch
        if mix.get("filter"):
            mix["filter"][0]["value"] = int(0.99 * ROWS["gist1m_flat_l2_filtered"])
        path.write_text(json.dumps(mix))
    return root


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from zvec_tpu_torch.ops.runtime import DEVICE_ENV, device

    monkeypatch.setenv(DEVICE_ENV, "cuda")  # a CPU test file of the same process asks for the CPU
    device.cache_clear()
    yield "cuda"
    device.cache_clear()


@pytest.mark.parametrize("cell", [FILTERED, SMALL])
def test_run_on_card(small_root, card, monkeypatch, cell):
    seed = 2**31 + 13
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", cell, "--seed", str(seed)])
    result, lines = run(small_root, cell, seed, 0.5, trace=True, device=card)
    assert result["correct"], lines
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    metrics = result["metrics"]
    assert {"device_idle_pct", "host_api_ms", "engine_ms", "mask_ms"} <= set(metrics)
    if cell == FILTERED:
        assert metrics["scored_per_passing"]["value"] == pytest.approx(131072 / 1311)
        assert 0 < metrics["filtered_scan_roofline"]["value"] < 100
        assert any("flat_scan_kernel" in name for name, _ in result["breakdown"]["device_ops"])


@pytest.mark.parametrize("cell", [FILTERED, SMALL])
def test_control_on_card_is_not_correct(small_root, card, cell):
    result, _ = run(small_root, cell, 2**31 + 14, 60.0, trace=False, device=card,
                    system_factory=Tf32Control, max_calls=8)
    assert not result["correct"], result["checks"]
