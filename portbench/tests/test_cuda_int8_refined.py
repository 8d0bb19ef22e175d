"""On the card, at a small size: a whole run of the cell
`deep10m_int8_refined.batch` comes out correct with its per-layer metrics
read from the device trace and the program's spans and counters; the
engine's codes on the card are int8, its scan reads every padded row in
blocks and its refine re-scores 100 candidates a query; and the control
(real TF32 on the tensor cores) comes out not correct. The cell keeps D = 96 and its 1,024-query
calls, over 262,144 rows: enough for the fused scan's size rule, which the
overscan's k = 100 still sends to the blockwise scan (two blocks).
Marked `cuda`; without a card these skip. Run them on the card with
`python -m pytest portbench/tests/test_cuda_int8_refined.py -q`."""

import json
import sys

import pytest
import torch

from portbench.port import PortSystem
from portbench.reference.control import Tf32Control
from portbench.run import run

from .conftest import make_tiny_root

pytestmark = pytest.mark.cuda
CELL = "deep10m_int8_refined.batch"
ROWS = 262144  # a multiple of the scan's 8,192-row padding: n_pad = ROWS
BLOCK = 131072  # the FLAT engine's blockwise scan block


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("small_int8"))
    path = root / "portbench" / "configs" / "quantized" / "deep10m_int8_refined.json"
    cfg = json.loads(path.read_text())
    cfg["rows"], cfg["query_pool"] = ROWS, 2560
    path.write_text(json.dumps(cfg))
    path = root / "portbench" / "traffic" / "batch.json"
    mix = json.loads(path.read_text())
    mix["batch"] *= 8  # back to the cell's own batch
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


class _Watched(PortSystem):
    """The port, with its engine's device state read after each call."""

    codes = []

    def query(self, call, queries):
        out = super().query(call, queries)
        st = self._engines[0]._st
        _Watched.codes.append((st.codes.dtype, st.codes.device.type, tuple(st.codes.shape), st.n_pad))
        return out


def test_run_on_card(small_root, card, monkeypatch):
    from zvec_tpu_torch.utils.profiler import counter_totals

    seed = 2**31 + 23
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL, "--seed", str(seed)])
    _Watched.codes.clear()
    before = counter_totals()
    result, lines = run(small_root, CELL, seed, 0.5, trace=True, device=card, system_factory=_Watched)
    grew = {k: v - before.get(k, 0) for k, v in counter_totals().items()}
    assert result["correct"], lines
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    metrics = result["metrics"]
    assert {"device_idle_pct", "host_api_ms", "engine_ms", "refine_ms", "quantized_scan_roofline"} <= set(metrics)
    assert metrics["refine_ms"]["value"] > 0
    assert 0 < metrics["quantized_scan_roofline"]["value"] < 100
    assert set(_Watched.codes) == {(torch.int8, "cuda", (ROWS, 96), ROWS)}
    traced, batch = 2, 1024  # the tiny copy's traced calls; the cell's batch
    assert grew["zvec.rows_scored"] == traced * ROWS
    assert grew["zvec.scan_blocks"] == traced * ROWS // BLOCK
    assert grew["zvec.refine_rows"] == traced * batch * 100


def test_control_on_card_is_not_correct(small_root, card):
    result, _ = run(small_root, CELL, 2**31 + 25, 60.0, trace=False, device=card,
                    system_factory=Tf32Control, max_calls=8)
    assert not result["correct"], result["checks"]
    assert result["checks"]["score_gap"]["value"] > 3 * result["checks"]["score_gap"]["limit"]
