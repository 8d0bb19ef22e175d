"""On the card, at a small size: a whole run of each cell comes out correct
with its per-layer metrics read from the device trace, and the control (real
TF32 on the tensor cores) comes out not correct. The mixes keep their
batches. Marked `cuda`; without a
card these skip. Run them on the card with
`python -m pytest portbench/tests/test_cuda.py -q`."""

import json

import pytest
import torch

from portbench.reference.control import Tf32Control
from portbench.run import run

from .conftest import make_tiny_root

pytestmark = pytest.mark.cuda
CELLS = ["sift1m_flat_l2.batch"]


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("small"))
    for path in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["rows"], cfg["query_pool"] = 16384, 2560
        path.write_text(json.dumps(cfg))
    for path in (root / "portbench" / "traffic").glob("*.json"):
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


@pytest.mark.parametrize("cell", CELLS)
def test_run_on_card(small_root, card, cell):
    result, lines = run(small_root, cell, 2**31 + 3, 0.5, trace=True, device=card)
    assert result["correct"], lines
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert "device_idle_pct" in result["metrics"]
    assert len(result["breakdown"]["device_ops"]) >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_on_card_is_not_correct(small_root, card, cell):
    result, _ = run(small_root, cell, 2**31 + 4, 60.0, trace=False, device=card,
                    system_factory=Tf32Control, max_calls=8)
    assert not result["correct"], result["checks"]
