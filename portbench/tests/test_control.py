"""The control (the plain reference at TF32 in the program's place) comes out
not correct on every cell: at a tiny size on the CPU, with TF32 emulated by
rounding the inputs. Its readings at the cells' own size come from
`portbench/control.py` on the card (PERF.md)."""

import os

os.environ.setdefault("ZVEC_TORCH_DEVICE", "cpu")

import pytest  # noqa: E402

from portbench.reference.control import Tf32Control  # noqa: E402
from portbench.run import run  # noqa: E402

CELLS = ["sift1m_flat_l2.batch"]


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 17])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell, seed):
    result, _ = run(tiny_root, cell, seed, 60.0, trace=False, device="cpu",
                    system_factory=Tf32Control, max_calls=8)
    assert not result["correct"], result["checks"]
    assert result["checks"]["score_gap"]["value"] > 3 * result["checks"]["score_gap"]["limit"]
