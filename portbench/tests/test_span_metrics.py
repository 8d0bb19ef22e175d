"""The readers of the program's spans (`gc_pause_ms`, `docs_ms`,
`engine_wait_ms`, `engine_host_ms`): ms per traced call from planted span
totals, and nothing where there is nothing to read: no traced call, no
totals, or a program without span totals (the readers run on the parent
commit too)."""

import os

os.environ.setdefault("ZVEC_TORCH_DEVICE", "cpu")  # the port on the CPU, before it is imported

import pytest  # noqa: E402

from portbench.cell import load_module  # noqa: E402
from zvec_tpu_torch.utils import profiler  # noqa: E402

from .conftest import REPO  # noqa: E402


def reader(name):
    return load_module(REPO / "portbench" / "metrics" / f"{name}.py", f"test_span_metric_{name}").read


def t(count, total_s, self_s):
    return {"count": count, "total_s": total_s, "self_s": self_s}


TOTALS = {
    "zvec.query": t(16, 0.960, 0.016),
    "zvec.gc": t(3, 0.420, 0.420),
    "zvec.docs": t(16, 0.560, 0.160),
    "zvec.vector_scan": t(16, 0.048, 0.040),
    "zvec.engine.finalize": t(16, 0.064, 0.008),
    "zvec.engine.wait": t(16, 0.056, 0.056),
}
RUN = {"calls": [], "setup": {}, "trace": None, "trace_calls": 16, "shape": {}}
EXPECTED = {  # ms per call of 16
    "gc_pause_ms": 420 / 16,
    "docs_ms": 160 / 16,
    "engine_wait_ms": 56 / 16,
    "engine_host_ms": (40 + 8) / 16,
}
NAMES = sorted(EXPECTED)


@pytest.mark.parametrize("name", NAMES)
def test_reads_ms_per_traced_call(name, monkeypatch):
    monkeypatch.setattr(profiler, "span_totals", lambda: {k: dict(v) for k, v in TOTALS.items()})
    assert reader(name)(RUN) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", NAMES)
def test_absent_span_reads_zero(name, monkeypatch):
    monkeypatch.setattr(profiler, "span_totals", lambda: {"zvec.query": TOTALS["zvec.query"]})
    assert reader(name)(RUN) == 0.0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["no_totals", "no_traced_call", "no_span_totals_in_the_program"])
def test_nothing_to_read(name, case, monkeypatch):
    run = dict(RUN)
    if case == "no_totals":
        monkeypatch.setattr(profiler, "span_totals", dict)
    elif case == "no_traced_call":
        monkeypatch.setattr(profiler, "span_totals", lambda: dict(TOTALS))
        run["trace_calls"] = 0
    else:
        monkeypatch.delattr(profiler, "span_totals")
    assert reader(name)(run) is None
