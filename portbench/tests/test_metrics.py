"""Each per-layer reader, the trace reduction and the roofline arithmetic on
synthetic inputs."""

import pytest

from portbench import peaks
from portbench.cell import load_module
from portbench.roofline import flat_scan
from portbench.trace import CALL, WINDOW, reduce, short_name

from .conftest import REPO

METRICS = REPO / "portbench" / "metrics"


def reader(name):
    return load_module(METRICS / f"{name}.py", f"test_metric_{name}").read


CALLS = [{"wall_s": 0.060, "engine_s": 0.010, "steps": 70, "queries": 1024},
         {"wall_s": 0.070, "engine_s": 0.012, "steps": 74, "queries": 1024}]
TRACE = {"window_s": 2.0, "busy_s": 0.5, "device_s": 0.064, "device_ops": [], "idle_gaps": []}
RUN = {"calls": CALLS, "setup": {"build_times": {"forward_knn": 8.25, "merge": 3.0}},
       "trace": TRACE, "trace_calls": 16, "shape": {"rows": 1_000_000, "dim": 128, "batch": 1024, "topk": 10}}
EMPTY = {"calls": [], "setup": {"build_times": {}}, "trace": None, "trace_calls": 0, "shape": RUN["shape"]}


def test_host_api_and_engine_ms():
    assert reader("host_api_ms")(RUN) == pytest.approx(54.0)
    assert reader("engine_ms")(RUN) == pytest.approx(11.0)


def test_device_idle_pct():
    assert reader("device_idle_pct")(RUN) == pytest.approx(75.0)


def test_flat_scan_roofline():
    least = 3 * 2.0 * 1024 * 1_000_000 * 128 / peaks.TF32_FLOPS
    assert reader("flat_scan_roofline")(RUN) == pytest.approx(100.0 * least / (0.064 / 16))


@pytest.mark.parametrize("name", ["host_api_ms", "engine_ms", "device_idle_pct", "flat_scan_roofline"])
def test_readers_find_nothing(name):
    assert reader(name)(EMPTY) is None


def test_flat_scan_least_time():
    b = flat_scan.least_time(1024, 1_000_000, 128, 10)
    assert b["bound_by"] == "operations"
    assert b["seconds"] == pytest.approx(1.589e-3, rel=1e-3)
    assert b["bytes"] == 1_000_000 * (512 + 5) + 1024 * 128 * 4 + 1024 * 80
    small = flat_scan.least_time(1, 1_000_000, 128, 10)
    assert small["bound_by"] == "bytes"
    assert small["seconds"] == pytest.approx(small["bytes"] / peaks.HBM_BYTES_PER_S)


def ev(name, cat, ts, dur, pid=1, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def test_reduce_synthetic_trace():
    events = [
        ev(WINDOW, "user_annotation", 0, 1000),
        ev(CALL, "user_annotation", 10, 400),
        ev("aten::item", "cpu_op", 300, 100),
        ev(CALL, "user_annotation", 500, 480),
        ev("void k1<3>(float const*, int)", "kernel", 100, 150, pid=0, tid=7),
        ev("k1<3>", "kernel", 200, 100, pid=0, tid=7),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 50, pid=0, tid=7),
    ]
    tr = reduce(events)
    assert tr["window_s"] == pytest.approx(1000e-6)
    assert tr["busy_s"] == pytest.approx(250e-6)  # [100, 300] and [600, 650]
    assert tr["device_s"] == pytest.approx(300e-6)
    assert tr["device_ops"][0] == ["k1<3>", pytest.approx(250e-6)]
    idle = dict(tr["idle_gaps"])
    # gaps [0,100] mid 50 in the call, [300,600] mid 450 after aten::item ends, [650,1000] mid 825
    assert idle["host python inside the call"] == pytest.approx((100 + 350) * 1e-6)
    assert idle["harness between calls"] == pytest.approx(300e-6)
    assert reduce([ev("x", "cpu_op", 0, 5)]) is None


def test_short_name():
    assert short_name("void at::native::k<128, 2, f(int)>(int, float*)") == "at::native::k<128, 2, f(int)>"
    assert short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD (Pageable -> Device)"
    assert short_name("void at::native::(anonymous namespace)::k<4>(int)") == "at::native::(anonymous namespace)::k<4>"
    assert len(short_name("x" * 500)) == 120
