"""The port's device contract (`zvec_tpu_torch/ops/runtime.py::device`).

Engine state lives on the CUDA card. The CPU is used only when
`ZVEC_TORCH_DEVICE=cpu` asks for it; with nothing asked for and no card,
`device()`, `make_mesh()` and the public entry points raise a RuntimeError
that names the variable, and asking for `cuda` without a card raises too.
The cases without a request run in a subprocess that sees no card
(`CUDA_VISIBLE_DEVICES=""`), so the cache on `device()` of this process is
not touched; the cases with the CPU asked for run here.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu_torch as zt  # noqa: E402
from zvec_tpu_torch.ops.runtime import DEVICE_ENV, device  # noqa: E402
from zvec_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

# each entry point, called as a user would in a fresh process
CALLS = {
    "device": "from zvec_tpu_torch.ops.runtime import device; device()",
    "make_mesh": "from zvec_tpu_torch.parallel.mesh import make_mesh; make_mesh(2)",
    "create_and_open": (
        "import sys, zvec_tpu_torch as zt; "
        "s = zt.CollectionSchema('devtest', vectors=[zt.VectorSchema('v', zt.DataType.VECTOR_FP32, 4, "
        "zt.FlatIndexParam(zt.MetricType.L2))]); zt.create_and_open(sys.argv[1], s)"
    ),
}


def _run(code: str, tmp_path, **env_over):
    env = {k: v for k, v in os.environ.items() if k != DEVICE_ENV}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="", **env_over)
    return subprocess.run([sys.executable, "-c", code, str(tmp_path / "col")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_no_card_and_nothing_asked_for_raises(name, tmp_path):
    res = _run(CALLS[name], tmp_path)
    assert res.returncode != 0
    assert "RuntimeError" in res.stderr and f"{DEVICE_ENV}=cpu" in res.stderr, res.stderr[-2000:]
    assert not (tmp_path / "col").exists()  # nothing written before the check


def test_cuda_asked_for_without_a_card_raises(tmp_path):
    res = _run(CALLS["device"], tmp_path, **{DEVICE_ENV: "cuda"})
    assert res.returncode != 0 and "RuntimeError" in res.stderr, res.stderr[-2000:]


def test_another_value_raises(tmp_path):
    res = _run(CALLS["device"], tmp_path, **{DEVICE_ENV: "tpu"})
    assert res.returncode != 0 and "ValueError" in res.stderr, res.stderr[-2000:]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_cpu_asked_for_runs_in_a_fresh_process(name, tmp_path):
    res = _run(CALLS[name], tmp_path, **{DEVICE_ENV: "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]


def test_cpu_asked_for_places_state_on_the_cpu(tmp_path):
    assert device() == torch.device("cpu")
    mesh = make_mesh(4)
    assert mesh.devices == [torch.device("cpu")] * 4
    schema = zt.CollectionSchema("devtest", vectors=[zt.VectorSchema(
        "v", zt.DataType.VECTOR_FP32, 8, zt.FlatIndexParam(zt.MetricType.L2))])
    col = zt.create_and_open(str(tmp_path / "col"), schema)
    x = np.random.default_rng(0).standard_normal((20, 8)).astype(np.float32)
    col.insert([zt.Doc(id=str(i), vectors={"v": x[i]}) for i in range(20)])
    col.optimize()
    got = col.query(zt.VectorQuery("v", vector=x[3]), topk=1)
    assert got[0].id == "3"
    engine = next(s for s in col._impl._segments_snapshot() if s.doc_count > 0).engine_for("v")
    engine._ensure_fresh()
    assert engine._st.codes.device.type == "cpu"
