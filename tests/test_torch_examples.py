"""The port's examples (`zvec_tpu_torch/examples/`) print the ids that the JAX
package's examples (`examples/*.py`, run as with `ZVEC_EXAMPLE_CPU=1`) print.

Each reference example is loaded from its file with its collection path moved
into the test's directory, run, and its printed ids parsed. quantized_groupby
runs with N = 1,000 rows (the least that still takes the beam: brute force
stops below 1,000) and ef_construction = 100 in both packages: its 5,000-row
graph build at the default efc = 500 takes about half a minute per package on
the CPU. The card runs it whole (`chip_smoke.py --phases tools`).
"""

import os
import ast
import functools
import importlib.util
import re
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
os.environ["ZVEC_TORCH_DEVICE"] = "cpu"  # the port runs on the CPU here, asked for (ops/runtime.device)

import zvec_tpu  # noqa: E402
import zvec_tpu_torch  # noqa: E402
from zvec_tpu.utils.config import GlobalConfig as JConfig  # noqa: E402
from zvec_tpu_torch.examples import hybrid_multivector, mesh_sharding, quantized_groupby, quickstart  # noqa: E402
from zvec_tpu_torch.utils.config import GlobalConfig as TConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _reference(name, tmp_path, monkeypatch, capsys, **overrides):
    monkeypatch.setenv("ZVEC_EXAMPLE_CPU", "1")
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "PATH", str(tmp_path / f"ref_{name}"))
    for k, v in overrides.items():
        monkeypatch.setattr(mod, k, v)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def test_quickstart_prints_the_same_ids(tmp_path, monkeypatch, capsys):
    ref = _reference("quickstart", tmp_path, monkeypatch, capsys)
    got = quickstart.main(str(tmp_path / "port"))
    out = capsys.readouterr().out
    want = re.findall(r"^  (p\d+)  score=", ref, re.M)
    assert len(want) == 5 and got == want
    assert re.findall(r"^  (p\d+)  score=", out, re.M) == want


def test_hybrid_multivector_prints_the_same_ids(tmp_path, monkeypatch, capsys):
    ref = _reference("hybrid_multivector", tmp_path, monkeypatch, capsys)
    got = hybrid_multivector.main(str(tmp_path / "port"))
    out = capsys.readouterr().out
    # the reference prints each hit's text, the port its id and text
    want = [str(hybrid_multivector.CORPUS.index(t)) for t in re.findall(r"^  rrf=\S+  (.*)$", ref, re.M)]
    assert len(want) == 3 and got == want
    assert re.findall(r"^  (\d+)  rrf=", out, re.M) == want
    assert re.findall(r"rrf=(\S+)", out) == re.findall(r"rrf=(\S+)", ref)


def _printed(text):
    """quantized_groupby's printed lines -> the same structure its main returns."""
    lines = dict(line.split(":", 1) for line in text.splitlines() if ":" in line)
    pairs = lambda s: [i for i, _ in ast.literal_eval(s.strip())]  # noqa: E731
    return {
        "plain": pairs(lines["int8 cosine top-5"]),
        "refined": pairs(lines["refined top-5"]),
        "filtered": ast.literal_eval(lines["filtered (sports)"].strip()),
        "group_by": ast.literal_eval(lines["group-by"].strip()),
    }


def test_quantized_groupby_prints_the_same_ids(tmp_path, monkeypatch, capsys):
    small = dict(N=1000, HnswIndexParam=functools.partial(zvec_tpu.HnswIndexParam, ef_construction=100))
    ref = _reference("quantized_groupby", tmp_path, monkeypatch, capsys, **small)
    monkeypatch.setattr(quantized_groupby, "N", 1000)
    monkeypatch.setattr(quantized_groupby, "HnswIndexParam",
                        functools.partial(zvec_tpu_torch.HnswIndexParam, ef_construction=100))
    got = quantized_groupby.main(str(tmp_path / "port"))
    out = capsys.readouterr().out
    want = _printed(ref)
    assert got == want and _printed(out) == want
    assert len(want["group_by"]) == 3 and "OK" in out.splitlines()


def test_mesh_sharding_prints_the_same_ids(tmp_path, monkeypatch, capsys):
    """The reference shards over its 8 virtual CPU devices, the port over 8
    shards on the CPU; both print the exact top-5."""
    for cfg in (JConfig, TConfig):  # the reference example leaves its mesh on
        monkeypatch.setattr(cfg.instance(), "mesh_devices", cfg.instance().mesh_devices)
    ref = _reference("mesh_sharding", tmp_path, monkeypatch, capsys)
    got = mesh_sharding.main(str(tmp_path / "port"))
    out = capsys.readouterr().out
    want = ast.literal_eval(re.search(r"^sharded top-5: (.*)$", ref, re.M).group(1))
    assert len(want) == 5 and got == want
    assert ast.literal_eval(re.search(r"^sharded top-5: (.*)$", out, re.M).group(1)) == want
    assert "code table: 8 shards of 3072 rows on ['cpu']" in out
    assert TConfig.instance().mesh_devices == 0
