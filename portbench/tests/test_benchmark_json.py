"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the files each entry names, and what each cell reports."""

import json
import re

import pytest

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def reports(metric, cell):
    return cell in metric["workloads"] if "workloads" in metric else True


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (REPO / p).is_dir() and not p.endswith("_torch")
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fits_the_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used, f"configuration {c['name']} keeps no cell"
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        own = json.loads((REPO / c["file"]).read_text())
        assert own["name"] == c["name"] and own["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key)


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"]) and w["config"] in configs
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "portbench" / "limits" / f"{w['name']}.json").is_file()


def test_end_to_end():
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for cell in CELLS:
        listed = [m for m in BENCH["end_to_end"] if reports(m, cell)]
        assert len(listed) >= 2, f"{cell} reports setup_s and nothing else"


def test_per_layer():
    assert 1 <= len(BENCH["per_layer"]) <= 128
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in E2E
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert reports(E2E[m["moves"]], cell), f"{m['name']} in {cell}, which lacks {m['moves']}"
    assert all(len(spellings) == 1 for spellings in layers.values())
    for cell in CELLS:
        assert any(reports(m, cell) for m in BENCH["per_layer"]), f"{cell} has no per-layer metric"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_limits_name_numbers_the_check_makes(cell):
    limits = json.loads((REPO / "portbench" / "limits" / f"{cell}.json").read_text())
    assert limits and set(limits) <= {"score_gap", "rank_gap"}
    assert all(0 < v < 1 for v in limits.values())
