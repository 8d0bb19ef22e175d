"""Shared fixtures of the benchmark's tests: the repository on the import
path, and a copy of the benchmark cut to a size the CPU runs in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_ROWS = 3000
TINY_POOL = 512


def make_tiny_root(dest: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ under `dest`, every
    configuration cut to TINY_ROWS rows and a TINY_POOL query pool, every
    mix's batch to an eighth."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (dest / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["rows"], cfg["query_pool"] = TINY_ROWS, TINY_POOL
        path.write_text(json.dumps(cfg))
    for path in (dest / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["batch"] //= 8
        mix["trace_calls"] = 2
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
