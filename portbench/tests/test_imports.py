"""What the harness may import and open: no module named jax, jaxlib, flax or
zvec_tpu (by whole top-level name: zvec_tpu_torch is the program), nothing of
the program from the reference, and no path under benchmarks/."""

import ast

import pytest

from .conftest import REPO

HARNESS = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "zvec_tpu"}
SOURCES = sorted(p for p in HARNESS.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ):
            names |= {a.value.split(".")[0] for a in node.args if isinstance(a, ast.Constant)}
    return names


def code_strings(path):
    """String constants of the code, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_sources_found():
    assert HARNESS / "run.py" in SOURCES and len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HARNESS)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HARNESS / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "zvec_tpu_torch" not in top_level_imports(path)
    assert not any("zvec_tpu" in s for s in code_strings(path))


@pytest.mark.parametrize("path", [p for p in SOURCES if p.name != "test_imports.py"],
                         ids=lambda p: str(p.relative_to(HARNESS)))
def test_nothing_opens_benchmarks(path):
    for s in code_strings(path):
        assert "benchmarks/" not in s and "bench.py" not in s and "chip_smoke" not in s


def test_the_check_sees_whole_names():
    from portbench.run import FORBIDDEN as RUN_FORBIDDEN

    assert set(RUN_FORBIDDEN) == {"jax", "jaxlib", "flax", "zvec_tpu"}
    assert "zvec_tpu_torch".split(".")[0] not in RUN_FORBIDDEN


def test_forbidden_modules_check(monkeypatch):
    import sys
    import types

    from portbench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "zvec_tpu_torch_fake", types.ModuleType("zvec_tpu_torch_fake"))
    assert "zvec_tpu_torch_fake" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax.numpy" in forbidden_modules()
