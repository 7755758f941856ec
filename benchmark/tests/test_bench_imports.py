"""Nothing under benchmark/ imports JAX or the JAX package (top-level
names compared whole), and the reference and the statement generators
import nothing of the program."""

import ast
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
PROGRAM = "genstark_tpu_torch"


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(HERE)) for p in FILES])
def test_no_jax(path):
    assert not top_level_imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("sub", ["reference", "statements"])
def test_plain_code_imports_nothing_of_the_program(sub):
    for path in (HERE / sub).rglob("*.py"):
        assert PROGRAM not in top_level_imports(path), path
        assert "examples" not in top_level_imports(path), path


def test_the_program_is_not_the_jax_package():
    assert PROGRAM.split(".")[0] not in run.FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "genstark_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]
