"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared whole."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "deepfilternet_tpu"}
MODULES = sorted(ROOT.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert "deepfilternet_torch" not in top_level_imports(path)


def test_prefix_is_not_the_name():
    # the program's name begins with the JAX package's; the check compares
    # whole names, so the program itself passes
    assert "deepfilternet_torch".split(".")[0] not in FORBIDDEN
