"""No module of the benchmark imports JAX or the JAX package, by whole
top-level name, and the reference imports nothing of the program."""

import ast

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "penguin_tpu"}
MODULES = sorted((ROOT / "perfbench").rglob("*.py"))


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(ROOT)) for p in MODULES])
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


def test_whole_names_are_compared():
    # the port's name begins with the JAX package's; only the whole name
    # counts
    assert "penguin_tpu_torch" not in FORBIDDEN
    assert "penguin_tpu_torch".split(".")[0] != "penguin_tpu"


def test_reference_stands_apart():
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        assert "penguin_tpu_torch" not in _imports(path), path
