"""Nothing under perfbench/ imports JAX, Flax or the JAX package, and the
reference imports nothing of the program either. Names are compared by
their whole top-level part, as `dynolog_tpu_torch` begins with
`dynolog_tpu`."""

import ast

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT

PKG = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "dynolog_tpu"}


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(PKG)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"dynolog_tpu_torch", "perfbench"})


def test_names_compare_whole():
    assert harness.FORBIDDEN == tuple(sorted(FORBIDDEN, key=list(
        harness.FORBIDDEN).index))
    assert "dynolog_tpu_torch" not in FORBIDDEN
    # The check of sys.modules takes the part before the first dot whole.
    import sys

    sys.modules.setdefault("dynolog_tpu_torch_probe", ast)
    try:
        assert "dynolog_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["dynolog_tpu_torch_probe"]
