"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package, and its entry points run on the card or raise."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "dynolog_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "dynolog_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _forbidden(name: str) -> bool:
    # dynolog_tpu_torch itself shares the prefix and is allowed.
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_module_imports_with_jax_blocked():
    names = [name for _, name in _modules()]
    code = "\n".join([
        "import importlib, sys",
        "for blocked in ('jax', 'jaxlib', 'optax'):",
        "    sys.modules[blocked] = None",
        f"for name in {names!r}:",
        "    importlib.import_module(name)",
        "leaked = sorted(m for m in sys.modules",
        "                if m == 'dynolog_tpu' or m.startswith('dynolog_tpu.'))",
        "assert not leaked, leaked",
        "print('imported', len(set(sys.modules) & set(%r)))" % (names,),
    ])
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert f"imported {len(names)}" in result.stdout


def test_no_forbidden_imports_in_source():
    offenders = []
    for path, _ in _modules():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names
                          if _forbidden(n)]
    assert not offenders, offenders


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any(_forbidden(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not _forbidden(node.module or "")


def test_train_demo_refuses_to_fall_back_to_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    result = subprocess.run(
        [sys.executable, "-m", "dynolog_tpu_torch.train_demo", "--steps",
         "1"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert result.returncode != 0
    assert "no CUDA device" in result.stderr
