"""Finds the benchmark's parts by the names that BENCHMARK.json and the
configuration files give them: ``perfbench/<kind>/<name>.py``, each loaded
once. Kinds:

- ``metrics``: a metric's reader, ``read(run)``, named by the metric;
- ``reference``: a plain reference, named by a configuration's
  ``reference``: ``leaf_shapes(model)`` and ``train_readings(...)``;
- ``programs``: how the port runs a configuration, named by its
  ``program``: ``KERNELS``, ``port_config(model)``,
  ``tree(weights, model)``, ``leaves(tree)`` and ``train_step(cfg)``."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
_loaded: dict = {}


def path(kind: str, name: str) -> Path:
    return HERE / kind / f"{name}.py"


def load(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py``."""
    if (kind, name) not in _loaded:
        file = path(kind, name)
        if not file.exists():
            raise FileNotFoundError(f"no {kind} part named {name!r}: {file}")
        safe = "".join(c if c.isalnum() else "_" for c in name)
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{safe}", file)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[kind, name] = module
    return _loaded[kind, name]
