"""Probe the CUDA backend in a disposable child process.

The counterpart of ``probe_backend`` in ``dynolog_tpu/_jaxinit.py``. A
wedged driver or device can hang CUDA initialization indefinitely, and
init state is per process, so the only safe probe is a child with a
deadline. A caller runs it before it starts work it cannot abort (a
benchmark, a soak, a long training run).
"""

from __future__ import annotations

import subprocess
import sys

_PROBE = (
    "import torch\n"
    "torch.cuda.init()\n"
    "print(torch.cuda.get_device_name(0))\n"
)


def probe_backend(timeout_s: float = 150.0) -> str | None:
    """CUDA init in a SUBPROCESS with a deadline; returns None when the
    card comes up, else a one-line error message."""
    try:
        probe = subprocess.run(
            [sys.executable, "-c", _PROBE],
            capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return (f"cuda init timed out after {timeout_s:.0f}s — driver or "
                "device wedged? (a wedged device hangs init indefinitely)")
    if probe.returncode != 0:
        tail = (probe.stderr.strip().splitlines() or ["init failed"])[-1]
        return f"cuda init failed: {tail}"
    return None
