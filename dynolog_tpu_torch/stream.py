"""Atomic artifact writes for the PyTorch shim (a copy of
``stream_write`` from ``dynolog_tpu/trace.py``)."""

from __future__ import annotations

import os


def stream_write(path: str, chunks) -> int:
    """Atomic chunked file write: tmp + rename, tmp unlinked on ANY
    failure (no orphaned .tmp next to the artifact), bytes written
    returned. A reader never sees a torn file."""
    tmp_path = path + ".tmp"
    written = 0
    try:
        with open(tmp_path, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
                written += len(chunk)
        os.replace(tmp_path, path)
    finally:
        try:
            os.unlink(tmp_path)  # no-op after a successful rename
        except OSError:
            pass
    return written
