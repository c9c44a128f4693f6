"""The port's collective probe (dynolog_tpu_torch.collectives) held against
the JAX package's (dynolog_tpu.collectives) on the CPU: the same metric
keys (2 gloo processes against JAX's 8 virtual CPU devices), the same
ring-model wire bytes, the same snapshot JSON, and every key a name the
daemon's file backend keeps."""

import json
import pathlib
import re

import pytest

from dynolog_tpu import collectives as jcol
from dynolog_tpu_torch import collectives as tcol

REPO = pathlib.Path(__file__).resolve().parent.parent


def _daemon_field_names() -> set:
    src = (REPO / "src/tpumon/TpuMetricBackend.cpp").read_text()
    block = src[src.index("tpuFieldIdToName()"):]
    block = block[:block.index("};")]
    return set(re.findall(r'\{k\w+, "(\w+)"\}', block))


def test_two_gloo_processes_give_the_jax_keys():
    ours = tcol.measure(shard_bytes=64 * 1024, device="cpu", world_size=2)
    ref = jcol.measure(shard_bytes=64 * 1024)
    assert set(ours) == set(ref)
    assert ours["collective_mesh_devices"] == 2.0
    for name in tcol.OPS:
        assert ours[f"ici_{name}_gbps"] > 0, name
        assert ours[f"ici_{name}_us"] > 0, name
    assert ours["ici_latency_us"] > 0
    assert set(ours) <= _daemon_field_names()


def test_one_process_writes_no_bandwidth():
    ours = tcol.measure(shard_bytes=4096, device="cpu")
    assert ours["collective_mesh_devices"] == 1.0
    assert not [k for k in ours if k.endswith("_gbps")]
    assert {f"ici_{name}_us" for name in tcol.OPS} <= set(ours)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_wire_bytes_match_jax_formula(n):
    """jcol.measure computes these inline (collectives.py:93-98); the
    shard rounding is its own too."""
    elems = tcol._shard_elems(1000 * 1024 + 4, n)
    want_elems = max(n, (1000 * 1024 + 4) // 4)
    want_elems += (-want_elems) % n
    assert elems == want_elems
    got = tcol.wire_bytes(n, elems)
    assert got["all_gather"] == (n - 1) * elems * 4
    assert got["reduce_scatter"] == ((n - 1) * elems * 4 / n if n > 1 else 0)
    assert got["all_reduce"] == (2 * (n - 1) * elems * 4 / n if n > 1 else 0)


@pytest.mark.parametrize("start", ["missing", "exporter", "corrupt"])
def test_merge_into_snapshot_matches_jax(tmp_path, start):
    metrics = {"collective_mesh_devices": 2.0, "ici_all_reduce_us": 12.5,
               "ici_all_reduce_gbps": 80.0, "note": "dropped"}
    exporter = {"devices": [{"device": 0, "chip_type": "nvidia_h100",
                             "metrics": {"hbm_total_bytes": 8.5e10}}],
                "ts_ms": 1}
    docs = []
    for mod in (jcol, tcol):
        path = tmp_path / f"{mod.__name__}.json"
        if start == "exporter":
            path.write_text(json.dumps(exporter))
        elif start == "corrupt":
            path.write_text("{not json")
        mod.merge_into_snapshot(metrics, str(path))
        doc = json.loads(path.read_text())
        assert doc.pop("ts_ms") > 1
        docs.append(doc)
    assert docs[0] == docs[1]
    assert "note" not in docs[1]["devices"][0]["metrics"]
    assert docs[1]["devices"][0]["metrics"]["ici_all_reduce_us"] == 12.5
    assert not list(tmp_path.glob("*.tmp.*"))


def test_every_metric_key_is_a_daemon_field():
    names = _daemon_field_names()
    assert "ici_all_reduce_us" in names and "tpu_duty_cycle_pct" in names
    keys = {"collective_mesh_devices", "ici_latency_us"}
    for name in tcol.OPS:
        keys |= {f"ici_{name}_gbps", f"ici_{name}_us"}
    assert keys <= names


def test_cli_refuses_to_fall_back_to_cpu():
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    result = subprocess.run(
        [sys.executable, "-m", "dynolog_tpu_torch.collectives",
         "--shard-bytes", "4096"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert result.returncode != 0
    assert "no CUDA device" in result.stderr
