"""The result line's shape, from whole runs of the harness on the CPU at a
tiny size (with dynologd and the shim), and run.py's refusal without a
card."""

import json
import subprocess
import sys

import pytest

from perfbench.tests import tiny
from perfbench.tests.conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload,trace", [
    ("deepseek_llm_7b.attached", False),
    ("deepseek_llm_7b.attached", True),
    ("deepseek_llm_7b.gputrace", True)])
def test_result_line_shape(workload, trace):
    out = tiny.run(workload, seconds=4.0, trace=trace)
    res = out["result"]
    keys = [k for k in res if k != "breakdown"]
    assert keys == KEYS  # "checks" comes last
    assert res["correct"] is True, out["detail"]
    assert res["failed"] == 0 and res["attempted"] > 0
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float), name
    names = set(res["metrics"])
    if not trace:
        assert {"setup_s", "train_tokens_per_s"} <= names
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)  # one line of plain JSON


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "deepseek_llm_7b.attached", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
