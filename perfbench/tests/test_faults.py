"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (the CPU, a tiny size), everything else
of a run driven, once per fault these cells can have. The same run
unbroken comes out correct (test_last_line)."""

import threading
import time

import dynolog_tpu_torch.client.shim as shim
import dynolog_tpu_torch.models.train as train
import pytest
import torch

from perfbench import calibrate
from perfbench.tests import tiny


def _frozen_step(self, *args, **kwargs):
    """An optimizer step that returns its state unchanged."""
    return None


def _late_mark(self):
    """A capture's step mark written a minute after the step() it marks."""
    self.tid = threading.get_native_id()
    self.times.append(time.time_ns() + 60 * 10**9)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "capture_steps_altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    workload = "deepseek_llm_7b.attached"
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.AdamW, "step", _frozen_step)
    elif fault == "half_batch":
        monkeypatch.setattr(train, "loss_fn",
                            calibrate.half_batch(train.loss_fn))
    else:
        workload = "deepseek_llm_7b.gputrace"
        monkeypatch.setattr(shim._StepClock, "mark", _late_mark)
    out = tiny.run(workload, seconds=4.0)
    res = out["result"]
    assert res["correct"] is False
    if fault == "capture_steps_altered":
        assert res["checks"]["captures_failed"]["value"] > 0
    else:
        assert any(c["value"] > c["limit"] for k, c in res["checks"].items()
                   if k.endswith("_gap"))
