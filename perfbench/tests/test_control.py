"""The control, the reference in float8 products put in the program's
place, fails the limits that the program passes, at a size a test run
holds (the CPU). On the card, `calibrate.py` reads both at a cell's own
size."""

import pytest

from perfbench import calibrate, check, harness
from perfbench.tests import tiny


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_where_the_program_passes(seed):
    _, model, traffic = tiny.spec("deepseek_llm_7b.attached")
    ref = harness.reference_readings(model, traffic, seed, "cpu")
    prog = check.training_numbers(
        calibrate.program(model, traffic, seed, "cpu"), ref)
    ctrl = check.training_numbers(
        harness.reference_readings(model, traffic, seed, "cpu", "fp8"), ref)
    keys = ("loss_gap", "grad_norm_gap", "change_norm_gap")
    assert all(prog[k] <= tiny.LIMITS[k] for k in keys), prog
    assert any(ctrl[k] > tiny.LIMITS[k] for k in keys), ctrl
