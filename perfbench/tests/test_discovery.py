"""Every name in BENCHMARK.json finds its file, and the files hold what
the contract asks of them."""

import json

import pytest

from perfbench import harness, parts
from perfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_config_and_traffic(cell):
    bench, entry, model, traffic = harness.load_spec(ROOT, cell)
    assert entry["config"] in {c["name"] for c in bench["configs"]}
    for key in ("batch", "seq_len", "loss_every", "checked_steps",
                "warm_steps"):
        assert isinstance(traffic[key], int) and traffic[key] > 0
    assert 0 <= traffic.get("loss_lag", 0) < traffic["loss_every"]
    assert set(model["limits"]) <= {"loss_gap", "grad_norm_gap",
                                    "change_norm_gap"}
    program = parts.load("programs", model["program"])
    assert program.port_config(model).n_layers == model["num_hidden_layers"]
    reference = parts.load("reference", model["reference"])
    assert callable(reference.train_readings)
    if traffic.get("captures"):
        caps = traffic["captures"]
        assert all(a.startswith("--") for a in caps["dyno_args"])
        assert caps["last_due_before_end_s"] < caps["every_s"]


def test_parts_are_found_by_name_only():
    """A part that no file holds is refused by its name."""
    with pytest.raises(FileNotFoundError, match="no_such_model"):
        parts.load("programs", "no_such_model")
    assert parts.load("metrics", "mfu.captured").read
    assert parts.load("metrics", "mfu") is not parts.load(
        "metrics", "mfu.captured")


@pytest.mark.parametrize("name", METRICS)
def test_metric_has_a_reader(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    assert path.exists()
    assert "def read(run)" in path.read_text()


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.cell_metrics(BENCH, cell, True)
    assert layers
    assert all(m["moves"] in e2e for m in layers)


def test_reduced_keys_differ_from_the_published():
    for c in BENCH["configs"]:
        model = json.loads((ROOT / c["file"]).read_text())
        assert c["source"] == model["source"]
        for key in c["reduced"]:
            assert model[key] != model["published"][key]


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.load_spec(ROOT, "no_such.cell")
