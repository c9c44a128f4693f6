"""A tiny configuration and traffic of the benchmark's own cells, for CPU
runs of the harness."""

from perfbench import harness
from perfbench.tests.conftest import ROOT

# Readings of this size on the CPU (seeds 1-2): the program 1.3e-5 /
# 1.5e-3 / 8.7e-4, the float8 control 2.7e-4 / 6.8e-3 / 5.4e-3 at least.
LIMITS = {"loss_gap": 1e-4, "grad_norm_gap": 4e-3, "change_norm_gap": 3e-3}


def spec(workload: str, **captures):
    """The cell's configuration and traffic at the tiny size; `captures`
    overrides keys of the traffic's captures."""
    bench, _, model, traffic = harness.load_spec(ROOT, workload)
    model = dict(model, hidden_size=64, intermediate_size=128,
                 num_attention_heads=4, num_key_value_heads=4,
                 num_hidden_layers=2, vocab_size=256,
                 max_position_embeddings=64, limits=LIMITS)
    traffic = dict(traffic, seq_len=64, warm_steps=1)
    if traffic.get("captures"):
        traffic["captures"] = dict(
            traffic["captures"], every_s=1.5, first_after_s=0.3,
            last_due_before_end_s=0.5, **{
                "dyno_args": ["--duration_ms=300"], **captures})
    return bench, model, traffic


def run(workload: str, seconds: float = 4.0, trace: bool = False,
        seed: int = 2**31 + 7, **captures) -> dict:
    bench, model, traffic = spec(workload, **captures)
    return harness.run_spec(ROOT, bench, workload, model, traffic, seed,
                            seconds, trace, "cpu")
