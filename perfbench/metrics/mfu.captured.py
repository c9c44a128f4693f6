"""mfu.captured: mfu in a window under captures at the traffic's rate."""

from perfbench import counts


def read(run):
    flops = counts.train_flops_per_token(run.model, run.traffic["seq_len"])
    return 100.0 * run.tokens * flops / run.window_s / counts.PEAK_BF16_FLOPS
