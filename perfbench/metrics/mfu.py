"""mfu: the window's model operations (6 per matrix parameter and token,
plus the causal attention products, no recompute) per second, as a share
of one H100's bf16 peak."""

from perfbench import counts


def read(run):
    flops = counts.train_flops_per_token(run.model, run.traffic["seq_len"])
    return 100.0 * run.tokens * flops / run.window_s / counts.PEAK_BF16_FLOPS
