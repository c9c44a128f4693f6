"""step_ms_p95: the 95th percentile (nearest rank) of every step's time in
the window, between consecutive CUDA events recorded on the stream after
each step, so a step the host starved reads long."""

import math


def read(run):
    if not run.step_ms:
        return None
    ranked = sorted(run.step_ms)
    return ranked[math.ceil(0.95 * len(ranked)) - 1]
