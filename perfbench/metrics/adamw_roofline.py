"""adamw_roofline: the bytes one AdamW step must move (read p, g and both
moments, write p and both moments, each leaf at its element size) over
the device time of the kernels launched under optimizer.step in the
captures' traces, against the card's memory rate."""

from perfbench import counts


def read(run):
    per_step = counts.adamw_bytes(run.leaf_sizes)
    nbytes = seconds = 0.0
    for c in run.captures:
        for inst in (c.get("trace") or {}).get("adamw", ()):
            nbytes += per_step
            seconds += inst["seconds"]
    if not seconds:
        return None
    return counts.roofline_pct(0.0, nbytes, seconds)
