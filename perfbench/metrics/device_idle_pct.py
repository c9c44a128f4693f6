"""device_idle_pct: the share of the harness's own profiled steps (from
the first device record to the last) in which no kernel, copy or memset
ran on the card."""


def read(run):
    if not run.profile or not run.profile["span_s"]:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["span_s"])
