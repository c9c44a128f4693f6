"""capture_cost_ms: the device time each capture added to the job: the sum
of every step's time in the window, less as many steps at the median time
of the steps that overlap no capture, over the captures. Steps are placed
on the host's clock from the window's first event; a capture spans its
request to the end of its export (manifest timing). The traffic asks for
no capture so late that its stop and export would fall after the window,
so every capture's cost lies in the steps counted."""

import statistics


def _spans(run):
    out = []
    for c in run.captures:
        m = c["manifest"]
        if not m:
            continue
        t = m.get("timing", {})
        end = (m["started_ms"] + t.get("window_ms", 0)
               + t.get("profiler_stop_ms", 0) + t.get("export_ms", 0))
        out.append((c["fired"]["fired"] * 1e3, end))
    return out


def read(run):
    if not run.captures or not run.step_ms:
        return None
    spans = _spans(run)
    end, clean = run.t0 * 1e3, []
    for ms in run.step_ms:
        begin, end = end, end + ms
        if not any(a < end and b > begin for a, b in spans):
            clean.append(ms)
    if not clean:
        return None
    extra = sum(run.step_ms) - len(run.step_ms) * statistics.median(clean)
    return extra / len(run.captures)
