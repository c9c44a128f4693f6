"""capture_stop_ms: the mean length of a capture's shim.profiler_stop span,
torch's _disable_profiler on the shim's poll thread (ROADMAP C16), over the
captures whose manifests list one."""

from perfbench import spans


def read(run):
    return spans.mean_ms(run, "shim.profiler_stop")
