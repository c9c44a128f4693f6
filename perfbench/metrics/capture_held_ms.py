"""capture_held_ms: the time the job's training thread sat parked in the
shim's step() for a capture's edges (its shim.step_held spans, summed),
averaged over the captures whose manifests list the phases' spans
(shim.profiler_start): a capture that held no step reads 0."""

from perfbench import spans


def read(run):
    return spans.mean_ms(run, "shim.step_held", among="shim.profiler_start")
