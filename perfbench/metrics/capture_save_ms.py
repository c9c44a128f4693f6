"""capture_save_ms: the mean length of a capture's shim.export span, the
save in the job's process (kineto's export_chrome_trace, shim.kineto_save,
and the session's release, shim.free_session, with the finish handed to
its own thread), over the captures whose manifests list one."""

from perfbench import spans


def read(run):
    return spans.mean_ms(run, "shim.export")
