"""setup_s: seconds from the process's start to the first timed step:
imports, builds found in the checkout's caches, dynologd's start, the
weights made on the card, the checked and warm steps and the shim's
profiler warmup (host clock)."""


def read(run):
    return run.setup_s
