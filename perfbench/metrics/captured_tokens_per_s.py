"""captured_tokens_per_s: as train_tokens_per_s, in a window in which
operators request captures at the traffic's fixed rate."""


def read(run):
    return run.tokens / run.window_s
