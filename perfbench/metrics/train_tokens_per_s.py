"""train_tokens_per_s: every token of every step the window dispatched,
over the window's host-clock seconds up to the card finishing them."""


def read(run):
    return run.tokens / run.window_s
