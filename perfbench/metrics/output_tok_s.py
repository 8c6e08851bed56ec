"""Output tokens the window emitted, over the window's seconds."""
UNIT = "tokens/s"
SOURCE = "host_clock"


def read(run):
    if run.window_s <= 0 or run.tokens == 0:
        return None
    return run.tokens / run.window_s
