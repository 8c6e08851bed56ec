"""Seconds from process start to the window's start: imports, the
weights made on the card, the engine, the kernels loaded (built, on a
checkout's first run), and the set-up traffic."""
UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s if run.setup_s > 0 else None
