"""The share of the traced span in which no kernel, copy or set ran on
the card."""
from perfbench import trace_reduce

UNIT = "%"
SOURCE = "device_trace"


def read(run):
    prof = run.profile
    if prof is None or prof.window_s <= 0 or not prof.device:
        return None
    return 100.0 * (1.0 - trace_reduce.busy_s(prof) / prof.window_s)
