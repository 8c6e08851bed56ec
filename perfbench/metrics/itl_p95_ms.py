"""Gap between consecutive output tokens, 95th percentile over every gap
whose later token the window emitted, in ms (each token stamped at the
``step`` return that gave it)."""
from perfbench import yardstick

UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    if not run.gaps_s:
        return None
    return 1e3 * yardstick.percentile(run.gaps_s, 95)
