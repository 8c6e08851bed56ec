"""Time to first token, median (nearest rank) over every request
submitted in the window (a failed request counts as missing), in ms:
from its submission to the ``step`` return that gave its first token,
as the harness sees it.  The median, as a window holds some 30 requests
of the MoE's long documents, too few for a tail that repeats."""
from perfbench import yardstick

UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    if not run.ttft_s:
        return None
    return 1e3 * yardstick.percentile(run.ttft_s, 50)
