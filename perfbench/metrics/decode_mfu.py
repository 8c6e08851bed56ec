"""The span's decode steps, as a share of the card's bf16 peak: the
model FLOPs of the active slots (``yardstick.decode_flops``) over the
wall time of the ``engine.decode`` calls, each synchronised before and
after."""
from perfbench import yardstick

UNIT = "%"
SOURCE = "host_clock"


def read(run):
    if not run.decodes:
        return None
    flops = sum(yardstick.decode_flops(run.spec, d[2]) for d in run.decodes)
    wall = sum(d[1] - d[0] for d in run.decodes)
    return yardstick.share(flops / wall / yardstick.PEAK_BF16_FLOPS)
