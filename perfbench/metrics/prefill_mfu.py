"""The span's prefills, as a share of the card's bf16 peak: the model
FLOPs of each prompt (``yardstick.prefill_flops``) over the wall time
of the ``engine.prefill_1`` calls, each synchronised before and after."""
from perfbench import yardstick

UNIT = "%"
SOURCE = "host_clock"


def read(run):
    if not run.prefills:
        return None
    flops = sum(yardstick.prefill_flops(run.spec, p[2]) for p in run.prefills)
    wall = sum(p[1] - p[0] for p in run.prefills)
    return yardstick.share(flops / wall / yardstick.PEAK_BF16_FLOPS)
