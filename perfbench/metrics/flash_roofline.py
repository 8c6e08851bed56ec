"""The flash kernel's share of its roofline over the span: each
prefill's least time, its layers' ``yardstick.flash_bound_s``, summed,
over the device time of every flash launch the profile saw."""
from perfbench import trace_reduce, yardstick

UNIT = "%"
SOURCE = "device_trace"


def read(run):
    ops = trace_reduce.kernels_named(run.profile, trace_reduce.FLASH_KERNELS)
    if not ops or not run.prefills:
        return None
    bound = sum(run.spec["L"] * yardstick.flash_bound_s(run.spec, p[2])
                for p in run.prefills)
    return yardstick.share(bound / (sum(o.end - o.start for o in ops) * 1e-9))
