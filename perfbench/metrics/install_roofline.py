"""The page install kernel's share of its roofline over the span: the
bytes each installed page gives the kernel, by the program's own page
layout (held to at most the configuration's page by the harness), read
once and written once at the HBM peak (``yardstick.install_bound_s``),
over the device time of every ``install_pages_kernel`` launch the
profile saw."""
from perfbench import trace_reduce, yardstick

UNIT = "%"
SOURCE = "device_trace"


def read(run):
    ops = trace_reduce.kernels_named(run.profile,
                                     (trace_reduce.INSTALL_KERNEL,))
    pages = run.counters.get("installed", 0)
    if not ops or not pages or not run.install_page_bytes:
        return None
    bound = yardstick.install_bound_s(run.install_page_bytes, pages)
    return yardstick.share(bound / (sum(o.end - o.start for o in ops) * 1e-9))
