"""The fused install's wait a page, in ms: the program's
``serve.install`` spans (the join of each group's fetch, its staging
and the install launch) summed, over the pages they installed."""
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    spans = [s for s in run.spans if s["name"] == "serve.install"
             and s["args"].get("path") == "fused"]
    pages = sum(int(s["args"].get("slots", 0)) for s in spans)
    if not pages:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in spans) / pages
