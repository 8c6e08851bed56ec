"""The page store of an admission, in ms: each ``serve.prefill`` span of
the program less the ``engine.prefill_1`` call inside it (the pack, the
page's D2H and its cold write, and the fresh cache's zeros), averaged
over the span's admissions."""
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    spans = [s for s in run.spans if s["name"] == "serve.prefill"]
    out = []
    for s in spans:
        calls = [p for p in run.prefills
                 if p[0] >= s["t0"] and p[1] <= s["t1"]]
        if len(calls) != 1:
            return None
        out.append((s["t1"] - s["t0"]) - (calls[0][1] - calls[0][0]))
    if not out:
        return None
    return 1e3 * sum(out) / len(out)
