"""Chrome trace-event validator (the gate for ``--trace-out`` files).

Twin of ``repro/obs/validate.py``.

Checks that a trace file

* parses as Chrome trace-event JSON (``{"traceEvents": [...]}`` or a
  bare event list — both loadable by Perfetto);
* has properly nested ``B``/``E`` begin/end pairs per track (an ``E``
  must close the innermost open ``B`` of the same name; leftovers are
  an error unless the tracer reported dropped events);
* pairs async ``b``/``e`` events by ``(name, id)``;
* optionally contains required categories (layers) and instant events.

Usable as a library (``validate_trace``) and as a CLI::

    python -m repro_torch.obs.validate trace.json \
        --require-cats serve,tier,fabric,cplane \
        --require-instant fabric.fail
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Sequence, Tuple


class TraceInvalid(ValueError):
    """The trace file violates the Chrome trace-event contract."""


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            raise TraceInvalid(
                "trace object lacks a 'traceEvents' event list")
    elif isinstance(doc, list):
        events = doc
    else:
        raise TraceInvalid(f"not a trace document: {type(doc).__name__}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise TraceInvalid(f"event #{i} is not a phased event: {ev!r}")
    return events


def validate_trace(path: str, require_cats: Sequence[str] = (),
                   require_instants: Sequence[str] = (),
                   allow_unbalanced: bool = False) -> dict:
    """Validate ``path``; returns summary stats or raises TraceInvalid."""
    events = load_events(path)
    stacks: Dict[Tuple[int, int], List[str]] = {}   # (pid,tid) -> names
    async_open: Dict[Tuple[str, object], int] = {}
    counts: Dict[str, int] = {}
    cats = set()
    instants = set()
    spans = 0
    for i, ev in enumerate(events):
        ph = ev["ph"]
        counts[ph] = counts.get(ph, 0) + 1
        if ph != "M":
            cats.add(ev.get("cat", ""))
        key = (ev.get("pid", 0), ev.get("tid", 0))
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise TraceInvalid(
                    f"event #{i}: 'E' with no open 'B' on track {key}")
            opened = stack.pop()
            name = ev.get("name", opened)
            if name != opened:
                raise TraceInvalid(
                    f"event #{i}: 'E' for {name!r} does not close the "
                    f"innermost 'B' ({opened!r}) on track {key} — "
                    f"begin/end pairs are not properly nested")
            spans += 1
        elif ph == "X":
            if "dur" not in ev:
                raise TraceInvalid(f"event #{i}: 'X' without 'dur'")
            spans += 1
        elif ph == "i":
            instants.add(ev.get("name", ""))
        elif ph == "b":
            k = (ev.get("name", ""), ev.get("id"))
            async_open[k] = async_open.get(k, 0) + 1
        elif ph == "e":
            k = (ev.get("name", ""), ev.get("id"))
            if async_open.get(k, 0) < 1:
                raise TraceInvalid(
                    f"event #{i}: async 'e' {k!r} without matching 'b'")
            async_open[k] -= 1
    if not allow_unbalanced:
        left = {k: v for k, v in stacks.items() if v}
        if left:
            raise TraceInvalid(f"unclosed 'B' events at EOF: {left}")
        dangling = {k: v for k, v in async_open.items() if v}
        if dangling:
            raise TraceInvalid(f"unclosed async 'b' events: {dangling}")
    missing = [c for c in require_cats if c not in cats]
    if missing:
        raise TraceInvalid(
            f"required categories absent: {missing} (present: "
            f"{sorted(c for c in cats if c)})")
    missing_i = [n for n in require_instants if n not in instants]
    if missing_i:
        raise TraceInvalid(f"required instant events absent: {missing_i} "
                           f"(present: {sorted(instants)})")
    return {"events": len(events), "spans": spans,
            "phases": counts, "cats": sorted(c for c in cats if c),
            "instants": sorted(instants)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace")
    ap.add_argument("--require-cats", default="",
                    help="comma-separated categories that must appear")
    ap.add_argument("--require-instant", action="append", default=[],
                    help="instant event name that must appear (repeatable)")
    ap.add_argument("--allow-unbalanced", action="store_true",
                    help="tolerate unclosed B/b at EOF (truncated rings)")
    args = ap.parse_args(argv)
    cats = [c for c in args.require_cats.split(",") if c]
    try:
        info = validate_trace(args.trace, require_cats=cats,
                              require_instants=args.require_instant,
                              allow_unbalanced=args.allow_unbalanced)
    except (TraceInvalid, OSError, json.JSONDecodeError) as e:
        print(f"INVALID {args.trace}: {e}", file=sys.stderr)
        return 1
    print(f"OK {args.trace}: {info['events']} events, "
          f"{info['spans']} spans, layers={info['cats']}, "
          f"instants={info['instants']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
