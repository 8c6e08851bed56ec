"""The readings a cell's correctness limits are set from, on the card.

    python perfbench/control.py --workload <cell> --seconds <s> \
        --seeds <a,b,...> --control-seeds <x,y,...>

For each seed it serves the cell as a run does (the same set-up, the
same load, a window of ``--seconds``), samples the finished requests as
a run does, and prints one JSON line: the program's readings under the
float32 reference (the lower readings), and the harness's own judgement
of them, ``checks`` and ``correct``.  For the control seeds it puts the
float8 control in the program's place: at each position of the same
sequences the token the control puts first and its logit of it
(``reference.control_samples``), judged by the same ``harness.judge``
and ``harness.is_correct`` (the upper readings, and ``control_correct``,
which has to come out false).  One process serves every seed, so the
kernels load once.  The benchmark's own runs never run this.
"""
import gc
import json
import sys
import time

import run  # noqa: F401  (the checkout's paths and caches, as a run sets them)


def readings(ref, samples) -> dict:
    """Both numbers, compared or not: the widest gap and the mean logit
    error."""
    from perfbench import reference
    return {"max_logit_gap": reference.widest(
                reference.served_gaps(ref, samples)),
            "mean_logit_error": reference.logit_error(ref, samples)}


def main(argv=None) -> int:
    import argparse
    import torch
    from perfbench import harness, reference
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    cell = harness.load_cell(args.workload)
    torch.set_num_threads(4)
    print(f"control: card {harness.power_line()}", file=sys.stderr)
    for seed in seeds:
        out = harness.serve(cell, seed, args.seconds, False, "cuda")
        t0 = time.perf_counter()
        ref = reference.logits(cell.spec, out.params, out.samples)
        checks = harness.judge(cell, ref, out.samples, out.failed_all)
        rec = {"workload": cell.name, "seed": seed,
               "readings": readings(ref, out.samples),
               "checks": checks, "correct": harness.is_correct(checks),
               "per_request": reference.served_gaps(ref, out.samples),
               "prompts": [len(s["prompt"]) for s in out.samples],
               "failed": out.failed_all,
               "reference_s": time.perf_counter() - t0}
        if seed in controls:
            t0 = time.perf_counter()
            ctl = reference.control_samples(
                reference.logits(cell.spec, out.params, out.samples,
                                 fp8=True), out.samples)
            cchecks = harness.judge(cell, ref, ctl, 0)
            rec.update(control_readings=readings(ref, ctl),
                       control_checks=cchecks,
                       control_correct=harness.is_correct(cchecks),
                       control_s=time.perf_counter() - t0)
            del ctl
        print(json.dumps(rec), flush=True)
        del out, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    run._environment()
    sys.exit(main())
