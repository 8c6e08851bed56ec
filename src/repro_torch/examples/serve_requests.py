"""Serving example: continuous-batched decode over a request stream.

Twin of ``examples/serve_requests.py``.  Full-width recurrentgemma-2b
(the hybrid: RG-LRU and local attention, bf16, weights from seed 0)
serves 10 requests of 12 prompt tokens and 12 new tokens through 4
slots on the card: prefill on admission, lockstep batched decode, slots
recycled as requests finish.  ``--smoke`` serves the reduced model
(``reduce_for_smoke``), as the reference does; ``--device cpu`` serves
on the CPU.

    python -m repro_torch.examples.serve_requests [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Request, ServeEngine

ARCH = "recurrentgemma-2b"


def serve(cfg, params, device, seed: int = 0) -> dict:
    """Serve the example's requests; returns outputs by request id."""
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=96,
                      device=device)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    for rid in range(10):
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab, 12,
                                               ).astype(np.int32),
                           max_new=12))
    eng.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in eng.done)
    print(f"served {len(eng.done)} requests / {toks} tokens "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s)", flush=True)
    for r in eng.done[:3]:
        print(f"  req {r.rid}: {r.out_tokens}", flush=True)
    eng.close()
    return {r.rid: list(r.out_tokens) for r in eng.done}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(ARCH)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    params = T.tree_init(T.param_defs(cfg), cfg, 0, dev)
    return serve(cfg, params, dev)


if __name__ == "__main__":
    main()
