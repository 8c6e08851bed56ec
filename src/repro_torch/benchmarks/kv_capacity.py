"""KV capacity multipliers bench: tier-boundary codecs and cross-request
prefix sharing.

Twin of ``benchmarks/kv_capacity.py``: the same three measurements, rows
and JSON keys.  Its serves run full-width qwen2-0.5b, bf16, weights from
seed 0; ``smoke`` (the CLI's ``--smoke``) reduces it with
``reduce_for_smoke``, as the reference always does.

* **codec sweep** — spill N float32 pages through a ``TieredStore`` per
  codec x access path; record logical against physical spill bytes and
  the per-page store and fetch host time.  ``int8_spill_ratio`` is the
  capacity the int8 codec buys (about 4x on float32 pages).
* **shared-prefix admission uplift** — an engine capped at 4 physical
  pages (``kv_capacity_bytes``) under an ``AdmissionController`` serves
  16 requests that share one prompt prefix; peak concurrent active slots
  with ``prefix_share`` on against off (delta pages cost a fraction of a
  page, so the same budget admits more).
* **bit-exactness** — serve tokens are equal with codec bf16 and none
  (bf16 caches encode losslessly) and with prefix sharing on and off
  (delta reconstruction is exact).  Both raise when broken.

    python -m repro_torch.benchmarks.kv_capacity [--quick|--smoke]
        [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, time_call, write_bench_json
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.rmem import TieredStore
from repro_torch.serving import AdmissionController
from repro_torch.serving.engine import Request, ServeEngine, page_bytes_for

ARCH = "qwen2-0.5b"
PAGE_ELEMS = 4096               # float32 -> 16 KiB logical pages


def _bench_codecs(paths, device, n_pages: int = 8) -> list:
    """Spill and fetch float32 pages per codec x path; the spill-byte
    ratio is the capacity multiplier the codec buys on the cold tier.
    Host wall time: every store and fetch waits on the host."""
    rng = np.random.default_rng(11)
    vals = [rng.standard_normal(PAGE_ELEMS).astype(np.float32)
            for _ in range(n_pages)]
    rows = []
    for path in paths:
        for codec in ("none", "bf16", "int8"):
            with TieredStore(n_pages, (PAGE_ELEMS,), dtype="float32",
                             n_hot_slots=n_pages, codec=codec,
                             path=path, device=device) as st:
                store_s = time_call(
                    lambda: [st.write_page(p, vals[p])
                             for p in range(n_pages)],
                    repeats=3, warmup=1)

                def fetch():
                    for p in range(n_pages):
                        st.release(p, writeback=False)
                    got = st.ensure(list(range(n_pages)))
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    return got
                st.ensure(list(range(n_pages)))
                fetch_s = time_call(fetch, repeats=3, warmup=1)
                kv = st.stats()
                ratio = kv["spill_bytes_logical"] / \
                    max(kv["spill_bytes_physical"], 1)
                emit(f"kv_codec[{path},{codec}]",
                     store_s / n_pages * 1e6,
                     f"fetch_us={fetch_s/n_pages*1e6:.1f};"
                     f"spill_ratio={ratio:.2f};"
                     f"phys_page={kv['phys_page_bytes']}")
                rows.append({
                    "path": path, "codec": codec,
                    "page_bytes": kv["page_bytes"],
                    "phys_page_bytes": kv["phys_page_bytes"],
                    "spill_bytes_logical": kv["spill_bytes_logical"],
                    "spill_bytes_physical": kv["spill_bytes_physical"],
                    "spill_ratio": ratio,
                    "store_us_per_page": store_s / n_pages * 1e6,
                    "fetch_us_per_page": fetch_s / n_pages * 1e6,
                    "projected_cold_s": kv["cold_projected_seconds"]})
    return rows


def _model(device, smoke: bool):
    cfg = get_config(ARCH)
    if smoke:
        cfg = reduce_for_smoke(cfg)
    return cfg, T.tree_init(T.param_defs(cfg), cfg, 0, device)


def _shared_requests(cfg, n: int, prompt_len: int = 12,
                     prefix_len: int = 8, max_new: int = 8):
    rng = np.random.default_rng(5)
    pfx = rng.integers(0, cfg.vocab, prefix_len).astype(np.int32)
    reqs = []
    for r in range(n):
        p = rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
        p[:prefix_len] = pfx
        reqs.append(Request(rid=r, prompt=p, max_new=max_new,
                            prefix_len=prefix_len))
    return reqs


def _peak_concurrency(cfg, params, device, share: bool,
                      capacity_pages: int = 4, slots: int = 8,
                      n_requests: int = 16) -> dict:
    """Peak concurrent active slots under a physical-byte budget: the
    admission controller refills against free cold bytes, so sharing's
    fractional page costs turn into admitted concurrency."""
    cap = capacity_pages * page_bytes_for(cfg, 64)
    eng = ServeEngine(cfg, params, batch_slots=slots, max_len=64,
                      access_path="xdma", prefix_share=share,
                      admission=AdmissionController(),
                      kv_capacity_bytes=cap, device=device)
    for req in _shared_requests(cfg, n_requests):
        eng.submit(req)
    peak = steps = 0
    while steps < 600:
        steps += 1
        active = eng.step()
        peak = max(peak, active)
        if active == 0 and eng.idle():
            break
    served = sum(1 for r in eng.done if r.failed is None)
    kv = eng.pager.stats()
    eng.close()
    return {"share": share, "peak_active": peak, "steps": steps,
            "served": served, "capacity_pages": capacity_pages,
            "shared_pages": kv["shared_pages"],
            "cow_copies": kv["cow_copies"],
            "dedup_bytes_saved": kv["dedup_bytes_saved"]}


def _serve_tokens(cfg, params, device, *, codec: str = "none",
                  share: bool = False, shared_prompts: bool = False
                  ) -> dict:
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=64,
                      access_path="xdma", kv_codec=codec,
                      prefix_share=share, device=device)
    if shared_prompts:
        reqs = _shared_requests(cfg, 4, max_new=4)
    else:
        rng = np.random.default_rng(3)
        reqs = [Request(rid=r, prompt=rng.integers(
            0, cfg.vocab, 12).astype(np.int32), max_new=4)
            for r in range(4)]
    for req in reqs:
        eng.submit(req)
    eng.run_until_drained()
    out = {r.rid: list(r.out_tokens) for r in eng.done
           if r.failed is None}
    eng.close()
    return out


def run(quick: bool = False, out: str = "", device=None,
        smoke: bool = False) -> dict:
    dev = resolve_device(device)
    paths = ["xdma"] if quick else ["xdma", "verbs"]
    codec_rows = _bench_codecs(paths, dev)
    by_codec = {r["codec"]: r for r in codec_rows if r["path"] == "xdma"}
    int8_ratio = (by_codec["none"]["spill_bytes_physical"] /
                  max(by_codec["int8"]["spill_bytes_physical"], 1))

    cfg, params = _model(dev, smoke)
    off = _peak_concurrency(cfg, params, dev, share=False)
    on = _peak_concurrency(cfg, params, dev, share=True)
    uplift = on["peak_active"] / max(off["peak_active"], 1)
    emit("kv_share_uplift", 0.0,
         f"peak_on={on['peak_active']};peak_off={off['peak_active']};"
         f"uplift={uplift:.2f}x;capacity_pages={off['capacity_pages']}")

    tok_none = _serve_tokens(cfg, params, dev, codec="none")
    tok_bf16 = _serve_tokens(cfg, params, dev, codec="bf16")
    bitexact_bf16 = tok_none == tok_bf16
    tok_noshare = _serve_tokens(cfg, params, dev, shared_prompts=True)
    tok_share = _serve_tokens(cfg, params, dev, share=True,
                              shared_prompts=True)
    bitexact_share = tok_noshare == tok_share
    emit("kv_bitexact", 0.0,
         f"bf16={bitexact_bf16};share={bitexact_share}")
    if not bitexact_bf16:
        raise AssertionError("bf16 codec changed serve tokens")
    if not bitexact_share:
        raise AssertionError("prefix sharing changed serve tokens")

    payload = {
        "arch": ARCH, "page_elems": PAGE_ELEMS,
        "codecs": codec_rows,
        "share": {"off": off, "on": on, "uplift": uplift},
        "gate": {
            "int8_spill_ratio": int8_ratio,
            "share_admit_uplift": uplift,
            "bitexact_bf16": bitexact_bf16,
            "bitexact_share": bitexact_share,
        }}
    if out:
        write_bench_json(out, payload)
    return payload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="--quick with the reduced qwen2-0.5b")
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(quick=args.quick or args.smoke, out=args.json,
               device=args.device, smoke=args.smoke)


if __name__ == "__main__":
    main()
