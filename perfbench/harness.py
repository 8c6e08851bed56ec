"""One run of one cell: set-up, the measured window, the check, the line.

``main`` reads the cell from ``BENCHMARK.json`` and the files it names,
refuses to run without the cards the cell asks for, and hands the rest
to ``run_cell``, which the CPU tests call directly on small shapes.

The system under test is ``repro_torch.serving.engine.ServeEngine``:
bf16 weights made from the seed on the card, ``batch_slots`` slots at
the mix's ``max_len``, every page through the xdma path with the fused
install, overlap on, no codec and no prefix sharing.  The harness's own
closed loop drives it through ``submit`` and ``step``: each of
``clients`` clients sends its next request once its last one is done.

Set-up: the weights, the engine, one request of the pool's longest
prompt (the largest prefill, which grows the allocator), then the
closed loop with each client's first answer cut short in steps of
``1 / clients``, until every client has finished one request, so that
the window opens on staggered slots in the middle of the traffic.  The
window opens at a step boundary and closes at the first one
``--seconds`` later.  Requests submitted inside it are the run's
attempts; the run goes on, sending nothing new, until each has its first
token.  Then the program's state is freed and the reference scores a
sample of the finished requests.

A traced run (``--trace 1``) serves the same way and profiles one span:
it opens with the window and closes at the first step boundary at which
it holds the mix's ``trace_span`` minimum of admissions (prefill calls),
fused installs (slots) and decode steps, inside the window or past it (the
loop keeps sending until it closes).  Before any metric is computed the
launch counts the profile saw are held against the kernels' own
counters and against the prefills in the span.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from perfbench import reference, trace_reduce, traffic, weights, yardstick

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SETUP_GUARD_S = 150.0       # set-up traffic that never finishes is a fault
DRAIN_GUARD_S = 60.0        # past the window, waiting for first tokens
SPAN_GUARD_S = 120.0        # a traced span that never fills is a fault


class HarnessFault(RuntimeError):
    """The harness cannot produce a sound line: exit non-zero, print none."""


# ---------------------------------------------------------------------------
# the cell, from the manifest and the files it names
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict                       # configs/<config>.json
    spec: dict                      # yardstick.model_spec(cfg)
    mix: dict                       # traffic/<mix>.json
    limits: dict                    # limits/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_of(manifest: dict, cell: str):
    """The end-to-end and per-layer metrics ``cell`` reports."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per = [m for m in manifest["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in reported)]
    return e2e, per


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise HarnessFault(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg = _json(root / conf["file"])
    e2e, per = metrics_of(manifest, name)
    return Cell(name=name, chips=int(w["chips"]), cfg=cfg,
                spec=yardstick.model_spec(cfg),
                mix=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def load_reader(metric: str):
    """``metrics/<metric>.py``: its ``UNIT`` and ``read(run)``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        raise HarnessFault(f"metric {metric}: no reader {path.name}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the port's side: its config, its parameter tree, its engine
# ---------------------------------------------------------------------------

def port_config(cell: Cell):
    """The port's ``ModelConfig`` the file names, held to the file's
    numbers: the file is the configuration as it is run."""
    from repro_torch.configs import get_config
    cfg = get_config(cell.cfg["port_arch"])
    check_port_config(cell.spec, cfg)
    return cfg


def check_port_config(s: dict, cfg) -> None:
    a = cfg.attention
    got = {"L": cfg.n_layers, "D": cfg.d_model, "H": a.n_heads,
           "KV": a.n_kv_heads, "dh": a.d_head, "V": cfg.vocab,
           "tied": cfg.tie_embeddings, "eps": cfg.norm_eps,
           "theta": a.rope_theta, "dtype": cfg.dtype, "bias": a.qkv_bias,
           "block": tuple(cfg.block_pattern)}
    want = {k: s[k] for k in ("L", "D", "H", "KV", "dh", "V", "tied",
                              "eps", "theta")}
    want.update(dtype="bfloat16", bias=True, block=("attn",))
    m = s["moe"]
    if m is None:
        got["F"], want["F"] = cfg.d_ff, s["F"]
        got["moe"], want["moe"] = cfg.moe is None, True
    else:
        pm = cfg.moe
        got.update(E=pm.n_experts, K=pm.top_k, de=pm.d_expert,
                   ds=pm.d_shared, cf=pm.capacity_factor,
                   dispatch=cfg.moe_dispatch)
        want.update(E=m["E"], K=m["K"], de=m["de"], ds=m["ds"], cf=m["cf"],
                    dispatch="global")
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise HarnessFault(f"the port's config departs from the file: "
                           f"{bad} (port, file)")


def check_param_tree(tree: dict, cfg) -> None:
    """Every leaf the benchmark made has the port's shape, in the
    port's order."""
    from repro_torch.interop import tree_flatten
    from repro_torch.models import transformer as T
    mine = [tuple(v.shape) for _, v in weights.flat(tree)]
    port = [tuple(d.shape) for d in tree_flatten(T.param_defs(cfg))[0]]
    if mine != port:
        raise HarnessFault(f"weight tree departs from the port's: "
                           f"{mine} != {port}")


def make_engine(cfg, params, mix: dict, device):
    from repro_torch.serving.engine import ServeEngine
    e = mix["engine"]
    return ServeEngine(cfg, params, batch_slots=int(mix["slots"]),
                       max_len=int(mix["max_len"]),
                       access_path=e["access_path"],
                       fused_install=bool(e["fused_install"]),
                       overlap=bool(e["overlap"]), kv_codec=e["kv_codec"],
                       prefix_share=bool(e["prefix_share"]), device=device)


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------

@dataclass
class Rec:
    rid: int
    client: int
    phase: str                  # longest | setup | window | after
    P: int
    A: int
    t_submit: float
    req: object
    times: List[float] = field(default_factory=list)
    done: bool = False
    failed: Optional[str] = None
    t_done: float = 0.0


class Loop:
    """Drives the engine: submits, steps, and stamps every token with the
    host time at which ``step`` returned it."""

    def __init__(self, engine, clients: int,
                 clock: Callable[[], float] = time.perf_counter):
        self.engine = engine
        self.clock = clock
        self.recs: Dict[int, Rec] = {}
        self.holding: List[Optional[int]] = [None] * clients
        self._rid = 0
        self._seen = 0
        self.phase = "setup"

    def submit(self, client: int, draw: traffic.Draw) -> Rec:
        from repro_torch.serving.engine import Request
        rid = self._rid
        self._rid += 1
        req = Request(rid=rid, prompt=draw.prompt, max_new=int(draw.answer))
        t = self.clock()
        self.engine.submit(req)
        rec = Rec(rid, client, self.phase, len(draw.prompt), draw.answer, t,
                  req)
        self.recs[rid] = rec
        self.holding[client] = rid
        return rec

    def free_clients(self) -> List[int]:
        return [c for c, r in enumerate(self.holding) if r is None]

    def step(self) -> float:
        self.engine.step()
        t = self.clock()
        for rid in self.holding:
            if rid is None:
                continue
            rec = self.recs[rid]
            n = len(rec.req.out_tokens or ())
            if n > len(rec.times):
                rec.times.extend([t] * (n - len(rec.times)))
        done = self.engine.done
        for req in done[self._seen:]:
            rec = self.recs[req.rid]
            rec.done, rec.failed, rec.t_done = True, req.failed, t
            self.holding[rec.client] = None
        self._seen = len(done)
        return t


class LogitTap:
    """The program's logit of each token it served, read where its model
    calls return their logits: one row-wise max a call (the greedy
    token's logit), left on the device until the run is over, keyed by
    the request and the token's index."""

    def __init__(self, engine):
        self.pending: List[tuple] = []
        cur: List[object] = [None]
        start, prefill, decode = (engine._start_request, engine.prefill_1,
                                  engine.decode)

        def start_request(s, req):
            cur[0] = req
            try:
                return start(s, req)
            finally:
                cur[0] = None

        def tapped_prefill(params, batch, caches):
            caches, logits = prefill(params, batch, caches)
            self.pending.append(([(0, cur[0].rid, 0)],
                                 logits.max(dim=-1).values))
            return caches, logits

        def tapped_decode(params, batch, caches):
            keys = [(s, r.rid, len(r.out_tokens))
                    for s, r in enumerate(engine.slot_req) if r is not None]
            caches, logits = decode(params, batch, caches)
            self.pending.append((keys, logits.max(dim=-1).values))
            return caches, logits

        engine._start_request = start_request
        engine.prefill_1, engine.decode = tapped_prefill, tapped_decode

    def values(self) -> Dict[tuple, float]:
        """(rid, token index) -> the program's logit of that token."""
        if not self.pending:
            return {}
        import torch
        flat = torch.cat([t.float().reshape(-1) for _, t in self.pending])
        flat = flat.cpu().tolist()
        out, off = {}, 0
        for keys, t in self.pending:
            for s, rid, i in keys:
                out[(rid, i)] = flat[off + s]
            off += t.numel()
        return out


# ---------------------------------------------------------------------------
# the traced span
# ---------------------------------------------------------------------------

class Span:
    """The profiled span of a traced run: the profiler records the
    card's kernels, copies and sets (CUDA activity only; the host's
    operators are not recorded, which keeps a span's trace a few hundred
    thousand events), and the harness's wrappers time the engine's model
    calls (each synchronised before and after, so that its wall time is
    the call's own) and label its admission, page store, install and
    step on the host, in the profiler's clock (Unix nanoseconds)."""

    def __init__(self, engine, mix: dict, device, clock):
        self.engine = engine
        self.need = dict(mix["trace_span"])
        self.device = device
        self.clock = clock
        self.prefills: List[tuple] = []      # (t0, t1, P, flash plans)
        self.decodes: List[tuple] = []       # (t0, t1, rows)
        self.host: List[trace_reduce.HostEvent] = []
        self.is_open = False
        self.closed = False
        self.t_open = self.t_close = 0.0
        self.ns_open = self.ns_close = 0
        self.prof = None
        self._tracer = None
        self.counters0: Dict[str, int] = {}
        self.counters: Dict[str, int] = {}
        self.spans: List[dict] = []
        self.profile: Optional[trace_reduce.Profile] = None
        self.install_page_bytes = 0

    def _sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.current_stream(self.device).synchronize()

    @staticmethod
    def counter_values(engine) -> Dict[str, int]:
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import page_install as pi
        return {"flash": fa.flash_attention.launches,
                "install": pi.install_pages.launches,
                "installed": engine.install_fused}

    def _labelled(self, name, fn):
        def call(*a, **k):
            ns = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                self.host.append(trace_reduce.HostEvent(
                    name, ns, time.time_ns()))
        return call

    def _wrap(self):
        from repro_torch.kernels import flash_attention as fa
        eng = self.engine
        L = eng.cfg.n_layers
        prefill, decode = eng.prefill_1, eng.decode

        def timed_prefill(params, batch, caches):
            P = int(batch["tokens"].shape[1])
            self._sync()
            t0 = self.clock()
            out = prefill(params, batch, caches)
            self._sync()
            t1 = self.clock()
            plans = len(fa.launch_plans(P, True, None)) \
                if self.device.type == "cuda" else 0
            self.prefills.append((t0, t1, P, L * plans))
            return out

        def timed_decode(params, batch, caches):
            rows = [int(eng.slot_pos[s]) + 1 for s in range(eng.B)
                    if eng.slot_req[s] is not None]
            self._sync()
            t0 = self.clock()
            out = decode(params, batch, caches)
            self._sync()
            t1 = self.clock()
            self.decodes.append((t0, t1, rows))
            return out

        self._orig = (prefill, decode)
        eng.prefill_1 = self._labelled("engine.prefill_1", timed_prefill)
        eng.decode = self._labelled("engine.decode", timed_decode)
        for name in ("_page_store", "_install_ready", "_admit", "step"):
            setattr(eng, name, self._labelled("engine." + name.lstrip("_"),
                                              getattr(eng, name)))

    def _unwrap(self):
        eng = self.engine
        eng.prefill_1, eng.decode = self._orig
        for name in ("_page_store", "_install_ready", "_admit", "step"):
            eng.__dict__.pop(name, None)

    @staticmethod
    def page_kernel_bytes(engine) -> int:
        """The bytes a page gives the install kernel, by the program's own
        page layout: the leaves the kernel writes (``install_rows``)."""
        return sum(sp.nbytes for sp in engine._layout.install_rows)

    def open(self):
        import torch
        from repro_torch import obs
        self._wrap()
        self.install_page_bytes = self.page_kernel_bytes(self.engine)
        self.counters0 = self.counter_values(self.engine)
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[
            act.CUDA if self.device.type == "cuda" else act.CPU])
        self.prof.start()
        self.ns_open = time.time_ns()
        self._tracer = obs.trace.enable(limit=1 << 20)
        self.is_open = True
        self.t_open = self.clock()

    def full(self) -> bool:
        c = self.counter_values(self.engine)
        return (len(self.prefills) >= self.need["admissions"]
                and c["installed"] - self.counters0["installed"]
                >= self.need["installs"]
                and len(self.decodes) >= self.need["decode_steps"])

    def close(self):
        from repro_torch import obs
        self.t_close = self.clock()
        self.counters = {k: v - self.counters0[k] for k, v in
                         self.counter_values(self.engine).items()}
        tracer = self._tracer
        obs.trace.disable()
        self._sync()
        self.ns_close = time.time_ns()
        self.prof.stop()
        self._unwrap()
        self.is_open, self.closed = False, True
        self.spans = trace_reduce.paired_spans(
            tracer.chrome_trace()["traceEvents"], tracer.epoch,
            ("serve.prefill", "serve.install"))

    def reduce(self):
        t0 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        self.profile = trace_reduce.from_kineto(
            events, self.ns_open, self.ns_close, self.host)
        self.prof = None
        p = self.profile
        print(f"perfbench: trace of {len(events)} events: "
              f"{len(p.device)} device ops in a span of {p.window_s:.3f} s, "
              f"{len(p.host)} host labels; counters {self.counters}; "
              f"reduced in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)


def check_launches(run) -> None:
    """The profile's kernels against the wrappers' counters and the
    prefills in the span, and the page the layout gives the install
    kernel against the configuration's; a mismatch is the harness's
    fault."""
    prof = run.profile
    flash = len(trace_reduce.kernels_named(prof, trace_reduce.FLASH_KERNELS))
    inst = len(trace_reduce.kernels_named(prof,
                                          (trace_reduce.INSTALL_KERNEL,)))
    want_flash = sum(p[3] for p in run.prefills)
    prefill_spans = [s for s in run.spans if s["name"] == "serve.prefill"]
    fused = [s for s in run.spans if s["name"] == "serve.install"
             and s["args"].get("path") == "fused"]
    problems = []
    if flash != run.counters["flash"]:
        problems.append(f"flash: {flash} in the profile, "
                        f"{run.counters['flash']} counted")
    if run.counters["flash"] != want_flash:
        problems.append(f"flash: {run.counters['flash']} counted, "
                        f"{want_flash} for the span's "
                        f"{len(run.prefills)} prefills")
    if inst != run.counters["install"]:
        problems.append(f"install: {inst} in the profile, "
                        f"{run.counters['install']} counted")
    if len(prefill_spans) != len(run.prefills):
        problems.append(f"prefill: {len(prefill_spans)} serve.prefill "
                        f"spans, {len(run.prefills)} calls")
    slots = sum(int(s["args"].get("slots", 0)) for s in fused)
    if slots != run.counters["installed"]:
        problems.append(f"install: {slots} slots in serve.install spans, "
                        f"{run.counters['installed']} counted")
    whole = yardstick.page_bytes(run.spec, int(run.mix["max_len"]))
    if not 0 < run.install_page_bytes <= whole:
        problems.append(f"install: the layout gives the kernel "
                        f"{run.install_page_bytes} B a page, the "
                        f"configuration's whole page is {whole} B")
    if problems:
        raise HarnessFault("launch counts disagree: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

@dataclass
class RunView:
    """What the metric readers read."""
    spec: dict
    mix: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    ttft_s: List[float] = field(default_factory=list)
    gaps_s: List[float] = field(default_factory=list)
    tokens: int = 0
    prefills: List[tuple] = field(default_factory=list)
    decodes: List[tuple] = field(default_factory=list)
    spans: List[dict] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    install_page_bytes: int = 0
    profile: Optional[trace_reduce.Profile] = None


@dataclass
class Outcome:
    view: RunView
    attempted: int
    failed: int
    failed_all: int
    samples: List[dict]
    memory_peak: int
    span: Optional[Span]
    params: Optional[dict]


def _sample(loop: Loop, t_open: float, mix: dict, seed: int,
            logits: Dict[tuple, float]) -> List[dict]:
    """The finished requests the check scores: the one with the longest
    prompt and answer, then others in an order drawn from the seed,
    until the served tokens reach the mix's ``check.min_tokens`` and the
    count its ``check.min_requests``, or the count its
    ``check.max_requests``."""
    done = [r for r in loop.recs.values() if r.done and r.failed is None
            and r.phase != "longest" and r.t_done > t_open]
    if not done:
        return []
    done.sort(key=lambda r: r.rid)
    first = max(done, key=lambda r: (r.P + r.A, -r.rid))
    rest = [r for r in done if r is not first]
    rng = np.random.default_rng([int(seed) % (1 << 64), 3])
    order = [first] + [rest[i] for i in rng.permutation(len(rest))]
    out, tokens = [], 0
    chk = mix["check"]
    for r in order:
        if (tokens >= chk["min_tokens"]
                and len(out) >= chk.get("min_requests", 1)) or \
                len(out) >= chk["max_requests"]:
            break
        toks = list(r.req.out_tokens)
        out.append({"rid": r.rid, "prompt": np.asarray(r.req.prompt),
                     "tokens": toks,
                     "logits": [logits[(r.rid, i)] for i in range(len(toks))]})
        tokens += len(r.req.out_tokens)
    return out


def serve(cell: Cell, seed: int, seconds: float, trace: bool, device,
          port_cfg=None, tamper=None, t_process: Optional[float] = None,
          clock: Callable[[], float] = time.perf_counter) -> Outcome:
    """Set up, run the window (and the traced span), drain first tokens,
    sample; the program's state is freed before returning."""
    import torch
    t0 = clock() if t_process is None else t_process
    marks = [("start", clock())]
    dev = torch.device(device)
    cfg = port_cfg if port_cfg is not None else port_config(cell)
    params = weights.make(cell.spec, seed, dev)
    check_param_tree(params, cfg)
    marks.append(("weights", clock()))
    engine = make_engine(cfg, params, cell.mix, dev)
    marks.append(("engine", clock()))
    if tamper is not None:
        tamper(engine)
    tap = LogitTap(engine)
    stream = traffic.Stream(cell.mix, seed, cell.spec["V"])
    clients = int(cell.mix["clients"])
    loop = Loop(engine, clients, clock)
    if trace:
        _warm_profiler(dev)

    # set-up: the longest prefill, then staggered slots
    loop.phase = "longest"
    loop.submit(0, stream.longest())
    guard = clock() + SETUP_GUARD_S
    while loop.holding[0] is not None:
        loop.step()
        if clock() > guard:
            raise HarnessFault("set-up: the longest request never finished")
    marks.append(("longest request", clock()))
    loop.phase = "setup"
    finished = set()
    for c in range(clients):
        loop.submit(c, traffic.staggered(stream.next(), c, clients,
                                         int(cell.mix["setup_answer_max"])))
    while len(finished) < clients:
        loop.step()
        for c in loop.free_clients():
            finished.add(c)
            loop.submit(c, stream.next())
        if clock() > guard:
            raise HarnessFault("set-up: the staggered requests never "
                               "finished")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("staggered traffic", clock()))
    print("perfbench: set-up " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in
        zip(marks, marks[1:])) + f" (before these {marks[0][1] - t0:.3f} s)",
        file=sys.stderr)

    # the window, and the traced span from its start
    span = Span(engine, cell.mix, dev, clock) if trace else None
    if span is not None:
        span.open()
    loop.phase = "window"
    t_open = clock()
    setup_s = t_open - t0
    t_close = None
    while True:
        now = clock()
        if t_close is None and now - t_open >= seconds:
            t_close = now
            loop.phase = "after"
        span_open = span is not None and span.is_open
        if t_close is not None and not span_open:
            break
        if span_open and now - span.t_open > SPAN_GUARD_S:
            raise HarnessFault(f"traced span: after {SPAN_GUARD_S} s it "
                               f"holds {len(span.prefills)} admissions, "
                               f"{len(span.decodes)} decode steps")
        for c in loop.free_clients():
            loop.submit(c, stream.next())
        loop.step()
        if span is not None and span.is_open and span.full():
            span.close()

    # past the window, sending nothing: every attempt gets its first
    # token, and enough requests finish for the check's sample
    window = [r for r in loop.recs.values() if r.phase == "window"]
    chk = cell.mix["check"]

    def checkable() -> bool:
        done = [r for r in loop.recs.values() if r.done and r.failed is None
                and r.phase != "longest" and r.t_done > t_open]
        return (sum(r.A for r in done) >= chk["min_tokens"]
                and len(done) >= chk.get("min_requests", 1))

    guard = clock() + DRAIN_GUARD_S
    while (any(not r.times and not r.done for r in window)
           or not checkable()) and any(h is not None for h in loop.holding) \
            and clock() < guard:
        loop.step()
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    samples = _sample(loop, t_open, cell.mix, seed, tap.values())
    view = RunView(spec=cell.spec, mix=cell.mix, setup_s=setup_s,
                   window_s=t_close - t_open)
    for r in window:
        if r.failed is None and r.times:
            view.ttft_s.append(r.times[0] - r.t_submit)
        else:
            view.ttft_s.append(math.inf)
    for r in loop.recs.values():
        for i, t in enumerate(r.times):
            if t_open < t <= t_close:
                view.tokens += 1
                if i > 0:
                    view.gaps_s.append(t - r.times[i - 1])
    print(f"perfbench: first-token times of the window's {len(window)} "
          f"requests, ms: " + " ".join(
              f"{1e3 * t:.1f}" for t in view.ttft_s), file=sys.stderr)
    failed = sum(1 for r in window if r.failed is not None or not r.times)
    failed_all = sum(1 for r in loop.recs.values() if r.failed is not None)
    engine.close()
    del engine, loop, tap
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    if span is not None:
        span.reduce()
        view.prefills, view.decodes = span.prefills, span.decodes
        view.spans, view.counters = span.spans, span.counters
        view.install_page_bytes = span.install_page_bytes
        view.profile = span.profile
    return Outcome(view=view, attempted=len(window), failed=failed,
                   failed_all=failed_all, samples=samples,
                   memory_peak=memory_peak, span=span,
                   params=params)


def _warm_profiler(dev) -> None:
    """Start and stop the profiler once in set-up, so that its first
    start (CUPTI's) is not paid inside the window."""
    import torch
    act = torch.profiler.ProfilerActivity
    a = torch.ones(256, 256, device=dev)
    with torch.profiler.profile(activities=[
            act.CUDA if dev.type == "cuda" else act.CPU]):
        (a @ a).sum().item()


def check(cell: Cell, out: Outcome) -> Dict[str, dict]:
    """The numbers ``correct`` compares for the program's served tokens,
    each with its limit (``judge``)."""
    ref = reference.logits(cell.spec, out.params, out.samples)
    return judge(cell, ref, out.samples, out.failed_all)


def judge(cell: Cell, ref, samples: List[dict],
          failed: int) -> Dict[str, dict]:
    """The numbers ``correct`` compares, each with its limit: the
    samples' tokens and logits (the program's, or the control's in its
    place) against the reference's logits ``ref`` over the same
    sequences.  A number whose limit file gives no limit (no control
    reading three times its program reading) is not compared."""
    lim = cell.limits
    values = {
        "max_logit_gap": reference.widest(
            reference.served_gaps(ref, samples)),
        "mean_logit_error": reference.logit_error(ref, samples),
        "failed_requests": failed,
    }
    checks = {k: {"value": v, "limit": lim[k]["limit"]}
              for k, v in values.items() if lim[k]["limit"] is not None}
    checks["served_tokens_checked"] = {
        "value": sum(len(s["tokens"]) for s in samples),
        "limit": cell.mix["check"]["min_tokens"]}
    return checks


def is_correct(checks: Dict[str, dict]) -> bool:
    """Every number at or under its limit; the served tokens checked at
    or over theirs."""
    n = checks["served_tokens_checked"]
    return n["value"] >= n["limit"] and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for k, c in checks.items() if k != "served_tokens_checked")


def compute_metrics(metrics: List[dict], view: RunView) -> Dict[str, dict]:
    """Each declared metric through its reader; one that finds nothing
    to read is the harness's fault."""
    out = {}
    for m in metrics:
        mod = load_reader(m["name"])
        if mod.UNIT != m["unit"]:
            raise HarnessFault(f"metric {m['name']}: reader unit "
                               f"{mod.UNIT!r} != manifest {m['unit']!r}")
        v = mod.read(view)
        if v is None or not math.isfinite(v):
            raise HarnessFault(f"metric {m['name']}: nothing to read "
                               f"(got {v})")
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(cell: Cell, out: Outcome, trace: bool, checks: dict,
                device_name: str) -> dict:
    view = out.view
    metrics = compute_metrics(cell.per_layer if trace else cell.end_to_end,
                              view)
    dev = {"platform": "gpu", "kind": device_name, "count": cell.chips,
           "memory_peak_bytes": out.memory_peak}
    line = {"correct": is_correct(checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = trace_reduce.busy_s(view.profile)
        dev["window_s"] = view.profile.window_s
        line["breakdown"] = {
            "device_ops": trace_reduce.top_device_ops(view.profile),
            "idle_gaps": trace_reduce.top_idle_gaps(view.profile)}
    line["checks"] = checks
    return line


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", port_cfg=None, tamper=None,
             t_process: Optional[float] = None,
             device_name: str = "cpu") -> dict:
    """Serve, check, and build the result line (no chip check here)."""
    out = serve(cell, seed, seconds, trace, device, port_cfg=port_cfg,
                tamper=tamper, t_process=t_process)
    if trace:
        check_launches(out.view)
    checks = check(cell, out)
    out.params = None
    return result_line(cell, out, trace, checks, device_name)


def power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None, t_process: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
                  f"device(s), found {n}", file=sys.stderr)
            return 4
        print(f"perfbench: card {power_line()}", file=sys.stderr)
        torch.set_num_threads(4)
        line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", t_process=t_process,
                        device_name=torch.cuda.get_device_name(0))
    except HarnessFault as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad} (JAX or its "
              f"package); no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in line["checks"].items():
        print(f"check {name} value={c['value']} limit={c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
