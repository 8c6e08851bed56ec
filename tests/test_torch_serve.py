"""The port's serving path against the reference's: the same float32
params and prompts give the same greedy tokens, with KV paging over xdma
(fused install on and off, overlap on and off) and without paging; and
the capacity multipliers (page codecs, prefix sharing, a byte budget)
within the port and against the reference's ``serve.main``."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

N_REQ, MAX_NEW, SLOTS, MAX_LEN = 6, 8, 4, 64


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    pcfg = dataclasses.replace(port_reduce(port_config("qwen2-0.5b")),
                               dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(1))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(7)
    # staggered lengths: slots finish and refill at different steps
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(5, 20, size=N_REQ)]
    return cfg, pcfg, params, pparams, prompts


def _run(engine, request_cls, prompts):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=p, max_new=MAX_NEW))
    assert engine.run_until_drained() == 0
    if engine.pager is not None:
        engine.pager.close()
    return {r.rid: list(r.out_tokens) for r in engine.done}


@pytest.fixture(scope="module")
def reference_outputs(setup):
    cfg, _, params, _, prompts = setup
    return _run(RefEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                          access_path="xdma"), RefRequest, prompts)


def _port(setup, **kw):
    _, pcfg, _, pparams, prompts = setup
    eng = ServeEngine(pcfg, pparams, batch_slots=SLOTS, max_len=MAX_LEN,
                      device="cpu", **kw)
    return eng, _run(eng, Request, prompts)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("overlap", [True, False])
def test_paged_outputs_match_reference(setup, reference_outputs, fused,
                                       overlap):
    eng, outs = _port(setup, access_path="xdma", fused_install=fused,
                      overlap=overlap)
    assert outs == reference_outputs
    assert len(outs) == N_REQ and all(len(v) == MAX_NEW
                                      for v in outs.values())
    if fused:
        assert (eng.install_fused, eng.install_fallback) == (N_REQ, 0)
    else:
        assert (eng.install_fused, eng.install_fallback) == (0, N_REQ)


def test_paging_off_matches_paging_on(setup, reference_outputs):
    eng, outs = _port(setup)
    assert eng.pager is None
    assert outs == reference_outputs


def _assert_kv_keys_match(got, want):
    assert set(got["kv"]) == set(want["kv"])
    assert got["kv"]["c2h_bytes"] == want["kv"]["c2h_bytes"] == 0


def test_cli_returns_reference_result_keys(capsys):
    flags = ["--smoke", "--requests", "3", "--max-new", "4",
             "--kv-paging"]
    want = ref_serve.main(flags)
    capsys.readouterr()
    got = port_serve.main(flags + ["--device", "cpu"])
    assert "c2h=0 " in next(line for line in capsys.readouterr().out
                            .splitlines()
                            if line.startswith("[serve:kv-paging]"))
    assert set(got) == set(want)
    assert set(got["install"]) == set(want["install"])
    assert set(got["latency"]) == set(want["latency"])
    _assert_kv_keys_match(got, want)
    assert got["requests"] == 3 and got["install"]["fused"] == 3
    assert all(len(v) == 4 for v in got["outputs"].values())
    plain = port_serve.main(flags[:-1] + ["--device", "cpu"])
    assert plain["outputs"] == got["outputs"]


@pytest.mark.parametrize("mode", [["--kv-codec", "int8"],
                                  ["--prefix-share"]],
                         ids=["kv-codec-int8", "prefix-share"])
def test_cli_kv_keys_match_reference_in_capacity_modes(mode):
    flags = ["--smoke", "--requests", "3", "--max-new", "4"] + mode
    want = ref_serve.main(flags)
    got = port_serve.main(flags + ["--device", "cpu"])
    _assert_kv_keys_match(got, want)
    assert set(got["kv"]["cold"]) == set(want["kv"]["cold"])


# ---------------------------------------------------------------------------
# capacity multipliers: page codecs and prefix sharing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_model():
    """The port's own bf16 smoke model (bf16 caches: the bf16 codec is
    raw passthrough there)."""
    from repro_torch.models import transformer as PT
    pcfg = port_reduce(port_config("qwen2-0.5b"))
    return pcfg, PT.tree_init(PT.param_defs(pcfg), pcfg, 0, "cpu")


def _serve_capacity(cfg, params, *, shared=False, **kw):
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=64,
                      access_path="xdma", device="cpu", **kw)
    rng = np.random.default_rng(8)
    pfx = rng.integers(0, cfg.vocab, 6).astype(np.int32)
    for r in range(3):
        p = rng.integers(0, cfg.vocab, 10).astype(np.int32)
        if shared:
            p[:6] = pfx
        eng.submit(Request(rid=r, prompt=p, max_new=4,
                           prefix_len=6 if shared else 0))
    assert eng.run_until_drained() == 0
    out = {r.rid: list(r.out_tokens) for r in eng.done if r.failed is None}
    assert len(out) == 3
    kv = eng.pager.stats()
    eng.close()
    return out, kv, eng


class TestServeCapacity:
    def test_defaults_are_byte_compatible(self, bf16_model):
        cfg, params = bf16_model
        eng = ServeEngine(cfg, params, batch_slots=2, max_len=64,
                          access_path="xdma", device="cpu")
        assert eng.pager.codec is None
        assert eng.pager.phys_page_bytes == eng.pager.page_bytes
        assert eng.prefix_pages == 0 and eng.pager.n_pages == 2
        eng.close()

    def test_bf16_codec_serves_bit_exact(self, bf16_model):
        cfg, params = bf16_model
        base, _, _ = _serve_capacity(cfg, params)
        bf16, kv, _ = _serve_capacity(cfg, params, kv_codec="bf16")
        assert base == bf16
        assert kv["codec"] == "bf16"
        assert kv["phys_page_bytes"] == kv["page_bytes"]

    def test_int8_fused_and_unfused_agree(self, bf16_model):
        cfg, params = bf16_model
        fused, kv, eng = _serve_capacity(cfg, params, kv_codec="int8")
        assert eng.install_fused == 3
        unfused, _, eng = _serve_capacity(cfg, params, kv_codec="int8",
                                          fused_install=False)
        assert eng.install_fallback == 3
        assert fused == unfused
        assert kv["spill_bytes_physical"] * 1.9 < kv["spill_bytes_logical"]
        assert kv["h2c_bytes"] == kv["spill_bytes_physical"]

    def test_prefix_sharing_serves_bit_exact(self, bf16_model):
        cfg, params = bf16_model
        off, _, _ = _serve_capacity(cfg, params, shared=True)
        on, kv, eng = _serve_capacity(cfg, params, shared=True,
                                      prefix_share=True)
        assert off == on
        assert kv["shared_pages"] >= 1 and kv["dedup_bytes_saved"] > 0
        assert eng.pager.n_pages == 2 + eng.prefix_pages
        assert eng._share_ratio < 0.5

    def test_page_cost_follows_the_published_base(self, bf16_model):
        cfg, params = bf16_model
        eng = ServeEngine(cfg, params, batch_slots=2, max_len=64,
                          access_path="xdma", prefix_share=True,
                          device="cpu")
        p = np.arange(10, dtype=np.int32)
        req = Request(rid=0, prompt=p, max_new=2, prefix_len=6)
        assert eng.kv_page_cost(req) == 1.0       # no base yet
        eng.submit(req)
        eng.run_until_drained()
        assert eng.kv_page_cost(Request(rid=1, prompt=p, max_new=2,
                                        prefix_len=6)) == eng._share_ratio
        assert eng.kv_page_cost(Request(rid=2, prompt=p, max_new=2)) == 1.0
        eng.close()

    def test_capacity_bytes_cap_still_drains(self, bf16_model):
        """A one-page physical budget: ``kv_free_pages`` never reports
        more than the budget holds, a held page takes it to 0, and the
        engine still drains (the FIFO refill does not read the budget,
        as in the reference without an admission controller)."""
        cfg, params = bf16_model
        from repro_torch.serving.engine import page_codec_for
        codec = page_codec_for(cfg, 64, "int8")
        cap = codec.encoded_bytes
        eng = ServeEngine(cfg, params, batch_slots=2, max_len=64,
                          access_path="xdma", kv_codec="int8",
                          kv_capacity_bytes=cap, device="cpu")
        assert eng.kv_free_pages() == 1
        for r in range(3):
            eng.submit(Request(rid=r, prompt=np.random.default_rng(r)
                               .integers(0, cfg.vocab, 8)
                               .astype(np.int32), max_new=3))
        seen = set()
        for _ in range(400):
            active = eng.step()
            seen.add(eng.kv_free_pages())
            if active == 0 and eng.idle():
                break
        assert seen <= {0, 1} and 0 in seen
        assert sum(1 for r in eng.done if r.failed is None) == 3
        assert eng.pager.free_cold_bytes() == cap
        assert eng.kv_free_pages() == 1
        eng.close()


# ---------------------------------------------------------------------------
# the CLI's capacity modes against the reference's serve.main, float32
# ---------------------------------------------------------------------------

CLI_ARCHS = {"qwen2-0.5b": [],
             "recurrentgemma-2b": ["--prompt-len", "40", "--max-len", "64"]}


@pytest.fixture(scope="module", params=sorted(CLI_ARCHS))
def cli_model(request):
    arch = request.param
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="float32")
    pcfg = dataclasses.replace(port_reduce(port_config(arch)),
                               dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(0))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    return arch, cfg, pcfg, params, pparams


@pytest.mark.parametrize("mode", [
    ["--kv-codec", "bf16"], ["--kv-codec", "int8"],
    ["--kv-codec", "int8", "--no-fused-install"], ["--prefix-share"],
])
def test_cli_capacity_modes_match_reference(monkeypatch, cli_model, mode):
    """``serve.main`` of both packages, the reference's float32 weights
    swapped into both: the same seeded prompts (a shared prefix with
    ``--prefix-share``) give the same tokens."""
    arch, cfg, pcfg, params, pparams = cli_model
    monkeypatch.setattr(ref_serve, "reduce_for_smoke", lambda c: cfg)
    monkeypatch.setattr(ref_serve.T, "tree_init",
                        lambda defs, c, key: params)
    monkeypatch.setattr(port_serve, "reduce_for_smoke", lambda c: pcfg)
    monkeypatch.setattr(port_serve.T, "tree_init",
                        lambda defs, c, seed, device: pparams)
    flags = ["--arch", arch, "--smoke", "--requests", "3", "--max-new",
             "4"] + CLI_ARCHS[arch] + mode
    want = ref_serve.main(flags)
    got = port_serve.main(flags + ["--device", "cpu"])
    assert got["outputs"] == want["outputs"]
    assert got["install"] == want["install"]
    for key in ("codec", "page_bytes", "phys_page_bytes",
                "spill_bytes_logical", "spill_bytes_physical",
                "shared_pages", "dedup_bytes_saved", "cow_copies"):
        assert got["kv"][key] == want["kv"][key], key


# ---------------------------------------------------------------------------
# the access paths: qdma, verbs and the model-driven auto selector
# ---------------------------------------------------------------------------

def _keys(d):
    """The key set of a nested dict, level by level (``placement`` maps
    the members the selector chose, which follow each package's own
    models: its keys are left out, its page count is compared)."""
    return {k: (None if k == "placement" else _keys(v))
            if isinstance(v, dict) else None for k, v in d.items()}


@pytest.mark.parametrize("path", ["qdma", "verbs", "auto"])
def test_cli_access_paths_match_reference(monkeypatch, capsys, cli_model,
                                          path):
    """``--kv-paging --access-path qdma|verbs|auto`` on both archs: the
    reference's tokens (its float32 weights swapped into both) and its
    result key set at every level, the path's own stats included."""
    arch, cfg, pcfg, params, pparams = cli_model
    monkeypatch.setattr(ref_serve, "reduce_for_smoke", lambda c: cfg)
    monkeypatch.setattr(ref_serve.T, "tree_init",
                        lambda defs, c, key: params)
    monkeypatch.setattr(port_serve, "reduce_for_smoke", lambda c: pcfg)
    monkeypatch.setattr(port_serve.T, "tree_init",
                        lambda defs, c, seed, device: pparams)
    flags = ["--arch", arch, "--smoke", "--requests", "3", "--max-new",
             "4", "--kv-paging", "--access-path", path] + CLI_ARCHS[arch]
    want = ref_serve.main(flags)
    capsys.readouterr()
    got = port_serve.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve:kv-paging] path={path} " in out
    assert got["outputs"] == want["outputs"]
    assert got["install"] == want["install"]
    assert got["access_path"] == path
    assert _keys(got) == _keys(want)
    cold, rcold = got["kv"]["cold"], want["kv"]["cold"]
    assert cold["path"] == rcold["path"] == path
    if path == "verbs":
        assert cold["qp"]["wrs_posted"] == rcold["qp"]["wrs_posted"]
        assert [n["staged_hops"] for n in cold["nodes"]] == \
            [n["staged_hops"] for n in rcold["nodes"]]
    if path == "qdma":
        assert cold["queues"] == rcold["queues"]
    if path == "auto":
        assert "[serve:access-auto]" in out
        assert sum(cold["placement"].values()) == \
            sum(rcold["placement"].values())
        assert len(got["path_decisions"]) == len(want["path_decisions"])
        assert all(d["chosen"] == d["model_argmin"]
                   for d in got["path_decisions"])
    for k in ("h2c_bytes", "c2h_bytes", "evictions", "clean_evictions",
              "dirty_evictions", "page_bytes"):
        assert got["kv"][k] == want["kv"][k], k


def test_kv_backend_alias_and_node_latency(capsys):
    flags = ["--smoke", "--requests", "2", "--max-new", "3", "--device",
             "cpu"]
    with pytest.warns(DeprecationWarning, match="--kv-backend"):
        got = port_serve.main(flags + ["--kv-backend", "remote",
                                       "--kv-node-latency", "0.001"])
    assert got["access_path"] == "verbs"
    assert "[serve:kv-paging] path=verbs " in capsys.readouterr().out
    plain = port_serve.main(flags)
    assert got["outputs"] == plain["outputs"]
    with pytest.warns(DeprecationWarning, match="kv_backend"):
        eng = ServeEngine(port_reduce(port_config("qwen2-0.5b")), {},
                          batch_slots=2, max_len=32, kv_backend="local",
                          device="cpu")
    assert eng.access_path == "xdma"
    eng.close()
