"""The port's fleet CLI against the reference's: ``serve.main`` of both
packages, the reference's float32 smoke weights swapped into both, gives
the same tokens per request id and the same result key set at every
level for each fleet flag combination (replicas and tenants over Poisson
arrivals, a replica kill, a shared fabric with a member kill, prefix
sharing, tenant quotas, a fault plan).  Dicts keyed by data (request
ids, tenant names met by a replica, shed reasons) are compared by
content where the run decides them, not by key."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.rmem import backend as ref_backend  # noqa: E402
from repro.rmem import node as ref_node  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.rmem import backend as port_backend  # noqa: E402
from repro_torch.rmem import node as port_node  # noqa: E402

# keys whose own keys are data the run's timing picks (which tenants a
# replica met, which shed reasons occurred, request ids)
DATA_KEYED = {"peak_inflight_tokens", "reasons", "outputs"}

BASE = ["--smoke", "--requests", "6", "--slots", "2", "--max-len", "64",
        "--replicas", "2", "--tenants", "2"]
MODES = {
    "poisson": ["--arrivals", "poisson:100"],
    "kill-replica": ["--kv-paging", "--kill-replica", "2"],
    "fabric-member-kill": ["--arrivals", "poisson:100", "--kv-shards", "3",
                           "--kv-replicas", "2", "--kv-kill-node", "4",
                           "--kill-replica", "8"],
    "prefix-share": ["--prefix-share", "--prefix-share-ratio", "0.5"],
    "quota": ["--kv-paging", "--quota-tokens", "60"],
    "faults": ["--kv-shards", "3", "--kv-replicas", "2", "--fault-seed",
               "7", "--fault-rate", "0.05"],
}


def keys_of(d):
    return {k: (None if k in DATA_KEYED else keys_of(v))
            if isinstance(v, dict) else None for k, v in d.items()}


@pytest.fixture(scope="module")
def qwen_model():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    pcfg = dataclasses.replace(port_reduce(port_config("qwen2-0.5b")),
                               dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(0))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    return cfg, pcfg, params, pparams


def _swap_weights(monkeypatch, qwen_model):
    cfg, pcfg, params, pparams = qwen_model
    monkeypatch.setattr(ref_serve, "reduce_for_smoke", lambda c: cfg)
    monkeypatch.setattr(ref_serve.T, "tree_init",
                        lambda defs, c, key: params)
    monkeypatch.setattr(port_serve, "reduce_for_smoke", lambda c: pcfg)
    monkeypatch.setattr(port_serve.T, "tree_init",
                        lambda defs, c, seed, device: pparams)


def _reset_scopes(monkeypatch):
    for mod in (ref_node.MemoryNode, port_node.MemoryNode,
                ref_backend.LocalHostBackend,
                port_backend.LocalHostBackend):
        monkeypatch.setattr(mod, "_scope_ids", itertools.count())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fleet_cli_matches_reference(monkeypatch, capsys, qwen_model,
                                     mode):
    _swap_weights(monkeypatch, qwen_model)
    flags = BASE + MODES[mode]
    _reset_scopes(monkeypatch)
    want = ref_serve.main(flags)
    capsys.readouterr()
    _reset_scopes(monkeypatch)
    got = port_serve.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve:fleet] 2 replicas" in out and "[serve:latency]" in out
    assert got["outputs"] == want["outputs"]
    assert sorted(got["outputs"]) == list(range(6))
    assert got["undrained"] == want["undrained"] == 0
    assert keys_of(got) == keys_of(want)
    assert got["workload"] == want["workload"]
    for k in ("replicas", "served", "tokens", "killed_replicas",
              "killed_member"):
        assert got["fleet"][k] == want["fleet"][k], k
    assert got["rejected"] == want["rejected"]
    if "--kill-replica" in flags:
        assert got["fleet"]["rerouted"] > 0
        assert got["fleet"]["killed_replicas"] == ["replica1"]
    if "--kv-kill-node" in flags:
        assert "[serve:fabric]" in out
        assert got["fabric"]["killed"] == want["fabric"]["killed"]
        assert got["fabric"]["repair"]["lost"] == 0
    if "--quota-tokens" in flags:
        for adm in got["admission"].values():
            assert all(v <= 60 for v in
                       adm["peak_inflight_tokens"].values())
    if mode == "prefix-share":
        assert got["kv"]["shared_pages"] >= 1
        assert got["kv"]["dedup_bytes_saved"] > 0
    if mode == "faults":
        assert got["shed"] == 0
        assert got["faults"]["plan"]["seed"] == 7
    if "kv" in want:
        assert set(got["kv"]) == set(want["kv"])


def test_fleet_cli_sheds_slo_with_typed_reasons(monkeypatch, qwen_model):
    """A one-replica saturating burst under a tiny TTFT deadline: the
    shed requests are counted under ``rejected.reasons.slo`` and carry no
    tokens; every served one has the reference's tokens."""
    _swap_weights(monkeypatch, qwen_model)
    flags = ["--smoke", "--requests", "10", "--slots", "2", "--max-len",
             "64", "--slo-ttft-ms", "0.001"]
    want = ref_serve.main(flags)
    got = port_serve.main(flags + ["--device", "cpu"])
    assert keys_of(got) == keys_of(want)
    shed = got["rejected"]["reasons"].get("slo", 0)
    assert shed > 0 and got["rejected"]["count"] == shed == got["shed"]
    assert set(got["outputs"]).isdisjoint(got["rejected"]["rids"])
    for rid, toks in got["outputs"].items():
        if rid in want["outputs"]:
            assert toks == want["outputs"][rid]
    adm = got["admission"]["replica0"]
    assert adm["shed_slo"] == shed and adm["cadence_s"] > 0


def test_fleet_mode_ignores_prompt_len_and_max_new():
    """The tenant mixes draw the lengths: --prompt-len and --max-new do
    not change a fleet run's tokens."""
    flags = ["--smoke", "--requests", "3", "--slots", "2", "--max-len",
             "64", "--tenants", "2", "--device", "cpu"]
    a = port_serve.main(flags)
    b = port_serve.main(flags + ["--prompt-len", "9", "--max-new", "3"])
    assert a["outputs"] == b["outputs"]
    assert a["fleet"]["replicas"] == 1


def test_fleet_cli_wants_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        port_serve.main(["--smoke", "--replicas", "2"])
