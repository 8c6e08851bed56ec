"""The port's trace validator against the reference's: a sharded kill
run's ``--trace-out`` file passes both packages' validators with the
serve, tier, fabric and path layers and the ``fabric.fail`` and
``serve.kill`` instants; on hand-made traces both validators accept and
refuse the same files with the same messages."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro import obs as robs  # noqa: E402
from repro.obs import validate as ref_validate  # noqa: E402
from repro_torch import obs as pobs  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.obs import validate as port_validate  # noqa: E402

CATS = ("serve", "tier", "fabric", "path")
INSTANTS = ("fabric.fail", "serve.kill")


@pytest.fixture
def clean_obs():
    def reset():
        for o in (robs, pobs):
            o.trace.disable()
            o.metrics.disable_live()
            o.default_registry().clear()
    reset()
    yield
    reset()


@pytest.mark.parametrize("path", ["xdma", "verbs"])
def test_kill_run_trace_passes_both_validators(tmp_path, clean_obs, path):
    out = tmp_path / "trace.json"
    res = port_serve.main(["--smoke", "--requests", "4", "--max-new", "4",
                           "--slots", "2", "--prompt-len", "6",
                           "--access-path", path, "--kv-shards", "4",
                           "--kv-replicas", "2", "--kv-kill-node", "3",
                           "--trace-out", str(out), "--metrics",
                           "--device", "cpu"])
    assert res["fabric"]["killed"] is not None
    infos = [v.validate_trace(str(out), require_cats=CATS,
                              require_instants=INSTANTS)
             for v in (ref_validate, port_validate)]
    assert infos[1] == infos[0]
    assert set(CATS) <= set(infos[1]["cats"])
    # the kill lands at the step the result names
    events = port_validate.load_events(str(out))
    kills = [e for e in events if e.get("name") == "serve.kill"]
    assert len(kills) == 1
    assert kills[0]["args"]["step"] == res["fabric"]["kill_step"]
    assert port_validate.main([str(out), "--require-cats", ",".join(CATS),
                               "--require-instant", "serve.kill"]) == 0


def _ev(ph, name="a", tid=0, **kw):
    return {"ph": ph, "name": name, "pid": 1, "tid": tid, "ts": 0,
            "cat": "serve", **kw}


TRACES = {
    "nested": [_ev("B", "a"), _ev("B", "b"), _ev("E", "b"), _ev("E", "a"),
               _ev("X", "c", dur=1), _ev("i", "serve.kill")],
    "misnested": [_ev("B", "a"), _ev("B", "b"), _ev("E", "a")],
    "unclosed": [_ev("B", "a")],
    "orphan_end": [_ev("E", "a")],
    "x_without_dur": [_ev("X", "a")],
    "async_pairs": [_ev("b", "r", id=1), _ev("e", "r", id=1)],
    "async_orphan": [_ev("e", "r", id=2)],
    "not_phased": [{"name": "a"}],
    "bare_list": [_ev("i", "fabric.fail")],
}


@pytest.mark.parametrize("name", sorted(TRACES))
@pytest.mark.parametrize("wrapped", [True, False])
def test_validators_agree_on_hand_made_traces(tmp_path, name, wrapped):
    f = tmp_path / f"{name}.json"
    evs = TRACES[name]
    f.write_text(json.dumps({"traceEvents": evs} if wrapped else evs))
    outcomes = []
    for v in (ref_validate, port_validate):
        try:
            outcomes.append(("ok", v.validate_trace(str(f))))
        except v.TraceInvalid as e:
            outcomes.append(("invalid", str(e)))
    assert outcomes[1] == outcomes[0]
    if outcomes[0][0] == "ok":
        for v in (ref_validate, port_validate):
            with pytest.raises(v.TraceInvalid, match="required"):
                v.validate_trace(str(f), require_instants=["nope"])
    if name == "unclosed":
        lenient = [v.validate_trace(str(f), allow_unbalanced=True)
                   for v in (ref_validate, port_validate)]
        assert lenient[1] == lenient[0]
