"""The port's live workloads (``repro_torch.sim.live``) against the JAX
package's on the CPU.

Replay needs no model: the port facade replays the three golden traces
of ``tests/golden`` and must produce the JAX facade's report (bit for
bit, wall time aside), identically under the port's barrier and async
engines (``single`` takes one host; every live scenario spans more).
Record runs the port's real ``BatchServer`` (plain
attention on the CPU) and its trace must replay bit-identically.  The
trainer is not ported (ROADMAP A8), so recording the recovery and
co-located scenarios raises.
"""
import json
import pathlib

import pytest

from repro import sim as jsim
from repro_torch import sim as tsim

GOLDEN = pathlib.Path(__file__).parent / "golden"
TRACES = {
    "serve": ("live_serve_trace.json", "live_serve_sim"),
    "colocated": ("live_colocated_trace.json", "live_colocated_sim"),
    "recovery": ("live_recovery_trace.json", "live_recovery_sim"),
}
#: the in-process engines that take a multi-host topology (every live
#: scenario spans two or more hosts, so ``single`` does not apply)
ENGINES = ("barrier", "async")


def _strip(report) -> dict:
    d = report.to_dict()
    d["wall_s"] = 0.0
    return d


def _replay(pkg, name, engine):
    fname, builder = TRACES[name]
    ledger = pkg.CostLedger.replay(GOLDEN / fname)
    return getattr(pkg, builder)(ledger).run(engine=engine)


@pytest.mark.parametrize("name", list(TRACES))
def test_golden_replay_equals_jax(name):
    port = _replay(tsim, name, "async")
    assert port.status == "ok"
    assert _strip(port) == _strip(_replay(jsim, name, "async"))


@pytest.mark.parametrize("name", list(TRACES))
def test_golden_replay_bit_identical_across_engines(name):
    want = _strip(_replay(tsim, name, "async"))
    got = _strip(_replay(tsim, name, "barrier"))
    for field in ("status", "vtime_ns", "messages", "bytes", "tasks",
                  "progress", "cells", "live"):
        assert got[field] == want[field], field


def test_golden_serve_latency_equals_jax():
    port = tsim.serve_latency(_replay(tsim, "serve", "async"))
    assert port and port == jsim.serve_latency(_replay(jsim, "serve",
                                                       "async"))
    rec = tsim.recovery_timeline(_replay(tsim, "recovery", "async"))
    assert [e["event"] for e in rec] == ["detect", "restore", "remesh",
                                         "resumed"]
    assert rec == jsim.recovery_timeline(_replay(jsim, "recovery", "async"))


def test_record_live_serve_replays_bit_identically(tmp_path):
    """The port's real BatchServer records a serve trace (on the CPU
    here) that replays bit-identically under every in-process engine,
    with the JAX recorder's task and label layout."""
    out = tmp_path / "serve_trace.json"
    report, ledger = tsim.record_live_serve(
        out, n_requests=4, max_batch=2, decode_steps=2, device="cpu")
    assert report.status == "ok"
    assert ledger.meta["serve_probe"]["probe_span_ns"] > 0
    assert len(ledger.meta["serve"]["arrivals"]) == 4
    data = json.loads(out.read_text())
    golden = json.loads((GOLDEN / "live_serve_trace.json").read_text())
    assert set(data["tasks"]) == set(golden["tasks"]) == {"serve.live"}
    assert data["schema"] == golden["schema"]
    labels = [e["label"] for e in data["tasks"]["serve.live"]]
    assert labels[0] == "prefill:0" and labels[1:3] == ["decode:0:0",
                                                        "decode:0:1"]
    reps = {eng: tsim.live_serve_sim(tsim.CostLedger.replay(out)).run(
        engine=eng) for eng in ENGINES}
    for eng, rep in reps.items():
        assert rep.vtime_ns == report.vtime_ns, eng
        assert tsim.serve_latency(rep) == tsim.serve_latency(report), eng
        assert _strip(rep)["live"] == _strip(reps["async"])["live"]


def test_serve_stack_lands_on_cuda_unless_asked(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.record_live_serve(tmp_path / "t.json", n_requests=2,
                               max_batch=1, decode_steps=1)


def test_trainer_record_raises_not_implemented(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tsim.record_live_recovery(tmp_path / "r.json")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tsim.record_live_colocated(tmp_path / "c.json", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tsim.TrainerStack().step(0)
