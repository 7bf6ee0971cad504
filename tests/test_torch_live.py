"""The port's live workloads (``repro_torch.sim.live``) against the JAX
package's on the CPU.

Replay needs no model: the port facade replays the three golden traces
of ``tests/golden`` and must produce the JAX facade's report (bit for
bit, wall time aside), identically under the port's barrier and async
engines (``single`` takes one host; every live scenario spans more).
Record runs the port's real ``BatchServer`` and trainer (plain
attention on the CPU) and their traces must replay bit-identically
across engines; under a clock that reads the golden traces' spans, the
recovery and co-located recorders write the golden traces themselves.
The CLI ``python -m repro_torch.live`` replays like the JAX package's.
"""
import json
import pathlib

import pytest

from engine_harness import assert_engines_agree
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


# -- the trainer scenarios, recorded by the port's real trainer ---------------


def _labels(path) -> dict:
    data = json.loads(pathlib.Path(path).read_text())
    return {t: [e["label"] for e in es] for t, es in data["tasks"].items()}


def _as_replayed(report) -> dict:
    """The report without wall time and without the live sections'
    ``mode``: what a replay of a recorded run reproduces."""
    d = _strip(report)
    d["live"] = {k: {f: x for f, x in sec.items() if f != "mode"}
                 for k, sec in d["live"].items()}
    return d


def _replays_agree(make_sim) -> dict:
    """Replay under every engine that takes the scenario's topology
    (barrier, async, dist:1, dist:2; ``single`` takes one host) and
    assert bit-identical reports."""
    return assert_engines_agree(make_sim, label="port live replay")


def test_trainer_record_raises_not_implemented(tmp_path):
    """Once the raise of ROADMAP A8; now the port's trainer records the
    recovery scenario on the CPU: an ordered timeline, a restore from
    the last committed checkpoint, and a trace that replays
    bit-identically across engines.  Which step the failure lands in
    follows the host's wall clock (the fail vtime comes from a probe
    step), so the labels are held to the golden trace's in
    ``test_record_live_recovery_on_the_golden_clock``."""
    out = tmp_path / "r.json"
    report, ledger = tsim.record_live_recovery(out, device="cpu")
    assert report.status == "ok"
    assert ledger.meta["fail_probe"]["probe_span_ns"] > 0
    tl = tsim.recovery_timeline(report)
    v = {e["event"]: e["vtime"] for e in tl}
    assert v["detect"] < v["restore"] < v["remesh"] <= v["resumed"], tl
    labels = _labels(out)["live.trainer"]
    saves = [int(x.split(":")[1]) for x in labels[:labels.index("restore:1")]
             if x.startswith("save:")]
    restored = {e["event"]: e["step"] for e in tl}["restore"]
    assert restored == (saves[-1] if saves else 0), (labels, tl)
    reports = _replays_agree(
        lambda: tsim.live_recovery_sim(tsim.CostLedger.replay(out)))
    for rep in reports.values():
        assert rep.vtime_ns == report.vtime_ns
        assert tsim.recovery_timeline(rep) == tl
    stack = tsim.TrainerStack(device="cpu", n_steps=2)
    stack.setup()
    stack.step(1)
    stack.close()


class _GoldenClock:
    """The recorder's wall clock for a test: every span it measures is the
    golden trace's cost for that call, so a record run by the port's real
    stack (the trainer and the server really run) is deterministic.  The
    ledger reads the clock twice per call, before and after the work."""

    def __init__(self, golden: dict):
        self.queues = {t: [(e["label"], e["cost_ns"]) for e in es]
                       for t, es in golden["tasks"].items()}
        self.now = self.calls = self.span = 0

    def perf_counter_ns(self) -> int:
        self.calls += 1
        if self.calls % 2 == 0:
            self.now += self.span
        return self.now

    def install(self, monkeypatch) -> None:
        from repro_torch.live import recorder
        charge = recorder.CostLedger.charge
        clock = self

        def golden_charge(ledger, task, label, fn=None, args=(),
                          kwargs=None):
            if ledger.mode == "record":
                want, clock.span = clock.queues[task].pop(0)
                assert label == want, (task, label, want)
            return charge(ledger, task, label, fn, args, kwargs)
        monkeypatch.setattr(recorder, "time", self)
        monkeypatch.setattr(recorder.CostLedger, "charge", golden_charge)


def test_record_live_recovery_on_the_golden_clock(monkeypatch, tmp_path):
    """The port's trainer, on the CPU, driven under the golden trace's
    spans and fail vtime, writes the golden trace: the same tasks, step
    labels and costs, the same meta; its replay equals the JAX facade's
    replay of the golden trace."""
    golden = json.loads((GOLDEN / "live_recovery_trace.json").read_text())
    _GoldenClock(golden).install(monkeypatch)
    out = tmp_path / "r.json"
    fail_at = golden["meta"]["recovery"]["fail_at_vtime"]
    report, _ = tsim.record_live_recovery(out, device="cpu",
                                          fail_at_vtime=fail_at)
    monkeypatch.undo()
    data = json.loads(out.read_text())
    assert data["tasks"] == golden["tasks"]
    assert data["meta"] == golden["meta"]
    assert _as_replayed(report) == _as_replayed(
        _replay(jsim, "recovery", "async"))
    _replays_agree(lambda: tsim.live_recovery_sim(tsim.CostLedger.replay(out)))


def test_record_live_colocated_on_the_golden_clock(monkeypatch, tmp_path):
    """The port's trainer and server sharing one cell, on the CPU, under
    the golden trace's spans and arrivals: the recorded tasks, labels and
    costs equal the golden trace's, and so does the replay's report."""
    golden = json.loads((GOLDEN / "live_colocated_trace.json").read_text())
    _GoldenClock(golden).install(monkeypatch)
    out = tmp_path / "c.json"
    serve = golden["meta"]["colocated"]["serve"]
    report, _ = tsim.record_live_colocated(
        out, device="cpu", serve={"arrivals": serve["arrivals"],
                                  "mean_gap_ns": serve["mean_gap_ns"]})
    monkeypatch.undo()
    data = json.loads(out.read_text())
    assert data["tasks"] == golden["tasks"]
    assert data["meta"]["colocated"] == golden["meta"]["colocated"]
    assert _as_replayed(report) == _as_replayed(
        _replay(jsim, "colocated", "async"))
    assert tsim.serve_latency(report)
    _replays_agree(
        lambda: tsim.live_colocated_sim(tsim.CostLedger.replay(out)))


def test_record_live_colocated_replays_bit_identically(tmp_path):
    """Recorded on the host's own clock: the same tasks and label layout
    as the golden trace's, non-empty serve latencies, and bit-identical
    replays."""
    out = tmp_path / "c.json"
    report, ledger = tsim.record_live_colocated(out, device="cpu")
    assert report.status == "ok" and tsim.serve_latency(report)
    assert ledger.meta["serve_probe"]["probe_span_ns"] > 0
    labels = _labels(out)
    golden = _labels(GOLDEN / "live_colocated_trace.json")
    assert set(labels) == set(golden) == {"live.trainer", "serve.live"}
    assert labels["live.trainer"] == golden["live.trainer"]
    assert labels["serve.live"][:3] == ["prefill:0", "decode:0:0",
                                        "decode:0:1"]
    reports = _replays_agree(
        lambda: tsim.live_colocated_sim(tsim.CostLedger.replay(out)))
    for rep in reports.values():
        assert tsim.serve_latency(rep) == tsim.serve_latency(report)


def test_trainer_stack_lands_on_cuda_unless_asked(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.record_live_recovery(tmp_path / "r.json")


@pytest.mark.parametrize("name", list(TRACES))
def test_live_cli_replay_equals_jax(name, capsys):
    """``python -m repro_torch.live replay`` prints what ``python -m
    repro.live replay`` prints for each golden trace."""
    from repro.live.__main__ import main as jmain
    from repro_torch.live.__main__ import main as tmain
    args = ["replay", "--trace", str(GOLDEN / TRACES[name][0])]
    assert tmain(args) == 0
    port = json.loads(capsys.readouterr().out)
    assert jmain(args) == 0
    assert port == json.loads(capsys.readouterr().out)
    assert port["scenario"] == name and port["status"] == "ok"


def test_live_cli_records_on_the_cpu(tmp_path, capsys):
    from repro_torch.live.__main__ import main as tmain
    out = tmp_path / "s.json"
    assert tmain(["record", "--scenario", "serve", "--device", "cpu",
                  "--n-requests", "3", "--out", str(out)]) == 0
    assert "recorded serve" in capsys.readouterr().out
    assert tmain(["replay", "--trace", str(out)]) == 0
