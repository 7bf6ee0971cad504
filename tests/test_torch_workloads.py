"""The Table 2 workloads and the DES baseline (``repro_torch.core.workloads``,
``repro_torch.core.des``) against the JAX package's copies on the CPU.

Both are pure Python with numpy: the port keeps its own copies.  Held
here: ``DESEngine`` and ``fine_grained_compute`` on scripted event lists
(order of events, ``events``, ``sim_ns``, ``exhausted``), the compute
functions bit for bit, ``extrapolate_wall_s`` and ``accuracy``, the
``WORKLOADS`` registry, and the livestack and DES modes of the four
workloads at small sizes under one scripted clock installed in both
packages (``LiveClock``'s timer, the modules' ``time``, and the wire's
calibration), which must give the same ``sim_s`` and ``metrics``
exactly.  No test here reads the host clock for a bound: the physical
modes run only to show they report the reference's fields.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import des as jdes
from repro.core import ipc as jipc
from repro.core import vtime as jvtime
from repro.core import workloads as jwl
from repro_torch.core import des as tdes
from repro_torch.core import ipc as tipc
from repro_torch.core import vtime as tvtime
from repro_torch.core import workloads as twl

PACKAGES = {"jax": (jdes, jipc, jvtime, jwl),
            "torch": (tdes, tipc, tvtime, twl)}


class _ScriptedClock:
    """A host clock that advances by a fixed cycle of spans on every
    read, so each package, given a fresh one, sees the same times in the
    same order of reads."""

    SPANS_NS = (1_300, 7_100, 2_900, 40_000, 450, 12_345)

    def __init__(self):
        self.now_ns = 0
        self._spans = itertools.cycle(self.SPANS_NS)

    def perf_counter_ns(self) -> int:
        self.now_ns += next(self._spans)
        return self.now_ns

    def perf_counter(self) -> float:
        return self.perf_counter_ns() / 1e9

    def sleep(self, seconds: float) -> None:
        self.now_ns += int(seconds * 1e9)

    def install(self, monkeypatch, package: str) -> None:
        des, ipc, vtime, wl = PACKAGES[package]
        monkeypatch.setattr(des, "time", self)
        monkeypatch.setattr(wl, "time", self)
        monkeypatch.setattr(vtime.LiveClock.__init__, "__defaults__",
                            (1.0, self.perf_counter_ns))
        # the hub's link as a calibration of the wire would have set it
        monkeypatch.setattr(wl, "_CALIBRATED", {
            "link": ipc.LinkSpec(bandwidth_bps=wl.LINK_BW,
                                 latency_ns=73_000),
            "overhead_ns": 23_000})


def _both(monkeypatch, run):
    """``run(package modules)`` once per package, each under a fresh
    scripted clock."""
    out = {}
    for name, mods in PACKAGES.items():
        with monkeypatch.context() as m:
            _ScriptedClock().install(m, name)
            out[name] = run(*mods)
    return out["jax"], out["torch"]


# ------------------------------------------------------------------ DES


def _script(des):
    """A scripted event list: three chains that fire at their own
    strides, a tie at one time (broken by schedule order), and one
    event scheduled from inside another; returns (engine, log)."""
    eng = des.DESEngine()
    log = []

    def chain(name, stride, left):
        def fire():
            log.append((eng.now, name, left))
            if left > 1:
                eng.schedule(eng.now + stride, chain(name, stride, left - 1))
        return fire
    for name, start, stride, n in (("a", 5, 10, 30), ("b", 5, 7, 40),
                                   ("c", 0, 100, 4)):
        eng.schedule(start, chain(name, stride, n))
    eng.schedule(50, lambda: eng.schedule(eng.now + 1,
                                          lambda: log.append("nested")))
    return eng, log


def test_des_engine_matches_reference_on_a_scripted_list(monkeypatch):
    """The same events fire in the same order, with the same stats,
    through ``until_ns``, ``max_events`` and a run to exhaustion."""
    def run(des, *_):
        eng, log = _script(des)
        stats = [eng.run(until_ns=120), eng.run(max_events=17),
                 eng.run(wall_budget_s=10.0), eng.run()]
        return log, stats, eng.now, eng.events_processed
    (jlog, jst, jnow, jn), (tlog, tst, tnow, tn) = _both(monkeypatch, run)
    assert tlog == jlog and (tnow, tn) == (jnow, jn)
    assert [s["events"] for s in jst] == [s["events"] for s in tst]
    assert tst == jst
    assert [s["exhausted"] for s in tst] == [False, False, True, True]
    assert tst[1]["events"] == 17


@pytest.mark.parametrize("duration,grain", [(10_000, 1_000), (999, 1_000),
                                            (7_300, 700), (0, 50)])
def test_fine_grained_compute_matches_reference(monkeypatch, duration,
                                                grain):
    """One event per grain (at least one), the work run once at the last
    event, then ``on_done``; the same count, times and order."""
    def run(des, *_):
        eng = des.DESEngine()
        log = []
        n = des.fine_grained_compute(
            eng, 40, duration, grain, lambda: log.append(("done", eng.now)),
            work_fn=lambda: log.append(("work", eng.now)))
        eng.schedule(40 + 3 * grain, lambda: log.append(("other", eng.now)))
        return n, eng.run(), log
    (jn, jst, jlog), (tn, tst, tlog) = _both(monkeypatch, run)
    assert (tn, tlog) == (jn, jlog)
    assert tst == jst
    assert tn == max(1, duration // grain)


@pytest.mark.parametrize("measured,total", [
    ({"events_per_s": 2.5e6}, 10 ** 9), ({"events_per_s": 0.0}, 7),
    ({"events_per_s": float("inf")}, 3), ({"events_per_s": 1e-12}, 5)])
def test_extrapolate_wall_s_matches_reference(measured, total):
    assert tdes.extrapolate_wall_s(measured, total) == \
        jdes.extrapolate_wall_s(measured, total)


@pytest.mark.parametrize("pred,actual", [(1.0, 1.0), (0.9, 1.0), (3.0, 1.0),
                                         (0.0, 0.0), (5e-13, 0.0),
                                         (2.0, 1e-15)])
def test_accuracy_matches_reference(pred, actual):
    assert twl.accuracy(pred, actual) == jwl.accuracy(pred, actual)


# ------------------------------------------------ the compute functions


def test_compute_functions_bit_equal():
    for n in (8, 64):
        assert twl.arith_kernel(n) == jwl.arith_kernel(n)
    payloads = np.random.default_rng(1).random((6, 64))
    js, ts = {}, {}
    for i, p in enumerate(payloads):
        assert twl.txn_kernel(ts, i % 3, p) == jwl.txn_kernel(js, i % 3, p)
    assert ts == js
    for key in (0, 1, 2, 9):
        assert twl.kv_read(ts, key) == jwl.kv_read(js, key)
    shard = np.random.default_rng(2).random(1_001)
    for parts in (1, 3, 4):
        tp, jp = twl.map_kernel(shard, parts), jwl.map_kernel(shard, parts)
        assert len(tp) == len(jp) == parts
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)
        assert twl.reduce_kernel(tp) == jwl.reduce_kernel(jp)


def test_workload_registry_matches_reference():
    assert list(twl.WORKLOADS) == list(jwl.WORKLOADS)
    for name, want in jwl.WORKLOADS.items():
        got = twl.WORKLOADS[name]
        assert list(got) == list(want), name
        for key, value in want.items():
            if callable(value):
                assert got[key].__name__ == value.__name__
                assert got[key].__module__ == "repro_torch.core.workloads"
            else:
                assert got[key] == value, (name, key)
    assert [f.name for f in dataclasses.fields(twl.WorkloadResult)] == \
        [f.name for f in dataclasses.fields(jwl.WorkloadResult)]
    assert (twl.LINK_BW, twl.LINK_LAT_S, twl.Wire.SPIN_S) == \
        (jwl.LINK_BW, jwl.LINK_LAT_S, jwl.Wire.SPIN_S)
    assert dataclasses.astuple(twl.LINK) == dataclasses.astuple(jwl.LINK)


# ------------------------------------------------ the workloads' modes

#: (workload, mode, small arguments)
MODES = [("arith", "livestack", dict(iters=5)),
         ("arith", "des", dict(iters=5)),
         ("oltp", "livestack", dict(n_req=12)),
         ("oltp", "des", dict(n_req=12)),
         ("kvstore", "livestack", dict(n_ops=10)),
         ("kvstore", "livestack", dict(n_ops=6, n_clients=3)),
         ("shuffle", "livestack", dict(rounds=2)),
         ("shuffle", "livestack", dict(n_workers=2, rounds=1))]


@pytest.mark.parametrize("workload,mode,kw", MODES)
def test_modes_match_reference_under_one_scripted_clock(monkeypatch,
                                                        workload, mode, kw):
    """The livestack mode (the same functions as live vtasks) and the
    DES mode give the reference's ``sim_s`` and ``metrics`` exactly when
    both read the same scripted clock."""
    def run(*mods):
        return mods[3].WORKLOADS[workload][mode](**kw)
    want, got = _both(monkeypatch, run)
    assert (got.name, got.mode) == (want.name, want.mode) == (workload, mode)
    assert got.sim_s == want.sim_s and got.sim_s > 0
    assert got.metrics == want.metrics


@pytest.mark.parametrize("workload,kw", [("arith", dict(iters=2)),
                                         ("oltp", dict(n_req=4)),
                                         ("kvstore", dict(n_ops=4)),
                                         ("shuffle", dict(rounds=1))])
def test_physical_modes_report_the_reference_fields(workload, kw):
    """The physical testbed (threads and slept wires) runs at a tiny size
    and reports what the reference's does; its times are the host's and
    are not compared."""
    got = twl.WORKLOADS[workload]["physical"](**kw)
    assert (got.name, got.mode) == (workload, "physical")
    want_keys = {"arith": {"iters_per_s"},
                 "oltp": {"avg_latency_us", "throughput_ops"},
                 "kvstore": {"runtime_s"}, "shuffle": {"runtime_s"}}
    assert set(got.metrics) == want_keys[workload]
    assert got.wall_s == got.sim_s > 0
