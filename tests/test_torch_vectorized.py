"""The port's facade engine against the JAX package, on the CPU.

``repro_torch.sim`` and ``repro.sim`` build the same scenarios; their
``run(engine="vectorized")`` reports must be equal (``to_dict()`` apart
from ``wall_s``) on the exact and tolerance tiers, they must refuse the
same scenarios with the same ``UnsupportedByEngine`` and
``TickRangeError`` messages, and sweep lanes must equal the JAX sweep's
lanes.  Inside the port, the exact tier also equals the port's own
pure-Python ``async`` engine.  Every run passes ``device="cpu"``.
"""
import numpy as np
import pytest

import repro.sim as J
import repro_torch.sim as T
from engine_harness import CORE_FIELDS
from repro.core.cluster import ClusterSpec as JSpec, StepCost as JCost
from repro_torch.core.cluster import ClusterSpec as TSpec, StepCost as TCost
from repro_torch.core.scheduler import DeadlockError

CPU = {"device": "cpu"}


def rack(M, inj=(), *, n_iters=12, skew=100_000, compute=5_000):
    wl = M.RackRing(n_racks=2, hosts_per_rack=2, n_iters=n_iters,
                    compute_ns=compute, msg_bytes=4096, cross_every=4,
                    skew_bound_ns=skew)
    return M.Simulation(M.Topology.racks(2, 2), wl, M.Scenario("sc", inj))


def single_host(M, inj=()):
    wl = M.RackRing(n_racks=1, hosts_per_rack=1, n_iters=8,
                    compute_ns=3_000)
    return M.Simulation(M.Topology.single_host(), wl, M.Scenario("sc", inj))


def chip(M, inj=()):
    spec, cost = (JSpec, JCost) if M is J else (TSpec, TCost)
    wl = M.ChipRingTraining(
        spec(n_pods=2, chips_per_pod=4),
        cost(compute_ns=50_000, ici_bytes=8192, dcn_bytes=65536),
        n_steps=5, skew_bound_ns=1_000_000)
    return M.Simulation(
        M.Topology.full_mesh(2, link=M.Topology().default_host_link), wl,
        M.Scenario("sc", inj),
        placement={f"chip{i}": i // 4 for i in range(8)})


def interference(M, inj=()):
    wl = M.RackRing(n_racks=2, hosts_per_rack=1, n_iters=6,
                    compute_ns=4_000, cross_every=2)
    return M.Simulation(
        M.Topology.full_mesh(2, link=M.Topology().default_host_link), wl,
        M.Scenario("i", (M.Interference(host=1, bursts=5, burst_ns=2_000),)
                   + inj))


#: name -> (factory, injections(M), run kwargs)
CASES = {
    "rack_baseline": (rack, lambda M: (), {}),
    "single_host": (single_host, lambda M: (), {}),
    "chip_ring_2x4": (chip, lambda M: (), {}),
    "straggler": (rack, lambda M: (M.Straggler("w1", 2.5),
                                   M.Straggler("w1", 1.5)), {}),
    "fail_task": (rack, lambda M: (M.FailTask("w2", at_compute=3),), {}),
    "fail_host_deadlock": (rack, lambda M: (
        M.FailHost(1, at_vtime=160_000),), {}),
    "degrade_hosts": (rack, lambda M: (M.DegradeLink(
        hosts=(0, 2), extra_ns=7_000, from_vtime=50_000),), {}),
    "degrade_fabric": (rack, lambda M: (M.DegradeLink(
        fabric="hub", latency_factor=3.0),), {}),
    "interference": (interference, lambda M: (), {}),
    "chip_fail_task_deadlock": (chip, lambda M: (
        M.FailTask("chip5", at_compute=2),), {}),
    "tolerance_rack": (rack, lambda M: (), {"tick_ns": 100}),
    "tolerance_faults": (rack, lambda M: (
        M.Straggler("w1", 2.5), M.FailHost(3, at_vtime=200_000)),
        {"tick_ns": 100}),
}


def _strip(report) -> dict:
    d = report.to_dict()
    d["wall_s"] = 0.0
    return d


@pytest.mark.parametrize("name", sorted(CASES))
def test_report_equals_jax(name):
    make, inj, kw = CASES[name]
    want = make(J, inj(J)).run(engine="vectorized", **kw)
    got = make(T, inj(T)).run(engine="vectorized", verify=True, **kw, **CPU)
    assert _strip(got) == _strip(want)
    if name.endswith("deadlock"):
        assert got.status == "deadlock"
    if name.startswith("tolerance"):
        assert got.tier == "tolerance" and got.tick_ns == 100
    else:
        assert got.tier == "exact"


@pytest.mark.parametrize("name", ["rack_baseline", "chip_ring_2x4",
                                  "straggler", "fail_host_deadlock",
                                  "degrade_hosts", "interference"])
def test_exact_tier_equals_port_async(name):
    make, inj, _ = CASES[name]
    vec = make(T, inj(T)).run(engine="vectorized", **CPU)
    ref = make(T, inj(T)).run(engine="async")
    for field in CORE_FIELDS:
        assert getattr(vec, field) == getattr(ref, field), field
    assert vec.links == ref.links


def test_explicit_divisible_tick_stays_exact():
    def make(M):
        wl = M.RackRing(n_racks=1, hosts_per_rack=1, n_iters=8,
                        compute_ns=3_000, msg_bytes=40_000)
        return M.Simulation(M.Topology.single_host(), wl)
    got = make(T).run(engine="vectorized", tick_ns=500, verify=True, **CPU)
    assert got.tier == "exact"
    assert _strip(got) == _strip(make(J).run(engine="vectorized",
                                             tick_ns=500))
    ref = make(T).run(engine="single")
    assert got.vtime_ns == ref.vtime_ns and got.tasks == ref.tasks


# ------------------------------------------------------ refusals and errors


def _unsupported(M):
    """name -> a Simulation the vectorized engine must refuse."""
    topo = M.Topology.single_host()
    topo.cell("hot", ways=4)
    mesh2 = M.Topology.full_mesh(2, link=M.Topology().default_host_link)
    return {
        "modeled_serve": M.Simulation(
            M.Topology.single_host(), M.ModeledServe(n_clients=2,
                                                     n_requests=3)),
        "cells": M.Simulation(topo, M.RackRing(
            n_racks=1, hosts_per_rack=1, n_iters=4, live=True,
            cells={"w0": "hot"})),
        "auto_cells": M.Simulation(
            M.Topology.single_host(),
            M.RackRing(n_racks=1, hosts_per_rack=2, n_iters=4),
            cells="auto"),
        "live": M.Simulation(mesh2, M.RackRing(
            n_racks=1, hosts_per_rack=2, n_iters=4, live=True)),
        "cpu_resource": M.Simulation(
            M.Topology.single_host(),
            M.RackRing(n_racks=1, hosts_per_rack=1, n_iters=4),
            cpu_resource=True),
        "bitflip": rack(M, (M.BitFlip("w0", at_step=1),)),
        "clockskew": rack(M, (M.ClockSkew(1, offset_ns=500),)),
        "joinhost": rack(M, (M.JoinHost(3, 400_000),)),
    }


@pytest.mark.parametrize("name", ["modeled_serve", "cells", "auto_cells",
                                  "live", "cpu_resource", "bitflip",
                                  "clockskew", "joinhost"])
def test_unsupported_surface_matches_jax(name):
    with pytest.raises(J.UnsupportedByEngine) as want:
        _unsupported(J)[name].run(engine="vectorized")
    with pytest.raises(T.UnsupportedByEngine) as got:
        _unsupported(T)[name].run(engine="vectorized", **CPU)
    assert str(got.value) == str(want.value)


def _big_ring(M):
    wl = M.RackRing(n_racks=1, hosts_per_rack=2, n_iters=2,
                    compute_ns=2**30)
    return M.Simulation(M.Topology.single_host(), wl)


def test_tick_range_error_matches_jax():
    with pytest.raises(J.TickRangeError) as want:
        _big_ring(J).run(engine="vectorized")
    with pytest.raises(T.TickRangeError, match="tick_ns") as got:
        _big_ring(T).run(engine="vectorized", **CPU)
    assert str(got.value) == str(want.value)
    rec = _big_ring(T).run(engine="vectorized", tick_ns=1024, **CPU)
    assert rec.tier == "tolerance"
    assert _strip(rec) == _strip(_big_ring(J).run(engine="vectorized",
                                                  tick_ns=1024))


def test_tick_range_boundary_is_tight():
    def make(M):
        wl = M.RackRing(n_racks=1, hosts_per_rack=1, n_iters=1,
                        compute_ns=2**30 - 2048)
        return M.Simulation(M.Topology.single_host(), wl)
    rep = make(T).run(engine="vectorized", tick_ns=1, verify=True, **CPU)
    assert rep.status == "ok" and rep.vtime_ns == 2**30 - 2048
    assert _strip(rep) == _strip(make(J).run(engine="vectorized",
                                             tick_ns=1))


@pytest.mark.parametrize("inj,match", [
    (lambda M: (M.Straggler("nope", 2.0),), "unknown"),
    (lambda M: (M.FailTask("w0", at_compute=1),
                M.FailTask("w0", at_compute=2)), "two failures"),
    (lambda M: (M.DegradeLink(),), "exactly one"),
    (lambda M: (M.DegradeLink(hosts=(0, 1), latency_factor=0.1),),
     "only add"),
    (lambda M: (M.FailHost(99, at_vtime=1_000),), "FailHost"),
])
def test_validation_matches_jax(inj, match):
    with pytest.raises(ValueError, match=match) as want:
        rack(J, inj(J)).run(engine="vectorized")
    with pytest.raises(ValueError, match=match) as got:
        rack(T, inj(T)).run(engine="vectorized", **CPU)
    assert str(got.value) == str(want.value)


def test_on_deadlock_raise_and_dist_not_ported():
    with pytest.raises(DeadlockError):
        rack(T, (T.FailHost(1, at_vtime=160_000),)).run(
            engine="vectorized", on_deadlock="raise", **CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rack(T).run(engine="dist")


# ---------------------------------------------------------------- sweeps


def test_sweep_12_draws_equal_jax_and_port_async():
    """A 12-draw cut of tests/test_engine_fuzz.py's deterministic
    sweep: stragglers, degraded fabric, and some host deaths."""
    def axis(M):
        rng = np.random.default_rng(7)
        out = []
        for i in range(12):
            inj = [M.Straggler(f"w{rng.integers(0, 4)}",
                               float(rng.choice((1.5, 2.0, 2.5, 3.0)))),
                   M.DegradeLink(fabric="hub",
                                 extra_ns=int(rng.choice((0, 1_000,
                                                          25_000))),
                                 from_vtime=int(rng.choice((0, 30_000))))]
            if rng.random() < 0.25:
                inj.append(M.FailHost(int(rng.integers(0, 4)),
                                      at_vtime=int(rng.integers(1, 40)
                                                   * 10_000)))
            out.append(M.Scenario(f"draw{i}", tuple(inj)))
        return out

    def base(M, sc=None):
        wl = M.RackRing(n_racks=2, hosts_per_rack=2, n_iters=6,
                        compute_ns=5_000, cross_every=2,
                        skew_bound_ns=100_000)
        return M.Simulation(M.Topology.racks(2, 2), wl, sc,
                            placement=wl.default_placement())

    want = base(J).sweep(axis(J))
    got = base(T).sweep(axis(T), **CPU)
    assert got.tier == want.tier == "exact"
    assert got.tick_ns == want.tick_ns
    assert any(r.status == "deadlock" for r in got.reports)
    for sc, g, w in zip(axis(T), got.reports, want.reports):
        assert _strip(g) == _strip(w), sc.name
        ref = base(T, sc).run(engine="async")
        for field in ("status", "vtime_ns", "tasks", "progress"):
            assert getattr(g, field) == getattr(ref, field), sc.name


def test_sweep_lanes_equal_solo_runs():
    axis = [T.Scenario("base"), T.Scenario("s1", (T.Straggler("w1", 2.0),)),
            T.Scenario("f", (T.FailHost(1, at_vtime=160_000),))]
    res = rack(T).sweep(axis, **CPU)
    assert res.configs_per_s > 0 and len(res.reports) == 3
    for sc, rep in zip(axis, res.reports):
        solo = rack(T, sc.injections).run(engine="vectorized", **CPU)
        d1, d2 = _strip(rep), _strip(solo)
        d1["scenario"] = d2["scenario"]
        assert d1 == d2, sc.name


def test_sweep_refusals():
    with pytest.raises(T.UnsupportedByEngine, match="structure"):
        rack(T).sweep([T.Scenario("base"), T.Scenario(
            "i", (T.Interference(host=0, bursts=3, burst_ns=1_000),))],
            **CPU)
    with pytest.raises(ValueError):
        rack(T).sweep([], **CPU)


# ------------------------------------------------ the tolerance tier's bound


def _c1_draw(M):
    """A recorded fuzz draw (topology (2, 2, 2000, 500), workload (4, 5000,
    2, 0)) whose hub DegradeLink threshold flips under a 100 ns tick: a
    send that rounds across ``from_vtime`` gains or loses the whole
    ``extra_ns``."""
    from repro.core.ipc import LinkSpec as JLink
    from repro_torch.core.ipc import LinkSpec as TLink
    link = JLink if M is J else TLink
    wl = M.RackRing(n_racks=2, hosts_per_rack=2, n_iters=4, compute_ns=5000,
                    cross_every=2, skew_bound_ns=0)
    topo = M.Topology.racks(
        2, 2, intra_link=link(bandwidth_bps=80e9 * 8, latency_ns=2000),
        cross_link=link(bandwidth_bps=25e9 * 8, latency_ns=500), n_cpus=4)
    sc = M.Scenario("fuzz", (M.DegradeLink(fabric="hub", extra_ns=25000,
                                           from_vtime=30000),))
    return M.Simulation(topo, wl, sc, placement=wl.default_placement())


def test_tolerance_tier_bounds_degrade_threshold_flip():
    from repro_torch.sim.vectorized import compile_simulation
    tol = compile_simulation(_c1_draw(T), tick_ns=100).tol_ns
    vec = _c1_draw(T).run(engine="vectorized", tick_ns=100, verify=True,
                          **CPU)
    ref = _c1_draw(T).run(engine="async")
    assert vec.tier == "tolerance"
    assert vec.status == ref.status and vec.progress == ref.progress
    devs = {t: abs(vec.tasks[t]["vtime"] - info["vtime"])
            for t, info in ref.tasks.items()}
    assert max(devs.values()) > 0          # the draw does flip
    assert all(d <= tol for d in devs.values()), (devs, tol)
    assert abs(vec.vtime_ns - ref.vtime_ns) <= tol
    want = _c1_draw(J).run(engine="vectorized", tick_ns=100)
    assert _strip(vec) == _strip(want)
