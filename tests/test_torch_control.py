"""The port's traffic-driven control plane (``repro_torch.sim.control``)
against the JAX package's (``repro.sim.control``), on the CPU.

Mirrors ``tests/test_control_plane.py``: the placement policies, the
threshold autoscaler's integer decision rule and the diurnal arrival
schedule give the same answers in both packages, and a small
autoscaled fleet with late-joining pool hosts gives bit-identical
reports and ``SimReport.control`` sections on every engine of the port
(dist with 1 and 2 OS workers included) and against the JAX package's
async run.  Everything compared is integer or JSON: the tolerance is
bit-equality.
"""
import numpy as np
import pytest

import repro.sim as J
import repro_torch.sim as T
from engine_harness import CORE_FIELDS, assert_engines_agree

POLICIES = ("first_fit", "best_fit", "worst_fit")


# ---------------------------------------------------------------------------
# placement policies
# ---------------------------------------------------------------------------


def test_first_fit_prefers_lowest_idle_id():
    busy = [0, 500, 0, 0]
    assert T.first_fit([1, 2, 3], busy, now=100, service_ns=50,
                       cap_ns=400) == 2
    busy = [0, 900, 700, 700]
    assert T.first_fit([1, 2, 3], busy, now=100, service_ns=50,
                       cap_ns=400) == 2


def test_best_fit_packs_deepest_that_fits():
    assert T.best_fit([1, 2, 3], [0, 300, 150, 0], now=100,
                      service_ns=100, cap_ns=300) == 1
    assert T.best_fit([1, 2], [0, 900, 800], now=100, service_ns=100,
                      cap_ns=100) == 2


def test_worst_fit_spreads_to_least_backlog():
    assert T.worst_fit([1, 2, 3], [0, 300, 150, 150], now=100,
                       service_ns=100, cap_ns=300) == 2


def test_policy_registry_is_the_public_surface():
    assert T.PLACEMENT_POLICIES == {"first_fit": T.first_fit,
                                    "best_fit": T.best_fit,
                                    "worst_fit": T.worst_fit}
    assert sorted(T.PLACEMENT_POLICIES) == sorted(J.PLACEMENT_POLICIES)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_on_random_fleets(policy):
    """500 random (candidates, backlog, now, service, cap) draws from a
    seed: the port's choice equals the JAX package's every time."""
    rng = np.random.default_rng(11)
    for _ in range(500):
        n = int(rng.integers(2, 9))
        busy = [int(x) for x in rng.integers(0, 2_000, n)]
        cands = sorted(int(x) for x in rng.choice(
            np.arange(n), size=int(rng.integers(1, n + 1)), replace=False))
        kw = dict(now=int(rng.integers(0, 1_500)),
                  service_ns=int(rng.integers(1, 400)),
                  cap_ns=int(rng.integers(1, 1_200)))
        assert T.PLACEMENT_POLICIES[policy](cands, busy, **kw) == \
            J.PLACEMENT_POLICIES[policy](cands, busy, **kw), (cands, busy, kw)


# ---------------------------------------------------------------------------
# threshold autoscaler
# ---------------------------------------------------------------------------


def test_autoscaler_target_thresholds_and_clamps():
    a = T.ThresholdAutoscaler(up_x1000=750, down_x1000=300, factor=2)
    assert a.target(800, 4, 2, 16) == 8
    assert a.target(800, 10, 2, 16) == 16
    assert a.target(200, 8, 2, 16) == 4
    assert a.target(200, 3, 2, 16) == 2
    assert a.target(500, 8, 2, 16) == 8
    b = J.ThresholdAutoscaler(up_x1000=750, down_x1000=300, factor=2)
    for util in range(0, 1_001, 25):
        for active in range(1, 17):
            assert a.target(util, active, 2, 16) == \
                b.target(util, active, 2, 16), (util, active)


def test_autoscaler_validation():
    with pytest.raises(ValueError, match="down < up"):
        T.ThresholdAutoscaler(up_x1000=300, down_x1000=300)
    with pytest.raises(ValueError, match="factor"):
        T.ThresholdAutoscaler(factor=1)
    with pytest.raises(ValueError, match="patience"):
        T.ThresholdAutoscaler(patience=0)


# ---------------------------------------------------------------------------
# diurnal arrivals
# ---------------------------------------------------------------------------


def test_diurnal_arrivals_equal_jax():
    kw = dict(base_gap_ns=1_000_000, peak_gap_ns=50_000,
              period_ns=100_000_000)
    for seed in (7, 8):
        got = list(T.diurnal_arrivals(500, seed=seed, **kw))
        assert got == list(J.diurnal_arrivals(500, seed=seed, **kw))
        assert all(b > a for a, b in zip(got, got[1:]))


# ---------------------------------------------------------------------------
# the fleet, cross-engine and cross-package
# ---------------------------------------------------------------------------


def fleet(M, policy="worst_fit"):
    n_pool, founding = 8, 4
    topo = M.Topology(n_hosts=n_pool + 1, n_cpus=2)
    topo.capacity_pool(range(founding + 1, n_pool + 1), 20_000_000,
                       stagger_ns=500_000)
    ready = [0] * founding + [20_000_000 + i * 500_000
                              for i in range(n_pool - founding)]
    wl = M.AutoscaledServe(
        arrivals=M.diurnal_arrivals(700, base_gap_ns=1_000_000,
                                    peak_gap_ns=60_000,
                                    period_ns=100_000_000, seed=5),
        n_pool=n_pool, ready_ns=ready, service_ns=400_000,
        min_active=founding, decide_every=8, probe_every=4,
        autoscaler=M.ThresholdAutoscaler(patience=2),
        placement=policy)
    return M.Simulation(topo, wl, M.Scenario("autoscale smoke"),
                        placement=wl.default_placement())


def test_autoscaled_fleet_engine_matrix_equals_jax():
    """barrier, async, dist:1 and dist:2 of the port agree bit for bit
    (the harness's bar, ``control`` included) and equal the JAX
    package's async run."""
    reports = assert_engines_agree(lambda: fleet(T), label="autoscale",
                                   worker_timeout=60.0)
    assert sorted(reports) == ["async", "barrier", "dist:1", "dist:2"]
    ref = fleet(J).run(engine="async")
    for eng, rep in reports.items():
        assert rep.control == ref.control, eng
        for f in CORE_FIELDS:
            assert getattr(rep, f) == getattr(ref, f), (eng, f)
    sec = ref.control["autoserve"]
    assert sec["served"] == 700
    joins = [e for e in ref.control["membership"] if e["event"] == "join"]
    assert [e["host"] for e in joins] == [5, 6, 7, 8]


@pytest.mark.parametrize("policy", ["first_fit", "best_fit"])
def test_fleet_control_section_equals_jax_per_policy(policy):
    got = fleet(T, policy).run(engine="async")
    want = fleet(J, policy).run(engine="async")
    assert got.control == want.control
    assert got.to_dict()["tasks"] == want.to_dict()["tasks"]


def test_autoscaled_serve_validation():
    arr = [1_000 * i for i in range(1, 20)]
    with pytest.raises(ValueError, match="placement"):
        T.AutoscaledServe(arrivals=arr, n_pool=4, placement="zany_fit")
    with pytest.raises(ValueError, match="min_active"):
        T.AutoscaledServe(arrivals=arr, n_pool=4, min_active=3,
                          ready_ns=[0, 0, 5_000, 5_000])


def test_control_report_absent_without_control_workload():
    wl = T.RackRing(n_racks=1, hosts_per_rack=2, n_iters=4,
                    compute_ns=5_000)
    topo = T.Topology.full_mesh(2, link=T.Topology(1).default_host_link,
                                n_cpus=2)
    r = T.Simulation(topo, wl, T.Scenario("plain"),
                     placement=wl.default_placement()).run(engine="async")
    assert r.control == {}
