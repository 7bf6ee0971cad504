"""The port's fault-campaign harness (``repro_torch.sim.campaign``)
against the JAX package's (``repro.sim.campaign``), on the CPU.

Mirrors ``tests/test_campaign.py``.  Both packages run the same
registered bases and grids; the port's sweep fast path runs with
``device="cpu"`` (the plain versions of ``minskew`` and ``hub_route``).
Whole ``CampaignReport``s are compared through ``to_dict()`` without
the clock fields (``wall_s``, ``points_per_s``); a crash point's
traceback names each package's own files, so tracebacks are compared
by their last line, the exception.  Reproducer specs are compared as
``spec_to_bytes`` and replayed across the packages.  Everything here is
integer or JSON: the tolerance is bit-equality.

The port adds one rule to the reference: its fast path falls back to
per-point runs only on the simulator surface's own refusals
(``UnsupportedByEngine``, a ``ValueError``, ``RoundsExhausted``).  No
card, a failed kernel build, a failed launch or a kernel refusing its
tensors raises out of ``Campaign.run()``.
"""
import json
import os

import pytest
import torch

import repro.sim as J
import repro_torch.sim as T
from engine_harness import HAS_FORK
from repro.sim.campaign import spec_to_bytes as j_spec_to_bytes
from repro_torch.core.ipc import LinkSpec
from repro_torch.core.vtask import Compute, LiveCall
from repro_torch.kernels import _build
from repro_torch.sim.campaign import (OUTCOMES, REPRO_SCHEMA, classify,
                                      functional_fingerprint, main,
                                      spec_to_bytes)
from repro_torch.sim.topology import FabricSpec
from repro_torch.sim.vectorized import RoundsExhausted
from repro_torch.sim.workload import EndpointSpec, Program

CPU = {"device": "cpu"}
BASES = ("serve_smoke@v1", "rack_ring@v1")
HISTOGRAMS = {
    "serve_smoke@v1": ({"ok": 4, "deadlock": 6, "invariant-violation": 0,
                        "crash": 4, "divergence": 2}, "per-point"),
    "rack_ring@v1": ({"ok": 16, "deadlock": 8, "invariant-violation": 0,
                      "crash": 0, "divergence": 0}, "mixed"),
}


def _serve(scenario=None):
    return T.Simulation(T.Topology.single_host(n_cpus=4),
                        T.ModeledServe(n_clients=2, n_requests=4),
                        scenario or T.Scenario("serve base"))


def port_campaign(ref, **kw):
    ent = T.registry.entry(ref)
    return T.Campaign(ent.make, ent.grid(), seed=0, base_name=ent.ref,
                      **{**CPU, **kw})


def jax_campaign(ref, **kw):
    ent = J.registry.entry(ref)
    return J.Campaign(ent.make, ent.grid(), seed=0, base_name=ent.ref,
                      **kw)


def comparable(report) -> dict:
    d = report.to_dict()
    d.pop("wall_s")
    d.pop("points_per_s")
    for p in d["points"]:
        if "traceback" in p:
            assert p["traceback"].strip()
            p["traceback"] = p["traceback"].strip().splitlines()[-1]
    return d


@pytest.fixture(scope="module")
def reports():
    """{ref: (port report, JAX report)}, each run once, each package's
    vtask ids counted from 0: a deadlock's detail names its tasks by id,
    and the tests that ran before in this process made other tasks."""
    from repro.core.vtask import VTask as JVTask
    from repro_torch.core.vtask import VTask as TVTask
    out = {}
    for ref in BASES:
        TVTask._next_id = 0
        port = port_campaign(ref).run()
        JVTask._next_id = 0
        out[ref] = (port, jax_campaign(ref).run())
    return out


# -- grid --------------------------------------------------------------------


def test_grid_validates_axes():
    with pytest.raises(ValueError, match="unknown fault type"):
        T.FaultGrid(types=("warp",), targets=("a",), vtimes=(0,))
    with pytest.raises(ValueError, match="at least one"):
        T.FaultGrid(types=("straggler",), targets=(), vtimes=(0,))
    with pytest.raises(ValueError, match="count"):
        T.FaultGrid(types=("straggler",), targets=("a",), vtimes=(0,),
                    counts=(2,))


def test_grid_points_equal_jax():
    kw = dict(types=("straggler", "fail_task", "clock_skew"),
              targets=("w0", "w1", "w2"), vtimes=(0, 10), counts=(1, 2))
    got = T.FaultGrid(**kw).points(lambda t: 1)
    want = J.FaultGrid(**kw).points(lambda t: 1)
    assert len(got) == len(want) == 36
    assert [(p.index, p.type, p.target, p.vtime, p.count, p.scenario.name)
            for p in got] == \
        [(p.index, p.type, p.target, p.vtime, p.count, p.scenario.name)
         for p in want]
    from repro.sim.campaign import injection_to_dict as j_dict
    from repro_torch.sim.campaign import injection_to_dict as t_dict
    assert [[t_dict(i) for i in p.scenario.injections] for p in got] == \
        [[j_dict(i) for i in p.scenario.injections] for p in want]


# -- histograms, whole reports, reproducers ----------------------------------


@pytest.mark.parametrize("ref", BASES)
def test_histogram_and_fast_path(reports, ref):
    port, _ = reports[ref]
    histogram, fast_path = HISTOGRAMS[ref]
    assert port.histogram == histogram
    assert port.fast_path == fast_path
    assert sum(port.histogram.values()) == port.grid["n_points"]


def test_serve_smoke_point_outcomes(reports):
    port, _ = reports["serve_smoke@v1"]
    by_type = {}
    for p in port.points:
        by_type.setdefault(p["type"], set()).add(p["outcome"])
    assert by_type == {"bitflip": {"crash"}, "straggler": {"ok"},
                       "fail_task": {"deadlock"},
                       "fail_host": {"divergence", "deadlock"}}
    crash = next(p for p in port.points if p["outcome"] == "crash")
    assert "unknown endpoint" in crash["detail"] and crash["traceback"]


@pytest.mark.parametrize("ref", BASES)
def test_whole_report_equals_jax(reports, ref):
    port, jax = reports[ref]
    assert comparable(port) == comparable(jax)


@pytest.mark.parametrize("ref", BASES)
def test_reproducer_bytes_equal_jax(reports, ref):
    port, jax = reports[ref]
    assert port.reproducers
    assert [spec_to_bytes(s) for s in port.reproducers] == \
        [j_spec_to_bytes(s) for s in jax.reproducers]
    rerun = port_campaign(ref).run()
    assert [spec_to_bytes(s) for s in rerun.reproducers] == \
        [spec_to_bytes(s) for s in port.reproducers]


@pytest.mark.parametrize("ref", BASES)
def test_reproducers_replay_across_packages(reports, ref):
    """A spec minimized by one package replays to its recorded outcome
    in the other (and in its own)."""
    port, jax = reports[ref]
    t_make, j_make = T.registry.entry(ref).make, J.registry.entry(ref).make
    for spec in port.reproducers:
        assert spec["schema"] == REPRO_SCHEMA
        assert J.replay_spec(json.loads(spec_to_bytes(spec)),
                             j_make)[0] == spec["outcome"]
        assert T.replay_spec(spec, t_make)[0] == spec["outcome"]
    for spec in jax.reproducers:
        assert T.replay_spec(json.loads(j_spec_to_bytes(spec)),
                             t_make)[0] == spec["outcome"]


def test_minimizer_reaches_minimal_spec(reports):
    port, _ = reports["serve_smoke@v1"]
    crashes = [s for s in port.reproducers if s["outcome"] == "crash"]
    assert len(crashes) == 4
    assert len({spec_to_bytes(dict(s, point=None, trials=None))
                for s in crashes}) == 1
    assert crashes[0]["injections"] == [
        {"at_vtime": 0, "bit": 1, "task": "serve.client0",
         "type": "BitFlip"}]


def test_cli_smoke_on_cpu(capsys):
    assert main(["smoke", "--device", "cpu"]) == 0
    assert "campaign smoke ok: 16 points" in capsys.readouterr().out


@pytest.mark.skipif(not HAS_FORK, reason="dist engine needs os.fork")
def test_specs_identical_across_async_and_dist_campaigns():
    ent = T.registry.entry("rack_ring@v1")
    grid = T.FaultGrid(types=("fail_task", "straggler", "clock_skew"),
                       targets=("w0", "w1"), vtimes=(0,))
    r_async = T.Campaign(ent.make, grid, seed=1, engine="async",
                         base_name=ent.ref).run()
    r_dist = T.Campaign(ent.make, grid, seed=1, engine="dist",
                        n_workers=2, base_name=ent.ref,
                        worker_timeout=60.0).run()
    assert [p["outcome"] for p in r_async.points] == \
        [p["outcome"] for p in r_dist.points]
    assert r_async.reproducers
    assert [spec_to_bytes(s) for s in r_async.reproducers] == \
        [spec_to_bytes(s) for s in r_dist.reproducers]


def test_baseline_must_be_fault_free():
    def broken(scenario=None):
        return _serve(T.Scenario(
            "wedged base", (T.FailTask("serve.client0", at_vtime=0),)))
    grid = T.FaultGrid(types=("straggler",), targets=("serve.client0",),
                       vtimes=(0,))
    with pytest.raises(ValueError, match="baseline"):
        T.Campaign(broken, grid, **CPU).run()


def test_custom_invariants_rank_above_divergence():
    ent = T.registry.entry("serve_smoke@v1")

    def all_served(report):
        served = report.progress["serve"]["served"]
        return [] if all(v == 4 for v in served) else \
            [f"incomplete serve counts {served}"]

    grid = T.FaultGrid(types=("fail_host",), targets=("serve.client0",),
                       vtimes=(0,))
    report = T.Campaign(ent.make, grid, invariants=all_served,
                        base_name=ent.ref, **CPU).run(minimize=False)
    assert report.points[0]["outcome"] == "invariant-violation"
    assert "incomplete serve" in report.points[0]["detail"]


def test_report_json_round_trip(reports):
    port, _ = reports["serve_smoke@v1"]
    d = json.loads(port.to_json())
    assert d["schema"] == "campaign_report/v1"
    assert set(d["histogram"]) == set(OUTCOMES)
    assert d["grid"]["shape"] == [4, 2, 2, 1]
    assert len(d["points"]) == d["grid"]["n_points"] == 16
    assert d["wall_s"] >= 0 and d["points_per_s"] > 0


def test_classify_exposes_fingerprint_fields():
    fp = functional_fingerprint(_serve().run())
    assert set(fp) == {"status", "tasks", "progress", "messages",
                       "bytes"}
    assert all("vtime" not in t for t in fp["tasks"].values())
    assert classify(_serve().run(), fp, lambda r: []) == ("ok", "")


# -- fault containment: a point that kills its OS worker ---------------------


class _Fragile(T.Workload):
    """Two live workers whose step result, when bit-flipped, hard-kills
    the owning OS worker process (in-process runs raise instead)."""

    name = "fragile"

    def __init__(self):
        self.main_pid = os.getpid()

    def programs(self):
        def mk(i):
            def make_body(eps):
                def body():
                    v = yield LiveCall(lambda: 0, cost_ns=1_000)
                    if v:
                        if os.getpid() != self.main_pid:
                            os._exit(17)
                        raise RuntimeError("corrupted live result")
                    yield Compute(10_000)
                return body()
            return make_body
        return [Program(name=f"k{i}", make_body=mk(i), kind="live",
                        endpoints=(EndpointSpec(f"k{i}.ep", "fab"),))
                for i in range(2)]

    def fabrics(self):
        return [FabricSpec("fab", LinkSpec())]


@pytest.mark.skipif(not HAS_FORK, reason="dist engine needs os.fork")
def test_dist_worker_death_is_contained_and_campaign_continues():
    def make_sim(scenario=None):
        return T.Simulation(T.Topology.racks(1, 2), _Fragile(),
                            scenario or T.Scenario("fragile base"),
                            placement={"k0": 0, "k1": 1})

    grid = T.FaultGrid(types=("bitflip", "straggler"),
                       targets=("k0", "k1"), vtimes=(0,))
    report = T.Campaign(make_sim, grid, seed=0, engine="dist",
                        n_workers=2, worker_timeout=30.0).run()
    outcomes = {(p["type"], p["target"]): p["outcome"]
                for p in report.points}
    assert outcomes == {("bitflip", "k0"): "crash",
                        ("bitflip", "k1"): "crash",
                        ("straggler", "k0"): "ok",
                        ("straggler", "k1"): "ok"}
    killed = next(p for p in report.points if p["outcome"] == "crash")
    assert "DistWorkerError" in killed["detail"] and killed["traceback"]
    assert {s["outcome"] for s in report.reproducers} == {"crash"}


@pytest.mark.skipif(not HAS_FORK, reason="dist engine needs os.fork")
def test_worker_error_frame_carries_remote_traceback():
    ent = T.registry.entry("serve_smoke@v1")
    grid = T.FaultGrid(types=("bitflip",), targets=("serve.client0",),
                       vtimes=(0,), knobs={"bit": 2})
    report = T.Campaign(ent.make, grid, seed=0, engine="dist",
                        base_name=ent.ref,
                        worker_timeout=30.0).run(minimize=False)
    [point] = report.points
    assert point["outcome"] == "crash"
    assert "DistWorkerError" in point["detail"]
    assert "unknown endpoint serve.cli4" in point["traceback"]


# -- the device: the fast path never hides the card or the kernels -----------


def test_no_device_without_cuda_raises(monkeypatch):
    """``device=None`` means CUDA: without a card the campaign raises
    out of ``run()`` instead of reporting the points per-point."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ent = T.registry.entry("rack_ring@v1")
    camp = T.Campaign(ent.make, ent.grid(), seed=0, base_name=ent.ref)
    with pytest.raises(RuntimeError, match="CUDA"):
        camp.run()


def _failing_sweep(exc, device="cpu"):
    def sweep(self, axis, **kw):
        assert kw.get("device") == device
        raise exc
    return sweep


@pytest.mark.parametrize("exc", [
    RuntimeError("minskew kernel launch failed: CUDA error 700"),
    _build.KernelArgumentError("minskew: vtime on cpu, expected cuda:0"),
], ids=["launch", "kernel-arguments"])
def test_kernel_failures_propagate(monkeypatch, exc):
    monkeypatch.setattr(T.Simulation, "sweep", _failing_sweep(exc))
    with pytest.raises(type(exc), match=str(exc).split(":")[0]):
        port_campaign("rack_ring@v1").run(minimize=False)


def test_failed_build_propagates(monkeypatch, tmp_path):
    """The sweep's first kernel launch builds the sources; a build that
    fails (here: no ``nvcc``) raises out of the campaign."""
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built")

    def sweep(self, axis, **kw):
        _build.load("minskew")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(T.Simulation, "sweep", sweep)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        port_campaign("rack_ring@v1").run(minimize=False)


def test_exhausted_rounds_fall_back_as_jax_does(monkeypatch):
    """``RoundsExhausted`` is the surface's refusal: the campaign runs
    every point on the reference engine, and its whole report equals
    the JAX package's when the JAX sweep raises the same."""
    exc = RoundsExhausted("vectorized sweep variant 0: max_rounds=1 "
                          "exhausted before the fixpoint")
    assert isinstance(exc, RuntimeError)
    monkeypatch.setattr(T.Simulation, "sweep", _failing_sweep(exc))
    monkeypatch.setattr(J.Simulation, "sweep", _failing_sweep(
        RuntimeError(str(exc)), device=None))
    report = port_campaign("rack_ring@v1").run()
    assert report.fast_path == "per-point"
    assert report.histogram == HISTOGRAMS["rack_ring@v1"][0]
    assert comparable(report) == comparable(jax_campaign(
        "rack_ring@v1").run())
