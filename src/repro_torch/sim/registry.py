"""Versioned, named scenario registry with pinned goldens.

gem5's reproducible-standard-experiments argument applied to this
repo: every showcase scenario — the example gallery, the live replay
stack, campaign bases, campaign-*derived* minimized reproducers — is a
named, versioned entry anyone can re-run bit-identically::

    from repro_torch.sim import registry
    report = registry.load("live_recovery@v1").run()

Refs are ``name@vN``; a bare ``name`` resolves to the latest version.
Registering the same (name, version) twice is an error — a changed
scenario gets a *new version*, never a silent mutation; its golden is
pinned alongside.

Entries with a ``grid`` are **campaign bases**: their factory accepts a
Scenario override, so ``python -m repro_torch.sim.campaign run --base <ref>``
can sweep a fault grid over them and replay reproducer specs against
them.

Goldens live in ``src/repro/sim/goldens/registry.json``: for each ref
the standalone *outcome* (``ok``/``deadlock``/``invariant-violation``/
``crash`` — no baseline, so no divergence class here) plus, for runs
that complete, the canonical timing-bearing report subset (the same
fields the gallery golden pins).  ``python -m repro_torch.sim.registry
check`` re-runs every entry against its pin (CI); ``--regen`` rewrites
after a reviewed change.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cluster import ClusterSpec, StepCost
from repro_torch.sim.campaign import (FaultGrid, default_invariants,
                                spec_scenario)
from repro_torch.sim.control import AutoscaledServe, ThresholdAutoscaler
from repro_torch.sim.scenario import BitFlip, ClockSkew, DegradeLink, \
    FailHost, Scenario, Straggler
from repro_torch.sim.simulation import Simulation
from repro_torch.sim.topology import Topology
from repro_torch.sim.workloads import (ChipRingTraining, ModeledServe,
                                 RackRing, diurnal_arrivals)

_ROOT = pathlib.Path(__file__).resolve().parents[3]
GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "goldens"
GOLDEN = GOLDEN_DIR / "registry.json"
_TRACE_DIR = _ROOT / "tests" / "golden"

#: the canonical (deterministic, machine-independent) report subset —
#: kept field-for-field in sync with tests/test_golden_trace.py
CANONICAL_FIELDS = ("scenario", "status", "n_hosts", "vtime_ns",
                    "messages", "bytes", "tasks", "progress", "cells")

#: gallery sizes (shared with tests/test_golden_trace.py)
N_ITERS = 40
N_STEPS = 8


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str
    version: int
    description: str
    #: fresh-Simulation factory; ``make(scenario)`` overrides the
    #: entry's scenario (campaign bases) — entries that cannot take an
    #: override (pinned live replays) raise ValueError on one
    make: Callable[..., Simulation]
    #: default fault grid — present on campaign bases only
    grid: Optional[Callable[[], FaultGrid]] = None
    tags: Tuple[str, ...] = ()

    @property
    def ref(self) -> str:
        return f"{self.name}@v{self.version}"


_REGISTRY: Dict[str, Dict[int, Entry]] = {}


def register(name: str, version: int, description: str,
             make: Callable[..., Simulation], *,
             grid: Optional[Callable[[], FaultGrid]] = None,
             tags: Tuple[str, ...] = ()) -> Entry:
    versions = _REGISTRY.setdefault(name, {})
    if version in versions:
        raise ValueError(
            f"{name}@v{version} is already registered — a changed "
            f"scenario needs a new version, not a re-register")
    ent = Entry(name, version, description, make, grid=grid, tags=tags)
    versions[version] = ent
    return ent


def entry(ref: str) -> Entry:
    """Resolve ``name`` (latest version) or ``name@vN`` (exact)."""
    name, _, ver = ref.partition("@")
    versions = _REGISTRY.get(name)
    if not versions:
        raise KeyError(f"unknown scenario {ref!r}; registered: "
                       f"{names()}")
    if not ver:
        return versions[max(versions)]
    if not ver.startswith("v") or not ver[1:].isdigit():
        raise KeyError(f"bad version in {ref!r} (want name@vN)")
    v = int(ver[1:])
    if v not in versions:
        raise KeyError(
            f"no version v{v} of {name!r}; have "
            f"{sorted(f'v{x}' for x in versions)}")
    return versions[v]


def load(ref: str, scenario: Optional[Scenario] = None) -> Simulation:
    """A fresh, unbuilt Simulation for ``ref`` (optionally with a
    scenario override, for campaign bases)."""
    ent = entry(ref)
    return ent.make(scenario) if scenario is not None else ent.make()


def names() -> List[str]:
    """Every registered ref, sorted (all versions)."""
    return sorted(e.ref for vs in _REGISTRY.values()
                  for e in vs.values())


def _no_override(ref: str, scenario) -> None:
    if scenario is not None:
        raise ValueError(
            f"{ref} pins its scenario (recorded live trace); it is "
            f"not a campaign base")


# ---------------------------------------------------------------------------
# gallery entries (the source of truth for tests/test_golden_trace.py)
# ---------------------------------------------------------------------------


def _straggler_host_death(scenario=None):
    wl = RackRing(n_iters=N_ITERS, skew_bound_ns=2_000_000)
    return Simulation(
        Topology.racks(2, 2), wl,
        scenario or Scenario(
            "straggler + host 3 dies",
            (Straggler("w1", 2.0),
             FailHost(host=3, at_vtime=N_ITERS * 4_000))),
        placement=wl.default_placement())


def _degraded_link(scenario=None):
    wl = RackRing(n_iters=N_ITERS, skew_bound_ns=2_000_000)
    return Simulation(
        Topology.racks(2, 2), wl,
        scenario or Scenario(
            "link 0<->2 8x latency",
            (DegradeLink(hosts=(0, 2), latency_factor=8.0,
                         from_vtime=N_ITERS * 1_000),)),
        placement=wl.default_placement())


def _colocated_serve_train(scenario=None):
    spec = ClusterSpec(n_pods=1, chips_per_pod=4)
    cost = StepCost(compute_ns=500_000, ici_bytes=1_000_000)
    return Simulation(
        Topology.single_host(n_cpus=1),
        [ChipRingTraining(spec, cost, N_STEPS,
                          skew_bound_ns=5_000_000),
         ModeledServe(n_clients=4, n_requests=N_STEPS,
                      service_ns=500_000)],
        scenario or Scenario("co-located serve + train"),
        cpu_resource=True)


def _colocated_cells(scenario=None):
    cells = {"w0": "hot", "w1": "cold", "w2": "hot", "w3": "cold"}
    wl = RackRing(n_racks=1, hosts_per_rack=4, n_iters=N_ITERS,
                  compute_ns=50_000, live=True, cells=cells,
                  skew_bound_ns=2_000_000)
    topo = Topology.single_host(n_cpus=1)
    topo.cell("hot", ways=2, working_set_frac=0.7, bw_share=0.3,
              bw_demand=0.7, mem_frac=0.6)
    topo.cell("cold", ways=8, working_set_frac=0.3, bw_share=0.5,
              bw_demand=0.4, mem_frac=0.2)
    topo.cell_config(n_warm_slots=2, recondition_ns=20_000)
    return Simulation(topo, wl, scenario or Scenario("co-located cells"))


def _live_recovery(scenario=None):
    from repro_torch.live import CostLedger
    from repro_torch.sim.live import live_recovery_sim
    _no_override("live_recovery@v1", scenario)
    return live_recovery_sim(
        CostLedger.replay(_TRACE_DIR / "live_recovery_trace.json"))


def _live_serve(scenario=None):
    from repro_torch.live import CostLedger
    from repro_torch.sim.live import live_serve_sim
    _no_override("live_serve@v1", scenario)
    return live_serve_sim(
        CostLedger.replay(_TRACE_DIR / "live_serve_trace.json"))


def _live_colocated(scenario=None):
    from repro_torch.live import CostLedger
    from repro_torch.sim.live import live_colocated_sim
    _no_override("live_colocated@v1", scenario)
    return live_colocated_sim(
        CostLedger.replay(_TRACE_DIR / "live_colocated_trace.json"))


def _diurnal_autoscale(scenario=None):
    # the membership marquee: a 4-host founding fleet rides one full
    # diurnal traffic period up to the 64-host pool and back down,
    # with the 60 late hosts joining the cluster as simulation events
    # (capacity_pool) just before the first scale-up decision needs
    # them.  Every decision is made by the control-plane workload from
    # observed simulated traffic — nothing here scripts the 4->64->4
    # ramp, the autoscaler discovers it.
    n_pool, founding = 64, 4
    join0, stagger = 100_000_000, 400_000
    topo = Topology(n_hosts=n_pool + 1, n_cpus=2)
    topo.capacity_pool(range(founding + 1, n_pool + 1), join0,
                       stagger_ns=stagger)
    ready = [0] * founding + [join0 + i * stagger
                              for i in range(n_pool - founding)]
    wl = AutoscaledServe(
        arrivals=diurnal_arrivals(3600, base_gap_ns=1_000_000,
                                  peak_gap_ns=12_500,
                                  period_ns=400_000_000, seed=7),
        n_pool=n_pool, ready_ns=ready, service_ns=800_000,
        min_active=founding, decide_every=8, probe_every=8,
        autoscaler=ThresholdAutoscaler(patience=3),
        placement="worst_fit")
    return Simulation(topo, wl,
                      scenario or Scenario("diurnal autoscale 4->64->4"),
                      placement=wl.default_placement())


# ---------------------------------------------------------------------------
# campaign bases + fault-injection showcases
# ---------------------------------------------------------------------------


def _rack_ring(scenario=None):
    wl = RackRing(n_racks=2, hosts_per_rack=2, n_iters=6,
                  compute_ns=5_000, cross_every=2,
                  skew_bound_ns=100_000)
    return Simulation(Topology.racks(2, 2), wl,
                      scenario or Scenario("rack ring base"),
                      placement=wl.default_placement())


def _rack_ring_grid() -> FaultGrid:
    return FaultGrid(types=("fail_task", "straggler", "clock_skew"),
                     targets=("w0", "w1", "w2", "w3"),
                     vtimes=(0, 20_000))


def _serve_smoke(scenario=None):
    return Simulation(Topology.single_host(n_cpus=4),
                      ModeledServe(n_clients=2, n_requests=4),
                      scenario or Scenario("serve base"))


def _serve_smoke_grid() -> FaultGrid:
    # type x target x vtime, planted to hit four outcome classes: a
    # bit-2 flip of a client's request payload routes the server's
    # response to a nonexistent endpoint (crash), fail_task starves
    # the server's fixed request count (deadlock), fail_host silently
    # zeroes progress (divergence), straggler only shifts time (ok)
    return FaultGrid(types=("bitflip", "fail_task", "fail_host",
                            "straggler"),
                     targets=("serve.client0", "serve.client1"),
                     vtimes=(0, 100_000),
                     knobs={"bit": 2})


def _bitflip_serve(scenario=None):
    return _serve_smoke(scenario or Scenario(
        "bit-2 flip of client0's first request payload",
        (BitFlip("serve.client0", at_step=0, bit=2),)))


def _clock_skew_rack(scenario=None):
    return _rack_ring(scenario or Scenario(
        "host 1 receive clock skewed +25us @ 100ppm",
        (ClockSkew(host=1, offset_ns=25_000, drift_ppm=100),)))


def _serve_flip_min(scenario=None):
    # campaign-derived: the minimized reproducer the serve_smoke
    # campaign emits for its planted bitflip crash, checked in as a
    # fault_repro/v1 spec and replayed as a first-class entry
    spec = json.loads((GOLDEN_DIR / "serve_flip_min.json").read_text())
    return _serve_smoke(scenario or spec_scenario(spec))


register("straggler_host_death", 1,
         "rack ring: straggler + mid-run host death (deadlock)",
         _straggler_host_death, tags=("gallery",))
register("degraded_link", 1,
         "rack ring: mid-run 8x cross-rack link degradation",
         _degraded_link, tags=("gallery",))
register("colocated_serve_train", 1,
         "serve + train sharing one host's simulated CPUs",
         _colocated_serve_train, tags=("gallery",))
register("colocated_cells", 1,
         "live rack ring on shared §3.3 memory-hierarchy cells",
         _colocated_cells, tags=("gallery",))
register("live_recovery", 1,
         "real sharded trainer: FailHost -> checkpoint restore "
         "(recorded trace replay)", _live_recovery,
         tags=("gallery", "live"))
register("live_serve", 1,
         "real BatchServer under open-loop Poisson arrivals "
         "(recorded trace replay)", _live_serve,
         tags=("gallery", "live"))
register("live_colocated", 1,
         "live train + live serve on one shared cell "
         "(recorded trace replay)", _live_colocated,
         tags=("gallery", "live"))
register("rack_ring", 1,
         "2x2 rack-ring campaign base (fail/straggle/skew grid)",
         _rack_ring, grid=_rack_ring_grid, tags=("campaign",))
register("serve_smoke", 1,
         "closed-loop serve campaign base with a planted bitflip "
         "crash", _serve_smoke, grid=_serve_smoke_grid,
         tags=("campaign",))
register("bitflip_serve", 1,
         "SDC showcase: bit-2 payload flip crashes hub routing",
         _bitflip_serve, tags=("fault",))
register("clock_skew_rack", 1,
         "per-host ingress clock skew on the rack ring",
         _clock_skew_rack, tags=("fault",))
register("serve_flip_min", 1,
         "campaign-derived minimized reproducer of the serve bitflip "
         "crash", _serve_flip_min, tags=("fault", "campaign-derived"))
register("diurnal_autoscale", 1,
         "65-host diurnal fleet: 60 hosts join mid-run, threshold "
         "autoscaler rides traffic 4->64->4", _diurnal_autoscale,
         tags=("gallery", "control"))


# ---------------------------------------------------------------------------
# pinned goldens
# ---------------------------------------------------------------------------


def canonical(report) -> dict:
    d = report.to_dict()
    out = {k: d[k] for k in CANONICAL_FIELDS}
    out["perf"] = {"sync_rounds": report.sync_rounds,
                   "proxy_syncs": report.proxy_syncs}
    if report.live:
        # live sections (recovery timelines) are golden-pinned too;
        # omitted when empty so pre-live rows stay byte-identical
        out["live"] = d["live"]
    if any(k != "membership" for k in report.control):
        # control-plane sections (autoscaler decisions, latency
        # percentiles, the membership timeline) are deterministic and
        # golden-pinned — but a bare membership timeline (FailHost
        # leave churn with no control workload) stays out so the
        # pre-membership fault rows remain byte-identical
        out["control"] = d["control"]
    return out


def golden_record(ref: str) -> dict:
    """Run ``ref`` standalone and reduce it to its pinned form: the
    outcome class (no baseline here, so no divergence) and, when the
    run completes, the canonical report subset."""
    try:
        report = load(ref).run()
    except Exception as e:                  # noqa: BLE001 - recorded
        return {"outcome": "crash",
                "detail": f"{type(e).__name__}: {e}",
                "canonical": None}
    violations = default_invariants(report)
    if violations:
        outcome = "invariant-violation"
    elif report.status == "deadlock":
        outcome = "deadlock"
    else:
        outcome = "ok"
    return {"outcome": outcome, "detail": "",
            "canonical": canonical(report)}


def check(refs: Optional[List[str]] = None, *,
          regen: bool = False) -> List[str]:
    """Replay every registered scenario against its pinned golden;
    returns a list of human-readable failures (empty = green).  With
    ``regen=True``, rewrite the golden file instead."""
    refs = refs or names()
    records = {ref: golden_record(ref) for ref in refs}
    if regen:
        GOLDEN_DIR.mkdir(exist_ok=True)
        existing = json.loads(GOLDEN.read_text()) \
            if GOLDEN.exists() else {}
        existing.update(records)
        GOLDEN.write_text(json.dumps(existing, indent=1,
                                     sort_keys=True) + "\n")
        return []
    if not GOLDEN.exists():
        return [f"no golden file {GOLDEN}; generate with "
                f"python -m repro_torch.sim.registry check --regen"]
    golden = json.loads(GOLDEN.read_text())
    failures = []
    for ref, rec in records.items():
        want = golden.get(ref)
        if want is None:
            failures.append(f"{ref}: no pinned golden (--regen after "
                            f"review)")
        elif rec != want:
            diffs = [k for k in rec if rec.get(k) != want.get(k)]
            failures.append(f"{ref}: diverged from pin on {diffs}\n"
                            f"  got: {rec.get(diffs[0]) if diffs else rec}\n"
                            f" want: {want.get(diffs[0]) if diffs else want}")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.registry",
        description="versioned scenario registry")
    sub = ap.add_subparsers(dest="cmd", required=True)
    lp = sub.add_parser("list")
    lp.add_argument("--json", action="store_true",
                    help="machine-readable listing (one object per "
                         "ref: name/version/tags/campaign-base flag)")
    p = sub.add_parser("check", help="replay every entry against its "
                                     "pinned golden")
    p.add_argument("refs", nargs="*", help="subset of refs (default "
                                           "all)")
    p.add_argument("--regen", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "list":
        if args.json:
            rows = [{"ref": ref, "name": entry(ref).name,
                     "version": entry(ref).version,
                     "description": entry(ref).description,
                     "tags": list(entry(ref).tags),
                     "campaign_base": entry(ref).grid is not None}
                    for ref in names()]
            print(json.dumps(rows, indent=1))
            return 0
        for ref in names():
            e = entry(ref)
            kind = "campaign-base" if e.grid else ",".join(e.tags)
            print(f"{ref:26s} [{kind}] {e.description}")
        return 0
    failures = check(args.refs or None, regen=args.regen)
    if args.regen:
        print(f"wrote {GOLDEN}")
        return 0
    for f in failures:
        print(f"FAIL {f}")
    print(f"registry check: {len(names()) if not args.refs else len(args.refs)} "
          f"refs, {len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
