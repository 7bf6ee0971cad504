"""Cluster model: TPU pods as LiveStack components.

Maps a production mesh (16x16 chips/pod, 2 pods) onto the simulation
substrate: every chip is a vtask; ICI links and the DCN are hubs; one
synchronization scope per collective group.  The per-chip compute/step
durations come from the dry-run roofline terms (``results/dryrun``) — the
cost-derived vtime model of DESIGN.md — optionally calibrated by really
executing a reduced-config step on the host (live calibration).

Since the `repro_torch.sim` facade landed, this module holds the *specs*
(:class:`ClusterSpec`, :class:`StepCost`, :class:`StragglerSpec`) plus
two thin adapters kept for the legacy call sites:
``build_training_cluster`` and ``build_rack_cluster`` construct their
simulations through :class:`repro_torch.sim.Simulation` and are verified
bit-identical to direct hand-wiring (``tests/test_sim_equivalence.py``).
New code should use `repro_torch.sim` directly — declarative
topology/placement/workloads/fault injection, structured
:class:`~repro_torch.sim.report.SimReport` results.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Callable, Optional, Tuple

from repro_torch.core.ipc import LinkSpec
from repro_torch.core.vtime import SEC, CostModel

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun"


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    n_pods: int = 1
    chips_per_pod: int = 256
    ici_bw_Bps: float = 50e9            # per link
    ici_lat_ns: int = 1_000
    dcn_bw_Bps: float = 25e9
    dcn_lat_ns: int = 10_000
    cost: CostModel = CostModel()

    @property
    def n_chips(self) -> int:
        return self.n_pods * self.chips_per_pod


@dataclasses.dataclass
class StepCost:
    """Per-chip per-step cost (from the dry-run artifact or analytic)."""
    compute_ns: int
    ici_bytes: int                      # per-chip wire bytes per step
    dcn_bytes: int = 0

    @staticmethod
    def from_dryrun(arch: str, shape: str, mesh: str = "16x16",
                    cost: CostModel = CostModel(),
                    variant: str = "") -> "StepCost":
        """Prefer the trip-count-corrected costs (results/costs, see
        launch/costcount.py); fall back to the raw dry-run record.
        ``variant`` selects an optimized §Perf configuration."""
        suffix = f"__{variant}" if variant else ""
        corrected = (RESULTS.parent / "costs"
                     / f"{arch}__{shape}__{mesh}{suffix}.json")
        if corrected.exists():
            rec = json.loads(corrected.read_text())
            if rec.get("status") == "ok":
                c = rec["corrected"]
                compute_ns = int(max(c["flops"] / cost.peak_flops,
                                     c["bytes"] / cost.hbm_bw) * SEC)
                return StepCost(compute_ns=compute_ns,
                                ici_bytes=int(c["coll_bytes"]))
        f = RESULTS / f"{arch}__{shape}__{mesh}.json"
        rec = json.loads(f.read_text())
        if rec["status"] != "ok":
            raise ValueError(f"dry-run cell {f.name}: {rec['status']}")
        flops = rec["flops_per_chip"]
        bts = rec["bytes_per_chip"]
        coll = rec["collectives"]
        ici = sum(v for k, v in coll.items() if k != "count")
        compute_ns = int(max(flops / cost.peak_flops,
                             bts / cost.hbm_bw) * SEC)
        return StepCost(compute_ns=compute_ns, ici_bytes=int(ici))


@dataclasses.dataclass
class StragglerSpec:
    chip: int                           # straggling chip index
    slowdown: float = 2.0               # compute multiplier


def build_training_cluster(
    spec: ClusterSpec,
    step_cost: StepCost,
    n_steps: int,
    *,
    skew_bound_ns: int = 1_000_000,
    stragglers: Tuple[StragglerSpec, ...] = (),
    fail_at: Optional[Tuple[int, int]] = None,   # (chip, step) -> dies
    live_step_fn: Optional[Callable] = None,     # executed natively per step
    chips_per_host: int = 0,                     # 0 = all on one scheduler
    mode: str = "async",                         # engine when sharded
):
    """Build a data-parallel training simulation (adapter over
    `repro_torch.sim`).

    ``chips_per_host == 0`` keeps every chip on one Scheduler (the
    legacy shape).  ``chips_per_host > 0`` shards chips across
    ``ceil(n_chips / chips_per_host)`` orchestrated hosts: placement
    routes through ``Orchestrator.co_locate`` on the ring-traffic
    matrix (so ring neighbors co-locate), host pairs that share a pod
    get an ICI-class interconnect and pod-disjoint pairs a DCN-class
    one, and ``mode`` picks the orchestration engine.

    Returns ``(engine, tasks, ctx)`` where ``engine`` is a Scheduler
    (single-host) or an Orchestrator (sharded) — both have ``.run()``.
    ``ctx`` additionally carries the built ``repro_torch.sim.Simulation`` as
    ``ctx["sim"]``.
    """
    from repro_torch.sim import (ChipRingTraining, FailTask, Scenario,
                           Simulation, Straggler, Topology)

    wl = ChipRingTraining(spec, step_cost, n_steps,
                          skew_bound_ns=skew_bound_ns,
                          live_step_fn=live_step_fn)
    # legacy semantics: duplicate straggler specs for one chip override
    # (dict last-wins), they do not compound like stacked injections
    slowdown = {s.chip: s.slowdown for s in stragglers}
    injections = tuple(Straggler(f"chip{c}", m)
                       for c, m in slowdown.items())
    if fail_at is not None:
        injections += (FailTask(f"chip{fail_at[0]}",
                                at_compute=fail_at[1]),)
    scenario = Scenario("training", injections)

    if chips_per_host <= 0:
        sim = Simulation(Topology.single_host(n_cpus=64), wl, scenario,
                         mode="single")
    else:
        from repro_torch.core.orchestrator import Orchestrator

        n_hosts = math.ceil(spec.n_chips / chips_per_host)
        # placement first (routed through co_locate on the ring-traffic
        # matrix), then host links derived from where chips actually
        # landed: hosts sharing a pod get an ICI-class interconnect,
        # pod-disjoint hosts a DCN-class one.  Deriving from the real
        # placement (not an assumed contiguous sharding) keeps the link
        # classes consistent even when heavy cross-pod traffic makes
        # co_locate merge leaders across pods.
        placement = Orchestrator.co_locate(
            [f"chip{c}" for c in range(spec.n_chips)], wl.traffic(),
            n_hosts, chips_per_host)
        host_pods = {}
        for c in range(spec.n_chips):
            host_pods.setdefault(placement[f"chip{c}"], set()).add(
                c // spec.chips_per_pod)
        topo = Topology(n_hosts=n_hosts,
                        n_cpus=max(1, min(64, chips_per_host)))
        ici = LinkSpec(bandwidth_bps=spec.ici_bw_Bps * 8,
                       latency_ns=spec.ici_lat_ns)
        dcn = LinkSpec(bandwidth_bps=spec.dcn_bw_Bps * 8,
                       latency_ns=spec.dcn_lat_ns)
        for a in range(n_hosts):
            for b in range(a + 1, n_hosts):
                shared_pod = (host_pods.get(a, set())
                              & host_pods.get(b, set()))
                topo.link(a, b, ici if shared_pod else dcn)
        sim = Simulation(topo, wl, scenario, mode=mode,
                         placement=placement)
    sim.build()
    engine = sim.scheduler if sim.scheduler is not None \
        else sim.orchestrator
    ctx = {"scope": sim.scopes[0] if len(sim.scopes) == 1
           else sim.scopes,
           "hubs": list(sim.hubs.values()),
           "done_steps": wl.done_steps,
           "endpoints": [sim.endpoints[f"chip{c}"]
                         for c in range(spec.n_chips)],
           "sim": sim}
    return engine, sim.tasks, ctx


def build_rack_cluster(
    *,
    n_racks: int = 2,
    hosts_per_rack: int = 2,
    n_iters: int = 200,
    compute_ns: int = 5_000,
    msg_bytes: int = 4096,
    cross_every: int = 20,
    intra_link: LinkSpec = LinkSpec(bandwidth_bps=80e9 * 8,
                                    latency_ns=2_000),
    cross_link: LinkSpec = LinkSpec(bandwidth_bps=25e9 * 8,
                                    latency_ns=50_000),
    rack_slowdown: Tuple[float, ...] = (),
    skew_bound_ns: int = 0,
    mode: str = "async",
):
    """Heterogeneous-latency multi-host topology (paper §3.5), adapter
    over `repro_torch.sim`: a :class:`~repro_torch.sim.workloads.RackRing` workload
    on a :meth:`~repro_torch.sim.topology.Topology.racks` topology, one worker
    pinned per host.  ``rack_slowdown`` becomes per-worker Straggler
    injections (imbalanced racks).

    Returns (orchestrator, tasks, ctx); ``ctx["sim"]`` carries the
    built Simulation.
    """
    from repro_torch.sim import RackRing, Scenario, Simulation, Topology

    wl = RackRing(n_racks=n_racks, hosts_per_rack=hosts_per_rack,
                  n_iters=n_iters, compute_ns=compute_ns,
                  msg_bytes=msg_bytes, cross_every=cross_every,
                  skew_bound_ns=skew_bound_ns)
    topo = Topology.racks(n_racks, hosts_per_rack, intra_link,
                          cross_link, n_cpus=4)
    sim = Simulation(topo, wl,
                     Scenario("rack", wl.stragglers(rack_slowdown)),
                     mode=mode, placement=wl.default_placement())
    sim.build()
    ctx = {"hubs": list(sim.hubs.values()),
           "iters_done": wl.iters_done,
           "endpoints": [sim.endpoints[f"w{h}"]
                         for h in range(wl.n_workers)],
           "sim": sim}
    return sim.orchestrator, sim.tasks, ctx


def analytic_step_ns(spec: ClusterSpec, step_cost: StepCost) -> int:
    """Closed-form per-step time (the validation target for the sim)."""
    comm = step_cost.ici_bytes / spec.ici_bw_Bps * SEC + spec.ici_lat_ns
    dcn = (step_cost.dcn_bytes / spec.dcn_bw_Bps * SEC + spec.dcn_lat_ns
           if spec.n_pods > 1 else 0)
    return int(step_cost.compute_ns + comm + dcn)
