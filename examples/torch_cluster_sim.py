"""Flagship example on the PyTorch port: simulate 512-chip training of
an assigned architecture BEFORE owning the pods (the paper's use case
pointed at ML systems), written against the declarative
`repro_torch.sim` facade.

The per-chip step cost comes from the multi-pod dry-run artifact (the
cost-derived vtime model; ``python -m repro_torch.launch.dryrun``
writes it); the ICI/DCN fabrics, placement, engines, and fault
injections are all declared, not hand-wired.  Then we do what
closed-form rooflines cannot: inject stragglers, chip/host deaths,
degraded links, and co-located interference, and read the end-to-end
effect off a structured SimReport.  Every engine here is a reference
engine on the host: nothing runs on the card, and the printed report is
the JAX example's, line for line, on the same step cost.

Run:  PYTHONPATH=src python examples/torch_cluster_sim.py [--arch qwen3_4b]
      (--smoke shrinks everything for CI)
"""
import argparse
import os

from repro_torch.core.cluster import (ClusterSpec, StepCost,
                                      analytic_step_ns)
from repro_torch.sim import (ChipRingTraining, DegradeLink, FailHost,
                             FailTask, ModeledServe, RackRing, Scenario,
                             Simulation, Straggler, Topology)


def resolve_cost(arch: str, variant: str = "") -> StepCost:
    try:
        cost = StepCost.from_dryrun(arch, "train_4k", "2x16x16",
                                    variant=variant)
        src = f"dry-run artifact{' (' + variant + ')' if variant else ''}"
    except Exception:
        try:
            cost = StepCost.from_dryrun(arch, "train_4k", "16x16",
                                        variant=variant)
            src = "single-pod dry-run artifact"
        except Exception:
            cost = StepCost(compute_ns=5_000_000, ici_bytes=50_000_000)
            src = "fallback constants (run launch/dryrun first)"
    cost.dcn_bytes = max(cost.ici_bytes // 8, 1)
    print(f"[{arch}] per-chip step cost from {src}: "
          f"compute={cost.compute_ns/1e6:.2f} ms, "
          f"ici={cost.ici_bytes/1e6:.1f} MB")
    return cost


def run(arch: str, n_steps: int = 4, variant: str = "",
        chips_per_pod: int = 256):
    spec = ClusterSpec(n_pods=2, chips_per_pod=chips_per_pod)
    cost = resolve_cost(arch, variant)
    analytic = analytic_step_ns(spec, cost)
    print(f"  closed-form step time: {analytic/1e6:.2f} ms")

    fail_chip = spec.n_chips * 3 // 5          # 300 of 512, scales down
    fail_step = n_steps // 2
    scenarios = [
        Scenario("baseline"),
        Scenario("straggler 2x on chip 7", (Straggler("chip7", 2.0),)),
        Scenario(f"chip {fail_chip} dies at step {fail_step}",
                 (FailTask(f"chip{fail_chip}", at_compute=fail_step),)),
    ]
    for scenario in scenarios:
        wl = ChipRingTraining(spec, cost, n_steps,
                              skew_bound_ns=2_000_000)
        report = Simulation(Topology.single_host(n_cpus=64), wl,
                            scenario).run()
        done = report.progress["train"]["done_steps"]
        print(f"  {scenario.name:28s}: "
              f"{report.vtime_ns/n_steps/1e6:9.2f} ms/step "
              f"(analytic x{report.vtime_ns/n_steps/analytic:.2f}) "
              f"steps done [{min(done)}..{max(done)}] "
              f"wall={report.wall_s:.1f}s msgs={report.messages} "
              f"[{report.status}]")


def run_multihost(n_racks: int = 2, hosts_per_rack: int = 2,
                  n_iters: int = 200, dist_workers: int = 2):
    """Orchestrate the simulation itself across hosts (paper §3.5):
    heterogeneous interconnect — 2us intra-rack, 50us cross-rack, with
    rack 1 computing 3x slower — under every orchestration engine.  The
    per-link-lookahead async engine lets each rack advance at its own
    link granularity instead of creeping at the global minimum latency;
    the dist engine shards the same hosts across real OS worker
    processes (`repro_torch.dist`) behind the same LBTS protocol.  All
    engines produce bit-identical simulation results."""
    print(f"\nmulti-host orchestration: {n_racks} racks x "
          f"{hosts_per_rack} hosts, 2us intra-rack / 50us cross-rack, "
          f"rack 1 is 3x slower")
    engines = ["barrier", "async"]
    if hasattr(os, "fork"):        # the dist engine forks OS workers
        engines.append("dist")
    results = {}
    for engine in engines:
        wl = RackRing(n_racks=n_racks, hosts_per_rack=hosts_per_rack,
                      n_iters=n_iters, skew_bound_ns=2_000_000)
        sim = Simulation(
            Topology.racks(n_racks, hosts_per_rack), wl,
            Scenario("imbalanced racks", wl.stragglers((1.0, 3.0))),
            placement=wl.default_placement(),
        )
        if engine == "dist":
            report = sim.run(engine="dist", n_workers=dist_workers,
                             on_deadlock="raise")
            label = f"dist x{report.n_workers}"
        else:
            report = sim.run(engine=engine, on_deadlock="raise")
            label = engine
        results[engine] = report
        print(f"  {label:8s}: {report.sync_rounds:5d} sync rounds, "
              f"{report.proxy_syncs:5d} proxy syncs, "
              f"{report.messages} msgs, sim={report.vtime_ns/1e6:.2f} ms, "
              f"wall={report.wall_s*1e3:.0f} ms")
    b, a = results["barrier"], results["async"]
    assert a.tasks == b.tasks, "engines must agree on simulation results"
    assert a.messages == b.messages
    if "dist" in results:
        d = results["dist"]
        assert a.tasks == d.tasks and a.messages == d.messages
        print(f"  identical results — even across {d.n_workers} OS "
              f"worker processes; async needed "
              f"{b.sync_rounds/a.sync_rounds:.2f}x fewer rounds than "
              f"barrier; dist determinism holds per-message "
              f"({d.cross_host_msgs} cross-host msgs replayed "
              f"bit-exactly)")
    else:
        print(f"  identical results; async needed "
              f"{b.sync_rounds/a.sync_rounds:.2f}x fewer rounds "
              f"(dist engine skipped: no fork on this platform)")
    return results


def run_scenarios(n_iters: int = 120, n_steps: int = 20,
                  multihost: bool = True):
    """Four scenarios only the declarative API can express.  The first
    two are multi-host (skipped with --skip-multihost); the last two
    are single-host."""
    print("\nscenario gallery (repro.sim injections):")

    if multihost:
        # 1. straggler + mid-run host failure: blast radius, not a crash
        wl = RackRing(n_iters=n_iters, skew_bound_ns=2_000_000)
        report = Simulation(
            Topology.racks(2, 2), wl,
            Scenario("straggler + host 3 dies",
                     (Straggler("w1", 2.0),
                      FailHost(host=3, at_vtime=n_iters * 4_000))),
            placement=wl.default_placement(), mode="async").run()
        done = report.progress["rack"]["iters_done"]
        print(f"  straggler + host death      : [{report.status}] "
              f"iters/worker {done} — the dead host's ring partner "
              f"wedges; the report records how far everyone got")

        # 2. mid-run degraded cross-rack link
        outs = {}
        for name, inj in (("healthy", ()),
                          ("link 0<->2 8x latency",
                           (DegradeLink(hosts=(0, 2), latency_factor=8.0,
                                        from_vtime=n_iters * 1_000),))):
            wl = RackRing(n_iters=n_iters, skew_bound_ns=2_000_000)
            outs[name] = Simulation(
                Topology.racks(2, 2), wl, Scenario(name, inj),
                placement=wl.default_placement(), mode="async").run()
        h, d = outs["healthy"], outs["link 0<->2 8x latency"]
        print(f"  degraded cross-rack link    : [{d.status}] sim time "
              f"{h.vtime_ns/1e6:.2f} -> {d.vtime_ns/1e6:.2f} ms "
              f"(+{(d.vtime_ns/h.vtime_ns - 1) * 100:.0f}% from the "
              f"slow link, same {d.messages} msgs)")

    # 3. co-located serving + training, coupled through simulated CPUs.
    # The tightly-synced train ring keeps low vtimes and wins the
    # virtual-time-ordered CPU queue, so serving takes the brunt — the
    # kind of asymmetry closed-form models miss.
    spec = ClusterSpec(n_pods=1, chips_per_pod=4)
    cost = StepCost(compute_ns=500_000, ici_bytes=1_000_000)

    def train():
        return ChipRingTraining(spec, cost, n_steps,
                                skew_bound_ns=5_000_000)

    def serve():
        return ModeledServe(n_clients=4, n_requests=n_steps,
                            service_ns=500_000)

    alone_t = Simulation(Topology.single_host(n_cpus=1), train(),
                         cpu_resource=True).run()
    alone_s = Simulation(Topology.single_host(n_cpus=1), serve(),
                         cpu_resource=True).run()
    both = Simulation(Topology.single_host(n_cpus=1),
                      [train(), serve()], cpu_resource=True).run()
    t0 = alone_t.tasks["chip0"]["vtime"]
    t1 = both.tasks["chip0"]["vtime"]
    s0 = alone_s.tasks["serve.client0"]["vtime"]
    s1 = both.tasks["serve.client0"]["vtime"]
    print(f"  co-located serve + train    : [{both.status}] train "
          f"{t0/n_steps/1e6:.2f} -> {t1/n_steps/1e6:.2f} ms/step "
          f"(+{(t1/t0 - 1) * 100:.0f}%), serving "
          f"{s0/1e6:.1f} -> {s1/1e6:.1f} ms "
          f"(+{(s1/s0 - 1) * 100:.0f}%) for "
          f"{sum(both.progress['serve']['served'])} requests")

    # 4. live memory-hierarchy cells (§3.3): four live ring workers
    # bound to CAT/MBA-style cells on one host — imperfect isolation
    # (bandwidth contention, working-set overflow, warm-slot
    # reconditioning) is folded into virtual time, and the report says
    # exactly where it went.
    def ring(cells=None):
        return RackRing(n_racks=1, hosts_per_rack=4, n_iters=n_iters,
                        compute_ns=50_000, live=True, cells=cells,
                        skew_bound_ns=2_000_000)

    iso = Simulation(Topology.single_host(n_cpus=1), ring()).run()
    topo = Topology.single_host(n_cpus=1)
    topo.cell("hot", ways=2, working_set_frac=0.7, bw_share=0.3,
              bw_demand=0.7, mem_frac=0.6)
    topo.cell("cold", ways=8, working_set_frac=0.3, bw_share=0.5,
              bw_demand=0.4, mem_frac=0.2)
    topo.cell_config(n_warm_slots=2, recondition_ns=20_000)
    celled = Simulation(
        topo, ring({"w0": "hot", "w1": "cold",
                    "w2": "hot", "w3": "cold"}),
        Scenario("co-located cells")).run()
    cs = celled.cells["0"]
    hot = cs["cells"]["hot"]
    print(f"  co-located memory cells     : [{celled.status}] "
          f"sim time {iso.vtime_ns/1e6:.2f} -> "
          f"{celled.vtime_ns/1e6:.2f} ms "
          f"(+{(celled.vtime_ns/iso.vtime_ns - 1) * 100:.0f}% from "
          f"imperfect isolation: {cs['interference_events']} "
          f"interference events, {cs['switches']} cell switches, "
          f"hot-cell slowdown up to "
          f"{hot['max_slowdown_ppm']/1e6:.2f}x)")


def run_live_recovery(dist_workers: int = 2):
    """Live recovery demo (replay mode): the marquee scenario — a real
    sharded Trainer recorded once under simulated time (the checked-in
    trace at tests/golden/live_recovery_trace.json; re-record with
    ``python -m repro_torch.live record``) takes a FailHost mid-run,
    restores the last committed checkpoint, elastically re-meshes, and resumes.
    Replaying the pinned costs reproduces the recorded vtimes
    bit-exactly on every engine — no model work happens here."""
    import pathlib

    from repro_torch.live import CostLedger
    from repro_torch.sim import live_recovery_sim, recovery_timeline

    trace = (pathlib.Path(__file__).parent.parent / "tests" / "golden"
             / "live_recovery_trace.json")
    print("\nlive trainer recovery (recorded-cost replay):")
    engines = ["barrier", "async"]
    if hasattr(os, "fork"):
        engines.append("dist")
    results = {}
    for engine in engines:
        sim = live_recovery_sim(CostLedger.replay(trace))
        if engine == "dist":
            report = sim.run(engine="dist", n_workers=dist_workers)
        else:
            report = sim.run(engine=engine)
        results[engine] = report
        assert report.status == "ok", report.detail
    base = results[engines[0]]
    for engine in engines[1:]:
        r = results[engine]
        assert (r.tasks, r.vtime_ns, r.live) == \
            (base.tasks, base.vtime_ns, base.live), \
            f"{engine} diverged from {engines[0]}"
    tl = recovery_timeline(base)
    names = {e["event"]: e["vtime"] for e in tl}
    print(f"  engines {'/'.join(engines)} bit-identical; recovery "
          f"timeline (vtime):")
    for e in tl:
        print(f"    {e['event']:8s} step {e['step']} at "
              f"{e['vtime']/1e6:10.2f} ms")
    assert names["detect"] < names["restore"] <= names["resumed"]
    print(f"  final step "
          f"{base.live['live_train']['tasks']['live.trainer']['final_step']}"
          f" reached after 1 restart, horizon "
          f"{base.vtime_ns/1e6:.0f} ms")
    return results


def run_live_serve(dist_workers: int = 2):
    """Live serving demo (replay mode): the real BatchServer recorded
    once under open-loop Poisson arrivals (the checked-in trace at
    tests/golden/live_serve_trace.json; re-record with ``python -m
    repro_torch.live record --scenario serve``).  Replaying the pinned
    per-wave prefill/decode costs reproduces the recorded request
    latencies bit-exactly on every engine — and the co-located trace
    (live trainer + live server sharing one §3.3 cell) replays the
    same way from one multi-driver ledger."""
    import pathlib

    from repro_torch.live import CostLedger
    from repro_torch.sim import (live_colocated_sim, live_serve_sim,
                                 serve_latency)

    golden = pathlib.Path(__file__).parent.parent / "tests" / "golden"
    print("\nlive serving (recorded-cost replay):")
    engines = ["barrier", "async"]
    if hasattr(os, "fork"):
        engines.append("dist")
    results = {}
    for engine in engines:
        sim = live_serve_sim(CostLedger.replay(
            golden / "live_serve_trace.json"))
        if engine == "dist":
            report = sim.run(engine="dist", n_workers=dist_workers)
        else:
            report = sim.run(engine=engine)
        results[engine] = report
        assert report.status == "ok", report.detail
    base = results[engines[0]]
    for engine in engines[1:]:
        r = results[engine]
        assert (r.tasks, r.vtime_ns, serve_latency(r)) == \
            (base.tasks, base.vtime_ns, serve_latency(base)), \
            f"{engine} diverged from {engines[0]}"
    sec = base.live["live_serve"]["tasks"]["serve.live"]
    lt = sec["latency_ns"]
    print(f"  engines {'/'.join(engines)} bit-identical; "
          f"{sec['requests']} requests in {sec['waves']} waves "
          f"(max wave batch {sec['max_wave_batch']})")
    print(f"  latency p50 {lt['p50']/1e6:.2f} ms, "
          f"p99 {lt['p99']/1e6:.2f} ms, max {lt['max']/1e6:.2f} ms; "
          f"max queue depth {sec['queue_depth']['max']}")
    assert lt["p50"] <= lt["p95"] <= lt["p99"] <= lt["max"]

    # co-located live train + live serve: one trace, two drivers, one
    # shared cell — the replay carries both the recovery timeline and
    # the serving percentiles
    colo = live_colocated_sim(CostLedger.replay(
        golden / "live_colocated_trace.json")).run(engine="async")
    assert colo.status == "ok", colo.detail
    clat = serve_latency(colo)
    final = colo.live["live_train"]["tasks"]["live.trainer"]["final_step"]
    cell = colo.cells["0"]["cells"]["colo"]
    print(f"  co-located train + serve    : [{colo.status}] one cell, "
          f"{cell['assigned']} live drivers, "
          f"{colo.cells['0']['switches']} cell switches; trainer "
          f"reached step {final}, serve p99 "
          f"{clat['p99']/1e6:.2f} ms")
    return results


def run_autoscale(dist_workers: int = 2, smoke: bool = False):
    """Membership + control-plane demo: a founding fleet rides a
    diurnal traffic wave — late pool hosts *join the cluster as
    simulation events* (``Topology.capacity_pool``), a threshold
    autoscaler boots and drains them from observed traffic, and every
    scaling decision plus the request-latency percentiles come out
    bit-identical on the in-process and multi-process engines."""
    from repro_torch.sim import (AutoscaledServe, ThresholdAutoscaler,
                                 diurnal_arrivals)

    n_pool, founding = (8, 4) if smoke else (16, 4)
    join0, stagger = 20_000_000, 500_000
    print(f"\ntraffic-driven control plane: {founding} founding hosts, "
          f"{n_pool - founding} joining mid-run, threshold autoscaler")

    def make():
        topo = Topology(n_hosts=n_pool + 1, n_cpus=2)
        topo.capacity_pool(range(founding + 1, n_pool + 1), join0,
                           stagger_ns=stagger)
        ready = [0] * founding + [join0 + i * stagger
                                  for i in range(n_pool - founding)]
        wl = AutoscaledServe(
            arrivals=diurnal_arrivals(700 if smoke else 1400,
                                      base_gap_ns=1_000_000,
                                      peak_gap_ns=60_000,
                                      period_ns=100_000_000, seed=5),
            n_pool=n_pool, ready_ns=ready, service_ns=400_000,
            min_active=founding, decide_every=8, probe_every=4,
            autoscaler=ThresholdAutoscaler(patience=2),
            placement="worst_fit")
        return Simulation(topo, wl, Scenario("diurnal autoscale"),
                          placement=wl.default_placement())

    a = make().run(engine="async")
    assert a.status == "ok", a.detail
    if hasattr(os, "fork"):
        d = make().run(engine="dist", n_workers=dist_workers)
        assert (d.tasks, d.vtime_ns, d.control) == \
            (a.tasks, a.vtime_ns, a.control), \
            "dist diverged from async on the control plane"
        print(f"  async == dist x{dist_workers} bit-identical "
              f"(including every autoscaler decision)")
    sec = a.control["autoserve"]
    moves = [(d_["vtime"], d_["from"], d_["to"])
             for d_ in sec["decisions"] if d_["from"] != d_["to"]]
    joins = [e for e in a.control["membership"] if e["event"] == "join"]
    print(f"  {len(joins)} hosts joined mid-run; fleet path: "
          + " -> ".join([str(founding)] + [str(t) for _, _, t in moves]))
    print(f"  {sec['served']} requests, boots={sec['boots']} "
          f"drains={sec['drains']} probes={sec['probes']['sent']}; "
          f"latency p50 {sec['latency_ns']['p50']/1e6:.2f} ms, "
          f"p99 {sec['latency_ns']['p99']/1e6:.2f} ms")
    return a


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--variant", default="",
                    help="optimized cost variant, e.g. gather_causal")
    ap.add_argument("--skip-multihost", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes for CI")
    args = ap.parse_args(argv)
    if args.smoke:
        run(args.arch, n_steps=2, variant=args.variant, chips_per_pod=16)
        if not args.skip_multihost:
            run_multihost(n_iters=60)
        run_scenarios(n_iters=40, n_steps=8,
                      multihost=not args.skip_multihost)
        if not args.skip_multihost:
            run_live_recovery()
            run_live_serve()
            run_autoscale(smoke=True)
    else:
        run(args.arch, args.steps, args.variant)
        if not args.skip_multihost:
            run_multihost()
        run_scenarios(multihost=not args.skip_multihost)
        if not args.skip_multihost:
            run_live_recovery()
            run_live_serve()
            run_autoscale()


if __name__ == "__main__":
    main()
