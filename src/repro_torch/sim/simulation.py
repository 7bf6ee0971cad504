"""Simulation: materialize (Topology, Workloads, Scenario) and run.

Single entry point of the facade.  ``build()`` turns the declarative
pieces into the concrete substrate — Scheduler or Orchestrator, hubs,
endpoints, scopes, injection wrappers — in a deterministic order, so a
facade-built simulation is bit-identical to careful hand-wiring (see
``tests/test_sim_equivalence.py``).  ``run()`` executes it and returns
a :class:`~repro_torch.sim.report.SimReport`.

Engine selection: ``mode="auto"`` runs single-host topologies on a
plain :class:`~repro_torch.core.scheduler.Scheduler` and multi-host ones on
the async :class:`~repro_torch.core.orchestrator.Orchestrator`; ``"single"``,
``"async"``, and ``"barrier"`` force an engine (the orchestrator modes
work for ``n_hosts == 1`` too, which the legacy rack adapter relies
on).

Placement: ``placement="auto"`` routes component->host assignment
through ``Orchestrator.co_locate`` on the merged workload traffic
matrix; a dict pins components explicitly; ``"round_robin"`` spreads
them.

Cells (§3.3): ``Topology.cell`` declarations are validated against
every ``Program.cell`` / ``Interference.cell`` reference at build time
(an undeclared name is an error, not a silent no-op), instantiated as
one :class:`~repro_torch.core.cells.CellManager` per host that ends up
hosting cell-bound components — identically in all four engines,
including the dist workers' forked replicas — and reported back as
``SimReport.cells``.  ``cells="auto"`` additionally derives a default
cell for every program co-located with another program or an
interference load (and for the loads themselves), so co-location
implies a controlled resource domain without per-program declarations.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.cells import CellManager
from repro_torch.core.ipc import Endpoint, Hub, Message
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.scheduler import DeadlockError, Scheduler
from repro_torch.core.scope import Scope
from repro_torch.core.vtask import Compute, State, VTask
from repro_torch.sim.report import HostReport, SimReport, _jsonable
from repro_torch.sim.scenario import (BitFlip, ClockSkew, DegradeLink,
                                FailHost, FailTask, Interference,
                                JoinHost, Scenario, Straggler,
                                TaskHandle, bitflip_body,
                                fail_gated_body, scaled_body)
from repro_torch.sim.topology import CellSpec, FabricSpec, Topology
from repro_torch.sim.workload import Program, Workload

PlacementSpec = Union[str, Dict[str, int]]


def _load_body(bursts: int, burst_ns: int):
    for _ in range(bursts):
        yield Compute(burst_ns)


class Simulation:
    def __init__(self, topology: Topology,
                 workloads: Union[Workload, Sequence[Workload]],
                 scenario: Optional[Scenario] = None, *,
                 placement: PlacementSpec = "auto",
                 mode: str = "auto",
                 capacity: Optional[int] = None,
                 cpu_resource: bool = False,
                 cells: str = "declared"):
        self.topology = topology
        self.workloads: List[Workload] = (
            [workloads] if isinstance(workloads, Workload)
            else list(workloads))
        self.scenario = scenario or Scenario()
        self.placement_spec = placement
        self.capacity = capacity
        self.cpu_resource = cpu_resource
        if cells not in ("declared", "auto"):
            raise ValueError(f"cells must be 'declared' or 'auto', "
                             f"got {cells!r}")
        self.cells_mode = cells
        if mode == "auto":
            mode = "single" if topology.n_hosts == 1 else "async"
        if mode not in ("single", "async", "barrier"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "single" and topology.n_hosts > 1:
            raise ValueError("mode='single' needs a 1-host topology")
        self.mode = mode
        # populated by build()
        self.scheduler: Optional[Scheduler] = None
        self.orchestrator: Optional[Orchestrator] = None
        self.hubs: Dict[str, Hub] = {}          # fabric- or host-keyed
        self.endpoints: Dict[str, Endpoint] = {}
        self.tasks: List[VTask] = []            # workload programs, in order
        self.task_by_name: Dict[str, VTask] = {}
        self.scopes: List[Scope] = []
        self.placement: Dict[str, int] = {}
        self.cell_managers: Dict[int, CellManager] = {}
        #: merged membership declarations (Topology.join + JoinHost
        #: injections): host -> join vtime; resolved by build()
        self.joins: Dict[int, int] = {}
        #: single-engine membership log (leave events from FailHost);
        #: multi-host engines read the orchestrator's timeline instead
        self._membership_events: List[dict] = []
        self._built = False

    # -- introspection helpers ----------------------------------------------
    def _programs(self) -> List[Tuple[Workload, Program]]:
        out = []
        seen = set()
        for wl in self.workloads:
            for prog in wl.programs():
                if prog.name in seen:
                    raise ValueError(f"duplicate program {prog.name!r}")
                seen.add(prog.name)
                out.append((wl, prog))
        return out

    def _fabrics(self) -> List[FabricSpec]:
        out: List[FabricSpec] = []
        by_name: Dict[str, FabricSpec] = {}
        for wl in self.workloads:
            for fab in wl.fabrics():
                prev = by_name.get(fab.name)
                if prev is None:
                    by_name[fab.name] = fab
                    out.append(fab)
                elif prev.link != fab.link:
                    raise ValueError(
                        f"fabric {fab.name!r} declared with two links")
        return out

    def _merged_traffic(self) -> Dict[Tuple[str, str], float]:
        traffic: Dict[Tuple[str, str], float] = {}
        for wl in self.workloads:
            for pair, w in wl.traffic().items():
                traffic[pair] = traffic.get(pair, 0.0) + w
        return traffic

    def _resolve_placement(self, names: List[str]) -> Dict[str, int]:
        n_hosts = self.topology.n_hosts
        spec = self.placement_spec
        if n_hosts == 1 and not isinstance(spec, dict):
            return {n: 0 for n in names}
        if isinstance(spec, dict):
            missing = [n for n in names if n not in spec]
            if missing:
                raise ValueError(f"placement missing {missing}")
            bad = [n for n in names
                   if not 0 <= spec[n] < n_hosts]
            if bad:
                raise ValueError(f"placement out of range for {bad}")
            return {n: spec[n] for n in names}
        if spec == "round_robin":
            return {n: i % n_hosts for i, n in enumerate(names)}
        if spec == "auto":
            capacity = self.capacity or max(
                1, math.ceil(len(names) / n_hosts))
            return Orchestrator.co_locate(
                names, self._merged_traffic(), n_hosts, capacity)
        raise ValueError(f"unknown placement {spec!r}")

    # -- cells (§3.3) --------------------------------------------------------
    def _resolve_interference(self) -> List[Tuple[Interference, int]]:
        """Validate each Interference injection and pin it to a host
        (declaration order preserved: the i-th entry becomes vtask
        ``load{i}``)."""
        out: List[Tuple[Interference, int]] = []
        n_hosts = self.topology.n_hosts
        for inj in self.scenario.injections:
            if not isinstance(inj, Interference):
                continue
            host = inj.host
            if host is not None and not 0 <= host < n_hosts:
                raise ValueError(
                    f"Interference host {host} outside "
                    f"0..{n_hosts - 1}")
            if host is None:
                if inj.co_locate_with is None:
                    raise ValueError(
                        "Interference needs host or co_locate_with")
                if inj.co_locate_with not in self.placement:
                    raise ValueError(
                        f"Interference co_locate_with targets "
                        f"unknown program {inj.co_locate_with!r}")
                host = self.placement[inj.co_locate_with]
            out.append((inj, host))
        return out

    def _resolve_cells(self, programs,
                       inter_targets: List[Tuple[Interference, int]]
                       ) -> Tuple[Dict[str, str], List[Optional[str]]]:
        """Map programs and interference loads to cells, derive auto
        cells for co-located placements (``cells="auto"``), reject
        undeclared references, and construct the per-host CellManagers
        (``self.cell_managers``)."""
        topo = self.topology
        cell_specs: Dict[str, CellSpec] = dict(topo.cells)
        cell_of: Dict[str, str] = {p.name: p.cell for _, p in programs
                                   if p.cell}
        load_cells: List[Optional[str]] = [inj.cell
                                           for inj, _ in inter_targets]
        if self.cells_mode == "auto":
            # co-location implies a controlled resource domain: every
            # program sharing a host with another program or an
            # interference load gets a default cell, as does each load
            prog_hosts: Dict[int, List[str]] = {}
            for _, p in programs:
                prog_hosts.setdefault(
                    self.placement[p.name], []).append(p.name)
            load_hosts = {h for _, h in inter_targets}
            for h in sorted(prog_hosts):
                if len(prog_hosts[h]) < 2 and h not in load_hosts:
                    continue
                for n in prog_hosts[h]:
                    if n not in cell_of:
                        auto = f"cell:{n}"
                        cell_specs.setdefault(auto, CellSpec(name=auto))
                        cell_of[n] = auto
            for i in range(len(load_cells)):
                if load_cells[i] is None:
                    auto = f"cell:load{i}"
                    cell_specs.setdefault(auto, CellSpec(name=auto))
                    load_cells[i] = auto
        # a Program.cell naming an undeclared cell used to be a silent
        # no-op (slowdown 1.0, switch cost 0 — see repro_torch.core.cells);
        # through the facade, that masks misconfiguration, so it is a
        # build-time error.
        bad = [(p.name, p.cell) for _, p in programs
               if p.cell and p.cell not in cell_specs]
        bad += [(f"Interference#{i}", c)
                for i, c in enumerate(load_cells)
                if c and c not in cell_specs]
        if bad:
            raise ValueError(
                f"undeclared cells referenced (declare them with "
                f"Topology.cell(name, ...)): {bad}")
        self.cell_managers = {}
        if cell_specs:
            need: Dict[int, set] = {}
            for n, c in cell_of.items():
                need.setdefault(self.placement[n], set()).add(c)
            for i, (_inj, h) in enumerate(inter_targets):
                if load_cells[i]:
                    need.setdefault(h, set()).add(load_cells[i])
            for h in sorted(need):
                cm = CellManager(host=h, **topo.cell_knobs)
                for name, spec in cell_specs.items():  # decl. order
                    if name in need[h]:
                        cm.add(spec.to_cell())
                self.cell_managers[h] = cm
        return cell_of, load_cells

    # -- membership ----------------------------------------------------------
    def _resolve_joins(self) -> Dict[int, int]:
        """Merge ``Topology.join`` declarations with :class:`JoinHost`
        injections into one host -> join-vtime map.  JoinHost gets the
        same validation as Topology.join (in range, not host 0, vtime
        >= 1); a host declared in both places — or twice — is a
        conflict, not a silent override."""
        joins: Dict[int, int] = dict(self.topology.joins)
        n_hosts = self.topology.n_hosts
        for inj in self.scenario.injections:
            if not isinstance(inj, JoinHost):
                continue
            if not 0 <= inj.host < n_hosts:
                raise ValueError(f"JoinHost host {inj.host} outside "
                                 f"0..{n_hosts - 1}")
            if inj.host == 0:
                raise ValueError("host 0 is the founding member and "
                                 "cannot join late")
            if inj.at_vtime < 1:
                raise ValueError(f"JoinHost vtime must be >= 1, got "
                                 f"{inj.at_vtime}")
            if inj.host in joins:
                raise ValueError(
                    f"host {inj.host} already has a join event at "
                    f"vtime {joins[inj.host]}")
            joins[inj.host] = inj.at_vtime
        return joins

    # -- scenario fault plan -------------------------------------------------
    def _resolve_fault_plan(self, names: List[str]
                            ) -> Tuple[Dict[str, float],
                                       Dict[str, FailTask]]:
        """Resolve Straggler/FailTask/FailHost injections to per-task
        compute scale factors and fail points.  Failure precedence (see
        tests/test_scenario_edges.py): an explicit FailTask always wins
        over a FailHost expansion regardless of declaration order; two
        explicit FailTasks on one program is an error; overlapping
        FailHosts on one host keep the earliest death.  Shared by
        ``build()`` (generator wrappers) and the vectorized compiler
        (fail_pc/fail_vtime arrays), so both engines kill identically.
        Requires ``self.placement`` (FailHost expansion)."""
        scale: Dict[str, float] = {}
        fails: Dict[str, FailTask] = {}
        explicit_fails: set = set()
        n_hosts = self.topology.n_hosts
        for inj in self.scenario.injections:
            if isinstance(inj, Straggler):
                scale[inj.task] = scale.get(inj.task, 1.0) * inj.slowdown
            elif isinstance(inj, FailTask):
                if inj.task in explicit_fails:
                    raise ValueError(f"two failures for {inj.task!r}")
                fails[inj.task] = inj
                explicit_fails.add(inj.task)
            elif isinstance(inj, FailHost):
                if not 0 <= inj.host < n_hosts:
                    raise ValueError(
                        f"FailHost host {inj.host} outside "
                        f"0..{n_hosts - 1}")
                for n, h in self.placement.items():
                    if h != inj.host or n in explicit_fails:
                        continue
                    prev = fails.get(n)
                    if prev is None or inj.at_vtime < prev.at_vtime:
                        fails[n] = FailTask(n, at_vtime=inj.at_vtime)
        unknown = [(t, "Straggler") for t in scale if t not in names] + \
                  [(t, "FailTask") for t in fails if t not in names]
        if unknown:
            raise ValueError(f"injections target unknown programs "
                             f"{unknown}; available: {sorted(names)}")
        return scale, fails

    def _resolve_bitflips(self, names: List[str]
                          ) -> Dict[str, List[BitFlip]]:
        """Validate BitFlip injections (known target, exactly one
        trigger, sane bit) and group them per task, declaration order
        preserved."""
        out: Dict[str, List[BitFlip]] = {}
        for inj in self.scenario.injections:
            if not isinstance(inj, BitFlip):
                continue
            if inj.task not in names:
                raise ValueError(
                    f"BitFlip targets unknown program {inj.task!r}; "
                    f"available: {sorted(names)}")
            if (inj.at_step is None) == (inj.at_vtime is None):
                raise ValueError(
                    f"BitFlip on {inj.task!r} needs exactly one of "
                    f"at_step= or at_vtime=")
            if inj.bit < 0:
                raise ValueError(f"BitFlip bit must be >= 0, "
                                 f"got {inj.bit}")
            out.setdefault(inj.task, []).append(inj)
        return out

    def _install_clock_skews(self, ep_host: Dict[str, int]) -> None:
        """Validate ClockSkew injections and install one ingress hook
        per injection on every hub: messages delivered to an endpoint
        on the skewed host arrive offset + drift later.  Non-negative
        offset/drift is a *build-time* requirement — a negative skew
        would let a message undercut the link lookahead and unsound
        the conservative cross-host windows."""
        n_hosts = self.topology.n_hosts
        for inj in self.scenario.injections:
            if not isinstance(inj, ClockSkew):
                continue
            if not 0 <= inj.host < n_hosts:
                raise ValueError(
                    f"ClockSkew host {inj.host} outside "
                    f"0..{n_hosts - 1}")
            if inj.offset_ns < 0 or inj.drift_ppm < 0:
                raise ValueError(
                    f"ClockSkew may only delay (conservative "
                    f"lookahead): offset_ns={inj.offset_ns}, "
                    f"drift_ppm={inj.drift_ppm}")

            def hook(msg, _state, inj=inj):
                if ep_host.get(msg.dst) != inj.host:
                    return 0
                return inj.offset_ns + \
                    (inj.drift_ppm * msg.send_vtime) // 1_000_000

            for hub in self.hubs.values():
                hub.add_ingress_hook(hook)

    # -- build ---------------------------------------------------------------
    def build(self) -> "Simulation":
        if self._built:
            return self
        # run-scoped workload state (progress arrays, timelines, replay
        # cursors) is cleared before anything is wired, so a Workload
        # instance reused across simulations starts every run fresh —
        # identically in all engines and every forked dist replica
        for wl in self.workloads:
            wl.reset()
        topo = self.topology
        programs = self._programs()
        fabrics = self._fabrics()
        names = [p.name for _, p in programs]
        self.placement = self._resolve_placement(names)

        # §3.3 cells: resolve Interference targets early (their hosts
        # feed auto-cell derivation and per-host manager construction),
        # validate every Program.cell / Interference.cell reference
        # against the Topology declarations, and build one CellManager
        # per host that hosts cell-bound components — before the engine
        # exists, so every engine (and every forked dist replica) gets
        # identical per-host cell state.
        inter_targets = self._resolve_interference()
        cell_of, load_cells = self._resolve_cells(programs,
                                                  inter_targets)

        # membership: merged Topology.join + JoinHost map (host 0 and
        # 1-host topologies can never join late, so `single` implies
        # an empty map — the validation above guarantees it)
        self.joins = self._resolve_joins()

        # engine + hubs
        single = self.mode == "single"
        fabric_eps: Dict[str, List[str]] = {f.name: [] for f in fabrics}
        if single:
            self.scheduler = Scheduler(n_cpus=topo.n_cpus,
                                       cells=self.cell_managers.get(0))
            for fab in fabrics:
                self.hubs[fab.name] = Hub(fab.name, fab.link)

            def hub_for(fabric: str, host: int) -> Hub:
                return self.hubs[fabric]
        else:
            self.orchestrator = Orchestrator(
                n_hosts=topo.n_hosts, n_cpus=topo.n_cpus,
                dcn_link=topo.default_host_link, mode=self.mode,
                cells=self.cell_managers or None,
                joins=self.joins or None)
            for (a, b), link in topo.host_links.items():
                self.orchestrator.connect_hosts(a, b, link)
            host_hubs: Dict[int, Hub] = {}
            if fabrics:
                host_fab = fabrics[0]
                for h in range(topo.n_hosts):
                    hub = Hub(f"{host_fab.name}{h}", host_fab.link)
                    host_hubs[h] = self.orchestrator.add_hub(h, hub)
                    self.hubs[hub.name] = hub

            def hub_for(fabric: str, host: int) -> Hub:
                if fabric not in fabric_eps:
                    raise KeyError(f"unknown fabric {fabric!r}")
                return host_hubs[host]

        # scenario: per-task fault plan (see _resolve_fault_plan)
        scale, fails = self._resolve_fault_plan(names)
        bitflips = self._resolve_bitflips(names)

        # membership churn half of FailHost: the kills themselves go
        # through the fault wrappers resolved above; here the leave is
        # logged on the membership timeline.  Deliberately no lookahead
        # rebuild — a dead host goes quiescent, and quiescent hosts
        # already stop gating peers — so window schedules (and pinned
        # golden sync_rounds) are unchanged.
        for inj in self.scenario.injections:
            if isinstance(inj, FailHost):
                if self.orchestrator is not None:
                    self.orchestrator.retire_host(inj.host, inj.at_vtime)
                else:
                    self._membership_events.append(
                        {"event": "leave", "host": inj.host,
                         "vtime": inj.at_vtime})

        # workload interception (Program.on_fail): a program may observe
        # its resolved failure at build time — "kill" keeps the normal
        # early-close wrapper, "survive" suppresses it (the workload
        # models the reaction itself, e.g. a live program's recovery)
        for wl, prog in programs:
            if prog.on_fail is not None and prog.name in fails:
                verdict = prog.on_fail(fails[prog.name])
                if verdict == "survive":
                    del fails[prog.name]
                elif verdict != "kill":
                    raise ValueError(
                        f"program {prog.name!r}: on_fail returned "
                        f"{verdict!r} (expected 'kill' or 'survive')")

        # spawn, in declaration order (determinism: vtask ids, scope and
        # task-list order all follow this loop)
        ep_host: Dict[str, int] = {}
        for wl, prog in programs:
            host = self.placement[prog.name]
            eps: Dict[str, Endpoint] = {}
            for es in prog.endpoints:
                if es.name in self.endpoints:
                    raise ValueError(f"duplicate endpoint {es.name!r}")
                ep = hub_for(es.fabric, host).attach(Endpoint(es.name))
                eps[es.name] = ep
                self.endpoints[es.name] = ep
                ep_host[es.name] = host
                fabric_eps[es.fabric].append(es.name)
            body = prog.make_body(eps)
            handles: List[TaskHandle] = []
            # innermost: data corruption (the flip happens before a
            # straggler scale or a fail gate sees the action stream)
            for bf in bitflips.get(prog.name, ()):
                bf_handle = TaskHandle()
                handles.append(bf_handle)
                body = bitflip_body(body, bf_handle, bf.at_step,
                                    bf.at_vtime, bf.bit)
            if prog.name in scale:
                body = scaled_body(body, scale[prog.name])
            if prog.name in fails:
                f = fails[prog.name]
                handle = TaskHandle()
                handles.append(handle)
                body = fail_gated_body(body, handle, f.at_compute,
                                       f.at_vtime)
            task = VTask(prog.name, body, kind=prog.kind)
            for h in handles:
                h.task = task
            if prog.handle is not None:
                prog.handle.task = task
            sched = self._sched_for(host)
            join_at = self.joins.get(host)
            if join_at is not None:
                # a joiner's programs start at its join vtime: the
                # host's earliest possible action is >= join_at, which
                # is what makes the membership epoch's add-only
                # lookahead attach conservative (Orchestrator.add_host)
                task.vtime = join_at
            sched.spawn(task)
            if prog.name in cell_of:
                # assign (not just a VTask backref): registers the task
                # in the host manager's live-cell multiset
                sched.cells.assign(task, cell_of[prog.name])
            self.tasks.append(task)
            self.task_by_name[prog.name] = task

        # non-host fabrics on shared host hubs: per-endpoint-pair link
        # overrides (skipped when the link equals the host fabric's —
        # indistinguishable)
        if not single and fabrics:
            host_link = fabrics[0].link
            for fab in fabrics[1:]:
                if fab.link == host_link:
                    continue
                members = fabric_eps[fab.name]
                for i, a in enumerate(members):
                    for b in members[i + 1:]:
                        for h in {ep_host[a], ep_host[b]}:
                            host_hubs[h].connect(a, b, fab.link)

        # scopes
        names_by_wl: Dict[int, List[str]] = {}
        for wl, prog in programs:
            names_by_wl.setdefault(id(wl), []).append(prog.name)
        for wl in self.workloads:
            wl_names = names_by_wl.get(id(wl), [])
            for ss in wl.scopes():
                members = [self.task_by_name[m]
                           for m in (ss.members or tuple(wl_names))]
                if single:
                    s = Scope(ss.name, ss.skew_bound_ns)
                    for t in members:
                        t.join(s)
                    self.scopes.append(s)
                else:
                    self.scopes.extend(self.orchestrator.global_scope(
                        ss.name, members, skew_bound_ns=ss.skew_bound_ns))

        # link degradation hooks + interference loads (targets resolved
        # and validated before the engine was built; spawn order — and
        # therefore vtask ids — matches the old interleaved loop)
        for inj in self.scenario.injections:
            if isinstance(inj, DegradeLink):
                self._install_degrade(inj, fabrics, fabric_eps, ep_host)
        self._install_clock_skews(ep_host)
        for i, (inj, host) in enumerate(inter_targets):
            load = VTask(f"load{i}",
                         _load_body(inj.bursts, inj.burst_ns),
                         kind="modeled")
            sched = self._sched_for(host)
            join_at = self.joins.get(host)
            if join_at is not None:
                load.vtime = join_at     # loads wait for the join too
            sched.spawn(load)
            if load_cells[i]:
                sched.cells.assign(load, load_cells[i])

        if self.cpu_resource:
            for sched in self._scheds():
                sched.cpu_resource = True

        self._built = True
        return self

    def _scheds(self) -> List[Scheduler]:
        if self.scheduler is not None:
            return [self.scheduler]
        return [self.orchestrator.hosts[h]
                for h in sorted(self.orchestrator.hosts)]

    def _sched_for(self, host: int) -> Scheduler:
        if self.scheduler is not None:
            return self.scheduler
        return self.orchestrator.host(host)

    def _install_degrade(self, inj: DegradeLink,
                         fabrics: List[FabricSpec],
                         fabric_eps: Dict[str, List[str]],
                         ep_host: Dict[str, int]) -> None:
        if (inj.fabric is None) == (inj.hosts is None):
            raise ValueError("DegradeLink needs exactly one of "
                             "fabric= or hosts=")
        if inj.fabric is not None:
            fab = next((f for f in fabrics if f.name == inj.fabric), None)
            if fab is None:
                raise ValueError(f"unknown fabric {inj.fabric!r}")
            members = set(fabric_eps[inj.fabric])
            extra = inj.extra_ns + int(
                (inj.latency_factor - 1.0) * fab.link.latency_ns)

            def match(msg: Message) -> bool:
                return msg.src in members and msg.dst in members
        else:
            a, b = inj.hosts
            n_hosts = self.topology.n_hosts
            bad = [h for h in (a, b) if not 0 <= h < n_hosts]
            if bad:
                # a pair outside the topology used to silently no-op
                # (the match predicate never fired); through the facade
                # that masks misconfiguration, so it is a build error
                raise ValueError(
                    f"DegradeLink hosts {inj.hosts} outside "
                    f"0..{n_hosts - 1}")
            pair_link = self.topology.host_links.get(
                (min(a, b), max(a, b)), self.topology.default_host_link)
            extra = inj.extra_ns + int(
                (inj.latency_factor - 1.0) * pair_link.latency_ns)

            def match(msg: Message) -> bool:
                return {ep_host.get(msg.src), ep_host.get(msg.dst)} \
                    == {a, b}
        if extra < 0:
            raise ValueError("DegradeLink may only add latency "
                             "(conservative lookahead)")

        for hub in self.hubs.values():
            def hook(msg, _state, hub=hub):
                # sender-side only: a forwarded cross-host message runs
                # the destination hub's hooks too — charge it once
                if msg.src not in hub.endpoints:
                    return 0
                if msg.send_vtime < inj.from_vtime or not match(msg):
                    return 0
                return extra
            hub.add_hook(hook)

    # -- run -----------------------------------------------------------------
    def run(self, *, engine: Optional[str] = None, n_workers: int = 2,
            on_deadlock: str = "report",
            max_rounds: Optional[int] = None,
            worker_timeout: float = 120.0,
            tick_ns: Optional[int] = None,
            pallas: str = "auto",
            verify: bool = False,
            device=None) -> SimReport:
        """Execute and return a SimReport.

        ``engine`` overrides the construction-time ``mode``:
        ``"single"``/``"async"``/``"barrier"`` pick an in-process
        engine; ``engine="dist"`` is not ported yet and raises
        ``NotImplementedError`` (``n_workers``/``worker_timeout`` keep
        its signature).  ``engine="vectorized"`` compiles the
        scenario to int32 tensors and runs the round loop on ``device``
        (`repro_torch.sim.vectorized`; None means ``"cuda"``, and there
        is no quiet CPU fallback): bit-identical on the exact tier
        (auto tick), within a declared tolerance under an explicit
        ``tick_ns``; inadmissible scenarios raise
        :class:`~repro_torch.sim.vectorized.UnsupportedByEngine`.
        ``max_rounds`` bounds the engine's dispatch rounds / sync
        epochs; None keeps each engine's own (generous) default.
        ``tick_ns``/``pallas``/``verify`` (vectorized only):
        quantization tick override, kernel path ("auto": the CUDA
        kernels on a CUDA device, the plain versions on the CPU; "on";
        "off"), and a cross-check of the batched hub fan-out against
        the round loop."""
        if on_deadlock not in ("report", "raise"):
            raise ValueError(f"on_deadlock must be 'report' or 'raise', "
                             f"got {on_deadlock!r}")
        if engine == "vectorized":
            from repro_torch.sim.vectorized import run_vectorized_sim
            report = run_vectorized_sim(
                self, tick_ns=tick_ns, pallas=pallas,
                max_rounds=max_rounds, verify=verify, device=device)
            if report.status == "deadlock" and on_deadlock == "raise":
                raise DeadlockError(report.detail
                                    or "vectorized simulation wedged")
            return report
        if engine == "dist":
            raise NotImplementedError(
                "engine='dist' is not ported yet: repro_torch.dist is "
                "ROADMAP.md queue A, item 3")
        if engine is not None:
            if engine not in ("single", "async", "barrier"):
                raise ValueError(f"unknown engine {engine!r}")
            if engine == "single" and self.topology.n_hosts > 1:
                raise ValueError("engine='single' needs a 1-host "
                                 "topology")
            if self._built and engine != self.mode:
                raise ValueError(
                    f"already built with mode={self.mode!r}; "
                    f"cannot re-run as engine={engine!r}")
            self.mode = engine
        if not self._built:
            self.build()
        status, detail = "ok", ""
        detail_info: Dict[str, Any] = {}
        t0 = time.perf_counter()
        try:
            if self.scheduler is not None:
                if max_rounds is None:
                    self.scheduler.run()
                else:
                    self.scheduler.run(max_rounds=max_rounds)
            elif max_rounds is None:
                self.orchestrator.run()
            else:
                self.orchestrator.run(max_epochs=max_rounds)
        except DeadlockError as e:
            if on_deadlock == "raise":
                raise
            status, detail = "deadlock", str(e)
            detail_info = dict(getattr(e, "info", {}) or {})
        wall = time.perf_counter() - t0
        return self._report(status, detail, wall, detail_info)

    def _report(self, status: str, detail: str, wall: float,
                detail_info: Optional[Dict[str, Any]] = None
                ) -> SimReport:
        msgs = sum(h.stats["messages"] for h in self.hubs.values())
        byts = sum(h.stats["bytes"] for h in self.hubs.values())
        links = {f"{hub.name}->{peer}": dict(st)
                 for hub in self.hubs.values()
                 for peer, st in hub.peer_stats.items()}
        hosts = [HostReport.from_sched(s.host, s.stats)
                 for s in self._scheds()]
        if self.orchestrator is not None:
            ost = self.orchestrator.stats
            vtime = self.orchestrator.horizon()
            sync_rounds = ost["epochs"]
            proxy_syncs = ost["proxy_syncs"]
            cross = sum(st["messages"] for hub in self.hubs.values()
                        for st in hub.peer_stats.values())
            staleness = ost["max_proxy_staleness_ns"]
            window = ost["max_window_ns"]
        else:
            vtime = self.scheduler.horizon()
            sync_rounds = proxy_syncs = cross = staleness = window = 0
        cells = {}
        for s in self._scheds():
            snap = s.cells.snapshot()
            if snap is not None:
                cells[str(s.host)] = snap
        # control-plane timeline, mirroring the dist merge exactly
        # (DistCoordinator._merge): one section per control workload,
        # then the membership events — present whenever there was
        # churn, [] when a control workload ran without any
        control: Dict[str, Any] = {}
        for wl in self.workloads:
            fn = getattr(wl, "control_report", None)
            sec = fn() if fn is not None else None
            if sec is not None:
                control[wl.name] = sec
        if self.orchestrator is not None:
            membership = self.orchestrator.membership_timeline()
        else:
            membership = sorted(
                self._membership_events,
                key=lambda e: (e["vtime"], e["event"], e["host"]))
        if membership:
            control["membership"] = membership
        elif control:
            control["membership"] = []
        return SimReport(
            status=status, mode=self.mode, n_hosts=self.topology.n_hosts,
            vtime_ns=vtime, wall_s=wall, messages=msgs, bytes=byts,
            sync_rounds=sync_rounds, proxy_syncs=proxy_syncs,
            cross_host_msgs=cross, max_proxy_staleness_ns=staleness,
            max_window_ns=window, hosts=hosts, links=links,
            tasks={t.name: {"vtime": t.vtime, "state": t.state.value,
                            "host": t.host} for t in self.tasks},
            progress={wl.name: _jsonable(wl.progress())
                      for wl in self.workloads},
            scenario=self.scenario.name, detail=detail, cells=cells,
            live={wl.name: sec for wl in self.workloads
                  for sec in [wl.live_report()] if sec is not None},
            control=control, detail_info=dict(detail_info or {}))

    def sweep(self, axis: Sequence[Scenario], *,
              tick_ns: Optional[int] = None,
              max_rounds: Optional[int] = None,
              device=None):
        """Vectorized batched configuration sweep: run one simulation
        per :class:`Scenario` in ``axis`` as one round loop over a
        leading variant axis of stacked compiled tapes, on ``device``
        (None means ``"cuda"``) (this Simulation's
        topology/workloads/placement are shared; only the scenario
        varies).  Variants must share scenario *structure* — the same
        tapes, messages and channels; injections may change compute
        scales, fail points and degrade extras.  Returns a
        :class:`~repro_torch.sim.vectorized.SweepResult` whose per-variant
        reports are bit-identical to ``run(engine="vectorized")`` on
        each scenario alone (and, on the exact tier, to the reference
        engines)."""
        from repro_torch.sim.vectorized import sweep_vectorized
        return sweep_vectorized(self, list(axis), tick_ns=tick_ns,
                                max_rounds=max_rounds, device=device)

    # -- conveniences --------------------------------------------------------
    def done(self) -> bool:
        return all(t.state == State.DONE for t in self.tasks)
