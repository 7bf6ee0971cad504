"""Declarative cluster topology for `repro_torch.sim`.

A :class:`Topology` names the *machines*: how many hosts run the
simulation, how many simulated CPUs each host's scheduler gets, the
interconnect :class:`~repro_torch.core.ipc.LinkSpec` of every host pair, and
the §3.3 memory-hierarchy :class:`CellSpec` declarations programs may
bind to (``Program.cell`` / ``Interference.cell``).  The logical
message *fabrics* (ICI rings, DCN, service networks) belong to the
workloads (see :class:`repro_torch.sim.workload.Workload.fabrics`); the
topology only says what hardware they are mapped onto.

Host-pair links double as the conservative synchronization lookahead of
the async orchestration engine — see ``Orchestrator.connect_hosts``.
Cell declarations are *names + knobs*: cell state itself is per host —
the :class:`~repro_torch.sim.simulation.Simulation` instantiates a declared
cell on every host where one of its programs lands, each with
independent warm/interference state (see ``repro_torch.core.cells``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.core.cells import Cell
from repro_torch.core.ipc import LinkSpec

#: CellManager calibration knobs accepted by :meth:`Topology.cell_config`
CELL_KNOBS = ("total_ways", "miss_penalty", "recondition_ns",
              "residue_frac", "n_warm_slots")


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """A declared §3.3 cell: a named controlled resource domain (CAT
    way allocation, MBA bandwidth share, working-set/memory profile)
    that programs bind to via ``Program.cell``.  Instantiated per host
    at build time."""
    name: str
    ways: int = 4                     # CAT way allocation
    bw_share: float = 0.5             # MBA throttle (fraction of machine BW)
    bw_demand: float = 0.3            # workload's bandwidth appetite
    working_set_frac: float = 0.5     # working set / LLC size
    mem_frac: float = 0.3             # memory-bound fraction of runtime
    cpus: Tuple[int, ...] = ()
    numa: int = 0

    def to_cell(self) -> Cell:
        return Cell(name=self.name, ways=self.ways,
                    bw_share=self.bw_share, bw_demand=self.bw_demand,
                    working_set_frac=self.working_set_frac,
                    mem_frac=self.mem_frac, cpus=tuple(self.cpus),
                    numa=self.numa)


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """A named message fabric a workload communicates over.

    Single-host simulations materialize each fabric as its own
    :class:`~repro_torch.core.ipc.Hub`.  Multi-host simulations give every
    host one hub (default link = the first declared fabric) and express
    the remaining fabrics as per-endpoint-pair link overrides on it.
    """
    name: str
    link: LinkSpec


class Topology:
    """Hosts + host-interconnect links + per-host CPU budget."""

    def __init__(self, n_hosts: int = 1, n_cpus: int = 8,
                 default_host_link: LinkSpec = LinkSpec(
                     bandwidth_bps=25e9 * 8, latency_ns=10_000)):
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        self.n_hosts = n_hosts
        self.n_cpus = n_cpus
        self.default_host_link = default_host_link
        # insertion order is preserved and becomes the connect order
        self.host_links: Dict[Tuple[int, int], LinkSpec] = {}
        # §3.3 cell declarations (name -> CellSpec, declaration order —
        # which becomes the per-host creation order) + per-host
        # CellManager calibration knobs
        self.cells: Dict[str, CellSpec] = {}
        self.cell_knobs: Dict[str, Any] = {}
        # membership timeline: host -> join vtime (> 0).  Hosts without
        # an entry are founding members; a declared joiner exists in the
        # cluster from build time (scheduler, hub, links) but enters the
        # conservative clock protocol — and its tasks start — at its
        # join vtime.  See Topology.join / Orchestrator.add_host.
        self.joins: Dict[int, int] = {}

    def join(self, host: int, at_vtime: int) -> "Topology":
        """Declare that ``host`` joins the cluster at simulated time
        ``at_vtime`` (> 0) instead of being a founding member.  Programs
        placed on it spawn with initial vtime ``at_vtime``; the engines
        keep it out of the LBTS closure until the membership epoch
        flips.  Host 0 must stay a founding member (the cluster needs
        at least one host at vtime 0)."""
        if not (0 <= host < self.n_hosts):
            raise ValueError(f"join({host}) outside 0..{self.n_hosts-1}")
        if host == 0:
            raise ValueError("host 0 is the founding member and cannot "
                             "join late")
        if at_vtime < 1:
            raise ValueError(f"join vtime must be >= 1 (got {at_vtime}); "
                             f"a vtime-0 join is a founding member")
        if host in self.joins:
            raise ValueError(f"host {host} already has a join event at "
                             f"vtime {self.joins[host]}")
        self.joins[host] = at_vtime
        return self

    def capacity_pool(self, hosts, start_vtime: int,
                      stagger_ns: int = 0) -> "Topology":
        """Declare a provisioning schedule for a pool of late-joining
        hosts: the first joins at ``start_vtime``, each subsequent one
        ``stagger_ns`` later (0 = all at once).  This is the
        simulation-native shape of an autoscaling group: capacity
        *arrives* on this timeline; a control-plane workload decides
        when to put traffic on it (see ``repro_torch.sim.control``)."""
        for i, h in enumerate(hosts):
            self.join(h, start_vtime + i * stagger_ns)
        return self

    def cell(self, name: str, **knobs) -> "Topology":
        """Declare a memory-hierarchy cell (``knobs`` are the
        :class:`CellSpec` fields: ways, bw_share, bw_demand,
        working_set_frac, mem_frac, cpus, numa)."""
        if name in self.cells:
            raise ValueError(f"cell {name!r} already declared")
        self.cells[name] = CellSpec(name=name, **knobs)
        return self

    def cell_config(self, **knobs) -> "Topology":
        """Set CellManager calibration knobs applied to every host's
        manager (total_ways, miss_penalty, recondition_ns,
        residue_frac, n_warm_slots)."""
        unknown = sorted(set(knobs) - set(CELL_KNOBS))
        if unknown:
            raise ValueError(f"unknown cell knobs {unknown}; "
                             f"expected {CELL_KNOBS}")
        self.cell_knobs.update(knobs)
        return self

    def link(self, a: int, b: int, spec: LinkSpec) -> "Topology":
        """Declare the interconnect between hosts ``a`` and ``b``."""
        if not (0 <= a < self.n_hosts and 0 <= b < self.n_hosts):
            raise ValueError(f"link({a}, {b}) outside 0..{self.n_hosts-1}")
        if a == b:
            raise ValueError("a host needs no link to itself")
        self.host_links[(min(a, b), max(a, b))] = spec
        return self

    def host_link(self, a: int, b: int) -> LinkSpec:
        """The effective interconnect of host pair (a, b): the declared
        per-pair link, else ``default_host_link`` — the same resolution
        the engines use (``Orchestrator.connect_hosts`` wiring, degrade
        hooks, the vectorized compiler)."""
        return self.host_links.get((min(a, b), max(a, b)),
                                   self.default_host_link)

    # -- canned shapes -------------------------------------------------------
    @classmethod
    def single_host(cls, n_cpus: int = 8) -> "Topology":
        return cls(n_hosts=1, n_cpus=n_cpus)

    @classmethod
    def full_mesh(cls, n_hosts: int, link: LinkSpec,
                  n_cpus: int = 8) -> "Topology":
        topo = cls(n_hosts=n_hosts, n_cpus=n_cpus)
        for a in range(n_hosts):
            for b in range(a + 1, n_hosts):
                topo.link(a, b, link)
        return topo

    @classmethod
    def racks(cls, n_racks: int, hosts_per_rack: int,
              intra_link: LinkSpec = LinkSpec(bandwidth_bps=80e9 * 8,
                                              latency_ns=2_000),
              cross_link: LinkSpec = LinkSpec(bandwidth_bps=25e9 * 8,
                                              latency_ns=50_000),
              n_cpus: int = 4) -> "Topology":
        """Hosts grouped into racks: fast intra-rack links, slow
        cross-rack links — the heterogeneous-latency regime where the
        per-link-lookahead async engine beats the global barrier."""
        n_hosts = n_racks * hosts_per_rack
        topo = cls(n_hosts=n_hosts, n_cpus=n_cpus)
        for a in range(n_hosts):
            for b in range(a + 1, n_hosts):
                same = a // hosts_per_rack == b // hosts_per_rack
                topo.link(a, b, intra_link if same else cross_link)
        return topo
