"""Distributed simulation orchestration (paper §3.5).

Composes per-host subsystems (scheduler, hubs, cells) into one
cluster-scale simulation while preserving local semantics:

* **Proxy vtasks**: a synchronization scope may contain remote members;
  locally they appear as ``kind="proxy"`` vtasks participating in the
  bounded-skew arithmetic.  The orchestrator (the control-plane daemon of
  the paper) refreshes proxy vtimes at sync points; between syncs the
  proxy is conservatively stale, so local tasks can never run ahead of a
  remote peer by more than skew_bound + sync staleness.
* **Distributed hubs**: ``Hub.peer_with`` links hub instances; cross-host
  messages carry addressing + visibility-time metadata over a host-
  interconnect ``LinkSpec``.  Links may be heterogeneous (fast intra-rack
  + slow cross-rack) — see ``connect_hosts``.
* **Placement**: greedy co-location of frequently-interacting components
  (traffic-weighted) to cut cross-host coordination, plus utilization
  rebalancing hooks.

Orchestration engines
---------------------

Two conservative engines share all of the wiring above; pick one with
``Orchestrator(mode=...)``:

``mode="async"`` (default) — per-link-lookahead conservative PDES.
  Each host advances to its own *earliest-input time* (EIT): the
  earliest vtime at which any peer could still make a message visible
  here, computed per host pair from that pair's link ``latency_ns``
  (the channel lookahead) rather than the global minimum.  Peer clock
  lower bounds are propagated transitively through the host graph
  (null-message-style LBTS relaxation), so a host only blocks on peers
  that can actually affect it, and hosts on fast intra-rack links stop
  gating hosts that only share a slow cross-rack link.  Proxy vtasks
  are refreshed lazily: a proxy is synced only when the host's window
  reaches past its scope pin bound (``vtime + skew_bound_ns``), i.e.
  only when its staleness could pin the local scope minimum.  Progress
  is guaranteed without wake heuristics: every link has lookahead
  >= 1 ns, so the minimum-time host's EIT always lies strictly past the
  global minimum.  A full round with no dispatch and no proxy change
  means true deadlock (``DeadlockError``).

``mode="barrier"`` — the legacy global-barrier epoch loop.  Every epoch
  runs all hosts to ``global_min + window`` where ``window`` is the
  *minimum* cross-host link latency, then barriers and syncs every
  proxy.  Kept for head-to-head comparison (see
  ``benchmarks/cluster_bench.py``); on heterogeneous-latency topologies
  it pays one epoch per min-latency window and one proxy sync per proxy
  per epoch, which the async engine mostly avoids.

Both engines are conservative, so they produce identical simulation
results (final vtimes, message counts); they differ only in how many
synchronization rounds (``stats["epochs"]``) and proxy syncs they need.
A third engine, ``repro_torch.dist``, runs the async protocol across real OS
worker processes: its coordinator reuses :func:`lbts_bounds` /
:func:`earliest_input_time` below, so all three engines compute the
same conservative clock bounds and stay bit-identical (enforced by
``tests/engine_harness.py``).

Most callers should not wire an Orchestrator by hand: the `repro_torch.sim`
facade (:class:`repro_torch.sim.Simulation`) builds hosts, hubs, links,
scopes, and placement from a declarative Topology/Workload/Scenario
description, picks the engine automatically, and returns a structured
:class:`repro_torch.sim.SimReport`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.cells import Cell, CellManager
from repro_torch.core.ipc import Hub, LinkSpec
from repro_torch.core.scheduler import DeadlockError, Scheduler
from repro_torch.core.scope import Scope
from repro_torch.core.vtask import State, VTask

_INF = 2**62
#: internal unreachable sentinel for closure distances; half of _INF so
#: int64 min-plus sums (CAP + CAP, _INF + CAP) can never overflow
_CAP = _INF >> 1


def lbts_bounds(next_times: Dict[int, Optional[int]],
                lookahead: Dict[Tuple[int, int], int]) -> Dict[int, int]:
    """Null-message-style LBTS relaxation: lb[h] is a lower bound on the
    vtime of *any* future action of host h, accounting for transitive
    wake-up chains (h may be woken by a message from p, which may first
    be woken by q, ...).  Fixpoint of

        lb[h] = min(local_next(h), min_p lb[p] + lookahead(p, h))

    over the host graph; converges in <= n_hosts passes because all
    lookaheads are positive.

    This is the *reference* implementation; the hot paths (in-process
    async engine and the dist coordinator) use :class:`LBTSSolver`,
    which computes the identical fixpoint through a precomputed
    min-plus closure of the static lookahead graph plus an
    unchanged-input cache (``tests/test_orchestrator_async.py`` pins
    solver == reference)."""
    lb = {h: (_INF if t is None else t) for h, t in next_times.items()}
    for _ in range(len(lb)):
        changed = False
        for (src, dst), la in lookahead.items():
            if lb[src] >= _INF:
                continue
            v = lb[src] + la
            if v < lb[dst]:
                lb[dst] = v
                changed = True
        if not changed:
            break
    return lb


def earliest_input_time(host: int, lb: Dict[int, int],
                        lookahead: Dict[Tuple[int, int], int]
                        ) -> Optional[int]:
    """Earliest-input time of ``host``: no peer can make a message
    visible here before this vtime, so every local event strictly below
    it is safe to execute.  None = unbounded (no peer can reach this
    host at all)."""
    times = [lb[src] + la for (src, dst), la in lookahead.items()
             if dst == host and lb[src] < _INF]
    return min(times) if times else None


class LBTSSolver:
    """Incremental LBTS/EIT computation over a *static* lookahead graph.

    Channels are pinned at peering time, so the graph never changes
    during a run; the fixpoint ``lb[h] = min_s next[s] + dist(s, h)``
    (with ``dist`` the min-plus closure of the lookahead edges,
    ``dist(h, h) = 0``) can therefore be evaluated as one vectorized
    min-plus product per round instead of an O(E x n) relaxation — and
    skipped entirely when no host's next-event time changed since the
    last round (the common case once parts of the cluster go quiescent).
    Produces bit-identical values to :func:`lbts_bounds` /
    :func:`earliest_input_time`."""

    def __init__(self, lookahead: Dict[Tuple[int, int], int],
                 hosts: Iterable[int]):
        self.hosts: List[int] = sorted(hosts)
        self._idx = {h: i for i, h in enumerate(self.hosts)}
        n = len(self.hosts)
        dist = np.full((n, n), _CAP, dtype=np.int64)
        np.fill_diagonal(dist, 0)
        #: direct in-edges per host, for EIT against a mutating lb dict
        self.in_edges: Dict[int, List[Tuple[int, int]]] = {
            h: [] for h in self.hosts}
        for (src, dst), la in lookahead.items():
            i, j = self._idx[src], self._idx[dst]
            dist[i, j] = min(dist[i, j], la)
            self.in_edges[dst].append((src, la))
        # min-plus closure, Floyd-Warshall with one vectorized (n, n)
        # relaxation per pivot: O(n^2) memory (a cubed temporary would
        # cost n^3 * 8 bytes at the host counts this exists for).
        # Entries stay <= _CAP by the running minimum, so pivot sums
        # never exceed 2 * _CAP < 2**63 — no int64 overflow.
        for k in range(n):
            np.minimum(dist, dist[:, k, None] + dist[None, k, :],
                       out=dist)
        self._dist = dist
        self._next_cache: Optional[Dict[int, Optional[int]]] = None
        self._lb_vec: Optional[np.ndarray] = None

    def bounds(self, next_times: Dict[int, Optional[int]]
               ) -> Dict[int, int]:
        """LBTS clock bounds for all hosts; recomputed only when some
        host's conservative next-event time changed.  Returns a fresh
        dict (callers mutate it mid-round)."""
        if next_times != self._next_cache:
            n = len(self.hosts)
            vec = np.fromiter(
                (_INF if next_times[h] is None else next_times[h]
                 for h in self.hosts), dtype=np.int64, count=n)
            # mask unreachable pairs before the min — a finite source
            # plus the _CAP sentinel must stay "no bound", not become a
            # huge-but-finite one (sums stay < 2**63, so no overflow)
            contrib = np.where(self._dist >= _CAP, _INF,
                               vec[:, None] + self._dist)
            lb = np.minimum(contrib.min(axis=0), _INF)
            self._next_cache = dict(next_times)
            self._lb_vec = lb
        return {h: int(self._lb_vec[i])
                for i, h in enumerate(self.hosts)}

    def eit(self, host: int, lb: Dict[int, int]) -> Optional[int]:
        """Earliest-input time of ``host`` against the (possibly
        mid-round-refreshed) lb dict: O(in-degree), identical to
        :func:`earliest_input_time`."""
        best = None
        for src, la in self.in_edges[host]:
            v = lb[src]
            if v >= _INF:
                continue
            c = v + la
            if best is None or c < best:
                best = c
        return best


class ProxyVTask(VTask):
    """Local stand-in for a remote scope member."""

    def __init__(self, remote: VTask, host: int):
        super().__init__(f"proxy:{remote.name}", body=None, kind="proxy",
                         host=host)
        self.remote = remote
        self.state = State.RUNNABLE
        self.vtime = remote.vtime
        # staleness bookkeeping (lazy sync): vtime of the mirrored source
        # at the last sync, sync count, and the largest source-vs-mirror
        # gap ever observed at a sync point.
        self.sync_count = 0
        self.last_sync_vtime = remote.vtime
        self.max_staleness_ns = 0

    def _mirror_state(self) -> State:
        """A finished/blocked remote must not pin the local scope min."""
        return (State.RUNNABLE if self.remote.state == State.RUNNABLE
                else State.BLOCKED)

    def is_stale(self) -> bool:
        return (self.vtime != self.remote.vtime
                or self.state != self._mirror_state())

    def sync(self) -> bool:
        """Refresh from the remote; returns True iff anything changed.

        Staleness bookkeeping: ``max_staleness_ns`` records the largest
        remote-vs-proxy vtime gap ever observed at a sync point (the
        proxy can only *under*-report, so staleness tightens the skew
        bound — a liveness cost, never a correctness one)."""
        remote_v = self.remote.vtime
        changed = self.is_stale()
        self.max_staleness_ns = max(self.max_staleness_ns,
                                    remote_v - self.vtime)
        self.sync_count += 1
        self.last_sync_vtime = remote_v
        if changed:
            self.vtime = remote_v
            self.state = self._mirror_state()
            for s in self.scopes:
                s.notify(self)
        return changed


@dataclasses.dataclass
class HostSpec:
    """Declarative per-host configuration for hand-wired orchestration:
    CPU budget plus the host's §3.3 memory-hierarchy cell allocations
    (the facade derives the same thing from ``Topology.cell``
    declarations + placement)."""
    host_id: int
    n_cpus: int = 8
    cells: Tuple[Cell, ...] = ()

    def cell_manager(self, **knobs) -> CellManager:
        """Build this host's CellManager (``knobs`` are CellManager
        calibration parameters: total_ways, miss_penalty, ...)."""
        cm = CellManager(host=self.host_id, **knobs)
        for cell in self.cells:
            cm.add(cell)
        return cm


class Orchestrator:
    def __init__(self, n_hosts: int = 1,
                 n_cpus: Union[int, Dict[int, int]] = 8,
                 dcn_link: LinkSpec = LinkSpec(bandwidth_bps=25e9 * 8,
                                               latency_ns=10_000),
                 mode: str = "async",
                 cells: Optional[Dict[int, CellManager]] = None,
                 joins: Optional[Dict[int, int]] = None):
        assert mode in ("async", "barrier"), mode
        self.mode = mode
        if not isinstance(n_cpus, dict):
            n_cpus = {h: n_cpus for h in range(n_hosts)}
        self.hosts: Dict[int, Scheduler] = {}
        #: membership timeline: host -> vtime it joins the cluster
        #: (0 = founding member) and host -> vtime it leaves, plus the
        #: ordered event log surfaced in ``SimReport.control``
        self.join_vtime: Dict[int, int] = {}
        self.leave_vtime: Dict[int, int] = {}
        self.membership_events: List[dict] = []
        self.hubs: Dict[int, Hub] = {}
        self.dcn_link = dcn_link
        # optional heterogeneous topology: (host_a, host_b) -> LinkSpec,
        # consulted when hubs are peered; pairs without an entry use
        # dcn_link.
        self.host_links: Dict[Tuple[int, int], LinkSpec] = {}
        self.proxies: List[ProxyVTask] = []
        self._host_proxies: Dict[int, List[ProxyVTask]] = {}
        self.global_scopes: List[Scope] = []
        self.stats = {"epochs": 0, "proxy_syncs": 0, "cross_host_msgs": 0,
                      "max_proxy_staleness_ns": 0, "max_window_ns": 0,
                      "quiescent_skips": 0, "membership_epochs": 0}
        self._solver: Optional[LBTSSolver] = None   # built on first run
        # membership-epoch state (lazy; see _membership_state)
        self._active_hosts: Optional[List[int]] = None
        self._pending_joins: Optional[List[Tuple[int, int]]] = None
        joins = joins or {}
        # per-host cell state (§3.3): each host's scheduler gets its own
        # CellManager — passed in by the facade, defaulted otherwise
        for h in range(n_hosts):
            self.add_host(h, n_cpus=n_cpus.get(h, 8),
                          at_vtime=joins.get(h, 0),
                          cells=None if cells is None else cells.get(h))

    @classmethod
    def from_host_specs(cls, specs: List[HostSpec], *,
                        dcn_link: LinkSpec = LinkSpec(
                            bandwidth_bps=25e9 * 8, latency_ns=10_000),
                        mode: str = "async",
                        cell_knobs: Optional[dict] = None
                        ) -> "Orchestrator":
        """Hand-wiring entry point for heterogeneous hosts: one
        :class:`HostSpec` per host (ids must be exactly 0..n-1), each
        contributing its CPU budget and §3.3 cell allocations."""
        ids = sorted(s.host_id for s in specs)
        if ids != list(range(len(specs))):
            raise ValueError(f"host ids must be 0..{len(specs) - 1}, "
                             f"got {ids}")
        return cls(
            n_hosts=len(specs),
            n_cpus={s.host_id: s.n_cpus for s in specs},
            dcn_link=dcn_link, mode=mode,
            cells={s.host_id: s.cell_manager(**(cell_knobs or {}))
                   for s in specs})

    # -- wiring -----------------------------------------------------------------
    def host(self, h: int) -> Scheduler:
        return self.hosts[h]

    # -- membership (vtime-stamped join/leave events) ----------------------------
    def add_host(self, h: int, *, n_cpus: int = 8, at_vtime: int = 0,
                 cells: Optional[CellManager] = None) -> Scheduler:
        """Add host ``h`` to the cluster as a vtime-stamped membership
        event.  ``at_vtime=0`` is a founding member; ``at_vtime=T > 0``
        means the host *joins* at simulated time ``T``: its scheduler and
        hub are wired at build time (fresh state, no resurrection of any
        prior host's tasks or cells), but the conservative engines keep
        it out of the LBTS closure — and clamp every active host's
        window at ``T`` — until the membership epoch flips (see
        ``_run_async``).  The facade spawns the joiner's tasks with
        initial vtime ``T``, so the joiner's earliest possible send is
        ``>= T`` and join-time lookahead attach is add-only conservative:
        no pre-join host ever executes an event at ``>= T`` before the
        joiner's edges are in the graph."""
        if h in self.hosts:
            raise ValueError(f"host {h} is already a cluster member")
        if at_vtime < 0:
            raise ValueError(f"host {h}: join vtime must be >= 0, "
                             f"got {at_vtime}")
        self.join_vtime[h] = at_vtime
        if at_vtime > 0:
            self.membership_events.append(
                {"event": "join", "host": h, "vtime": at_vtime})
        self._active_hosts = None       # membership timeline changed
        self._pending_joins = None
        self._solver = None
        sched = Scheduler(host=h, n_cpus=n_cpus, distributed=True,
                          cells=cells)
        self.hosts[h] = sched
        return sched

    def retire_host(self, h: int, at_vtime: int) -> None:
        """Record host ``h`` leaving the cluster at ``at_vtime`` (the
        membership half of ``FailHost``: the facade kills the host's
        tasks through the ordinary fault wrappers; this logs the churn
        event).  Leaves need no solver rebuild — a retired host goes
        quiescent, and quiescent hosts already stop gating peers — so
        the conservative window schedule (and every pinned golden
        ``sync_rounds``) is unchanged."""
        if h not in self.hosts:
            raise ValueError(f"cannot retire unknown host {h}")
        prior = self.leave_vtime.get(h)
        if prior is None or at_vtime < prior:
            self.leave_vtime[h] = at_vtime
        self.membership_events.append(
            {"event": "leave", "host": h, "vtime": at_vtime})

    def membership_timeline(self) -> List[dict]:
        """Vtime-ordered membership events (joins + leaves)."""
        return sorted(self.membership_events,
                      key=lambda e: (e["vtime"], e["event"], e["host"]))

    def _membership_state(self) -> Tuple[List[int], List[Tuple[int, int]]]:
        """(active hosts, pending joins as sorted (vtime, host)) — the
        epoch state for the conservative engines.  Persisted on self so
        chunked re-entry (the dist sole-worker path) resumes the same
        epoch."""
        if self._active_hosts is None:
            self._active_hosts = sorted(
                h for h, t in self.join_vtime.items() if t <= 0)
            self._pending_joins = sorted(
                (t, h) for h, t in self.join_vtime.items() if t > 0)
            if not self._active_hosts and self.hosts:
                raise ValueError(
                    "cluster has no founding member: at least one host "
                    "must join at vtime 0")
        return self._active_hosts, self._pending_joins

    def _activate_epoch(self) -> None:
        """Flip the membership epoch: admit every pending joiner at the
        earliest pending join vtime into the active set and invalidate
        the solver so the min-plus closure re-solves over the grown
        graph."""
        t0 = self._pending_joins[0][0]
        while self._pending_joins and self._pending_joins[0][0] == t0:
            _, h = self._pending_joins.pop(0)
            self._active_hosts.append(h)
        self._active_hosts.sort()
        self._solver = None
        self.stats["membership_epochs"] += 1

    def connect_hosts(self, a: int, b: int, link: LinkSpec) -> None:
        """Declare the interconnect between hosts ``a`` and ``b`` (both
        directions); pairs not declared fall back to ``dcn_link``.
        Per-pair latency becomes that pair's synchronization lookahead
        in the async engine.  If both hosts already have hubs, the
        existing channel is re-pinned to the new link."""
        self.host_links[(a, b)] = link
        self.host_links[(b, a)] = link
        self._solver = None             # lookahead graph changed
        ha, hb = self.hubs.get(a), self.hubs.get(b)
        if ha is not None and hb is not None:
            ha.peer_with(hb, link)

    def _link_for(self, a: int, b: int) -> LinkSpec:
        return self.host_links.get((a, b), self.dcn_link)

    def add_hub(self, host: int, hub: Hub) -> Hub:
        for other_host, other in self.hubs.items():
            hub.peer_with(other, self._link_for(host, other_host))
        self.hubs[host] = hub
        self._solver = None             # lookahead graph changed
        return hub

    def global_scope(self, name: str, members: List[VTask],
                     skew_bound_ns: int) -> List[Scope]:
        """One logical scope spanning hosts: a local Scope per host with
        real members + proxies for remote members."""
        per_host: Dict[int, List[VTask]] = {}
        for t in members:
            per_host.setdefault(t.host, []).append(t)
        scopes = []
        for h, local in per_host.items():
            s = Scope(f"{name}@host{h}", skew_bound_ns)
            for t in local:
                t.join(s)
            for t in members:
                if t.host != h:
                    p = ProxyVTask(t, host=h)
                    self.hosts[h].spawn(p)
                    p.join(s)
                    self.proxies.append(p)
                    self._host_proxies.setdefault(h, []).append(p)
            scopes.append(s)
        self.global_scopes.extend(scopes)
        return scopes

    # -- placement ---------------------------------------------------------------
    @staticmethod
    def co_locate(components: List[str],
                  traffic: Dict[Tuple[str, str], float],
                  n_hosts: int, capacity: int) -> Dict[str, int]:
        """Greedy traffic-weighted placement: heaviest edges first, merge
        into the same host while capacity permits.

        Self-edges are ignored, ``capacity < 2`` degenerates to
        balanced singletons, components without traffic get their own
        group, and more groups than hosts simply stack on the
        least-loaded host."""
        placement: Dict[str, int] = {}
        groups: List[List[str]] = []
        edges = sorted(traffic.items(), key=lambda kv: -kv[1])

        def group_of(c):
            for g in groups:
                if c in g:
                    return g
            return None

        for (a, b), _w in edges:
            if a == b:
                continue
            ga, gb = group_of(a), group_of(b)
            if ga is None and gb is None:
                if capacity < 2:
                    continue        # singletons; placed by the tail loop
                groups.append([a, b])
            elif ga is not None and gb is None and len(ga) < capacity:
                ga.append(b)
            elif gb is not None and ga is None and len(gb) < capacity:
                gb.append(a)
            elif (ga is not None and gb is not None and ga is not gb
                  and len(ga) + len(gb) <= capacity):
                ga.extend(gb)
                groups.remove(gb)
        for c in components:
            if group_of(c) is None:
                groups.append([c])
        groups.sort(key=len, reverse=True)
        loads = [0] * n_hosts
        for g in groups:
            h = loads.index(min(loads))
            for c in g:
                placement[c] = h
            loads[h] += len(g)
        return placement

    # -- control plane --------------------------------------------------------------
    def sync_proxies(self) -> None:
        for p in self.proxies:
            p.sync()
            self.stats["proxy_syncs"] += 1
        self._note_staleness()

    def _note_staleness(self) -> None:
        for p in self.proxies:
            self.stats["max_proxy_staleness_ns"] = max(
                self.stats["max_proxy_staleness_ns"], p.max_staleness_ns)

    def unfinished(self) -> bool:
        return any(h.has_unfinished() for h in self.hosts.values())

    def global_now(self) -> int:
        """Conservative next-event time across hosts (PDES semantics:
        blocked vtasks with nothing pending cannot generate events)."""
        nows = [t for t in (h.next_time() for h in self.hosts.values())
                if t is not None]
        return min(nows) if nows else self.horizon()

    def horizon(self) -> int:
        return max((t.vtime for h in self.hosts.values()
                    for t in h.tasks if t.kind != "proxy"), default=0)

    # -- async engine: per-link lookahead ----------------------------------------
    def _lookahead(self, src: int, dst: int) -> Optional[int]:
        """Guaranteed minimum delay of a src->dst cross-host message, or
        None when no channel exists.  Read from the hubs' own routing
        config (single source of truth with the data path).  Clamped to
        >= 1 ns: a zero-latency link has no usable lookahead and would
        stall conservative progress."""
        shub, dhub = self.hubs.get(src), self.hubs.get(dst)
        if shub is None or dhub is None or dhub.name not in shub.peers:
            return None
        return max(1, shub.lookahead_ns(dhub.name))

    def lookahead_map(self, hosts: Optional[Iterable[int]] = None
                      ) -> Dict[Tuple[int, int], int]:
        """All directed cross-host channels and their lookahead, the
        input to :func:`lbts_bounds` / :func:`earliest_input_time`.
        ``hosts`` restricts the map to a membership epoch's active set
        (the solver re-solves over exactly these edges)."""
        la = {}
        members = self.hosts if hosts is None else list(hosts)
        for src in members:
            for dst in members:
                if src == dst:
                    continue
                v = self._lookahead(src, dst)
                if v is not None:
                    la[(src, dst)] = v
        return la

    def _clock_bounds(self) -> Dict[int, int]:
        return lbts_bounds(
            {h: sched.next_time() for h, sched in self.hosts.items()},
            self.lookahead_map())

    def _eit(self, host: int, lb: Dict[int, int]) -> Optional[int]:
        return earliest_input_time(host, lb, self.lookahead_map())

    def _next_times(self) -> Dict[int, Optional[int]]:
        return {h: sched.next_time() for h, sched in self.hosts.items()}

    def _lazy_sync(self, host: int, bound: Optional[int]) -> bool:
        """Sync a proxy only when its staleness could pin the local scope
        minimum within this window: once the window reaches past
        ``proxy.vtime + skew_bound`` (the scope pin bound), local members
        would skew-stall on the stale value."""
        changed = False
        for p in self._host_proxies.get(host, ()):
            if not p.is_stale():
                continue
            if bound is not None and p.scopes:
                pin = min(s.pin_bound(p) for s in p.scopes)
                if pin >= bound:
                    continue                  # cannot stall anyone yet
            if p.sync():
                changed = True
            self.stats["proxy_syncs"] += 1
        return changed

    def _membership_gmin(self, active: List[int]) -> Optional[int]:
        """Conservative next-event time over the active set only."""
        times = [t for t in (self.hosts[h].next_time() for h in active)
                 if t is not None]
        return min(times) if times else None

    def _wedge_info(self) -> dict:
        """Structured deadlock detail: which hosts hold unfinished work
        (and any joins still pending), so a membership-related wedge
        names the responsible host instead of only carrying prose."""
        active, pending = self._membership_state()
        return {
            "kind": "wedged",
            "wedged_hosts": [h for h in sorted(self.hosts)
                             if self.hosts[h].has_unfinished()],
            "pending_joins": [{"host": h, "vtime": t}
                              for t, h in pending],
        }

    def _run_async(self, max_rounds: int,
                   raise_on_exhaust: bool = True) -> bool:
        """Run the per-link-lookahead engine; returns True when the
        simulation finished, False when ``max_rounds`` elapsed first
        (only with ``raise_on_exhaust=False`` — the dist sole-worker
        path runs in bounded chunks to heartbeat its coordinator).

        Membership epochs: hosts with a pending join (``add_host`` with
        ``at_vtime=T > 0``) are kept out of the LBTS closure, and every
        active host's window is clamped at the earliest pending ``T``,
        until the active set provably cannot act below ``T`` — then the
        epoch flips, the joiner enters the graph, and the min-plus
        closure re-solves (cached between epochs).  Conservatism: the
        clamp means no pre-join host executes an event at ``>= T``
        before the joiner's edges exist, and the joiner's own tasks
        start at vtime ``T``, so its earliest send is ``>= T`` — wake
        forwarding is causal-timestamp-only, so the epoch-clamped
        schedule yields results bit-identical to every other engine."""
        # channels are pinned at peering time (Hub.peer_with), so within
        # a membership epoch the lookahead map is static — build the
        # solver's min-plus closure once per epoch (the dist coordinator
        # mirrors this logic round by round).  Cached across chunked
        # re-entry.
        active, pending = self._membership_state()
        solver = self._solver
        if solver is None:
            solver = self._solver = LBTSSolver(
                self.lookahead_map(active), active)
        for _ in range(max_rounds):
            if not self.unfinished():
                return True
            # membership epoch flips: admit pending joiners once no
            # active host can act strictly below the join vtime
            while pending:
                gmin = self._membership_gmin(active)
                if gmin is not None and gmin < pending[0][0]:
                    break
                self._activate_epoch()
                solver = self._solver = LBTSSolver(
                    self.lookahead_map(active), active)
            self.stats["epochs"] += 1
            progressed = False
            clamp = pending[0][0] if pending else None
            lb = solver.bounds(self._next_times())
            for h in active:
                sched = self.hosts[h]
                bound = solver.eit(h, lb)
                if clamp is not None:
                    bound = clamp if bound is None else min(bound, clamp)
                if self._lazy_sync(h, bound):
                    progressed = True
                elif sched.quiescent_below(bound):
                    # provably a no-op window: nothing runnable and no
                    # pending wake-up below this host's bound, and no
                    # proxy sync fell due — skip the host entirely.
                    self.stats["quiescent_skips"] += 1
                    continue
                if bound is not None:
                    start = sched.next_time()
                    if start is not None and bound > start:
                        self.stats["max_window_ns"] = max(
                            self.stats["max_window_ns"], bound - start)
                wakes_before = sched.stats.wakes
                if (sched.run_until(bound)
                        or sched.stats.wakes != wakes_before):
                    # dispatches are progress; so is a wake that consumed
                    # a pending visibility/event even when scope
                    # forwarding pushed the woken vtask past this round's
                    # window (no dispatch yet) — the next round's clock
                    # bounds see the new vtime.
                    progressed = True
                    # freshen this host's clock bound so later hosts in
                    # the same round see the larger lookahead window.
                    # The transitive component (h may still be woken by a
                    # peer that runs after it) must be re-applied: lb[h]
                    # is min(local next event, earliest peer wake-up).
                    t = sched.next_time()
                    local = _INF if t is None else t
                    # bound == _eit(h, lb) still: lb is untouched since
                    # the top of this iteration (and _eit ignores lb[h])
                    lb[h] = local if bound is None else min(local, bound)
            if not progressed:
                if pending:
                    # active set is wedged below the next join vtime:
                    # the epoch flip itself is the progress (the joiner
                    # may hold the messages everyone is blocked on)
                    self._activate_epoch()
                    solver = self._solver = LBTSSolver(
                        self.lookahead_map(active), active)
                    continue
                if self.unfinished():
                    self._note_staleness()
                    raise DeadlockError("distributed simulation wedged",
                                        info=self._wedge_info())
                return True
        if self.unfinished():
            if not raise_on_exhaust:
                return False
            self._note_staleness()
            raise DeadlockError(
                f"async engine exceeded {max_rounds} rounds "
                f"without finishing", info=self._wedge_info())
        return True

    # -- barrier engine (legacy, kept for head-to-head comparison) ---------------
    def _run_barrier(self, max_epochs: int) -> None:
        # CMB lookahead = the minimum latency over every cross-host
        # channel — any single faster link bounds how far all hosts may
        # conservatively run ahead.  ``peer_links`` is pinned per pair
        # at peering time, so it enumerates exactly the channels that
        # exist; no channels at all (e.g. a 1-host topology) means no
        # conservative constraint, and the window must be unbounded —
        # a finite window would defer wake-ups past the gate and let
        # scope-min forwarding observe a schedule that no unconstrained
        # engine produces (diverging from single/async results).
        lats = [link.latency_ns
                for hub in self.hubs.values()
                for link in hub.peer_links.values()]
        window = max(1, min(lats)) if lats else None
        stalled = 0
        for _ in range(max_epochs):
            if not self.unfinished():
                break
            self.stats["epochs"] += 1
            before = self.horizon()
            before_d = sum(h.stats.dispatches for h in self.hosts.values())
            gmin = self.global_now()
            for h in self.hosts.values():
                # strict window drain: a wake-up at or past the gate
                # could timestamp a receiver against a late slow-link
                # message that an unsent fast-link message will undercut
                h.run_until(None if window is None else gmin + window)
            self.sync_proxies()
            if not self.unfinished():
                break
            after_d = sum(h.stats.dispatches for h in self.hosts.values())
            if self.horizon() == before and after_d == before_d:
                # No progress in a full epoch: everything pending lies at
                # or past the gate.  Since nothing below gmin + window
                # could dispatch, any *future* send happens at
                # >= gmin + window and becomes visible at
                # >= gmin + 2*window — so waking blocked vtasks below
                # that horizon is conservative; anything further out is
                # reached by gmin itself advancing next epoch.
                moved = False
                for h in self.hosts.values():
                    h._wake_pass(bound=None if window is None
                                 else gmin + 2 * window)
                    if h.runnable():
                        moved = True
                if not moved:
                    if not any(h.next_time() is not None
                               for h in self.hosts.values()):
                        raise DeadlockError("distributed simulation wedged",
                                            info=self._wedge_info())
                    # pending events exist beyond the wake horizon; gmin
                    # itself advances next epoch.  Two stalled epochs in
                    # a row means even that cannot make progress.
                    stalled += 1
                    if stalled >= 2:
                        raise DeadlockError(
                            "distributed simulation stalled with pending "
                            "events beyond the wake horizon",
                            info=self._wedge_info())
            else:
                stalled = 0

    def run(self, max_epochs: int = 1_000_000) -> dict:
        if self.mode == "barrier":
            self._run_barrier(max_epochs)
        else:
            self._run_async(max_epochs)
        self._note_staleness()
        total_msgs = sum(hub.stats["messages"]
                         for hub in self.hubs.values())
        self.stats["cross_host_msgs"] = sum(
            st["messages"] for hub in self.hubs.values()
            for st in hub.peer_stats.values())
        return {"epochs": self.stats["epochs"],
                "vtime_ns": self.horizon(),
                "messages": total_msgs}
