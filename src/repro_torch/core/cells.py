"""Live memory-hierarchy management (paper §3.3): the cell abstraction.

A cell binds one live component to a controlled resource domain: CPU set,
NUMA node, LLC way allocation (Intel CAT / AMD QoS analogue), memory-
bandwidth share (MBA analogue), interrupt placement.  On the simulation
host we cannot program real RDT MSRs, so the subsystem does exactly what
the paper prescribes for *imperfect* isolation: estimate the residual
deviation and fold it into virtual-time advance — "imperfect isolation is
not hidden; it is explicitly incorporated into simulated time."

Two distortions are modeled:

* **Spatial interference**: a closed-form contention model.  Cache
  pressure = working-set overflow beyond the cell's way fraction; memory
  bandwidth = demand vs. MBA share under co-active demand, weighted by
  the workload's memory-bound fraction.  The resulting multiplier scales
  clock-derived vtime of live calls.  Accounting distinguishes *spatial
  interference* (the multiplier grew because co-active cells contend)
  from *self-pressure* (the cell's own working set overflows its ways,
  or its demand exceeds the machine, with nobody else around).
* **Temporal residue**: warm-cell tracking with ``n_warm_slots``
  capacity.  Dispatching a cold cell costs reconditioning time (flush
  outgoing + prefetch incoming) plus a deterministic "PMU-sampled"
  residue (hash-derived, reproducible) — charged to the incoming
  component's vtime at its next live call.

State model (the engine-equivalence contract)
---------------------------------------------

One ``CellManager`` per simulated *host* — the facade constructs them
per host in every engine, and the multi-process dist workers rebuild
bit-identical replicas, so a cell name denotes independent state on
each host it is used on.  Everything that feeds virtual time is a
function of declarative, engine-independent inputs:

* **Co-activity is assignment-based**: a cell is live on its host from
  the first :meth:`assign` until :meth:`release` — a CAT/MBA allocation
  holds its ways and bandwidth share for the component's lifetime, not
  just while a task happens to be dispatched (and not merely until it
  finishes: a dead component's cell still occupies the hierarchy until
  released).  Assignments happen at build time, so the coactive set —
  and therefore every spatial multiplier — is identical across the
  single/barrier/async/dist engines regardless of how they window
  execution.  The per-host *live-cell multiset* is maintained
  incrementally (O(1) aggregate reads per live call; updates only at
  assign/release), replacing the old O(n)-tasks scan per LiveCall.
* **Residues are name-keyed**: the reconditioning residue hashes the
  task's *name* and its per-task cold-entry ordinal, never process
  state (vtask ids drift across builds in one process; a global switch
  counter drifts with dispatch interleaving).
* **Warm-slot LRU transitions happen at live-call dispatch
  boundaries**, which the scheduler orders by ``(vtime, id)``.  On a
  host that dispatches serially (``n_cpus=1`` — the same condition
  under which ``cpu_resource`` queuing is engine-exact) that order is
  provably engine-invariant, so switch charges agree bit-exactly across
  engines; wider hosts may batch racing live calls across window gates
  differently (spatial interference stays exact either way).

All constants are calibration knobs (see benchmarks/run.py::cells).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from repro_torch.core.vtask import VTask

TOTAL_WAYS = 12

#: slowdown-histogram bucket upper edges (inclusive); the report keeps
#: integer counts per bucket so cross-engine comparison is exact
SLOWDOWN_BUCKETS = (1.0, 1.05, 1.1, 1.25, 1.5, 2.0)


def _hash01(*xs: int) -> float:
    """Deterministic pseudo-random in [-1, 1) (PMU-sampling stand-in)."""
    h = 2166136261
    for x in xs:
        h = (h ^ (x & 0xFFFFFFFF)) * 16777619 & 0xFFFFFFFF
    return (h / 2**31) - 1.0


def _stable_hash(s: str) -> int:
    """FNV-1a over UTF-8 bytes: a process- and build-order-independent
    int key for residue hashing (vtask ids are neither)."""
    h = 2166136261
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


#: precomputed histogram labels (the bucket lookup runs on every live
#: call — only float compares belong on that path)
_BUCKET_LABELS = tuple(f"<={e:.2f}" for e in SLOWDOWN_BUCKETS) \
    + (f">{SLOWDOWN_BUCKETS[-1]:.2f}",)


def _bucket(s: float) -> str:
    for i, edge in enumerate(SLOWDOWN_BUCKETS):
        if s <= edge:
            return _BUCKET_LABELS[i]
    return _BUCKET_LABELS[-1]


@dataclasses.dataclass
class Cell:
    name: str
    ways: int = 4                     # CAT way allocation
    bw_share: float = 0.5             # MBA throttle (fraction of machine BW)
    bw_demand: float = 0.3            # workload's bandwidth appetite
    working_set_frac: float = 0.5     # working set / LLC size
    mem_frac: float = 0.3             # memory-bound fraction of runtime
    cpus: tuple = ()
    numa: int = 0


class CellManager:
    """Per-host cell allocation, spatial-interference, and warm-slot
    state (see the module docstring for the engine-equivalence
    contract)."""

    def __init__(self, total_ways: int = TOTAL_WAYS,
                 miss_penalty: float = 0.6,
                 recondition_ns: int = 50_000,
                 residue_frac: float = 0.05,
                 n_warm_slots: int = 4,
                 host: int = 0):
        self.host = host
        self.cells: Dict[str, Cell] = {}
        self.total_ways = total_ways
        self.miss_penalty = miss_penalty
        self.recondition_ns = recondition_ns
        self.residue_frac = residue_frac
        self.n_warm_slots = n_warm_slots
        self._warm: "OrderedDict[str, None]" = OrderedDict()
        # live-cell multiset: cell -> number of assigned tasks, plus the
        # O(1) aggregates slowdown() reads per live call (sum of demand/
        # share over cells with >= 1 assignment, each counted once)
        self._assigned: Dict[str, int] = {}
        self._tasks: Dict[str, List[VTask]] = {}   # backrefs for release
        self._solo: Dict[str, float] = {}          # cached solo multipliers
        self._n_live = 0
        self._live_demand = 0.0
        self._live_share = 0.0
        self.stats = {"switches": 0, "recondition_ns": 0,
                      "interference_events": 0, "self_pressure_events": 0}
        self._cell_stats: Dict[str, Dict[str, Any]] = {}

    # -- allocation ------------------------------------------------------------
    def add(self, cell: Cell) -> Cell:
        """Register an existing :class:`Cell` spec (copied defensively)."""
        if cell.name in self.cells:
            raise ValueError(f"cell {cell.name} exists")
        cell = dataclasses.replace(cell)
        self.cells[cell.name] = cell
        # the solo multiplier is a pure function of the (immutable)
        # spec + manager knobs: cache it so contended live calls don't
        # run the float pipeline twice
        self._solo[cell.name] = self._slowdown_of(cell, 0.0, 0.0)
        self._cell_stats.setdefault(cell.name, {
            "live_calls": 0, "interference_events": 0,
            "self_pressure_events": 0, "switches": 0,
            "recondition_ns": 0, "max_slowdown_ppm": 0,
            "slowdown_hist": {}})
        return cell

    def create(self, name: str, **kwargs) -> Cell:
        return self.add(Cell(name=name, **kwargs))

    def assign(self, task: VTask, name: str) -> VTask:
        """Bind a task to a cell and register it in the live-cell
        multiset.  Membership is keyed on the manager's own records —
        not on ``task.cell``, which may already carry the name from the
        ``VTask(cell=...)`` constructor arg — so assign() is idempotent
        and constructor-labelled tasks register correctly."""
        if name not in self.cells:
            raise KeyError(name)
        if task.cell and task.cell != name:
            self._unassign(task)
        tasks = self._tasks.setdefault(name, [])
        if task not in tasks:
            task.cell = name
            tasks.append(task)
            self._assigned[name] = self._assigned.get(name, 0) + 1
            if self._assigned[name] == 1:
                self._recount_live()
        return task

    def _unassign(self, task: VTask) -> None:
        name, task.cell = task.cell, None
        tasks = self._tasks.get(name, [])
        if task in tasks:
            tasks.remove(task)
            self._assigned[name] -= 1
            if self._assigned[name] == 0:
                del self._assigned[name]
                self._recount_live()

    def release(self, name: str) -> None:
        """Destroy a cell: drop its allocation from the live multiset,
        evict its warm slot, and clear every assigned task's ``.cell``
        backref — a released name must stop charging interference and
        switch costs even if the same name is created again later."""
        self.cells.pop(name, None)
        self._warm.pop(name, None)
        self._solo.pop(name, None)
        for t in self._tasks.pop(name, ()):
            if t.cell == name:
                t.cell = None
        if self._assigned.pop(name, 0):
            self._recount_live()

    def _recount_live(self) -> None:
        """Rebuild the live-cell aggregates (assign/release only — never
        on the per-live-call hot path).  A full recount in cell creation
        order keeps the float sums bit-identical across engines: every
        replica performs the same op sequence."""
        live = [c for n, c in self.cells.items()
                if self._assigned.get(n, 0) > 0]
        self._n_live = len(live)
        self._live_demand = sum(c.bw_demand for c in live)
        self._live_share = sum(c.bw_share for c in live)

    @property
    def warm_cells(self) -> tuple:
        """Warm-slot contents, LRU-first (introspection/tests)."""
        return tuple(self._warm)

    # -- spatial interference ----------------------------------------------------
    def _slowdown_of(self, c: Cell, others_demand: float,
                     others_share: float) -> float:
        # cache: overflow beyond the cell's partition (CAT guarantees the
        # partition itself; overflow lines miss)
        ways_frac = c.ways / self.total_ways
        overflow = max(0.0, c.working_set_frac - ways_frac)
        s_cache = self.miss_penalty * overflow / max(c.working_set_frac,
                                                     1e-9)
        # bandwidth: MBA share under co-active demand
        total_demand = c.bw_demand + others_demand
        if total_demand > 1.0:
            avail = c.bw_share / max(c.bw_share + others_share, 1e-9)
            got = min(c.bw_demand, avail)
        else:
            got = c.bw_demand
        s_bw = c.mem_frac * max(0.0, c.bw_demand / max(got, 1e-9) - 1.0)
        return 1.0 + s_cache + s_bw

    def slowdown(self, task: VTask,
                 coactive_cells: Optional[List[Optional[str]]] = None
                 ) -> float:
        """Spatial-interference multiplier for one live call.

        With ``coactive_cells=None`` (the engine hot path) the co-active
        set is the host's live-cell multiset — O(1) aggregate reads, no
        task scan.  An explicit list overrides it (calibration and unit
        tests)."""
        if not task.cell or task.cell not in self.cells:
            return 1.0
        c = self.cells[task.cell]
        if coactive_cells is None:
            own_live = self._assigned.get(c.name, 0) > 0
            n_others = self._n_live - (1 if own_live else 0)
            others_demand = self._live_demand - (c.bw_demand if own_live
                                                 else 0.0)
            others_share = self._live_share - (c.bw_share if own_live
                                               else 0.0)
        else:
            others = [self.cells[x] for x in set(coactive_cells)
                      if x and x in self.cells and x != task.cell]
            n_others = len(others)
            others_demand = sum(o.bw_demand for o in others)
            others_share = sum(o.bw_share for o in others)
        s = self._slowdown_of(c, others_demand, others_share)
        # self-pressure (the cell alone) vs spatial interference (the
        # extra multiplier co-active cells add): report stats must mean
        # what they say — a solo working-set overflow is not
        # "interference among co-located live hosts"
        s_solo = self._solo[c.name] if n_others else s
        cs = self._cell_stats[c.name]
        cs["live_calls"] += 1
        if s_solo > 1.0:
            self.stats["self_pressure_events"] += 1
            cs["self_pressure_events"] += 1
        if s > s_solo:
            self.stats["interference_events"] += 1
            cs["interference_events"] += 1
        ppm = int(round(s * 1e6))
        if ppm > cs["max_slowdown_ppm"]:
            cs["max_slowdown_ppm"] = ppm
        b = _bucket(s)
        cs["slowdown_hist"][b] = cs["slowdown_hist"].get(b, 0) + 1
        return s

    # -- temporal residue ----------------------------------------------------------
    def switch_cost(self, task: VTask) -> int:
        """Reconditioning + residue when the task's cell is cold."""
        if not task.cell or task.cell not in self.cells:
            return 0
        if task.cell in self._warm:
            self._warm.move_to_end(task.cell)
            return 0
        if len(self._warm) >= self.n_warm_slots:
            self._warm.popitem(last=False)       # evict LRU (flush)
        self._warm[task.cell] = None
        self.stats["switches"] += 1
        task.stats["cell_switches"] = uses = \
            task.stats.get("cell_switches", 0) + 1
        residue = _hash01(_stable_hash(task.name), uses) \
            * self.residue_frac
        cost = int(self.recondition_ns * (1.0 + residue))
        self.stats["recondition_ns"] += cost
        cs = self._cell_stats[task.cell]
        cs["switches"] += 1
        cs["recondition_ns"] += cost
        return cost

    # -- reporting -------------------------------------------------------------
    def snapshot(self) -> Optional[Dict[str, Any]]:
        """JSON-able per-host cell report (``SimReport.cells`` section),
        or None when this host never had cells (keeps cell-less reports
        and goldens unchanged).  Integer-valued throughout, so
        cross-engine equality checks are exact."""
        if not self._cell_stats and not any(self.stats.values()):
            return None
        cells = {}
        for name in sorted(self._cell_stats):
            st = self._cell_stats[name]
            cells[name] = {
                "assigned": self._assigned.get(name, 0),
                "live_calls": st["live_calls"],
                "interference_events": st["interference_events"],
                "self_pressure_events": st["self_pressure_events"],
                "switches": st["switches"],
                "recondition_ns": st["recondition_ns"],
                "max_slowdown_ppm": st["max_slowdown_ppm"],
                "slowdown_hist": dict(st["slowdown_hist"]),
            }
        return {"switches": self.stats["switches"],
                "recondition_ns": self.stats["recondition_ns"],
                "interference_events": self.stats["interference_events"],
                "self_pressure_events":
                    self.stats["self_pressure_events"],
                "cells": cells}
