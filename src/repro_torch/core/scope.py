"""Synchronization scopes (paper §3.2, "Dispatch").

A scope groups vtasks that must progress together within a bounded
virtual-time skew.  A vtask may belong to multiple scopes; dispatch
eligibility requires the bound to hold in *every* scope.

scope.vtime (the member minimum) is computed over RUNNABLE members only —
blocked vtasks are excluded (they cannot make progress and would pin the
minimum, deadlocking e.g. VM boot where halted vCPUs lag the bootstrap
vCPU).  On wake, a previously blocked vtask's vtime is forwarded to the
wake-up's *causal* timestamp — the message visibility / event fire time
(a sleeper observes that time moved up to the interrupt that woke it).
Forwarding must depend on nothing else: the scope's current member
minimum is a function of the orchestration engine's window schedule, so
forwarding to it would give every engine (single / barrier / async /
multi-process dist) different timings for the same simulation.

The minimum is tracked *incrementally*: each scope keeps a lazy
min-heap of ``(vtime, id)`` member entries.  ``notify(task)`` pushes a
fresh entry in O(log n) whenever a member's vtime changes or it becomes
runnable (vtime is monotone, so stale entries are always <= the true
value and surface at the head, where the query discards them); blocked/
finished/removed members need no bookkeeping at all — their entries
fail the validity check at query time.  This replaces the O(members)
recompute per invalidation that dominated large-scope scheduling.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Set, Tuple

from repro_torch.core.vtask import State, VTask


class Scope:
    def __init__(self, name: str, skew_bound_ns: int):
        self.name = name
        self.skew_bound_ns = int(skew_bound_ns)
        self.members: List[VTask] = []
        self._member_set: Set[VTask] = set()
        self._heap: List[Tuple[int, int, VTask]] = []

    def add(self, task: VTask) -> None:
        if task not in self._member_set:
            self.members.append(task)
            self._member_set.add(task)
            if self not in task.scopes:
                task.scopes.append(self)
            self.notify(task)

    def remove(self, task: VTask) -> None:
        if task in self._member_set:
            self.members.remove(task)
            self._member_set.discard(task)
        if self in task.scopes:
            task.scopes.remove(self)

    def notify(self, task: VTask) -> None:
        """Index a member's current (vtime, state) in O(log n).  Must be
        called whenever a member's vtime changes while runnable or it
        transitions to RUNNABLE; all other transitions are handled
        lazily (stale entries fail validation at query time)."""
        if task.state is State.RUNNABLE:
            heapq.heappush(self._heap, (task.vtime, task.id, task))

    @property
    def vtime(self) -> int:
        """Min vtime over runnable members (-1 if none), amortized O(1):
        pop stale heads (blocked/done/removed members, superseded
        vtimes) until a live entry — the true minimum — surfaces."""
        h = self._heap
        while h:
            v, _, t = h[0]
            if (t.state is State.RUNNABLE and t.vtime == v
                    and t in self._member_set):
                return v
            heapq.heappop(h)
        return -1

    def eligible(self, task: VTask) -> bool:
        sv = self.vtime
        if sv < 0:      # no runnable members -> nothing to lag behind
            return True
        return task.vtime <= sv + self.skew_bound_ns

    def pin_bound(self, task: VTask) -> int:
        """The vtime up to which *other* members may advance while
        ``task`` stays put: beyond task.vtime + skew_bound they become
        ineligible.  Used by the orchestrator's lazy proxy sync — a stale
        proxy needs a refresh only when the host's window reaches past
        its pin bound."""
        return task.vtime + self.skew_bound_ns


def all_eligible(task: VTask) -> bool:
    return all(s.eligible(task) for s in task.scopes)


def wake(task: VTask, at_vtime: Optional[int] = None) -> None:
    """Unblock + forward vtime to the wake-up's causal timestamp
    ``at_vtime`` (message visibility / event fire time).

    Forwarding is *causal only*, never to the scope's current member
    minimum: that minimum reflects how far peers happened to run under
    one engine's window schedule, so using it would make wake timings —
    and therefore simulation results — engine-dependent (the
    single/barrier/async/dist equivalence bar in
    ``tests/engine_harness.py`` is what enforces this)."""
    if task.sched is not None and task.state is State.BLOCKED \
            and task.kind != "proxy":
        task.sched._n_blocked -= 1
    if at_vtime is not None:
        task.vtime = max(task.vtime, at_vtime)
    task.state = State.RUNNABLE
    for s in task.scopes:
        s.notify(task)
    if task.sched is not None:
        task.sched._runq_push(task)
