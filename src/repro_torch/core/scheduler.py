"""Simulation-oriented scheduling (paper §3.2): the reference engine.

Deterministic in-process realization of LiveStack's scheduler:

* vtasks yield actions (see ``repro_torch.core.vtask``); the yield points are
  the dispatch boundaries.
* Per round, up to ``n_cpus`` runnable vtasks satisfying the bounded-skew
  condition in **every** scope are dispatched (lowest-vtime first,
  deterministic id tie-break).  The globally minimal runnable vtask is
  always eligible (see ``tests/test_scheduler.py::test_no_livelock``), so
  the simulation cannot livelock while work remains.
* Live vtasks advance clock-derived vtime (measured host span x
  calibration, scaled by the cell-interference factor — imperfect
  isolation is folded into simulated time, §3.3); modeled vtasks advance
  by reported latency (sync return or async RunPage), and are preempted
  to FAULTY after ``preempt_after`` consecutive zero-progress dispatches.
* Blocked vtasks are excluded from scope minima; wake-up forwards their
  vtime to the wake-up's causal timestamp (message visibility time /
  event fire time) — deterministic regardless of how the orchestrator
  windows execution, so every engine produces identical timings.

Hot-path structure (this is the per-round inner loop of every engine,
so none of it may scan the full task list):

* ``_runq`` — a lazy-invalidation min-heap of ``(vtime, id)`` over
  runnable non-proxy vtasks.  Entries go stale when a vtask blocks,
  finishes, or advances; stale entries are discarded at pop time
  (``_runq_v``/``_runq_on`` track the single live entry per vtask).
  Dispatch pops the heap in exactly the ``(vtime, id)`` order the old
  full sort produced, so dispatch order — and therefore every result —
  is bit-identical to the scan-based scheduler.
* ``_wake_q`` / ``_next_q`` — the visibility/event index: blocked
  vtasks with a known pending wake-up (message visibility or event fire
  time) are heap-indexed by that time (``_wake_q``) and by their
  conservative next-event time ``max(vtime, visibility)`` (``_next_q``).
  Wake passes drain only the entries below the window gate and
  ``next_time()`` peeks both heads, instead of scanning every task and
  every inbox per round.  Index entries are *hints*: ``_try_wake``
  revalidates everything, so stale entries are harmless.
* Scope minima are maintained incrementally by the scopes themselves
  (see ``repro_torch.core.scope``): O(log n) heap pushes on vtime changes
  replace the O(members) recompute per invalidation.
* Cell co-activity (§3.3) is read from the :class:`CellManager`'s
  per-host live-cell multiset — O(1) aggregate reads per LiveCall,
  replacing the old O(tasks) coactive scan (see ``repro_torch.core.cells``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional

from repro_torch.core import scope as scope_mod
from repro_torch.core.cells import CellManager
from repro_torch.core.vtask import (Await, Compute, LiveCall, Recv, Send, State,
                              VTask, Yield)


@dataclasses.dataclass
class SchedStats:
    rounds: int = 0
    dispatches: int = 0
    live_calls: int = 0
    preemptions: int = 0
    skew_stalls: int = 0          # eligible-check rejections
    max_skew_seen: int = 0
    window_runs: int = 0          # run_until invocations (orchestrator)
    gate_deferrals: int = 0       # wake-ups deferred past a strict bound
    wakes: int = 0                # successful blocked->runnable wake-ups


class DeadlockError(RuntimeError):
    """Conservative engines raise this when no task can make progress.

    ``info`` is an optional structured detail (surfaced as
    ``SimReport.detail_info``): engines populate it with the wedged
    hosts and, for membership scenarios, any still-pending joins, so a
    failure names the responsible host instead of only carrying prose.
    """

    def __init__(self, message: str, info: Optional[dict] = None):
        super().__init__(message)
        self.info: dict = dict(info or {})


class Scheduler:
    def __init__(self, host: int = 0, n_cpus: int = 8,
                 cells: Optional[CellManager] = None,
                 preempt_after: int = 100,
                 send_overhead_ns: int = 500,
                 distributed: bool = False,
                 cpu_resource: bool = False):
        self.host = host
        self.n_cpus = n_cpus
        # cell state is keyed by host (one manager per simulated host,
        # facade-constructed in every engine); the default manager
        # inherits this scheduler's host id
        self.cells = cells or CellManager(host=host)
        self.tasks: List[VTask] = []
        self.preempt_after = preempt_after
        self.send_overhead_ns = send_overhead_ns
        self.distributed = distributed   # a remote host may still wake us
        # cpu_resource: model the host's CPUs as contended resources in
        # *virtual time* (per-CPU busy-until).  In the paper this happens
        # implicitly — vCPUs execute on real, time-shared cores and the
        # pvclock measures it; in-process live calls execute solo, so
        # co-located compute must queue for a simulated CPU instead.
        # Leave False for cluster sims where every vtask is its own
        # machine.
        self.cpu_resource = cpu_resource
        self._cpu_free_at: List[int] = [0] * n_cpus
        self.stats = SchedStats()
        # strict window bound for the round being dispatched (async
        # engine); read by _exec_action so Recv/Await cannot idle-advance
        # a task past it.  Carried on the scheduler, not the _dispatch
        # signature, so tests may still wrap _dispatch(task).
        self._strict_gate: Optional[int] = None
        # hot-path indexes (see module docstring)
        self._runq: List[tuple] = []       # (vtime, id, task), lazy
        self._wake_q: List[tuple] = []     # (wake time, id, task), lazy
        self._next_q: List[tuple] = []     # (max(vtime, wake), id, task)
        self._n_blocked = 0                # blocked non-proxy tasks
        self._n_unfinished = 0             # runnable+blocked non-proxy

    # -- registration --------------------------------------------------------
    def spawn(self, task: VTask) -> VTask:
        task.host = self.host
        task.sched = self
        if task.cell is not None and task.cell in self.cells.cells:
            # constructor-labelled cell (VTask(cell=...)): register it
            # in this host's live-cell multiset so it spatially
            # interferes like an explicitly assign()ed task.  An
            # unknown name keeps the core's lenient no-op semantics
            # (the facade validates declarations at build time).
            self.cells.assign(task, task.cell)
        self.tasks.append(task)
        if task.kind != "proxy":
            if task.state in (State.RUNNABLE, State.BLOCKED):
                self._n_unfinished += 1
            if task.state == State.BLOCKED:
                self._n_blocked += 1
        self._runq_push(task)
        for s in task.scopes:
            s.notify(task)
        return task

    # -- runnable index ------------------------------------------------------
    def _runq_push(self, task: VTask) -> None:
        """Ensure a live heap entry exists for a runnable non-proxy task
        at its current vtime (no-op otherwise; duplicates are avoided by
        tracking the one live entry per task)."""
        if task.state is not State.RUNNABLE or task.kind == "proxy":
            return
        if task._runq_on and task._runq_v == task.vtime:
            return
        task._runq_on = True
        task._runq_v = task.vtime
        heapq.heappush(self._runq, (task.vtime, task.id, task))

    def _runq_head(self) -> bool:
        """Drop stale heap heads; True iff a valid head remains."""
        q = self._runq
        while q:
            v, _, t = q[0]
            if t._runq_on and t._runq_v == v:
                if t.state is State.RUNNABLE and t.vtime == v:
                    return True
                t._runq_on = False      # the live entry went stale
            heapq.heappop(q)
        return False

    def _runq_min(self) -> Optional[int]:
        return self._runq[0][0] if self._runq_head() else None

    # -- visibility/event index ----------------------------------------------
    def _wait_push(self, task: VTask, wake_time: Optional[int]) -> None:
        """Index a blocked task's pending wake-up (message visibility /
        event fire time).  Called at block time, by Endpoint.deliver for
        messages arriving while blocked, and by Event.fire."""
        if wake_time is None or task.kind == "proxy":
            return
        if task._wait_on and task._wait_v is not None \
                and task._wait_v <= wake_time:
            return                  # an earlier-or-equal entry is live
        task._wait_on = True
        task._wait_v = wake_time
        heapq.heappush(self._wake_q, (wake_time, task.id, task))
        heapq.heappush(self._next_q,
                       (max(task.vtime, wake_time), task.id, task))

    def _wake_min(self) -> Optional[int]:
        """Earliest indexed pending wake-up (conservative: may be lower
        than the true wake time for a re-blocked task, never higher)."""
        q = self._wake_q
        while q:
            v, _, t = q[0]
            if t.state is State.BLOCKED and t._wait_reason is not None:
                return v
            heapq.heappop(q)
        return None

    def _blocked_next_min(self) -> Optional[int]:
        """Min over blocked tasks of max(vtime, pending wake time) —
        the blocked contribution to next_time()."""
        q = self._next_q
        while q:
            k, _, t = q[0]
            if t.state is State.BLOCKED and t._wait_reason is not None:
                kind, obj = t._wait_reason
                v = (obj.head_visibility() if kind == "recv"
                     else obj.set_at_vtime)
                if v is not None and max(t.vtime, v) == k:
                    return k
            heapq.heappop(q)
        return None

    # -- introspection -------------------------------------------------------
    def runnable(self) -> List[VTask]:
        return [t for t in self.tasks if t.state == State.RUNNABLE]

    def unfinished(self) -> List[VTask]:
        return [t for t in self.tasks
                if t.state in (State.RUNNABLE, State.BLOCKED)]

    def has_unfinished(self) -> bool:
        """O(1) liveness check over non-proxy tasks."""
        return self._n_unfinished > 0

    def now(self) -> int:
        """Host-level simulated time = min over unfinished vtasks."""
        vs = [t.vtime for t in self.unfinished()]
        return min(vs) if vs else max(
            (t.vtime for t in self.tasks), default=0)

    def next_time(self) -> Optional[int]:
        """Conservative next-event time: min over runnable real vtasks'
        vtime and blocked vtasks' pending visibility.  Blocked vtasks with
        nothing pending cannot act (or send) until woken, so they do not
        hold the horizon back (classic PDES next-event semantics).
        O(1) amortized via the runnable + visibility indexes."""
        rv = self._runq_min()
        bv = self._blocked_next_min()
        if rv is None:
            return bv
        if bv is None:
            return rv
        return min(rv, bv)

    def quiescent_below(self, bound: Optional[int]) -> bool:
        """True iff a strict ``run_until(bound)`` is provably a no-op:
        nothing runnable and no pending wake-up lies below the bound
        (``bound=None`` checks for any work at all).  The orchestrator
        uses this to skip idle hosts without calling into them."""
        rv = self._runq_min()
        if rv is not None and (bound is None or rv < bound):
            return False
        wv = self._wake_min()
        return wv is None or (bound is not None and wv >= bound)

    def horizon(self) -> int:
        """Completed simulated time = max vtime reached."""
        return max((t.vtime for t in self.tasks), default=0)

    # -- wake-ups -------------------------------------------------------------
    def _try_wake(self, task: VTask, bound: Optional[int] = None) -> bool:
        """Wake a blocked task to its pending visibility/event time.

        ``bound`` (async-engine strict window): a wake-up at or past the
        bound is deferred — a peer that has not run yet could still make
        an *earlier* message visible at the same endpoint, so waking past
        the bound would timestamp the task against the wrong message."""
        reason = task._wait_reason
        if reason is None:
            return False
        kind, obj = reason
        vis = (obj.head_visibility() if kind == "recv"
               else obj.set_at_vtime)
        if vis is None:
            return False
        if bound is not None and vis >= bound:
            self.stats.gate_deferrals += 1
            return False
        scope_mod.wake(task, at_vtime=vis)   # idle-until-interrupt
        task._wait_reason = None
        task._wait_on = False
        task._wait_v = None
        self.stats.wakes += 1
        return True

    def _wake_pass(self, bound: Optional[int] = None) -> None:
        """Wake every blocked task whose indexed pending wake-up lies
        below ``bound`` (everything pending when ``bound`` is None).
        Drains only the index entries below the gate — entries at or
        past it stay for future, larger windows."""
        q = self._wake_q
        while q:
            v, _, t = q[0]
            if bound is not None and v >= bound:
                break
            heapq.heappop(q)
            if t._wait_v == v:
                t._wait_on = False      # live entry consumed
                t._wait_v = None
            if t.state is State.BLOCKED:
                self._try_wake(t, bound=bound)

    # -- one action -----------------------------------------------------------
    def _advance(self, task: VTask, delta_ns: int) -> None:
        if delta_ns < 0:
            raise ValueError("vtime cannot go backwards")
        task.vtime += delta_ns

    def _advance_on_cpu(self, task: VTask, delta_ns: int) -> None:
        """Advance vtime by a compute span, queuing for a simulated CPU
        when cpu_resource accounting is on (virtual-time time-sharing)."""
        if not self.cpu_resource:
            self._advance(task, delta_ns)
            return
        cpu = min(range(self.n_cpus), key=self._cpu_free_at.__getitem__)
        start = max(task.vtime, self._cpu_free_at[cpu])
        end = start + delta_ns
        self._cpu_free_at[cpu] = end
        self._advance(task, end - task.vtime)

    def _block(self, task: VTask, reason) -> None:
        task.state = State.BLOCKED
        task._wait_reason = reason
        self._n_blocked += 1

    def _exec_action(self, task: VTask, action):
        """Returns value to send into the generator on next dispatch.

        ``self._strict_gate`` (strict window bound): a Recv/Await may not
        idle-advance the task to a visibility/event time at or past the
        gate — a peer that has not run yet could still produce an earlier
        input, so the task blocks and is woken through the gated wake
        path instead."""
        gate = self._strict_gate
        if isinstance(action, Compute):
            progress = action.ns + task.run_page.drain()
            self._advance_on_cpu(task, progress)
            if task.kind == "modeled":
                if progress == 0:
                    task.zero_progress += 1
                    if task.zero_progress >= self.preempt_after:
                        task.state = State.FAULTY
                        self._n_unfinished -= 1
                        self.stats.preemptions += 1
                else:
                    task.zero_progress = 0
            return None
        if isinstance(action, LiveCall):
            self.stats.live_calls += 1
            # co-activity comes from the manager's per-host live-cell
            # multiset (O(1) aggregates), not a task scan
            slow = self.cells.slowdown(task)
            if action.cost_ns is not None:
                if action.cost_ns <= 0:
                    raise ValueError(
                        f"task {task.name!r}: LiveCall "
                        f"{action.label or action.fn!r} has "
                        f"cost_ns={action.cost_ns}; live costs must be "
                        f">= 1 ns (a 0-cost live call would let the "
                        f"task spin without advancing vtime)")
                result = action.fn(*action.args, **action.kwargs)
                delta = int(action.cost_ns * slow)
            else:
                result, host_delta = task.clock.measure(
                    action.fn, *action.args, **action.kwargs)
                # zero/negative measured spans (sub-ns callables, timer
                # warp) must still advance vtime — conservative
                # lookahead needs monotone progress
                delta = max(1, int(host_delta * slow))
            delta += self.cells.switch_cost(task)
            task.stats["live_ns"] += delta
            self._advance_on_cpu(task, delta)
            return result
        if isinstance(action, Send):
            hub = action.endpoint.hub
            self._advance(task, self.send_overhead_ns)
            msg = hub.send(action.endpoint.name, action.dst,
                           action.size_bytes, task.vtime, action.payload)
            task.stats["msgs_tx"] += 1
            return msg
        if isinstance(action, Recv):
            msg = action.endpoint.pop_visible(task.vtime)
            if msg is not None:
                task.stats["msgs_rx"] += 1
                return msg
            vis = action.endpoint.head_visibility()
            if vis is not None and (gate is None or vis < gate):
                # message exists but not yet visible: idle until it is
                self._advance(task, vis - task.vtime)
                msg = action.endpoint.pop_visible(task.vtime)
                task.stats["msgs_rx"] += 1
                return msg
            if vis is not None:
                self.stats.gate_deferrals += 1
            self._block(task, ("recv", action.endpoint))
            if task not in action.endpoint._waiters:
                action.endpoint._waiters.append(task)
            self._wait_push(task, vis)
            return None
        if isinstance(action, Await):
            ev = action.event
            if ev.set_at_vtime is not None and (
                    gate is None or ev.set_at_vtime < gate):
                self._advance(task, max(0, ev.set_at_vtime - task.vtime))
                return None
            if ev.set_at_vtime is not None:
                self.stats.gate_deferrals += 1
            self._block(task, ("event", ev))
            if task not in ev.waiters:
                ev.waiters.append(task)
            self._wait_push(task, ev.set_at_vtime)
            return None
        if isinstance(action, Yield):
            return None
        raise TypeError(f"unknown action {action!r}")

    def _dispatch(self, task: VTask) -> None:
        task.stats["dispatches"] += 1
        self.stats.dispatches += 1
        if task._pending_action is not None:
            # retry the action that blocked (Recv/Await); the generator
            # must receive its real result, not None.
            action, task._pending_action = task._pending_action, None
        else:
            send_value = task.result
            task.result = None
            try:
                action = task.body.send(send_value)
            except StopIteration as stop:
                task.state = State.DONE
                task.result = getattr(stop, "value", None)
                self._n_unfinished -= 1
                return
        value = self._exec_action(task, action)
        if task.state == State.BLOCKED:
            task._pending_action = action
            return
        task.result = value

    # -- main loop --------------------------------------------------------------
    def step_round(self, until_vtime: Optional[int] = None,
                   strict: bool = False) -> bool:
        """One dispatch round.  Returns False when nothing is left to do
        locally (all done, or stalled on remote proxy vtime / the epoch
        gate — the orchestrator then syncs proxies and resumes).

        ``until_vtime`` is the conservative epoch gate: only vtasks with
        vtime < until_vtime may dispatch this round.  With ``strict``
        (async engine), the gate also applies to wake-ups: a blocked
        vtask whose pending visibility lies at or past the gate stays
        blocked, because a not-yet-sent remote message could still
        become visible *earlier* — waking past the gate would let the
        vtask miss it."""
        self.stats.rounds += 1
        self._wake_pass(until_vtime if strict else None)
        q = self._runq
        if not self._runq_head():
            # nothing runnable; the wake pass above already drained
            # every pending wake-up below the gate
            if self._n_blocked == 0:
                return False            # all done/faulty
            if self.distributed or (strict and until_vtime is not None):
                # a remote host may still deliver; yield to orchestrator
                return False
            blocked = [t for t in self.tasks
                       if t.state == State.BLOCKED and t.kind != "proxy"]
            raise DeadlockError(
                f"host {self.host}: all tasks blocked with no pending "
                f"messages/events: {blocked}")
        if until_vtime is not None and q[0][0] >= until_vtime:
            return False                # everything is past the epoch gate
        # bounded-skew eligibility, lowest-(vtime, id) first — the heap
        # pops in exactly the order the old full sort produced.
        # Ineligible vtasks are re-queued (counted as skew stalls) until
        # peers catch up.
        picked: List[VTask] = []
        stalled: List[VTask] = []
        while len(picked) < self.n_cpus:
            if not self._runq_head():
                break
            v, _, t = q[0]
            if until_vtime is not None and v >= until_vtime:
                break
            heapq.heappop(q)
            t._runq_on = False
            if scope_mod.all_eligible(t):
                picked.append(t)
            else:
                self.stats.skew_stalls += 1
                stalled.append(t)
        for t in stalled:
            self._runq_push(t)
        if not picked:
            # every dispatchable vtask is skew-bound behind a proxy (remote)
            # vtime: yield to the orchestrator for a proxy sync.
            return False
        if len(picked) == self.n_cpus and self._runq_head():
            # visibility probe: the next-in-line vtask is examined even
            # though the CPUs are full, so a skew-held vtask still shows
            # up in the stall counter (the old full scan counted every
            # ineligible runnable per round).
            v, _, t = q[0]
            if (until_vtime is None or v < until_vtime) \
                    and not scope_mod.all_eligible(t):
                self.stats.skew_stalls += 1
        self._strict_gate = until_vtime if strict else None
        try:
            for t in picked:
                for s in t.scopes:
                    sv = s.vtime
                    if sv >= 0:
                        self.stats.max_skew_seen = max(
                            self.stats.max_skew_seen, t.vtime - sv)
                v_before = t.vtime
                self._dispatch(t)
                if t.state is State.RUNNABLE:
                    self._runq_push(t)
                    if t.vtime != v_before:
                        for s in t.scopes:
                            s.notify(t)
        finally:
            self._strict_gate = None
        return True

    def run(self, max_rounds: int = 10_000_000,
            until_vtime: Optional[int] = None) -> SchedStats:
        for _ in range(max_rounds):
            if not self.step_round(until_vtime):
                break
        return self.stats

    def run_until(self, bound: Optional[int],
                  max_rounds: int = 10_000_000) -> int:
        """Async-engine hook: drain every action strictly below ``bound``
        (None = no bound) without ever waking a vtask past it.  Returns
        the number of dispatches performed in this window."""
        self.stats.window_runs += 1
        before = self.stats.dispatches
        for _ in range(max_rounds):
            if not self.step_round(until_vtime=bound, strict=True):
                break
        return self.stats.dispatches - before
