"""DistCoordinator: multi-process distributed simulation orchestration.

The parent-process control plane of the dist engine.  It forks
``n_workers`` OS processes *before* the facade builds anything (so every
worker derives a bit-identical replica, see ``repro_torch.dist.worker``),
partitions the topology's hosts contiguously across them, and then runs
the same conservative per-link-lookahead clock protocol as
``Orchestrator(mode="async")`` — except that host windows execute in
real parallel processes and the LBTS clock bounds travel over pipes.

Round structure — one coalesced round-trip per round:

* The coordinator computes LBTS clock bounds and per-host
  earliest-input times with the same :class:`~repro_torch.core.orchestrator.
  LBTSSolver` the in-process async engine uses, from each host's
  last-reported conservative next-event time *capped by the forwarded
  send vtime of any envelope being delivered this round* (a delivered
  message can wake its receiver no earlier than that, so the capped
  bounds are always conservative — see ``repro_torch.dist.worker``).
* One packed binary ``STEP`` frame per worker carries that worker's
  bounds + replica-state deltas + inbound envelope records; the worker
  injects, runs its windows, and answers with one ``REPLY`` frame
  (``repro_torch.dist.frames``).  The old protocol paid two pickled
  round-trips per round (phase A sync + phase B run) — coalescing and
  struct-packing is most of the dist engine's wall-clock win.
* **Adaptive skip**: a worker whose last reply showed no activity is
  not stepped at all while it has no inbound envelopes, no relevant
  replica updates, and unchanged bounds — re-running it would provably
  be a no-op, so its cached clock state is reused.
* **Sole-worker fast path**: with one worker there are no
  cross-partition channels, so the worker free-runs the in-process
  async engine (``run_all``) instead of paying a round-trip per window.

Deadlock mirrors the in-process engines: a full round with no
dispatches, wakes, replica changes, or delivered envelopes while work
remains is a wedged simulation — reported as
``SimReport.status == "deadlock"``, not a crash.

Fault containment: workers are daemon processes, every coordinator
receive has a timeout (``Simulation.run(worker_timeout=...)`` plumbs
straight through to the per-reply ``poll``), and shutdown always
terminates stragglers — a hung or crashed worker fails the run fast
instead of wedging the caller (or CI).

Caveat: workers are *forked* (workload closures are not picklable),
and the parent has often touched CUDA already (a vectorized run, a
campaign's sweep, a served model).  A CUDA context does not survive a
fork, so the workers never use the card: the sim substrate they run is
pure Python + numpy (``repro_torch.core``, ``repro_torch.sim.report``),
and PyTorch marks a child forked after CUDA initialisation as a bad
fork, in which any CUDA call raises at once instead of wedging.  A
worker that wedges anyway (in a lock some parent thread held at the
fork) is contained by ``timeout`` rather than prevented.  The
coordinator does not refuse to fork from a parent that touched CUDA: a
campaign classifies any exception of a point as ``crash``, so such a
refusal would turn every point of a dist campaign into a crash and hide
its cause.
"""
from __future__ import annotations

import multiprocessing
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.orchestrator import LBTSSolver
from repro_torch.dist import frames
from repro_torch.sim.live import merge_live_sections
from repro_torch.sim.report import SimReport, _jsonable


class DistWorkerError(RuntimeError):
    """A worker crashed, hung past the timeout, or closed its pipe.

    ``worker`` is the failing worker's index when known;
    ``worker_traceback`` carries the worker-side traceback text for
    error-frame failures (a crash inside the replica), so callers —
    the fault-campaign harness in particular — can capture *why* a
    point crashed without parsing the message."""

    def __init__(self, message: str, *, worker: int = -1,
                 worker_traceback: str = ""):
        super().__init__(message)
        self.worker = worker
        self.worker_traceback = worker_traceback


def partition_hosts(n_hosts: int, n_workers: int) -> List[List[int]]:
    """Contiguous near-equal blocks: keeps rack-style topologies (hosts
    grouped contiguously) mostly intra-partition, minimizing
    cross-partition channels."""
    base, extra = divmod(n_hosts, n_workers)
    out, start = [], 0
    for w in range(n_workers):
        size = base + (1 if w < extra else 0)
        out.append(list(range(start, start + size)))
        start += size
    return out


class DistCoordinator:
    def __init__(self, sim, n_workers: int = 2, *,
                 max_rounds: int = 1_000_000, timeout: float = 120.0):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if sim._built:
            raise ValueError(
                "the dist engine forks workers that build their own "
                "replicas; run() it on an unbuilt Simulation")
        self.sim = sim
        self.n_workers = min(n_workers, sim.topology.n_hosts)
        self.partitions = partition_hosts(sim.topology.n_hosts,
                                          self.n_workers)
        self.owner = {h: w for w, hosts in enumerate(self.partitions)
                      for h in hosts}
        self.max_rounds = max_rounds
        self.timeout = timeout
        self.rounds = 0
        self.envelopes_routed = 0
        self.worker_skips = 0        # adaptive skips of idle workers
        self.membership_epochs = 0   # epoch flips (joins activated)
        self._conns: List[Any] = []
        self._procs: List[Any] = []

    # -- worker lifecycle ----------------------------------------------------
    def _spawn(self) -> None:
        from repro_torch.dist.worker import worker_main
        try:
            ctx = multiprocessing.get_context("fork")
        except ValueError as e:          # pragma: no cover - non-POSIX
            raise DistWorkerError(
                "dist engine needs the fork start method (workload "
                "closures are not picklable)") from e
        for w in range(self.n_workers):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=worker_main, name=f"dist-worker-{w}",
                args=(self.sim, w, self.partitions, child), daemon=True)
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)

    def _shutdown(self) -> None:
        """Every reply the run needs has been received by the time this
        runs (success or failure), so workers are terminated outright —
        a hung worker must never stall the caller's exit path."""
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
        for proc in self._procs:
            proc.join(timeout=5.0)
            if proc.is_alive():                 # pragma: no cover
                proc.kill()
                proc.join(timeout=5.0)

    def _send(self, w: int, frame: bytes) -> None:
        try:
            self._conns[w].send_bytes(frame)
        except (BrokenPipeError, OSError) as e:
            raise DistWorkerError(f"dist worker {w} died: {e}") from e

    def _recv(self, w: int, expect) -> Any:
        """Receive one frame (timeout-guarded).  ``expect`` is a pickle
        sub-tag or ``"reply"`` for the binary REPLY frame; a tuple of
        sub-tags returns ``(sub_tag, payload)`` instead."""
        conn = self._conns[w]
        if not conn.poll(self.timeout):
            raise DistWorkerError(
                f"dist worker {w} hung (> {self.timeout}s without a "
                f"{expect!r} reply)")
        try:
            frame = conn.recv_bytes()
        except EOFError as e:
            raise DistWorkerError(f"dist worker {w} died mid-run",
                                  worker=w) from e
        tag = frame[:1]
        if tag == frames.TAG_PICKLE:
            sub, payload = frames.unpack_pickle(frame)
            if sub == "error":
                raise DistWorkerError(
                    f"dist worker {w} failed:\n{payload}",
                    worker=w, worker_traceback=str(payload))
            if isinstance(expect, tuple):
                if sub in expect:
                    return sub, payload
            elif sub == expect:
                return payload
            raise DistWorkerError(
                f"dist worker {w}: expected {expect!r}, got {sub!r}")
        if tag == frames.TAG_REPLY and expect == "reply":
            return frames.Reply(frame)
        raise DistWorkerError(
            f"dist worker {w}: expected {expect!r}, got frame {tag!r}")

    # -- the run -------------------------------------------------------------
    def run(self) -> SimReport:
        t0 = time.perf_counter()
        # the parent sim never builds (workers build their own
        # replicas), so clear run-scoped workload state here: the
        # parent's progress arrays are merge *targets* (_merge_progress
        # max-merges into them), and stale values from a previous run
        # of the same Workload instance would double-count.  Resetting
        # before the fork also hands every worker a clean replica.
        for wl in self.sim.workloads:
            wl.reset()
        self._spawn()
        try:
            readies = [self._recv(w, "ready")
                       for w in range(self.n_workers)]
            if self.n_workers == 1:
                status, detail, info = self._run_sole_worker()
            else:
                status, detail, info = self._run_rounds(readies)
            for w in range(self.n_workers):
                self._send(w, frames.pack_pickle("finalize", None))
            reports = [self._recv(w, "report")
                       for w in range(self.n_workers)]
            wall = time.perf_counter() - t0
            return self._merge(status, detail, wall, reports, info)
        finally:
            self._shutdown()

    def _run_sole_worker(self) -> Tuple[str, str, dict]:
        """One worker owns every host: no cross-partition channels, so
        it free-runs the async engine.  The worker heartbeats a "tick"
        every bounded chunk of rounds, so ``timeout`` stays a per-reply
        liveness bound — a long healthy run keeps ticking, a hung
        worker still fails fast."""
        self._send(0, frames.pack_pickle("run_all", self.max_rounds))
        while True:
            msg = self._recv(0, ("tick", "ran_all"))
            if msg[0] == "ran_all":
                ran = msg[1]
                self.rounds = ran["rounds"]
                return ran["status"], ran["detail"], ran.get("info", {})

    def _run_rounds(self, readies: List[Dict[str, Any]]
                    ) -> Tuple[str, str, dict]:
        # wire tables are identical across workers (bit-identical
        # replicas): take worker 0's
        lookahead = readies[0]["lookahead"]
        hub_names = readies[0]["hub_names"]
        hub_host = readies[0]["hub_host"]
        task_names = readies[0]["task_names"]
        task_idx = {n: i for i, n in enumerate(task_names)}
        hub_idx_host = [hub_host[n] for n in hub_names]
        interests: List[Set[int]] = [
            {task_idx[n] for n in r["imports"]} for r in readies]
        next_times: Dict[int, Optional[int]] = {}
        unfinished: List[bool] = []
        for r in readies:
            next_times.update(r["next_times"])
            unfinished.append(r["unfinished"])
        # membership epochs, mirroring Orchestrator._run_async: joiners
        # (join vtime > 0, identical in every replica) stay out of the
        # LBTS closure — and every active bound is clamped at the
        # earliest pending join vtime — until the active set provably
        # cannot act below it; then the closure re-solves over the grown
        # graph.  Joiners keep their build-time partition owner, so no
        # repartitioning message traffic is needed at a flip.
        join_vtime: Dict[int, int] = readies[0].get("join_vtime") or {
            h: 0 for h in next_times}
        active = sorted(h for h, t in join_vtime.items() if t <= 0)
        pending_joins = sorted(
            (t, h) for h, t in join_vtime.items() if t > 0)
        self.membership_epochs = 0

        def _epoch_solver() -> LBTSSolver:
            member = set(active)
            return LBTSSolver(
                {e: la for e, la in lookahead.items()
                 if e[0] in member and e[1] in member}, active)

        def _flip_or_wedge() -> bool:
            """A round made no progress: if a join is still pending,
            the epoch flip *is* the progress (mirrors the in-process
            engine's no-progress flip); otherwise the simulation is
            truly wedged."""
            if not pending_joins:
                return False
            t0 = pending_joins[0][0]
            while pending_joins and pending_joins[0][0] == t0:
                active.append(pending_joins.pop(0)[1])
            active.sort()
            self.membership_epochs += 1
            return True

        solver = _epoch_solver()
        W = range(self.n_workers)
        pending: List[List[bytes]] = [[] for _ in W]
        caps: Dict[int, int] = {}   # host -> min in-flight send vtime
        updates: Dict[int, Tuple[int, int]] = {}
        last_bounds: List[Optional[Dict[int, Optional[int]]]] = \
            [None for _ in W]
        idle = [False for _ in W]
        for _ in range(self.max_rounds):
            if not any(unfinished) and not any(pending):
                # note the pending check: a message can still be in
                # flight after every task finished (e.g. a send to a
                # task that died without receiving) — it must be
                # delivered and replayed anyway or message/byte totals
                # and link stats diverge from the in-process engines
                return "ok", "", {}
            eff_next = dict(next_times)
            for h, cap in caps.items():
                cur = eff_next[h]
                eff_next[h] = cap if cur is None else min(cur, cap)
            while pending_joins:
                # flip condition uses the envelope-capped next times: an
                # in-flight message below the join vtime may still
                # enable active-set progress there
                gmin = min((t for t in (eff_next[h] for h in active)
                            if t is not None), default=None)
                if gmin is not None and gmin < pending_joins[0][0]:
                    break
                t0 = pending_joins[0][0]
                while pending_joins and pending_joins[0][0] == t0:
                    active.append(pending_joins.pop(0)[1])
                active.sort()
                solver = _epoch_solver()
                self.membership_epochs += 1
            clamp = pending_joins[0][0] if pending_joins else None
            lb = solver.bounds(eff_next)
            bounds = {}
            for h in next_times:
                if h in join_vtime and join_vtime[h] > 0 \
                        and h not in solver._idx:
                    # pending joiner: nothing of it exists below its
                    # join vtime, so this bound is a provable no-op
                    bounds[h] = join_vtime[h]
                    continue
                b = solver.eit(h, lb)
                if clamp is not None:
                    b = clamp if b is None else min(b, clamp)
                bounds[h] = b
            stepped: List[int] = []
            delivered = False
            for w in W:
                wb = {h: bounds[h] for h in self.partitions[w]}
                w_up = {i: v for i, v in updates.items()
                        if i in interests[w]}
                if (idle[w] and not pending[w] and not w_up
                        and wb == last_bounds[w]):
                    # provably a no-op round for this worker: no new
                    # inputs and an unchanged window
                    self.worker_skips += 1
                    continue
                delivered = delivered or bool(pending[w])
                self._send(w, frames.pack_step(wb, w_up, pending[w]))
                pending[w] = []
                last_bounds[w] = wb
                stepped.append(w)
            if not stepped:
                if _flip_or_wedge():
                    solver = _epoch_solver()
                    continue
                return ("deadlock", "distributed simulation wedged",
                        self._wedge_info(unfinished, pending_joins))
            self.rounds += 1
            updates = {}
            caps = {}
            progressed = delivered
            for w in stepped:
                r = self._recv(w, "reply")
                unfinished[w] = r.unfinished
                worked = bool(r.applied or r.dispatches or r.wakes
                              or r.lazy_changed or r.envelopes)
                idle[w] = not worked
                progressed = progressed or worked
                next_times.update(r.next_times)
                updates.update(r.task_states)
                for dst_hub, send_vt, record in r.envelopes:
                    host = hub_idx_host[dst_hub]
                    pending[self.owner[host]].append(record)
                    prev = caps.get(host)
                    caps[host] = (send_vt if prev is None
                                  else min(prev, send_vt))
                    self.envelopes_routed += 1
            if not progressed:
                if _flip_or_wedge():
                    solver = _epoch_solver()
                    continue
                return ("deadlock", "distributed simulation wedged",
                        self._wedge_info(unfinished, pending_joins))
        return ("deadlock", (f"dist engine exceeded {self.max_rounds} "
                             f"rounds without finishing"),
                self._wedge_info(unfinished, pending_joins))

    def _wedge_info(self, unfinished: List[bool],
                    pending_joins: List[Tuple[int, int]]) -> dict:
        """Structured deadlock detail (``SimReport.detail_info``):
        hosts of the workers still holding unfinished work, plus any
        joins that never activated."""
        return {
            "kind": "wedged",
            "wedged_hosts": sorted(
                h for w, unf in enumerate(unfinished) if unf
                for h in self.partitions[w]),
            "pending_joins": [{"host": h, "vtime": t}
                              for t, h in pending_joins],
        }

    # -- report merging ------------------------------------------------------
    def _merge_progress(self, worker_progress: List[Dict[str, dict]]
                        ) -> Dict[str, Any]:
        """Each worker ran a disjoint subset of programs, so its copies
        of the monotone progress counters are authoritative where it
        executed and zero elsewhere: merge by elementwise maximum, and
        write the merged arrays back into the parent's workload objects
        so ``wl.progress()`` reads post-run, like in-process."""
        for wl in self.sim.workloads:
            mine = wl.progress()
            for wp in worker_progress:
                for key, value in wp.get(wl.name, {}).items():
                    cur = mine.get(key)
                    if isinstance(cur, np.ndarray) and \
                            isinstance(value, np.ndarray):
                        np.maximum(cur, value, out=cur)
                    elif cur is None or (np.isscalar(cur)
                                         and np.isscalar(value)
                                         and value > cur):
                        mine[key] = value
        return {wl.name: _jsonable(wl.progress())
                for wl in self.sim.workloads}

    def _merge(self, status: str, detail: str, wall: float,
               reports: List[Dict[str, Any]],
               detail_info: Optional[dict] = None) -> SimReport:
        sim = self.sim
        hosts = sorted((hr for r in reports for hr in r["hosts"]),
                       key=lambda hr: hr.host)
        links: Dict[str, Dict[str, int]] = {}
        for r in reports:
            links.update(r["links"])
        tasks: Dict[str, Dict[str, Any]] = {}
        merged_tasks = {}
        for r in reports:
            merged_tasks.update(r["tasks"])
        for _, prog in sim._programs():    # declaration order, like
            tasks[prog.name] = merged_tasks[prog.name]   # in-process
        cells: Dict[str, Any] = {}
        for r in reports:                  # per-host, owner-disjoint
            cells.update(r["cells"])
        cells = {h: cells[h] for h in sorted(cells, key=int)}
        # control-plane timeline: workload sections come from the one
        # worker owning the controller task (first non-empty wins, like
        # live); the membership timeline is build-time data identical
        # across replicas, so worker 0's copy is authoritative
        control: Dict[str, Any] = {}
        for r in reports:
            for wl_name, sec in r.get("control", {}).items():
                control.setdefault(wl_name, sec)
        membership = next((r["membership"] for r in reports
                           if r.get("membership")), [])
        if membership:
            control["membership"] = membership
        elif control:
            control["membership"] = []
        return SimReport(
            status=status, mode="dist", n_hosts=sim.topology.n_hosts,
            vtime_ns=max(r["horizon"] for r in reports),
            wall_s=wall,
            messages=sum(r["messages"] for r in reports),
            bytes=sum(r["bytes"] for r in reports),
            sync_rounds=self.rounds,
            proxy_syncs=sum(r["proxy_syncs"] for r in reports),
            cross_host_msgs=sum(st["messages"] for st in links.values()),
            max_proxy_staleness_ns=max(
                r["max_proxy_staleness_ns"] for r in reports),
            max_window_ns=max(r["max_window_ns"] for r in reports),
            hosts=hosts, links=links, tasks=tasks,
            progress=self._merge_progress(
                [r["progress"] for r in reports]),
            scenario=sim.scenario.name, detail=detail,
            n_workers=self.n_workers, cells=cells,
            live=merge_live_sections([r.get("live", {})
                                      for r in reports]),
            control=control, detail_info=dict(detail_info or {}))


def run_dist(sim, n_workers: int = 2, *, max_rounds: int = 1_000_000,
             timeout: float = 120.0) -> SimReport:
    """Run an unbuilt facade Simulation across ``n_workers`` OS worker
    processes; see :class:`DistCoordinator`."""
    return DistCoordinator(sim, n_workers, max_rounds=max_rounds,
                           timeout=timeout).run()
