"""Traffic-driven control plane: autoscaling a serve fleet over a
mutable cluster membership.

The membership half of the story lives in the engines — hosts join and
leave as vtime-stamped simulation events (``Topology.join`` /
``Topology.capacity_pool``, ``JoinHost`` / ``FailHost`` injections,
``Orchestrator.add_host`` / ``retire_host``).  This module supplies the
*control plane* that reacts to traffic on top of that substrate:
:class:`AutoscaledServe` drives a pool of modeled servers through an
open-loop arrival schedule (:func:`~repro_torch.sim.workloads.poisson_arrivals`
/ :func:`~repro_torch.sim.workloads.diurnal_arrivals` /
:func:`~repro_torch.sim.workloads.burst_arrivals`), scaling the active fleet
with a pluggable :class:`ThresholdAutoscaler` and routing each request
with a pluggable placement policy (:data:`PLACEMENT_POLICIES`:
``first_fit`` / ``best_fit`` / ``worst_fit``).

Topology integration: ``Topology.capacity_pool`` declares *when
capacity arrives* (hosts join on a provisioning timeline); the
controller's ``ready_ns`` schedule mirrors it and decides *when traffic
lands on it* — a scale-up can only boot servers whose host has joined.

Determinism: the controller, load balancer and response sink are
co-located on host 0 (``default_placement``), so in the dist engine one
worker owns all control state.  Every scale/placement decision is pure
integer arithmetic over the build-time arrival schedule (the controller
advances to each arrival with modeled compute, so its vtime *is* the
schedule); only measured request latencies come from the simulation —
recorded by the sink at response visibility, which every engine orders
identically.  The resulting ``SimReport.control`` section (decision
timeline, boot/drain counts, health probes, nearest-rank latency
percentiles) is integer-valued and bit-identical across
single/barrier/async/dist — the engine harness compares it exactly.

Protocol (all over one ``ctlnet`` fabric):

* ``("boot", gen)`` — controller -> server: enter the active set; each
  boot starts a fresh generation (a re-booted server counts serves
  against its new generation — fresh state, no resurrection).
* ``("req", j, arr_ns, k)`` — controller -> server ``k``: request
  ``j``, scheduled at ``arr_ns``.
* ``("resp", j, arr_ns, k)`` — server -> sink: request done; the sink
  records ``latency = sink.vtime - arr_ns``.
* ``("drain", )`` — controller -> server: leave the active set (the
  server keeps serving requests already routed to it — channel order
  guarantees those were delivered first).
* ``("probe", seq)`` / ``("ack", seq, k)`` — health check: controller
  probes every active server at a configurable decision cadence;
  servers ack to the sink.
* ``("stop", )`` / ``("fin", n_acks)`` — shutdown: every pool server
  (booted or not) stops; the sink drains exactly the announced probe
  acks after the last response.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ipc import LinkSpec
from repro_torch.core.vtask import Compute, Recv, Send
from repro_torch.sim.scenario import TaskHandle
from repro_torch.sim.topology import FabricSpec
from repro_torch.sim.workload import EndpointSpec, Program, Workload

# -- placement policies ------------------------------------------------------
#
# A policy picks the server for one request:
#   policy(active, busy_until, now, service_ns, cap_ns) -> server id
# ``active`` is the sorted active set, ``busy_until[k]`` the vtime at
# which server k's modeled backlog drains (the controller charges
# ``service_ns`` per routed request), ``cap_ns`` the backlog a "fit"
# may not exceed.  Pure integer arithmetic; ties break to the lowest id.


def first_fit(active: List[int], busy_until: List[int], now: int,
              service_ns: int, cap_ns: int) -> int:
    """First idle server in id order; all busy -> least backlog."""
    for k in active:
        if busy_until[k] <= now:
            return k
    return min(active, key=lambda k: (busy_until[k], k))


def best_fit(active: List[int], busy_until: List[int], now: int,
             service_ns: int, cap_ns: int) -> int:
    """Deepest backlog that still fits under ``cap_ns`` after taking
    this request (pack tight, keep spare servers idle for scale-down);
    nothing fits -> least backlog."""
    fits = [k for k in active
            if max(busy_until[k] - now, 0) + service_ns <= cap_ns]
    if fits:
        return max(fits, key=lambda k: (max(busy_until[k] - now, 0), -k))
    return min(active, key=lambda k: (max(busy_until[k] - now, 0), k))


def worst_fit(active: List[int], busy_until: List[int], now: int,
              service_ns: int, cap_ns: int) -> int:
    """Least-backlog server (spread wide, minimize per-request queueing)."""
    return min(active, key=lambda k: (max(busy_until[k] - now, 0), k))


PLACEMENT_POLICIES: Dict[str, Callable] = {
    "first_fit": first_fit,
    "best_fit": best_fit,
    "worst_fit": worst_fit,
}


@dataclasses.dataclass(frozen=True)
class ThresholdAutoscaler:
    """Utilization-threshold scaling: utilization is measured per
    decision window as offered work over capacity —
    ``reqs * service_ns / (elapsed * n_active)`` — in integer permille.
    Above ``up_x1000`` the active set multiplies by ``factor``; below
    ``down_x1000`` it divides by ``factor`` (never past the caller's
    ``min_active`` / ``max_active``).  ``patience`` is hysteresis: the
    threshold must hold for that many *consecutive* decision windows
    before the fleet moves (jittered open-loop arrivals make single
    windows noisy; patience >= 2 stops flapping).  Pure integers, so
    decisions are bit-identical across engines."""
    up_x1000: int = 750
    down_x1000: int = 300
    factor: int = 2
    patience: int = 1

    def __post_init__(self):
        if not 0 <= self.down_x1000 < self.up_x1000:
            raise ValueError(
                f"need 0 <= down < up, got down={self.down_x1000} "
                f"up={self.up_x1000}")
        if self.factor < 2:
            raise ValueError(f"factor must be >= 2, got {self.factor}")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, "
                             f"got {self.patience}")

    def target(self, util_x1000: int, n_active: int,
               min_active: int, max_active: int) -> int:
        if util_x1000 > self.up_x1000:
            return min(max_active, n_active * self.factor)
        if util_x1000 < self.down_x1000:
            return max(min_active, n_active // self.factor)
        return n_active


class AutoscaledServe(Workload):
    """Open-loop serve fleet under a traffic-driven control plane.

    Programs: ``ctl.lb`` (source + load balancer + autoscaler, one body
    so all control state is serial), ``ctl.sink`` (response collector /
    latency recorder), and ``pool{k}`` for ``k < n_pool`` (modeled
    servers, one per pool host).  ``default_placement`` puts both
    control programs on host 0 and ``pool{k}`` on host ``k + 1`` —
    pair it with ``Topology.capacity_pool`` joining those hosts on the
    ``ready_ns`` schedule.

    ``ready_ns[k]`` is the vtime from which server ``k`` may be booted
    (its host's join vtime; 0 = founding capacity).  At least
    ``min_active`` servers must be ready at vtime 0.
    """

    name = "autoserve"
    CTL = "ctl.lb"
    SINK = "ctl.sink"

    def __init__(self, *, arrivals: Sequence[int], n_pool: int,
                 ready_ns: Optional[Sequence[int]] = None,
                 service_ns: int = 200_000,
                 min_active: int = 1, max_active: Optional[int] = None,
                 decide_every: int = 8,
                 autoscaler: Optional[ThresholdAutoscaler] = None,
                 placement: str = "first_fit",
                 probe_every: int = 0,
                 queue_cap: int = 8,
                 req_bytes: int = 1024, resp_bytes: int = 256,
                 link: LinkSpec = LinkSpec(bandwidth_bps=25e9 * 8,
                                           latency_ns=10_000)):
        arr = np.asarray(arrivals, dtype=np.int64)
        if arr.ndim != 1 or len(arr) == 0:
            raise ValueError("arrivals must be a non-empty 1-D schedule")
        if np.any(arr < 1):
            raise ValueError("arrival vtimes must be >= 1 ns")
        if np.any(np.diff(arr) < 0):
            raise ValueError("arrivals must be non-decreasing")
        if n_pool < 1:
            raise ValueError(f"n_pool must be >= 1, got {n_pool}")
        if service_ns < 1:
            raise ValueError(f"service_ns must be >= 1, got {service_ns}")
        if decide_every < 1:
            raise ValueError(f"decide_every must be >= 1, "
                             f"got {decide_every}")
        if queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        if probe_every < 0:
            raise ValueError(f"probe_every must be >= 0, "
                             f"got {probe_every}")
        ready = ([0] * n_pool if ready_ns is None
                 else [int(v) for v in ready_ns])
        if len(ready) != n_pool:
            raise ValueError(f"ready_ns needs one entry per pool "
                             f"server: {len(ready)} != {n_pool}")
        max_active = n_pool if max_active is None else max_active
        if not 1 <= min_active <= max_active <= n_pool:
            raise ValueError(
                f"need 1 <= min_active <= max_active <= n_pool, got "
                f"{min_active} <= {max_active} <= {n_pool}")
        if sum(1 for v in ready if v <= 0) < min_active:
            raise ValueError(
                f"min_active={min_active} servers must be ready at "
                f"vtime 0; only {sum(1 for v in ready if v <= 0)} are")
        if placement not in PLACEMENT_POLICIES:
            raise ValueError(
                f"unknown placement policy {placement!r}; "
                f"available: {sorted(PLACEMENT_POLICIES)}")
        self.arrivals = arr
        self.n_pool = n_pool
        self.ready_ns = ready
        self.service_ns = service_ns
        self.min_active = min_active
        self.max_active = max_active
        self.decide_every = decide_every
        self.autoscaler = autoscaler or ThresholdAutoscaler()
        self.placement_name = placement
        self.probe_every = probe_every
        self.queue_cap = queue_cap
        self.req_bytes = req_bytes
        self.resp_bytes = resp_bytes
        self.link = link
        self._sink_handle = TaskHandle()
        # progress arrays (monotone counters: the dist merge max-folds
        # per-worker copies, so each must be written by one owner only)
        n = len(arr)
        self.sent = np.zeros(1, dtype=np.int64)        # ctl
        self.served = np.zeros(1, dtype=np.int64)      # sink
        self.routed = np.zeros(n_pool, dtype=np.int64)     # ctl
        self.served_by = np.zeros(n_pool, dtype=np.int64)  # server k
        self.boots = np.zeros(n_pool, dtype=np.int64)      # server k
        self.drains = np.zeros(n_pool, dtype=np.int64)     # server k
        self.probe_acks = np.zeros(1, dtype=np.int64)  # sink
        # control timeline (ctl + sink state; host 0's worker owns both)
        self.latencies = np.zeros(n, dtype=np.int64)
        self.decisions: List[Dict[str, int]] = []
        self.peak_active = 0
        self.probes_sent = 0
        self.boots_sent = 0
        self.drains_sent = 0

    # -- bodies --------------------------------------------------------------
    def _ctl_factory(self, eps):
        ep = eps["ctl.lb.ep"]

        def body():
            arr = self.arrivals
            scaler = self.autoscaler
            policy = PLACEMENT_POLICIES[self.placement_name]
            service = self.service_ns
            cap_ns = self.queue_cap * service
            busy_until = [0] * self.n_pool
            gen = [0] * self.n_pool
            active: List[int] = []

            def boot(k: int) -> Send:
                gen[k] += 1
                active.append(k)
                active.sort()
                self.boots_sent += 1
                return Send(ep, f"pool.srv{k}", 64,
                            payload=("boot", gen[k]))

            # initial fleet: lowest-id servers ready at vtime 0
            for k in range(self.n_pool):
                if len(active) >= self.min_active:
                    break
                if self.ready_ns[k] <= 0:
                    yield boot(k)
            self.peak_active = len(active)
            prev = 0
            last_decide = 0
            n_decisions = 0
            up_streak = down_streak = 0
            for i in range(len(arr)):
                t = int(arr[i])
                if t > prev:
                    yield Compute(t - prev)
                prev = t
                if i and i % self.decide_every == 0:
                    # offered work over capacity, integer permille
                    elapsed = max(1, t - last_decide)
                    util = (self.decide_every * service * 1000
                            // (elapsed * len(active)))
                    was = len(active)
                    # hysteresis: the threshold must hold `patience`
                    # consecutive windows before the fleet moves
                    if util > scaler.up_x1000:
                        up_streak, down_streak = up_streak + 1, 0
                    elif util < scaler.down_x1000:
                        up_streak, down_streak = 0, down_streak + 1
                    else:
                        up_streak = down_streak = 0
                    target = was
                    if max(up_streak, down_streak) >= scaler.patience:
                        target = scaler.target(util, was,
                                               self.min_active,
                                               self.max_active)
                        up_streak = down_streak = 0
                    if target > was:
                        for k in range(self.n_pool):
                            if len(active) >= target:
                                break
                            if k not in active and self.ready_ns[k] <= t:
                                yield boot(k)
                    elif target < was:
                        # drain highest ids first (boot order is lowest
                        # first, so the fleet shrinks LIFO)
                        for k in sorted(active, reverse=True):
                            if len(active) <= target:
                                break
                            active.remove(k)
                            self.drains_sent += 1
                            yield Send(ep, f"pool.srv{k}", 64,
                                       payload=("drain",))
                    self.decisions.append(
                        {"vtime": t, "util_x1000": int(util),
                         "from": was, "to": len(active)})
                    self.peak_active = max(self.peak_active,
                                           len(active))
                    n_decisions += 1
                    if self.probe_every \
                            and n_decisions % self.probe_every == 0:
                        for k in active:
                            self.probes_sent += 1
                            yield Send(ep, f"pool.srv{k}", 64,
                                       payload=("probe",
                                                self.probes_sent))
                    last_decide = t
                k = policy(active, busy_until, t, service, cap_ns)
                busy_until[k] = max(busy_until[k], t) + service
                yield Send(ep, f"pool.srv{k}", self.req_bytes,
                           payload=("req", i, t, k))
                self.routed[k] += 1
                self.sent[0] = i + 1
            for k in range(self.n_pool):
                yield Send(ep, f"pool.srv{k}", 64, payload=("stop",))
            yield Send(ep, "ctl.sink.ep", 64,
                       payload=("fin", self.probes_sent))
        return body()

    def _server_factory(self, k: int):
        def factory(eps):
            ep = eps[f"pool.srv{k}"]

            def body():
                while True:
                    msg = yield Recv(ep)
                    kind = msg.payload[0]
                    if kind == "req":
                        _, j, arr_ns, _who = msg.payload
                        yield Compute(self.service_ns)
                        yield Send(ep, "ctl.sink.ep", self.resp_bytes,
                                   payload=("resp", j, arr_ns, k))
                        self.served_by[k] += 1
                    elif kind == "boot":
                        # a fresh generation: re-booting a drained
                        # server starts clean, like a re-joined host
                        self.boots[k] += 1
                    elif kind == "probe":
                        yield Send(ep, "ctl.sink.ep", 64,
                                   payload=("ack", msg.payload[1], k))
                    elif kind == "drain":
                        # no early close: everything already routed
                        # here was delivered first (channel order) and
                        # still gets served
                        self.drains[k] += 1
                    elif kind == "stop":
                        return
            return body()
        return factory

    def _sink_factory(self, eps):
        ep = eps["ctl.sink.ep"]

        def body():
            task = self._sink_handle.task
            n = len(self.arrivals)
            got = acks = 0
            expect_acks: Optional[int] = None
            while (got < n or expect_acks is None
                   or acks < expect_acks):
                msg = yield Recv(ep)
                kind = msg.payload[0]
                if kind == "resp":
                    _, j, arr_ns, _k = msg.payload
                    self.latencies[j] = int(task.vtime) - int(arr_ns)
                    got += 1
                    self.served[0] = got
                elif kind == "ack":
                    acks += 1
                    self.probe_acks[0] = acks
                elif kind == "fin":
                    expect_acks = int(msg.payload[1])
        return body()

    # -- workload protocol ---------------------------------------------------
    def fabrics(self) -> List[FabricSpec]:
        return [FabricSpec("ctlnet", self.link)]

    def programs(self) -> List[Program]:
        out = [
            Program(name=self.CTL, make_body=self._ctl_factory,
                    endpoints=(EndpointSpec("ctl.lb.ep", "ctlnet"),)),
            Program(name=self.SINK, make_body=self._sink_factory,
                    endpoints=(EndpointSpec("ctl.sink.ep", "ctlnet"),),
                    handle=self._sink_handle)]
        for k in range(self.n_pool):
            out.append(Program(
                name=f"pool{k}", make_body=self._server_factory(k),
                endpoints=(EndpointSpec(f"pool.srv{k}", "ctlnet"),)))
        return out

    def default_placement(self) -> Dict[str, int]:
        pl = {self.CTL: 0, self.SINK: 0}
        for k in range(self.n_pool):
            pl[f"pool{k}"] = k + 1
        return pl

    def traffic(self) -> Dict[Tuple[str, str], float]:
        n = len(self.arrivals)
        per = float(n) / self.n_pool
        t: Dict[Tuple[str, str], float] = {}
        for k in range(self.n_pool):
            t[(self.CTL, f"pool{k}")] = per * self.req_bytes
            t[(f"pool{k}", self.SINK)] = per * self.resp_bytes
        return t

    def progress(self) -> Dict[str, np.ndarray]:
        return {"sent": self.sent, "served": self.served,
                "routed": self.routed, "served_by": self.served_by,
                "boots": self.boots, "drains": self.drains,
                "probe_acks": self.probe_acks}

    def reset(self) -> None:
        self.sent[:] = 0
        self.served[:] = 0
        self.routed[:] = 0
        self.served_by[:] = 0
        self.boots[:] = 0
        self.drains[:] = 0
        self.probe_acks[:] = 0
        self.latencies[:] = 0
        self.decisions.clear()
        self.peak_active = 0
        self.probes_sent = 0
        self.boots_sent = 0
        self.drains_sent = 0

    # -- control hook (SimReport.control) ------------------------------------
    def control_report(self, tasks: Optional[set] = None
                       ) -> Optional[Dict[str, Any]]:
        """Post-run control section.  ``tasks`` restricts to owned task
        names (dist workers): the controller, sink and their state all
        live on host 0, so exactly the worker owning ``ctl.lb`` reports
        — the coordinator's first-non-empty merge is authoritative."""
        if tasks is not None and self.CTL not in tasks:
            return None
        lat = sorted(int(v) for v in self.latencies if v > 0)

        def pct(q: int) -> int:     # nearest-rank, pure integers
            if not lat:
                return 0
            return lat[min(len(lat) - 1,
                           max(0, (q * len(lat) + 99) // 100 - 1))]

        return {
            "placement": self.placement_name,
            "autoscaler": {
                "up_x1000": self.autoscaler.up_x1000,
                "down_x1000": self.autoscaler.down_x1000,
                "factor": self.autoscaler.factor,
                "min_active": self.min_active,
                "max_active": self.max_active,
                "decide_every": self.decide_every},
            "decisions": list(self.decisions),
            "peak_active": int(self.peak_active),
            "final_active": int(self.decisions[-1]["to"]
                                if self.decisions else self.min_active),
            "served": int(self.served[0]),
            "boots": int(self.boots_sent),
            "drains": int(self.drains_sent),
            "probes": {"sent": int(self.probes_sent),
                       "acks": int(self.probe_acks[0])},
            "latency_ns": {
                "p50": pct(50), "p95": pct(95), "p99": pct(99),
                "max": lat[-1] if lat else 0,
                "mean": (sum(lat) // len(lat)) if lat else 0},
        }
