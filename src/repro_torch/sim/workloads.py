"""Workload ports: chip-ring training, rack-ring, and serving.

These are the repo's hand-wired simulations re-expressed against the
:class:`~repro_torch.sim.workload.Workload` protocol.  Bodies are kept
action-for-action identical to the legacy build functions so the thin adapters
in :mod:`repro_torch.core.cluster` produce bit-identical results (verified by
``tests/test_sim_equivalence.py``); stragglers/failures moved out of the
bodies and into :class:`~repro_torch.sim.scenario.Scenario` injections.

Serving comes in two forms: :class:`ModeledServe` (closed-loop clients
with a modeled service time) and :class:`LiveServe` — the real
:class:`~repro_torch.serve.loop.BatchServer` prefill/decode steps under
simulated time, fed by an *open-loop* arrival schedule
(:func:`poisson_arrivals` / :func:`burst_arrivals`) standing in for
high-traffic clients that do not wait for responses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec, StepCost
from repro_torch.core.ipc import LinkSpec
from repro_torch.core.vtask import Compute, LiveCall, Recv, Send
from repro_torch.sim.scenario import TaskHandle
from repro_torch.sim.topology import FabricSpec
from repro_torch.sim.workload import (EndpointSpec, Program, ScopeSpec,
                                VecCompute, VecMark, VecRecv, VecSend,
                                Workload)


def _live_step() -> None:
    """Trivial fork-safe body for cost-derived live iterations (the
    cost comes from ``cost_ns``; the call just has to be real)."""
    return None


class ChipRingTraining(Workload):
    """Data-parallel training: one vtask per chip.

    Per step each chip computes (cost-derived or live), exchanges its
    per-step collective bytes with its pod-ring neighbor over the pod
    ICI fabric, and pod leaders all-reduce over the DCN fabric.  Chips
    are oblivious to placement: single-host they share one scheduler;
    with ``chips_per_host`` sharding (see ``build_training_cluster``)
    the same bodies run across orchestrated hosts and ring edges that
    cross hosts ride the host interconnect.
    """

    name = "train"

    def __init__(self, spec: ClusterSpec, step_cost: StepCost,
                 n_steps: int, *, skew_bound_ns: int = 1_000_000,
                 live_step_fn: Optional[Callable] = None,
                 ledger=None,
                 cells: Optional[Dict[str, str]] = None):
        if ledger is not None and live_step_fn is None \
                and ledger.mode == "record":
            raise ValueError("a record-mode ledger needs live_step_fn "
                             "(the real callable to measure)")
        self.spec = spec
        self.step_cost = step_cost
        self.n_steps = n_steps
        self.skew_bound_ns = skew_bound_ns
        self.live_step_fn = live_step_fn
        # optional repro_torch.live.CostLedger: per-(chip, step) recorded costs
        # replace the static cost model for live steps (record/replay)
        self.ledger = ledger
        # program name -> declared cell name (§3.3); chips with an
        # entry bind their live steps to that memory-hierarchy cell
        self.cells = cells or {}
        self.done_steps = np.zeros(spec.n_chips, dtype=np.int64)

    def fabrics(self) -> List[FabricSpec]:
        spec = self.spec
        ici = LinkSpec(bandwidth_bps=spec.ici_bw_Bps * 8,
                       latency_ns=spec.ici_lat_ns)
        dcn = LinkSpec(bandwidth_bps=spec.dcn_bw_Bps * 8,
                       latency_ns=spec.dcn_lat_ns)
        return [FabricSpec(f"ici{p}", ici) for p in range(spec.n_pods)] \
            + [FabricSpec("dcn", dcn)]

    def _chip_body(self, c: int):
        spec, cost = self.spec, self.step_cost
        p = c // spec.chips_per_pod
        right = p * spec.chips_per_pod + (c + 1) % spec.chips_per_pod
        leader = spec.n_pods > 1 and c % spec.chips_per_pod == 0
        other = (p + 1) % spec.n_pods
        live_fn = self.live_step_fn

        def make_body(eps):
            ep = eps[f"chip{c}"]
            dep = eps.get(f"pod{p}")

            def body():
                for step in range(self.n_steps):
                    if self.ledger is not None:
                        _, ns = self.ledger.charge(
                            f"chip{c}", f"step:{step}", live_fn)
                        yield LiveCall(_live_step, cost_ns=ns,
                                       label=f"step:{step}")
                    elif live_fn is not None:
                        yield LiveCall(live_fn, cost_ns=cost.compute_ns)
                    else:
                        yield Compute(cost.compute_ns)
                    yield Send(ep, f"chip{right}", cost.ici_bytes)
                    yield Recv(ep)
                    if leader:
                        yield Send(dep, f"pod{other}", cost.dcn_bytes)
                        yield Recv(dep)
                    self.done_steps[c] = step + 1
            return body()
        return make_body

    def programs(self) -> List[Program]:
        spec = self.spec
        out = []
        for c in range(spec.n_chips):
            p = c // spec.chips_per_pod
            eps: Tuple[EndpointSpec, ...] = (
                EndpointSpec(f"chip{c}", f"ici{p}"),)
            if c % spec.chips_per_pod == 0:
                eps += (EndpointSpec(f"pod{p}", "dcn"),)
            out.append(Program(
                name=f"chip{c}", make_body=self._chip_body(c),
                endpoints=eps,
                kind="live" if (self.live_step_fn or self.ledger)
                else "modeled",
                cell=self.cells.get(f"chip{c}")))
        return out

    def traffic(self) -> Dict[Tuple[str, str], float]:
        spec, cost = self.spec, self.step_cost
        t: Dict[Tuple[str, str], float] = {}
        for c in range(spec.n_chips):
            p = c // spec.chips_per_pod
            right = p * spec.chips_per_pod + (c + 1) % spec.chips_per_pod
            t[(f"chip{c}", f"chip{right}")] = float(max(cost.ici_bytes, 1))
        if spec.n_pods > 1:
            for p in range(spec.n_pods):
                a = p * spec.chips_per_pod
                b = ((p + 1) % spec.n_pods) * spec.chips_per_pod
                t[(f"chip{a}", f"chip{b}")] = float(
                    max(cost.dcn_bytes, 1))
        return t

    def scopes(self) -> List[ScopeSpec]:
        return [ScopeSpec("train", self.skew_bound_ns)]

    def progress(self) -> Dict[str, np.ndarray]:
        return {"done_steps": self.done_steps}

    def reset(self) -> None:
        self.done_steps[:] = 0
        if self.ledger is not None and self.ledger.mode == "replay":
            self.ledger.rewind()

    def live_mode(self):
        return self.ledger.mode if self.ledger is not None else None

    def live_fns(self):
        if self.live_step_fn is None:
            return {}
        return {f"chip{c}": self.live_step_fn
                for c in range(self.spec.n_chips)}

    def live_report(self, tasks=None):
        if self.ledger is None:
            return None
        return {"mode": self.ledger.mode,
                "calibration": self.ledger.calibration, "tasks": {}}

    def vec_ops(self):
        """Vectorized lowering — op-for-op the ``_chip_body`` stream
        (modeled computes only; live steps have no array form)."""
        if self.live_step_fn is not None or self.ledger is not None:
            return None
        spec, cost = self.spec, self.step_cost
        out = {}
        for c in range(spec.n_chips):
            p = c // spec.chips_per_pod
            right = p * spec.chips_per_pod + (c + 1) % spec.chips_per_pod
            leader = spec.n_pods > 1 and c % spec.chips_per_pod == 0
            other = (p + 1) % spec.n_pods
            ops = []
            for step in range(self.n_steps):
                ops.append(VecCompute(cost.compute_ns))
                ops.append(VecSend(f"chip{c}", f"chip{right}",
                                   cost.ici_bytes))
                ops.append(VecRecv(f"chip{c}"))
                if leader:
                    ops.append(VecSend(f"pod{p}", f"pod{other}",
                                       cost.dcn_bytes))
                    ops.append(VecRecv(f"pod{p}"))
                ops.append(VecMark("done_steps", c, step + 1))
            out[f"chip{c}"] = ops
        return out


class RackRing(Workload):
    """Heterogeneous-latency multi-host ring (paper §3.5): one worker
    per host, hosts grouped into racks; intra-rack ring every iteration,
    cross-rack leader ring every ``cross_every`` iterations.  Natural
    placement is one worker per host (``build_rack_cluster`` pins it);
    rack compute imbalance is a Scenario concern (Straggler injections).
    """

    name = "rack"

    def __init__(self, *, n_racks: int = 2, hosts_per_rack: int = 2,
                 n_iters: int = 200, compute_ns: int = 5_000,
                 msg_bytes: int = 4096, cross_every: int = 20,
                 skew_bound_ns: int = 0,
                 local_link: LinkSpec = LinkSpec(bandwidth_bps=80e9 * 8,
                                                 latency_ns=500),
                 live: bool = False,
                 cells: Optional[Dict[str, str]] = None):
        self.n_racks = n_racks
        self.hosts_per_rack = hosts_per_rack
        self.n_workers = n_racks * hosts_per_rack
        self.n_iters = n_iters
        self.compute_ns = compute_ns
        self.msg_bytes = msg_bytes
        self.cross_every = cross_every
        self.skew_bound_ns = skew_bound_ns
        self.local_link = local_link
        # live=True swaps each iteration's modeled Compute for a
        # cost-derived LiveCall, so workers can bind to §3.3 cells
        # (``cells``: worker name -> declared cell name) and pick up
        # spatial-interference / reconditioning charges
        self.live = live
        self.cells = cells or {}
        self.iters_done = np.zeros(self.n_workers, dtype=np.int64)

    def fabrics(self) -> List[FabricSpec]:
        return [FabricSpec("hub", self.local_link)]

    def _worker_body(self, h: int):
        r = h // self.hosts_per_rack
        slot = h % self.hosts_per_rack
        right = r * self.hosts_per_rack + (slot + 1) % self.hosts_per_rack
        is_leader = slot == 0
        next_rack = (r + 1) % self.n_racks

        def make_body(eps):
            ep = eps[f"w{h}"]
            xep = eps.get(f"lead{r}")

            def body():
                for i in range(self.n_iters):
                    if self.live:
                        yield LiveCall(_live_step,
                                       cost_ns=self.compute_ns)
                    else:
                        yield Compute(self.compute_ns)
                    if self.hosts_per_rack > 1:
                        yield Send(ep, f"w{right}", self.msg_bytes)
                        yield Recv(ep)
                    if (is_leader and self.n_racks > 1
                            and (i + 1) % self.cross_every == 0):
                        yield Send(xep, f"lead{next_rack}",
                                   self.msg_bytes)
                        yield Recv(xep)
                    self.iters_done[h] = i + 1
            return body()
        return make_body

    def programs(self) -> List[Program]:
        out = []
        for h in range(self.n_workers):
            r = h // self.hosts_per_rack
            eps: Tuple[EndpointSpec, ...] = (EndpointSpec(f"w{h}", "hub"),)
            if h % self.hosts_per_rack == 0:
                eps += (EndpointSpec(f"lead{r}", "hub"),)
            out.append(Program(name=f"w{h}",
                               make_body=self._worker_body(h),
                               endpoints=eps,
                               kind="live" if self.live else "modeled",
                               cell=self.cells.get(f"w{h}")))
        return out

    def default_placement(self) -> Dict[str, int]:
        return {f"w{h}": h for h in range(self.n_workers)}

    def live_fns(self):
        if not self.live:
            return {}
        return {f"w{h}": _live_step for h in range(self.n_workers)}

    def stragglers(self, rack_slowdown: Tuple[float, ...]):
        """Per-rack compute multipliers -> per-worker Straggler
        injections (racks beyond the tuple, and 1.0 entries, are
        untouched).  The single source of the mapping used by the
        legacy adapter, benchmarks, and examples."""
        from repro_torch.sim.scenario import Straggler
        out = []
        for h in range(self.n_workers):
            r = h // self.hosts_per_rack
            if r < len(rack_slowdown) and rack_slowdown[r] != 1.0:
                out.append(Straggler(f"w{h}", rack_slowdown[r]))
        return tuple(out)

    def traffic(self) -> Dict[Tuple[str, str], float]:
        t: Dict[Tuple[str, str], float] = {}
        per_iter = float(self.msg_bytes) * self.n_iters
        for h in range(self.n_workers):
            r = h // self.hosts_per_rack
            slot = h % self.hosts_per_rack
            if self.hosts_per_rack > 1:
                right = r * self.hosts_per_rack \
                    + (slot + 1) % self.hosts_per_rack
                t[(f"w{h}", f"w{right}")] = per_iter
        if self.n_racks > 1:
            for r in range(self.n_racks):
                a = r * self.hosts_per_rack
                b = ((r + 1) % self.n_racks) * self.hosts_per_rack
                t[(f"w{a}", f"w{b}")] = per_iter / self.cross_every
        return t

    def scopes(self) -> List[ScopeSpec]:
        if self.skew_bound_ns > 0:
            return [ScopeSpec("cluster", self.skew_bound_ns)]
        return []

    def progress(self) -> Dict[str, np.ndarray]:
        return {"iters_done": self.iters_done}

    def reset(self) -> None:
        self.iters_done[:] = 0

    def vec_ops(self):
        """Vectorized lowering — op-for-op the ``_worker_body`` stream
        (modeled iterations only)."""
        if self.live:
            return None
        out = {}
        for h in range(self.n_workers):
            r = h // self.hosts_per_rack
            slot = h % self.hosts_per_rack
            right = (r * self.hosts_per_rack
                     + (slot + 1) % self.hosts_per_rack)
            is_leader = slot == 0
            next_rack = (r + 1) % self.n_racks
            ops = []
            for i in range(self.n_iters):
                ops.append(VecCompute(self.compute_ns))
                if self.hosts_per_rack > 1:
                    ops.append(VecSend(f"w{h}", f"w{right}",
                                       self.msg_bytes))
                    ops.append(VecRecv(f"w{h}"))
                if (is_leader and self.n_racks > 1
                        and (i + 1) % self.cross_every == 0):
                    ops.append(VecSend(f"lead{r}", f"lead{next_rack}",
                                       self.msg_bytes))
                    ops.append(VecRecv(f"lead{r}"))
                ops.append(VecMark("iters_done", h, i + 1))
            out[f"w{h}"] = ops
        return out


class ModeledServe(Workload):
    """Closed-loop request serving: ``n_clients`` clients think, send a
    request, and wait for the response; one server computes per-request
    service time.  Co-locate with a training workload (single host +
    ``cpu_resource=True``) to study interference coupling."""

    name = "serve"

    def __init__(self, *, n_clients: int = 2, n_requests: int = 50,
                 think_ns: int = 20_000, service_ns: int = 50_000,
                 req_bytes: int = 1024, resp_bytes: int = 256,
                 skew_bound_ns: int = 0,
                 link: LinkSpec = LinkSpec(bandwidth_bps=10e9 * 8,
                                           latency_ns=20_000)):
        self.n_clients = n_clients
        self.n_requests = n_requests
        self.think_ns = think_ns
        self.service_ns = service_ns
        self.req_bytes = req_bytes
        self.resp_bytes = resp_bytes
        self.skew_bound_ns = skew_bound_ns
        self.link = link
        self.served = np.zeros(n_clients, dtype=np.int64)

    def fabrics(self) -> List[FabricSpec]:
        return [FabricSpec("svc", self.link)]

    def programs(self) -> List[Program]:
        wl = self

        def server_factory(eps):
            srv = eps["serve.srv"]

            def body():
                for _ in range(wl.n_clients * wl.n_requests):
                    msg = yield Recv(srv)
                    yield Compute(wl.service_ns)
                    yield Send(srv, f"serve.cli{msg.payload}",
                               wl.resp_bytes, payload=msg.payload)
            return body()

        def client_factory(i):
            def factory(eps):
                cli = eps[f"serve.cli{i}"]

                def body():
                    for j in range(wl.n_requests):
                        yield Compute(wl.think_ns)
                        yield Send(cli, "serve.srv", wl.req_bytes,
                                   payload=i)
                        yield Recv(cli)
                        wl.served[i] = j + 1
                return body()
            return factory

        out = [Program(name="serve.server", make_body=server_factory,
                       endpoints=(EndpointSpec("serve.srv", "svc"),))]
        for i in range(self.n_clients):
            out.append(Program(
                name=f"serve.client{i}", make_body=client_factory(i),
                endpoints=(EndpointSpec(f"serve.cli{i}", "svc"),)))
        return out

    def traffic(self) -> Dict[Tuple[str, str], float]:
        w = float(self.n_requests * (self.req_bytes + self.resp_bytes))
        return {("serve.server", f"serve.client{i}"): w
                for i in range(self.n_clients)}

    def scopes(self) -> List[ScopeSpec]:
        if self.skew_bound_ns > 0:
            return [ScopeSpec("serve", self.skew_bound_ns)]
        return []

    def progress(self) -> Dict[str, np.ndarray]:
        return {"served": self.served}

    def reset(self) -> None:
        self.served[:] = 0


# ---------------------------------------------------------------------------
# open-loop arrival schedules + live serving
# ---------------------------------------------------------------------------


def poisson_arrivals(n: int, mean_gap_ns: int, *, seed: int = 0,
                     start_ns: int = 0) -> np.ndarray:
    """Open-loop Poisson arrival schedule: ``n`` absolute arrival
    vtimes (int64 ns) with exponential inter-arrival gaps of mean
    ``mean_gap_ns``, each clamped >= 1 ns, deterministic in ``seed``.

    The schedule is *generated once* — at record time for live serving
    — and pinned into the trace meta, so replays read the exact integer
    schedule back instead of re-deriving it from an RNG stream (numpy
    stream details must never be part of the determinism argument)."""
    if n < 1:
        raise ValueError(f"need at least one arrival, got n={n}")
    if mean_gap_ns < 1:
        raise ValueError(f"mean_gap_ns must be >= 1, got {mean_gap_ns}")
    rng = np.random.default_rng(seed)
    gaps = np.maximum(1, rng.exponential(float(mean_gap_ns),
                                         size=n)).astype(np.int64)
    return int(start_ns) + np.cumsum(gaps)


def burst_arrivals(n: int, burst_size: int, *, gap_ns: int,
                   spread_ns: int = 0, start_ns: int = 0) -> np.ndarray:
    """Deterministic bursty schedule: requests arrive in bursts of
    ``burst_size`` (``spread_ns`` apart inside a burst), one burst
    every ``gap_ns``, truncated to ``n`` requests — the high-traffic
    antagonist for queue-depth stats (a whole burst lands on the server
    at once)."""
    if n < 1 or burst_size < 1 or gap_ns < 1:
        raise ValueError("n, burst_size and gap_ns must be >= 1")
    out = []
    b = 0
    while len(out) < n:
        t0 = int(start_ns) + (b + 1) * int(gap_ns)
        for i in range(burst_size):
            out.append(t0 + i * int(spread_ns))
            if len(out) == n:
                break
        b += 1
    return np.asarray(out, dtype=np.int64)


def diurnal_arrivals(n: int, *, base_gap_ns: int, peak_gap_ns: int,
                     period_ns: int, seed: int = 0,
                     start_ns: int = 0) -> np.ndarray:
    """Open-loop diurnal schedule: ``n`` absolute arrival vtimes whose
    mean inter-arrival gap swings sinusoidally between ``base_gap_ns``
    (trough traffic, long gaps — the cycle starts here) and
    ``peak_gap_ns`` (peak traffic, short gaps, reached half a
    ``period_ns`` in), with exponential jitter around the phase mean,
    deterministic in ``seed``.  The traffic shape autoscalers exist
    for: load ramps up ~``base_gap_ns / peak_gap_ns``x into the peak
    and back down again.  Like :func:`poisson_arrivals`, the schedule
    is generated once at build time and pinned — int64 ns, clamped to
    >= 1 ns gaps."""
    if n < 1:
        raise ValueError(f"need at least one arrival, got n={n}")
    if not 1 <= peak_gap_ns <= base_gap_ns:
        raise ValueError(f"need 1 <= peak_gap_ns <= base_gap_ns, got "
                         f"peak={peak_gap_ns} base={base_gap_ns}")
    if period_ns < 2:
        raise ValueError(f"period_ns must be >= 2, got {period_ns}")
    rng = np.random.default_rng(seed)
    jitter = rng.exponential(1.0, size=n)
    out = np.empty(n, dtype=np.int64)
    t = int(start_ns)
    half_swing = (base_gap_ns - peak_gap_ns) / 2.0
    for i in range(n):
        phase = (t % period_ns) / period_ns
        mean = peak_gap_ns + half_swing * (
            1.0 + np.cos(2.0 * np.pi * phase))
        t += max(1, int(jitter[i] * mean))
        out[i] = t
    return out


class LiveServe(Workload):
    """Open-loop live serving: the real serve stack under simulated
    time (the serve half of the paper's full-stack claim).

    Two programs: ``serve.src`` — the open-loop source, emitting one
    request per entry of the ``arrivals`` schedule without waiting for
    responses (millions-of-users traffic has no closed loop); and
    ``serve.live`` — the live server, which forms *waves*: on receiving
    the head request it batches every request whose scheduled arrival
    is at or before its current vtime (up to ``max_batch``, the static
    batch of :class:`~repro_torch.serve.loop.BatchServer`), then runs one
    prefill plus ``decode_steps`` decode steps as cost-derived
    :class:`~repro_torch.core.vtask.LiveCall`\\ s charged through the
    :class:`~repro_torch.live.CostLedger` — real jitted BatchServer steps in
    record mode (via :class:`~repro_torch.sim.live.ServeStack`), pinned costs
    in replay.

    Determinism: wave membership depends only on the build-time
    ``arrivals`` array and the server's vtime, which replay re-derives
    exactly from the pinned costs — so the wave sequence, the ledger
    labels, per-request latencies, and queue depths are bit-identical
    across single/barrier/async/dist (`tests/test_live_serve.py`).

    The per-task live section reports simulated time-in-system
    percentiles (p50/p95/p99, nearest-rank on integers — no float
    interpolation) and queue-depth stats sampled at each wave start,
    surfaced through ``SimReport.live``.
    """

    name = "live_serve"
    SERVER = "serve.live"
    SOURCE = "serve.src"

    def __init__(self, *, ledger, arrivals: Sequence[int], stack=None,
                 max_batch: int = 4, decode_steps: int = 4,
                 req_bytes: int = 512, resp_bytes: int = 2048,
                 cell: Optional[str] = None,
                 link: LinkSpec = LinkSpec(bandwidth_bps=25e9 * 8,
                                           latency_ns=10_000)):
        if ledger.mode == "record" and stack is None:
            raise ValueError("record mode needs a real ServeStack "
                             "(the callables to measure)")
        if max_batch < 1 or decode_steps < 1:
            raise ValueError("max_batch and decode_steps must be >= 1")
        arr = np.asarray(arrivals, dtype=np.int64)
        if arr.ndim != 1 or len(arr) == 0:
            raise ValueError("arrivals must be a non-empty 1-D schedule")
        if np.any(arr < 1):
            raise ValueError("arrival vtimes must be >= 1 ns")
        if np.any(np.diff(arr) < 0):
            raise ValueError("arrivals must be non-decreasing")
        self.ledger = ledger
        self.stack = stack
        self.arrivals = arr
        self.max_batch = max_batch
        self.decode_steps = decode_steps
        self.req_bytes = req_bytes
        self.resp_bytes = resp_bytes
        self.cell = cell
        self.link = link
        self._handle = TaskHandle()
        self.sent = np.zeros(1, dtype=np.int64)
        self.served = np.zeros(1, dtype=np.int64)
        self.latencies = np.zeros(len(arr), dtype=np.int64)
        self.wave_sizes: List[int] = []
        self.wave_depths: List[int] = []

    # -- bodies --------------------------------------------------------------
    def _source_factory(self, eps):
        ep = eps["serve.lsrc"]

        def body():
            prev = 0
            for i, t in enumerate(self.arrivals):
                t = int(t)
                if t > prev:
                    yield Compute(t - prev)
                prev = t
                yield Send(ep, "serve.lsrv", self.req_bytes, payload=i)
                self.sent[0] = i + 1
            # open loop: responses are drained only after the last
            # request is out, so sending never waits on the server
            while True:
                msg = yield Recv(ep)
                if msg.payload[0] == "close":
                    return
        return body()

    def _server_factory(self, eps):
        ep = eps["serve.lsrv"]

        def body():
            led, stack = self.ledger, self.stack
            if stack is not None:
                stack.setup()    # model init + jit warm-up: outside
            task = self._handle.task            # simulated time
            arr = self.arrivals
            n = len(arr)
            done = wave = 0
            while done < n:
                yield Recv(ep)               # head request of the wave
                now = int(task.vtime)
                # wave membership: every request whose *scheduled*
                # arrival is at or before now, capped at the static
                # batch — build-time data + deterministic vtime only
                hi = done + 1
                while hi < n and hi - done < self.max_batch \
                        and int(arr[hi]) <= now:
                    hi += 1
                for _ in range(done + 1, hi):
                    yield Recv(ep)           # rest of the wave
                batch = hi - done
                depth = hi
                while depth < n and int(arr[depth]) <= now:
                    depth += 1
                self.wave_sizes.append(batch)
                self.wave_depths.append(depth - done)
                _, cost = led.charge(
                    self.SERVER, f"prefill:{wave}",
                    stack.prefill if stack else None, (wave, batch))
                yield LiveCall(_live_step, cost_ns=cost,
                               label=f"prefill:{wave}")
                for d in range(self.decode_steps):
                    _, cost = led.charge(
                        self.SERVER, f"decode:{wave}:{d}",
                        stack.decode if stack else None, (wave, d))
                    yield LiveCall(_live_step, cost_ns=cost,
                                   label=f"decode:{wave}:{d}")
                t_done = int(task.vtime)
                for j in range(done, hi):
                    self.latencies[j] = t_done - int(arr[j])
                yield Send(ep, "serve.lsrc", self.resp_bytes * batch,
                           payload=("wave", wave, batch))
                done = hi
                self.served[0] = done
                wave += 1
            yield Send(ep, "serve.lsrc", 64, payload=("close", wave, 0))
            if stack is not None:
                stack.close()
        return body()

    # -- workload protocol ---------------------------------------------------
    def fabrics(self) -> List[FabricSpec]:
        return [FabricSpec("lsvc", self.link)]

    def programs(self) -> List[Program]:
        return [
            Program(name=self.SOURCE, make_body=self._source_factory,
                    endpoints=(EndpointSpec("serve.lsrc", "lsvc"),)),
            Program(name=self.SERVER, make_body=self._server_factory,
                    endpoints=(EndpointSpec("serve.lsrv", "lsvc"),),
                    kind="live", cell=self.cell, handle=self._handle)]

    def default_placement(self) -> Dict[str, int]:
        return {self.SOURCE: 0, self.SERVER: 1}

    def traffic(self) -> Dict[Tuple[str, str], float]:
        n = len(self.arrivals)
        return {(self.SOURCE, self.SERVER):
                float(n * (self.req_bytes + self.resp_bytes))}

    def progress(self) -> Dict[str, np.ndarray]:
        return {"sent": self.sent, "served": self.served}

    def reset(self) -> None:
        self.sent[:] = 0
        self.served[:] = 0
        self.latencies[:] = 0
        self.wave_sizes.clear()
        self.wave_depths.clear()
        if self.ledger.mode == "replay":
            self.ledger.rewind()
        elif self.ledger.tasks.get(self.SERVER):
            raise ValueError(
                f"record ledger already holds {self.SERVER!r} costs: "
                f"one record run per ledger — save the trace and "
                f"replay it, or record with a fresh ledger")

    # -- live hooks ----------------------------------------------------------
    def live_mode(self):
        return self.ledger.mode

    def live_fns(self):
        return {self.SERVER: self.stack.prefill} if self.stack else {}

    def live_report(self, tasks: Optional[set] = None):
        sec = {"mode": self.ledger.mode,
               "calibration": self.ledger.calibration, "tasks": {}}
        if tasks is None or self.SERVER in tasks:
            done = int(self.served[0])
            lat = sorted(int(v) for v in self.latencies[:done])

            def pct(q):      # nearest-rank percentile, pure integers
                if not lat:
                    return 0
                return lat[min(len(lat) - 1,
                               max(0, (q * len(lat) + 99) // 100 - 1))]

            sec["tasks"][self.SERVER] = {
                "requests": done,
                "waves": len(self.wave_sizes),
                "max_wave_batch": max(self.wave_sizes, default=0),
                "latency_ns": {
                    "p50": pct(50), "p95": pct(95), "p99": pct(99),
                    "max": lat[-1] if lat else 0,
                    "mean": (sum(lat) // len(lat)) if lat else 0},
                "queue_depth": {
                    "max": max(self.wave_depths, default=0),
                    "sum": int(sum(self.wave_depths)),
                    "samples": len(self.wave_depths)}}
        return sec
