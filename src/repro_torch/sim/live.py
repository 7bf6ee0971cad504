"""Live-execution workloads: the real stack under simulated time.

The paper's headline claim is full-stack fidelity — the *unmodified*
production stack executes live while virtual time stays shared and
deterministic.  This module is that subsystem for the facade:

* :class:`LiveProgram` — wrap any named real step callables in
  cost-derived :class:`~repro_torch.core.vtask.LiveCall`\\ s.  Each simulated
  step, the :class:`~repro_torch.live.CostLedger` either *records* the real
  call's wall span (scaled by the clock calibration, clamped to >= 1
  ns) or *replays* the pinned cost from a versioned JSON trace, so a
  recorded live scenario passes the cross-engine equivalence bar
  bit-identically (single/barrier/async/dist; the vectorized engine
  keeps raising ``UnsupportedByEngine`` — real callables have no array
  form).  Programs are cell-bindable, so live steps pick up §3.3
  memory-interference charges like any other live vtask.
* :class:`LiveTrainerRecovery` + :class:`TrainerStack` — the marquee
  scenario: a real sharded trainer driven step-by-step under simulated
  time; a scenario ``FailHost`` kills one shard-anchor host, the driver
  detects it (routed through the real
  :class:`~repro_torch.runtime.failures.FailureInjector` /
  ``SimulatedHostFailure`` machinery), restores the last committed
  checkpoint, elastically re-meshes, and resumes — emitting a recovery
  timeline (detect → restore → re-mesh → resumed vtimes) into
  ``SimReport.live``.  :class:`TrainerStack` runs the port's trainer on
  ``device`` (the card unless the caller asks for the CPU).
* :func:`live_recovery_sim` / :func:`record_live_recovery` — the
  canned marquee scenario builder (scenario parameters travel inside
  the trace's ``meta`` so a replay reconstructs exactly the recorded
  run) and its one-shot recorder.
* :class:`ServeStack` + :func:`live_serve_sim` /
  :func:`record_live_serve` — the serve half: the real
  :class:`~repro_torch.serve.loop.BatchServer` prefill/decode steps driven as
  a :class:`~repro_torch.sim.workloads.LiveServe` workload under open-loop
  arrivals, reporting simulated time-in-system percentiles.
* :func:`live_colocated_sim` / :func:`record_live_colocated` —
  live-on-live interference: a real trainer and a real server sharing
  one §3.3 memory-hierarchy cell (and one multi-driver ledger — the
  recorder's sequential-span guard keeps their wall spans honest).
* :func:`check_dist_live` — facade guard for ``engine="dist"``: record
  mode is rejected (forked workers cannot produce one coherent trace)
  and every live fn must pickle — an unpicklable callable is a
  reliable proxy for fork-unsafe captured state, and the facade error
  names the fn instead of surfacing a worker crash traceback.

Determinism: replayed costs are integers fed through the scheduler's
cost-derived LiveCall path; every control-flow decision in the bodies
below depends only on step indices and task vtimes, which replay
re-derives exactly from the pinned costs (see ``repro_torch.live.recorder``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.ipc import LinkSpec
from repro_torch.core.vtask import Compute, LiveCall, Recv, Send
from repro_torch.live import CostLedger
from repro_torch.runtime.failures import FailureInjector, SimulatedHostFailure
from repro_torch.sim.scenario import FailHost, Scenario, TaskHandle
from repro_torch.sim.simulation import Simulation
from repro_torch.sim.topology import FabricSpec, Topology
from repro_torch.sim.workload import EndpointSpec, Program, Workload
from repro_torch.sim.workloads import LiveServe, poisson_arrivals


def _noop(*_args) -> None:
    """Fork-safe stand-in executed by replayed LiveCalls (the pinned
    cost carries the timing; the call just has to be real)."""
    return None


# ---------------------------------------------------------------------------
# generic live workload
# ---------------------------------------------------------------------------


class LiveProgram(Workload):
    """Named real step callables under simulated time.

    ``fns`` maps program name -> callable invoked as ``fn(step)`` each
    simulated step (record mode only; replay never calls it).  With
    ``ring_bytes > 0`` the programs additionally exchange a message
    ring per step, so multi-host placements exercise the transport.
    """

    def __init__(self, fns: Dict[str, Callable], n_steps: int, *,
                 ledger: CostLedger, name: str = "live",
                 ring_bytes: int = 0,
                 link: LinkSpec = LinkSpec(bandwidth_bps=25e9 * 8,
                                           latency_ns=10_000),
                 cells: Optional[Dict[str, str]] = None,
                 skew_bound_ns: int = 0):
        if not fns:
            raise ValueError("LiveProgram needs at least one fn")
        self.fns = dict(fns)
        self.n_steps = n_steps
        self.ledger = ledger
        self.name = name
        self.ring_bytes = ring_bytes
        self.link = link
        self.cells = cells or {}
        self.skew_bound_ns = skew_bound_ns
        self.order = list(self.fns)
        self.steps_done = np.zeros(len(self.order), dtype=np.int64)

    def _ring(self) -> bool:
        return self.ring_bytes > 0 and len(self.order) > 1

    def fabrics(self) -> List[FabricSpec]:
        if self._ring():
            return [FabricSpec(f"{self.name}.hub", self.link)]
        return []

    def _body_factory(self, i: int):
        task = self.order[i]
        fn = self.fns[task]
        right = self.order[(i + 1) % len(self.order)]

        def make_body(eps):
            ep = eps.get(task)

            def body():
                for step in range(self.n_steps):
                    _, cost = self.ledger.charge(task, f"step:{step}",
                                                 fn, (step,))
                    yield LiveCall(_noop, cost_ns=cost,
                                   label=f"step:{step}")
                    if ep is not None:
                        yield Send(ep, right, self.ring_bytes)
                        yield Recv(ep)
                    self.steps_done[i] = step + 1
            return body()
        return make_body

    def programs(self) -> List[Program]:
        ring = self._ring()
        return [Program(
            name=t, make_body=self._body_factory(i),
            endpoints=(EndpointSpec(t, f"{self.name}.hub"),) if ring
            else (),
            kind="live", cell=self.cells.get(t))
            for i, t in enumerate(self.order)]

    def traffic(self):
        if not self._ring():
            return {}
        per = float(self.ring_bytes) * self.n_steps
        return {(t, self.order[(i + 1) % len(self.order)]): per
                for i, t in enumerate(self.order)}

    def scopes(self):
        from repro_torch.sim.workload import ScopeSpec
        if self.skew_bound_ns > 0:
            return [ScopeSpec(self.name, self.skew_bound_ns)]
        return []

    def progress(self):
        return {"steps_done": self.steps_done}

    def reset(self) -> None:
        self.steps_done[:] = 0
        if self.ledger.mode == "replay":
            self.ledger.rewind()
        elif any(self.ledger.tasks.get(t) for t in self.order):
            raise ValueError(
                f"record ledger already holds costs for "
                f"{sorted(t for t in self.order if self.ledger.tasks.get(t))} "
                f"— one record run per ledger; save the trace and "
                f"replay it, or record with a fresh ledger")

    # live hooks
    def live_mode(self):
        return self.ledger.mode

    def live_fns(self):
        return dict(self.fns)

    def live_report(self, tasks: Optional[set] = None):
        return {"mode": self.ledger.mode,
                "calibration": self.ledger.calibration, "tasks": {}}


# ---------------------------------------------------------------------------
# marquee scenario: real trainer + FailHost + checkpoint re-mesh
# ---------------------------------------------------------------------------


class TrainerStack:
    """Record-mode binding of the real trainer
    (:class:`~repro_torch.runtime.trainer.Trainer`) to the live recovery
    driver's phases, on ``device`` (``None`` means CUDA and raises
    without it; replay passes ``stack=None`` and needs none of it).

    Every phase that runs work on the device ends in a device
    synchronize (where the JAX package blocks until ready), so a
    recorded span times the work.  The mesh is logical on the port's one
    card (``repro_torch.launch.mesh``): ``data`` is clamped to the devices
    there are, as the JAX package clamps it, so (2, 1) and the re-mesh's
    (1, 1) are both (1, 1) and ``remesh`` rebuilds the step and re-places
    the state on the same card."""

    def __init__(self, *, arch: str = "qwen3_4b", n_steps: int = 8,
                 seq_len: int = 32, global_batch: int = 4,
                 mesh_shape: Sequence[int] = (2, 1),
                 remesh_shape: Sequence[int] = (1, 1),
                 checkpoint_dir: Optional[str] = None, seed: int = 0,
                 device=None):
        self.arch = arch
        self.n_steps = n_steps
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.mesh_shape = tuple(mesh_shape)
        self.remesh_shape = tuple(remesh_shape)
        self.checkpoint_dir = checkpoint_dir
        self.seed = seed
        self.device = device
        self.trainer = None
        self.params = self.opt = None
        self._ctx = contextlib.ExitStack()
        self._tmp_dir: Optional[str] = None

    def _mesh(self, shape):
        from repro_torch.launch.mesh import make_test_mesh
        data, model = shape
        ndev = 1          # the one card (or the CPU) the trainer runs on
        data = max(1, min(int(data), ndev // max(1, int(model))))
        return make_test_mesh(data=data, model=int(model))

    def _sync(self) -> None:
        from repro_torch.serve.loop import sync
        sync(self.trainer.device)

    def setup(self) -> None:
        if self.trainer is not None:
            return
        import dataclasses
        import tempfile

        from repro_torch import configs
        from repro_torch.core.engine_torch import resolve_device
        from repro_torch.parallel import ctx as pctx
        from repro_torch.runtime.trainer import Trainer, TrainerConfig
        dev = resolve_device(self.device, "the trainer")
        cfg = dataclasses.replace(configs.get_smoke(self.arch),
                                  remat=False)
        ckpt_dir = self.checkpoint_dir
        if ckpt_dir is None:
            ckpt_dir = self._tmp_dir = tempfile.mkdtemp(
                prefix="repro_live_ckpt_")
        tcfg = TrainerConfig(
            n_steps=self.n_steps, seq_len=self.seq_len,
            global_batch=self.global_batch,
            # the live driver controls checkpoint cadence itself
            checkpoint_every=10 ** 9, checkpoint_dir=ckpt_dir,
            checkpoint_async=False, log_every=10 ** 9, seed=self.seed)
        mesh = self._mesh(self.mesh_shape)
        self.trainer = Trainer(cfg, tcfg, mesh=mesh,
                               injector=FailureInjector(),
                               log_fn=lambda _s: None, device=dev)
        self._ctx.enter_context(pctx.use_mesh(mesh))
        self.params, self.opt = self.trainer.init_state()
        # warm up (kernel build and load, allocator) so recorded step
        # costs are steady-state (an unrecorded step 0 on synthetic data)
        self.step(0)

    def step(self, step: int) -> None:
        self.params, self.opt, metrics = self.trainer.step(
            self.params, self.opt, step, self.trainer.data.batch(step))
        self._sync()

    def save(self, step: int) -> None:
        self.trainer.ckpt.save({"params": self.params, "opt": self.opt},
                               step, blocking=True)
        self._sync()

    def restore(self) -> int:
        self.params = self.opt = None
        self.params, self.opt, step = self.trainer._recover()
        self._sync()
        return step

    def remesh(self) -> None:
        """Elastic re-mesh after the simulated host loss: rebuild the
        (logical) mesh at the post-failure shape, rebuild the train step,
        and re-place the restored state on the card."""
        from repro_torch.optim.adamw import tree_map
        from repro_torch.parallel import ctx as pctx
        mesh = self._mesh(self.remesh_shape)
        self.trainer.mesh = mesh
        self.trainer._build()
        dev = self.trainer.device
        self.params = tree_map(lambda t: t.to(dev), self.params)
        self.opt = tree_map(lambda t: t.to(dev), self.opt)
        self._ctx.close()
        self._ctx = contextlib.ExitStack()
        self._ctx.enter_context(pctx.use_mesh(mesh))
        self._sync()

    def close(self) -> None:
        if self.trainer is not None:
            self.trainer.ckpt.wait()
        self._ctx.close()
        if self._tmp_dir is not None:       # made by setup: remove it
            import shutil
            shutil.rmtree(self._tmp_dir, ignore_errors=True)
            self._tmp_dir = None


class LiveTrainerRecovery(Workload):
    """The marquee live scenario as a workload.

    Programs (in vtask order): ``live.trainer`` — the live driver on
    host 0, running the real (or replayed) train steps; ``live.shard1..
    N`` — modeled shard anchors, one per worker host, representing the
    trainer's presence there (a scenario ``FailHost`` kills the anchor
    and, via ``Program.on_fail``, arms the driver's detection at the
    failure vtime); ``live.store`` — a modeled checkpoint store the
    driver saves to / restores from over the interconnect.

    The driver's recovery path goes through the *real* runtime
    machinery in both modes: a :class:`FailureInjector` armed at the
    detected step raises :class:`SimulatedHostFailure`, and the handler
    restores + re-meshes (real calls in record mode, replayed costs
    otherwise), appending ``{event, step, vtime}`` records that surface
    as the ``SimReport.live`` recovery timeline.
    """

    name = "live_train"
    DRIVER = "live.trainer"
    STORE = "live.store"

    def __init__(self, *, ledger: CostLedger,
                 stack: Optional[TrainerStack] = None,
                 n_steps: int = 8, checkpoint_every: int = 3,
                 n_shards: int = 2, detection_ns: int = 2_000_000,
                 ckpt_bytes: int = 4_000_000, req_bytes: int = 256,
                 ack_bytes: int = 64, store_ns: int = 500_000,
                 beat_ns: int = 1_000_000, n_beats: Optional[int] = None,
                 cell: Optional[str] = None,
                 link: LinkSpec = LinkSpec(bandwidth_bps=25e9 * 8,
                                           latency_ns=10_000)):
        if ledger.mode == "record" and stack is None:
            raise ValueError("record mode needs a real TrainerStack")
        if checkpoint_every < 1 or n_steps < 1:
            raise ValueError("n_steps and checkpoint_every must be >= 1")
        self.ledger = ledger
        self.stack = stack
        self.n_steps = n_steps
        self.checkpoint_every = checkpoint_every
        self.n_shards = n_shards
        self.detection_ns = detection_ns
        self.ckpt_bytes = ckpt_bytes
        self.req_bytes = req_bytes
        self.ack_bytes = ack_bytes
        self.store_ns = store_ns
        self.beat_ns = beat_ns
        self.n_beats = n_beats if n_beats is not None else n_steps * 8
        self.cell = cell
        self.link = link
        self.shards = [f"live.shard{i}" for i in range(1, n_shards + 1)]
        self._handle = TaskHandle()
        self._fail_at: Optional[int] = None   # armed at build by on_fail
        self._timeline: List[dict] = []
        self.restarts = 0
        self.final_step = 0
        self.steps_done = np.zeros(1, dtype=np.int64)
        self.beats = np.zeros(max(1, n_shards), dtype=np.int64)

    # -- build-time failure notice (Program.on_fail) -------------------------
    def _shard_on_fail(self, failspec) -> str:
        """A scenario failure resolved onto a shard anchor: the anchor
        still dies (``"kill"``), and the driver's detection arms at the
        failure vtime — deterministic build-time data, identical in
        every engine and every forked dist replica."""
        at = failspec.at_vtime
        if at is not None:
            self._fail_at = at if self._fail_at is None \
                else min(self._fail_at, at)
        return "kill"

    def _event(self, event: str, step: int, task) -> None:
        self._timeline.append({"event": event, "step": int(step),
                               "vtime": int(task.vtime)})

    # -- bodies --------------------------------------------------------------
    def _driver_factory(self, eps):
        ep = eps["live.tr"]

        def body():
            led, stack = self.ledger, self.stack
            injector = FailureInjector()
            if stack is not None:
                stack.setup()        # cluster warm-up: outside sim time
            task = self._handle.task
            step = last_saved = 0
            fired = resumed_pending = False
            while step < self.n_steps:
                if (self._fail_at is not None and not fired
                        and task.vtime >= self._fail_at):
                    fired = True
                    # the dead shard host is noticed one detection
                    # latency after its failure vtime passed
                    yield Compute(self.detection_ns)
                    # route through the real runtime failure machinery
                    injector.fail_at_steps.add(step)
                    try:
                        injector.check(step)
                    except SimulatedHostFailure:
                        self.restarts += 1
                        self._event("detect", step, task)
                        # fetch the last committed checkpoint from the
                        # store (request out, checkpoint bytes back),
                        # then the real restore + state rebuild
                        yield Send(ep, "live.ckpt", self.req_bytes,
                                   payload=("restore", last_saved))
                        yield Recv(ep)
                        _, cost = led.charge(
                            self.DRIVER, f"restore:{self.restarts}",
                            stack.restore if stack else None)
                        yield LiveCall(_noop, cost_ns=cost,
                                       label="restore")
                        step = last_saved
                        self._event("restore", step, task)
                        # elastic re-mesh: rebuild without the dead host
                        _, cost = led.charge(
                            self.DRIVER, f"remesh:{self.restarts}",
                            stack.remesh if stack else None)
                        yield LiveCall(_noop, cost_ns=cost,
                                       label="remesh")
                        self._event("remesh", step, task)
                        resumed_pending = True
                _, cost = led.charge(self.DRIVER, f"step:{step}",
                                     stack.step if stack else None,
                                     (step,))
                yield LiveCall(_noop, cost_ns=cost, label=f"step:{step}")
                step += 1
                self.steps_done[0] = max(int(self.steps_done[0]), step)
                if resumed_pending:
                    self._event("resumed", step - 1, task)
                    resumed_pending = False
                if step % self.checkpoint_every == 0 \
                        and step < self.n_steps:
                    yield Send(ep, "live.ckpt", self.ckpt_bytes,
                               payload=("save", step))
                    yield Recv(ep)
                    _, cost = led.charge(self.DRIVER, f"save:{step}",
                                         stack.save if stack else None,
                                         (step,))
                    yield LiveCall(_noop, cost_ns=cost,
                                   label=f"save:{step}")
                    last_saved = step
            self.final_step = step
            yield Send(ep, "live.ckpt", 64, payload=("close", None))
            if stack is not None:
                stack.close()
        return body()

    def _store_factory(self, eps):
        sep = eps["live.ckpt"]

        def body():
            while True:
                msg = yield Recv(sep)
                kind = msg.payload[0]
                if kind == "close":
                    return
                yield Compute(self.store_ns)
                size = self.ckpt_bytes if kind == "restore" \
                    else self.ack_bytes
                yield Send(sep, "live.tr", size,
                           payload=("ack", msg.payload[1]))
        return body()

    def _shard_factory(self, i: int):
        def make_body(eps):
            def body():
                for b in range(self.n_beats):
                    yield Compute(self.beat_ns)
                    self.beats[i] = b + 1
            return body()
        return make_body

    # -- workload protocol ---------------------------------------------------
    def fabrics(self) -> List[FabricSpec]:
        return [FabricSpec("livec", self.link)]

    def programs(self) -> List[Program]:
        out = [Program(
            name=self.DRIVER, make_body=self._driver_factory,
            endpoints=(EndpointSpec("live.tr", "livec"),),
            kind="live", cell=self.cell, handle=self._handle)]
        for i, s in enumerate(self.shards):
            out.append(Program(name=s, make_body=self._shard_factory(i),
                               on_fail=self._shard_on_fail))
        out.append(Program(name=self.STORE,
                           make_body=self._store_factory,
                           endpoints=(EndpointSpec("live.ckpt",
                                                   "livec"),)))
        return out

    def default_placement(self) -> Dict[str, int]:
        pl = {self.DRIVER: 0}
        for i, s in enumerate(self.shards):
            pl[s] = i + 1
        pl[self.STORE] = self.n_shards + 1
        return pl

    def traffic(self):
        saves = max(0, self.n_steps // self.checkpoint_every - 1)
        return {(self.DRIVER, self.STORE):
                float(self.ckpt_bytes) * max(1, saves)}

    def progress(self):
        return {"steps_done": self.steps_done, "beats": self.beats}

    def reset(self) -> None:
        self.steps_done[:] = 0
        self.beats[:] = 0
        self._timeline.clear()
        self.restarts = 0
        self.final_step = 0
        self._fail_at = None     # re-armed by on_fail at build time
        if self.ledger.mode == "replay":
            self.ledger.rewind()
        elif self.ledger.tasks.get(self.DRIVER):
            raise ValueError(
                f"record ledger already holds {self.DRIVER!r} costs — "
                f"one record run per ledger; save the trace and replay "
                f"it, or record with a fresh ledger")

    # -- live hooks ----------------------------------------------------------
    def live_mode(self):
        return self.ledger.mode

    def live_fns(self):
        return {self.DRIVER: self.stack.step} if self.stack else {}

    def live_report(self, tasks: Optional[set] = None):
        sec = {"mode": self.ledger.mode,
               "calibration": self.ledger.calibration, "tasks": {}}
        if tasks is None or self.DRIVER in tasks:
            sec["tasks"][self.DRIVER] = {
                "recovery": list(self._timeline),
                "restarts": int(self.restarts),
                "final_step": int(self.final_step)}
        return sec


# ---------------------------------------------------------------------------
# canned marquee scenario + recorder
# ---------------------------------------------------------------------------

#: Scenario parameters of the canned recovery run.  A record run stores
#: the resolved values in the trace's ``meta["recovery"]``; a replay
#: rebuilds the simulation from them, so trace and scenario cannot
#: drift apart silently (and any residual divergence fails fast in the
#: ledger's label check).
RECOVERY_DEFAULTS: Dict[str, Any] = dict(
    n_steps=8, checkpoint_every=3, n_shards=2, fail_host=1,
    fail_at_vtime=600_000_000, detection_ns=2_000_000,
    ckpt_bytes=4_000_000, req_bytes=256, ack_bytes=64,
    store_ns=500_000, beat_ns=1_000_000)

_WL_KEYS = ("n_steps", "checkpoint_every", "n_shards", "detection_ns",
            "ckpt_bytes", "req_bytes", "ack_bytes", "store_ns",
            "beat_ns")

#: Safety margin (in train steps) the recovery recorder adds when it
#: derives ``fail_at_vtime`` from a probe step.  The failure should
#: land *after* the first checkpoint commits (``checkpoint_every``
#: steps) but before the next one — half a step past the commit puts it
#: mid-step on any machine speed, so the replayed restore always
#: resumes from a real committed checkpoint.  Named (rather than a bare
#: ``+ 0.5`` in the formula) and pinned into ``meta["fail_probe"]`` so
#: every derived fail-at vtime in a saved trace is auditable.
FAIL_PROBE_MARGIN_STEPS: float = 0.5


def live_recovery_sim(ledger: CostLedger, *,
                      stack: Optional[TrainerStack] = None,
                      **overrides) -> Simulation:
    """Build the marquee recovery Simulation for ``ledger``'s mode.
    Replay reads the scenario parameters pinned in the trace meta;
    record resolves defaults + overrides and pins them."""
    params = dict(RECOVERY_DEFAULTS)
    if ledger.mode == "replay":
        params.update(ledger.meta.get("recovery", {}))
    unknown = sorted(set(overrides) - set(params))
    if unknown:
        raise ValueError(f"unknown recovery parameters {unknown}; "
                         f"expected {sorted(params)}")
    params.update(overrides)
    if ledger.mode == "record":
        ledger.meta["recovery"] = dict(params)
    wl = LiveTrainerRecovery(ledger=ledger, stack=stack,
                             **{k: params[k] for k in _WL_KEYS})
    n_hosts = params["n_shards"] + 2
    if not 0 <= params["fail_host"] < n_hosts:
        raise ValueError(f"fail_host {params['fail_host']} outside "
                         f"0..{n_hosts - 1}")
    topo = Topology.full_mesh(n_hosts, wl.link, n_cpus=4)
    return Simulation(
        topo, wl,
        Scenario("live recovery",
                 (FailHost(host=params["fail_host"],
                           at_vtime=params["fail_at_vtime"]),)),
        placement=wl.default_placement())


def record_live_recovery(out_path, *, arch: str = "qwen3_4b",
                         seq_len: int = 32, global_batch: int = 4,
                         calibration: float = 1.0,
                         engine: str = "async", device=None, **overrides):
    """One-shot recorder for the canned recovery scenario: run the real
    sharded trainer under simulated time, measure every phase, and save
    the trace to ``out_path``.  Returns ``(report, ledger)``.

    The failure vtime (unless overridden) is placed from a probe step:
    a little past the first checkpoint commit, so the restore resumes
    from a real committed checkpoint mid-run on any machine speed."""
    import time as _time
    ledger = CostLedger.record(calibration=calibration)
    params = dict(RECOVERY_DEFAULTS)
    params.update(overrides)
    stack = TrainerStack(arch=arch, n_steps=params["n_steps"],
                         seq_len=seq_len, global_batch=global_batch,
                         device=device)
    stack.setup()
    if "fail_at_vtime" not in overrides:
        t0 = _time.perf_counter_ns()
        stack.step(0)
        span = _time.perf_counter_ns() - t0
        steps_to_failure = params["checkpoint_every"] \
            + FAIL_PROBE_MARGIN_STEPS
        params["fail_at_vtime"] = max(1, int(
            span * calibration * steps_to_failure))
        ledger.meta["fail_probe"] = {
            "probe_span_ns": int(span), "calibration": calibration,
            "margin_steps": FAIL_PROBE_MARGIN_STEPS,
            "steps_to_failure": steps_to_failure,
            "fail_at_vtime": params["fail_at_vtime"]}
    sim = live_recovery_sim(ledger, stack=stack, **params)
    report = sim.run(engine=engine)
    ledger.save(out_path)
    return report, ledger


def recovery_timeline(report, *, workload: str = "live_train",
                      task: str = LiveTrainerRecovery.DRIVER
                      ) -> List[dict]:
    """The ``{event, step, vtime}`` recovery records of a run's live
    section (empty when the scenario had no failure)."""
    sec = report.live.get(workload, {})
    return list(sec.get("tasks", {}).get(task, {})
                .get("recovery", []))


# ---------------------------------------------------------------------------
# serve scenario: real BatchServer under open-loop arrivals
# ---------------------------------------------------------------------------


class ServeStack:
    """Record-mode binding of the real :class:`~repro_torch.serve.loop.
    BatchServer` to :class:`~repro_torch.sim.workloads.LiveServe`'s
    per-wave phases, on ``device`` (``None`` means CUDA and raises
    without it; replay passes ``stack=None`` and needs no device).

    The server runs a *static* batch per wave (the BatchServer
    contract): every wave prefill uses the same ``(max_batch,
    prompt_len)`` prompt shape regardless of how many requests the wave
    actually carries, so recorded costs reflect the static batch the
    real server would execute.  Prompts are deterministic functions of
    the wave index — no RNG stream in the record path.  Each phase ends
    in a device synchronize, so a recorded span times the work."""

    def __init__(self, *, arch: str = "qwen3_4b", max_batch: int = 4,
                 prompt_len: int = 8, decode_steps: int = 4,
                 seed: int = 0, device=None):
        if max_batch < 1 or prompt_len < 1 or decode_steps < 1:
            raise ValueError("max_batch, prompt_len and decode_steps "
                             "must be >= 1")
        self.arch = arch
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.decode_steps = decode_steps
        self.seed = seed
        self.device = device
        self.server = None
        self._tok = self._cache = None

    def _prompts(self, wave: int):
        vocab = self.server.cfg.vocab
        ids = (np.arange(self.max_batch * self.prompt_len,
                         dtype=np.int64)
               .reshape(self.max_batch, self.prompt_len)
               * 31 + wave * 131 + 7) % max(2, vocab)
        return torch.as_tensor(ids.astype(np.int32)).to(self.server.device)

    def setup(self) -> None:
        if self.server is not None:
            return
        import dataclasses

        from repro_torch import configs
        from repro_torch.core.engine_torch import resolve_device
        from repro_torch.models import registry
        from repro_torch.serve.loop import BatchServer
        dev = resolve_device(self.device, "ServeStack")
        cfg = dataclasses.replace(configs.get_smoke(self.arch),
                                  remat=False)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        params = registry.init(cfg, gen, device=dev)
        self.server = BatchServer(cfg, params,
                                  max_new_tokens=self.decode_steps + 1,
                                  device=dev)
        # warm both steps (kernel build and load, allocator) so recorded
        # per-wave costs are steady-state execution
        self.prefill(0, self.max_batch)
        self.decode(0, 0)
        self._tok = self._cache = None

    def _finish(self, logits) -> None:
        from repro_torch.serve.loop import sync
        self._tok = logits.argmax(dim=-1).to(torch.int32)
        sync(self.server.device)

    def prefill(self, wave: int, batch: int) -> None:
        logits, self._cache = self.server._prefill(
            self.server.params, self._prompts(wave), None)
        self._finish(logits)

    def decode(self, wave: int, d: int) -> None:
        logits, self._cache = self.server._decode(
            self.server.params, self._tok, self._cache)
        self._finish(logits)

    def close(self) -> None:
        self._tok = self._cache = None


#: Scenario parameters of the canned serve run.  ``arrivals`` is the
#: resolved open-loop schedule: a record run pins the concrete integer
#: list (plus everything else) into ``meta["serve"]``, so a replay
#: reads the exact schedule back and never re-derives it from an RNG
#: stream.  ``mean_gap_ns=None`` means the recorder probes one wave and
#: aims the mean inter-arrival gap at half the wave's service span, so
#: waves genuinely batch up on any machine speed.
SERVE_DEFAULTS: Dict[str, Any] = dict(
    n_requests=12, mean_gap_ns=None, seed=0, arrivals=None,
    max_batch=4, decode_steps=4, req_bytes=512, resp_bytes=2048)


def live_serve_sim(ledger: CostLedger, *,
                   stack: Optional[ServeStack] = None,
                   **overrides) -> Simulation:
    """Build the canned serve Simulation for ``ledger``'s mode: the
    live server on one host, the open-loop source on another.  Replay
    reads the pinned parameters (including the concrete arrival
    schedule) from the trace meta; record resolves defaults + overrides
    and pins them."""
    params = dict(SERVE_DEFAULTS)
    if ledger.mode == "replay":
        params.update(ledger.meta.get("serve", {}))
    unknown = sorted(set(overrides) - set(params))
    if unknown:
        raise ValueError(f"unknown serve parameters {unknown}; "
                         f"expected {sorted(params)}")
    params.update(overrides)
    if params["arrivals"] is None:
        if params["mean_gap_ns"] is None:
            raise ValueError(
                "no arrival schedule: pass arrivals=... (explicit "
                "vtimes) or mean_gap_ns=... (Poisson schedule), or "
                "record via record_live_serve which probes a gap")
        params["arrivals"] = [int(v) for v in poisson_arrivals(
            params["n_requests"], params["mean_gap_ns"],
            seed=params["seed"])]
    params["arrivals"] = [int(v) for v in params["arrivals"]]
    params["n_requests"] = len(params["arrivals"])
    if ledger.mode == "record":
        ledger.meta["serve"] = dict(params)
    wl = LiveServe(ledger=ledger, stack=stack,
                   arrivals=params["arrivals"],
                   max_batch=params["max_batch"],
                   decode_steps=params["decode_steps"],
                   req_bytes=params["req_bytes"],
                   resp_bytes=params["resp_bytes"])
    topo = Topology.full_mesh(2, wl.link, n_cpus=4)
    return Simulation(topo, wl, placement=wl.default_placement())


def record_live_serve(out_path, *, arch: str = "qwen3_4b",
                      prompt_len: int = 8, calibration: float = 1.0,
                      engine: str = "async", device=None, **overrides):
    """One-shot recorder for the canned serve scenario: run the real
    BatchServer under simulated time against an open-loop Poisson
    schedule, measure every wave phase, and save the trace to
    ``out_path``.  Returns ``(report, ledger)``.

    Unless ``arrivals``/``mean_gap_ns`` is overridden, the schedule is
    derived from a probe wave (one prefill + ``decode_steps`` decodes):
    the mean gap targets half the wave span, so the open-loop source
    outruns the server and waves batch multiple requests.  The probe
    is pinned into ``meta["serve_probe"]`` for auditability; the
    resolved schedule itself lands in ``meta["serve"]["arrivals"]``."""
    import time as _time
    ledger = CostLedger.record(calibration=calibration)
    params = dict(SERVE_DEFAULTS)
    params.update(overrides)
    stack = ServeStack(arch=arch, max_batch=params["max_batch"],
                       prompt_len=prompt_len,
                       decode_steps=params["decode_steps"], device=device)
    stack.setup()
    if params["arrivals"] is None and params["mean_gap_ns"] is None:
        t0 = _time.perf_counter_ns()
        stack.prefill(0, params["max_batch"])
        for d in range(params["decode_steps"]):
            stack.decode(0, d)
        span = _time.perf_counter_ns() - t0
        params["mean_gap_ns"] = max(1, int(span * calibration) // 2)
        ledger.meta["serve_probe"] = {
            "probe_span_ns": int(span), "calibration": calibration,
            "mean_gap_ns": params["mean_gap_ns"]}
    sim = live_serve_sim(ledger, stack=stack, **params)
    report = sim.run(engine=engine)
    ledger.save(out_path)
    return report, ledger


def serve_latency(report, *, workload: str = "live_serve",
                  task: str = LiveServe.SERVER) -> Dict[str, int]:
    """The simulated time-in-system percentiles (p50/p95/p99/max/mean,
    ns) of a run's serve live section (empty if absent)."""
    sec = report.live.get(workload, {})
    return dict(sec.get("tasks", {}).get(task, {})
                .get("latency_ns", {}))


# ---------------------------------------------------------------------------
# co-located live train + live serve on shared §3.3 cells
# ---------------------------------------------------------------------------

#: Scenario parameters of the canned co-located run: a live trainer
#: (no failure injected) and a live server sharing host 0 and one
#: declared memory-hierarchy cell, recorded into ONE multi-driver
#: ledger.  Record pins the resolved dict (including the serve arrival
#: schedule) into ``meta["colocated"]``.
COLOCATED_DEFAULTS: Dict[str, Any] = dict(
    train=dict(n_steps=4, checkpoint_every=2, n_shards=1,
               detection_ns=2_000_000, ckpt_bytes=1_000_000,
               req_bytes=256, ack_bytes=64, store_ns=500_000,
               beat_ns=1_000_000),
    serve=dict(n_requests=8, mean_gap_ns=None, seed=1, arrivals=None,
               max_batch=2, decode_steps=2, req_bytes=512,
               resp_bytes=2048),
    cell=dict(ways=2, working_set_frac=0.7, bw_share=0.3,
              bw_demand=0.7, mem_frac=0.6),
    cell_cfg=dict(n_warm_slots=1, recondition_ns=20_000))

CELL_NAME = "colo"


def live_colocated_sim(ledger: CostLedger, *,
                       train_stack: Optional[TrainerStack] = None,
                       serve_stack: Optional[ServeStack] = None,
                       **overrides) -> Simulation:
    """Build the live-on-live interference Simulation: the recovery
    driver (failure-free here) and the live server both bound to cell
    ``"colo"`` on host 0, so their LiveCalls charge §3.3 co-activity
    slowdowns against each other.  Both workloads share ``ledger`` —
    one trace holds both drivers' costs (``live.trainer`` +
    ``serve.live`` task keys are disjoint)."""
    params = {k: dict(v) for k, v in COLOCATED_DEFAULTS.items()}
    if ledger.mode == "replay":
        for k, v in ledger.meta.get("colocated", {}).items():
            params.setdefault(k, {}).update(v)
    unknown = sorted(set(overrides) - set(params))
    if unknown:
        raise ValueError(f"unknown colocated sections {unknown}; "
                         f"expected {sorted(params)}")
    for k, v in overrides.items():
        bad = sorted(set(v) - set(COLOCATED_DEFAULTS[k]))
        if bad:
            raise ValueError(f"unknown colocated {k} parameters {bad}")
        params[k].update(v)
    sp = params["serve"]
    if sp["arrivals"] is None:
        if sp["mean_gap_ns"] is None:
            raise ValueError(
                "no serve arrival schedule: pass serve={'arrivals': "
                "...} or serve={'mean_gap_ns': ...}, or record via "
                "record_live_colocated which probes a gap")
        sp["arrivals"] = [int(v) for v in poisson_arrivals(
            sp["n_requests"], sp["mean_gap_ns"], seed=sp["seed"])]
    sp["arrivals"] = [int(v) for v in sp["arrivals"]]
    sp["n_requests"] = len(sp["arrivals"])
    if ledger.mode == "record":
        ledger.meta["colocated"] = {k: dict(v)
                                    for k, v in params.items()}
    train = LiveTrainerRecovery(
        ledger=ledger, stack=train_stack, cell=CELL_NAME,
        **{k: params["train"][k] for k in _WL_KEYS})
    serve = LiveServe(
        ledger=ledger, stack=serve_stack, cell=CELL_NAME,
        arrivals=sp["arrivals"], max_batch=sp["max_batch"],
        decode_steps=sp["decode_steps"], req_bytes=sp["req_bytes"],
        resp_bytes=sp["resp_bytes"])
    n_shards = params["train"]["n_shards"]
    n_hosts = n_shards + 3
    topo = Topology.full_mesh(n_hosts, train.link, n_cpus=4)
    topo.cell(CELL_NAME, **params["cell"])
    topo.cell_config(**params["cell_cfg"])
    placement = train.default_placement()      # driver 0, shards,
    placement[serve.SERVER] = 0                # store; server shares
    placement[serve.SOURCE] = n_shards + 2     # the driver's host/cell
    return Simulation(topo, [train, serve], placement=placement)


def record_live_colocated(out_path, *, arch: str = "qwen3_4b",
                          seq_len: int = 32, global_batch: int = 4,
                          prompt_len: int = 8,
                          calibration: float = 1.0,
                          engine: str = "async", device=None,
                          **overrides):
    """One-shot recorder for the co-located scenario: real trainer
    steps (single-device mesh, in-process) interleaved with real
    BatchServer waves, both measured into one multi-driver ledger under
    the in-process engines' one-live-call-at-a-time dispatch.  Returns
    ``(report, ledger)``."""
    import time as _time
    ledger = CostLedger.record(calibration=calibration)
    params = {k: dict(v) for k, v in COLOCATED_DEFAULTS.items()}
    for k, v in overrides.items():
        if k not in params:
            raise ValueError(f"unknown colocated section {k!r}")
        params[k].update(v)
    tp, sp = params["train"], params["serve"]
    train_stack = TrainerStack(arch=arch, n_steps=tp["n_steps"],
                               seq_len=seq_len,
                               global_batch=global_batch,
                               mesh_shape=(1, 1), device=device)
    serve_stack = ServeStack(arch=arch, max_batch=sp["max_batch"],
                             prompt_len=prompt_len,
                             decode_steps=sp["decode_steps"],
                             device=device)
    train_stack.setup()
    serve_stack.setup()
    if sp["arrivals"] is None and sp["mean_gap_ns"] is None:
        t0 = _time.perf_counter_ns()
        serve_stack.prefill(0, sp["max_batch"])
        for d in range(sp["decode_steps"]):
            serve_stack.decode(0, d)
        span = _time.perf_counter_ns() - t0
        sp["mean_gap_ns"] = max(1, int(span * calibration) // 2)
        ledger.meta["serve_probe"] = {
            "probe_span_ns": int(span), "calibration": calibration,
            "mean_gap_ns": sp["mean_gap_ns"]}
    sim = live_colocated_sim(ledger, train_stack=train_stack,
                             serve_stack=serve_stack, **params)
    report = sim.run(engine=engine)
    ledger.save(out_path)
    return report, ledger


# ---------------------------------------------------------------------------
# facade guards + dist merging
# ---------------------------------------------------------------------------


def check_dist_live(workloads: Sequence[Workload]) -> None:
    """``engine="dist"`` preflight for live workloads (see module
    docstring): reject record mode, and require every live fn to
    pickle — failing with a facade error that names the fn."""
    import pickle
    for wl in workloads:
        if wl.live_mode() == "record":
            raise ValueError(
                f"workload {wl.name!r}: live record mode is not "
                f"supported under engine='dist' — forked workers each "
                f"measure their own wall clock and cannot produce one "
                f"coherent trace; record on an in-process engine "
                f"('single'/'barrier'/'async') and replay the saved "
                f"trace under dist")
        for prog, fn in sorted(wl.live_fns().items()):
            try:
                pickle.dumps(fn)
            except Exception as e:
                raise ValueError(
                    f"engine='dist' cannot run live program {prog!r}: "
                    f"its live fn {fn!r} is not picklable ({e}).  Dist "
                    f"workers are forked OS processes and an "
                    f"unpicklable callable almost always captures "
                    f"fork-unsafe state (device buffers, locks, open "
                    f"files); define live fns at module top level with "
                    f"picklable state, or record a trace in-process "
                    f"and replay it (replay never calls the fn)"
                ) from e


def merge_live_sections(parts: Sequence[Dict[str, dict]]
                        ) -> Dict[str, dict]:
    """Merge per-worker ``SimReport.live`` sections (dist engine).
    ``tasks`` sub-dicts are owner-disjoint (each worker reports only
    the tasks it executed) and union; every other key is deterministic
    build-time data, identical across replicas — first non-empty
    wins."""
    out: Dict[str, dict] = {}
    for part in parts:
        for wl_name, sec in part.items():
            cur = out.setdefault(wl_name, {})
            for key, value in sec.items():
                if key == "tasks":
                    cur.setdefault("tasks", {}).update(value)
                elif key not in cur or cur[key] in ("", None):
                    cur[key] = value
    return out
