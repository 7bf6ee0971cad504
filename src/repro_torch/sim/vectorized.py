"""The vectorized facade engine: compile a Simulation to int32 arrays,
run the round loop on a device (``repro_torch.core.engine_torch``),
decompile back to a normal :class:`~repro_torch.sim.report.SimReport`.

``Simulation.run(engine="vectorized")`` is the fifth engine, held to
the same cross-engine equivalence bar as single/barrier/async/dist via
a *two-tier* contract (tests/engine_harness.py):

* **exact tier** — every additive ns quantity of the scenario (compute
  durations post-straggler, the scheduler's send overhead, per-message
  serialization and latency, DegradeLink extras) is divisible by the
  compiled tick (auto tick = their gcd, so auto-ticked scenarios are
  always exact when they fit the range): results are **bit-identical**
  to the reference engines, including per-link stats.
* **tolerance tier** — an explicit ``tick_ns=`` quantizes those
  quantities: per-task vtimes carry a declared bound
  (``tick * n_quantities`` — each additive term appears at most once on
  any event's max-plus dependency path), while the schedule-independent
  invariants (completion sets, per-task states, message/byte totals,
  progress arrays) stay exact.

Admissible scenario surface (everything else raises
:class:`UnsupportedByEngine` at build time, never silently diverges):
modeled programs lowered via ``Workload.vec_ops`` (RackRing,
ChipRingTraining), any topology/placement, Straggler / FailTask /
FailHost / DegradeLink / Interference injections, bounded-skew scopes.
Not admissible: live programs (real callables can't be arrays), §3.3
cells (stateful per-dispatch charges), ``cpu_resource`` (CPU-slot
schedules are engine timing, not results), multi-producer endpoints
(receive matching becomes schedule-dependent — e.g. ModeledServe), and
scenarios the reference would preempt (>= ``preempt_after`` consecutive
zero-progress computes).

Why the restricted surface is *provably* schedule-independent: each
channel has a single producer executing its sends in program order, so
per-channel FIFO busy chains and message visibilities depend only on
the producer's vtime trajectory; each receive is matched to one message
at compile time and resolves to ``vtime = max(vtime, visibility)``;
scope gating and CPU slots delay dispatch but never change any of those
values.  Hence dispatch-all-eligible-per-round produces the reference
fixpoint exactly.

Devices: the compiler and decompiler are host numpy; the tape moves to
the run's device once.  ``device=None`` means ``"cuda"`` and raises
without CUDA.  ``pallas="auto"`` runs the CUDA kernels (``minskew`` in
every round, ``hub_route`` in the decompiler's fan-out) on a CUDA
device and their plain versions on the CPU; ``"on"`` demands the
kernels, ``"off"`` the plain versions.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.core import engine_torch as ej
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.vtime import SEC
from repro_torch.kernels.hub_route import hub_route
from repro_torch.sim.report import HostReport, SimReport, _jsonable
from repro_torch.sim.scenario import (BitFlip, ClockSkew, DegradeLink,
                                      FailTask, Interference, JoinHost,
                                      Scenario)
from repro_torch.sim.workload import VecCompute, VecMark, VecRecv, VecSend

__all__ = ["UnsupportedByEngine", "compile_simulation",
           "run_vectorized_sim", "sweep_vectorized", "SweepResult"]

#: reference-engine constants, read off Scheduler so a recalibration
#: there cannot silently diverge this engine
_SCHED_DEFAULTS = {
    p.name: p.default
    for p in inspect.signature(Scheduler.__init__).parameters.values()}
SEND_OVERHEAD_NS = int(_SCHED_DEFAULTS["send_overhead_ns"])
PREEMPT_AFTER = int(_SCHED_DEFAULTS["preempt_after"])

_INF = ej.INF_TICKS


class UnsupportedByEngine(ValueError):
    """The scenario uses a feature outside the vectorized engine's
    admissible surface (see module docstring).  Raised at build time so
    an unsupported run is an explicit error, not a silent divergence."""


def _ser_ns(size_bytes: int, link) -> int:
    # exactly Hub._serialize's expression
    return int(size_bytes * 8 / link.bandwidth_bps * SEC)


@dataclasses.dataclass
class _Msg:
    src_ep: str
    dst_ep: str
    size: int
    src_task: int
    src_host: int
    dst_host: int
    ch1: int
    ser1: int               # ns
    lat1: int               # ns
    two_stage: bool
    ch2: int
    ser2: int               # ns
    lat2: int               # ns
    extras: List[Tuple[int, int]]   # (from_vtime ns, extra ns)


@dataclasses.dataclass
class CompiledSim:
    """Tick-level numpy arrays (``tape``, keyed by
    :class:`~repro_torch.core.engine_torch.VecTape` field) + everything
    decompile needs."""
    tape: Dict[str, np.ndarray]
    n_channels: int
    tick_ns: int
    tier: str                       # "exact" | "tolerance"
    tol_ns: int                     # declared vtime bound (0 = exact)
    max_rounds: int
    n_tasks: int
    n_programs: int                 # leading tasks that are programs
    task_names: List[str]
    task_hosts: List[int]
    #: per task: (op_index, workload_index, array, index, value); fires
    #: iff final pc >= op_index
    markers: List[List[Tuple[int, int, str, int, int]]]
    msgs: List[_Msg]
    hub_base: str                   # multi-host hub name prefix
    n_hosts: int
    scenario_name: str
    #: additive ns quantities (for sweep: shared-tick computation)
    quantities: List[int]


# ---------------------------------------------------------------------------
# lowering: facade -> ns-level tapes
# ---------------------------------------------------------------------------


def _detect_cells(sim, programs, inter_targets) -> bool:
    cell_of = {p.name: p.cell for _, p in programs if p.cell}
    load_cells = [inj.cell for inj, _ in inter_targets]
    if sim.cells_mode == "auto":
        prog_hosts: Dict[int, List[str]] = {}
        for _, p in programs:
            prog_hosts.setdefault(sim.placement[p.name],
                                  []).append(p.name)
        load_hosts = {h for _, h in inter_targets}
        for h, names in prog_hosts.items():
            if len(names) >= 2 or h in load_hosts:
                return True
        if load_cells:
            return True
    return bool(cell_of) or any(c is not None for c in load_cells)


def _lower(sim) -> Dict[str, Any]:
    """Validate the scenario against the admissible surface and lower
    it to ns-level python/numpy structures (tick-independent)."""
    topo = sim.topology
    programs = sim._programs()
    fabrics = sim._fabrics()
    names = [p.name for _, p in programs]
    placement = sim._resolve_placement(names)
    sim.placement = placement
    inter_targets = sim._resolve_interference()

    if sim.cpu_resource:
        raise UnsupportedByEngine(
            "cpu_resource=True: CPU-slot contention is an engine "
            "schedule, not an array op")
    if getattr(topo, "joins", None) or any(
            isinstance(inj, JoinHost) for inj in sim.scenario.injections):
        raise UnsupportedByEngine(
            "membership joins: late hosts need the conservative "
            "engines' membership-epoch re-solve; the vectorized "
            "compiler lowers a fixed host set")
    for inj in sim.scenario.injections:
        # explicit rejection, not silent omission: a campaign's sweep
        # fast path relies on this raise to fall back to the reference
        # engines for data-corruption / ingress-skew grids
        if isinstance(inj, BitFlip):
            raise UnsupportedByEngine(
                "BitFlip: payload values have no vectorized lowering "
                "(tapes carry sizes and timing, not data)")
        if isinstance(inj, ClockSkew):
            raise UnsupportedByEngine(
                "ClockSkew: ingress hooks are per-delivery hub state, "
                "not a tape-time transform")
    for _, p in programs:
        if p.kind != "modeled":
            raise UnsupportedByEngine(
                f"live program {p.name!r}: real callables have no "
                f"vectorized lowering")
    if _detect_cells(sim, programs, inter_targets):
        raise UnsupportedByEngine(
            "memory-hierarchy cells: per-dispatch cell charges are "
            "stateful scheduler semantics")

    # workload lowering
    ops_by_name: Dict[str, list] = {}
    wl_of_prog: Dict[str, int] = {}
    for wi, wl in enumerate(sim.workloads):
        wl_progs = [p.name for w, p in programs if w is wl]
        vec = wl.vec_ops()
        if vec is None:
            raise UnsupportedByEngine(
                f"workload {wl.name!r} has no vec_ops() lowering")
        missing = [n for n in wl_progs if n not in vec]
        if missing:
            raise ValueError(
                f"vec_ops() of {wl.name!r} missing programs {missing}")
        for n in wl_progs:
            ops_by_name[n] = list(vec[n])
            wl_of_prog[n] = wi

    # endpoints (mirrors the build() spawn loop's wiring checks)
    ep_owner: Dict[str, str] = {}
    ep_fabric: Dict[str, str] = {}
    fabric_by_name = {f.name: f for f in fabrics}
    for _, p in programs:
        for es in p.endpoints:
            if es.name in ep_owner:
                raise ValueError(f"duplicate endpoint {es.name!r}")
            if es.fabric not in fabric_by_name:
                raise KeyError(f"unknown fabric {es.fabric!r}")
            ep_owner[es.name] = p.name
            ep_fabric[es.name] = es.fabric

    scale, fails = sim._resolve_fault_plan(names)

    # task list: programs (report-visible) then interference loads
    tapes: List[list] = []        # per task: real ops (marks stripped)
    markers: List[List[Tuple[int, int, str, int, int]]] = []
    task_names: List[str] = []
    task_hosts: List[int] = []
    for _, p in programs:
        factor = scale.get(p.name)
        real: list = []
        marks: List[Tuple[int, int, str, int, int]] = []
        for op in ops_by_name[p.name]:
            if isinstance(op, VecMark):
                marks.append((len(real), wl_of_prog[p.name],
                              op.array, op.index, op.value))
                continue
            if isinstance(op, VecCompute):
                ns = int(op.ns * factor) if factor is not None else op.ns
                real.append(VecCompute(ns))
            elif isinstance(op, (VecSend, VecRecv)):
                if ep_owner.get(op.endpoint) != p.name:
                    raise ValueError(
                        f"program {p.name!r} uses endpoint "
                        f"{op.endpoint!r} it does not own")
                real.append(op)
            else:
                raise UnsupportedByEngine(
                    f"program {p.name!r}: op {op!r} has no vectorized "
                    f"form")
        tapes.append(real)
        markers.append(marks)
        task_names.append(p.name)
        task_hosts.append(placement[p.name])
    n_programs = len(programs)
    for i, (inj, host) in enumerate(inter_targets):
        tapes.append([VecCompute(inj.burst_ns)] * inj.bursts)
        markers.append([])
        task_names.append(f"load{i}")
        task_hosts.append(host)
    n_tasks = len(tapes)
    for name, real in zip(task_names, tapes):
        # the reference counter resets on *progress*, so interleaved
        # sends/recvs don't break a zero-compute run
        zero_run = 0
        for op in real:
            if isinstance(op, VecCompute):
                zero_run = zero_run + 1 if op.ns <= 0 else 0
                if zero_run >= PREEMPT_AFTER:
                    raise UnsupportedByEngine(
                        f"task {name!r}: >= {PREEMPT_AFTER} "
                        f"consecutive zero-progress computes — the "
                        f"reference scheduler would preempt it FAULTY")

    # messages + channels.  Pass 1: sends, in task/program order (=
    # per-channel FIFO order); pass 2: receive matching.
    channels: Dict[tuple, int] = {}

    def chan(key: tuple) -> int:
        return channels.setdefault(key, len(channels))

    msgs: List[_Msg] = []
    sends_to: Dict[str, List[int]] = {}
    dst_sources: Dict[str, set] = {}
    peer_producers: Dict[tuple, set] = {}
    send_arg: Dict[Tuple[int, int], int] = {}
    for t, ops in enumerate(tapes):
        for j, op in enumerate(ops):
            if not isinstance(op, VecSend):
                continue
            if op.dst not in ep_owner:
                raise KeyError(f"unknown endpoint {op.dst!r}")
            fs, fd = ep_fabric[op.endpoint], ep_fabric[op.dst]
            if fs != fd:
                raise UnsupportedByEngine(
                    f"cross-fabric send {op.endpoint!r}->{op.dst!r} "
                    f"({fs!r} vs {fd!r})")
            flink = fabric_by_name[fs].link
            sh = placement[ep_owner[op.endpoint]]
            dh = placement[ep_owner[op.dst]]
            if sh == dh:
                m = _Msg(op.endpoint, op.dst, op.size_bytes, t, sh, dh,
                         ch1=chan(("ep", op.endpoint, op.dst)),
                         ser1=_ser_ns(op.size_bytes, flink),
                         lat1=flink.latency_ns, two_stage=False,
                         ch2=0, ser2=0, lat2=0, extras=[])
            else:
                plink = topo.host_link(sh, dh)
                key = ("peer", sh, dh)
                peer_producers.setdefault(key, set()).add(t)
                m = _Msg(op.endpoint, op.dst, op.size_bytes, t, sh, dh,
                         ch1=chan(key),
                         ser1=_ser_ns(op.size_bytes, plink),
                         lat1=plink.latency_ns, two_stage=True,
                         ch2=chan(("ep", op.endpoint, op.dst)),
                         ser2=_ser_ns(op.size_bytes, flink),
                         lat2=flink.latency_ns, extras=[])
            mid = len(msgs)
            msgs.append(m)
            send_arg[(t, j)] = mid
            sends_to.setdefault(op.dst, []).append(mid)
            dst_sources.setdefault(op.dst, set()).add(op.endpoint)
    n_msgs = len(msgs)
    multi = sorted(ep for ep, srcs in dst_sources.items()
                   if len(srcs) > 1)
    if multi:
        raise UnsupportedByEngine(
            f"endpoints {multi} receive from multiple source "
            f"endpoints: receive matching would depend on the engine "
            f"schedule")
    multi_peer = sorted(k[1:] for k, ts in peer_producers.items()
                        if len(ts) > 1)
    if multi_peer:
        raise UnsupportedByEngine(
            f"host pairs {multi_peer} carry cross-host sends from "
            f"multiple producer tasks: peer-channel FIFO order would "
            f"depend on the engine schedule")
    recv_arg: Dict[Tuple[int, int], int] = {}
    recv_count: Dict[str, int] = {}
    for t, ops in enumerate(tapes):
        for j, op in enumerate(ops):
            if not isinstance(op, VecRecv):
                continue
            k = recv_count.get(op.endpoint, 0)
            recv_count[op.endpoint] = k + 1
            matched = sends_to.get(op.endpoint, [])
            # unmatched -> the never-sent sentinel row (blocks forever)
            recv_arg[(t, j)] = matched[k] if k < len(matched) else n_msgs

    # DegradeLink hooks -> per-message (from_vtime, extra) pairs
    # (sender-side stage-1 only, exactly like Hub.route's hook pass)
    fabric_eps: Dict[str, List[str]] = {f.name: [] for f in fabrics}
    for _, p in programs:
        for es in p.endpoints:
            fabric_eps[es.fabric].append(es.name)
    for inj in sim.scenario.injections:
        if not isinstance(inj, DegradeLink):
            continue
        if (inj.fabric is None) == (inj.hosts is None):
            raise ValueError("DegradeLink needs exactly one of "
                             "fabric= or hosts=")
        if inj.fabric is not None:
            fab = fabric_by_name.get(inj.fabric)
            if fab is None:
                raise ValueError(f"unknown fabric {inj.fabric!r}")
            members = set(fabric_eps[inj.fabric])
            extra = inj.extra_ns + int(
                (inj.latency_factor - 1.0) * fab.link.latency_ns)

            def match(m: _Msg) -> bool:
                return m.src_ep in members and m.dst_ep in members
        else:
            a, b = inj.hosts
            pair_link = topo.host_link(a, b)
            extra = inj.extra_ns + int(
                (inj.latency_factor - 1.0) * pair_link.latency_ns)

            def match(m: _Msg, a=a, b=b) -> bool:
                return {m.src_host, m.dst_host} == {a, b}
        if extra < 0:
            raise ValueError("DegradeLink may only add latency "
                             "(conservative lookahead)")
        for m in msgs:
            if match(m):
                m.extras.append((inj.from_vtime, extra))

    # fail points: at_compute -> tape index of the k-th (0-based)
    # compute op; at_vtime -> checked at every op boundary
    fail_pc = [None] * n_tasks
    fail_vt = [None] * n_tasks
    for i, name in enumerate(task_names[:n_programs]):
        f = fails.get(name)
        if f is None:
            continue
        if f.at_vtime is not None:
            fail_vt[i] = f.at_vtime
        if f.at_compute is not None:
            k = 0
            for j, op in enumerate(tapes[i]):
                if isinstance(op, VecCompute):
                    if k == f.at_compute:
                        fail_pc[i] = j
                        break
                    k += 1

    # scopes (loads never join)
    name_idx = {n: i for i, n in enumerate(task_names[:n_programs])}
    scope_members: List[List[int]] = []
    scope_skews: List[int] = []
    names_by_wl: Dict[int, List[str]] = {}
    for wl, prog in programs:
        names_by_wl.setdefault(id(wl), []).append(prog.name)
    for wl in sim.workloads:
        wl_names = names_by_wl.get(id(wl), [])
        for ss in wl.scopes():
            members = [name_idx[m]
                       for m in (ss.members or tuple(wl_names))]
            scope_members.append(members)
            scope_skews.append(ss.skew_bound_ns)

    return dict(tapes=tapes, markers=markers, task_names=task_names,
                task_hosts=task_hosts, n_programs=n_programs,
                msgs=msgs, n_channels=len(channels),
                send_arg=send_arg, recv_arg=recv_arg,
                scope_members=scope_members, scope_skews=scope_skews,
                fail_pc=fail_pc, fail_vt=fail_vt,
                hub_base=fabrics[0].name if fabrics else "hub",
                n_hosts=topo.n_hosts, scenario_name=sim.scenario.name)


def _quantities(low: Dict[str, Any]) -> List[int]:
    """Every additive ns quantity of the lowered scenario (each appears
    at most once on any event time's max-plus dependency path)."""
    qs: List[int] = []
    for ops in low["tapes"]:
        qs.extend(op.ns for op in ops if isinstance(op, VecCompute))
    for m in low["msgs"]:
        qs.append(SEND_OVERHEAD_NS)
        qs.extend((m.ser1, m.lat1))
        if m.two_stage:
            qs.extend((m.ser2, m.lat2))
        qs.extend(e for _, e in m.extras)
    return qs


# ---------------------------------------------------------------------------
# quantization: ns -> ticks
# ---------------------------------------------------------------------------


def _quantize(low: Dict[str, Any],
              tick_ns: Optional[int]) -> CompiledSim:
    qs = _quantities(low)
    pos = [q for q in qs if q > 0]
    if tick_ns is None:
        tick = math.gcd(*pos) if pos else 1
    else:
        if tick_ns < 1:
            raise ValueError(f"tick_ns must be >= 1, got {tick_ns}")
        tick = int(tick_ns)
    # conservative horizon bound: any event time is a max-plus path sum
    # over distinct additive quantities <= their total sum
    total_ns = sum(q for q in pos)
    bound_ticks = total_ns // tick + len(qs) + 1
    if bound_ticks >= _INF:
        raise ej.TickRangeError(
            f"scenario horizon bound {total_ns} ns = {bound_ticks} "
            f"ticks at tick_ns={tick} >= 2**30 — exceeds the int32 "
            f"tick range; pass a coarser tick_ns= (tolerance tier) or "
            f"shrink the scenario")
    exact = all(q % tick == 0 for q in pos)
    tier = "exact" if exact else "tolerance"
    # Rounding each additive quantity moves an event time by at most
    # tick / 2 per quantity on its path: tick * len(qs) bounds that.  A
    # DegradeLink threshold (q_ceil below) is compared with a rounded
    # send time, so a send within that error of ``from_vtime`` can land
    # on the other side and gain or lose the whole ``extra_ns``.  Each
    # extra appears at most once on any max-plus path, so adding every
    # extra's ns once bounds the flips too.
    extras_ns = sum(abs(e) for m in low["msgs"] for _, e in m.extras)
    tol = 0 if exact else tick * len(qs) + extras_ns

    def q_add(x: int) -> int:           # additive quantity: round-half
        return (int(x) + tick // 2) // tick

    def q_ceil(x: int) -> int:          # threshold: exact under >= cmp
        return min(-(-int(x) // tick), _INF)

    tapes, msgs = low["tapes"], low["msgs"]
    n = len(tapes)
    p = max(1, max((len(t) for t in tapes), default=0))
    op_kind = np.zeros((n, p), np.int32)
    op_arg = np.zeros((n, p), np.int32)
    n_ops = np.zeros(n, np.int32)
    for i, ops in enumerate(tapes):
        n_ops[i] = len(ops)
        for j, op in enumerate(ops):
            if isinstance(op, VecCompute):
                op_kind[i, j] = ej.OP_COMPUTE
                op_arg[i, j] = q_add(op.ns)
            elif isinstance(op, VecSend):
                op_kind[i, j] = ej.OP_SEND
                op_arg[i, j] = low["send_arg"][(i, j)]
            else:
                op_kind[i, j] = ej.OP_RECV
                op_arg[i, j] = low["recv_arg"][(i, j)]
    fail_pc = np.full(n, _INF, np.int32)
    fail_vt = np.full(n, _INF, np.int32)
    for i in range(n):
        if low["fail_pc"][i] is not None:
            fail_pc[i] = low["fail_pc"][i]
        if low["fail_vt"][i] is not None:
            fail_vt[i] = q_ceil(low["fail_vt"][i])
    s = len(low["scope_members"])
    membership = np.zeros((n, s), bool)
    skew = np.zeros(s, np.int32)
    for j, members in enumerate(low["scope_members"]):
        membership[members, j] = True
        skew[j] = min(low["scope_skews"][j] // tick, _INF - 1)
    m = len(msgs)
    d = max((len(msg.extras) for msg in msgs), default=0)
    ch1 = np.zeros(m, np.int32)
    ser1 = np.zeros(m, np.int32)
    lat1 = np.zeros(m, np.int32)
    two = np.zeros(m, bool)
    ch2 = np.zeros(m, np.int32)
    ser2 = np.zeros(m, np.int32)
    lat2 = np.zeros(m, np.int32)
    extra = np.zeros((m, d), np.int32)
    extra_from = np.zeros((m, d), np.int32)
    for i, msg in enumerate(msgs):
        ch1[i], ser1[i], lat1[i] = msg.ch1, q_add(msg.ser1), \
            q_add(msg.lat1)
        two[i] = msg.two_stage
        ch2[i], ser2[i], lat2[i] = msg.ch2, q_add(msg.ser2), \
            q_add(msg.lat2)
        for k, (frm, ext) in enumerate(msg.extras):
            extra_from[i, k] = q_ceil(frm)
            extra[i, k] = q_add(ext)
    tape = dict(
        op_kind=op_kind, op_arg=op_arg, n_ops=n_ops, fail_pc=fail_pc,
        fail_vtime=fail_vt, membership=membership, skew=skew,
        send_overhead=np.int32(q_add(SEND_OVERHEAD_NS)),
        msg_ch1=ch1, msg_ser1=ser1, msg_lat1=lat1, msg_two_stage=two,
        msg_ch2=ch2, msg_ser2=ser2, msg_lat2=lat2, msg_extra=extra,
        msg_extra_from=extra_from)
    total_ops = int(n_ops.sum())
    return CompiledSim(
        tape=tape, n_channels=low["n_channels"],
        tick_ns=tick, tier=tier, tol_ns=tol,
        max_rounds=total_ops + n + 3,
        n_tasks=n, n_programs=low["n_programs"],
        task_names=low["task_names"], task_hosts=low["task_hosts"],
        markers=low["markers"], msgs=msgs, hub_base=low["hub_base"],
        n_hosts=low["n_hosts"], scenario_name=low["scenario_name"],
        quantities=qs)


def compile_simulation(sim, tick_ns: Optional[int] = None) -> CompiledSim:
    """Lower + quantize ``sim`` for the vectorized engine.  Raises
    :class:`UnsupportedByEngine` for inadmissible scenarios and
    :class:`~repro_torch.core.engine_torch.TickRangeError` when the horizon
    bound exceeds the int32 tick range at the chosen tick."""
    return _quantize(_lower(sim), tick_ns)


# ---------------------------------------------------------------------------
# batched hub fan-out (kernels/hub_route, or its plain version)
# ---------------------------------------------------------------------------


def _batched_visibility(comp: CompiledSim, sent: np.ndarray,
                        sent_vt: np.ndarray, *, device: torch.device,
                        kernel: bool) -> Optional[np.ndarray]:
    """Recompute every message's final visibility (ticks) with the
    batched segmented-scan fan-out pass — the ``hub_route`` wrapper when
    ``kernel`` (the CUDA kernel for a CUDA device), the plain torch scan
    otherwise.  Serialization durations come from the tick-quantized
    tape via the integer ``ser_ns=`` bypass (the float32 size*1e9/bw
    path only carries 24 mantissa bits), so the result is bit-equal to
    the round loop's incremental visibilities for every *sent* message
    (unsent messages form a per-channel suffix; their rows are garbage
    and masked by the caller).  Returns None when there are no
    messages."""
    msgs = comp.msgs
    m = len(msgs)
    if m == 0:
        return None
    tape = comp.tape
    c = max(comp.n_channels, 1)
    ser1 = tape["msg_ser1"]
    lat1_t = np.zeros(c, np.int32)
    lat2_t = np.zeros(c, np.int32)
    lat1_m = tape["msg_lat1"]
    lat2_m = tape["msg_lat2"]
    ch1 = tape["msg_ch1"]
    ch2 = tape["msg_ch2"]
    lat1_t[ch1] = lat1_m
    two = tape["msg_two_stage"]
    lat2_t[ch2[two]] = lat2_m[two]
    extra = np.sum(
        np.where(sent_vt[:m, None] >= tape["msg_extra_from"],
                 tape["msg_extra"], 0),
        axis=1).astype(np.int64) if tape["msg_extra"].size \
        else np.zeros(m, np.int64)
    bw = torch.ones(c, dtype=torch.float32, device=device)  # ser_ns bypass
    fan = hub_route if kernel else ej.hub_visibility

    def fanout(send, ser, link_id, lat_t):
        send, ser, link_id, lat_t = (
            torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)
            for x in (send, ser, link_id, lat_t))
        out = fan(send, ser, link_id, bw, lat_t, ser_ns=ser)
        return out.cpu().numpy().astype(np.int64)

    # stage 1: all messages, per-channel program order (= array order
    # per channel; lexsort keeps it within each channel)
    o1 = np.lexsort((np.arange(m), ch1))
    end1 = np.empty(m, np.int64)
    end1[o1] = fanout(sent_vt[:m][o1], ser1[o1], ch1[o1], lat1_t) \
        - lat1_t[ch1[o1]]
    vis = end1 + lat1_m + extra
    # stage 2: cross-host messages only, keyed by their dest channel
    xi = np.flatnonzero(two)
    if xi.size:
        o2 = xi[np.argsort(ch2[xi], kind="stable")]
        vis2 = fanout(vis[o2], tape["msg_ser2"][o2], ch2[o2], lat2_t)
        out = vis.copy()
        out[o2] = vis2
        vis = out
    return vis


# ---------------------------------------------------------------------------
# run + decompile
# ---------------------------------------------------------------------------


def _resolve_pallas(pallas: str, device) -> Tuple[torch.device, bool]:
    """(device, whether to launch the kernels).  The keyword keeps the
    JAX package's name: "auto" = kernels on a CUDA device, plain
    versions on the CPU; "on" = kernels (a CUDA device is required);
    "off" = the plain versions, on the caller's explicit request."""
    if pallas not in ("auto", "on", "off", "interpret"):
        raise ValueError(f"pallas must be auto/on/off/interpret, "
                         f"got {pallas!r}")
    if pallas == "interpret":
        raise ValueError(
            "pallas='interpret': PyTorch has no interpreter for a CUDA "
            "kernel; use pallas='off' for the plain versions")
    dev = ej.resolve_device(device)
    if pallas == "on" and dev.type != "cuda":
        raise ValueError(f"pallas='on' needs a CUDA device, got {dev}")
    return dev, pallas == "on" or (pallas == "auto" and dev.type == "cuda")


def _decompile(sim, comp: CompiledSim, st, wall: float, *,
               device: torch.device, kernel: bool,
               verify: bool) -> SimReport:
    tick = comp.tick_ns
    vtime = st.vtime.cpu().numpy().astype(np.int64)
    pc = st.pc.cpu().numpy()
    done = st.done.cpu().numpy()
    sent = st.sent.cpu().numpy()[:len(comp.msgs)]
    sent_vt = st.sent_vt.cpu().numpy().astype(np.int64)
    vis_loop = st.vis.cpu().numpy().astype(np.int64)[:len(comp.msgs)]
    rounds = int(st.rounds)

    bvis = _batched_visibility(comp, sent, sent_vt, device=device,
                               kernel=kernel)
    if bvis is not None:
        vis = np.where(sent, bvis, vis_loop)
        if verify and sent.any() and \
                not np.array_equal(vis[sent], vis_loop[sent]):
            raise RuntimeError(
                "vectorized engine: batched hub fan-out disagrees "
                "with the round loop's visibilities")
    else:
        vis = vis_loop

    status, detail = "ok", ""
    if not done.all():
        blocked = [comp.task_names[i] for i in np.flatnonzero(~done)]
        status = "deadlock"
        detail = (f"vectorized fixpoint: no task eligible; blocked: "
                  f"{blocked}")

    tasks = {}
    for i in range(comp.n_programs):
        tasks[comp.task_names[i]] = {
            "vtime": int(vtime[i]) * tick,
            "state": "done" if done[i] else "blocked",
            "host": comp.task_hosts[i]}

    progress: Dict[str, Any] = {}
    arrays = [{k: np.zeros_like(v) for k, v in wl.progress().items()}
              for wl in sim.workloads]
    for i in range(comp.n_programs):
        for op_idx, wi, arr, index, value in comp.markers[i]:
            if pc[i] >= op_idx:
                arrays[wi][arr][index] = value
    for wl, arrs in zip(sim.workloads, arrays):
        progress[wl.name] = _jsonable(arrs)

    msgs_total = int(sent.sum())
    bytes_total = sum(m.size for m, s in zip(comp.msgs, sent) if s)
    links: Dict[str, Dict[str, Any]] = {}
    cross = 0
    for i, m in enumerate(comp.msgs):
        if not sent[i] or not m.two_stage:
            continue
        cross += 1
        key = (f"{comp.hub_base}{m.src_host}->"
               f"{comp.hub_base}{m.dst_host}")
        st_ = links.setdefault(key, {"messages": 0, "bytes": 0,
                                     "min_slack_ns": None,
                                     "max_visibility_ns": 0})
        st_["messages"] += 1
        st_["bytes"] += m.size
        slack = int(vis[i]) * tick - int(sent_vt[i]) * tick - m.lat1
        st_["min_slack_ns"] = (slack if st_["min_slack_ns"] is None
                               else min(st_["min_slack_ns"], slack))
        st_["max_visibility_ns"] = max(st_["max_visibility_ns"],
                                       int(vis[i]) * tick)

    host_disp = [0] * comp.n_hosts
    for i in range(comp.n_tasks):
        host_disp[comp.task_hosts[i]] += int(pc[i])
    hosts = [HostReport(host=h, dispatches=host_disp[h], rounds=rounds,
                        skew_stalls=0, max_skew_seen=0,
                        gate_deferrals=0, window_runs=0, preemptions=0,
                        live_calls=0)
             for h in range(comp.n_hosts)]

    horizon = int(vtime.max(initial=0)) * tick
    return SimReport(
        status=status, mode="vectorized", n_hosts=comp.n_hosts,
        vtime_ns=horizon, wall_s=wall, messages=msgs_total,
        bytes=bytes_total, sync_rounds=rounds, proxy_syncs=0,
        cross_host_msgs=cross, max_proxy_staleness_ns=0,
        max_window_ns=0, hosts=hosts, links=links, tasks=tasks,
        progress=progress, scenario=comp.scenario_name, detail=detail,
        cells={}, tick_ns=tick, tier=comp.tier)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_vectorized_sim(sim, *, tick_ns: Optional[int] = None,
                       pallas: str = "auto",
                       max_rounds: Optional[int] = None,
                       verify: bool = False, device=None) -> SimReport:
    """Compile ``sim``, run the round loop on ``device``, decompile the
    resulting tensors to a :class:`SimReport` (``mode="vectorized"``)."""
    dev, kernel = _resolve_pallas(pallas, device)
    t0 = time.perf_counter()
    comp = compile_simulation(sim, tick_ns)
    cap = comp.max_rounds if max_rounds is None else max_rounds
    tape = ej.tape_from_numpy(comp.tape, dev)
    st0 = ej.init_vec_sim_state(tape, comp.n_channels)
    st = ej.run_vec_tape(tape, st0, cap, kernel=kernel)
    _sync(dev)
    wall = time.perf_counter() - t0
    if bool(st.progressed) and not bool(st.done.all()):
        raise RuntimeError(
            f"vectorized engine: max_rounds={cap} exhausted before "
            f"the fixpoint")
    return _decompile(sim, comp, st, wall, device=dev, kernel=kernel,
                      verify=verify)


# ---------------------------------------------------------------------------
# batched configuration sweep (a leading variant axis over scenarios)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SweepResult:
    """One batched round loop over V scenario variants."""
    reports: List[SimReport]
    wall_s: float
    configs_per_s: float
    tick_ns: int
    tier: str


def sweep_vectorized(sim, axis: List[Scenario], *,
                     tick_ns: Optional[int] = None,
                     max_rounds: Optional[int] = None,
                     device=None) -> SweepResult:
    """Run one vectorized simulation per :class:`Scenario` in ``axis``
    as a single batch (stacked tapes along a leading variant axis, one
    round loop, the ``minskew`` kernel on a CUDA device).  Variants must
    share scenario *structure* (same tapes, messages, channels —
    injections may change durations, fail points, degrade extras); a
    shared tick (gcd across variants) keeps every admissible variant on
    the exact tier.  Each returned report is bit-identical to running
    its variant alone (asserted in tests)."""
    if not axis:
        raise ValueError("sweep needs at least one Scenario")
    dev, kernel = _resolve_pallas("auto", device)
    from repro_torch.sim.simulation import Simulation
    variants = [
        Simulation(sim.topology, sim.workloads, sc,
                   placement=sim.placement_spec, mode=sim.mode,
                   capacity=sim.capacity, cpu_resource=sim.cpu_resource,
                   cells=sim.cells_mode)
        for sc in axis]
    lows = [_lower(v) for v in variants]
    if tick_ns is None:
        pos = [q for low in lows for q in _quantities(low) if q > 0]
        tick_ns = math.gcd(*pos) if pos else 1
    comps = [_quantize(low, tick_ns) for low in lows]
    base = comps[0]
    shapes = [{k: np.shape(x) for k, x in c.tape.items()} for c in comps]
    if any(sh != shapes[0] for sh in shapes[1:]):
        raise UnsupportedByEngine(
            "sweep variants must share scenario structure (same "
            "tapes/messages/channels); only injection values may vary")
    tapes = ej.tape_from_numpy(
        {k: np.stack([c.tape[k] for c in comps]) for k in base.tape}, dev)
    states = ej.init_vec_sim_state(tapes, base.n_channels)
    cap = (max(c.max_rounds for c in comps)
           if max_rounds is None else max_rounds)
    t0 = time.perf_counter()
    out = ej.run_vec_tape_batch(tapes, states, cap, kernel=kernel)
    _sync(dev)
    wall = time.perf_counter() - t0
    reports = []
    for v, comp in enumerate(comps):
        st_v = ej.VecSimState(**{f: getattr(out, f)[v]
                                 for f in ej.STATE_FIELDS})
        if bool(st_v.progressed) and not bool(st_v.done.all()):
            raise RuntimeError(
                f"vectorized sweep variant {v}: max_rounds={cap} "
                f"exhausted before the fixpoint")
        reports.append(_decompile(variants[v], comp, st_v,
                                  wall / len(comps), device=dev,
                                  kernel=kernel, verify=False))
    return SweepResult(reports=reports, wall_s=wall,
                       configs_per_s=len(comps) / wall if wall > 0
                       else float("inf"),
                       tick_ns=tick_ns, tier=base.tier)
