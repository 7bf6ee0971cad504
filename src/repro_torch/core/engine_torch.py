"""Vectorized fast-path engine on torch tensors (port of
``repro.core.engine_jax``).

The reference scheduler dispatches Python generators — exact
semantics, O(n) Python per round.  This engine advances ALL vtasks in
lockstep rounds as tensor ops on one device:

  state:      vtime (N,) int32 ticks, runnable / done (N,) bool,
              scope membership (N, S) bool
  per round:  scope minima -> bounded-skew eligibility (the ``minskew``
              CUDA kernel on the card, its plain version otherwise)
              -> advance eligible vtasks -> message visibility

Two differences from the JAX engine, neither visible in results:

* ``vmap`` becomes an explicit leading variant axis: the round is
  written once over (V, ...) tensors and single runs use V = 1, so
  batched sweeps go through the same kernel as single runs.
* ``lax.while_loop`` becomes a host loop that reads the stop condition
  back every ``CHECK_EVERY`` rounds.  Each round is guarded on the
  device per variant (``any(~done) & progressed & rounds < max_rounds``
  for tapes), so rounds past the fixpoint change nothing, ``rounds``
  included.

Every state and tape tensor is int32 (bool where JAX uses bool); index
tensors are cast to int64 only where torch indexes with them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.hub_route import serialization
from repro_torch.kernels.minskew import minskew as minskew_kernel

INF = 2**30
INF_TICKS = 2**30               # python-int mirror of INF
TICK_NS = 100  # cluster sims use 0.1us ticks: int32 range = ~214 simulated s
#: rounds between host reads of the loop condition.  Each read waits for
#: the card; each round run past the fixpoint is a guarded no-op that
#: still costs its launches.  On an H100, on the 20-round main path, 4
#: beat 16 by a third or more and 1 by 6-15%; on a ~410-round sweep it
#: came within 6% of 16 (``chip_smoke.py``'s check_interval phase).
CHECK_EVERY = 4

hub_visibility_ref = kref.hub_visibility_ref


class TickRangeError(ValueError):
    """Simulated times would overflow the engine's int32 tick range
    (``INF = 2**30`` ticks).  Raised at build time — before any round
    runs — so an over-long horizon is an explicit error instead of a
    silent int32 wraparound mid-simulation.  Fix: fewer steps / shorter
    durations, or a coarser tick (``TICK_NS`` for the synthetic engine,
    ``tick_ns=`` for the facade compiler)."""


def resolve_device(device=None,
                   what: str = "the vectorized engine") -> torch.device:
    """``None`` means ``"cuda"``; without CUDA that raises — a run never
    lands on the CPU unless the caller asked for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device: {what} runs on the card unless the "
                f"caller asks for the CPU (device='cpu')")
        return torch.device("cuda")
    return torch.device(device)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.int32), device=device)


def _bool(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, bool), device=device)


def _drive(step: Callable[[], None],
           live: Callable[[], torch.Tensor]) -> None:
    """Host loop: ``CHECK_EVERY`` guarded rounds per read of ``live``."""
    while bool(live()):
        for _ in range(CHECK_EVERY):
            step()


def _bcast(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.view(mask.shape + (1,) * (x.dim() - mask.dim()))


# ---------------------------------------------------------------------------
# synthetic compute-only engine (benchmarks, property tests)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VecState:
    """Array-of-structs state for N vtasks / S scopes."""
    vtime: torch.Tensor         # (N,) int32 ticks
    runnable: torch.Tensor      # (N,) bool
    membership: torch.Tensor    # (N, S) bool
    skew: torch.Tensor          # (S,) int32
    duration: torch.Tensor      # (N,) int32 — per-dispatch vtime advance
    steps_left: torch.Tensor    # (N,) int32 — dispatches until done

    @staticmethod
    def create(n: int, scopes: int, durations, steps, membership, skews,
               device=None):
        dev = resolve_device(device)
        durations = np.asarray(durations, np.int64).reshape(n)
        steps = np.asarray(steps, np.int64).reshape(n)
        if (durations < 0).any() or (steps < 0).any():
            raise ValueError("durations and steps must be >= 0")
        # per-task final vtime = duration * steps, exactly (vtime only
        # advances by own durations); validate it fits the tick range
        # instead of wrapping int32 mid-run
        total = durations * steps
        if total.size and int(total.max()) >= INF_TICKS:
            worst = int(np.argmax(total))
            raise TickRangeError(
                f"vtask {worst}: duration {int(durations[worst])} x "
                f"steps {int(steps[worst])} = {int(total[worst])} ticks "
                f">= 2**30 — exceeds the int32 tick range; use a "
                f"coarser tick (TICK_NS) or fewer steps")
        return VecState(
            vtime=torch.zeros((n,), dtype=torch.int32, device=dev),
            runnable=_bool(steps > 0, dev),
            membership=_bool(membership, dev).reshape(n, scopes),
            skew=_i32(skews, dev).reshape(scopes),
            duration=_i32(durations, dev),
            steps_left=_i32(steps, dev),
        )


def scope_minima(vtime: torch.Tensor, runnable: torch.Tensor,
                 membership: torch.Tensor) -> torch.Tensor:
    """(S,) min vtime over runnable members (INF when none) — the cached
    scope vtime of the paper, recomputed batch-style."""
    return kref.scope_minima_plain(vtime[None], runnable[None],
                                   membership[None])[0]


def eligibility(vtime: torch.Tensor, runnable: torch.Tensor,
                membership: torch.Tensor, skew: torch.Tensor,
                minima: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bounded-skew dispatch mask: eligible iff for EVERY scope the vtask
    belongs to, vtime <= scope_min + skew."""
    if minima is None:
        minima = scope_minima(vtime, runnable, membership)
    return kref.eligibility_plain(vtime[None], runnable[None],
                                  membership[None], skew[None],
                                  minima[None])[0]


def _run_synthetic(vtime, runnable, member8, skew, duration, steps,
                   max_rounds: int):
    """Compute-only rounds over (V, ...) tensors until no vtask is
    runnable; eligibility through ``minskew`` (kernel on CUDA tensors,
    plain version on CPU tensors)."""
    rounds = torch.zeros(vtime.shape[0], dtype=torch.int32,
                         device=vtime.device)
    st = [vtime, runnable, steps, rounds]

    def live_v():
        return st[1].any(dim=1) & (st[3] < max_rounds)

    def step():
        vt, run, stp, rnd = st
        lv = live_v()
        _, elig8 = minskew_kernel(vt, run.to(torch.int8), member8, skew)
        elig = (elig8 != 0) & lv[:, None]
        vt = torch.where(elig, vt + duration, vt)
        stp = torch.where(elig, stp - 1, stp)
        st[:] = [vt, run & (stp > 0), stp, rnd + lv.to(torch.int32)]

    _drive(step, lambda: live_v().any())
    return st


def run_vectorized(state: VecState, max_rounds: int = 1_000_000
                   ) -> Tuple[VecState, int]:
    """Run rounds until no vtask is runnable; returns (state, rounds)."""
    vt, run, stp, rounds = _run_synthetic(
        state.vtime[None], state.runnable[None],
        state.membership.to(torch.int8)[None], state.skew[None],
        state.duration[None], state.steps_left[None], max_rounds)
    return (dataclasses.replace(state, vtime=vt[0], runnable=run[0],
                                steps_left=stp[0]), int(rounds[0]))


def run_vectorized_sweep(state: VecState, duration_axis,
                         max_rounds: int = 1_000_000):
    """Batched configuration sweep over a (V, N) axis of per-task
    durations (V variants sharing everything else).  Returns (final
    vtimes (V, N), rounds (V,)) — V simulations in one round loop."""
    dur = _i32(duration_axis, state.vtime.device)
    v = dur.shape[0]
    member8 = state.membership.to(torch.int8)
    vt, _, _, rounds = _run_synthetic(
        state.vtime.expand(v, -1).contiguous(),
        state.runnable.expand(v, -1).contiguous(),
        member8.expand(v, -1, -1).contiguous(),
        state.skew.expand(v, -1).contiguous(), dur,
        state.steps_left.expand(v, -1).contiguous(), max_rounds)
    return vt, rounds


# ---------------------------------------------------------------------------
# Facade tape interpreter (`Simulation.run(engine="vectorized")`)
# ---------------------------------------------------------------------------
#
# The facade compiler (``repro_torch.sim.vectorized``) lowers a scenario
# to a static per-task *op tape* plus per-message routing tables; this
# module owns the round loop that interprets the tapes.  Per round, for
# every non-done task: fail gates fire, the current op's readiness and
# bounded-skew eligibility are evaluated, and eligible tasks execute
# exactly one op.  On the scenario surface the compiler admits, results
# are schedule-independent, so this loop is bit-identical to the
# reference engines.

OP_END, OP_COMPUTE, OP_SEND, OP_RECV = 0, 1, 2, 3


@dataclasses.dataclass
class VecTape:
    """Static (per-compile) tensors: tapes, scopes, message routing.
    Batched runs stack every field along a leading variant axis."""
    op_kind: torch.Tensor        # (N, P) int32: OP_*
    op_arg: torch.Tensor         # (N, P) int32: ticks | message id
    n_ops: torch.Tensor          # (N,) int32
    fail_pc: torch.Tensor        # (N,) int32 (INF = never)
    fail_vtime: torch.Tensor     # (N,) int32 ticks (INF = never)
    membership: torch.Tensor     # (N, S) bool
    skew: torch.Tensor           # (S,) int32 ticks
    send_overhead: torch.Tensor  # () int32 ticks
    msg_ch1: torch.Tensor        # (M,) int32 — stage-1 channel
    msg_ser1: torch.Tensor       # (M,) int32 ticks
    msg_lat1: torch.Tensor       # (M,) int32 ticks
    msg_two_stage: torch.Tensor  # (M,) bool — cross-host second hop
    msg_ch2: torch.Tensor        # (M,) int32
    msg_ser2: torch.Tensor       # (M,) int32 ticks
    msg_lat2: torch.Tensor       # (M,) int32 ticks
    msg_extra: torch.Tensor      # (M, D) int32 — DegradeLink extras
    msg_extra_from: torch.Tensor  # (M, D) int32 — send_vtime thresholds


@dataclasses.dataclass
class VecSimState:
    """Per-round mutable state.  ``sent``/``vis``/``sent_vt`` carry one
    extra trailing row — the unmatched-recv sentinel (never sent, so a
    receiver matched to it blocks forever, as in the reference)."""
    vtime: torch.Tensor          # (N,) int32 ticks
    pc: torch.Tensor             # (N,) int32
    done: torch.Tensor           # (N,) bool
    sent: torch.Tensor           # (M+1,) bool
    vis: torch.Tensor            # (M+1,) int32 — final visibility
    sent_vt: torch.Tensor        # (M+1,) int32 — send vtime (overhead incl.)
    busy: torch.Tensor           # (C,) int32 — per-channel busy-until
    rounds: torch.Tensor         # () int32
    progressed: torch.Tensor     # () bool — any op executed / kill fired


_BOOL_FIELDS = {"membership", "msg_two_stage", "done", "sent",
                "progressed"}
TAPE_FIELDS = tuple(f.name for f in dataclasses.fields(VecTape))
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(VecSimState))


def _from_numpy(cls, fields, arrays: Dict[str, np.ndarray], device):
    dev = torch.device(device)
    return cls(**{k: (_bool if k in _BOOL_FIELDS else _i32)(arrays[k], dev)
                  for k in fields})


def tape_from_numpy(arrays: Dict[str, np.ndarray], device) -> VecTape:
    """A :class:`VecTape` on ``device`` from numpy arrays keyed by field
    name (e.g. ``np.asarray`` of each field of the JAX engine's tape)."""
    return _from_numpy(VecTape, TAPE_FIELDS, arrays, device)


def state_from_numpy(arrays: Dict[str, np.ndarray], device) -> VecSimState:
    """A :class:`VecSimState` on ``device`` from numpy arrays keyed by
    field name."""
    return _from_numpy(VecSimState, STATE_FIELDS, arrays, device)


def _map(obj, fn):
    return type(obj)(**{f.name: fn(getattr(obj, f.name))
                        for f in dataclasses.fields(obj)})


def init_vec_sim_state(tape: VecTape, n_channels: int) -> VecSimState:
    """Initial state for ``tape``, with the tape's leading variant axes
    (none for a single tape)."""
    lead = tuple(tape.op_kind.shape[:-2])
    n = tape.op_kind.shape[-2]
    m1 = tape.msg_ch1.shape[-1] + 1
    dev = tape.op_kind.device

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    return VecSimState(
        vtime=zeros(n), pc=zeros(n), done=(tape.n_ops == 0),
        sent=zeros(m1, dtype=torch.bool), vis=zeros(m1),
        sent_vt=zeros(m1), busy=zeros(max(n_channels, 1)),
        rounds=zeros(), progressed=torch.ones(lead, dtype=torch.bool,
                                              device=dev))


def _scatter_drop(x: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor) -> torch.Tensor:
    """``x`` (V, K) with ``x[v, idx[v, i]] = val[v, i]``, where index K
    means "drop": it lands in a scratch column that is cut off again
    (torch raises on out-of-range indices where JAX drops them)."""
    ext = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)
    ext.scatter_(1, idx, val)
    return ext[:, :-1]


def vec_sim_round(tape: VecTape, st: VecSimState, *, kernel: bool = False,
                  member8: Optional[torch.Tensor] = None) -> VecSimState:
    """One dispatch round over a leading variant axis (every field of
    ``tape`` and ``st`` is (V, ...)).  Kill gates fire *before*
    execution (matching ``fail_gated_body``: the wrapped generator
    returns when the op at the fail boundary is produced, before it
    runs); blocked receivers are excluded from scope minima (reference:
    blocked vtasks leave the runnable heap); the effective vtime of a
    ready receiver is max(vtime, visibility) in both minima and
    eligibility (reference: ``scope.wake`` forwards vtime before the
    retry dispatch).  ``kernel`` routes eligibility through the
    ``minskew`` wrapper (the CUDA kernel for CUDA tensors)."""
    p = tape.op_kind.shape[2]
    m = tape.msg_ch1.shape[1]
    if member8 is None:
        member8 = tape.membership.to(torch.int8)
    pcc = st.pc.clamp(0, max(p - 1, 0)).long()[:, :, None]
    kind = tape.op_kind.gather(2, pcc)[:, :, 0]
    arg = tape.op_arg.gather(2, pcc)[:, :, 0]

    active = ~st.done
    kill = active & ((st.pc == tape.fail_pc)
                     | (st.vtime >= tape.fail_vtime))
    active = active & ~kill
    done = st.done | kill

    is_recv = active & (kind == OP_RECV)
    marg = torch.where(is_recv, arg, 0).long()
    recv_ready = is_recv & st.sent.gather(1, marg)
    ready = active & (~is_recv | recv_ready)
    vis_m = st.vis.gather(1, marg)
    eff = torch.where(recv_ready, torch.maximum(st.vtime, vis_m), st.vtime)

    if member8.shape[2] == 0:
        elig = ready
    elif kernel:
        _, elig8 = minskew_kernel(eff, ready.to(torch.int8), member8,
                                  tape.skew)
        elig = elig8 != 0
    else:
        _, elig8 = kref.minskew_plain(eff, ready, member8, tape.skew)
        elig = elig8 != 0

    do_comp = elig & (kind == OP_COMPUTE)
    do_send = elig & (kind == OP_SEND)
    do_recv = elig & (kind == OP_RECV)
    sv = st.vtime + tape.send_overhead[:, None]
    vtime = torch.where(do_comp, st.vtime + arg, st.vtime)
    vtime = torch.where(do_recv, torch.maximum(st.vtime, vis_m), vtime)
    vtime = torch.where(do_send, sv, vtime)

    # sends: at most one message per channel per round (single-producer
    # channels, one op per task per round), so plain scatters suffice
    m_idx = torch.where(do_send, arg, m + 1).long()   # m+1: drop
    sent_vt = _scatter_drop(st.sent_vt, m_idx, sv)
    sent = _scatter_drop(st.sent, m_idx, do_send)
    now = sent[:, :m] & ~st.sent[:, :m]               # newly sent
    msv = sent_vt[:, :m]
    start1 = torch.maximum(msv, st.busy.gather(1, tape.msg_ch1.long()))
    end1 = start1 + tape.msg_ser1
    extra = torch.where(msv[:, :, None] >= tape.msg_extra_from,
                        tape.msg_extra, 0).sum(dim=2).to(torch.int32)
    vis1 = end1 + tape.msg_lat1 + extra        # extra is post-busy (hook)
    start2 = torch.maximum(vis1, st.busy.gather(1, tape.msg_ch2.long()))
    end2 = start2 + tape.msg_ser2
    vis2 = end2 + tape.msg_lat2
    vism = torch.where(tape.msg_two_stage, vis2, vis1)
    c = st.busy.shape[1]
    busy = _scatter_drop(st.busy, torch.where(now, tape.msg_ch1, c).long(),
                         end1)
    busy = _scatter_drop(
        busy, torch.where(now & tape.msg_two_stage, tape.msg_ch2, c).long(),
        end2)
    vis = torch.cat([torch.where(now, vism, st.vis[:, :m]),
                     st.vis[:, m:]], dim=1)

    pc = torch.where(elig, st.pc + 1, st.pc)
    done = done | (pc >= tape.n_ops)
    return VecSimState(
        vtime=vtime, pc=pc, done=done, sent=sent, vis=vis,
        sent_vt=sent_vt, busy=busy, rounds=st.rounds + 1,
        progressed=elig.any(dim=1) | kill.any(dim=1))


def _tape_live(st: VecSimState, max_rounds) -> torch.Tensor:
    return (~st.done).any(dim=1) & st.progressed & (st.rounds < max_rounds)


def run_vec_tape_batch(tapes: VecTape, states: VecSimState, max_rounds,
                       *, kernel: bool = False) -> VecSimState:
    """Run every variant (leading axis of each field) to its fixpoint:
    every task done, or no op executed and no kill fired (the remaining
    tasks are blocked — a deadlock), or ``max_rounds``.  A finished
    variant's rounds are no-ops, so each result equals running its tape
    alone.  Membership goes to int8 once per run."""
    member8 = tapes.membership.to(torch.int8)
    cur = [states]

    def step():
        st = cur[0]
        lv = _tape_live(st, max_rounds)
        new = vec_sim_round(tapes, st, kernel=kernel, member8=member8)
        cur[0] = VecSimState(**{
            f: torch.where(_bcast(lv, getattr(new, f)), getattr(new, f),
                           getattr(st, f)) for f in STATE_FIELDS})

    _drive(step, lambda: _tape_live(cur[0], max_rounds).any())
    return cur[0]


def run_vec_tape(tape: VecTape, st: VecSimState, max_rounds, *,
                 kernel: bool = False) -> VecSimState:
    """Run one tape to its fixpoint (V = 1 of
    :func:`run_vec_tape_batch`); the minimal ready task is always
    eligible, so each round progresses and rounds <= total ops + N."""
    out = run_vec_tape_batch(_map(tape, lambda x: x[None]),
                             _map(st, lambda x: x[None]), max_rounds,
                             kernel=kernel)
    return _map(out, lambda x: x[0])


# ---------------------------------------------------------------------------
# Batched IPC visibility (hub fast path)
# ---------------------------------------------------------------------------


def hub_visibility(send_vtime: torch.Tensor, size_bytes: torch.Tensor,
                   link_id: torch.Tensor, link_bw_Bps: torch.Tensor,
                   link_lat_ns: torch.Tensor,
                   ser_ns: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Visibility times for a batch of messages with FIFO link queuing,
    plain PyTorch on any device.

    Messages must be sorted by (link_id, send_vtime).  Per link:
      start_i = max(send_i, end_{i-1}),  end_i = start_i + size/bw,
      visibility_i = end_i + latency,
    a segmented max-plus scan (:func:`repro_torch.kernels.ref.
    hub_route_plain`).  ``ser_ns`` bypasses the float32 serialization
    math with exact precomputed per-message durations."""
    ser = (ser_ns.to(torch.int32) if ser_ns is not None
           else serialization(size_bytes, link_id, link_bw_Bps))
    return kref.hub_route_plain(send_vtime, ser, link_id, link_lat_ns)
