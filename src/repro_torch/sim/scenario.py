"""Declarative fault/interference injection.

A :class:`Scenario` is a named tuple of :class:`Injection`\\ s applied at
build time by :class:`~repro_torch.sim.simulation.Simulation` — workload
bodies are never edited.  Mechanisms:

* :class:`Straggler` / :class:`FailTask` / :class:`FailHost` wrap the
  target program's generator: compute actions are scaled, or the body is
  closed at a given compute index / virtual time (the vtask finishes
  early, exactly like the legacy ``fail_at`` chip death — downstream
  effects, including a wedged cluster, propagate through the engines
  and surface as ``SimReport.status == "deadlock"``).
* :class:`DegradeLink` installs a hub hook (the eBPF analogue) on the
  sending side that adds latency to matching messages from a given
  virtual time on.  Hooks may only *add* latency, so conservative
  cross-host lookahead is preserved by construction.
* :class:`Interference` spawns a co-located load program; with
  ``Simulation(cpu_resource=True)`` its compute queues for the same
  simulated CPUs as the victim's, coupling their timing in virtual
  time.
* :class:`BitFlip` wraps the target program's generator like the
  failure wrappers, but instead of killing the body it corrupts *data*:
  at the chosen data-bearing action (``Send`` / ``LiveCall``) one bit
  of the payload (or of the live-call result) is flipped — silent data
  corruption that downstream consumers and ``LiveCall`` replay observe,
  while timing machinery is untouched.
* :class:`ClockSkew` installs an *ingress* hub hook on the hub owning
  the destination endpoint: every message delivered to an endpoint on
  the skewed host arrives ``offset_ns + drift`` later (the receiver's
  skewed clock timestamps arrivals late).  Offsets and drift are
  validated non-negative at build time, so — like
  :class:`DegradeLink` — the hook only ever *adds* latency and
  conservative cross-host lookahead stays sound.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, Optional, Tuple

from repro_torch.core.vtask import Compute, LiveCall, Send


class Injection:
    """Marker base class for scenario injections."""


@dataclasses.dataclass(frozen=True)
class Straggler(Injection):
    """Scale the target program's modeled compute (and cost-derived live
    calls) by ``slowdown``.  Measured (cost-less) live calls are
    unaffected — their duration comes from the host clock.  Multiple
    stragglers on the same task compound multiplicatively."""
    task: str
    slowdown: float = 2.0


@dataclasses.dataclass(frozen=True)
class FailTask(Injection):
    """Kill one program: before its ``at_compute``-th compute action
    (0-based — the legacy ``fail_at=(chip, step)`` semantics for bodies
    with one compute per step), or at the first dispatch boundary once
    its vtime reaches ``at_vtime``."""
    task: str
    at_compute: Optional[int] = None
    at_vtime: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class FailHost(Injection):
    """Kill every program placed on ``host`` once their vtime reaches
    ``at_vtime`` (a machine dying mid-run).

    Membership semantics: this is ordinary churn — the facade records a
    ``leave`` event on the cluster's membership timeline
    (``SimReport.control["membership"]``) and kills the host's tasks
    through the standard fault wrappers.  A leave needs no lookahead
    rebuild (a dead host goes quiescent, and quiescent hosts already
    stop gating peers), so results and sync-round schedules are
    byte-identical to the pre-membership special case."""
    host: int
    at_vtime: int


@dataclasses.dataclass(frozen=True)
class JoinHost(Injection):
    """Scenario-driven membership churn: ``host`` joins the cluster at
    ``at_vtime`` (>= 1), exactly like a ``Topology.join`` declaration —
    programs placed on it spawn with initial vtime ``at_vtime`` and the
    conservative engines admit it at the membership-epoch flip.  The
    host id must be within the topology's ``n_hosts`` and must not
    already be a founding member with tasks that start at vtime 0 or
    carry a conflicting join declaration.  Not admissible on the
    vectorized engine (raises ``UnsupportedByEngine`` at build)."""
    host: int
    at_vtime: int


@dataclasses.dataclass(frozen=True)
class DegradeLink(Injection):
    """Add latency to messages on a fabric or between a host pair.

    ``latency_factor`` multiplies the base link latency (1.0 = none),
    ``extra_ns`` adds a flat term, and only messages sent at
    ``from_vtime`` or later are affected (mid-run degradation)."""
    fabric: Optional[str] = None
    hosts: Optional[Tuple[int, int]] = None
    latency_factor: float = 1.0
    extra_ns: int = 0
    from_vtime: int = 0


@dataclasses.dataclass(frozen=True)
class Interference(Injection):
    """Co-located load: ``bursts`` x ``burst_ns`` of modeled compute on
    ``host`` (or wherever ``co_locate_with`` was placed).  Two
    contention axes, composable: ``Simulation(cpu_resource=True)``
    queues the load's compute on the victim host's simulated CPUs, and
    ``cell`` binds the load to a declared memory-hierarchy cell
    (``Topology.cell``) so its bandwidth demand spatially interferes
    with co-located live cells — no cpu_resource needed for that axis
    (``Simulation(cells="auto")`` derives the cell instead)."""
    host: Optional[int] = None
    co_locate_with: Optional[str] = None
    bursts: int = 100
    burst_ns: int = 5_000
    cell: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class BitFlip(Injection):
    """Silent data corruption in the target program's data path.

    Exactly one trigger: the ``at_step``-th data-bearing action
    (0-based over the body's ``Send``/``LiveCall`` stream), or the
    first data-bearing action once the task's vtime reaches
    ``at_vtime`` (mirroring :class:`FailTask`'s two triggers).  At the
    trigger, ``bit`` is flipped in the ``Send`` payload before it
    enters the hub (downstream consumers receive the corrupted value)
    or in the ``LiveCall`` result before the body observes it (replay
    of recorded live calls sees the corruption).  Payloads with no
    flippable scalar (``None``) pass through unchanged — the injection
    is then masked, which is itself a valid campaign outcome."""
    task: str
    at_step: Optional[int] = None
    at_vtime: Optional[int] = None
    bit: int = 0


@dataclasses.dataclass(frozen=True)
class ClockSkew(Injection):
    """Per-host receive-clock skew: every message delivered to an
    endpoint placed on ``host`` becomes visible
    ``offset_ns + drift_ppm * send_vtime / 1e6`` ns later (integer
    floor).  Both terms must be non-negative — validated at build time
    — so the ingress hook only adds latency and the per-link
    conservative lookahead bound survives.  Multiple skews on one host
    sum."""
    host: int
    offset_ns: int = 0
    drift_ppm: int = 0


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str = "baseline"
    injections: Tuple[Injection, ...] = ()


# -- body wrappers (build-time machinery, used by Simulation) ----------------


class TaskHandle:
    """Late-bound reference to the wrapped program's VTask (the VTask is
    created *around* the wrapped generator, so wrappers that need its
    vtime get it via this mutable cell)."""
    __slots__ = ("task",)

    def __init__(self):
        self.task = None


def scaled_body(body: Iterator, factor: float) -> Iterator:
    """Forward the action stream, scaling Compute ns and cost-derived
    LiveCall cost_ns by ``factor``."""
    result = None
    while True:
        try:
            action = body.send(result)
        except StopIteration:
            return
        if isinstance(action, Compute):
            action = dataclasses.replace(action, ns=int(action.ns * factor))
        elif isinstance(action, LiveCall) and action.cost_ns is not None:
            # clamp: a straggler factor must never scale a live cost to
            # 0 — the scheduler rejects non-positive live costs
            action = dataclasses.replace(
                action, cost_ns=max(1, int(action.cost_ns * factor)))
        result = yield action


def fail_gated_body(body: Iterator, handle: TaskHandle,
                    at_compute: Optional[int],
                    at_vtime: Optional[int]) -> Iterator:
    """Forward the action stream until the failure point, then return
    (the vtask completes early — it died)."""
    computes = 0
    result = None
    while True:
        try:
            action = body.send(result)
        except StopIteration:
            return
        if (at_vtime is not None and handle.task is not None
                and handle.task.vtime >= at_vtime):
            return
        if at_compute is not None and isinstance(action,
                                                 (Compute, LiveCall)):
            if computes >= at_compute:
                return
            computes += 1
        result = yield action


def flip_bit(value, bit: int):
    """Flip one bit of a scalar payload; containers flip their first
    flippable element; unflippable values pass through unchanged (a
    masked fault, not an error — determinism is what matters)."""
    if isinstance(value, bool):
        return (not value) if bit == 0 else value
    if isinstance(value, int):
        return value ^ (1 << bit)
    if isinstance(value, float):
        (bits,) = struct.unpack("<Q", struct.pack("<d", value))
        return struct.unpack("<d", struct.pack("<Q",
                                               bits ^ (1 << (bit % 64))))[0]
    if isinstance(value, str) and value:
        return chr(ord(value[0]) ^ (1 << (bit % 16))) + value[1:]
    if isinstance(value, (tuple, list)):
        for i, v in enumerate(value):
            flipped = flip_bit(v, bit)
            if flipped is not v and flipped != v:
                out = list(value)
                out[i] = flipped
                return type(value)(out) if isinstance(value, tuple) \
                    else out
        return value
    return value


def bitflip_body(body: Iterator, handle: TaskHandle,
                 at_step: Optional[int], at_vtime: Optional[int],
                 bit: int) -> Iterator:
    """Forward the action stream; at the trigger (the ``at_step``-th
    data-bearing action, or the first one at/after ``at_vtime``) flip
    one payload bit: Send payloads are corrupted *before* the hub sees
    them, LiveCall results are corrupted before the body observes them.
    Exactly one flip per injection."""
    steps = 0
    result = None
    flipped = False
    while True:
        try:
            action = body.send(result)
        except StopIteration:
            return
        fire = False
        if not flipped and isinstance(action, (Send, LiveCall)):
            if at_step is not None:
                fire = steps == at_step
            else:
                fire = (handle.task is not None
                        and handle.task.vtime >= at_vtime)
            steps += 1
        if fire and isinstance(action, Send):
            flipped = True
            action = dataclasses.replace(
                action, payload=flip_bit(action.payload, bit))
            result = yield action
        elif fire:
            flipped = True
            result = yield action
            result = flip_bit(result, bit)
        else:
            result = yield action
