"""The vtask abstraction (paper §3.2).

A vtask is any unit of execution the simulation coordinates — live (real
code running at native speed under measured/cost-derived vtime) or modeled
(a performance model reporting simulated latency).

Execution model: a vtask body is a Python generator that yields *actions*
to the scheduler.  This is the in-process realization of "user-space
thread whose execution must be coordinated": the yield points are the
dispatch boundaries (KVM exits / preemption points in the paper).

Actions:
  Compute(ns)            — modeled advance of simulated time.
  LiveCall(fn, args)     — execute fn natively NOW; vtime advances by the
                           measured host span x clock calibration
                           (clock-derived vtime), or by an explicit
                           cost-model duration when provided.
  Send(endpoint, ...)    — enqueue a message through the endpoint's hub.
  Recv(endpoint)         — block until a message is *visible* (vtime
                           ordering enforced by the scheduler+hub).
  Await(event)           — block on an event object.
  Yield()                — cooperative reschedule point.
  Done(value)            — finish (also raised by StopIteration).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Iterator, Optional, Tuple

from repro_torch.core.vtime import LiveClock, RunPage


class State(enum.Enum):
    RUNNABLE = "runnable"
    BLOCKED = "blocked"
    DONE = "done"
    FAULTY = "faulty"       # preempted for failing to report progress


# --------------------------- actions ---------------------------------------


@dataclasses.dataclass
class Compute:
    ns: int
    label: str = ""


@dataclasses.dataclass
class LiveCall:
    fn: Callable
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    cost_ns: Optional[int] = None    # cost-derived override (else measured)
    label: str = ""


@dataclasses.dataclass
class Send:
    endpoint: Any                    # repro_torch.core.ipc.Endpoint
    dst: str                         # destination endpoint name
    size_bytes: int
    payload: Any = None


@dataclasses.dataclass
class Recv:
    endpoint: Any
    timeout_ns: Optional[int] = None


@dataclasses.dataclass
class Await:
    event: "Event"


@dataclasses.dataclass
class Yield:
    pass


class Event:
    """Level-triggered event with a vtime stamp (for Await)."""

    def __init__(self) -> None:
        self.set_at_vtime: Optional[int] = None
        self.waiters: list = []

    def fire(self, vtime: int) -> None:
        self.set_at_vtime = vtime
        # index the fire time for blocked waiters so the scheduler's
        # wake pass finds them without scanning (visibility/event index)
        for t in self.waiters:
            r = t._wait_reason
            if (r is not None and r[0] == "event" and r[1] is self
                    and t.sched is not None):
                t.sched._wait_push(t, vtime)
        self.waiters.clear()


# --------------------------- vtask ------------------------------------------


class VTask:
    _next_id = 0

    def __init__(self, name: str, body: Optional[Iterator] = None, *,
                 kind: str = "live", clock: Optional[LiveClock] = None,
                 host: int = 0, cell: Optional[str] = None):
        assert kind in ("live", "modeled", "proxy")
        self.id = VTask._next_id
        VTask._next_id += 1
        self.name = name
        self.kind = kind
        self.body = body
        self.state = State.RUNNABLE if body is not None else State.BLOCKED
        self.vtime = 0
        self.scopes: list = []
        self.host = host
        self.cell = cell
        self.clock = clock or LiveClock()
        self.run_page = RunPage()
        self.result: Any = None
        self.inbox_hint: Optional[int] = None     # head-of-queue visibility
        self.zero_progress = 0                    # preemption counter
        self.stats = {"dispatches": 0, "live_ns": 0, "msgs_rx": 0,
                      "msgs_tx": 0, "blocked_rounds": 0,
                      "cell_switches": 0}
        self._wait_reason: Optional[Tuple[str, Any]] = None
        self._pending_action: Any = None   # blocked action awaiting retry
        # scheduler back-reference + index bookkeeping (set by spawn;
        # see repro_torch.core.scheduler's runnable + visibility indexes)
        self.sched: Any = None
        self._runq_on = False              # a live runnable-heap entry exists
        self._runq_v = -1                  # vtime of that entry
        self._wait_on = False              # a live wake-index entry exists
        self._wait_v: Optional[int] = None  # its wake time

    # -- scope membership --
    def join(self, scope) -> "VTask":
        if scope not in self.scopes:
            self.scopes.append(scope)
            scope.add(self)
        return self

    def runnable(self) -> bool:
        return self.state == State.RUNNABLE

    def __repr__(self) -> str:
        return (f"VTask({self.name}#{self.id} {self.kind} {self.state.value}"
                f" v={self.vtime})")
