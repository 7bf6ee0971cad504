"""Pure discrete-event simulation baseline (the gem5/ns-3 stand-in).

LiveStack's Table 2 compares against a gem5-based modular setup that "did
not finish within a week".  To reproduce that comparison honestly on one
host, this module provides a classic event-queue engine that models
the SAME workloads at fine event granularity (one event per ``grain_ns``
of simulated compute, the way a cycle-ish functional+timing simulator
processes work), so the benchmark can measure events/second and report
measured or extrapolated wall time for the full workload.

The engine is deliberately a fair, optimized-Python DES (heapq, tuple
events, no allocation in the hot loop) — the slowdown vs. LiveStack comes
from the *method* (fine-grained event processing), not an artificially
slow implementation.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import Callable, List, Optional, Tuple


class DESEngine:
    def __init__(self) -> None:
        self._heap: List[Tuple[int, int, Callable]] = []
        self._seq = itertools.count()
        self.now = 0
        self.events_processed = 0

    def schedule(self, t_ns: int, fn: Callable) -> None:
        heapq.heappush(self._heap, (t_ns, next(self._seq), fn))

    def run(self, until_ns: Optional[int] = None,
            max_events: Optional[int] = None,
            wall_budget_s: Optional[float] = None) -> dict:
        """Returns run stats; stops early on any budget."""
        t_start = time.perf_counter()
        n0 = self.events_processed
        while self._heap:
            if until_ns is not None and self._heap[0][0] > until_ns:
                break
            if max_events is not None and \
                    self.events_processed - n0 >= max_events:
                break
            if wall_budget_s is not None and \
                    (self.events_processed & 0xFFF) == 0 and \
                    time.perf_counter() - t_start > wall_budget_s:
                break
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            self.events_processed += 1
            fn()
        wall = time.perf_counter() - t_start
        done = self.events_processed - n0
        return {
            "events": done,
            "wall_s": wall,
            "events_per_s": done / wall if wall > 0 else float("inf"),
            "sim_ns": self.now,
            "exhausted": not self._heap,
        }


def fine_grained_compute(engine: DESEngine, start_ns: int, duration_ns: int,
                         grain_ns: int, on_done: Callable,
                         work_fn: Optional[Callable] = None) -> int:
    """Model a compute span as duration/grain events (the DES way).

    ``work_fn``, if given, is executed once at the final event (functional
    result); the *timing* is carried by the event cascade.  Returns the
    number of events scheduled (lazily, one at a time — constant memory).
    """
    n_events = max(1, duration_ns // grain_ns)

    def step(i: int):
        def fire():
            if i + 1 < n_events:
                engine.schedule(start_ns + (i + 1) * grain_ns, step(i + 1))
            else:
                if work_fn is not None:
                    work_fn()
                on_done()
        return fire

    engine.schedule(start_ns + grain_ns, step(0))
    return n_events


def extrapolate_wall_s(measured: dict, total_events: int) -> float:
    """Extrapolated wall time for a full workload from a measured slice."""
    eps = measured["events_per_s"]
    return total_events / max(eps, 1e-9)
