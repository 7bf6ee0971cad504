"""Failure injection + straggler detection for the training runtime.

``FailureInjector`` raises ``SimulatedHostFailure`` at configured steps —
the trainer treats it exactly as a real host loss: abandon in-flight
state, rebuild the mesh (possibly smaller — elastic), restore the last
committed checkpoint, and resume from its step (the data pipeline is
step-indexed, so the stream continues exactly).

``StragglerMonitor`` tracks per-step wall times; steps above
``threshold x rolling median`` are flagged (on real fleets this feeds
backup-task dispatch; here it feeds the LiveStack cluster simulation,
which models the backup-dispatch policy under virtual time).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional, Set


class SimulatedHostFailure(RuntimeError):
    def __init__(self, step: int, host: int = 0):
        super().__init__(f"simulated failure of host {host} at step {step}")
        self.step = step
        self.host = host


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: Set[int] = dataclasses.field(default_factory=set)
    fired: Set[int] = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedHostFailure(step)


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 20):
        self.threshold = threshold
        self.window = window
        self.times: List[float] = []
        self.stragglers: List[int] = []

    def record(self, step: int, wall_s: float) -> bool:
        self.times.append(wall_s)
        hist = self.times[-self.window:]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if wall_s > self.threshold * med:
                self.stragglers.append(step)
                return True
        return False
