"""Virtual-time accounting (paper §3.2, "Virtual-Time Accounting").

Two vtime sources, exactly mirroring the paper:

* **Clock-derived** (live vtasks): the paper adapts KVM's pvclock so that
  guest-visible time advances only during actual vCPU execution, absorbing
  preemption gaps into the TSC offset.  ``LiveClock`` is our analogue: it
  measures host wall-time spans *only while the live call executes* (the
  scheduler is not running the vtask between dispatches, so "steal time"
  is structurally absorbed) and applies a calibration scale mapping host
  execution speed to the simulated target's speed.  The scheduler and the
  "guest" (workload code) read the same clock — single source of truth.

* **Model-driven** (modeled vtasks): components report accumulated
  simulated latency either synchronously (return value of a step — the
  ``ioctl`` analogue) or asynchronously through a shared ``RunPage`` the
  scheduler polls (the per-vtask run-page analogue).

All vtimes are integer nanoseconds for exact, platform-independent
determinism.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

NS = 1
US = 1_000
MS = 1_000_000
SEC = 1_000_000_000


def to_ns(seconds: float) -> int:
    return int(round(seconds * SEC))


@dataclasses.dataclass
class RunPage:
    """Shared async progress page for a modeled vtask (paper: per-vtask
    run page).  The component accumulates simulated latency; the scheduler
    drains it at dispatch points."""
    accumulated_ns: int = 0
    epoch: int = 0                      # bumped on every report

    def report(self, delta_ns: int) -> None:
        if delta_ns < 0:
            raise ValueError("negative vtime advance")
        self.accumulated_ns += int(delta_ns)
        self.epoch += 1

    def drain(self) -> int:
        d, self.accumulated_ns = self.accumulated_ns, 0
        return d


class LiveClock:
    """pvclock analogue for live vtasks.

    ``calibration`` converts measured host-nanoseconds into simulated
    target-nanoseconds (e.g. host CPU step time -> TPU roofline step
    time).  ``measure`` brackets one live execution span; between spans
    the clock does not advance (preemption-gap absorption).
    """

    def __init__(self, calibration: float = 1.0,
                 timer: Callable[[], int] = time.perf_counter_ns):
        self.calibration = float(calibration)
        self._timer = timer
        self.total_host_ns = 0
        self.total_vtime_ns = 0

    def measure(self, fn: Callable, *args, **kwargs):
        """Execute ``fn`` live; returns (result, vtime_delta_ns)."""
        t0 = self._timer()
        result = fn(*args, **kwargs)
        host_ns = self._timer() - t0
        v_ns = int(round(host_ns * self.calibration))
        self.total_host_ns += host_ns
        self.total_vtime_ns += v_ns
        return result, v_ns


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Cost-derived vtime for live components when the target hardware is
    not the host (the dry-run roofline terms *are* this model).

    vtime(op) = max(flops/peak_flops, bytes/hbm_bw) + collective_ns."""
    peak_flops: float = 197e12          # TPU v5e bf16
    hbm_bw: float = 819e9
    link_bw: float = 50e9

    def step_ns(self, flops: float, bytes_hbm: float,
                coll_bytes: float = 0.0, coll_ns: float = 0.0) -> int:
        compute = flops / self.peak_flops
        memory = bytes_hbm / self.hbm_bw
        coll = coll_ns / SEC + coll_bytes / self.link_bw
        return to_ns(max(compute, memory) + coll)
