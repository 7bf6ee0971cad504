"""Structured simulation results.

:class:`SimReport` replaces the ad-hoc ``(sched, tasks, ctx)`` tuples of
the hand-wired build functions: one JSON-serializable record with per-host
dispatch/sync statistics, proxy staleness, per-link visibility slack,
per-task outcomes, and workload progress arrays.  ``status`` is
``"ok"`` or ``"deadlock"`` — fault injections that wedge the cluster
(e.g. a dead ring partner) are a *result*, not a crash.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

import numpy as np


@dataclasses.dataclass
class HostReport:
    """Per-host scheduler statistics (see SchedStats)."""
    host: int
    dispatches: int
    rounds: int
    skew_stalls: int
    max_skew_seen: int
    gate_deferrals: int
    window_runs: int
    preemptions: int
    live_calls: int

    @classmethod
    def from_sched(cls, host: int, stats) -> "HostReport":
        return cls(host=host, dispatches=stats.dispatches,
                   rounds=stats.rounds,
                   skew_stalls=stats.skew_stalls,
                   max_skew_seen=stats.max_skew_seen,
                   gate_deferrals=stats.gate_deferrals,
                   window_runs=stats.window_runs,
                   preemptions=stats.preemptions,
                   live_calls=stats.live_calls)


def _jsonable(value: Any) -> Any:
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.integer, np.floating)):
        return value.item()
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return value


@dataclasses.dataclass
class SimReport:
    status: str                      # "ok" | "deadlock"
    mode: str    # "single" | "async" | "barrier" | "dist" | "vectorized"
    n_hosts: int
    vtime_ns: int                    # simulated horizon
    wall_s: float
    messages: int
    bytes: int
    sync_rounds: int                 # orchestrator epochs (0 single-host)
    proxy_syncs: int
    cross_host_msgs: int
    max_proxy_staleness_ns: int
    max_window_ns: int
    hosts: List[HostReport]
    links: Dict[str, Dict[str, Any]]     # "hub->peer" -> peer_stats
    tasks: Dict[str, Dict[str, Any]]     # name -> {vtime, state, host}
    progress: Dict[str, Any]             # workload -> named arrays
    scenario: str = "baseline"
    detail: str = ""                     # deadlock detail, if any
    n_workers: int = 1                   # OS worker processes (dist engine)
    #: per-host §3.3 cell accounting, keyed by str(host): switches,
    #: recondition_ns, interference/self-pressure events, and per-cell
    #: slowdown histograms (CellManager.snapshot(); empty when the
    #: simulation declared no cells).  Integer-valued, so engines can be
    #: compared bit-exactly on it.
    cells: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: vectorized engine only: the compiled tick size and which bar of
    #: the two-tier conformance contract this run sits under ("exact" =
    #: every additive ns quantity was tick-divisible, results are
    #: bit-identical to the reference engines; "tolerance" = quantized,
    #: vtimes within the declared bound).  0/"" for the other engines.
    tick_ns: int = 0
    tier: str = ""
    #: live-execution sections, keyed by workload name (repro_torch.sim.live):
    #: ledger mode + calibration and per-task records — for the marquee
    #: recovery scenario, the detection → restore → re-mesh → resumed
    #: timeline with vtimes.  Empty for fully modeled simulations, and
    #: integer-vtimed so the cross-engine harness compares it bit-exactly.
    live: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: control-plane timeline (repro_torch.sim.control): a ``"membership"``
    #: list of vtime-ordered join/leave events plus one section per
    #: control workload (scale decisions, health events, placement, and
    #: p50/p95/p99 simulated request latency).  Empty when the
    #: simulation has neither membership churn nor a control workload;
    #: integer-vtimed so engines compare bit-exactly.
    control: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: structured companion to ``detail``: for deadlocks, the wedged
    #: hosts and any membership joins that never activated
    #: ({"kind": "wedged", "wedged_hosts": [...], "pending_joins":
    #: [...]}).  Empty on ok runs.  ``detail`` stays the human-readable
    #: string so existing goldens are byte-identical.
    detail_info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return _jsonable(d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)
