"""`repro_torch.sim` — the declarative scenario API, PyTorch port.

The same facade as `repro.sim`: :class:`Topology`, :class:`Workload`
(:class:`ChipRingTraining`, :class:`RackRing`, :class:`ModeledServe`,
:class:`LiveServe`), :class:`Scenario` injections and
:class:`Simulation`.  ``Simulation.run(engine="vectorized",
device=...)`` and ``Simulation.sweep(..., device=...)`` run the
vectorized engine on torch tensors — on a CUDA device through the
hand-written ``minskew`` and ``hub_route`` kernels.  The single,
barrier and async engines are pure Python and take no device.  The
live workloads (:mod:`repro_torch.sim.live`) record the port's real
``BatchServer`` (on the card through the ``flash_attention`` and
``decode_attention`` kernels) and replay recorded traces.
``run(engine="dist", n_workers=K)`` shards the hosts across forked OS
worker processes (`repro_torch.dist`), which never touch the card.
:class:`AutoscaledServe` is the traffic-driven control plane
(:mod:`repro_torch.sim.control`); :class:`Campaign` sweeps a
:class:`FaultGrid` over a scenario base (its fast path is
``Simulation.sweep`` on ``device``), and :mod:`repro_torch.sim.registry`
holds the named, versioned scenarios with their pinned goldens.
"""
from repro_torch.sim.topology import CellSpec, FabricSpec, Topology
from repro_torch.sim.workload import (EndpointSpec, Program, ScopeSpec,
                                      VecCompute, VecMark, VecRecv,
                                      VecSend, Workload)
from repro_torch.sim.scenario import (BitFlip, ClockSkew, DegradeLink,
                                      FailHost, FailTask, Injection,
                                      Interference, JoinHost, Scenario,
                                      Straggler)
from repro_torch.sim.report import HostReport, SimReport
from repro_torch.sim.simulation import Simulation
from repro_torch.sim.vectorized import SweepResult, UnsupportedByEngine
from repro_torch.sim.workloads import (ChipRingTraining, LiveServe,
                                       ModeledServe, RackRing,
                                       burst_arrivals, diurnal_arrivals,
                                       poisson_arrivals)
from repro_torch.sim.live import (LiveProgram, LiveTrainerRecovery,
                                  ServeStack, TrainerStack,
                                  live_colocated_sim, live_recovery_sim,
                                  live_serve_sim, record_live_colocated,
                                  record_live_recovery, record_live_serve,
                                  recovery_timeline, serve_latency)
from repro_torch.live import (CostLedger, LiveTraceError, LiveTraceMismatch,
                              TRACE_SCHEMA)
from repro_torch.core.engine_torch import TickRangeError
from repro_torch.sim.control import (PLACEMENT_POLICIES, AutoscaledServe,
                                     ThresholdAutoscaler, best_fit,
                                     first_fit, worst_fit)
from repro_torch.sim.campaign import (Campaign, CampaignReport, FaultGrid,
                                      GridPoint, replay_spec)
from repro_torch.sim import registry

__all__ = [
    "AutoscaledServe", "BitFlip", "Campaign", "CampaignReport",
    "CellSpec", "ChipRingTraining", "ClockSkew", "CostLedger",
    "DegradeLink", "EndpointSpec", "FabricSpec", "FailHost",
    "FailTask", "FaultGrid", "GridPoint", "HostReport", "Injection",
    "Interference", "JoinHost", "LiveProgram", "LiveServe",
    "LiveTraceError", "LiveTraceMismatch", "LiveTrainerRecovery",
    "ModeledServe", "PLACEMENT_POLICIES", "Program", "RackRing",
    "Scenario", "ScopeSpec", "ServeStack", "SimReport", "Simulation",
    "Straggler", "SweepResult", "TRACE_SCHEMA", "ThresholdAutoscaler",
    "TickRangeError", "Topology", "TrainerStack",
    "UnsupportedByEngine", "VecCompute", "VecMark", "VecRecv",
    "VecSend", "Workload", "best_fit", "burst_arrivals",
    "diurnal_arrivals", "first_fit", "live_colocated_sim",
    "live_recovery_sim", "live_serve_sim", "poisson_arrivals",
    "record_live_colocated", "record_live_recovery",
    "record_live_serve", "recovery_timeline", "registry",
    "replay_spec", "serve_latency", "worst_fit",
]
