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

__all__ = [
    "BitFlip", "CellSpec", "ChipRingTraining", "ClockSkew", "CostLedger",
    "DegradeLink", "EndpointSpec", "FabricSpec", "FailHost", "FailTask",
    "HostReport", "Injection", "Interference", "JoinHost", "LiveProgram",
    "LiveServe", "LiveTraceError", "LiveTraceMismatch",
    "LiveTrainerRecovery", "ModeledServe", "Program", "RackRing",
    "Scenario", "ScopeSpec", "ServeStack", "SimReport", "Simulation",
    "Straggler", "SweepResult", "TRACE_SCHEMA", "TickRangeError",
    "Topology", "TrainerStack", "UnsupportedByEngine", "VecCompute",
    "VecMark", "VecRecv", "VecSend", "Workload", "burst_arrivals",
    "diurnal_arrivals", "live_colocated_sim", "live_recovery_sim",
    "live_serve_sim", "poisson_arrivals", "record_live_colocated",
    "record_live_recovery", "record_live_serve", "recovery_timeline",
    "serve_latency",
]
