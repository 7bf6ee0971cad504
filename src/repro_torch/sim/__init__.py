"""`repro_torch.sim` — the declarative scenario API, PyTorch port.

The same facade as `repro.sim`: :class:`Topology`, :class:`Workload`
(:class:`ChipRingTraining`, :class:`RackRing`, :class:`ModeledServe`,
:class:`LiveServe`), :class:`Scenario` injections and
:class:`Simulation`.  ``Simulation.run(engine="vectorized",
device=...)`` and ``Simulation.sweep(..., device=...)`` run the
vectorized engine on torch tensors — on a CUDA device through the
hand-written ``minskew`` and ``hub_route`` kernels.  The single,
barrier and async engines are pure Python and take no device.
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
from repro_torch.core.engine_torch import TickRangeError

__all__ = [
    "BitFlip", "CellSpec", "ChipRingTraining", "ClockSkew",
    "DegradeLink", "EndpointSpec", "FabricSpec", "FailHost", "FailTask",
    "HostReport", "Injection", "Interference", "JoinHost", "LiveServe",
    "ModeledServe", "Program", "RackRing", "Scenario", "ScopeSpec",
    "SimReport", "Simulation", "Straggler", "SweepResult",
    "TickRangeError", "Topology", "UnsupportedByEngine", "VecCompute",
    "VecMark", "VecRecv", "VecSend", "Workload", "burst_arrivals",
    "diurnal_arrivals", "poisson_arrivals",
]
