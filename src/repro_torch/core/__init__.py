"""LiveStack core, PyTorch port.

Subsystems (one module per paper subsystem):
  vtime        — virtual-time accounting (§3.2): LiveClock, RunPage, CostModel
  vtask        — the vtask abstraction + action vocabulary (§3.2)
  scope        — synchronization scopes, bounded-skew arithmetic (§3.2)
  scheduler    — reference dispatch engine (§3.2)
  cells        — live memory-hierarchy management (§3.3)
  ipc          — simulation-aware IPC: messages/endpoints/hubs (§3.4)
  orchestrator — distributed simulation orchestration (§3.5)
  engine_torch — vectorized fast-path engine on torch tensors
  des          — fine-grained DES baseline (the gem5/ns-3 comparison)
  cluster      — ClusterSpec: chips/ICI/DCN topology -> vtasks + hubs
  workloads    — live workload adapters (Table-2 benchmarks)
"""
from repro_torch.core.vtime import (NS, US, MS, SEC, CostModel, LiveClock,
                                    RunPage, to_ns)
from repro_torch.core.vtask import (Await, Compute, Event, LiveCall, Recv,
                                    Send, State, VTask, Yield)
from repro_torch.core.scope import Scope, all_eligible, wake
from repro_torch.core.cells import Cell, CellManager
from repro_torch.core.ipc import Endpoint, Hub, LinkSpec, Message
from repro_torch.core.scheduler import DeadlockError, SchedStats, Scheduler
from repro_torch.core.orchestrator import Orchestrator, ProxyVTask
from repro_torch.core.des import (DESEngine, extrapolate_wall_s,
                                   fine_grained_compute)
