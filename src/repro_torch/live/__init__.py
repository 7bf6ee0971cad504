"""`repro_torch.live` — recorded-cost ledger for live-execution workloads.

See :mod:`repro_torch.live.recorder` for the record/replay model and
:mod:`repro_torch.sim.live` for the workloads that consume it.
"""
from repro_torch.live.recorder import (TRACE_SCHEMA, CostLedger,
                                 LiveTraceError, LiveTraceMismatch)

__all__ = ["TRACE_SCHEMA", "CostLedger", "LiveTraceError",
           "LiveTraceMismatch"]
