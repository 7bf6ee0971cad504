"""`repro_torch.dist` — multi-process distributed simulation orchestration.

The fourth LiveStack subsystem at real OS-process scale: a
:class:`~repro_torch.dist.coordinator.DistCoordinator` shards a facade
:class:`~repro_torch.sim.simulation.Simulation` across ``n_workers`` forked
worker processes (each running its own
:class:`~repro_torch.core.scheduler.Scheduler` per owned host) and extends
the async engine's per-link-lookahead LBTS protocol across process
boundaries over pipes.  Results are bit-identical to the in-process
``barrier``/``async`` engines (enforced by ``tests/engine_harness.py``).

Entry point::

    report = Simulation(topology, workloads, scenario).run(
        engine="dist", n_workers=4)

``python -m repro_torch.dist`` runs a 2-worker smoke (used by CI).
"""
from repro_torch.dist.coordinator import (DistCoordinator, DistWorkerError,
                                    partition_hosts, run_dist)

__all__ = ["DistCoordinator", "DistWorkerError", "partition_hosts",
           "run_dist"]
