"""Distributed-engine smoke: a small heterogeneous rack topology run
in-process (async) and across 2 OS worker processes (dist), asserting
bit-identical task outcomes.  CI runs this as the dist smoke step:

    PYTHONPATH=src python -m repro_torch.dist
"""
from __future__ import annotations

import argparse
import sys


def smoke(n_workers: int = 2, n_iters: int = 60) -> int:
    from repro_torch.sim import RackRing, Scenario, Simulation, Topology

    def make():
        wl = RackRing(n_racks=2, hosts_per_rack=2, n_iters=n_iters,
                      skew_bound_ns=2_000_000)
        return Simulation(
            Topology.racks(2, 2), wl,
            Scenario("imbalanced racks", wl.stragglers((1.0, 3.0))),
            placement=wl.default_placement())

    inproc = make().run(engine="async", on_deadlock="raise")
    dist = make().run(engine="dist", n_workers=n_workers,
                      worker_timeout=60.0, on_deadlock="raise")
    assert dist.tasks == inproc.tasks, \
        (dist.tasks, inproc.tasks)
    assert dist.messages == inproc.messages
    assert dist.vtime_ns == inproc.vtime_ns
    print(f"dist smoke ok: {dist.n_hosts} hosts / {dist.n_workers} "
          f"workers, {dist.sync_rounds} cross-partition sync rounds, "
          f"{dist.cross_host_msgs} cross-host msgs, "
          f"sim={dist.vtime_ns / 1e6:.2f} ms, "
          f"wall={dist.wall_s * 1e3:.0f} ms — bit-identical to async "
          f"({inproc.sync_rounds} rounds, "
          f"wall={inproc.wall_s * 1e3:.0f} ms)")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args()
    sys.exit(smoke(args.workers, args.iters))
