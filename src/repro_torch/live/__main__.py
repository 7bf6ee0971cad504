"""CLI for the live scenarios' record/replay ledgers, PyTorch port of
``repro.live.__main__``.

Record a trace on ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions of the kernels; ``--scenario`` picks the canned scenario):

* ``recovery`` — the marquee trainer recovery (the real trainer on the
  one device, its mesh logical)::

      python -m repro_torch.live record --scenario recovery \\
          --out results/live_recovery_trace.json

* ``serve`` — the real BatchServer under open-loop arrivals::

      python -m repro_torch.live record --scenario serve \\
          --out results/live_serve_trace.json

* ``colocated`` — live trainer + live server sharing one §3.3 cell,
  both recorded into one multi-driver trace::

      python -m repro_torch.live record --scenario colocated \\
          --out results/live_colocated_trace.json

Replay any trace deterministically on any engine (no model runs, no
device needed); the scenario is inferred from the trace meta::

    python -m repro_torch.live replay --trace tests/golden/live_serve_trace.json
"""
from __future__ import annotations

import argparse
import json
import sys


def _replay_sim(ledger):
    """Pick the canned scenario a trace belongs to from its pinned
    meta blocks (each recorder writes exactly one of these keys)."""
    from repro_torch.sim.live import (live_colocated_sim, live_recovery_sim,
                                live_serve_sim)
    if "colocated" in ledger.meta:
        return "colocated", live_colocated_sim(ledger)
    if "serve" in ledger.meta:
        return "serve", live_serve_sim(ledger)
    if "recovery" in ledger.meta:
        return "recovery", live_recovery_sim(ledger)
    raise SystemExit(
        "trace meta names no canned scenario (expected one of "
        "'recovery', 'serve', 'colocated')")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.live")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rec = sub.add_parser("record", help="record a live trace")
    rec.add_argument("--out", required=True)
    rec.add_argument("--scenario", default="recovery",
                     choices=("recovery", "serve", "colocated"))
    rec.add_argument("--arch", default="qwen3_4b")
    rec.add_argument("--engine", default="async")
    rec.add_argument("--calibration", type=float, default=1.0)
    rec.add_argument("--device", default="cuda",
                     help="where the real stack runs (cuda or cpu)")
    rec.add_argument("--n-steps", type=int, default=8,
                     help="recovery: train steps")
    rec.add_argument("--checkpoint-every", type=int, default=3,
                     help="recovery: checkpoint cadence")
    rec.add_argument("--n-requests", type=int, default=12,
                     help="serve: open-loop request count")
    rep = sub.add_parser("replay", help="replay a recorded trace")
    rep.add_argument("--trace", required=True)
    rep.add_argument("--engine", default="async")
    rep.add_argument("--n-workers", type=int, default=2)
    args = ap.parse_args(argv)

    if args.cmd == "record":
        if args.scenario == "recovery":
            from repro_torch.sim.live import record_live_recovery
            report, ledger = record_live_recovery(
                args.out, arch=args.arch, engine=args.engine,
                calibration=args.calibration, device=args.device,
                n_steps=args.n_steps, checkpoint_every=args.checkpoint_every)
        elif args.scenario == "serve":
            from repro_torch.sim.live import record_live_serve
            report, ledger = record_live_serve(
                args.out, arch=args.arch, engine=args.engine,
                calibration=args.calibration, device=args.device,
                n_requests=args.n_requests)
        else:
            from repro_torch.sim.live import record_live_colocated
            report, ledger = record_live_colocated(
                args.out, arch=args.arch, engine=args.engine,
                calibration=args.calibration, device=args.device)
        print(f"recorded {args.scenario} -> {args.out} "
              f"({sum(len(v) for v in ledger.tasks.values())} costs)")
    else:
        from repro_torch.live import CostLedger
        from repro_torch.sim.live import recovery_timeline, serve_latency
        ledger = CostLedger.replay(args.trace)
        scenario, sim = _replay_sim(ledger)
        report = sim.run(engine=args.engine, n_workers=args.n_workers)
        out = {"scenario": scenario, "status": report.status,
               "engine": report.mode, "vtime_ns": report.vtime_ns}
        ok = report.status == "ok"
        if scenario in ("recovery", "colocated"):
            out["recovery"] = recovery_timeline(report)
        if scenario in ("serve", "colocated"):
            out["latency_ns"] = serve_latency(report)
            ok = ok and bool(out["latency_ns"])
        if scenario == "recovery":
            ok = ok and bool(out["recovery"])
        print(json.dumps(out, indent=1))
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
