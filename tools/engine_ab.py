#!/usr/bin/env python3
"""Time the vectorized engine end to end on one CUDA card, for this
checkout and another one, in turns.

    python3 tools/engine_ab.py --other DIR [--pairs 3] [--repeats 15]

Run from the root of a checkout.  DIR is the root of another checkout
(for example the parent commit, unpacked with ``git archive``).  Each
turn is a fresh process on one tree (its own ``src`` and
``chip_smoke.py``, its kernels built from its own sources) that times:

- the main path's round loop (chip_smoke's 16,384-vtask scenario):
  ``run_vec_tape`` between two synchronisations, ``--repeats`` times
  after one warm-up; and its decompile (the two ``hub_route`` calls);
- the 64-variant straggler sweep (chip_smoke's ``sweep_make``) three
  times after one warm-up: ``wall_s`` and ``configs_per_s``.

Turns go other, this, this, other, then again, ``--pairs`` times over,
so that the two trees alternate which runs first.  One JSON line per
turn, then one with each metric's medians for both trees, after
``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def turn(tree: pathlib.Path, repeats: int) -> dict:
    """One tree's timings, in this process."""
    sys.path.insert(0, str(tree))
    import chip_smoke as cs  # puts the tree's src first on sys.path
    import torch

    from repro_torch.core import engine_torch as et
    from repro_torch.sim import Scenario, Straggler
    from repro_torch.sim import vectorized as vz
    if not torch.cuda.is_available():
        raise SystemExit("engine_ab: no CUDA device")
    dev = torch.device("cuda")
    sim = cs.main_path_sim()
    comp = vz.compile_simulation(sim)
    tape = et.tape_from_numpy(comp.tape, dev)
    st0 = et.init_vec_sim_state(tape, comp.n_channels)
    loops, decompiles = [], []
    for i in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = et.run_vec_tape(tape, st0, comp.max_rounds, kernel=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vz._decompile(sim, comp, st, t1 - t0, device=dev, kernel=True,
                      verify=False)
        t2 = time.perf_counter()
        if i:
            loops.append(t1 - t0)
            decompiles.append(t2 - t1)
    axis = [Scenario(f"v{i}", (Straggler(f"w{i % 16}", 1.0 + (i % 7) * 0.5),))
            for i in range(64)]
    walls, rates = [], []
    for i in range(4):
        res = cs.sweep_make().sweep(axis, device=dev)
        if i:
            walls.append(res.wall_s)
            rates.append(res.configs_per_s)
    return {"tree": str(tree), "main_loop_s": loops,
            "decompile_s": decompiles, "sweep_wall_s": walls,
            "configs_per_s": rates}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=15)
    ap.add_argument("--turn", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn.resolve(), args.repeats)))
        return 0
    if args.other is None:
        ap.error("--other is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = {"other": args.other.resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    order = ["other", "this", "this", "other"] * args.pairs
    for name in order[:2 * args.pairs]:
        proc = subprocess.run(
            [sys.executable, __file__, "--turn", str(trees[name]),
             "--repeats", str(args.repeats)], capture_output=True,
            text=True, cwd=trees[name])
        if proc.returncode != 0:
            raise RuntimeError(f"turn on {trees[name]} failed:\n"
                               f"{proc.stderr[-4000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[name].append(row)
        print(json.dumps({"turn": name, **row}), flush=True)
    summary = {}
    for name, rows in runs.items():
        for key in ("main_loop_s", "decompile_s", "sweep_wall_s",
                    "configs_per_s"):
            vals = [v for r in rows for v in r[key]]
            summary[f"{name}_{key}_median"] = statistics.median(vals)
            summary[f"{name}_{key}_quartiles"] = statistics.quantiles(
                vals, n=4)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
