#!/usr/bin/env python3
"""Time one family's train step on one CUDA card, for this checkout and
another one, in turns.

    python3 tools/train_ab.py --other DIR [--family xlstm] [--steps 4]
                              [--pairs 1] [--parity]

Run from the root of a checkout.  DIR is the root of another checkout
(for example the parent commit, unpacked with ``git archive``).  Each
turn is a fresh process on one tree (its own ``src`` and
``chip_smoke.py``, its kernels built from its own sources) that runs
that tree's ``chip_smoke.phase_train`` on the family's entry of
``TRAIN_RECURRENT`` or ``TRAIN_FAMILIES`` with ``--steps`` timed steps
(one warm-up and one profiled step besides; launches checked every
step, as chip_smoke does).  Turns go other, this, this, other,
``--pairs`` times over.  One JSON line per turn (the phase's step
walls, tokens/s, peak memory, the profiled step's idle share and device
ms by class), then one with each tree's median step over all its timed
steps and the quartiles, after ``nvidia-smi``'s name and power limit.

``--parity`` runs the family's ``chip_smoke.phase_train_parity`` instead
(its ``TRAIN_PARITY_FAMILIES`` entry: float32, card against CPU, the
phase's own checks), twice in each turn's process: the first builds the
kernels and starts CUDA, the second gives the card side's and the CPU
side's seconds for the phase's steps; the summary gives the median card
side.
"""
from __future__ import annotations

import argparse
import io
import json
import pathlib
import statistics
import subprocess
import sys
from contextlib import redirect_stdout

ROOT = pathlib.Path(__file__).resolve().parents[1]


def parity_turn(cs, np, torch, family: str) -> dict:
    """One tree's train parity phase, in this process: a warm-up run, then
    the one reported."""
    arch, spec, overrides = {f: rest for f, *rest in
                             cs.TRAIN_PARITY_FAMILIES}[family]
    phase = f"train_parity_{family}"
    for _ in range(2):
        out = io.StringIO()
        with redirect_stdout(out):
            cs.phase_train_parity(torch, np, torch.device("cuda"), spec,
                                  arch, overrides, phase)
    row = next(json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{") and json.loads(line)["phase"] == phase)
    return {"card_s": row["seconds"]["card"], "cpu_s": row["seconds"]["cpu"],
            **{k: row.get(k) for k in ("worst_relative_to_scale", "launches",
                                       "mlstm_bwd_by_source")}}


def turn(tree: pathlib.Path, family: str, steps: int,
         parity: bool = False) -> dict:
    """One tree's train phase (or train parity phase), in this process."""
    sys.path.insert(0, str(tree))
    import chip_smoke as cs  # puts the tree's src first on sys.path
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_ab: no CUDA device")
    if parity:
        return {"tree": str(tree), **parity_turn(cs, np, torch, family)}
    specs = dict(cs.TRAIN_FAMILIES + cs.TRAIN_RECURRENT)
    arch, batch, seq_len, warm, _timed, n_layers = specs[family]
    phase = f"train_{family}"
    out = io.StringIO()
    with redirect_stdout(out):
        cs.phase_train(torch, np, torch.device("cuda"),
                       (arch, batch, seq_len, warm, steps, n_layers), phase)
    row = next(json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{") and json.loads(line)["phase"] == phase)
    return {"tree": str(tree), "step_s": [s["wall_s"]
                                          for s in row["steps"][warm:]],
            **{k: row[k] for k in (
                "step_s_median", "tokens_per_s", "peak_memory_bytes",
                "profiled_step_wall_s", "profiled_step_device_busy_s",
                "profiled_step_device_idle_share",
                "profiled_step_device_ms_by_class")}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=pathlib.Path)
    ap.add_argument("--family", default="xlstm")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--turn", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn.resolve(), args.family, args.steps,
                              args.parity)))
        return 0
    if args.other is None:
        ap.error("--other is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = {"other": args.other.resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    for name in ["other", "this", "this", "other"] * args.pairs:
        proc = subprocess.run(
            [sys.executable, __file__, "--turn", str(trees[name]),
             "--family", args.family, "--steps", str(args.steps)]
            + (["--parity"] if args.parity else []),
            capture_output=True, text=True, cwd=trees[name])
        if proc.returncode != 0:
            raise RuntimeError(f"turn on {trees[name]} failed:\n"
                               f"{proc.stderr[-4000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[name].append(row)
        print(json.dumps({"turn": name, **row}), flush=True)
    summary = {}
    for name, rows in runs.items():
        if args.parity:
            summary[f"{name}_card_s_median"] = statistics.median(
                r["card_s"] for r in rows)
            continue
        vals = [v for r in rows for v in r["step_s"]]
        summary[f"{name}_step_s_median"] = statistics.median(vals)
        summary[f"{name}_step_s_quartiles"] = statistics.quantiles(vals, n=4)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
