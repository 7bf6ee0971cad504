#!/usr/bin/env python3
"""Time the chained ``rglru_scan`` kernel at each chunk length it takes,
and optionally the first design, on one CUDA card.

    python3 tools/rglru_chunks.py [--first-design PATH]

Run from the root of a checkout.  The kernel's launcher takes T_c as an
argument (``kernels.rglru_scan`` passes ``CHUNK``); this script calls it
at every T_c from 32 to 256, holds each to ``rglru_plain`` within 1e-4 x
max(1, largest |value|) at recurrentgemma's prefill shape (B=4, S=3,072,
W=4,096, with h0), an odd W and a short S, checks that two calls give the
same bits, and times T_c = 64, 128, 256 at the prefill shape and at a
long-chain shape (B=1, S=16,384, W=1,024).  ``--first-design`` names the
source of the one-thread-per-channel design that the chained kernel
replaced, for example extracted with

    git show 5345b68:src/repro_torch/kernels/csrc/rglru_scan.cu \\
        > build/rglru_first.cu

which is built with the same flags and timed in the same turns.  Times
are CUDA-event medians of three runs of 20 back-to-back calls over 20,
taken in the order first design, 64, 128, 256, then back.  One JSON line
per shape, after ``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
TIMED = (64, 128, 256)


def first_design(torch, path: pathlib.Path):
    """The first design's launcher, built from ``path`` into build/."""
    from repro_torch.kernels import _build
    so = _build.BUILD_DIR / "librglru_first.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.FLAGS, "-o", str(so),
                    str(path)], check=True)
    fn = ctypes.CDLL(str(so)).rglru_scan_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, I, I, P]
    fn.restype = I

    def run(la, bv):
        bsz, s, w = la.shape
        out = torch.empty_like(la)
        h0 = torch.zeros(bsz, w, device=la.device)
        err = fn(la.data_ptr(), bv.data_ptr(), h0.data_ptr(), out.data_ptr(),
                 bsz, s, w, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"first design: CUDA error {err}")
        return out
    return run


def chained(torch, la, bv, h0, chunk):
    from repro_torch.kernels.rglru_scan import TILE_W, _lib
    launch, ws_bytes = _lib()
    bsz, s, w = la.shape
    out = torch.empty_like(la)
    n = ws_bytes(bsz, s, w, chunk)
    ws = torch.empty(n, dtype=torch.uint8, device=la.device)
    err = launch(la.data_ptr(), bv.data_ptr(),
                 None if h0 is None else h0.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), n, bsz, s, w, chunk, TILE_W,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"chunk {chunk}: CUDA error {err}")
    return out


def batch_ms(torch, fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / n)
    return statistics.median(runs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--first-design", type=pathlib.Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rglru_chunks: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.ref import rglru_plain
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    first = (first_design(torch, args.first_design) if args.first_design
             else None)

    def inputs(b, s, w, with_h0):
        la = -torch.rand(b, s, w, generator=g, device=dev) * 0.3
        bv = torch.randn(b, s, w, generator=g, device=dev)
        h0 = (torch.randn(b, w, generator=g, device=dev) if with_h0
              else None)
        return la, bv, h0

    for shape in ((4, 3072, 4096), (2, 515, 4099), (3, 100, 64)):
        la, bv, h0 = inputs(*shape, True)
        want = rglru_plain(la, bv, h0)
        scale = max(1.0, float(want.abs().max()))
        for chunk in range(32, 257, 32):
            got = chained(torch, la, bv, h0, chunk)
            err = float((got - want).abs().max())
            if not err <= 1e-4 * scale:
                raise AssertionError(f"chunk {chunk} at {shape}: {err}")
            if not torch.equal(got, chained(torch, la, bv, h0, chunk)):
                raise AssertionError(f"chunk {chunk} at {shape}: two calls "
                                     f"differ")
        del la, bv, h0, want, got
    print(json.dumps({"checked_chunks": list(range(32, 257, 32))}),
          flush=True)
    for shape in ((4, 3072, 4096), (1, 16384, 1024)):
        la, bv, _ = inputs(*shape, False)
        row = {"shape": list(shape),
               "bound_ms": 12 * la.numel() / HBM_BYTES_PER_S * 1e3}
        turns = (["first"] if first else []) + list(TIMED)
        for name in turns + turns[::-1]:
            fn = ((lambda: first(la, bv)) if name == "first" else
                  (lambda c=name: chained(torch, la, bv, None, c)))
            row.setdefault(f"{name}_ms" if name == "first"
                           else f"chunk{name}_ms", []).append(
                batch_ms(torch, fn))
        print(json.dumps(row), flush=True)
        del la, bv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
