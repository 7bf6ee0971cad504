#!/usr/bin/env python3
"""Report what ``ptxas`` makes of the RG-LRU backward, hold it to its plain
version, and time it against the first design on one CUDA card.

    python3 tools/rglru_bwd_check.py [--first-design PATH] [--check-only]

Run from the root of a checkout.  The first line is ``nvidia-smi``'s name
and power limit.  Then what ``nvcc -Xptxas -v`` says of
``csrc/rglru_scan_bwd.cu`` (and of the first design, where given):
registers, shared memory and spills of each instantiation.  Then the
wrapper (``rglru_scan_bwd``: T_c 256 over 8 warps) and the first design
are held to ``rglru_bwd_plain`` at ``CHECKS`` (the train shape with and without h0,
the parity shape, odd W off the chunk, S = 1, the long chain): dlog_a, db
and dh0 within ``chip_smoke.ATTN_TOL["float32"]`` x max(1, largest |plain
gradient|), and two calls bit-equal.  ``--check-only`` stops there.

Then, at ``TIMED`` (recurrentgemma's train shape, train_parity_rglru's,
and a long chain where the carry chain is the critical path; no h0, as
the model calls it), the first design and the wrapper in turns on the
same tensors, in the order first design, wrapper, wrapper, first design:
per turn the median CUDA-event ms of three runs of 20 back-to-back calls
over 20 (the workspace reset included) and the kernel's device ms from
``torch.profiler`` (``chip_smoke.device_ms``, by kernel name).  One JSON
line per shape, with the bytes bound (log_a, h, dh read, db and dlog_a
written: 20 bytes an element over 3.35 TB/s) and, as yardsticks of the
streaming rate the card reaches at that size (not the same function),
``torch.addcmul`` of the same three inputs into one output (three reads
and a write an element) and ``Tensor.copy_`` of one input (a read and a
write): their device ms and rates, each turn's rate at 20 bytes, and
``mix_floor_ms``, the time of three reads and two writes an element
at the per-read and per-write costs the two yardsticks solve for.

``--first-design`` names the source of the design the kernel replaced,
for example extracted with

    git show b8c4108:src/repro_torch/kernels/csrc/rglru_scan_bwd.cu \\
        > build/rglru_bwd_first.cu

which is built with the same flags (and ``-I`` the kernels' ``csrc``,
for ``sm90.cuh``) and timed in the same turns.
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
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: (B, S, W, with h0) held to the plain version
CHECKS = ((4, 1024, 4096, False), (4, 1024, 4096, True),
          (2, 128, 4096, False), (2, 515, 4099, True), (3, 1, 4096, True),
          (1, 257, 36, True), (1, 16384, 1024, True))
#: (name, B, S, W) timed: the train shape, the parity shape, a long chain
TIMED = (("train", 4, 1024, 4096), ("parity", 2, 128, 4096),
         ("long_chain", 1, 16384, 1024))
NEW_KERNEL = "rglru_bwd_subchunk_kernel"
FIRST_KERNEL = "rglru_bwd_chained_kernel"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def ptxas_report(path: pathlib.Path) -> str:
    from repro_torch.kernels import _build
    out = subprocess.run([_build.find_nvcc(), *_build.FLAGS, "-I",
                          str(_build.CSRC), "-Xptxas", "-v", "-o",
                          "/dev/null", str(path)],
                         capture_output=True, text=True, timeout=300)
    return f"== {path.name}\n{out.stdout}{out.stderr}"


def first_design(torch, path: pathlib.Path):
    """The first design's call ``(log_a, h, h0, dh) -> (dla, db, dh0)``,
    built from ``path`` into build/ (its launcher: T_c 256, one warp)."""
    from repro_torch.kernels import _build
    so = _build.BUILD_DIR / "librglru_bwd_first.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.FLAGS, "-I", str(_build.CSRC),
                    "-o", str(so), str(path)], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.rglru_scan_bwd_launch
    fn.argtypes = [_P] * 8 + [_L, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    ws_fn = lib.rglru_scan_bwd_workspace_bytes
    ws_fn.argtypes = [_I] * 4
    ws_fn.restype = _L

    def run(la, h, h0, dh):
        bsz, s, w = la.shape
        dla, db = torch.empty_like(la), torch.empty_like(la)
        dh0 = None if h0 is None else torch.empty_like(h0)
        n = ws_fn(bsz, s, w, 256)
        ws = torch.empty(n, dtype=torch.uint8, device=la.device)
        err = fn(la.data_ptr(), h.data_ptr(),
                 None if h0 is None else h0.data_ptr(), dh.data_ptr(),
                 dla.data_ptr(), db.data_ptr(),
                 None if dh0 is None else dh0.data_ptr(), ws.data_ptr(), n,
                 bsz, s, w, 256, 32, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"first design: CUDA error {err}")
        return dla, db, dh0
    return run


def inputs(torch, g, dev, b, s, w, with_h0):
    from repro_torch.kernels.ref import rglru_plain
    log_a = -torch.rand(b, s, w, generator=g, device=dev) * 0.3
    bv, dh = (torch.randn(b, s, w, generator=g, device=dev)
              for _ in range(2))
    h0 = torch.randn(b, w, generator=g, device=dev) if with_h0 else None
    return log_a, rglru_plain(log_a, bv, h0), h0, dh


def batch_ms(torch, fn, n: int = 20) -> float:
    return statistics.median(cs.batch_ms(torch, fn, n) for _ in range(3))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--first-design", type=pathlib.Path)
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rglru_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as kr
    from repro_torch.kernels.ref import rglru_bwd_plain
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(ptxas_report(_build.CSRC / "rglru_scan_bwd.cu"), flush=True)
    runs = {"new": kr.rglru_scan_bwd}
    names = {"new": NEW_KERNEL}
    if args.first_design:
        print(ptxas_report(args.first_design), flush=True)
        runs = {"first": first_design(torch, args.first_design), **runs}
        names["first"] = FIRST_KERNEL
    print(json.dumps({"wrapper": kr.plan_bwd(4, 1024, 4096)}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(32)

    for b, s, w, with_h0 in CHECKS:
        la, h, h0, dh = inputs(torch, g, dev, b, s, w, with_h0)
        want = rglru_bwd_plain(la, h, h0, dh)
        row = {"check": [b, s, w, with_h0]}
        for key, run in runs.items():
            got, again = run(la, h, h0, dh), run(la, h, h0, dh)
            torch.cuda.synchronize()
            err, scale = cs._bwd_err([x for x in got if x is not None],
                                     [x for x in want if x is not None])
            cs._hold(f"rglru_scan_bwd {key}", err, "float32",
                     (b, s, w, with_h0), scale)
            if not all(x is None or torch.equal(x, y)
                       for x, y in zip(got, again)):
                raise AssertionError(f"{key} at {(b, s, w)}: two calls "
                                     f"differ")
            row[key] = err
        row["scale"] = scale
        print(json.dumps(row), flush=True)
        del la, h, h0, dh, want, got, again
        torch.cuda.empty_cache()
    if args.check_only:
        print(json.dumps({"ok": True, "checked": list(runs)}))
        return 0

    for name, b, s, w in TIMED:
        la, h, h0, dh = inputs(torch, g, dev, b, s, w, False)
        row = {"shape": name, "B": b, "S": s, "W": w, "card": smi,
               "bound_ms": 20 * la.numel() / cs.HBM_BYTES_PER_S * 1e3}
        order = list(runs)
        for key in order + order[::-1]:
            fn = (lambda r=runs[key]: r(la, h, None, dh))
            row.setdefault(f"{key}_ms", []).append(batch_ms(torch, fn))
            row.setdefault(f"{key}_device_ms", []).append(
                cs.device_ms(torch, fn, (names[key],))[0])
        out = torch.empty_like(la)
        three_one = cs.device_ms(
            torch, lambda: torch.addcmul(la, h, dh, out=out))[0]
        one_one = cs.device_ms(torch, lambda: out.copy_(la))[0]
        row["addcmul_device_ms"] = three_one
        row["addcmul_tb_s"] = 16 * la.numel() / three_one / 1e9
        row["copy_device_ms"] = one_one
        row["copy_tb_s"] = 8 * la.numel() / one_one / 1e9
        read = (three_one - one_one) / 2     # 3 r + w, r + w
        row["mix_floor_ms"] = 3 * read + 2 * (one_one - read)
        for key in order:
            row[f"{key}_tb_s"] = [20 * la.numel() / t / 1e9
                                  for t in row[f"{key}_device_ms"]]
        print(json.dumps(row), flush=True)
        del la, h, dh, out
        torch.cuda.empty_cache()
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
