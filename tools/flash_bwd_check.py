#!/usr/bin/env python3
"""Build the flash-attention backward kernel and hold it to its plain
version on one CUDA card; time it beside SDPA's backward.

    python3 tools/flash_bwd_check.py [--no-time]

Run from the root of a checkout.  It prints what ``nvcc -Xptxas -v``
says of ``csrc/flash_attention_bwd.cu`` (registers, shared memory,
spills of each kernel), then one JSON line per shape: the kernel's dq,
dk, dv against ``attention_flat_bwd_plain`` (max abs error relative to
max(1, largest |plain gradient|); 2e-2 bfloat16, 1e-4 float32), and
whether two calls give the same bits.  At the trainer's shape (B=4,
S=1,024, 32/8 heads, hd 128, causal) it also times the kernel (CUDA
events, median of 10 calls after warm-up) and the backward of
``scaled_dot_product_attention`` at the same shape, its forward done
before the timed window (``torch.autograd.grad`` with ``retain_graph``).
The first line is ``nvidia-smi``'s name and power limit.  Each call runs
under a time limit, so a kernel that hangs fails the script.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: (case, B, H, Hkv, Sq, Sk, hd, causal, window, timed)
CASES = [("train", 4, 32, 8, 1024, 1024, 128, True, 0, True),
         ("gqa", 1, 4, 2, 128, 128, 64, True, 0, False),
         ("padded", 1, 8, 2, 96, 96, 32, True, 0, False),
         ("window64", 1, 2, 1, 256, 256, 64, True, 64, False),
         ("cross", 1, 2, 2, 64, 192, 32, False, 0, False),
         ("hd8", 2, 4, 2, 100, 100, 8, True, 0, False),
         ("hd24", 1, 4, 1, 130, 130, 24, True, 0, False),
         ("hd40", 1, 4, 2, 70, 70, 40, False, 0, False),
         ("sq_lt_sk_causal", 1, 4, 2, 50, 300, 128, True, 0, False),
         ("window5", 1, 4, 2, 200, 200, 256, True, 5, False),
         ("sk0", 2, 4, 2, 30, 0, 64, True, 0, False),
         ("rglru_window", 1, 16, 1, 3072, 3072, 256, True, 2048, False)]


def ptxas_report() -> str:
    from repro_torch.kernels import _build
    src = _build.CSRC / "flash_attention_bwd.cu"
    out = subprocess.run([_build.find_nvcc(), *_build.FLAGS, "-Xptxas", "-v",
                          "-o", "/dev/null", str(src)], capture_output=True,
                         text=True, timeout=300)
    return out.stdout + out.stderr


def inputs(torch, dev, dt, b, h, hkv, sq, sk, hd, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, sq, h, hd, generator=g, device=dev).to(dt)
    k = torch.randn(b, sk, hkv, hd, generator=g, device=dev).to(dt)
    v = torch.randn(b, sk, hkv, hd, generator=g, device=dev).to(dt)
    do = torch.randn(b, sq, h, hd, generator=g, device=dev).to(dt)
    return q, k, v, do


def err_rel(got, want) -> float:
    scale = max(1.0, float(want.float().abs().max())) if want.numel() else 1.0
    if not got.numel():
        return 0.0
    return float((got.float() - want.float()).abs().max()) / scale


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import (flash_attention_bshd,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ref import attention_flat_bwd_plain
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(ptxas_report(), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[1]
        for name, b, h, hkv, sq, sk, hd, causal, window, timed in CASES:
            q, k, v, do = inputs(torch, dev, dt, b, h, hkv, sq, sk, hd)
            with torch.no_grad():
                o = flash_attention_bshd(q, k, v, causal=causal,
                                         window=window)
            got = flash_attention_bwd(q, k, v, o, do, causal=causal,
                                      window=window)
            again = flash_attention_bwd(q, k, v, o, do, causal=causal,
                                        window=window)

            def flat(t):
                return t.transpose(1, 2).reshape(b * t.shape[2], t.shape[1],
                                                 hd)
            want = attention_flat_bwd_plain(
                flat(q), flat(k), flat(v), flat(o), flat(do), causal=causal,
                window=window)
            torch.cuda.synchronize()
            errs = {}
            for gname, gt, wt, heads in zip(("dq", "dk", "dv"), got, want,
                                            (h, hkv, hkv)):
                wt = wt.reshape(b, heads, wt.shape[1], hd).transpose(1, 2)
                errs[gname] = err_rel(gt, wt)
            passed = all(e <= TOL[dname] for e in errs.values())
            ok = ok and passed
            row = {"case": name, "dtype": dname, "max_rel_err": errs,
                   "passed": passed,
                   "bit_equal": all(torch.equal(a, c)
                                    for a, c in zip(got, again))}
            del want
            if timed and not args.no_time:
                kern = lambda: flash_attention_bwd(q, k, v, o, do,
                                                   causal=causal,
                                                   window=window)
                row["kernel_ms"] = median_ms(torch, kern)
                qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                              for t in (q, k, v))
                out = F.scaled_dot_product_attention(qs, ks, vs,
                                                     is_causal=causal,
                                                     enable_gqa=True)
                dos = do.transpose(1, 2)
                lib = lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                                  retain_graph=True)
                row["sdpa_bwd_ms"] = median_ms(torch, lib)
            print(json.dumps(row), flush=True)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


def median_ms(torch, fn, iters: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


if __name__ == "__main__":
    sys.exit(main())
