#!/usr/bin/env python3
"""Build the flash-attention backward kernels and hold them to their plain
version on one CUDA card; time them beside SDPA's backward.

    python3 tools/flash_bwd_check.py [--no-time]

Run from the root of a checkout.  It prints what ``nvcc -Xptxas -v``
says of ``csrc/flash_attention_bwd_sm90.cu`` (bf16 up to hd 128: the
tensor cores) and ``csrc/flash_attention_bwd.cu`` (float32 and bf16
above hd 128: the CUDA cores) — registers, shared memory, spills of each
kernel — then one JSON line per shape and dtype: the source that ran,
its dq, dk, dv against ``attention_flat_bwd_plain`` (max abs error
relative to max(1, largest |plain gradient|); 2e-2 bfloat16, 1e-4
float32), and whether two calls give the same bits.  At the trainer's
shape (B=4, S=1,024, 32/8 heads, hd 128, causal, bf16) it then times, in
one process and in turns, the wrapper (the tensor-core kernels), the
first design (``csrc/flash_attention_bwd.cu``'s launcher on the same bf16
tensors), the backward of ``scaled_dot_product_attention`` at the same
shape (its forward done before the timed window, ``torch.autograd.grad``
with ``retain_graph``), the plain version, and the wrapper again: CUDA
events, median of 10 calls after warm-up, and the device time per call
from ``torch.profiler``.  The first line is ``nvidia-smi``'s name and
power limit.  A kernel's mbarrier wait traps after a bounded number of
polls, so a hang becomes a CUDA error; run it under ``timeout`` as well.
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
SOURCES = ("flash_attention_bwd_sm90.cu", "flash_attention_bwd.cu")
#: (case, B, H, Hkv, Sq, Sk, hd, causal, window, timed)
CASES = [("train", 4, 32, 8, 1024, 1024, 128, True, 0, True),
         ("gqa", 1, 4, 2, 128, 128, 64, True, 0, False),
         ("padded", 1, 8, 2, 96, 96, 32, True, 0, False),
         ("window64", 1, 2, 1, 256, 256, 64, True, 64, False),
         ("cross", 1, 2, 2, 64, 192, 32, False, 0, False),
         ("hd8", 2, 4, 2, 100, 100, 8, True, 0, False),
         ("hd24", 1, 4, 1, 130, 130, 24, True, 0, False),
         ("hd40", 1, 4, 2, 70, 70, 40, False, 0, False),
         ("hd64_gqa8_window40", 2, 16, 2, 300, 300, 64, True, 40, False),
         ("hd96_ragged", 1, 8, 2, 190, 257, 96, True, 0, False),
         ("hd128_mha", 2, 4, 4, 129, 129, 128, True, 0, False),
         ("sq_lt_sk_causal", 1, 4, 2, 50, 300, 128, True, 0, False),
         ("window5", 1, 4, 2, 200, 200, 256, True, 5, False),
         ("window5_hd64", 1, 4, 2, 200, 200, 64, True, 5, False),
         ("sk0", 2, 4, 2, 30, 0, 64, True, 0, False),
         ("rglru_window", 1, 16, 1, 3072, 3072, 256, True, 2048, False)]


def ptxas_report(name: str) -> str:
    from repro_torch.kernels import _build
    out = subprocess.run([_build.find_nvcc(), *_build.FLAGS, "-Xptxas", "-v",
                          "-o", "/dev/null", str(_build.CSRC / name)],
                         capture_output=True, text=True, timeout=300)
    return f"== {name}\n{out.stdout}{out.stderr}"


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
    if not torch.cuda.is_available():
        print("flash_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_flat_bwd_plain
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name in SOURCES:
        print(ptxas_report(name), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    timed_case = None
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[1]
        for name, b, h, hkv, sq, sk, hd, causal, window, timed in CASES:
            q, k, v, do = inputs(torch, dev, dt, b, h, hkv, sq, sk, hd)
            with torch.no_grad():
                o = fa.flash_attention_bshd(q, k, v, causal=causal,
                                            window=window)
            got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                         window=window)
            source = fa.flash_attention_bwd.source
            again = fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
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
            bit_equal = all(torch.equal(a, c) for a, c in zip(got, again))
            passed = (all(e <= TOL[dname] for e in errs.values())
                      and bit_equal
                      and source == SOURCES[not fa.uses_sm90_bwd(dt, hd)])
            ok = ok and passed
            print(json.dumps({"case": name, "dtype": dname, "source": source,
                              "max_rel_err": errs, "passed": passed,
                              "bit_equal": bit_equal}), flush=True)
            del want, got, again
            if timed and dt == torch.bfloat16:
                timed_case = (q, k, v, o, do, causal, window)
    if timed_case is not None and not args.no_time:
        print(json.dumps(timings(torch, fa, *timed_case)), flush=True)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


def timings(torch, fa, q, k, v, o, do, causal, window) -> dict:
    """The train shape's backward four ways, in turns, in this process."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import attention_flat_bwd_plain
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(k)]
    kern = lambda: fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                          window=window)
    first = lambda: fa._bwd_cuda_cores(q, k, v, o, do, *outs, causal,
                                       window)
    flat = lambda t: t.transpose(1, 2).reshape(b * t.shape[2], t.shape[1],
                                               hd)
    plain = lambda: attention_flat_bwd_plain(
        flat(q), flat(k), flat(v), flat(o), flat(do), causal=causal,
        window=window)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                         enable_gqa=True)
    dos = do.transpose(1, 2)
    lib = lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                      retain_graph=True)
    # the first design on the same bf16 tensors: its own result, held too
    first()
    want = kern()
    torch.cuda.synchronize()
    first_err = max(err_rel(a, w) for a, w in zip(outs, want))
    row = {"case": "train_timed", "shape": [b, sq, h, hkv, hd],
           "causal": causal, "first_design_max_rel_err_vs_kernel": first_err}
    for key, fn in (("kernel", kern), ("first_design", first),
                    ("sdpa_bwd", lib), ("plain", plain), ("kernel_again",
                                                          kern)):
        row[f"{key}_ms"] = median_ms(torch, fn)
        row[f"{key}_device_ms"] = device_ms(torch, fn)
    pairs = sum(min(sk, i + 1) if causal else sk for i in range(sq))
    row["flops_10hd"] = 10 * hd * b * h * pairs
    row["bound_ms"] = row["flops_10hd"] / 989e12 * 1e3
    return row


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


def device_ms(torch, fn, iters: int = 10):
    """The summed device time of every kernel ``fn`` ran, per call, from
    ``torch.profiler`` (None where it kept no device record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    if not evs:
        return None
    # ctypes launches: the profiler may keep only some records, so each
    # kernel counts as its mean record once per call
    return sum(e.self_device_time_total / e.count
               * (1 if e.count <= iters else e.count / iters)
               for e in evs) / 1e3


if __name__ == "__main__":
    sys.exit(main())
