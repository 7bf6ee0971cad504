#!/usr/bin/env python3
"""Report what ``ptxas`` makes of the float32 attention forward's kernels,
and time the split-TF32 forward against its first design on one CUDA
card.

    python3 tools/flash_fwd_check.py [--sass]

Run from the root of a checkout.  The first line is ``nvidia-smi``'s
name and power limit.  Then what ``nvcc -Xptxas -v`` says of
``csrc/flash_attention_tf32x3.cu`` (float32 on the tensor cores: one
kernel per head-dim class, ``flash_fwd_tf32x3<64|128|256>``) and of
``csrc/flash_attention.cu`` (the first design: float32 FMAs on the CUDA
cores, on no route) — registers, shared memory and spills of each
kernel.  With ``--sass``, for each kernel of the new source, the count of
each SASS opcode ``cuobjdump -sass`` shows in an ``nvcc -cubin`` of it
(static counts): ``HMMA`` beside the split's integer instructions, and
any ``WARPSYNC`` (an ``mma.sync`` under a branch).

Then at each shape of ``SHAPES`` (the parity phases', qwen3_4b's
prefill and serve_parity_rglru's prefill), float32, one JSON line: the
wrapper (``flash_attention_bshd`` on (B, S, H, hd) tensors, the source
``fwd_source`` names) and the first design (``_fwd_cuda_cores`` on flat
(B*H, S, hd) copies made beforehand, so its row times the kernel alone,
without the transposing copies its route made) each held to the plain
version within ``chip_smoke.ATTN_TOL["float32"]`` x max(1, largest
|plain value|) (beside it ||got - want|| / ||want|| and the mean signed
error over the mean |want|), the wrapper's two calls bit-equal; then the
wrapper, the first design, the first design again, the wrapper again and
SDPA's float32 forward (``chip_smoke.sdpa``, a band mask under a window),
timed in turns in this process: the median CUDA-event ms of a call and the
device ms from ``torch.profiler`` (``chip_smoke.timed_ms`` and
``device_ms``); beside them the bound at 3 x operations over the dense
TF32 peak and at the CUDA-core peak, and the bytes bound.

The kernels against their plain version at every case of chip_smoke's
``FLASH_CASES`` is ``chip_smoke.py --phases flash_attention``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from flash_bwd_check import ptxas_report, sass_counts  # noqa: E402

#: the split-TF32 source and the first design
SOURCES = ("flash_attention_tf32x3.cu", "flash_attention.cu")
#: (case, B, H, Hkv, S, hd, causal, window): the parity phases' shape,
#: qwen3_4b's prefill, serve_parity_rglru's prefill (its one attention
#: layer, the window binding)
SHAPES = (("parity", 2, 32, 8, 128, 128, True, 0),
          ("main", 4, 32, 8, 1024, 128, True, 0),
          ("rglru_parity", 2, 16, 1, 2080, 256, True, 2048))
#: device kernel names: the new source's, the first design's
NEW, FIRST = ("flash_fwd_tf32x3",), ("flash_kernel",)


def timed(torch, fn, names) -> dict:
    """Median CUDA-event ms of ``fn()`` and its device ms (``names``, or
    every kernel where None)."""
    ms, records = cs.device_ms(torch, fn, names, 10)
    return {"ms": cs.timed_ms(torch, fn, 10), "device_ms": ms,
            "device_records": records}


def compare(torch, fa, ref, shape, smi: str) -> dict:
    name, b, h, hkv, s, hd, causal, window = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(b, s, h, hd, generator=g, device=dev)
    k, v = (torch.randn(b, s, hkv, hd, generator=g, device=dev)
            for _ in range(2))
    flat = [t.transpose(1, 2).reshape(-1, s, hd).contiguous()
            for t in (q, k, v)]

    def kern():
        return fa.flash_attention_bshd(q, k, v, causal=causal, window=window)

    def first():
        return fa._fwd_cuda_cores(*flat, causal, window)

    before = fa.flash_attention_flat.launches_by_source.get(fa.FWD_TF32X3, 0)
    got = kern()
    again = kern()
    if fa.flash_attention_flat.launches_by_source.get(
            fa.FWD_TF32X3, 0) != before + 2:
        raise AssertionError(f"{name}: the wrapper did not run "
                             f"{fa.FWD_TF32X3}")
    got_first = first()
    want = ref.attention_flat_plain(*flat, causal=causal, window=window)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    errs, rel_norm, mean_signed = {}, {}, {}
    for key, out in (("kernel", got.transpose(1, 2).reshape(-1, s, hd)),
                     ("first_design", got_first)):
        errs[key] = cs._err(out, want)
        cs._hold(f"flash_attention {key}", errs[key], "float32", name, scale)
        diff = out - want
        rel_norm[key] = float(diff.norm() / want.norm())
        mean_signed[key] = float(diff.mean() / want.abs().mean())
    bit_equal = bool(torch.equal(got, again))
    if not bit_equal:
        raise AssertionError(f"{name}: two calls differ")
    del got, again, got_first, want
    if window > 0:                      # SDPA has no window argument
        qpos = torch.arange(s, device=dev)[:, None]
        kpos = torch.arange(s, device=dev)[None, :]
        band = (kpos > qpos - window) & ((kpos <= qpos) | (not causal))
        lib = cs.sdpa(*(t.transpose(1, 2) for t in (q, k, v)),
                      attn_mask=band)
    else:
        lib = cs.sdpa(*(t.transpose(1, 2) for t in (q, k, v)),
                      is_causal=causal)
    flops = 4 * hd * b * h * cs.visible_pairs(s, s, causal, window)
    n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    row = {"case": name, "card": smi, "shape": {
        "B": b, "S": s, "H": h, "Hkv": hkv, "hd": hd, "causal": causal,
        "window": window, "dtype": "float32"},
        "source": fa.fwd_source(torch.float32, hd),
        "max_abs_err": errs, "scale": scale, "rel_norm_err": rel_norm,
        "mean_signed_err": mean_signed, "bit_equal": bit_equal,
        "flops": flops, "bytes": n_bytes,
        "bound_ms": cs.attn_bound_ms(n_bytes, 3 * flops, "tf32")[0],
        "bound_by": cs.attn_bound_ms(n_bytes, 3 * flops, "tf32")[1],
        "fp32_cuda_core_bound_ms": flops / cs.PEAK_FLOPS["float32"] * 1e3,
        "bytes_bound_ms": n_bytes / cs.HBM_BYTES_PER_S * 1e3}
    for key, fn, names in (("kernel", kern, NEW), ("first_design", first,
                                                     FIRST),
                           ("first_design_again", first, FIRST),
                           ("kernel_again", kern, NEW),
                           ("sdpa", lib, None)):
        row[key] = timed(torch, fn, names)
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name in SOURCES:
        print(ptxas_report(name), flush=True)
    if args.sass:
        for row in sass_counts(SOURCES[0]):
            print(json.dumps({"source": SOURCES[0], **row}), flush=True)
    for shape in SHAPES:
        compare(torch, fa, ref, shape, smi)
        torch.cuda.empty_cache()
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
