#!/usr/bin/env python3
"""Report what ``ptxas`` makes of the attention backward's kernels, and
time the tensor-core backwards against their first design on one CUDA
card.

    python3 tools/flash_bwd_check.py [--sass] [--parts]

Run from the root of a checkout.  The first line is ``nvidia-smi``'s
name and power limit.  Then what ``nvcc -Xptxas -v`` says of the three
backward sources — ``csrc/flash_attention_bwd_sm90.cu`` (bf16: ``wgmma``;
each head-dim variant's two kernels and the head split's reduction),
``csrc/flash_attention_bwd_tf32x3.cu`` (float32: split TF32 ``mma.sync``;
each head-dim variant's two kernels and the reduction) and
``csrc/flash_attention_bwd.cu`` (the first design: the CUDA cores, either
dtype, on no route) — registers, shared memory, spills of each kernel.
Then, in bf16 and in float32, at the two train shapes of
``chip_smoke.FLASH_BWD_CASES`` in ``TIMED`` (qwen3_4b's: B=4, S=1,024,
32/8 heads, hd 128, causal; recurrentgemma's: 16/1 heads, hd 256,
window 2,048), one JSON line each: the first design's dq, dk, dv held to
the wrapper's within ``chip_smoke.ATTN_TOL`` of the dtype x max(1,
largest |value|) of each gradient, then the wrapper (the source its route
table picks), the first design (``csrc/flash_attention_bwd.cu``'s
launcher on the same tensors) and the wrapper again, timed in turns in
this process: the median CUDA-event time and the device time of each
kernel from ``torch.profiler`` (``chip_smoke.timed_ms`` and
``device_ms``).

With ``--sass`` it first prints, for each kernel of a source in ``SASS``
(the float32 one), the count of each SASS opcode ``cuobjdump -sass``
shows in an ``nvcc -cubin`` of it (static counts: an instruction in a
loop counts once): ``HMMA`` beside the instructions that split its
operands, and any ``WARPSYNC`` (an ``mma.sync`` under a branch).

With ``--parts`` it also times, at recurrentgemma's train shape in bf16,
the tensor-core backward at every count of head parts in ``PARTS``
through the launcher's ``parts`` argument (the wrapper's rule,
``flash_attention.bwd_head_parts``, picks one), each result held to the
wrapper's as above.

The kernels against their plain version, at every case, and SDPA's
backward beside them are ``chip_smoke.py --phases flash_attention_bwd``.
A kernel's mbarrier wait traps after a bounded number of polls, so a
hang becomes a CUDA error; run it under ``timeout`` as well.
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

import chip_smoke as cs  # noqa: E402

#: the tensor-core sources (bf16, float32) and the first design
SOURCES = ("flash_attention_bwd_sm90.cu", "flash_attention_bwd_tf32x3.cu",
           "flash_attention_bwd.cu")
#: the cases of chip_smoke.FLASH_BWD_CASES timed here, in each dtype
TIMED = ("train", "rglru_train")
DTYPES = ("bfloat16", "float32")
#: the sources whose SASS ``--sass`` counts
SASS = ("flash_attention_bwd_tf32x3.cu",)
#: counts of head parts timed at recurrentgemma's train shape
PARTS = (1, 2, 3, 4, 6, 8, 16)


def ptxas_report(name: str) -> str:
    from repro_torch.kernels import _build
    out = subprocess.run([_build.find_nvcc(), *_build.FLAGS, "-Xptxas", "-v",
                          "-o", "/dev/null", str(_build.CSRC / name)],
                         capture_output=True, text=True, timeout=300)
    return f"== {name}\n{out.stdout}{out.stderr}"


def sass_counts(name: str) -> list:
    """[{kernel, instructions, opcodes}] of each function in the SASS of
    ``csrc/<name>`` (``nvcc -cubin``, then ``cuobjdump -sass``); opcodes
    without their modifiers, most frequent first."""
    import collections
    import re
    import tempfile

    from repro_torch.kernels import _build
    nvcc = pathlib.Path(_build.find_nvcc())
    flags = [f for f in _build.FLAGS if f not in ("-shared", "-Xcompiler",
                                                  "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = pathlib.Path(tmp) / "k.cubin"
        subprocess.run([str(nvcc), *flags, "-cubin", "-o", str(cubin),
                        str(_build.CSRC / name)], check=True, timeout=300,
                       capture_output=True)
        sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                               str(cubin)], check=True, capture_output=True,
                              text=True, timeout=120).stdout
    rows = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = collections.Counter(
            m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                part))
        rows.append({"kernel": part.split("\n", 1)[0].strip(),
                     "instructions": sum(ops.values()),
                     "opcodes": dict(ops.most_common())})
    return rows


def held(torch, got, want, where: str, dname: str) -> dict:
    """Each of dq, dk, dv within ``ATTN_TOL`` of ``dname`` x max(1,
    largest |value| of ``want``'s); its max abs error relative to that
    scale."""
    errs = {}
    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
        err, scale = cs._bwd_err([a], [w])
        cs._hold(f"flash_attention_bwd {gname}", err, dname, where, scale)
        errs[gname] = err / max(1.0, scale)
    return errs


def by_kernel(torch, fn) -> dict:
    """Median CUDA-event ms of ``fn()``, and the device ms of each
    backward kernel it ran."""
    out = {"ms": cs.timed_ms(torch, fn, 10)}
    for name in cs.FLASH_BWD_KERNELS:
        ms, _ = cs.device_ms(torch, fn, (name,), 10)
        if ms is not None:
            out[f"{name}_device_ms"] = ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name in SOURCES:
        print(ptxas_report(name), flush=True)
    if args.sass:
        for name in SASS:
            for row in sass_counts(name):
                print(json.dumps({"source": name, **row}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for dname, case in ((d, c) for d in DTYPES
                        for c in cs.FLASH_BWD_CASES):
        name, b, h, hkv, sq, sk, hd, causal, window, _ = case
        if name not in TIMED:
            continue
        dt = getattr(torch, dname)
        q, do = (torch.randn(b, sq, h, hd, generator=g,
                             device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn(b, sk, hkv, hd, generator=g,
                            device=dev).to(dt) for _ in range(2))
        with torch.no_grad():
            o = fa.flash_attention_bshd(q, k, v, causal=causal,
                                        window=window)
        outs = [torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(k)]

        def kern():
            return fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                          window=window)

        def first():
            fa._bwd_cuda_cores(q, k, v, o, do, *outs, causal, window)

        want = kern()
        first()
        torch.cuda.synchronize()
        row = {"case": name, "dtype": dname, "shape": [b, sq, h, hkv, hd],
               "causal": causal, "window": window,
               "source": fa.flash_attention_bwd.source,
               "head_parts": fa.flash_attention_bwd.head_parts,
               "first_design_rel_err_vs_kernel":
               held(torch, outs, want, f"{name} first design", dname)}
        for key, fn in (("kernel", kern), ("first_design", first),
                        ("kernel_again", kern)):
            row[key] = by_kernel(torch, fn)
        print(json.dumps(row), flush=True)
        if not (args.parts and name == "rglru_train"
                and dname == "bfloat16"):
            continue
        for parts in PARTS:
            got = [torch.empty_like(t) for t in outs]

            def split(parts=parts, got=got):
                fa._bwd_sm90(q, k, v, o, do, *got, causal, window,
                             parts=parts)
            split()
            torch.cuda.synchronize()
            print(json.dumps({"case": name, "head_parts": parts,
                              "rel_err_vs_kernel": held(
                                  torch, got, want, f"{name} G={parts}",
                                  dname),
                              **by_kernel(torch, split)}), flush=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
