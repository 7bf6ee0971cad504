#!/usr/bin/env python3
"""Report what ``ptxas`` makes of the mLSTM backward's kernels, and time
each tensor-core backward against the first design, kernel by kernel, on
one CUDA card.

    python3 tools/mlstm_bwd_check.py [--first-only]

Run from the root of a checkout.  The first line is ``nvidia-smi``'s
name and power limit.  Then what ``nvcc -Xptxas -v`` says of
``csrc/mlstm_kernel_bwd_sm90.cu`` (bf16 on the tensor cores),
``csrc/mlstm_kernel_bwd_tf32x3.cu`` (float32 on the tensor cores, split
TF32) and ``csrc/mlstm_kernel_bwd.cu`` (the first design: float32 sums on
the CUDA cores, for both dtypes) — registers, shared memory and spills of
each kernel.  Then, for bf16 and for float32 q, k, v, dh at xlstm's train
shape (``SHAPE``: BH = 16, S = 1,024, hd = 1,024; no initial carry and no
final-state gradient, as the model's train step calls it), one JSON line
each: the route's seven gradients held to the first design's on the same
tensors (max abs error within ``chip_smoke.ATTN_TOL`` of the dtype x
max(1, largest |value|), and ||got - want|| / ||want|| within
``chip_smoke.ATTN_BWD_REL_NORM``), then the wrapper, the first design and
the wrapper again, and the first design once more, timed in turns in this
process: the median CUDA-event ms of a call and the device ms of each of
its kernels from ``torch.profiler`` (``chip_smoke.timed_ms`` and
``device_ms``, by kernel name).

``--first-only`` times only the first design (no tensor-core source is
built or run), in bf16: the per-kernel split of the design the
tensor-core ones replace.

Every case against the plain version is ``chip_smoke.py --phases
mlstm_chunkwise_bwd``.
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
SOURCES = ("mlstm_kernel_bwd_sm90.cu", "mlstm_kernel_bwd_tf32x3.cu",
           "mlstm_kernel_bwd.cu")
#: xlstm_1_3b's train shape: (BH, S, hd)
SHAPE = (16, 1024, 1024)
GRADS = ("dq", "dk", "dv", "di_raw", "df_raw", "dc0", "dn0")


def ptxas_report(name: str) -> str:
    from repro_torch.kernels import _build
    out = subprocess.run([_build.find_nvcc(), *_build.FLAGS, "-Xptxas", "-v",
                          "-o", "/dev/null", str(_build.CSRC / name)],
                         capture_output=True, text=True, timeout=300)
    return f"== {name}\n{out.stdout}{out.stderr}"


def by_kernel(torch, fn, names) -> dict:
    """Median CUDA-event ms of ``fn()``, and the device ms of each of
    ``names`` that it ran."""
    out = {"ms": cs.timed_ms(torch, fn, 5, 2)}
    total = 0.0
    for name in names:
        ms, _ = cs.device_ms(torch, fn, (name,), 5)
        if ms is not None:
            out[f"{name}_device_ms"] = ms
            total += ms
    out["device_ms"] = total
    return out


def compare(torch, mk, dtype, smi: str, first_only: bool) -> dict:
    """One dtype at ``SHAPE``: the route against the first design on the
    same tensors, then both timed in turns, kernel by kernel."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    bh, s, hd = SHAPE
    dname = cs._dname(torch, dtype)
    q, k, v, dh = (torch.randn(bh, s, hd, generator=g, device=dev)
                   .mul(0.3).to(dtype) for _ in range(4))
    ig = torch.randn(bh, s, generator=g, device=dev)
    fg = torch.randn(bh, s, generator=g, device=dev) + 2.0
    ins = (q, k, v, dh, ig, fg, None, None, None, None)
    first_out = [torch.empty_like(q) for _ in range(3)] + [
        torch.empty_like(ig), torch.empty_like(fg),
        torch.empty(bh, hd, hd, device=dev), torch.empty(bh, hd, device=dev)]

    def first():
        err = mk._bwd_cuda_cores(*ins, *first_out)
        if err:
            raise RuntimeError(f"mlstm_kernel_bwd.cu: CUDA error {err}")

    def kern():
        return mk.mlstm_chunkwise_bwd(q, k, v, ig, fg, None, None, dh)

    first()
    torch.cuda.synchronize()
    row = {"shape": {"BH": bh, "S": s, "hd": hd, "dtype": dname},
           "card": smi}
    runs = [("first_design", first, cs.MLSTM_BWD_KERNELS_CUDA_CORES)]
    if not first_only:
        source = mk.bwd_source(dtype, hd)
        got = [x for part in kern() for x in part]
        torch.cuda.synchronize()
        if mk.mlstm_chunkwise_bwd.source != source:
            raise AssertionError(f"{dname} at hd {hd} ran "
                                 f"{mk.mlstm_chunkwise_bwd.source}")
        held = {}
        for gname, a, w in zip(GRADS, got, first_out):
            err, scale = cs._bwd_err([a], [w])
            cs._hold(f"mlstm_chunkwise_bwd {gname}", err, dname, SHAPE,
                     scale)
            rel = cs.rel_norm(torch, a, w)
            if not rel <= cs.ATTN_BWD_REL_NORM[dname]:
                raise AssertionError(f"{gname}: ||got - want|| / ||want|| "
                                     f"{rel} against the first design")
            held[gname] = {"max_abs_err": err, "scale": scale,
                           "rel_norm_err": rel}
        row["source"] = source
        row["kernel_vs_first_design"] = held
        del got
        k_names = cs.MLSTM_BWD_KERNELS_BY_SOURCE[source]
        runs = [("kernel", kern, k_names)] + runs + [
            ("first_design_again", first, cs.MLSTM_BWD_KERNELS_CUDA_CORES),
            ("kernel_again", kern, k_names)]
    for key, fn, names in runs:
        row[key] = by_kernel(torch, fn, names)
        print(json.dumps({"dtype": dname, key: row[key]}), flush=True)
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--first-only", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mlstm_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import mlstm_kernel as mk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name in SOURCES[2:] if args.first_only else SOURCES:
        print(ptxas_report(name), flush=True)
    compare(torch, mk, torch.bfloat16, smi, args.first_only)
    if not args.first_only:
        torch.cuda.empty_cache()
        compare(torch, mk, torch.float32, smi, False)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
