#!/usr/bin/env python3
"""Report what ``ptxas`` makes of the float32 mLSTM forward's kernels, and
time the split-TF32 forward against the first design, kernel by kernel,
on one CUDA card.

    python3 tools/mlstm_fwd_check.py

Run from the root of a checkout.  The first line is ``nvidia-smi``'s
name and power limit.  Then what ``nvcc -Xptxas -v`` says of
``csrc/mlstm_kernel_tf32x3.cu`` (float32 on the tensor cores, split TF32)
and ``csrc/mlstm_kernel.cu`` (the first design: float32 FMAs on the CUDA
cores) — registers, shared memory and spills of each kernel.  Then, for
float32 q, k, v at xlstm's train shape (BH = 16, S = 1,024, hd = 1,024)
and at train_parity_xlstm's (BH = 8, S = 200, hd = 1,024; no initial
carry, as the model calls it), one JSON line each: h, C and n of the
route held to the first design's on the same tensors (max abs error
within ``chip_smoke.ATTN_TOL`` x max(1, largest |value|), and ||got -
want|| / ||want|| within ``chip_smoke.ATTN_BWD_REL_NORM``), then the
wrapper, the first design, the first design again and the wrapper again,
timed in turns in this process: the median CUDA-event ms of a call and
the device ms of each of its kernels from ``torch.profiler``
(``chip_smoke.timed_ms`` and ``device_ms``, by kernel name).

Every case against the plain version is ``chip_smoke.py --phases
mlstm_chunkwise``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mlstm_bwd_check import by_kernel, ptxas_report  # noqa: E402

#: the split-TF32 source and the first design
SOURCES = ("mlstm_kernel_tf32x3.cu", "mlstm_kernel.cu")
#: xlstm_1_3b's train shape and train_parity_xlstm's: (BH, S, hd)
SHAPES = ((16, 1024, 1024), (8, 200, 1024))


def compare(torch, mk, shape, smi: str) -> dict:
    """One shape: the route against the first design on the same
    tensors, then both timed in turns, kernel by kernel."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    bh, s, hd = shape
    q, k, v = (torch.randn(bh, s, hd, generator=g, device=dev).mul(0.3)
               for _ in range(3))
    ig = torch.randn(bh, s, generator=g, device=dev)
    fg = torch.randn(bh, s, generator=g, device=dev) + 2.0
    args = (q, k, v, ig, fg, None, None)
    first = cs._mlstm_first_design(torch, mk, args)

    def kern():
        return mk.mlstm_chunkwise(*args)

    source = mk.fwd_source(torch.float32, hd)
    got = kern()
    want = first()
    torch.cuda.synchronize()
    if mk.mlstm_chunkwise.source != source:
        raise AssertionError(f"hd {hd} ran {mk.mlstm_chunkwise.source}")
    row = {"shape": {"BH": bh, "S": s, "hd": hd, "dtype": "float32"},
           "card": smi, "source": source}
    held = {}
    for name, a, w in zip(("h", "C", "n"), (got[0], *got[1]),
                          (want[0], *want[1])):
        err, scale = cs._err(a, w), float(w.abs().max())
        cs._hold(f"mlstm_chunkwise {name}", err, "float32", shape, scale)
        rel = cs._hold_rel_norm(torch, f"mlstm_chunkwise {name}", a, w,
                                "float32", shape)
        held[name] = {"max_abs_err": err, "scale": scale,
                      "rel_norm_err": rel}
    row["kernel_vs_first_design"] = held
    del got, want
    k_names = cs.MLSTM_KERNELS_BY_SOURCE[source]
    f_names = cs.MLSTM_KERNELS_BY_SOURCE[mk.FWD_CUDA_CORES]
    turns = [("kernel", kern, k_names), ("first_design", first, f_names),
             ("first_design_again", first, f_names),
             ("kernel_again", kern, k_names)]
    for key, fn, names in turns:
        row[key] = by_kernel(torch, fn, names)
        print(json.dumps({"shape": shape, key: row[key]}), flush=True)
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mlstm_fwd_check: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import mlstm_kernel as mk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name in SOURCES:
        print(ptxas_report(name), flush=True)
    for shape in SHAPES:
        compare(torch, mk, shape, smi)
        torch.cuda.empty_cache()
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
