#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold it to its plain
versions.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and ``nvcc``,
imports only ``repro_torch``, ``torch``, numpy and the standard library,
and catches nothing: any mismatch raises and the exit code is non-zero.
One JSON line per phase:

1. device — the card, ``nvidia-smi``'s name and power limit, versions;
2. build — the eleven CUDA sources (the six kernels, the two attention
   backwards and the empty ``launch_floor`` kernel) compiled from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each, in parallel);
3. launch_floor — an empty kernel launched through the same ctypes
   route, timed: what one launch costs, beside every bytes bound;
4. minskew — kernel vs plain version on the card, bit-equal, timed at
   the main path's (V=1, N=16,384, S=1), (1, 16,384, 256),
   (8, 4,096, 64) and the main-path campaign's (32, 16,384, 1), the edge cases of tests/test_kernels.py, a sequence
   of calls of growing and shrinking size, and one device operation a
   call (the profiler sees only the kernel, no fill);
5. hub_route — the same at the main path's M=65,600 and M=2^20, one
   link for 2^20 messages, M around a tile, a sequence of sizes (the
   kept scratch under smaller and larger calls), the float32 pin;
6. main path — a 16,384-vtask ``ChipRingTraining`` (16 pods x 1,024
   chips on 16 hosts) through ``Simulation.run(engine="vectorized")``
   on the card, with every kernel launch counter set to 0 just before
   and read just after, and its report equal to the same run on the CPU;
   then the same path stage by stage (compile, round loop, decompile)
   with the card's busy time in the loop from ``torch.profiler``;
7. sweep — the 64-variant ``RackRing`` straggler sweep on the card, each
   lane equal to the same sweep on the CPU (plain versions, ``links``
   included), to its solo run, and four lanes to the ``async`` engine;
8. check_interval — the round loop of the main path and of the sweep
   timed with the stop condition read back every 1, 4 and 16 rounds;
9. campaign_main — a fault campaign over the main path
   (``Campaign(engine="auto")``): one straggler chip (3x) in every
   fourth pod of the 16, alone or four pods at once, 8 points; the
   baseline on the reference engine, then every point through the
   sweep fast path on the card (both engine kernels launched), every
   swept lane's report (vtimes included) and the campaign's report
   equal to the same campaign's on the CPU;
10. campaign — the registry's ``rack_ring@v1`` with its grid: the
   sweepable points on the card, the clock-skew points on the reference
   engine ("mixed"), the JAX package's histogram, the 16 swept lanes'
   reports and the reproducer bytes equal to the CPU run's; then, with CUDA initialised in this process, the
   dist engine's forked workers: ``python -m repro_torch.dist``'s smoke
   (dist:2 equal to async) and the campaign on ``engine="dist"`` (2
   workers), its reproducer bytes equal to ``engine="async"``;
11. flash_attention — kernel vs plain version at the serving path's
   prefill shape (B=4, S=1024, H=32, Hkv=8, hd=128, causal), at S=4096
   and at the edge shapes of tests/test_kernels.py, bfloat16 and
   float32, timed beside ``scaled_dot_product_attention`` (with a
   boolean band mask where a window applies), at recurrentgemma_9b's
   prefill shape (B=4, S=3,072, H=16, Hkv=1, hd=256, window 2,048) and
   at seamless_m4t_medium's three (B=4, 16/16 heads, hd 64: the encoder's
   256 frames, non-causal; the cross-attention's 1,024 queries against
   256 frames; the decoder's 1,024 causal); untimed at olmoe_1b_7b's
   prefill (16/16 heads, hd 128), at hd 8, 24 and 40, one query row,
   Sq < Sk under the causal mask and a window narrower than a key tile,
   and through ``ops.flash_attention`` on non-contiguous (B, S, H, hd)
   views;
11b. flash_attention_bwd — the attention backward kernels vs their plain
   version (``attention_flat_bwd_plain``): bfloat16 up to hd 128 on the
   tensor cores (``csrc/flash_attention_bwd_sm90.cu``), float32 and hd
   256 on the CUDA cores (``csrc/flash_attention_bwd.cu``), each case
   with the source that ran; at the trainer's shape (B=4, S=1,024, 32/8
   heads, hd 128, causal; bfloat16 and float32, timed beside SDPA's
   backward, two calls bit-equal), at the shapes the other families'
   train steps give it (timed the same way: seamless_m4t_medium's
   cross-attention, 1,024 queries over 256 frames, non-causal, its
   encoder's 256 frames, non-causal, and its decoder's 1,024 causal, all
   16/16 heads at hd 64; olmoe_1b_7b's 16/16 heads at hd 128, causal),
   recurrentgemma's window shape (MQA, hd 256, window 2,048) and the
   edge shapes (hd 8/24/40/64/96, Sq < Sk, Sq and Sk off the tiles, GQA
   8, windows 5 and 40, Sk = 0), and through ``ops.flash_attention``
   under autograd on non-contiguous views;
12. decode_attention — the same at the decode shape (B=4, H=32, Hkv=8,
   hd=128, S=1056, ragged lengths), at S=8192, at recurrentgemma's
   ring buffer (S=2,048, MQA, hd 256), at seamless_m4t_medium's self
   cache (S=1,056, 16/16 heads, hd 64, lengths 1,025-1,055) and cross
   cache (256 frames, all valid), untimed at olmoe_1b_7b's cache (16/16
   heads, hd 128), and the edge shapes: lengths on
   and either side of the split kernel's chunk boundaries, a length-0
   row among full rows, lengths above S, qpk = 1;
13. rglru_scan — the chained scan kernel vs plain version at
   recurrentgemma's prefill shape (B=4, S=3,072, W=4,096, timed, and
   with h0), a long-chain shape (B=1, S=16,384, W=1,024; the kernel
   timed, the plain loop over S timed once), odd W
   with S not a multiple of the chunk, S = 1, S below one chunk and
   tests/test_kernels.py's shapes (padded S, h0), float32; each case
   with the kernel's T_c, W_t and grid, and two calls at the prefill
   shape bit-equal;
14. mlstm_chunkwise — kernel vs plain version at xlstm's prefill shape
   (BH=16, S=1,024, hd=1,024), bfloat16 (the tensor-core kernel) and
   float32 (the first design), and edge shapes (S not a multiple of the
   chunk, an initial carry, small hd, in bfloat16 a head dim above the
   tensor-core kernel's limit), with the final (C, n) and the source
   that ran;
15. serve — the serving path: ``BatchServer`` on full-width, full-depth
   qwen3_4b in bfloat16 (random weights from a seed), 4 prompts of 1,024
   tokens, 32 new tokens; one warm-up ``generate`` and 3 timed ones,
   each with the kernel counters set to 0 just before and read just
   after; then one profiled ``generate`` and 8 profiled decode steps;
16. serve_parity — the same entry point at full width, 2 layers,
   float32: the card's logits and greedy tokens against the CPU run of
   the same parameters (the plain versions);
17. serve_rglru, serve_xlstm — the same serving phase on full-width,
   full-depth recurrentgemma_9b (4 prompts of 3,072 tokens, past the
   2,048 window) and xlstm_1_3b (4 prompts of 1,024 tokens), 32 new
   tokens each, every kernel's launches per ``generate`` checked;
18. serve_parity_rglru, serve_parity_xlstm — card against CPU at full
   width, float32, cut depth: recurrentgemma (rec, rec, attn) with
   prompts of 2,080 tokens, which wrap the window; xlstm one mLSTM and
   one sLSTM block with prompts of 200 tokens, which the kernel pads;
19. live_serve — ``record_live_serve`` on the card (smoke config), its
   trace replayed bit-identically under the barrier and async engines;
19b. serve_moe, serve_vlm, serve_encdec — the same serving phase on
   full-width, full-depth olmoe_1b_7b (64 experts, top 8; the slots its
   prefill drops counted), pixtral_12b (512 patch embeddings of width
   1,024 from a seed) and seamless_m4t_medium (256 audio frames of width
   1,024 from a seed), 4 prompts of 1,024 tokens, 32 new tokens each,
   every kernel's launches per ``generate`` checked (flash 16, 40 and
   36, decode 496, 1,240 and 744); each phase frees its parameters and
   cache before the next;
19c. serve_parity_moe, serve_parity_vlm, serve_parity_encdec — card
   against CPU at full width, float32, 2 layers (seamless: 2 encoder and
   2 decoder layers), 2 prompts of 128 tokens with their frontend
   embeddings, 8 new; the MoE's dropped-slot mask of the first layer's
   prefill equal on both sides and non-empty;
20. train — the training path: ``Trainer`` on full-width, full-depth
   qwen3_4b in bfloat16 (remat, AdamW, global batch 4 of 1,024 tokens),
   one warm-up step and four timed ones, each with the kernel counters
   set to 0 just before and read just after (attention forward twice a
   layer, backward once, nothing else); one profiled step (idle share,
   top device operations); every parameter's gradient present and
   finite; peak memory;
21. train_parity — three train steps at full width, 2 layers, float32,
   on the card and on the CPU from the same parameters and batches:
   losses, grad norms, parameters and AdamW moments within 1e-4;
21b. train_moe, train_vlm, train_encdec, each followed by its
   train_parity_* phase — the train phase on olmoe_1b_7b (10 of its 16
   layers; the slots its warm-up step drops counted), pixtral_12b (12 of
   40 layers; 512 patch embeddings) and seamless_m4t_medium (whole: 12 +
   12 layers; 256 audio frames) at full width, bfloat16, global batch 4
   of 1,024 tokens, one warm-up, two timed and one profiled step, the
   launches of every step exact (seamless: its encoder's attention, and
   its decoder's self- and cross-attention); then two train steps card
   against CPU at full width in float32 (olmoe 2 layers, pixtral 1,
   seamless 1 + 1; 2 x 128 tokens with 64 patches or frames) within
   1e-4, olmoe's first layer dropping the same slots on both sides;
22. live_recovery, live_colocated — ``record_live_recovery`` and
   ``record_live_colocated`` on the card (smoke config): the real trainer
   loses a host, restores a committed checkpoint and re-meshes (ordered
   timeline), or shares a cell with the real server (non-empty
   latencies); each trace replayed bit-identically under the barrier and
   async engines;
23. kernels — one object per kernel: launches on its paths (the main
   path and the sweep for ``minskew`` and ``hub_route``, the train paths
   for the attention backward), max error against the plain version,
   times, the card's bound, the library call's time and, for the
   engine's two kernels, the launch floor.

It uses one card: the first visible one (``CUDA_VISIBLE_DEVICES`` is
narrowed to it before CUDA starts).

The last line is ``{"ok": true, "device": {...}}``.  ``*_ms`` times are
CUDA-event medians over single calls after warm-up (what a caller waits,
launch overhead included); ``*_batch_ms`` are CUDA-event times of 20
back-to-back calls over 20; ``*_device_ms`` are the kernels' own device
time per call from ``torch.profiler`` (null where it saw none);
``bound_ms`` is the larger of the bytes the function must move over the
card's 3.35 TB/s and its operations over the card's peak for their type
(989 TFLOP/s bfloat16 on the tensor cores, 67 TFLOP/s float32).  All on
the card named in phase 1.
"""
from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM HBM3 rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense peaks (NVIDIA data sheet), operations per second
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: kernel-vs-plain tolerance on the card, absolute, per dtype: bfloat16
#: outputs are rounded once to bfloat16 (2^-8 relative on values of
#: order 1); float32 differ only by the order of the float32 sums.  The
#: recurrences hold it relative to max(1, largest |plain value|).
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: timed calls per measurement, after warm-up
ITERS = 30
WARMUP = 5
#: fields every engine must agree on (tests/engine_harness.py CORE_FIELDS)
CORE_FIELDS = ("status", "n_hosts", "vtime_ns", "messages", "bytes",
               "tasks", "progress", "cells", "live")


#: the script's start on the host clock
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``at_s`` is the host time since the script started,
    so consecutive lines show where the run's wall time goes."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - T0,
                      **fields}), flush=True)


def timed_ms(torch, fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median CUDA-event time of ``fn()`` in ms."""
    for _ in range(warmup):
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


def batch_ms(torch, fn, n: int = 20) -> float:
    """CUDA-event time of ``n`` back-to-back calls of ``fn()`` over
    ``n``, in ms: the device's time per call where the host enqueues
    faster than the card runs (no host gap between calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(torch, fn, names=None, iters: int = 20):
    """Device time per call of ``fn()`` in ms from ``torch.profiler``,
    and the profiler's records per call.

    Without ``names``: the summed duration of every CUDA kernel it ran,
    over the calls.  With ``names`` (the port's kernels, each launched
    once per call): the sum over those kernels of the mean duration of
    the records the profiler kept, since it keeps only some records of
    a kernel launched through ctypes.  None where it saw no device
    time."""
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
           and e.self_device_time_total > 0
           and (names is None or any(n in e.key for n in names))]
    records = sum(e.count for e in evs) / iters
    if not evs:
        return None, records
    if names is None:
        us = sum(e.self_device_time_total for e in evs) / iters
    else:
        us = sum(e.self_device_time_total / e.count for e in evs)
    return us / 1e3, records


MINSKEW_KERNELS = ("minskew_cluster_kernel",)
HUB_KERNELS = ("hub_lookback_kernel",)


def one_device_op(torch, fn, names, calls: int = 40,
                  windows: int = 5) -> float:
    """Holds ``fn`` to one device operation a call: over ``calls`` calls
    every device record the profiler kept is one of ``names`` (no fill,
    no memset, no copy) and there are at most ``calls`` of them; returns
    the records per call.  It keeps only some records of a kernel
    launched through ctypes, so the records' names and their count are
    checked, never a single record; now and then it keeps none in a
    window, which shows nothing either way, so such a window is taken
    again, up to ``windows`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
        if not seen:
            continue
        if (sum(seen.values()) > calls
                or any(not any(n in k for n in names) for k in seen)):
            raise AssertionError(f"not one device operation a call: {seen}")
        return sum(seen.values()) / calls
    raise AssertionError(f"not one device operation a call: no device "
                         f"record in {windows} windows of {calls} calls")


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(torch, got, want) -> int:
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


# ---------------------------------------------------------------- inputs


def sched_membership(np, n: int, s: int):
    """BENCH_sched's pattern: vtask i in scope i % S, every 7th vtask
    also in (i + 1) % S (benchmarks/sched_scale.py)."""
    m = np.zeros((n, s), np.int8)
    idx = np.arange(n)
    m[idx, idx % s] = 1
    sev = idx[idx % 7 == 0]
    m[sev, (sev + 1) % s] = 1
    return m


def minskew_inputs(np, rng, v: int, n: int, s: int):
    """~10% INF-sentinel vtimes, ~70% runnable, BENCH_sched membership."""
    from repro_torch.kernels.ref import INF
    vt = rng.integers(0, 1_000_000, (v, n)).astype(np.int32)
    vt[rng.random((v, n)) < 0.1] = INF
    run = (rng.random((v, n)) < 0.7).astype(np.int8)
    mem = np.broadcast_to(sched_membership(np, n, s), (v, n, s)).copy()
    skew = rng.integers(0, 50_000, (v, s)).astype(np.int32)
    return vt, run, mem, skew


def minskew_edge_cases(np, rng):
    """The edge cases of tests/test_kernels.py's minskew section."""
    from repro_torch.kernels.ref import INF
    cases = []
    n, s = 40, 6                                    # all masked
    cases.append(("all_masked", rng.integers(0, 10_000, n),
                  np.zeros(n), rng.random((n, s)) < 0.4,
                  rng.integers(1, 500, s)))
    n, s = 24, 4                                    # empty scope
    mem = rng.random((n, s)) < 0.5
    mem[:, 2] = False
    cases.append(("empty_scope", rng.integers(0, 10_000, n), np.ones(n),
                  mem, np.zeros(s)))
    n, s = 16, 3                                    # sentinel vtimes
    vt = rng.integers(0, 10_000, n)
    vt[::2] = INF
    run = np.ones(n)
    run[::2] = 0
    cases.append(("sentinel", vt, run, np.ones((n, s)),
                  rng.integers(1, 100, s)))
    n, s = 12, 2                                    # int32 boundary
    cases.append(("int32_boundary", INF - 1 - rng.integers(0, 2_000, n),
                  np.ones(n), np.ones((n, s)), np.full(s, 5_000)))
    cases.append(("tiny_1x1", [7], [1], [[1]], [0]))
    cases.append(("tiny_3x2", rng.integers(0, 100, 3), [1, 0, 1],
                  rng.random((3, 2)) < 0.5, [10, 20]))
    return [(name, np.asarray(a, np.int32)[None], np.asarray(b, np.int8)[None],
             np.asarray(c, np.int8)[None], np.asarray(d, np.int32)[None])
            for name, a, b, c, d in cases]


def hub_inputs(np, rng, m: int, n_links: int, one_per_link: bool = False,
               ser_hi: int = 10_000):
    """Messages sorted by (link, send); durations below ``ser_hi``, ~20%
    of them 163.  A link's summed durations must stay within int32 (the
    function's domain), so one link for many messages takes a lower
    ``ser_hi``."""
    if one_per_link:
        link = np.arange(m, dtype=np.int32)
    else:
        link = np.sort(rng.integers(0, n_links, m)).astype(np.int32)
    send = rng.integers(0, 1_000_000, m).astype(np.int32)
    order = np.lexsort((send, link))
    send, link = send[order], link[order]
    ser = rng.integers(0, ser_hi, m).astype(np.int32)
    ser[rng.random(m) < 0.2] = 163
    lat = rng.integers(0, 5_000, n_links).astype(np.int32)
    return send, ser, link, lat


# ---------------------------------------------------------------- phases


def use_one_card() -> str:
    """Narrow ``CUDA_VISIBLE_DEVICES`` to its first entry (card 0 when
    unset); must run before CUDA starts.  Returns that entry."""
    first = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    return first


def phase_device(torch, card: str):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in paths])


def phase_launch_floor(torch, dev) -> float:
    """An empty kernel (``csrc/launch_floor.cu``) launched through the
    same ctypes route as the port's kernels: the least a launch costs on
    this card.  Returns its device ms."""
    import ctypes

    from repro_torch.kernels import _build
    fn = _build.load("launch_floor").launch_floor_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call():
        err = fn(_build.stream_ptr(torch, dev))
        if err != 0:
            raise RuntimeError(f"launch_floor: CUDA error {err}")
    dms = device_ms(torch, call, ("launch_floor_kernel",))[0]
    emit("launch_floor", call_ms=timed_ms(torch, call),
         batch_ms=batch_ms(torch, call), device_ms=dms)
    return dms


def check_minskew(torch, np, dev, vt, run, mem, skew):
    """Kernel vs plain version on ``dev``; returns (err, tensors)."""
    from repro_torch.kernels.minskew import minskew
    from repro_torch.kernels.ref import minskew_plain
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
         for x in (vt, run, mem, skew)]
    got = minskew(*t)
    want = minskew_plain(*t)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    if err != 0:
        raise AssertionError(f"minskew kernel != plain at shape "
                             f"{tuple(mem.shape)}: max abs err {err}")
    return err, t


def minskew_bytes(v: int, n: int, s: int) -> int:
    # in: vtime 4, runnable 1, membership 1 per (n, s), skew 4; out:
    # minima 4, elig 1
    return v * (4 * n + n + n * s + 4 * s + 4 * s + n)


def phase_minskew(torch, np, dev, floor_ms: float):
    from repro_torch.kernels.minskew import minskew, plan
    from repro_torch.kernels.ref import minskew_plain
    rng = np.random.default_rng(0)
    shapes = []
    # the main path's, a wide scope set, the sweep's cluster plan, the
    # main-path campaign's sweep
    for v, n, s in ((1, 16_384, 1), (1, 16_384, 256), (8, 4_096, 64),
                    (32, 16_384, 1)):
        err, t = check_minskew(torch, np, dev,
                               *minskew_inputs(np, rng, v, n, s))
        again = minskew(*t)
        if not all(torch.equal(a, b) for a, b in zip(again, minskew(*t))):
            raise AssertionError(f"minskew at {(v, n, s)}: two calls differ")
        shapes.append({
            "V": v, "N": n, "S": s, "max_abs_err": err,
            "cluster": plan(v, n, s).cluster,
            "kernel_ms": timed_ms(torch, lambda: minskew(*t)),
            "kernel_batch_ms": batch_ms(torch, lambda: minskew(*t)),
            "plain_ms": timed_ms(torch, lambda: minskew_plain(*t)),
            "kernel_device_ms": device_ms(torch, lambda: minskew(*t),
                                          MINSKEW_KERNELS)[0],
            "plain_device_ms": device_ms(torch,
                                         lambda: minskew_plain(*t))[0],
            "records_per_call": one_device_op(
                torch, lambda: minskew(*t), MINSKEW_KERNELS),
            "bound_ms": bound_ms(minskew_bytes(v, n, s)),
            "launch_floor_ms": floor_ms})
    for name, *arrs in minskew_edge_cases(np, rng):
        check_minskew(torch, np, dev, *arrs)
    # growing and shrinking V*N*S on one stream, each call bit-equal
    sequence = ((1, 16_384, 1), (8, 4_096, 64), (1, 3, 2), (1, 16_384, 256),
                (64, 16, 3), (2, 700, 2_100), (1, 16_384, 1))
    for v, n, s in sequence:
        check_minskew(torch, np, dev, *minskew_inputs(np, rng, v, n, s))
    emit("minskew", shapes=shapes, edge_cases="bit_equal",
         sequence=[list(x) for x in sequence], one_device_op=True)
    return shapes[0]


def hub_bytes(m: int, n_links: int) -> int:
    # in: send, ser, link (4 B each per message), lat (4 B per link);
    # out: 4 B per message
    return 16 * m + 4 * n_links


def phase_hub_route(torch, np, dev, floor_ms: float):
    from repro_torch.kernels.hub_route import TILE, hub_route
    from repro_torch.kernels.ref import hub_route_plain
    rng = np.random.default_rng(1)
    cases = [("main", 65_600, 16_416, False), ("large", 1 << 20, 4_096, False),
             ("one_link", 1 << 20, 1, False), ("m1", 1, 1, False),
             ("m7", 7, 1, False), ("m129", 129, 1, False),
             ("tile-1", TILE - 1, 3, False), ("tile+1", TILE + 1, 2, False),
             ("per_link", 4_099, 4_099, True),
             # the sequence: smaller calls over the kept scratch's stale
             # flags, then past its first capacity
             ("seq7", 7, 1, False), ("seq1", 1, 1, False),
             ("seq_large", 1 << 20, 4_096, False),
             ("seq_main", 65_600, 16_416, False),
             ("seq_grow", 9_000_000, 9_000, False),
             ("seq_main2", 65_600, 16_416, False)]
    shapes = []
    for name, m, n_links, one in cases:
        send, ser, link, lat = (
            torch.from_numpy(x).to(dev)
            for x in hub_inputs(np, rng, m, n_links, one,
                                min(10_000, 2**30 * n_links // m)))
        ones = torch.ones(n_links, dtype=torch.float32, device=dev)

        def call():
            return hub_route(send, ser, link, ones, lat, ser_ns=ser)
        got = call()
        want = hub_route_plain(send, ser, link, lat)
        err = max_abs_err(torch, got, want)
        if err != 0 or not torch.equal(got, call()):
            raise AssertionError(f"hub_route kernel != plain on {name}: "
                                 f"max abs err {err}, or two calls differ")
        if name in ("main", "large"):
            shapes.append({
                "case": name, "M": m, "links": n_links, "max_abs_err": err,
                "kernel_ms": timed_ms(torch, call),
                "kernel_batch_ms": batch_ms(torch, call),
                "plain_ms": timed_ms(torch, lambda: hub_route_plain(
                    send, ser, link, lat)),
                "kernel_device_ms": device_ms(torch, call, HUB_KERNELS)[0],
                "plain_device_ms": device_ms(torch, lambda: hub_route_plain(
                    send, ser, link, lat))[0],
                "records_per_call": one_device_op(torch, call, HUB_KERNELS),
                "bound_ms": bound_ms(hub_bytes(m, n_links)),
                "launch_floor_ms": floor_ms})
    # the float32 pin: 163 B at 1e9 B/s truncates to 162 on the f32
    # path and stays 163 with ser_ns
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    size = torch.tensor([163], dtype=torch.int32, device=dev)
    bw = torch.tensor([1e9], dtype=torch.float32, device=dev)
    f32 = int(hub_route(z, size, z, bw, z)[0])
    exact = int(hub_route(z, size, z, bw, z, ser_ns=size)[0])
    if (f32, exact) != (162, 163):
        raise AssertionError(f"163-ns pin: f32 {f32}, ser_ns {exact}")
    emit("hub_route", shapes=shapes, edge_cases="bit_equal",
         cases=[c[0] for c in cases], one_device_op=True,
         pin_f32=f32, pin_ser_ns=exact)
    return shapes[0]


#: the main path's size: pods (one host each) x chips per pod
MAIN_PODS, MAIN_CHIPS = 16, 1024
#: campaign_main's targets: a chip in every fourth pod (4 of 16, 8
#: points).  The cut from every pod (32 points) keeps the script inside
#: its time limit with the serving phases of the MoE, VLM and
#: encoder-decoder families: each point is a host compile of the main
#: path (2-5 s, with the host's pace)
CAMPAIGN_POD_STEP = 4


def main_path_sim(scenario=None):
    from repro_torch.core.cluster import ClusterSpec, StepCost
    from repro_torch.sim import ChipRingTraining, Simulation, Topology
    wl = ChipRingTraining(
        ClusterSpec(n_pods=MAIN_PODS, chips_per_pod=MAIN_CHIPS),
        StepCost(compute_ns=5_000_000, ici_bytes=50_000_000,
                 dcn_bytes=6_000_000), n_steps=4)
    return Simulation(
        Topology.full_mesh(MAIN_PODS, link=Topology().default_host_link),
        wl, scenario,
        placement={f"chip{i}": i // MAIN_CHIPS
                   for i in range(MAIN_PODS * MAIN_CHIPS)})


def strip_wall(report) -> dict:
    d = report.to_dict()
    d["wall_s"] = 0.0
    return d


def phase_main_path(torch, dev):
    from repro_torch.kernels.hub_route import hub_route
    from repro_torch.kernels.minskew import minskew
    minskew.launches = hub_route.launches = 0
    rep = main_path_sim().run(engine="vectorized", device=dev)
    launches = {"minskew": minskew.launches, "hub_route": hub_route.launches}
    if rep.status != "ok":
        raise AssertionError(f"main path status {rep.status}: {rep.detail}")
    if launches["minskew"] < rep.sync_rounds or launches["hub_route"] < 1:
        raise AssertionError(f"main path missed a kernel: {launches}, "
                             f"rounds {rep.sync_rounds}")
    cpu = main_path_sim().run(engine="vectorized", device="cpu")
    if strip_wall(rep) != strip_wall(cpu):
        raise AssertionError("main path: card report != CPU report")
    dispatches = sum(h.dispatches for h in rep.hosts)
    emit("main_path", vtasks=len(rep.tasks), status=rep.status,
         tier=rep.tier, tick_ns=rep.tick_ns, rounds=rep.sync_rounds,
         messages=rep.messages, vtime_ns=rep.vtime_ns, wall_s=rep.wall_s,
         cpu_wall_s=cpu.wall_s, dispatches=dispatches,
         dispatch_per_s=dispatches / rep.wall_s, launches=launches,
         equal_to_cpu=True)
    return launches


def phase_main_path_breakdown(torch, dev):
    """Where the main path's time goes, stage by stage (host clock with
    a synchronize at each stage's end), and how busy the card is in the
    round loop (profiler device time over the loop's wall time).  These
    launches come after the main path's counts were read."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine_torch as et
    from repro_torch.kernels.minskew import minskew
    from repro_torch.sim import vectorized as vz
    sim = main_path_sim()
    t0 = time.perf_counter()
    comp = vz.compile_simulation(sim)
    t1 = time.perf_counter()
    tape = et.tape_from_numpy(comp.tape, dev)
    st0 = et.init_vec_sim_state(tape, comp.n_channels)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    st = et.run_vec_tape(tape, st0, comp.max_rounds, kernel=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    rep = vz._decompile(sim, comp, st, t3 - t0, device=dev, kernel=True,
                        verify=False)
    t4 = time.perf_counter()
    minskew.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        et.run_vec_tape(tape, st0, comp.max_rounds, kernel=True)
        torch.cuda.synchronize()
        loop_prof_s = time.perf_counter() - tp
    by_kernel, _ = _device_kernels(
        prof, {k: minskew.launches for k in MINSKEW_KERNELS})
    busy_us = sum(by_kernel.values())
    kernels_us = {k: sum(us for n, us in by_kernel.items() if k in n)
                  for k in MINSKEW_KERNELS}
    emit("main_path_breakdown", compile_s=t1 - t0, to_device_s=t2 - t1,
         loop_s=t3 - t2, decompile_s=t4 - t3, rounds=rep.sync_rounds,
         loop_ms_per_round=(t3 - t2) * 1e3 / rep.sync_rounds,
         tape_shape=list(comp.tape["op_kind"].shape),
         channels=comp.n_channels,
         profiled_loop_s=loop_prof_s,
         device_busy_ms=busy_us / 1e3 if busy_us > 0 else None,
         device_idle_share=(1 - busy_us / 1e6 / loop_prof_s
                            if busy_us > 0 else None),
         minskew_device_ms={k: v / 1e3 for k, v in kernels_us.items()})


def sweep_make(scenario=None):
    """BENCH_sched's sweep base (benchmarks/sched_scale.py)."""
    from repro_torch.sim import RackRing, Simulation, Topology
    wl = RackRing(n_racks=4, hosts_per_rack=4, n_iters=128,
                  cross_every=8, skew_bound_ns=2_000_000)
    return Simulation(Topology.racks(4, 4), wl, scenario,
                      placement=wl.default_placement())


def phase_sweep(torch, dev, n_variants: int = 64, n_async: int = 4):
    from repro_torch.kernels.hub_route import hub_route
    from repro_torch.kernels.minskew import minskew
    from repro_torch.sim import Scenario, Straggler

    def axis_sc(i):
        return Scenario(f"v{i}", (Straggler(f"w{i % 16}",
                                            1.0 + (i % 7) * 0.5),))
    axis = [axis_sc(i) for i in range(n_variants)]
    minskew.launches = hub_route.launches = 0
    res = sweep_make().sweep(axis, device=dev)
    launches = {"minskew": minskew.launches, "hub_route": hub_route.launches}
    if launches["minskew"] < 1 or launches["hub_route"] < 1:
        raise AssertionError(f"sweep missed a kernel: {launches}")
    if res.tier != "exact" or len(res.reports) != n_variants:
        raise AssertionError(f"sweep: tier {res.tier}, "
                             f"{len(res.reports)} reports")
    # the CPU sweep runs the plain versions on the sweep's own inputs:
    # minskew at (V=64, N=16) and hub_route at RackRing's messages
    cpu = sweep_make().sweep(axis, device="cpu")
    for i, rep in enumerate(res.reports):
        if strip_wall(rep) != strip_wall(cpu.reports[i]):
            raise AssertionError(f"sweep lane {i}: card != CPU")
        solo = sweep_make(axis_sc(i)).run(engine="vectorized", device=dev)
        if strip_wall(rep) != strip_wall(solo):
            raise AssertionError(f"sweep lane {i} != its solo run")
    for i in range(n_async):
        ref = sweep_make(axis_sc(i)).run(engine="async")
        for f in CORE_FIELDS:
            if getattr(res.reports[i], f) != getattr(ref, f):
                raise AssertionError(f"sweep lane {i} != async on {f}")
    emit("sweep", variants=n_variants, tier=res.tier, wall_s=res.wall_s,
         configs_per_s=res.configs_per_s, cpu_wall_s=cpu.wall_s,
         launches=launches, lanes_equal_cpu=n_variants,
         lanes_equal_solo=n_variants, lanes_equal_async=n_async)
    return axis, res.tick_ns, launches


def campaign_rows(report) -> dict:
    """A ``CampaignReport`` without its clock fields."""
    d = report.to_dict()
    d.pop("wall_s")
    d.pop("points_per_s")
    return d


def recording(make):
    """A campaign's ``make_sim`` that keeps the lane reports of every
    sweep the campaign runs on what it made, in ``.lanes``."""
    lanes = []

    def make_kept(scenario=None):
        sim = make(scenario)
        sweep = sim.sweep

        def sweep_kept(axis, **kw):
            res = sweep(axis, **kw)
            lanes.extend(res.reports)
            return res
        sim.sweep = sweep_kept
        return sim
    make_kept.lanes = lanes
    return make_kept


def lanes_equal(what: str, card: list, cpu: list, n: int) -> None:
    """Every swept lane's whole report (vtimes of every task included)
    on the card equal to the CPU's, where the kernels' plain versions
    ran on the same inputs."""
    if len(card) != n or len(cpu) != n:
        raise AssertionError(f"{what}: {len(card)} card and {len(cpu)} "
                             f"CPU lanes, expected {n}")
    for i, (a, b) in enumerate(zip(card, cpu)):
        if strip_wall(a) != strip_wall(b):
            raise AssertionError(f"{what} lane {i}: card != CPU")


def timed_campaign(camp, minimize: bool = True):
    """(report, set-up seconds, engine-kernel launches): the kernel
    counters are set to 0 just before ``run`` and read just after.  The
    set-up is the part of ``run`` outside the report's ``wall_s``: the
    baseline on the reference engine (which launches no kernel) and the
    grid's points."""
    from repro_torch.kernels.hub_route import hub_route
    from repro_torch.kernels.minskew import minskew
    minskew.launches = hub_route.launches = 0
    t0 = time.perf_counter()
    report = camp.run(minimize=minimize)
    setup_s = time.perf_counter() - t0 - report.wall_s
    return report, setup_s, {"minskew": minskew.launches,
                             "hub_route": hub_route.launches}


def phase_campaign_main(torch, dev):
    """A fault campaign over the main path: one straggler chip (3x) in
    every ``CAMPAIGN_POD_STEP``-th pod, or four correlated pods (8
    points), ``engine="auto"``; every
    point must take the sweep fast path on the card through both engine
    kernels, every lane's report (vtimes included) must equal the CPU
    sweep's, and the campaign's report the CPU campaign's."""
    from repro_torch.sim import Campaign, FaultGrid

    def camp(device):
        grid = FaultGrid(
            types=("straggler",),
            targets=tuple(f"chip{p * MAIN_CHIPS}"
                          for p in range(0, MAIN_PODS, CAMPAIGN_POD_STEP)),
            vtimes=(0,), counts=(1, 4), knobs={"slowdown": 3.0})
        make = recording(main_path_sim)
        return make, Campaign(make, grid, seed=0, engine="auto",
                              base_name="main_path", device=device)
    make, card = camp(dev)
    rep, baseline_s, launches = timed_campaign(card, minimize=False)
    n = rep.grid["n_points"]
    if rep.fast_path != "sweep":
        raise AssertionError(f"campaign_main: fast path {rep.fast_path}")
    if launches["minskew"] < 1 or launches["hub_route"] < 1:
        raise AssertionError(f"campaign_main missed a kernel: {launches}")
    make_cpu, on_cpu = camp("cpu")
    cpu, cpu_baseline_s, _ = timed_campaign(on_cpu, minimize=False)
    lanes_equal("campaign_main", make.lanes, make_cpu.lanes, n)
    if campaign_rows(rep) != campaign_rows(cpu):
        raise AssertionError("campaign_main: card report != CPU report")
    emit("campaign_main", points=n, vtasks=MAIN_PODS * MAIN_CHIPS,
         fast_path=rep.fast_path, histogram=rep.histogram,
         baseline_s=baseline_s, sweep_wall_s=rep.wall_s,
         points_per_s=rep.points_per_s, cpu_baseline_s=cpu_baseline_s,
         cpu_wall_s=cpu.wall_s, launches=launches, lanes_equal_cpu=n,
         equal_to_cpu=True)
    return launches


#: the rack_ring@v1 histogram the JAX package gives
RACK_RING_HISTOGRAM = {"ok": 16, "deadlock": 8, "invariant-violation": 0,
                       "crash": 0, "divergence": 0}
#: its points that the sweep takes (the rest are clock skews)
RACK_RING_SWEPT = 16


def phase_campaign(torch, dev):
    """The registry's sweepable campaign base, ``rack_ring@v1`` with its
    grid: the sweepable points on the card, the clock-skew points on the
    reference engine ("mixed"), the pinned histogram, every swept lane's
    report equal to the CPU sweep's, reproducers byte-equal to the CPU
    run's.  Then, in this process with CUDA
    initialised, the dist engine's forked workers: ``python -m
    repro_torch.dist``'s smoke and the campaign on ``engine="dist"``,
    its reproducers byte-equal to ``engine="async"``."""
    from repro_torch.dist.__main__ import smoke
    from repro_torch.sim import Campaign, registry
    from repro_torch.sim.campaign import spec_to_bytes
    ent = registry.entry("rack_ring@v1")

    def camp(make=ent.make, **kw):
        return Campaign(make, ent.grid(), seed=0, base_name=ent.ref, **kw)
    make, make_cpu = recording(ent.make), recording(ent.make)
    rep, baseline_s, launches = timed_campaign(camp(make, device=dev))
    if rep.fast_path != "mixed" or rep.histogram != RACK_RING_HISTOGRAM:
        raise AssertionError(f"campaign: {rep.fast_path} {rep.histogram}")
    if launches["minskew"] < 1:
        raise AssertionError(f"campaign missed minskew: {launches}")
    specs = [spec_to_bytes(s) for s in rep.reproducers]
    cpu = camp(make_cpu, device="cpu").run()
    lanes_equal("campaign", make.lanes, make_cpu.lanes, RACK_RING_SWEPT)
    if campaign_rows(rep) != campaign_rows(cpu) or \
            specs != [spec_to_bytes(s) for s in cpu.reproducers]:
        raise AssertionError("campaign: card report != CPU report")
    if not torch.cuda.is_initialized():
        raise AssertionError("campaign: CUDA not initialised before dist")
    t0 = time.perf_counter()
    smoke(2)
    smoke_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist = camp(engine="dist", n_workers=2, worker_timeout=60.0).run()
    dist_s = time.perf_counter() - t0
    asy = camp(engine="async").run()
    if [spec_to_bytes(s) for s in dist.reproducers] != \
            [spec_to_bytes(s) for s in asy.reproducers] or \
            dist.histogram != asy.histogram:
        raise AssertionError("campaign: dist:2 reproducers != async")
    emit("campaign", base=ent.ref, points=rep.grid["n_points"],
         fast_path=rep.fast_path, histogram=rep.histogram,
         reproducers=len(specs), baseline_s=baseline_s,
         wall_s=rep.wall_s, points_per_s=rep.points_per_s,
         launches=launches, lanes_equal_cpu=RACK_RING_SWEPT,
         equal_to_cpu=True, dist_smoke_s=smoke_s,
         dist_campaign_s=dist_s, dist_histogram=dist.histogram,
         dist_specs_equal_async=True)
    return launches


def loop_s(torch, run) -> tuple:
    """Host-clock seconds of one round loop ``run()``, synchronised at
    both ends, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, st


def phase_check_interval(torch, np, dev, axis, tick: int,
                         intervals=(1, 4, 16), repeats: int = 5):
    """Round-loop wall time with the stop condition read back every K
    rounds (``engine_torch.CHECK_EVERY``), K interleaved over
    ``repeats``: the main path's loop (V = 1) and the sweep's loop
    (V = 64, at the sweep's shared ``tick``), each without compile or
    decompile.  Every K must give the same final state."""
    from repro_torch.core import engine_torch as et
    from repro_torch.sim import vectorized as vz
    comp = vz.compile_simulation(main_path_sim())
    tape = et.tape_from_numpy(comp.tape, dev)
    st0 = et.init_vec_sim_state(tape, comp.n_channels)
    comps = [vz.compile_simulation(sweep_make(sc), tick) for sc in axis]
    tapes = et.tape_from_numpy(
        {k: np.stack([c.tape[k] for c in comps]) for k in comps[0].tape},
        dev)
    sts0 = et.init_vec_sim_state(tapes, comps[0].n_channels)
    cap = max(c.max_rounds for c in comps)
    default = et.CHECK_EVERY
    times = {"main": {k: [] for k in intervals},
             "sweep": {k: [] for k in intervals}}
    want = {}
    for _ in range(repeats):
        for k in intervals:
            et.CHECK_EVERY = k
            for cell, run in (
                    ("main", lambda: et.run_vec_tape(
                        tape, st0, comp.max_rounds, kernel=True)),
                    ("sweep", lambda: et.run_vec_tape_batch(
                        tapes, sts0, cap, kernel=True))):
                sec, st = loop_s(torch, run)
                times[cell][k].append(sec)
                got = [getattr(st, f).cpu().numpy().tobytes()
                       for f in et.STATE_FIELDS]
                if want.setdefault(cell, got) != got:
                    raise AssertionError(f"check interval {k} changed "
                                         f"the {cell} loop's state")
    et.CHECK_EVERY = default
    emit("check_interval", default=default, repeats=repeats,
         sweep_tick_ns=tick,
         **{f"{cell}_loop_{stat}_s": {k: fn(v) for k, v in by_k.items()}
            for cell, by_k in times.items()
            for stat, fn in (("median", statistics.median), ("min", min))})


# ------------------------------------------------------- serving kernels


#: the device kernels of one wrapper call: bf16 flash runs the tensor-core
#: kernel, fp32 flash the CUDA-core one (one launch either way); decode
#: runs the split kernel and the combine kernel
FLASH_KERNELS = ("flash_sm90_kernel", "flash_kernel")
#: the attention backward: the tensor-core pair (bf16 up to hd 128) or the
#: CUDA-core pair, two kernels a call either way; no name contains another
FLASH_BWD_KERNELS = ("flash_bwd_sm90_q", "flash_bwd_sm90_kv", "flash_bwd_dq",
                     "flash_bwd_dkdv")
DECODE_KERNELS = ("decode_split_kernel", "decode_combine_kernel")
#: (case, B, H, Hkv, Sq, Sk, hd, causal, window, timed): the serving
#: path's prefill shape (pixtral_12b's too), a longer prompt,
#: recurrentgemma's prefill, seamless_m4t_medium's encoder, cross- and
#: decoder self-attention, olmoe_1b_7b's prefill (MHA, hd 128),
#: tests/test_kernels.py's edge shapes (GQA, padded tail, window, cross
#: attention, hd 128), head dims that are not multiples of 16 (the bf16
#: kernel pads them to 64 in shared memory), one query row, fewer queries
#: than keys under the causal mask, and a window narrower than a key tile
FLASH_CASES = [("main", 4, 32, 8, 1024, 1024, 128, True, 0, True),
               ("s4096", 4, 32, 8, 4096, 4096, 128, True, 0, True),
               ("rglru_prefill", 4, 16, 1, 3072, 3072, 256, True, 2048,
                True),
               ("encdec_enc", 4, 16, 16, 256, 256, 64, False, 0, True),
               ("encdec_cross", 4, 16, 16, 1024, 256, 64, False, 0, True),
               ("encdec_self", 4, 16, 16, 1024, 1024, 64, True, 0, True),
               ("moe_prefill", 4, 16, 16, 1024, 1024, 128, True, 0, False),
               ("gqa", 1, 4, 2, 128, 128, 64, True, 0, False),
               ("padded", 1, 8, 2, 96, 96, 32, True, 0, False),
               ("window64", 1, 2, 1, 256, 256, 64, True, 64, False),
               ("cross", 1, 2, 2, 64, 192, 32, False, 0, False),
               ("hd128", 1, 6, 3, 128, 128, 128, True, 0, False),
               ("hd8", 2, 4, 2, 100, 100, 8, True, 0, False),
               ("hd24", 1, 4, 1, 130, 130, 24, True, 0, False),
               ("hd40", 1, 4, 2, 70, 70, 40, False, 0, False),
               ("sq1", 2, 4, 2, 1, 1, 64, True, 0, False),
               ("sq1_cross", 2, 4, 2, 1, 77, 64, False, 0, False),
               ("sq_lt_sk_causal", 1, 4, 2, 50, 300, 128, True, 0, False),
               ("window5", 1, 4, 2, 200, 200, 256, True, 5, False)]
#: (case, B, H, Hkv, S, hd, lengths, timed): lengths a list, None for
#: random, or "edges" for the split boundaries of the shape's own chunk
#: (chunk - 1, chunk, chunk + 1, 2 chunk).  The serving path's decode
#: shape (S = 1,024 + 32 cache positions), a long cache, recurrentgemma's
#: ring buffer, seamless_m4t_medium's self and cross caches, olmoe_1b_7b's
#: cache, tests/test_kernels.py's decode shapes, a length-0 row alone and
#: among full rows, lengths above S (clamped) and qpk = 1
DECODE_CASES = [("main", 4, 32, 8, 1056, 128, [1, 300, 777, 1056], True),
                ("s8192", 4, 32, 8, 8192, 128, [1, 2048, 5000, 8192], True),
                ("rglru_ring", 4, 16, 1, 2048, 256, [2048] * 4, True),
                ("encdec_self", 4, 16, 16, 1056, 64,
                 [1025, 1035, 1045, 1055], True),
                ("encdec_cross", 4, 16, 16, 256, 64, [256] * 4, True),
                ("moe_decode", 4, 16, 16, 1056, 128,
                 [1025, 1035, 1045, 1055], False),
                ("rglru_ring_partial", 4, 16, 1, 2048, 256,
                 [1, 700, 1500, 2048], False),
                ("mha", 2, 4, 4, 256, 64, None, False),
                ("gqa4", 2, 8, 2, 256, 64, None, False),
                ("mqa_padded", 3, 4, 1, 300, 32, None, False),
                ("hd128", 1, 16, 8, 512, 128, None, False),
                ("empty_row", 3, 4, 2, 100, 32, [0, 1, 100], False),
                ("split_edges", 4, 32, 8, 1056, 128, "edges", False),
                ("ring_split_edges", 4, 16, 1, 2048, 256, "edges", False),
                ("zero_among_full", 4, 32, 8, 1056, 128,
                 [1056, 0, 1056, 1056], False),
                ("over_s", 3, 8, 2, 300, 64, [301, 5000, 300], False),
                ("qpk1", 2, 8, 8, 300, 128, None, False)]
#: the serving paths: (arch, batch, prompt length, new tokens), full
#: width and depth in bfloat16.  recurrentgemma's prompt is longer than
#: its 2,048 window, so the window binds in flash_attention, prefill
#: rolls the ring buffer and decode writes over old slots.
SERVE = ("qwen3_4b", 4, 1024, 32)
#: decode steps a serve phase profiles after its timed ``generate``s: the
#: profiler's host work grows with the device operations it records
#: (about 0.2 ms each on the card's host; 3,500 a qwen3_4b step), so 8 of
#: the 31 steps keep the script inside its time
PROFILED_DECODE_STEPS = 8
SERVE_RGLRU = ("recurrentgemma_9b", 4, 3072, 32)
SERVE_XLSTM = ("xlstm_1_3b", 4, 1024, 32)
#: olmoe's prefill routes 4,096 tokens x 8 slots into 64 experts of 640
#: places; pixtral's prompts open with 512 patch embeddings and
#: seamless's decoder attends to 256 audio frames (frontend_embeds)
SERVE_MOE = ("olmoe_1b_7b", 4, 1024, 32)
SERVE_VLM = ("pixtral_12b", 4, 1024, 32)
SERVE_ENCDEC = ("seamless_m4t_medium", 4, 1024, 32)
#: the parity phases: (layers, batch, prompt length, new tokens, config
#: overrides) at the arch's full width in float32
PARITY = (2, 2, 128, 8, {})
PARITY_RGLRU = (3, 2, 2080, 4, {})
PARITY_XLSTM = (2, 2, 200, 8, {"slstm_every": 2})
#: olmoe's 256 tokens take 40 places an expert against a mean load of 32,
#: so some expert overflows and the first layer drops slots
PARITY_MOE = (2, 2, 128, 8, {})
PARITY_VLM = (2, 2, 128, 8, {})
PARITY_ENCDEC = (2, 2, 128, 8, {"n_enc_layers": 2})
#: (B, S, W, with h0, timed): recurrentgemma's prefill shape, a long
#: chain (64 chunks at the kernel's T_c of 256; "kernel": the plain loop
#: over its 16,384 steps is timed once, not profiled), tests/test_kernels.py's
#: rglru shapes, then the prefill shape with h0, odd W with S not a
#: multiple of the chunk, S = 1 and S below one chunk
RGLRU_CASES = [(4, 3072, 4096, False, True), (2, 128, 64, False, False),
               (2, 128, 64, True, False), (1, 300, 32, True, False),
               (3, 64, 128, False, False), (2, 16, 8, True, False),
               (4, 3072, 4096, True, False), (1, 16384, 1024, False, "kernel"),
               (2, 515, 4099, True, False), (3, 1, 4096, True, False),
               (2, 100, 4096, False, False)]
#: recurrentgemma's prefill shape, where two calls must give the same bits
RGLRU_SERVE_SHAPE = (4, 3072, 4096)
#: (BH, S, hd, with an initial carry, timed, dtypes): xlstm's prefill
#: shape (B=4 x H=4 heads of hd 1,024), tests/test_kernels.py's mlstm
#: shapes, S not a multiple of the kernel's chunk and hd 8, in both dtypes;
#: in bfloat16 also the prefill shape with an initial carry, and a head dim
#: above the tensor-core kernel's limit (SM90_MAX_HD), where the first
#: design runs
BOTH = ("bfloat16", "float32")
MLSTM_CASES = [(16, 1024, 1024, False, True, BOTH),
               (2, 128, 32, False, False, BOTH),
               (4, 256, 64, False, False, BOTH),
               (1, 64, 128, False, False, BOTH),
               (2, 200, 64, True, False, BOTH),
               (3, 130, 96, True, False, BOTH),
               (2, 64, 8, True, False, BOTH),
               (16, 1024, 1024, True, False, ("bfloat16",)),
               (1, 128, 2880, True, False, ("bfloat16",))]


#: (case, B, H, Hkv, Sq, Sk, hd, causal, window, timed) for the attention
#: backward: the trainer's shape (full-width qwen3_4b, B=4, S=1,024, timed),
#: recurrentgemma's window shape (MQA, hd 256, window 2,048), and the
#: forward phase's edge shapes: hd 8/24/40, GQA with a padded tail, fewer
#: queries than keys under the causal mask, a window narrower than a key
#: tile, and Sk = 0; and on the bf16 tensor-core route hd 64 (GQA 8, a
#: window of 40, S off the tiles) and hd 96 (Sq < Sk, both off the tiles),
#: and a window of 5 at hd 64; then the shapes the MoE, VLM and
#: encoder-decoder train steps give it (timed): seamless's cross-attention
#: (1,024 queries over 256 frames, non-causal), its encoder (256 frames,
#: non-causal) and decoder self-attention (hd 64, 16/16 heads), and
#: olmoe's (16/16 heads, hd 128); pixtral's is the trainer's shape
FLASH_BWD_CASES = [("train", 4, 32, 8, 1024, 1024, 128, True, 0, True),
                   ("rglru_window", 1, 16, 1, 3072, 3072, 256, True, 2048,
                    False),
                   ("gqa", 1, 4, 2, 128, 128, 64, True, 0, False),
                   ("padded", 1, 8, 2, 96, 96, 32, True, 0, False),
                   ("hd8", 2, 4, 2, 100, 100, 8, True, 0, False),
                   ("hd24", 1, 4, 1, 130, 130, 24, True, 0, False),
                   ("hd40", 1, 4, 2, 70, 70, 40, False, 0, False),
                   ("sq_lt_sk_causal", 1, 4, 2, 50, 300, 128, True, 0,
                    False),
                   ("window5", 1, 4, 2, 200, 200, 256, True, 5, False),
                   ("sk0", 2, 4, 2, 30, 0, 64, True, 0, False),
                   ("hd64_gqa8_window40", 2, 16, 2, 300, 300, 64, True, 40,
                    False),
                   ("hd96_sq_lt_sk", 1, 8, 2, 190, 257, 96, True, 0, False),
                   ("hd64_window5", 1, 4, 2, 200, 200, 64, True, 5, False),
                   ("seamless_cross", 4, 16, 16, 1024, 256, 64, False, 0,
                    True),
                   ("seamless_encoder", 4, 16, 16, 256, 256, 64, False, 0,
                    True),
                   ("seamless_decoder", 4, 16, 16, 1024, 1024, 64, True, 0,
                    True),
                   ("olmoe", 4, 16, 16, 1024, 1024, 128, True, 0, True)]
#: the training path: (arch, global batch, sequence length, warm-up steps,
#: timed steps, layers or None for the config's), full width in bfloat16
#: with the config's remat
TRAIN = ("qwen3_4b", 4, 1024, 1, 4, None)
#: the MoE, VLM and encoder-decoder train paths, by family: full width,
#: depth cut to fit 80 GB with bf16 weights and gradients and float32
#: AdamW moments (about 12 bytes a parameter): olmoe 10 of 16 layers
#: (4.4 B parameters), pixtral 12 of 40 (4.6 B), seamless whole (12 + 12
#: layers, 0.98 B); 1 warm-up, 2 timed and 1 profiled step each
TRAIN_FAMILIES = (("moe", ("olmoe_1b_7b", 4, 1024, 1, 2, 10)),
                  ("vlm", ("pixtral_12b", 4, 1024, 1, 2, 12)),
                  ("encdec", ("seamless_m4t_medium", 4, 1024, 1, 2, None)))
#: the train step's device operations by class, from their kernel names
#: (the first class whose key a name contains; the rest are "other")
TRAIN_OP_CLASSES = (("attention_bwd", ("flash_bwd",)),
                    ("attention_fwd", ("flash_sm90", "flash_kernel")),
                    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                    ("elementwise", ("elementwise", "copy", "fill")),
                    ("reduction", ("reduce", "softmax", "logsumexp",
                                   "index", "scatter", "gather")))
#: the training parity phase: (layers, batch, sequence length, steps,
#: peak lr) at qwen3_4b's full width in float32, card against CPU.  AdamW
#: turns a gradient whose sign differs at rounding level into a step of
#: +-lr, so lr stays below the parameters' tolerance
TRAIN_PARITY = (2, 2, 128, 3, 1e-5)
#: the three families' training parity: (family, arch, (layers, batch,
#: sequence length, steps, peak lr), config overrides), full width,
#: float32, S = 128 with 64 patches or frames: olmoe 2 layers; pixtral 1
#: (its float32 weights, gradients and moments are about 26 GB on the
#: host); seamless 1 + 1
TRAIN_PARITY_FAMILIES = (
    ("moe", "olmoe_1b_7b", (2, 2, 128, 2, 1e-5), {}),
    ("vlm", "pixtral_12b", (1, 2, 128, 2, 1e-5), {}),
    ("encdec", "seamless_m4t_medium", (1, 2, 128, 2, 1e-5),
     {"n_enc_layers": 1}))


def sdpa(q, k, v, **kw):
    """The call to time: ``scaled_dot_product_attention`` on (B, H, S,
    hd) tensors with fewer kv heads than query heads."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)


def attn_bound_ms(n_bytes: int, flops: int, dtype: str):
    """(bound ms, "bytes" or "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, per flat row."""
    i = sum(min(sk, q + 1 if causal else sk)
            - (max(0, q - window + 1) if window > 0 else 0)
            for q in range(sq))
    return max(i, 0)


def _dname(torch, dt) -> str:
    return {torch.bfloat16: "bfloat16", torch.float32: "float32"}[dt]


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _hold(name: str, err: float, dtype: str, where,
          scale: float = 1.0) -> None:
    """``err`` within ``ATTN_TOL`` x max(1, ``scale``), the largest
    |plain value| for the recurrences (also catches NaN)."""
    if not err <= ATTN_TOL[dtype] * max(1.0, scale):
        raise AssertionError(f"{name} kernel != plain at {where} "
                             f"({dtype}): max abs err {err} (scale {scale})")


def _kernel_timings(torch, kern, names, iters: int = ITERS) -> dict:
    return {"kernel_ms": timed_ms(torch, kern, iters),
            "kernel_batch_ms": batch_ms(torch, kern),
            **dict(zip(("kernel_device_ms", "kernel_device_records"),
                       device_ms(torch, kern, names)))}


def _timings(torch, kern, plain, names, iters: int = ITERS) -> dict:
    return {**_kernel_timings(torch, kern, names, iters),
            "plain_ms": timed_ms(torch, plain, iters),
            "plain_batch_ms": batch_ms(torch, plain),
            "plain_device_ms": device_ms(torch, plain)[0]}


def _library(torch, lib, iters: int = ITERS) -> dict:
    return {"library_ms": timed_ms(torch, lib, iters),
            "library_batch_ms": batch_ms(torch, lib),
            "library_device_ms": device_ms(torch, lib)[0]}


def phase_flash_attention(torch, np, dev):
    """Kernel vs plain version (``attention_flat_plain``) on the card;
    times at the serving shapes beside ``scaled_dot_product_attention``
    (timed here only: the port never calls it; a window becomes a
    boolean band mask, since SDPA has no window argument)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_flat
    from repro_torch.kernels.ref import attention_flat_plain
    g = torch.Generator(device=dev).manual_seed(2)
    main = []
    edge = []
    for dt in (torch.bfloat16, torch.float32):
        dname = _dname(torch, dt)
        for name, b, h, hkv, sq, sk, hd, causal, window, timed in \
                FLASH_CASES:
            q = torch.randn(b * h, sq, hd, generator=g, device=dev).to(dt)
            k = torch.randn(b * hkv, sk, hd, generator=g, device=dev).to(dt)
            v = torch.randn(b * hkv, sk, hd, generator=g, device=dev).to(dt)
            got = flash_attention_flat(q, k, v, causal=causal, window=window)
            want = attention_flat_plain(q, k, v, causal=causal,
                                        window=window)
            torch.cuda.synchronize()
            err = _err(got, want)
            _hold("flash_attention", err, dname, name)
            if not timed:
                edge.append({"case": name, "dtype": dname,
                             "max_abs_err": err})
                continue
            del got, want
            iters = ITERS if sq <= 1024 else 10
            kern = lambda: flash_attention_flat(q, k, v, causal=causal,
                                                window=window)
            plain = lambda: attention_flat_plain(q, k, v, causal=causal,
                                                 window=window)
            q4, k4, v4 = (t.view(b, -1, t.shape[1], hd) for t in (q, k, v))
            if window > 0:                  # SDPA has no window argument
                qpos = torch.arange(sq, device=dev)[:, None]
                kpos = torch.arange(sk, device=dev)[None, :]
                band = (kpos > qpos - window) & ((kpos <= qpos) | (not causal))
                lib = sdpa(q4, k4, v4, attn_mask=band)
            else:
                lib = sdpa(q4, k4, v4, is_causal=causal)
            elt = q.element_size()
            n_bytes = elt * (2 * q.numel() + k.numel() + v.numel())
            flops = 4 * hd * b * h * visible_pairs(sq, sk, causal, window)
            bound, by = attn_bound_ms(n_bytes, flops, dname)
            main.append({
                "case": name, "dtype": dname, "B": b, "H": h, "Hkv": hkv,
                "S": sq, "hd": hd, "max_abs_err": err,
                **_timings(torch, kern, plain, FLASH_KERNELS, iters),
                **_library(torch, lib, iters),
                "bound_ms": bound, "bound_by": by, "flops": flops,
                "bytes": n_bytes})
            if name == "main":              # what the serving path calls
                bshd = [t.view(b, -1, t.shape[1], hd).transpose(1, 2)
                        .contiguous() for t in (q, k, v)]
                main[-1]["kernel_bshd_ms"] = timed_ms(
                    torch, lambda: ops.flash_attention(*bshd, causal=causal),
                    iters)
                del bshd
    emit("flash_attention", tolerance=ATTN_TOL, shapes=main, edge=edge,
         strided=flash_strided_views(torch, dev, g))
    return main[0]


def flash_strided_views(torch, dev, g, b=2, s=200, h=8, hkv=2, hd=128):
    """``ops.flash_attention`` on (B, S, H, hd) views whose strides are not
    contiguous (bf16 reads them in place): q, k, v sliced from one fused
    projection output, and heads-first storage transposed; held to the
    plain version of contiguous copies."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_flat_plain
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for kind in ("fused", "heads_first"):
            if kind == "fused":
                x = torch.randn(b, s, h + 2 * hkv, hd, generator=g,
                                device=dev).to(dt)
                q, k, v = x[:, :, :h], x[:, :, h:h + hkv], x[:, :, h + hkv:]
            else:
                x = torch.randn(b, h + 2 * hkv, s, hd, generator=g,
                                device=dev).to(dt)
                q, k, v = (t.transpose(1, 2) for t in (
                    x[:, :h], x[:, h:h + hkv], x[:, h + hkv:]))
            got = ops.flash_attention(q, k, v, causal=True)
            want = attention_flat_plain(
                *(t.transpose(1, 2).reshape(-1, s, hd).contiguous()
                  for t in (q, k, v)), causal=True)
            torch.cuda.synchronize()
            err = _err(got, want.view(b, h, s, hd).transpose(1, 2))
            _hold("flash_attention", err, _dname(torch, dt), kind)
            rows.append({"view": kind, "dtype": _dname(torch, dt),
                         "contiguous": q.is_contiguous(),
                         "max_abs_err": err})
    return rows


def phase_decode_attention(torch, np, dev):
    """Kernel vs plain version (``decode_attention_plain``) on the card;
    times at the decode shapes beside ``scaled_dot_product_attention``
    with a boolean mask built from ``lengths``."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      n_splits, split_chunk)
    from repro_torch.kernels.ref import decode_attention_plain
    g = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    main, edge = [], []
    for dt in (torch.bfloat16, torch.float32):
        dname = _dname(torch, dt)
        for name, b, h, hkv, s, hd, lens, timed in DECODE_CASES:
            if lens is None:
                lens = rng.integers(1, s + 1, size=b).tolist()
            elif lens == "edges":
                c = split_chunk(b, hkv, s)
                lens = [c - 1, c, c + 1, 2 * c][:b]
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = torch.randn(b, h, hd, generator=g, device=dev).to(dt)
            k = torch.randn(b, s, hkv, hd, generator=g, device=dev).to(dt)
            v = torch.randn(b, s, hkv, hd, generator=g, device=dev).to(dt)
            got = decode_attention(q, k, v, lengths)
            want = decode_attention_plain(q, k, v, lengths)
            torch.cuda.synchronize()
            err = _err(got, want)
            _hold("decode_attention", err, dname, name)
            for row, n in enumerate(lens):
                if n <= 0 and bool(got[row].any()):
                    raise AssertionError(f"decode_attention: the length-0 "
                                         f"row {row} of {name} is not 0")
            splits = {"chunk": split_chunk(b, hkv, s),
                      "splits": n_splits(b, hkv, s)}
            if not timed:
                edge.append({"case": name, "dtype": dname,
                             "lengths": lens, "max_abs_err": err, **splits})
                continue
            kern = lambda: decode_attention(q, k, v, lengths)
            plain = lambda: decode_attention_plain(q, k, v, lengths)
            mask = (torch.arange(s, device=dev)[None, None, None, :]
                    < lengths[:, None, None, None])
            q4 = q[:, :, None, :]
            k4, v4 = k.transpose(1, 2), v.transpose(1, 2)
            lib = sdpa(q4, k4, v4, attn_mask=mask)
            elt = q.element_size()
            valid = int(sum(min(max(n, 0), s) for n in lens))
            n_bytes = elt * (2 * q.numel() + 2 * valid * hkv * hd) \
                + 4 * b
            flops = 4 * hd * h * valid
            bound, by = attn_bound_ms(n_bytes, flops, dname)
            main.append({
                "case": name, "dtype": dname, "B": b, "H": h, "Hkv": hkv,
                "S": s, "hd": hd, "lengths": lens, "max_abs_err": err,
                **splits, **_timings(torch, kern, plain, DECODE_KERNELS),
                **_library(torch, lib),
                "bound_ms": bound, "bound_by": by, "bytes": n_bytes})
    emit("decode_attention", tolerance=ATTN_TOL, shapes=main, edge=edge)
    return main[0]


RGLRU_KERNELS = ("rglru_chained_kernel",)
#: the device kernels of both routes: mlstm_kernel.cu's and
#: mlstm_kernel_sm90.cu's
MLSTM_KERNELS = ("scores_kernel", "carry_kernel", "mlstm_scores_sm90",
                 "mlstm_den_sm90", "mlstm_carry_sm90")


def phase_rglru_scan(torch, np, dev):
    """Kernel vs plain version (``rglru_plain``, a loop over S) on the
    card, float32; each case with the kernel's tiling (T_c, W_t, grid),
    and at the prefill shape a second call that must give the same bits
    (the carry is chained in a fixed order).  No single PyTorch call
    computes a linear recurrence, so there is no library time."""
    from repro_torch.kernels.ref import rglru_plain
    from repro_torch.kernels.rglru_scan import plan, rglru_scan
    g = torch.Generator(device=dev).manual_seed(6)
    main, edge = [], []
    for b, s, w, with_h0, timed in RGLRU_CASES:
        log_a = -torch.rand(b, s, w, generator=g, device=dev) * 0.3
        bv = torch.randn(b, s, w, generator=g, device=dev)
        h0 = (torch.randn(b, w, generator=g, device=dev) if with_h0
              else None)
        got = rglru_scan(log_a, bv, h0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want = rglru_plain(log_a, bv, h0)
        ev[1].record()
        torch.cuda.synchronize()
        err, scale = _err(got, want), float(want.abs().max())
        _hold("rglru_scan", err, "float32", (b, s, w, with_h0), scale)
        case = {"B": b, "S": s, "W": w, "h0": with_h0, "max_abs_err": err,
                "scale": scale, **plan(b, s, w)}
        if (b, s, w) == RGLRU_SERVE_SHAPE:
            if not torch.equal(got, rglru_scan(log_a, bv, h0)):
                raise AssertionError(f"rglru_scan: two calls at {(b, s, w)}"
                                     f" (h0 {with_h0}) differ")
            case["bit_equal_two_calls"] = True
        if not timed:
            edge.append(case)
            continue
        del got, want
        n_bytes = 4 * (3 * b * s * w + (b * w if with_h0 else 0))
        bound, by = attn_bound_ms(n_bytes, 2 * b * s * w, "float32")
        kern = lambda: rglru_scan(log_a, bv, h0)
        if timed == "kernel":                   # plain: the one call above
            times = {**_kernel_timings(torch, kern, RGLRU_KERNELS, 10),
                     "plain_ms": ev[0].elapsed_time(ev[1])}
        else:
            times = _timings(torch, kern, lambda: rglru_plain(log_a, bv, h0),
                             RGLRU_KERNELS, 10)
        main.append({**case, **times, "bound_ms": bound, "bound_by": by,
                     "bytes": n_bytes, "library_ms": None})
    emit("rglru_scan", tolerance=ATTN_TOL["float32"], shapes=main,
         edge=edge)
    return main[0]


def mlstm_work(bh: int, s: int, hd: int, elt: int, carry_in: bool):
    """(bytes, FLOPs) of one chunkwise mLSTM call: q, k, v read and h
    written in the model dtype, the gates read, the final C and n
    written (and the initial ones read); 4 hd^2 + 4 L hd FLOPs per
    token and head (q C and the C update, the L x L scores and S v)."""
    from repro_torch.kernels.mlstm_kernel import CHUNK
    carry = 4 * bh * (hd * hd + hd)
    n_bytes = (elt * 4 * bh * s * hd + 4 * 2 * bh * s
               + carry * (2 if carry_in else 1))
    return n_bytes, bh * s * (4 * hd * hd + 4 * CHUNK * hd)


def phase_mlstm_chunkwise(torch, np, dev):
    """Kernel vs plain version (``mlstm_flat_plain``: the same tail
    padding, the chunkwise form at the kernel's chunk) on the card, h
    and the final C and n; each case names the source that ran.  The
    bound is at the peak of the dtype's route (bfloat16 on the tensor
    cores, float32 on the CUDA cores).  No single PyTorch call computes
    a chunkwise mLSTM, so there is no library time."""
    from repro_torch.kernels.mlstm_kernel import mlstm_chunkwise
    from repro_torch.kernels.mlstm_kernel import mlstm_flat_plain
    from repro_torch.kernels.mlstm_kernel import uses_sm90
    g = torch.Generator(device=dev).manual_seed(7)
    main, edge = [], []
    for dt in (torch.bfloat16, torch.float32):
        dname = _dname(torch, dt)
        for bh, s, hd, carry_in, timed, dtypes in MLSTM_CASES:
            if dname not in dtypes:
                continue
            q, k, v = (torch.randn(bh, s, hd, generator=g, device=dev)
                       .mul(0.3).to(dt) for _ in range(3))
            ig = torch.randn(bh, s, generator=g, device=dev)
            fg = torch.randn(bh, s, generator=g, device=dev) + 2.0
            c0 = n0 = None
            if carry_in:
                c0 = torch.randn(bh, hd, hd, generator=g, device=dev) * 0.1
                n0 = torch.randn(bh, hd, generator=g, device=dev) * 0.1
            h, (c, n) = mlstm_chunkwise(q, k, v, ig, fg, c0, n0)
            hw, (cw, nw) = mlstm_flat_plain(q, k, v, ig, fg, c0, n0)
            torch.cuda.synchronize()
            want = ("mlstm_kernel_sm90.cu" if uses_sm90(dt, hd)
                    else "mlstm_kernel.cu")
            if mlstm_chunkwise.source != want:
                raise AssertionError(f"mlstm_chunkwise at {(bh, s, hd)} "
                                     f"{dname} ran {mlstm_chunkwise.source}"
                                     f", expected {want}")
            errs = {}
            for part, got, want, pdt in (("h", h, hw, dname),
                                         ("C", c, cw, "float32"),
                                         ("n", n, nw, "float32")):
                err, scale = _err(got, want), float(want.abs().max())
                _hold("mlstm_chunkwise", err, pdt,
                      (bh, s, hd, carry_in, part), scale)
                errs[part] = err
            case = {"dtype": dname, "BH": bh, "S": s, "hd": hd,
                    "carry_in": carry_in,
                    "kernel": mlstm_chunkwise.source,
                    "max_abs_err": errs["h"],
                    "max_abs_err_C": errs["C"], "max_abs_err_n": errs["n"]}
            if not timed:
                edge.append(case)
                continue
            del h, c, n, hw, cw, nw
            n_bytes, flops = mlstm_work(bh, s, hd, q.element_size(),
                                        carry_in)
            bound, by = attn_bound_ms(n_bytes, flops, dname)
            main.append({**case, **_timings(
                torch, lambda: mlstm_chunkwise(q, k, v, ig, fg, c0, n0),
                lambda: mlstm_flat_plain(q, k, v, ig, fg, c0, n0),
                MLSTM_KERNELS, 10),
                "bound_ms": bound, "bound_by": by, "flops": flops,
                "bytes": n_bytes, "library_ms": None})
    emit("mlstm_chunkwise", tolerance=ATTN_TOL, shapes=main, edge=edge)
    return main[0]


# ------------------------------------------------------- the serving path


def serve_prompts(np, vocab: int, b: int, s: int, seed: int):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def frontend_embeds(np, cfg, b: int, s: int, seed: int):
    """The frontend stub's embeddings for B prompts of S tokens, float32
    from a seed (``None`` without a frontend): ``min(n_frontend_tokens,
    S // 2)`` patches, or ``enc_len(S)`` audio frames, as the JAX
    package's ``launch/shapes.py::frontend_tokens`` reckons."""
    if not cfg.frontend:
        return None
    if cfg.frontend == "patch":
        n = min(cfg.n_frontend_tokens, s // 2)
    else:
        from repro_torch.models.encdec import enc_len
        n = enc_len(cfg, s)
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.frontend_dim)).astype(np.float32)


def moe_keeps(run):
    """(``run()``, [(capacity, kept mask on the host)] of each MoE layer
    it ran): the MoE's ``dispatch_indices`` wrapped to keep them; outside
    the timed runs, since reading the mask waits for the card."""
    from repro_torch.models import moe
    inner = moe.dispatch_indices
    kept = []

    def keeping(ids, cap, n_experts):
        idx, keep = inner(ids, cap, n_experts)
        kept.append((cap, keep.cpu()))
        return idx, keep
    moe.dispatch_indices = keeping
    try:
        out = run()
    finally:
        moe.dispatch_indices = inner
    return out, kept


def _serving_wrappers() -> dict:
    """The model paths' kernel wrappers (serving and training), by kernel
    name."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_flat)
    from repro_torch.kernels.mlstm_kernel import mlstm_chunkwise
    from repro_torch.kernels.rglru_scan import rglru_scan
    return {"flash_attention": flash_attention_flat,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention,
            "rglru_scan": rglru_scan, "mlstm_chunkwise": mlstm_chunkwise}


def _kernel_counts():
    return {k: w.launches for k, w in _serving_wrappers().items()}


def _zero_kernel_counts():
    for w in _serving_wrappers().values():
        w.launches = 0


def expected_launches(cfg, decode_steps: int) -> dict:
    """Each model kernel's launches in one ``generate``: attention
    once per attention layer in prefill and per attention layer and
    decode step (the encoder-decoder: its encoder layers, and twice per
    decoder layer, self and cross); the recurrences once per recurrent
    layer in prefill (decode steps them in plain tensor ops); no
    attention backward."""
    n_attn = n_rec = n_mlstm = 0
    if cfg.family in ("dense", "moe", "vlm"):
        n_attn = cfg.n_layers
    elif cfg.family == "encdec":
        # prefill: the encoder's layers, the decoder's self- and
        # cross-attention; decode: self and cross per decoder layer
        return {"flash_attention": (cfg.n_enc_layers or cfg.n_layers)
                + 2 * cfg.n_layers, "flash_attention_bwd": 0,
                "decode_attention": 2 * cfg.n_layers * decode_steps,
                "rglru_scan": 0, "mlstm_chunkwise": 0}
    elif cfg.family == "rglru":
        from repro_torch.models.rglru import layer_kinds
        n_attn = layer_kinds(cfg).count("attn")
        n_rec = cfg.n_layers - n_attn
    elif cfg.family == "xlstm":
        from repro_torch.models.xlstm import is_slstm
        n_mlstm = sum(not is_slstm(cfg, i) for i in range(cfg.n_layers))
    return {"flash_attention": n_attn, "flash_attention_bwd": 0,
            "decode_attention": n_attn * decode_steps,
            "rglru_scan": n_rec, "mlstm_chunkwise": n_mlstm}


def expected_train_launches(cfg, n_steps: int) -> dict:
    """Each model kernel's launches in ``n_steps`` train steps: every
    attention call of the forward (one per layer of a dense, MoE or VLM
    transformer; the encoder-decoder's encoder layers, and two per
    decoder layer, self and cross) once, again when ``cfg.remat``
    recomputes its layer in the backward, and its backward once; no
    decode or recurrent kernel (the recurrent families do not train on
    the card, ROADMAP A8.2)."""
    if cfg.family in ("dense", "moe", "vlm"):
        n_attn = cfg.n_layers
    elif cfg.family == "encdec":
        n_attn = (cfg.n_enc_layers or cfg.n_layers) + 2 * cfg.n_layers
    else:
        raise ValueError(f"{cfg.name}: the {cfg.family!r} family does not "
                         f"train on the card")
    fwd = n_attn * (2 if cfg.remat else 1)
    return {"flash_attention": n_steps * fwd,
            "flash_attention_bwd": n_steps * n_attn,
            "decode_attention": 0, "rglru_scan": 0, "mlstm_chunkwise": 0}


def _device_kernels(prof, launched: dict):
    """({kernel name: device us}, {part: records seen}) of a profile's
    CUDA kernels.  A kernel whose name contains a key of ``launched``
    (the port's kernels, by their launch counters over the profiled
    window) counts as the mean duration of the records the profiler
    kept times its launches: it keeps only some records of a kernel
    launched through ctypes."""
    from torch.autograd import DeviceType
    us, seen = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        t = e.self_device_time_total
        for part, n in launched.items():
            if part in e.key:
                seen[part] = seen.get(part, 0) + e.count
                t = t / e.count * n
        us[e.key] = t
    return us, seen


#: the device kernels each serving wrapper launches once per call
DEVICE_KERNELS = {"flash_attention": FLASH_KERNELS,
                  "flash_attention_bwd": FLASH_BWD_KERNELS,
                  "decode_attention": DECODE_KERNELS,
                  "rglru_scan": RGLRU_KERNELS,
                  "mlstm_chunkwise": MLSTM_KERNELS}


def _launched() -> dict:
    """The port's serving kernels' launch counters, by device kernel
    name."""
    counts = _kernel_counts()
    return {name: counts[w] for w, names in DEVICE_KERNELS.items()
            for name in names}


def _device_ops(prof) -> int:
    """How many operations (kernels and copies) a profile saw run on
    the card."""
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def phase_serve(torch, np, dev, spec=SERVE, phase: str = "serve",
                seed: int = 0):
    """A serving path at the arch's full width and depth, bfloat16:
    ``spec`` is (arch, batch, prompt length, new tokens); a frontend's
    embeddings come from ``seed`` and live on the card, as the stub's
    output would."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.serve.loop import BatchServer
    arch, batch, prompt_len, new = spec
    cfg = configs.get(arch)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = registry.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    srv = BatchServer(cfg, params, max_new_tokens=new, device=dev)
    prompts = serve_prompts(np, cfg.vocab, batch, prompt_len, seed=4)
    fe = frontend_embeds(np, cfg, batch, prompt_len, seed)
    fe = None if fe is None else torch.from_numpy(fe).to(dev)
    logits, _ = srv._prefill(params, torch.from_numpy(prompts).to(dev), fe)
    if logits.shape != (batch, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{phase}: prefill logits "
                             f"{tuple(logits.shape)} not finite")
    del logits
    srv.generate(prompts, fe)                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(3):
        _zero_kernel_counts()
        out = srv.generate(prompts, fe)
        counts = _kernel_counts()
        st = out["stats"]
        tok = out["tokens"]
        if (tok.shape != (batch, new) or tok.min() < 0
                or tok.max() >= cfg.vocab):
            raise AssertionError(f"{phase}: tokens {tok.shape}, range "
                                 f"{tok.min()}..{tok.max()}")
        want = expected_launches(cfg, st.decode_steps)
        if counts != want:
            raise AssertionError(f"{phase}: launches {counts}, expected "
                                 f"{want}")
        runs.append({"prefill_s": st.prefill_s, "decode_s": st.decode_s,
                     "per_token_ms": st.per_token_ms,
                     "throughput_tok_s": st.throughput_tok_s,
                     "decode_steps": st.decode_steps,
                     "tokens_out": st.tokens_out, "launches": counts})
    peak = torch.cuda.max_memory_allocated()
    slstm = (slstm_share(torch, srv, params,
                         torch.from_numpy(prompts).to(dev))
             if cfg.family == "xlstm" else None)
    drops = None
    if cfg.n_experts:
        _, kept = moe_keeps(lambda: srv._prefill(
            params, torch.from_numpy(prompts).to(dev), fe))
        drops = {"capacity": kept[0][0], "slots": int(kept[0][1].numel()),
                 "dropped_by_layer": [int((~k).sum()) for _, k in kept]}
        drops["dropped_share"] = (sum(drops["dropped_by_layer"])
                                  / (drops["slots"] * len(kept)))
    # one profiled generate: each kernel's share of the device time
    _zero_kernel_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        srv.generate(prompts, fe)
        torch.cuda.synchronize()
    gen_launched = _launched()
    by_kernel, gen_seen = _device_kernels(prof, gen_launched)
    total = sum(by_kernel.values())
    share = {k: sum(us for n, us in by_kernel.items() if k in n)
             / total for k in gen_launched if gen_launched[k]}
    # decode steps alone, profiled: the device's idle share and where a
    # decode step's device time goes
    _, cache = srv._prefill(params, torch.from_numpy(prompts).to(dev), fe)
    tok = torch.zeros(batch, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    n_steps = min(new - 1, PROFILED_DECODE_STEPS)
    _zero_kernel_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logits, cache = srv._decode(params, tok, cache)
            tok = logits.argmax(dim=-1).to(torch.int32)
            tok.cpu()                            # as generate reads it
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dec_launched = _launched()
    dec, dec_seen = _device_kernels(prof, dec_launched)
    busy_s = sum(dec.values()) / 1e6
    top = sorted(dec.items(), key=lambda kv: -kv[1])[:8]
    med = {k: statistics.median(r[k] for r in runs)
           for k in ("prefill_s", "decode_s", "per_token_ms",
                     "throughput_tok_s")}
    emit(phase, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_params=cfg.n_params(), dtype="bfloat16", batch=batch,
         prompt_len=prompt_len, max_new_tokens=new, init_s=init_s, runs=runs,
         median=med, peak_memory_bytes=peak,
         generate_device_ms=total / 1e3,
         kernel_share_of_device_time=share,
         generate_kernel_launches=gen_launched,
         generate_kernel_records_seen=gen_seen,
         decode_profiled_steps=n_steps, decode_profiled_wall_s=wall,
         decode_device_busy_s=busy_s,
         decode_device_idle_share=1 - busy_s / wall,
         decode_step_device_ops=_device_ops(prof) / n_steps,
         decode_kernel_launches=dec_launched,
         decode_kernel_records_seen=dec_seen,
         decode_step_device_ms_by_kernel={
             k[:80]: us / 1e3 / n_steps for k, us in top},
         prefill_slstm=slstm, prefill_moe_drops=drops,
         frontend_embeds=None if fe is None else list(fe.shape))
    del srv, params, cache, logits, tok, fe, prof
    torch.cuda.empty_cache()
    return runs[0]["launches"]


def slstm_share(torch, srv, params, prompts) -> dict:
    """One prefill with ``slstm_seq`` (the sLSTM loop over S, which has
    no kernel) timed call by call, synchronised at both ends: its
    seconds and its share of that prefill's wall time."""
    from repro_torch.models import xlstm
    inner = xlstm.slstm_seq
    spent = []

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out
    xlstm.slstm_seq = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv._prefill(params, prompts)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        xlstm.slstm_seq = inner
    return {"calls": len(spent), "slstm_s": sum(spent), "prefill_s": total,
            "share": sum(spent) / total}


def phase_serve_parity(torch, np, dev, arch: str = SERVE[0],
                       spec=PARITY, phase: str = "serve_parity"):
    """Full width, cut depth, float32: the card (kernels) against the
    CPU (plain versions) on the same parameters and frontend embeddings.
    ``spec`` is (layers, batch, prompt length, new tokens, config
    overrides).  A MoE's first layer must drop the same slots on both
    sides in prefill, and some."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.serve.loop import BatchServer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = 1e-3            # float32 sums of 2,560-24,576 terms in other
    #                       orders (cuBLAS vs the CPU BLAS, kernels vs
    #                       plain versions): about 1e-5 of the logits
    n_layers, batch, prompt_len, new, overrides = spec
    cfg = dataclasses.replace(configs.get(arch), n_layers=n_layers,
                              dtype=torch.float32, **overrides)
    torch.cuda.empty_cache()
    gpu = registry.init(cfg, torch.Generator(device=dev).manual_seed(1),
                        device=dev)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}
    cpu = to_cpu(gpu)
    prompts = serve_prompts(np, cfg.vocab, batch, prompt_len, seed=5)
    fe = frontend_embeds(np, cfg, batch, prompt_len, seed=6)
    fe_c, fe_h = ((None, None) if fe is None
                  else (torch.from_numpy(fe).to(dev), torch.from_numpy(fe)))
    card = BatchServer(cfg, gpu, max_new_tokens=new, device=dev)
    host = BatchServer(cfg, cpu, max_new_tokens=new, device="cpu")
    # logits of prefill and of every decode step, both fed the card's
    # greedy tokens
    ((lc, cc), (lh, ch)), kept = moe_keeps(lambda: (
        card._prefill(gpu, torch.from_numpy(prompts).to(dev), fe_c),
        host._prefill(cpu, torch.from_numpy(prompts), fe_h)))
    drops = None
    if cfg.n_experts:
        first_c, first_h = kept[0][1], kept[cfg.n_layers][1]
        drops = int((~first_h).sum())
        if not torch.equal(first_c, first_h) or drops == 0:
            raise AssertionError(f"{phase}: first layer's dropped slots "
                                 f"{int((~first_c).sum())} on the card, "
                                 f"{drops} on the CPU (must be equal, "
                                 f"non-empty)")
    errs, gaps = [], []
    for step in range(new):
        lc_h = lc.cpu()
        errs.append(float((lc_h - lh).abs().max()))
        scale = float(lh.abs().max())
        if not errs[-1] <= tol * max(1.0, scale):
            raise AssertionError(f"{phase} step {step}: max abs err "
                                 f"{errs[-1]} (logit scale {scale})")
        tc, th = lc_h.argmax(-1), lh.argmax(-1)
        for lane in np.nonzero((tc != th).numpy())[0]:
            top2 = lh[lane].topk(2).values
            gap = float(top2[0] - top2[1])
            gaps.append({"step": step, "lane": int(lane), "gap": gap})
            if gap >= tol * max(1.0, scale):
                raise AssertionError(f"{phase}: token differs at "
                                     f"step {step} lane {lane} with top-2 "
                                     f"gap {gap}")
        if step == new - 1:
            break
        lc, cc = card._decode(gpu, tc.to(torch.int32).to(dev), cc)
        lh, ch = host._decode(cpu, tc.to(torch.int32), ch)
    out_c = card.generate(prompts, fe)
    out_h = host.generate(prompts, fe)
    same = bool((out_c["tokens"] == out_h["tokens"]).all())
    if not same and not gaps:
        raise AssertionError(f"{phase}: generate tokens differ")
    sc, sh = out_c["stats"], out_h["stats"]
    if (sc.decode_steps, sc.tokens_out) != (sh.decode_steps, sh.tokens_out):
        raise AssertionError(f"{phase}: decode_steps, tokens_out "
                             f"{(sc.decode_steps, sc.tokens_out)} on the "
                             f"card, {(sh.decode_steps, sh.tokens_out)} "
                             f"on the CPU")
    emit(phase, arch=cfg.name, n_layers=n_layers, overrides=overrides,
         dtype="float32",
         batch=batch, prompt_len=prompt_len, new_tokens=new, tolerance=tol,
         logits_max_abs_err=errs, token_gaps_where_differ=gaps,
         tokens_equal=same, decode_steps=sc.decode_steps,
         tokens_out=sc.tokens_out, first_layer_prefill_dropped=drops,
         frontend_embeds=None if fe is None else list(fe.shape))
    del card, host, gpu, cpu, cc, ch, lc, lh
    torch.cuda.empty_cache()


def replayed(report) -> dict:
    """The report without wall time and without the live sections'
    ``mode`` (``record`` or ``replay``), the fields a replay of a
    recorded run must reproduce."""
    d = strip_wall(report)
    d["live"] = {k: {f: x for f, x in sec.items() if f != "mode"}
                 for k, sec in d["live"].items()}
    return d


def phase_live_serve(torch, dev):
    """``record_live_serve`` on the card (the JAX recorder's smoke
    config), replayed bit-identically under the barrier and async
    engines (``single`` takes one host; the scenario has two)."""
    import tempfile

    from repro_torch.sim import (CostLedger, live_serve_sim,
                                 record_live_serve, serve_latency)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "live_serve_trace.json"
        _zero_kernel_counts()
        rep, ledger = record_live_serve(path, device=dev)
        counts = {k: c for k, c in _kernel_counts().items()
                  if k in ("flash_attention", "decode_attention")}
        if rep.status != "ok" or min(counts.values()) < 1:
            raise AssertionError(f"live_serve: status {rep.status}, "
                                 f"launches {counts}")
        want = replayed(rep)
        for eng in ("barrier", "async"):
            got = replayed(live_serve_sim(CostLedger.replay(path)).run(
                engine=eng))
            if any(got[f] != want[f] for f in CORE_FIELDS):
                raise AssertionError(f"live_serve: replay on {eng} != "
                                     f"the record run")
    emit("live_serve", status=rep.status, vtime_ns=rep.vtime_ns,
         requests=len(ledger.meta["serve"]["arrivals"]),
         probe_span_ns=ledger.meta["serve_probe"]["probe_span_ns"],
         serve_latency=serve_latency(rep), launches=counts,
         replays_equal=["barrier", "async"])


def _bshd_flat(t, hd: int):
    b, s, h, _ = t.shape
    return t.transpose(1, 2).reshape(b * h, s, hd)


def _bwd_plain(q, k, v, o, do, causal, window):
    """``attention_flat_bwd_plain`` on (B, S, H, hd) tensors, as (B, S,
    H, hd) gradients."""
    from repro_torch.kernels.ref import attention_flat_bwd_plain
    b, hd = q.shape[0], q.shape[-1]
    grads = attention_flat_bwd_plain(
        *(_bshd_flat(t, hd) for t in (q, k, v, o, do)), causal=causal,
        window=window)
    return [g.reshape(b, t.shape[2], t.shape[1], hd).transpose(1, 2)
            for g, t in zip(grads, (q, k, v))]


def _bwd_err(got, want) -> tuple:
    """(max abs error, largest |plain gradient|) over dq, dk, dv."""
    err = scale = 0.0
    for a, w in zip(got, want):
        if w.numel():
            err = max(err, _err(a, w))
            scale = max(scale, float(w.float().abs().max()))
    return err, scale


def _bwd_route(torch, dt, hd) -> str:
    """The source the backward's route table must pick."""
    from repro_torch.kernels.flash_attention import uses_sm90_bwd
    return ("flash_attention_bwd_sm90.cu" if uses_sm90_bwd(dt, hd)
            else "flash_attention_bwd.cu")


def phase_flash_attention_bwd(torch, np, dev):
    """The attention backward kernels (``csrc/flash_attention_bwd_sm90.cu``
    for bf16 up to hd 128, ``csrc/flash_attention_bwd.cu`` otherwise)
    against their plain version (``attention_flat_bwd_plain``) on the
    card, within ``ATTN_TOL`` x max(1, largest |plain gradient|), each
    case on the source its dtype and head dim pick; timed at the
    trainer's shape beside SDPA's backward (its forward done before the
    timed window); two calls bit-equal; and through ``ops.flash_attention``
    under autograd on non-contiguous (B, S, H, hd) views."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_bshd,
                                                     flash_attention_bwd)
    g = torch.Generator(device=dev).manual_seed(11)
    main, edge = [], []
    for dt in (torch.bfloat16, torch.float32):
        dname = _dname(torch, dt)
        for name, b, h, hkv, sq, sk, hd, causal, window, timed in \
                FLASH_BWD_CASES:
            q, do = (torch.randn(b, sq, h, hd, generator=g,
                                 device=dev).to(dt) for _ in range(2))
            k, v = (torch.randn(b, sk, hkv, hd, generator=g,
                                device=dev).to(dt) for _ in range(2))
            with torch.no_grad():
                o = flash_attention_bshd(q, k, v, causal=causal,
                                         window=window)
            got = flash_attention_bwd(q, k, v, o, do, causal=causal,
                                      window=window)
            source = flash_attention_bwd.source
            if source != _bwd_route(torch, dt, hd):
                raise AssertionError(f"flash_attention_bwd: {name} "
                                     f"({dname}) ran {source}")
            again = flash_attention_bwd(q, k, v, o, do, causal=causal,
                                        window=window)
            want = _bwd_plain(q, k, v, o, do, causal, window)
            torch.cuda.synchronize()
            err, scale = _bwd_err(got, want)
            _hold("flash_attention_bwd", err, dname, name, scale)
            bit_equal = all(torch.equal(a, c) for a, c in zip(got, again))
            if not bit_equal:
                raise AssertionError(f"flash_attention_bwd: two calls "
                                     f"differ at {name} ({dname})")
            del got, again, want
            if not timed:
                edge.append({"case": name, "dtype": dname, "source": source,
                             "max_abs_err": err, "scale": scale})
                continue
            kern = lambda: flash_attention_bwd(q, k, v, o, do, causal=causal,
                                               window=window)
            plain = lambda: _bwd_plain(q, k, v, o, do, causal, window)
            q4, k4, v4 = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(q4, k4, v4,
                                                 is_causal=causal,
                                                 enable_gqa=True)
            do4 = do.transpose(1, 2)
            lib = lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                              retain_graph=True)
            elt = q.element_size()
            # q, k, v, o, dO read once; dq, dk, dv written once
            n_bytes = elt * (4 * q.numel() + 2 * k.numel() + 2 * v.numel())
            pairs = visible_pairs(sq, sk, causal, window)
            flops = 10 * hd * b * h * pairs
            bound, by = attn_bound_ms(n_bytes, flops, dname)
            main.append({
                "case": name, "dtype": dname, "source": source, "B": b,
                "H": h, "Hkv": hkv, "S": sq, "hd": hd, "max_abs_err": err,
                "scale": scale, "bit_equal": bit_equal,
                **_timings(torch, kern, plain, FLASH_BWD_KERNELS, 10),
                **_library(torch, lib, 10),
                "library": "SDPA backward (torch.autograd.grad of "
                           "scaled_dot_product_attention's output)",
                "bound_ms": bound, "bound_by": by, "flops": flops,
                "bytes": n_bytes,
                "fp32_cuda_core_bound_ms": flops / PEAK_FLOPS["float32"]
                * 1e3})
            del out, q4, k4, v4
    strided = []
    for dt in (torch.bfloat16, torch.float32):
        b, s, h, hkv, hd = 2, 150, 8, 2, 64
        x = torch.randn(b, s, h + 2 * hkv, hd, generator=g,
                        device=dev).to(dt).requires_grad_()
        q, k, v = x[:, :, :h], x[:, :, h:h + hkv], x[:, :, h + hkv:]
        do = torch.randn(b, s, h, hd, generator=g, device=dev).to(dt)
        o = ops.flash_attention(q, k, v, causal=True, window=40)
        (gx,) = torch.autograd.grad(o, (x,), do)
        source = flash_attention_bwd.source
        if source != _bwd_route(torch, dt, hd):
            raise AssertionError(f"flash_attention_bwd: strided ({dt}) ran "
                                 f"{source}")
        want = _bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(),
                          do, True, 40)
        torch.cuda.synchronize()
        err, scale = _bwd_err([gx], [torch.cat(want, dim=2)])
        _hold("flash_attention_bwd", err, _dname(torch, dt), "strided",
              scale)
        strided.append({"view": "fused", "dtype": _dname(torch, dt),
                        "source": source, "contiguous": q.is_contiguous(),
                        "max_abs_err": err})
    emit("flash_attention_bwd", tolerance=ATTN_TOL,
         tolerance_relative_to="max(1, largest |plain gradient|)",
         shapes=main, edge=edge, strided=strided)
    return main[0]


def phase_train(torch, np, dev, spec=TRAIN, phase: str = "train"):
    """A training path: ``Trainer`` at the arch's full width in bfloat16
    (random weights from a seed, synthetic data with the frontend's
    embeddings), AdamW, no checkpoint; ``spec`` is (arch, batch, sequence
    length, warm-up steps, timed steps, layers or None).  Each step with
    the kernel counters set to 0 just before and read just after and
    checked against ``expected_train_launches``; a MoE's dropped slots
    counted in the warm-up step (the count reads the card); then one
    profiled step (the card's idle share, the top device operations, the
    classes of ``TRAIN_OP_CLASSES``) and one gradient of the trained
    parameters, every leaf present and finite."""
    import dataclasses
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.train.step import grads_of
    arch, batch, seq_len, warm, timed, n_layers = spec
    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    drops = None
    with tempfile.TemporaryDirectory() as ckpt:
        tcfg = TrainerConfig(n_steps=warm + timed + 1, seq_len=seq_len,
                             global_batch=batch, n_microbatch=1,
                             checkpoint_every=10 ** 9, checkpoint_dir=ckpt,
                             log_every=10 ** 9, seed=0)
        tr = Trainer(cfg, tcfg, log_fn=lambda _s: None, device=dev)
        t0 = time.perf_counter()
        params, opt = tr.init_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        want = expected_train_launches(cfg, 1)
        steps = []
        for step in range(warm + timed):
            data = tr.data.batch(step)
            torch.cuda.synchronize()
            _zero_kernel_counts()
            t0 = time.perf_counter()
            if cfg.n_experts and step == 0:
                (params, opt, metrics), kept = moe_keeps(
                    lambda: tr.step(params, opt, step, data))
                # each layer's forward; under remat the backward's
                # recomputation follows
                drops = [int((~keep).sum())
                         for _cap, keep in kept[:cfg.n_layers]]
            else:
                params, opt, metrics = tr.step(params, opt, step, data)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _kernel_counts()
            if counts != want:
                raise AssertionError(f"{phase} step {step}: launches "
                                     f"{counts}, expected {want}")
            gnorm = float(metrics["grad_norm"])
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"{phase} step {step}: loss {loss}, "
                                     f"grad_norm {gnorm}")
            steps.append({"step": step, "wall_s": wall, "loss": loss,
                          "grad_norm": gnorm, "lr": float(metrics["lr"]),
                          "launches": counts})
        peak = torch.cuda.max_memory_allocated()
        # one profiled step: the card's idle share and the top operations
        data = tr.data.batch(warm + timed)
        torch.cuda.synchronize()
        _zero_kernel_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, metrics = tr.step(params, opt, warm + timed, data)
            float(metrics["loss"])
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        launched = _launched()
        if _kernel_counts() != want:
            raise AssertionError(f"{phase} profiled step: launches "
                                 f"{_kernel_counts()}, expected {want}")
        by_kernel, seen = _device_kernels(prof, launched)
        busy_s = sum(by_kernel.values()) / 1e6
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
        by_class = {}
        for k, us in by_kernel.items():
            c = next((c for c, keys in TRAIN_OP_CLASSES
                      if any(x in k for x in keys)), "other")
            by_class[c] = by_class.get(c, 0.0) + us / 1e3
        # every parameter gets a finite gradient
        opt = None
        torch.cuda.empty_cache()
        data = tr.data.batch(0)
        grads, _ = grads_of(cfg, params, data["tokens"], data["labels"],
                            data.get("frontend_embeds"))
        leaves = tree_leaves(grads)
        bad = [i for i, gl in enumerate(leaves)
               if gl is None or not bool(torch.isfinite(gl).all())]
        n_leaves = len(leaves)
        if bad or n_leaves != len(tree_leaves(params)):
            raise AssertionError(f"{phase}: {len(bad)} parameter leaves "
                                 f"without a finite gradient")
        fe = data.get("frontend_embeds")
        del grads, leaves, params, tr, data
    torch.cuda.empty_cache()
    timed_walls = [r["wall_s"] for r in steps[warm:]]
    med = statistics.median(timed_walls)
    emit(phase, arch=cfg.name, n_layers=cfg.n_layers,
         n_enc_layers=cfg.n_enc_layers, d_model=cfg.d_model,
         n_params=cfg.n_params(), dtype="bfloat16", remat=cfg.remat,
         global_batch=batch, seq_len=seq_len, n_microbatch=1,
         frontend_embeds=None if fe is None else list(fe.shape),
         warmup_steps=warm, init_s=init_s, steps=steps,
         step_s_median=med, tokens_per_s=batch * seq_len / med,
         peak_memory_bytes=peak, expected_launches_per_step=want,
         moe_slots=None if drops is None else
         batch * seq_len * cfg.top_k,
         moe_dropped_slots_by_layer=drops,
         profiled_step_wall_s=prof_wall, profiled_step_device_busy_s=busy_s,
         profiled_step_device_idle_share=1 - busy_s / prof_wall,
         profiled_step_device_ops=_device_ops(prof),
         profiled_step_kernel_launches=launched,
         profiled_step_kernel_records_seen=seen,
         profiled_step_device_ms_by_op={k[:80]: us / 1e3 for k, us in top},
         profiled_step_device_ms_by_class=by_class,
         finite_gradient_leaves=n_leaves)
    return {k: v * timed for k, v in want.items()}


def phase_train_parity(torch, np, dev, spec=TRAIN_PARITY,
                       arch: str = TRAIN[0], overrides=None,
                       phase: str = "train_parity"):
    """Full width, cut depth, float32: the same train steps on the card
    (kernels) and on the CPU (plain versions), from the same parameters
    and batches (with the frontend's embeddings).  Per step, loss and
    grad norm within 1e-4 relative, and a MoE's first layer dropping the
    same slots on both sides, and some; after the last, every parameter
    and AdamW moment within 1e-4 x max(1, the leaf's largest |value|)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.shapes import frontend_tokens
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.step import build_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = 1e-4
    n_layers, batch, seq_len, n_steps, peak_lr = spec
    overrides = overrides or {}
    cfg = dataclasses.replace(configs.get(arch), n_layers=n_layers,
                              dtype=torch.float32, **overrides)
    n_front = frontend_tokens(cfg, seq_len)
    torch.cuda.empty_cache()
    gpu = registry.init(cfg, torch.Generator(device=dev).manual_seed(3),
                        device=dev)
    cpu = tree_map(lambda t: t.to("cpu", copy=True), gpu)
    states = {"card": (gpu, adamw_init(gpu)), "cpu": (cpu, adamw_init(cpu))}
    del gpu, cpu
    step = build_train_step(cfg, lr_kwargs=dict(peak_lr=peak_lr, warmup=1,
                                                total=10))
    rows = []
    _zero_kernel_counts()
    seconds = {"card": 0.0, "cpu": 0.0}
    for i in range(n_steps):
        out, first = {}, {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            data = SyntheticLMData(vocab=cfg.vocab, seq_len=seq_len,
                                   global_batch=batch, seed=5,
                                   frontend_dim=cfg.frontend_dim,
                                   frontend_tokens=n_front, device=d)
            t0 = time.perf_counter()
            (p, o, m), kept = moe_keeps(
                lambda: step(*states[where], i, data.batch(i)))
            out[where] = {k: float(v) for k, v in m.items()}
            seconds[where] += time.perf_counter() - t0
            states[where] = (p, o)
            first[where] = kept[0][1] if kept else None
        rel = {k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])
               for k in ("loss", "grad_norm")}
        if not all(r <= tol for r in rel.values()):
            raise AssertionError(f"{phase} step {i}: {out} ({rel})")
        drops = None
        if cfg.n_experts:
            drops = int((~first["cpu"]).sum())
            if not torch.equal(first["card"], first["cpu"]) or drops == 0:
                raise AssertionError(
                    f"{phase} step {i}: first layer's dropped slots "
                    f"{int((~first['card']).sum())} on the card, {drops} "
                    f"on the CPU (must be equal, non-empty)")
        rows.append({"step": i, **{f"{k}_card": out["card"][k]
                                   for k in ("loss", "grad_norm", "lr")},
                     **{f"{k}_cpu": out["cpu"][k]
                        for k in ("loss", "grad_norm")}, "rel_err": rel,
                     "first_layer_dropped": drops})
    counts = _kernel_counts()
    want = expected_train_launches(cfg, n_steps)
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts}, expected {want}")
    (pc, oc), (ph, oh) = states["card"], states["cpu"]
    worst = {}
    for part, a_tree, c_tree in (("params", pc, ph), ("m", oc["m"], oh["m"]),
                                 ("v", oc["v"], oh["v"])):
        errs = []
        for a, c in zip(tree_leaves(a_tree), tree_leaves(c_tree)):
            scale = max(1.0, float(c.abs().max()))
            errs.append(float((a.cpu() - c).abs().max()) / scale)
        worst[part] = max(errs)
        if not worst[part] <= tol:
            raise AssertionError(f"{phase}: {part} differ by "
                                 f"{worst[part]} (relative to max(1, "
                                 f"scale))")
    del states, pc, oc, ph, oh
    torch.cuda.empty_cache()
    emit(phase, arch=cfg.name, n_layers=n_layers, overrides=overrides,
         dtype="float32", remat=cfg.remat, batch=batch, seq_len=seq_len,
         frontend_tokens=n_front, steps=rows,
         peak_lr=peak_lr, tolerance=tol, worst_relative_to_scale=worst,
         launches=counts, seconds=seconds)
    return counts


def _recorded_phase(torch, dev, record, sim_of, phase: str, check):
    """Record a live trace on the card with ``record(path, device=dev)``,
    with the kernel counters set to 0 just before; hold it with
    ``check(report, ledger, labels)``; replay it bit-identically under
    the barrier and async engines (``single`` takes one host, the
    scenarios span several).  Returns (report, ledger, counts)."""
    import tempfile

    from repro_torch.sim import CostLedger
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / f"{phase}_trace.json"
        _zero_kernel_counts()
        rep, ledger = record(path, device=dev)
        counts = _kernel_counts()
        if rep.status != "ok":
            raise AssertionError(f"{phase}: status {rep.status}")
        labels = {t: [e["label"] for e in es]
                  for t, es in json.loads(path.read_text())["tasks"].items()}
        check(rep, ledger, labels)
        want = replayed(rep)
        for eng in ("barrier", "async"):
            got = replayed(sim_of(CostLedger.replay(path)).run(engine=eng))
            if any(got[f] != want[f] for f in CORE_FIELDS):
                raise AssertionError(f"{phase}: replay on {eng} != the "
                                     f"record run")
    return rep, ledger, counts, labels


def phase_live_recovery(torch, dev):
    """``record_live_recovery`` on the card (the JAX recorder's smoke
    config): the real trainer loses a host under simulated time, restores
    its last committed checkpoint, re-meshes and resumes.  The timeline is
    ordered (detect < restore < remesh <= resumed), the restore comes from
    a checkpoint the run committed, and the trace replays bit-identically."""
    from repro_torch.sim import (live_recovery_sim, record_live_recovery,
                                 recovery_timeline)

    def check(rep, ledger, labels):
        tl = recovery_timeline(rep)
        v = {e["event"]: e["vtime"] for e in tl}
        if not v.get("detect", 0) < v.get("restore", 0) < v.get(
                "remesh", 0) <= v.get("resumed", -1):
            raise AssertionError(f"live_recovery: timeline {tl}")
        trainer = labels["live.trainer"]
        saved = [int(x.split(":")[1])
                 for x in trainer[:trainer.index("restore:1")]
                 if x.startswith("save:")]
        restored = {e["event"]: e["step"] for e in tl}["restore"]
        if restored not in saved:
            raise AssertionError(f"live_recovery: restored step {restored} "
                                 f"is no committed checkpoint ({trainer})")
    rep, ledger, counts, labels = _recorded_phase(
        torch, dev, record_live_recovery, live_recovery_sim,
        "live_recovery", check)
    if counts["flash_attention"] < 1 or counts["flash_attention_bwd"] < 1:
        raise AssertionError(f"live_recovery: launches {counts}")
    emit("live_recovery", status=rep.status, vtime_ns=rep.vtime_ns,
         timeline=recovery_timeline(rep), labels=labels,
         fail_probe=ledger.meta.get("fail_probe"), launches=counts,
         replays_equal=["barrier", "async"])


def phase_live_colocated(torch, dev):
    """``record_live_colocated`` on the card: the real trainer and the
    real server in one §3.3 cell, one multi-driver trace; non-empty serve
    latencies, and the trace replays bit-identically."""
    from repro_torch.sim import (live_colocated_sim, record_live_colocated,
                                 serve_latency)

    def check(rep, ledger, labels):
        if not serve_latency(rep):
            raise AssertionError("live_colocated: no serve latencies")
    rep, ledger, counts, labels = _recorded_phase(
        torch, dev, record_live_colocated, live_colocated_sim,
        "live_colocated", check)
    if min(counts[k] for k in ("flash_attention", "flash_attention_bwd",
                               "decode_attention")) < 1:
        raise AssertionError(f"live_colocated: launches {counts}")
    emit("live_colocated", status=rep.status, vtime_ns=rep.vtime_ns,
         serve_latency=serve_latency(rep), labels=labels,
         serve_probe=ledger.meta.get("serve_probe"), launches=counts,
         replays_equal=["barrier", "async"])


def main() -> int:
    card = use_one_card()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.sim  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    phase_device(torch, card)
    phase_build()
    floor = phase_launch_floor(torch, dev)
    ms = phase_minskew(torch, np, dev, floor)
    hr = phase_hub_route(torch, np, dev, floor)
    launches = phase_main_path(torch, dev)
    phase_main_path_breakdown(torch, dev)
    axis, tick, sweep_launches = phase_sweep(torch, dev)
    phase_check_interval(torch, np, dev, axis, tick)
    campaign_main_launches = phase_campaign_main(torch, dev)
    campaign_launches = phase_campaign(torch, dev)
    fa = phase_flash_attention(torch, np, dev)
    fb = phase_flash_attention_bwd(torch, np, dev)
    da = phase_decode_attention(torch, np, dev)
    rg = phase_rglru_scan(torch, np, dev)
    ml = phase_mlstm_chunkwise(torch, np, dev)
    by_path = {"serve": phase_serve(torch, np, dev)}
    phase_serve_parity(torch, np, dev)
    by_path["serve_rglru"] = phase_serve(torch, np, dev, SERVE_RGLRU,
                                         "serve_rglru", seed=8)
    phase_serve_parity(torch, np, dev, SERVE_RGLRU[0], PARITY_RGLRU,
                       "serve_parity_rglru")
    by_path["serve_xlstm"] = phase_serve(torch, np, dev, SERVE_XLSTM,
                                         "serve_xlstm", seed=9)
    phase_serve_parity(torch, np, dev, SERVE_XLSTM[0], PARITY_XLSTM,
                       "serve_parity_xlstm")
    phase_live_serve(torch, dev)
    for spec, parity, fam, seed in (
            (SERVE_MOE, PARITY_MOE, "moe", 10),
            (SERVE_VLM, PARITY_VLM, "vlm", 11),
            (SERVE_ENCDEC, PARITY_ENCDEC, "encdec", 12)):
        by_path[f"serve_{fam}"] = phase_serve(torch, np, dev, spec,
                                              f"serve_{fam}", seed=seed)
        phase_serve_parity(torch, np, dev, spec[0], parity,
                           f"serve_parity_{fam}")
    by_path["train"] = phase_train(torch, np, dev)
    by_path["train_parity"] = phase_train_parity(torch, np, dev)
    parity = {fam: rest for fam, *rest in TRAIN_PARITY_FAMILIES}
    for fam, spec in TRAIN_FAMILIES:
        by_path[f"train_{fam}"] = phase_train(torch, np, dev, spec,
                                              f"train_{fam}")
        arch, pspec, overrides = parity[fam]
        by_path[f"train_parity_{fam}"] = phase_train_parity(
            torch, np, dev, pspec, arch, overrides, f"train_parity_{fam}")
    phase_live_recovery(torch, dev)
    phase_live_colocated(torch, dev)
    paths = {k: {"main_path": launches[k], "sweep": sweep_launches[k],
                 "campaign_main": campaign_main_launches[k],
                 "campaign": campaign_launches[k]}
             for k in ("minskew", "hub_route")}
    for kname in ("flash_attention", "flash_attention_bwd",
                  "decode_attention", "rglru_scan", "mlstm_chunkwise"):
        paths[kname] = {p: c[kname] for p, c in by_path.items() if c[kname]}
    kernels = []
    for kname, row, src, tpu in (
            ("minskew", ms, "src/repro_torch/kernels/csrc/minskew.cu",
             "src/repro/kernels/minskew.py:67"),
            ("hub_route", hr, "src/repro_torch/kernels/csrc/hub_route.cu",
             "src/repro/kernels/hub_route.py:78"),
            ("flash_attention", fa,
             "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:91"),
            ("flash_attention_bwd", fb,
             "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
             "gradient of src/repro/kernels/flash_attention.py:91 (the JAX "
             "package differentiates its jnp attention; no Pallas kernel)"),
            ("decode_attention", da,
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:74"),
            ("rglru_scan", rg, "src/repro_torch/kernels/csrc/rglru_scan.cu",
             "src/repro/kernels/rglru_scan.py:60"),
            ("mlstm_chunkwise", ml,
             f"src/repro_torch/kernels/csrc/{ml['kernel']}",
             "src/repro/kernels/mlstm_kernel.py:79")):
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sum(paths[kname].values()),
            "launches_by_path": paths[kname],
            "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"],
            "kernel_ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "device_ms": row["kernel_device_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row.get("bound_by", "bytes"),
            "library_ms": row.get("library_ms"),
            **({"launch_floor_ms": row["launch_floor_ms"]}
               if "launch_floor_ms" in row else {}),
            "shape": {k: row[k] for k in row
                      if k in ("V", "N", "S", "M", "links", "B", "H", "Hkv",
                               "hd", "dtype", "lengths", "W", "BH")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
