#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold it to its plain
versions.

    python3 chip_smoke.py [--phases NAME,...]

Run from the root of a checkout.  It needs one CUDA card and ``nvcc``,
imports only ``repro_torch``, ``torch``, numpy and the standard library,
and catches nothing: any mismatch raises and the exit code is non-zero.
One JSON line per phase:

1. device — the card, ``nvidia-smi``'s name and power limit, versions;
2. build — every CUDA source of ``_build.SOURCES`` (seventeen: the
   forward kernels, the attention and recurrences' backwards, first
   designs included, and the empty ``launch_floor`` kernel) compiled from
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
   256 frames; the decoder's 1,024 causal), float32 alone at the train
   parity phases' shape (B=2, S=128, 32/8 heads, hd 128, causal) and at
   serve_parity_rglru's prefill (B=2, S=2,080, 16/1 heads, hd 256,
   window 2,048): the shapes where the float32 kernel runs on a path;
   untimed at olmoe_1b_7b's
   prefill (16/16 heads, hd 128), at hd 8, 24 and 40, one query row,
   Sq < Sk under the causal mask and a window narrower than a key tile,
   and through ``ops.flash_attention`` on non-contiguous (B, S, H, hd)
   views; each case with the source that ran
   (``csrc/flash_attention_sm90.cu`` for bfloat16,
   ``csrc/flash_attention_tf32x3.cu``, split TF32, for float32), two
   float32 calls bit-equal, a float32 row's bound at the TF32 peak times
   three, the CUDA-core bound beside it;
11b. flash_attention_bwd — the attention backward kernels vs their plain
   version (``attention_flat_bwd_plain``): bfloat16 on the tensor cores
   (``csrc/flash_attention_bwd_sm90.cu``; above hd 128 its columns and
   query heads split, with a reduction kernel), float32 on the tensor
   cores as split TF32 products (``csrc/flash_attention_bwd_tf32x3.cu``;
   above hd 128 its query heads split the same way), each case with the
   source and head parts that ran; a float32 row's bound at the TF32 peak
   times three (the split's products), the CUDA-core bound beside it;
   at the trainer's shape (B=4, S=1,024, 32/8
   heads, hd 128, causal; bfloat16 and float32, timed beside SDPA's
   backward, two calls bit-equal), at the shapes the other families'
   train steps give it (timed the same way: seamless_m4t_medium's
   cross-attention, 1,024 queries over 256 frames, non-causal, its
   encoder's 256 frames, non-causal, and its decoder's 1,024 causal, all
   16/16 heads at hd 64; olmoe_1b_7b's 16/16 heads at hd 128, causal;
   recurrentgemma_9b's train shape, B=4, S=1,024, 16/1 heads at hd 256,
   causal, window 2,048, beside SDPA's backward under a boolean band
   mask), recurrentgemma's window shape (MQA, hd 256, window 2,048) and the
   edge shapes (hd 8/24/40/64/96, Sq < Sk, Sq and Sk off the tiles, GQA
   8, windows 5 and 40, Sk = 0; above hd 128: a binding window at 16/1
   heads, 6 heads a group split unevenly, hd 192, hd 136 with Sq < Sk,
   Sk = 0), each row with the head parts of its dk/dv blocks, and
   through ``ops.flash_attention`` under autograd on non-contiguous
   views;
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
   shape bit-equal (the plain loop's device time from 2 profiled calls:
   the profiler's host cost per recorded operation);
13b. rglru_scan_bwd — the backward kernel (``csrc/rglru_scan_bwd.cu``)
   vs its plain version (``rglru_bwd_plain``, a loop over S in reverse) at
   recurrentgemma's train shape (B=4, S=1,024, W=4,096) without and with
   h0, and S = 1, S = 515 with W = 4,099, S below the chunk and a long
   chain (B=1, S=16,384, W=1,024, h0 given), every case twice and
   bit-equal, with the kernel's T_c, warps and grid; the plain loop timed
   on few calls;
14. mlstm_chunkwise — the forward kernels (``csrc/mlstm_kernel_sm90.cu``
   for bfloat16 on the tensor cores, ``csrc/mlstm_kernel_tf32x3.cu`` for
   float32 on the tensor cores as split TF32 products,
   ``csrc/mlstm_kernel.cu`` for the head dims neither takes) vs their
   plain version at xlstm's prefill shape (BH=16, S=1,024, hd=1,024),
   bfloat16 and float32, and in float32 at train_parity_xlstm's (BH=8,
   S=200, hd=1,024), each timed in turns with the first design on the
   same tensors (a float32 row's bound at the TF32 peak times three, the
   CUDA-core bound beside it); and edge shapes (S not a multiple of the
   chunk, an initial carry, small hd, hd 100 off both tensor-core routes,
   in bfloat16 a head dim above its kernel's limit), with the final (C, n),
   the source that ran, every case twice and bit-equal;
14b. mlstm_chunkwise_bwd — the backward kernels
   (``csrc/mlstm_kernel_bwd_sm90.cu`` for bfloat16 on the tensor cores,
   ``csrc/mlstm_kernel_bwd_tf32x3.cu`` for float32 on the tensor cores as
   split TF32 products, ``csrc/mlstm_kernel_bwd.cu`` for the head dims
   neither takes) vs their plain version (``mlstm_chunkwise_bwd_plain``)
   at xlstm's train shape (BH=16, S=1,024, hd=1,024) and
   train_parity_xlstm's (BH=8, S=200, hd=1,024), bfloat16 and float32,
   timed beside the first design on the same tensors (a float32 row's
   bound at the TF32 peak times three, the CUDA-core bound beside it);
   S = 200 (a padded tail),
   an initial (C, n), gradients of the final (C, n), the forward phase's
   small shapes and a bf16 head dim off the tensor-core route; each
   gradient by its max abs error and its relative norm, the source its
   dtype and head dim pick, every case twice, bit-equal;
15. serve — the serving path: ``BatchServer`` on full-width, full-depth
   qwen3_4b in bfloat16 (random weights from a seed), 4 prompts of 1,024
   tokens, 32 new tokens; one warm-up ``generate`` and 3 timed ones,
   each with the kernel counters set to 0 just before and read just
   after; then one profiled ``generate`` and 8 profiled decode steps;
16. serve_parity — the same entry point at full width, 2 layers,
   float32: the card's logits and greedy tokens against the CPU run of
   the same parameters (the plain versions); then, on the same
   parameters and prompts, two mesh cases on logical meshes, each a line
   and a path of its own: serve_parity_tp_attention (``tp_attention`` on
   (1, 3): 32 heads padded to 33, flash as MHA; the card's forward
   logits against the card's without the option within 1e-4 and the
   CPU's within 1e-3, and whether card and card are bit-equal) and
   serve_parity_sp_decode (``sp_decode`` on (1, 2): card against CPU,
   whose decode attention is the sharded formula); launches exact;
17. serve_rglru, serve_xlstm — the same serving phase on full-width,
   full-depth recurrentgemma_9b (4 prompts of 3,072 tokens, past the
   2,048 window) and xlstm_1_3b (4 prompts of 1,024 tokens), 32 new
   tokens each, every kernel's launches per ``generate`` checked;
18. serve_parity_rglru, serve_parity_xlstm — card against CPU at full
   width, float32, cut depth: recurrentgemma (rec, rec, attn) with
   prompts of 2,080 tokens, which wrap the window; xlstm one mLSTM and
   one sLSTM block with prompts of 200 tokens, which the kernel pads, its
   mLSTM forward's launches counted, every one on the split-TF32 kernel;
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
   prefill equal on both sides and non-empty; then
   serve_parity_moe_expert_parallel: olmoe on a logical (2, 2) mesh, four
   shards of 64 prompt tokens each routed at capacity 10, every shard's
   first-layer mask equal on both sides, the drops beside the one-shard
   run's; launches exact;
20. train — the training path: ``Trainer`` on full-width, full-depth
   qwen3_4b in bfloat16 (remat, AdamW, global batch 4 of 1,024 tokens),
   one warm-up step and four timed ones, each with the kernel counters
   set to 0 just before and read just after (attention forward twice a
   layer, backward once, nothing else); one profiled step (idle share,
   top device operations); every parameter's gradient present and
   finite; peak memory;
21. train_parity — two train steps at full width, 2 layers, float32,
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
21c. train_rglru, train_xlstm, each followed by its train_parity_* phase
   — the train phase on recurrentgemma_9b (9 of its 38 layers: 6
   recurrent, 3 attention) and xlstm_1_3b (16 of 48: 14 mLSTM, 2 sLSTM)
   at full width, bfloat16, remat, global batch 4 of 1,024 tokens, one
   warm-up, two timed and one profiled step, the launches of every step
   exact (``rglru_scan`` twice and its backward once a recurrent layer,
   the attention kernels likewise; ``mlstm_chunkwise`` twice and its
   backward once an mLSTM layer); then two train steps card against CPU
   at full width in float32 (recurrentgemma 3 layers, rec, rec, attn, at
   S = 128; xlstm one mLSTM and one sLSTM block at S = 200, which the
   kernels pad, its mLSTM forward and backward launches each on its
   split-TF32 kernel) within 1e-4;
21d. dry_run — the dry run (``repro_torch.launch.dryrun``) against the
   train phases: each phase's step traced on meta tensors on a (1, 1)
   mesh by a process of its own (no card visible, lowest priority,
   started after the kernel phases, ``--dry-run-counts``), its predicted peak within 10% of
   the phase's ``max_memory_allocated``, its launches per step by source
   equal to the phase's, its counted FLOPs per step and over the median
   step; then dry_run_cell, the record of qwen3_4b x train_4k x 16x16;
22. live_recovery, live_colocated — ``record_live_recovery`` and
   ``record_live_colocated`` on the card (smoke config): the real trainer
   loses a host, restores a committed checkpoint and re-meshes (ordered
   timeline), or shares a cell with the real server (non-empty
   latencies); each trace replayed bit-identically under the barrier and
   async engines;
23. kernels — one object per kernel: launches on its paths (the main
   path and the sweep for ``minskew`` and ``hub_route``, the train paths
   for the backward kernels; the float32 split-TF32 kernels and the
   float32 flash forward apart, from the parity phases), max error
   against the plain version,
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
(989 TFLOP/s bfloat16 on the tensor cores, 67 TFLOP/s float32 on the CUDA
cores, 494.7 TFLOP/s TF32 for each of a split's three products).  All on
the card named in phase 1.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The H100's memory rate and peaks (HBM_BYTES_PER_S, PEAK_FLOPS) and the
# kernels' work formulas live in the package, where the dry run's meta
# route reads the same count (fails outside a checkout).
from repro_torch.kernels.work import (HBM_BYTES_PER_S,  # noqa: E402
                                      PEAK_FLOPS, mlstm_bwd_stored_bytes,
                                      mlstm_bwd_work, mlstm_work,
                                      visible_pairs)
from repro_torch.kernels.work import bound_ms as attn_bound_ms  # noqa: E402
#: kernel-vs-plain tolerance on the card, absolute, per dtype: bfloat16
#: outputs are rounded once to bfloat16 (2^-8 relative on values of
#: order 1); float32 differ only by the order of the float32 sums.  The
#: recurrences hold it relative to max(1, largest |plain value|).
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: the backward kernels' ||got - want|| / ||want||, for each gradient
#: against its own plain gradient: a wrong or missing tile of small late
#: rows shows here where the max abs error may hide it (about 2.6e-3 for
#: the attention backward's bf16 roundings and at most 3.9e-3 for the
#: mLSTM backward's, at the repo's CPU emulations of the kernels)
ATTN_BWD_REL_NORM = {"bfloat16": 1e-2, "float32": 1e-4}
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


def device_records(prof) -> dict:
    """{name: (records, device us)} of the device operations (kernels,
    copies, fills) a finished profile kept, read from its raw records:
    ``key_averages()`` first builds an event tree, at about 0.2 ms of
    host a record."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, us = out.get(e.name(), (0, 0.0))
            out[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return out


def device_ms(torch, fn, names=None, iters: int = 20):
    """Device time per call of ``fn()`` in ms from ``torch.profiler``,
    and the profiler's records per call.

    Without ``names``: the summed duration of every CUDA kernel it ran,
    over the calls.  With ``names`` (the port's kernels, each launched
    once per call): the sum over those kernels of the mean duration of
    the records the profiler kept, since it keeps only some records of
    a kernel launched through ctypes.  None where it saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [(n, t) for k, (n, t) in device_records(prof).items()
           if t > 0 and (names is None or any(x in k for x in names))]
    records = sum(n for n, _ in evs) / iters
    if not evs:
        return None, records
    if names is None:
        us = sum(t for _, t in evs) / iters
    else:
        us = sum(t / n for n, t in evs)
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
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {k: n for k, (n, _) in device_records(prof).items()}
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
        device_records(prof), {k: minskew.launches for k in MINSKEW_KERNELS})
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
                         intervals=(1, 4, 16), repeats: int = 2):
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


#: the device kernels of one wrapper call: bf16 flash runs the wgmma
#: kernel, fp32 flash the split-TF32 one (one launch either way); decode
#: runs the split kernel and the combine kernel
FLASH_KERNELS = ("flash_sm90_kernel", "flash_fwd_tf32x3")
#: the attention backward: the bf16 tensor-core kernels (above hd 128
#: with the query heads split, a third, the reduction of the parts), the
#: float32 split-TF32 ones (the same three roles), and the first design's
#: CUDA-core pair (on no route; tools/flash_bwd_check.py times it); no
#: name contains another
FLASH_BWD_KERNELS = ("flash_bwd_sm90_q", "flash_bwd_sm90_kv",
                     "flash_bwd_sm90_reduce", "flash_bwd_tf32x3_dq",
                     "flash_bwd_tf32x3_dkdv", "flash_bwd_tf32x3_reduce",
                     "flash_bwd_dq", "flash_bwd_dkdv")
DECODE_KERNELS = ("decode_split_kernel", "decode_combine_kernel")
#: (case, B, H, Hkv, Sq, Sk, hd, causal, window, timed): the serving
#: path's prefill shape (pixtral_12b's too), a longer prompt,
#: recurrentgemma's prefill, seamless_m4t_medium's encoder, cross- and
#: decoder self-attention, olmoe_1b_7b's prefill (MHA, hd 128),
#: tests/test_kernels.py's edge shapes (GQA, padded tail, window, cross
#: attention, hd 128), head dims that are not multiples of 16 (the bf16
#: kernel pads them to 64 in shared memory), one query row, fewer queries
#: than keys under the causal mask, and a window narrower than a key tile;
#: ``timed`` may name the one dtype a case is timed in ("float32": the
#: train parity phases' shape and serve_parity_rglru's prefill, where only
#: the float32 kernel is on a path)
FLASH_CASES = [("main", 4, 32, 8, 1024, 1024, 128, True, 0, True),
               ("s4096", 4, 32, 8, 4096, 4096, 128, True, 0, True),
               ("rglru_prefill", 4, 16, 1, 3072, 3072, 256, True, 2048,
                True),
               ("encdec_enc", 4, 16, 16, 256, 256, 64, False, 0, True),
               ("encdec_cross", 4, 16, 16, 1024, 256, 64, False, 0, True),
               ("encdec_self", 4, 16, 16, 1024, 1024, 64, True, 0, True),
               ("moe_prefill", 4, 16, 16, 1024, 1024, 128, True, 0, False),
               ("parity", 2, 32, 8, 128, 128, 128, True, 0, "float32"),
               ("rglru_parity", 2, 16, 1, 2080, 2080, 256, True, 2048,
                "float32"),
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
#: the mesh cases of the parity phases: (logical mesh shape, the config
#: option set or ``None``) by case; serve_parity runs "tp_attention"
#: (:func:`parity_tp_attention`: 32 heads padded to 33) and "sp_decode",
#: serve_parity_moe "expert_parallel" (a MoE under any mesh; 4 shards of
#: 64 prompt tokens: capacity 10 against a mean load of 8)
PARITY_MESH_CASES = {"tp_attention": ((1, 3), "tp_attention"),
                     "sp_decode": ((1, 2), "sp_decode"),
                     "expert_parallel": ((2, 2), None)}
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
#: in float32 also train_parity_xlstm's and serve_parity_xlstm's shape
#: (B=2 x H=4 at S = 200, padded to 256; timed); hd 100, off both
#: tensor-core routes (not a multiple of 8), where the first design runs
#: in either dtype; in bfloat16 also the prefill shape with an initial
#: carry, and a head dim above the bf16 kernel's limit (SM90_MAX_HD)
BOTH = ("bfloat16", "float32")
MLSTM_CASES = [(16, 1024, 1024, False, True, BOTH),
               (8, 200, 1024, False, True, ("float32",)),
               (2, 128, 32, False, False, BOTH),
               (4, 256, 64, False, False, BOTH),
               (1, 64, 128, False, False, BOTH),
               (2, 200, 64, True, False, BOTH),
               (3, 130, 96, True, False, BOTH),
               (2, 64, 8, True, False, BOTH),
               (1, 70, 100, True, False, BOTH),
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
#: olmoe's (16/16 heads, hd 128); pixtral's is the trainer's shape; and
#: recurrentgemma's train step (16/1 heads at hd 256, window 2,048, timed
#: beside SDPA's backward under a band mask); then, untimed, the bf16
#: route above hd 128 (columns and query heads split): hd 256 at 16/1
#: heads with a binding window, 6 heads a group (split unevenly, 4 parts
#: on an H100), hd 192, hd 136 with Sq < Sk, and Sk = 0 at hd 256
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
                   ("olmoe", 4, 16, 16, 1024, 1024, 128, True, 0, True),
                   ("rglru_train", 4, 16, 1, 1024, 1024, 256, True, 2048,
                    True),
                   ("hd256_mqa_window100", 1, 16, 1, 300, 300, 256, True,
                    100, False),
                   ("hd256_gqa6", 2, 12, 2, 1024, 1024, 256, True, 0,
                    False),
                   ("hd192", 1, 8, 2, 200, 200, 192, True, 0, False),
                   ("hd136_sq_lt_sk", 1, 4, 2, 70, 300, 136, True, 0,
                    False),
                   ("hd256_sk0", 2, 4, 1, 30, 0, 256, True, 0, False)]
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
#: the recurrent train paths, full width, bf16, remat, steps as
#: TRAIN_FAMILIES: recurrentgemma 9 of 38 layers (6 rec + 3 attn, 4.07 B
#: parameters; at about 12 bytes a parameter and 4.2 GB a copy of the
#: float32 logits over 256,000 entries, near 80 GB at 9); xlstm 16 of 48
#: (14 mLSTM + 2 sLSTM), cut for time: the sLSTM is a loop over S with no
#: kernel (ROADMAP B8), run about four times a step under remat
TRAIN_RECURRENT = (("rglru", ("recurrentgemma_9b", 4, 1024, 1, 2, 9)),
                   ("xlstm", ("xlstm_1_3b", 4, 1024, 1, 2, 16)))
#: the train step's device operations by class, from their kernel names
#: (the first class whose key a name contains; the rest are "other")
TRAIN_OP_CLASSES = (("attention_bwd", ("flash_bwd",)),
                    ("attention_fwd", ("flash_sm90", "flash_fwd")),
                    ("recurrence_bwd", ("rglru_bwd", "mlstm_bwd")),
                    ("recurrence_fwd", ("rglru_chained", "mlstm_scores",
                                        "mlstm_den", "mlstm_carry",
                                        "mlstm_tf32x3", "scores_kernel",
                                        "carry_kernel")),
                    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                    ("elementwise", ("elementwise", "copy", "fill")),
                    ("reduction", ("reduce", "softmax", "logsumexp",
                                   "index", "scatter", "gather")))
#: the training parity phase: (layers, batch, sequence length, steps,
#: peak lr) at qwen3_4b's full width in float32, card against CPU.  AdamW
#: turns a gradient whose sign differs at rounding level into a step of
#: +-lr, so lr stays below the parameters' tolerance
TRAIN_PARITY = (2, 2, 128, 2, 1e-5)
#: the other families' training parity: (family, arch, (layers, batch,
#: sequence length, steps, peak lr), config overrides), full width,
#: float32, S = 128 with 64 patches or frames: olmoe 2 layers; pixtral 1
#: (its float32 weights, gradients and moments are about 26 GB on the
#: host); seamless 1 + 1; recurrentgemma 3 (rec, rec, attn: about 44 GB
#: on the host, which the one-card machine's 96 GiB holds); xlstm one
#: mLSTM and one sLSTM block at S = 200, which the kernels pad
TRAIN_PARITY_FAMILIES = (
    ("moe", "olmoe_1b_7b", (2, 2, 128, 2, 1e-5), {}),
    ("vlm", "pixtral_12b", (1, 2, 128, 2, 1e-5), {}),
    ("encdec", "seamless_m4t_medium", (1, 2, 128, 2, 1e-5),
     {"n_enc_layers": 1}),
    ("rglru", "recurrentgemma_9b", (3, 2, 128, 2, 1e-5), {}),
    ("xlstm", "xlstm_1_3b", (2, 2, 200, 2, 1e-5), {"slstm_every": 2}))


def sdpa(q, k, v, **kw):
    """The call to time: ``scaled_dot_product_attention`` on (B, H, S,
    hd) tensors with fewer kv heads than query heads."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)






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


def _timings(torch, kern, plain, names, iters: int = ITERS,
             plain_iters: int = None) -> dict:
    """The kernel's and the plain version's times; ``plain_iters`` calls
    of the plain version for each of its three times where given (a loop
    over S records thousands of operations a call, and the profiler
    costs the host about 0.2 ms each)."""
    n = plain_iters or iters
    return {**_kernel_timings(torch, kern, names, iters),
            "plain_ms": timed_ms(torch, plain, n, min(WARMUP, n)),
            "plain_batch_ms": batch_ms(torch, plain, plain_iters or 20),
            "plain_device_ms": device_ms(torch, plain,
                                         iters=plain_iters or 20)[0]}


def _library(torch, lib, iters: int = ITERS) -> dict:
    return {"library_ms": timed_ms(torch, lib, iters),
            "library_batch_ms": batch_ms(torch, lib),
            "library_device_ms": device_ms(torch, lib)[0]}


def phase_flash_attention(torch, np, dev):
    """Kernel vs plain version (``attention_flat_plain``) on the card, the
    source each case ran held to ``fwd_source``'s, two float32 calls
    bit-equal; times at the serving shapes beside
    ``scaled_dot_product_attention`` (timed here only: the port never
    calls it; a window becomes a boolean band mask, since SDPA has no
    window argument).  A float32 row's bound is at 3 x operations over
    the dense TF32 peak (the split's three products),
    ``fp32_cuda_core_bound_ms`` beside it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_flat,
                                                     fwd_source)
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
            source = fwd_source(dt, hd)
            before = flash_attention_flat.launches_by_source.get(source, 0)
            got = flash_attention_flat(q, k, v, causal=causal, window=window)
            if flash_attention_flat.launches_by_source.get(
                    source, 0) != before + 1:
                raise AssertionError(f"flash_attention: {name} ({dname}) did "
                                     f"not run {source}")
            want = attention_flat_plain(q, k, v, causal=causal,
                                        window=window)
            bit_equal = None
            if dt == torch.float32:         # no atomics: the same bits
                bit_equal = bool(torch.equal(got, flash_attention_flat(
                    q, k, v, causal=causal, window=window)))
                if not bit_equal:
                    raise AssertionError(f"flash_attention: {name} "
                                         f"(float32): two calls differ")
            torch.cuda.synchronize()
            err = _err(got, want)
            _hold("flash_attention", err, dname, name)
            if timed is not True and timed != dname:
                edge.append({"case": name, "dtype": dname, "source": source,
                             "max_abs_err": err, "bit_equal": bit_equal})
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
            # float32: three TF32 products for each float32 one
            bound, by = (attn_bound_ms(n_bytes, 3 * flops, "tf32")
                         if dt == torch.float32 else
                         attn_bound_ms(n_bytes, flops, dname))
            main.append({
                "case": name, "dtype": dname, "source": source, "B": b,
                "H": h, "Hkv": hkv, "S": sq, "hd": hd, "max_abs_err": err,
                "bit_equal": bit_equal,
                **_timings(torch, kern, plain, FLASH_KERNELS, iters),
                **_library(torch, lib, iters),
                "bound_ms": bound, "bound_by": by, "flops": flops,
                "bytes": n_bytes,
                **({"fp32_cuda_core_bound_ms": flops / PEAK_FLOPS["float32"]
                    * 1e3} if dt == torch.float32 else {})})
            if name == "main":              # what the serving path calls
                bshd = [t.view(b, -1, t.shape[1], hd).transpose(1, 2)
                        .contiguous() for t in (q, k, v)]
                main[-1]["kernel_bshd_ms"] = timed_ms(
                    torch, lambda: ops.flash_attention(*bshd, causal=causal),
                    iters)
                del bshd
    emit("flash_attention", tolerance=ATTN_TOL, shapes=main, edge=edge,
         strided=flash_strided_views(torch, dev, g))
    return main[0], next(r for r in main if r["case"] == "parity")


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
RGLRU_BWD_KERNELS = ("rglru_bwd_subchunk_kernel",)
#: the six kernels of csrc/mlstm_kernel_bwd.cu (head dims off the
#: tensor-core routes), of csrc/mlstm_kernel_bwd_sm90.cu (bf16) and of
#: csrc/mlstm_kernel_bwd_tf32x3.cu (float32), each launched once a call of
#: its route; no name of one list contains a name of another
MLSTM_BWD_KERNELS_CUDA_CORES = ("mlstm_bwd_states", "mlstm_bwd_u",
                                "mlstm_bwd_intra", "mlstm_bwd_walk",
                                "mlstm_bwd_dk", "mlstm_bwd_gates")
MLSTM_BWD_KERNELS_SM90 = ("mlstm_bwd_sm90_scores", "mlstm_bwd_sm90_den",
                          "mlstm_bwd_sm90_dwalk", "mlstm_bwd_sm90_cwalk",
                          "mlstm_bwd_sm90_intra", "mlstm_bwd_sm90_gates")
MLSTM_BWD_KERNELS_TF32X3 = ("mlstm_bwd_tf32x3_scores", "mlstm_bwd_tf32x3_den",
                            "mlstm_bwd_tf32x3_dwalk", "mlstm_bwd_tf32x3_cwalk",
                            "mlstm_bwd_tf32x3_intra", "mlstm_bwd_tf32x3_gates")
MLSTM_BWD_KERNELS = (MLSTM_BWD_KERNELS_CUDA_CORES + MLSTM_BWD_KERNELS_SM90
                     + MLSTM_BWD_KERNELS_TF32X3)
#: each backward source's kernels
MLSTM_BWD_KERNELS_BY_SOURCE = {
    "mlstm_kernel_bwd.cu": MLSTM_BWD_KERNELS_CUDA_CORES,
    "mlstm_kernel_bwd_sm90.cu": MLSTM_BWD_KERNELS_SM90,
    "mlstm_kernel_bwd_tf32x3.cu": MLSTM_BWD_KERNELS_TF32X3}
#: the device kernels of the three forward routes, by source: the first
#: design's, the bf16 tensor-core source's and the float32 one's (no name
#: is a part of another's, or of a backward kernel's)
MLSTM_KERNELS_BY_SOURCE = {
    "mlstm_kernel.cu": ("scores_kernel", "carry_kernel"),
    "mlstm_kernel_sm90.cu": ("mlstm_scores_sm90", "mlstm_den_sm90",
                             "mlstm_carry_sm90"),
    "mlstm_kernel_tf32x3.cu": ("mlstm_tf32x3_scores", "mlstm_tf32x3_den",
                               "mlstm_tf32x3_carry")}
MLSTM_KERNELS = tuple(n for names in MLSTM_KERNELS_BY_SOURCE.values()
                      for n in names)


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
                             RGLRU_KERNELS, 10, plain_iters=2)
        main.append({**case, **times, "bound_ms": bound, "bound_by": by,
                     "bytes": n_bytes, "library_ms": None})
    emit("rglru_scan", tolerance=ATTN_TOL["float32"], shapes=main,
         edge=edge)
    return main[0]




def _mlstm_first_design(torch, mk, args):
    """A call of the first design (``csrc/mlstm_kernel.cu``) on the same
    inputs, tail-padded as the wrapper pads them, into outputs made once;
    it returns h, (C, n) as the wrapper does."""
    q, k, v, ig, fg, c0, n0 = args
    ins = mk.pad_tail(q, k, v, ig, fg)
    bh, s, hd = q.shape
    c, n, h = (torch.empty(bh, hd, hd, device=q.device),
               torch.empty(bh, hd, device=q.device), torch.empty_like(ins[0]))

    def first():
        err = mk._fwd_cuda_cores(*ins, c0, n0, c, n, h)
        if err:
            raise RuntimeError(f"mlstm_kernel.cu: CUDA error {err}")
        return h[:, :s], (c, n)
    return first


def _hold_mlstm_fwd(torch, got, want, dtype: str, where) -> tuple:
    """Holds h (in the inputs' dtype) and the final C and n (float32) of
    ``mlstm_chunkwise`` each to its plain value: max abs error within
    ``ATTN_TOL`` x max(1, its largest |plain value|), and ||got - want|| /
    ||want|| within ``ATTN_BWD_REL_NORM``.  Returns ({name: max abs
    error}, {name: relative norm})."""
    errs, rels = {}, {}
    for part, a, w, pdt in zip(("h", "C", "n"), got, want,
                               (dtype, "float32", "float32")):
        err, scale = _err(a, w), float(w.float().abs().max())
        name = f"mlstm_chunkwise {part}"
        _hold(name, err, pdt, (*where, part), scale)
        rels[part] = _hold_rel_norm(torch, name, a, w, pdt, (*where, part))
        errs[part] = err
    return errs, rels


def phase_mlstm_chunkwise(torch, np, dev):
    """Kernel vs plain version (``mlstm_flat_plain``: the same tail
    padding, the chunkwise form at the kernel's chunk) on the card, h
    and the final C and n, each case on the source
    ``mlstm_kernel.fwd_source`` picks for its dtype and hd
    (``csrc/mlstm_kernel_sm90.cu``: bf16 on the tensor cores;
    ``csrc/mlstm_kernel_tf32x3.cu``: float32 on the tensor cores as split
    TF32 products; ``csrc/mlstm_kernel.cu``: float32 FMAs on the CUDA
    cores, for the head dims neither takes), each of h, C and n by
    ``_hold_mlstm_fwd``; every case twice and bit-equal.  The bound is at the peak of the route that runs (bf16 on
    the tensor cores; float32 as three TF32 products each on the tensor
    cores, the CUDA-core bound beside it); a tensor-core row is timed in
    turns with the first design on the same tensors (kernel, first
    design, kernel again).  No single PyTorch call computes a chunkwise
    mLSTM, so there is no library time.  Returns the first timed row of
    each dtype (bf16, float32)."""
    from repro_torch.kernels import mlstm_kernel as mk
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
            args = (q, k, v, ig, fg, c0, n0)
            before = mk.mlstm_chunkwise.launches
            h, (c, n) = mk.mlstm_chunkwise(*args)
            again = mk.mlstm_chunkwise(*args)
            hw, (cw, nw) = mk.mlstm_flat_plain(*args)
            torch.cuda.synchronize()
            source = mk.fwd_source(dt, hd)
            if (mk.mlstm_chunkwise.source != source
                    or mk.mlstm_chunkwise.launches != before + 2):
                raise AssertionError(
                    f"mlstm_chunkwise at {(bh, s, hd)} {dname} ran "
                    f"{mk.mlstm_chunkwise.source} "
                    f"({mk.mlstm_chunkwise.launches - before} launches for "
                    f"2 calls), expected {source}")
            if not (torch.equal(h, again[0]) and torch.equal(c, again[1][0])
                    and torch.equal(n, again[1][1])):
                raise AssertionError(f"mlstm_chunkwise: two calls at "
                                     f"{(bh, s, hd)} ({dname}) differ")
            errs, rels = _hold_mlstm_fwd(torch, (h, c, n), (hw, cw, nw),
                                         dname, (bh, s, hd, carry_in))
            case = {"dtype": dname, "BH": bh, "S": s, "hd": hd,
                    "carry_in": carry_in, "kernel": source,
                    "max_abs_err": errs["h"],
                    "max_abs_err_C": errs["C"], "max_abs_err_n": errs["n"],
                    "rel_norm_err": rels, "bit_equal": True}
            del h, c, n, hw, cw, nw, again
            if not timed:
                edge.append(case)
                continue
            n_bytes, flops = mlstm_work(bh, s, hd, q.element_size(),
                                        carry_in)
            # float32 on the tensor cores: three TF32 products for each
            bound, by = (attn_bound_ms(n_bytes, 3 * flops, "tf32")
                         if source == mk.FWD_TF32X3 else
                         attn_bound_ms(n_bytes, flops, dname))
            kern = lambda: mk.mlstm_chunkwise(*args)
            names = MLSTM_KERNELS_BY_SOURCE[source]
            row = {**case, **_timings(
                torch, kern, lambda: mk.mlstm_flat_plain(*args), names, 10),
                "bound_ms": bound, "bound_by": by, "flops": flops,
                "bytes": n_bytes, "library_ms": None,
                "fp32_cuda_core_bound_ms": flops / PEAK_FLOPS["float32"]
                * 1e3}
            if source != mk.FWD_CUDA_CORES:  # the first design, same tensors
                first_t = _kernel_timings(
                    torch, _mlstm_first_design(torch, mk, args),
                    MLSTM_KERNELS_BY_SOURCE[mk.FWD_CUDA_CORES], 10)
                row.update({f"first_design_{k_}": v_
                            for k_, v_ in first_t.items()})
                row["kernel_again_device_ms"] = device_ms(torch, kern,
                                                          names)[0]
            main.append(row)
            del args, q, k, v
            torch.cuda.empty_cache()
    emit("mlstm_chunkwise", tolerance=ATTN_TOL,
         rel_norm_limit=ATTN_BWD_REL_NORM, shapes=main, edge=edge)
    return tuple(next(r for r in main if r["dtype"] == d)
                 for d in ("bfloat16", "float32"))


#: (B, S, W, with h0, timed) for the rglru backward: recurrentgemma's train
#: shape without h0 (timed) and with it, then RGLRU_CASES' edge shapes (S =
#: 1, S = 515 with W = 4,099, S below one chunk, h0 given) and a long chain
#: (64 hops at T_c 256, where the chain is the critical path)
RGLRU_BWD_CASES = [(4, 1024, 4096, False, True), (4, 1024, 4096, True, False),
                   (3, 1, 4096, True, False), (2, 515, 4099, True, False),
                   (1, 300, 32, True, False), (2, 16, 8, True, False),
                   (1, 16384, 1024, True, False)]
#: (BH, S, hd, initial carry, final-state gradients, timed) for the mLSTM
#: backward, both dtypes: xlstm's train shape and train_parity_xlstm's
#: (timed), S = 200 (a padded tail) with both carries, each carry alone,
#: MLSTM_CASES' small shapes, and hd 100, which both dtypes run on the
#: first design (off the tensor-core routes: not a multiple of 8)
MLSTM_BWD_CASES = [(16, 1024, 1024, False, False, True),
                   (8, 200, 1024, False, False, True),
                   (4, 200, 1024, True, True, False),
                   (2, 128, 32, True, False, False),
                   (4, 256, 64, False, True, False),
                   (1, 64, 128, False, False, False),
                   (2, 200, 64, True, True, False),
                   (3, 130, 96, True, False, False),
                   (2, 64, 8, True, True, False),
                   (1, 70, 100, True, False, False)]


def phase_rglru_scan_bwd(torch, np, dev):
    """The backward kernel (``csrc/rglru_scan_bwd.cu``) against its plain
    version (``rglru_bwd_plain``, a loop over S in reverse) on the card,
    float32, dlog_a, db and dh0 within ``ATTN_TOL`` x max(1, largest
    |plain gradient|), every case twice and bit-equal, each with the
    kernel's tiling (``plan_bwd``); timed at the train shape (the plain
    loop on 3 calls, profiled on 1: the profiler's host cost per recorded
    operation).  No PyTorch call computes it."""
    from repro_torch.kernels.ref import rglru_bwd_plain, rglru_plain
    from repro_torch.kernels.rglru_scan import plan_bwd, rglru_scan_bwd
    g = torch.Generator(device=dev).manual_seed(13)
    main, edge = [], []
    for b, s, w, with_h0, timed in RGLRU_BWD_CASES:
        log_a = -torch.rand(b, s, w, generator=g, device=dev) * 0.3
        bv, dh = (torch.randn(b, s, w, generator=g, device=dev)
                  for _ in range(2))
        h0 = (torch.randn(b, w, generator=g, device=dev) if with_h0
              else None)
        h = rglru_plain(log_a, bv, h0)
        got = rglru_scan_bwd(log_a, h, h0, dh)
        again = rglru_scan_bwd(log_a, h, h0, dh)
        want = rglru_bwd_plain(log_a, h, h0, dh)
        torch.cuda.synchronize()
        if (got[2] is None) != (h0 is None):
            raise AssertionError(f"rglru_scan_bwd: dh0 at {(b, s, w)} "
                                 f"(h0 {with_h0})")
        err, scale = _bwd_err([x for x in got if x is not None],
                              [x for x in want if x is not None])
        _hold("rglru_scan_bwd", err, "float32", (b, s, w, with_h0), scale)
        if not all(x is None or torch.equal(x, y)
                   for x, y in zip(got, again)):
            raise AssertionError(f"rglru_scan_bwd: two calls at {(b, s, w)}"
                                 f" (h0 {with_h0}) differ")
        case = {"B": b, "S": s, "W": w, "h0": with_h0, "max_abs_err": err,
                "scale": scale, "bit_equal": True, **plan_bwd(b, s, w)}
        del got, again, want
        if not timed:
            edge.append(case)
            continue
        # log_a, h and dh read; dlog_a and db written (and h0, dh0)
        n_bytes = 4 * (5 * b * s * w + (2 * b * w if with_h0 else 0))
        bound, by = attn_bound_ms(n_bytes, 5 * b * s * w, "float32")
        main.append({**case, **_timings(
            torch, lambda: rglru_scan_bwd(log_a, h, h0, dh),
            lambda: rglru_bwd_plain(log_a, h, h0, dh), RGLRU_BWD_KERNELS,
            10, plain_iters=1), "bound_ms": bound, "bound_by": by,
            "bytes": n_bytes, "library_ms": None})
    emit("rglru_scan_bwd", tolerance=ATTN_TOL["float32"],
         tolerance_relative_to="max(1, largest |plain gradient|)",
         shapes=main, edge=edge)
    return main[0]






#: the mLSTM backward's outputs, in the order the wrapper returns them
MLSTM_BWD_GRADS = ("dq", "dk", "dv", "di_raw", "df_raw", "dc0", "dn0")


def _hold_mlstm_bwd(torch, got, want, dtype: str, where) -> tuple:
    """Holds each of the mLSTM backward's seven outputs to its own plain
    gradient: max abs error within ``ATTN_TOL`` x max(1, its largest
    |plain value|), and ||got - want|| / ||want|| within
    ``ATTN_BWD_REL_NORM``.  Returns ({name: max abs error}, {name:
    relative norm})."""
    errs, rels = {}, {}
    for part, a, w in zip(MLSTM_BWD_GRADS, got, want):
        err, scale = _err(a, w), float(w.float().abs().max())
        name = f"mlstm_chunkwise_bwd {part}"
        _hold(name, err, dtype, (*where, part), scale)
        rels[part] = _hold_rel_norm(torch, name, a, w, dtype, (*where, part))
        errs[part] = err
    return errs, rels


def _mlstm_bwd_first_design(torch, mk, args):
    """A call of the first design (``csrc/mlstm_kernel_bwd.cu``) on the
    same inputs, tail-padded as the wrapper pads them, into outputs made
    once."""
    q, k, v, ig, fg, c0, n0, dh, dc, dn = args
    qp, kp, vp, ip, fp = mk.pad_tail(q, k, v, ig, fg)
    dhp = torch.zeros_like(qp)
    dhp[:, :q.shape[1]] = dh
    bh, hd = q.shape[0], q.shape[2]
    outs = [torch.empty_like(x) for x in (qp, kp, vp, ip, fp)] + [
        torch.empty(bh, hd, hd, device=q.device),
        torch.empty(bh, hd, device=q.device)]

    def first():
        err = mk._bwd_cuda_cores(qp, kp, vp, dhp, ip, fp, c0, n0, dc, dn,
                                 *outs)
        if err:
            raise RuntimeError(f"mlstm_kernel_bwd.cu: CUDA error {err}")
    return first


def phase_mlstm_chunkwise_bwd(torch, np, dev):
    """The backward kernels against their plain version
    (``mlstm_chunkwise_bwd_plain``) on the card, each case on the source
    ``mlstm_kernel.bwd_source`` picks for its dtype and hd
    (``csrc/mlstm_kernel_bwd_sm90.cu``: bf16 on the tensor cores;
    ``csrc/mlstm_kernel_bwd_tf32x3.cu``: float32 on the tensor cores as
    split TF32 products; ``csrc/mlstm_kernel_bwd.cu``: float32 sums on the
    CUDA cores, for the head dims neither takes): each of dq, dk, dv (in
    q's dtype), di_raw, df_raw, dc0 and dn0 within ``ATTN_TOL`` of the
    dtype x max(1, its largest |plain value|) and by
    ||got - want|| / ||want|| within ``ATTN_BWD_REL_NORM``; every case
    twice and bit-equal, an ``i_raw`` above the cap passing no gradient;
    timed at the timed shapes, the first design beside the tensor-core
    source on the same tensors.  The bound is the function's work at the
    peak of the route that runs (bf16 on the tensor cores; float32 as
    three TF32 products each on the tensor cores, the CUDA-core bound
    beside it); the bytes its design stores and reads back are beside it.
    No PyTorch call computes it.  Returns the first timed row of each
    dtype (bf16, float32)."""
    from repro_torch.kernels import mlstm_kernel as mk
    from repro_torch.kernels.ref import I_CAP, mlstm_chunkwise_bwd_plain
    g = torch.Generator(device=dev).manual_seed(14)
    main, edge = [], []

    def flat(out):
        return [x for part in out for x in part]
    for dt in (torch.bfloat16, torch.float32):
        dname = _dname(torch, dt)
        for bh, s, hd, carry, final, timed in MLSTM_BWD_CASES:
            q, k, v, dh = (torch.randn(bh, s, hd, generator=g, device=dev)
                           .mul(0.3).to(dt) for _ in range(4))
            ig = torch.randn(bh, s, generator=g, device=dev)
            ig[0, s // 2] = I_CAP + 1.5
            fg = torch.randn(bh, s, generator=g, device=dev) + 2.0
            c0, n0, dc, dn = (
                torch.randn(*shape, generator=g, device=dev) * 0.1 if on
                else None
                for on, shape in ((carry, (bh, hd, hd)), (carry, (bh, hd)),
                                  (final, (bh, hd, hd)), (final, (bh, hd))))
            args = (q, k, v, ig, fg, c0, n0, dh, dc, dn)
            before = mk.mlstm_chunkwise_bwd.launches
            got = flat(mk.mlstm_chunkwise_bwd(*args))
            again = flat(mk.mlstm_chunkwise_bwd(*args))
            want = flat(mlstm_chunkwise_bwd_plain(*args))
            torch.cuda.synchronize()
            source = mk.bwd_source(dt, hd)
            if (mk.mlstm_chunkwise_bwd.source != source
                    or mk.mlstm_chunkwise_bwd.launches != before + 2):
                raise AssertionError(
                    f"mlstm_chunkwise_bwd at {(bh, s, hd)} {dname} ran "
                    f"{mk.mlstm_chunkwise_bwd.source} "
                    f"({mk.mlstm_chunkwise_bwd.launches - before} launches "
                    f"for 2 calls), expected {source}")
            errs, rels = _hold_mlstm_bwd(torch, got, want, dname,
                                         (bh, s, hd, carry, final))
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"mlstm_chunkwise_bwd: two calls at "
                                     f"{(bh, s, hd)} ({dname}) differ")
            if float(got[3][0, s // 2]) != 0.0:
                raise AssertionError("mlstm_chunkwise_bwd: di_raw above the "
                                     "cap is not 0")
            case = {"dtype": dname, "BH": bh, "S": s, "hd": hd,
                    "carry_in": carry, "final_grad": final,
                    "kernel": mk.mlstm_chunkwise_bwd.source,
                    "max_abs_err": max(errs.values()), "errs": errs,
                    "rel_norm_errs": rels, "bit_equal": True}
            del got, again, want
            if not timed:
                edge.append(case)
                continue
            n_bytes, flops = mlstm_bwd_work(bh, s, hd, q.element_size(),
                                            carry, final)
            # float32 on the tensor cores: three TF32 products for each
            bound, by = (attn_bound_ms(n_bytes, 3 * flops, "tf32")
                         if source == mk.BWD_TF32X3 else
                         attn_bound_ms(n_bytes, flops, dname))
            stored = mlstm_bwd_stored_bytes(bh, s, hd, source)
            row = {**case, **_timings(
                torch, lambda: mk.mlstm_chunkwise_bwd(*args),
                lambda: mlstm_chunkwise_bwd_plain(*args),
                MLSTM_BWD_KERNELS_BY_SOURCE[source], 5, plain_iters=3),
                "bound_ms": bound, "bound_by": by, "flops": flops,
                "bytes": n_bytes, "library_ms": None,
                "stored_bytes": stored,
                "stored_bytes_bound_ms": bound_ms(stored + n_bytes),
                "bf16_tensor_core_bound_ms": flops / PEAK_FLOPS["bfloat16"]
                * 1e3,
                "fp32_cuda_core_bound_ms": flops / PEAK_FLOPS["float32"]
                * 1e3}
            if source != mk.BWD_CUDA_CORES:  # the first design, same tensors
                first_t = _kernel_timings(
                    torch, _mlstm_bwd_first_design(torch, mk, args),
                    MLSTM_BWD_KERNELS_CUDA_CORES, 5)
                row.update({f"first_design_{k_}": v_
                            for k_, v_ in first_t.items()})
            main.append(row)
            del args, q, k, v, dh
            torch.cuda.empty_cache()
    emit("mlstm_chunkwise_bwd", tolerance=ATTN_TOL,
         tolerance_relative_to="max(1, largest |plain gradient|)",
         rel_norm_limit=ATTN_BWD_REL_NORM, shapes=main, edge=edge)
    return tuple(next(r for r in main if r["dtype"] == d)
                 for d in ("bfloat16", "float32"))


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
    from repro_torch.kernels.mlstm_kernel import (mlstm_chunkwise,
                                                  mlstm_chunkwise_bwd)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    return {"flash_attention": flash_attention_flat,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention,
            "rglru_scan": rglru_scan, "rglru_scan_bwd": rglru_scan_bwd,
            "mlstm_chunkwise": mlstm_chunkwise,
            "mlstm_chunkwise_bwd": mlstm_chunkwise_bwd}


def _kernel_counts():
    return {k: w.launches for k, w in _serving_wrappers().items()}


#: the wrappers that count their launches by source, each with the
#: kernels line's entry for the launches of its float32 source (the
#: parity phases' calls; each phase holds every call to the source its
#: dtype picks)
BY_SOURCE = {"flash_attention": "flash_attention_tf32x3",
             "flash_attention_bwd": "flash_attention_bwd_tf32x3",
             "mlstm_chunkwise": "mlstm_chunkwise_tf32x3",
             "mlstm_chunkwise_bwd": "mlstm_chunkwise_bwd_tf32x3"}


def _zero_kernel_counts():
    for w in _serving_wrappers().values():
        w.launches = 0
    for name in BY_SOURCE:
        _serving_wrappers()[name].launches_by_source = {}


def _launches_by_source() -> dict:
    """Every model kernel's launching calls by source since the counts
    were last set to 0, the kernels of one source under its name."""
    from repro_torch.kernels import decode_attention, rglru_scan
    wrappers = _serving_wrappers()
    out = {}
    for name in BY_SOURCE:
        out.update(wrappers[name].launches_by_source)
    for name, src in (("decode_attention", decode_attention.SOURCE),
                      ("rglru_scan", rglru_scan.SOURCE),
                      ("rglru_scan_bwd", rglru_scan.BWD_SOURCE)):
        out[src] = wrappers[name].launches
    return {k: n for k, n in sorted(out.items()) if n}


def _by_source(name: str = "flash_attention_bwd") -> dict:
    """A wrapper's launching calls by source since the counts were last
    set to 0 (the attention backward's unless ``name`` names another of
    ``BY_SOURCE``)."""
    return dict(_serving_wrappers()[name].launches_by_source)


def expected_launches(cfg, decode_steps: int) -> dict:
    """Each model kernel's launches in one ``generate``: attention
    once per attention layer in prefill and per attention layer and
    decode step (the encoder-decoder: its encoder layers, and twice per
    decoder layer, self and cross); the recurrences once per recurrent
    layer in prefill (decode steps them in plain tensor ops); no
    backward kernel."""
    n_attn = n_rec = n_mlstm = 0
    if cfg.family in ("dense", "moe", "vlm"):
        n_attn = cfg.n_layers
    elif cfg.family == "encdec":
        # prefill: the encoder's layers, the decoder's self- and
        # cross-attention; decode: self and cross per decoder layer
        return {"flash_attention": (cfg.n_enc_layers or cfg.n_layers)
                + 2 * cfg.n_layers, "flash_attention_bwd": 0,
                "decode_attention": 2 * cfg.n_layers * decode_steps,
                "rglru_scan": 0, "rglru_scan_bwd": 0, "mlstm_chunkwise": 0,
                "mlstm_chunkwise_bwd": 0}
    elif cfg.family == "rglru":
        from repro_torch.models.rglru import layer_kinds
        n_attn = layer_kinds(cfg).count("attn")
        n_rec = cfg.n_layers - n_attn
    elif cfg.family == "xlstm":
        from repro_torch.models.xlstm import is_slstm
        n_mlstm = sum(not is_slstm(cfg, i) for i in range(cfg.n_layers))
    return {"flash_attention": n_attn, "flash_attention_bwd": 0,
            "decode_attention": n_attn * decode_steps,
            "rglru_scan": n_rec, "rglru_scan_bwd": 0,
            "mlstm_chunkwise": n_mlstm, "mlstm_chunkwise_bwd": 0}


def expected_train_launches(cfg, n_steps: int) -> dict:
    """Each model kernel's launches in ``n_steps`` train steps: every
    attention and recurrence call of the forward (attention once per
    layer of a dense, MoE or VLM transformer; the encoder-decoder's
    encoder layers, and two per decoder layer, self and cross;
    recurrentgemma's ``rglru_scan`` per recurrent layer and attention per
    attention layer; xlstm's ``mlstm_chunkwise`` per mLSTM layer) once,
    again when ``cfg.remat`` recomputes its layer in the backward, and
    its backward kernel once; no decode kernel."""
    n_attn = n_rec = n_mlstm = 0
    if cfg.family in ("dense", "moe", "vlm"):
        n_attn = cfg.n_layers
    elif cfg.family == "encdec":
        n_attn = (cfg.n_enc_layers or cfg.n_layers) + 2 * cfg.n_layers
    elif cfg.family == "rglru":
        from repro_torch.models.rglru import layer_kinds
        n_attn = layer_kinds(cfg).count("attn")
        n_rec = cfg.n_layers - n_attn
    elif cfg.family == "xlstm":
        from repro_torch.models.xlstm import is_slstm
        n_mlstm = sum(not is_slstm(cfg, i) for i in range(cfg.n_layers))
    else:
        raise ValueError(f"{cfg.name}: no train path for the "
                         f"{cfg.family!r} family")
    fwd = n_steps * (2 if cfg.remat else 1)
    return {"flash_attention": fwd * n_attn,
            "flash_attention_bwd": n_steps * n_attn, "decode_attention": 0,
            "rglru_scan": fwd * n_rec, "rglru_scan_bwd": n_steps * n_rec,
            "mlstm_chunkwise": fwd * n_mlstm,
            "mlstm_chunkwise_bwd": n_steps * n_mlstm}


def expected_fwd_sources(torch, cfg, n: int) -> dict:
    """The flash forward's launches by source that ``n`` of them at
    ``cfg`` must give: all on ``csrc/flash_attention_tf32x3.cu`` in
    float32, on the bf16 tensor-core kernel otherwise; none without
    attention."""
    if not n:
        return {}
    from repro_torch.kernels.flash_attention import FWD_SM90, FWD_TF32X3
    return {FWD_TF32X3 if cfg.dtype == torch.float32 else FWD_SM90: n}


def _hold_fwd_sources(torch, cfg, counts: dict, phase: str) -> dict:
    """The flash forward's launches by source since the counts were set
    to 0, held to :func:`expected_fwd_sources` of ``counts``."""
    got = _by_source("flash_attention")
    want = expected_fwd_sources(torch, cfg, counts["flash_attention"])
    if got != want:
        raise AssertionError(f"{phase}: attention forward by source {got}, "
                             f"expected {want}")
    return got


def expected_bwd_sources(torch, cfg, n: int) -> dict:
    """The attention backward's launching calls by source that ``n``
    calls of a train step at ``cfg`` must give: all on the source the
    route table picks for its dtype and head dim (float32: the split-TF32
    kernel), none without attention."""
    if not n:
        return {}
    from repro_torch.kernels.flash_attention import bwd_source
    return {bwd_source(cfg.dtype, cfg.head_dim): n}


def expected_mlstm_sources(cfg, n: int, bwd: bool = True) -> dict:
    """The mLSTM backward's (``bwd``) or forward's launches by source that
    ``n`` of them at ``cfg`` must give: all on the source the route table
    picks for its dtype and head dim (bf16: the bf16 tensor-core kernel;
    float32: the split-TF32 one), none without an mLSTM layer."""
    if not n:
        return {}
    from repro_torch.kernels.mlstm_kernel import bwd_source, fwd_source
    from repro_torch.models.xlstm import d_inner
    route = bwd_source if bwd else fwd_source
    return {route(cfg.dtype, d_inner(cfg) // cfg.n_heads): n}


def _device_kernels(records: dict, launched: dict):
    """({kernel name: device us}, {part: records seen}) of a profile's
    device operations (``records``: its :func:`device_records`).  A
    kernel whose name contains a key of ``launched`` (the port's
    kernels, by their launch counters over the profiled window) counts
    as the mean duration of the records the profiler kept times its
    launches: it keeps only some records of a kernel launched through
    ctypes."""
    us, seen = {}, {}
    for key, (count, t) in records.items():
        if t <= 0:
            continue
        for part, n in launched.items():
            if part in key:
                seen[part] = seen.get(part, 0) + count
                t = t / count * n
        us[key] = t
    return us, seen


#: the device kernels each serving wrapper launches once per call
DEVICE_KERNELS = {"flash_attention": FLASH_KERNELS,
                  "flash_attention_bwd": FLASH_BWD_KERNELS,
                  "decode_attention": DECODE_KERNELS,
                  "rglru_scan": RGLRU_KERNELS,
                  "rglru_scan_bwd": RGLRU_BWD_KERNELS,
                  "mlstm_chunkwise": MLSTM_KERNELS,
                  "mlstm_chunkwise_bwd": MLSTM_BWD_KERNELS}


def _launched() -> dict:
    """The port's serving kernels' launch counters, by device kernel
    name."""
    counts = _kernel_counts()
    return {name: counts[w] for w, names in DEVICE_KERNELS.items()
            for name in names}


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
        _hold_fwd_sources(torch, cfg, counts, phase)
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
    by_kernel, gen_seen = _device_kernels(device_records(prof), gen_launched)
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
    dec_records = device_records(prof)
    dec, dec_seen = _device_kernels(dec_records, dec_launched)
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
         decode_step_device_ops=sum(n for n, _ in dec_records.values())
         / n_steps,
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


#: the parity phases' float32 logit bound, x max(1, logit scale): sums of
#: 2,560-24,576 terms in other orders (cuBLAS vs the CPU BLAS, kernels vs
#: plain versions) differ by about 1e-5 of the logits
PARITY_TOL = 1e-3
#: ``tp_attention``'s card forward against the card forward without it,
#: x max(1, scale): the JAX package's own bound for the option
TP_TOL = 1e-4


def parity_steps(torch, np, dev, cfg, gpu, cpu, prompts, fe, new,
                 phase: str):
    """Card (kernels) against CPU (plain versions) on the same parameters
    and frontend embeddings: the logits of prefill and of every decode
    step within ``PARITY_TOL``, both sides fed the card's greedy tokens
    (a token may differ only where the CPU's top two are closer than
    the bound), then one ``generate`` a side, its tokens, ``decode_steps``
    and ``tokens_out`` equal.  Returns (max abs errors by step, token
    gaps where they differ, tokens equal, the card's stats, the first MoE
    layer's (capacity, kept mask) on the card and on the CPU, or
    ``None``); the card launches ``expected_launches(cfg, new - 1)`` and
    then ``expected_launches(cfg, stats.decode_steps)``."""
    from repro_torch.serve.loop import BatchServer
    fe_c, fe_h = ((None, None) if fe is None
                  else (torch.from_numpy(fe).to(dev), torch.from_numpy(fe)))
    card = BatchServer(cfg, gpu, max_new_tokens=new, device=dev)
    host = BatchServer(cfg, cpu, max_new_tokens=new, device="cpu")
    ((lc, cc), (lh, ch)), kept = moe_keeps(lambda: (
        card._prefill(gpu, torch.from_numpy(prompts).to(dev), fe_c),
        host._prefill(cpu, torch.from_numpy(prompts), fe_h)))
    first = (kept[0], kept[cfg.n_layers]) if cfg.n_experts else None
    errs, gaps = [], []
    for step in range(new):
        lc_h = lc.cpu()
        errs.append(float((lc_h - lh).abs().max()))
        scale = float(lh.abs().max())
        if not errs[-1] <= PARITY_TOL * max(1.0, scale):
            raise AssertionError(f"{phase} step {step}: max abs err "
                                 f"{errs[-1]} (logit scale {scale})")
        tc, th = lc_h.argmax(-1), lh.argmax(-1)
        for lane in np.nonzero((tc != th).numpy())[0]:
            top2 = lh[lane].topk(2).values
            gap = float(top2[0] - top2[1])
            gaps.append({"step": step, "lane": int(lane), "gap": gap})
            if gap >= PARITY_TOL * max(1.0, scale):
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
    return errs, gaps, same, sc, first


def _added(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def _hold_launches(torch, cfg, want: dict, phase: str) -> dict:
    """The kernels' launches since the counts were set to 0, exactly
    ``want``, every flash forward on the source its dtype picks; returns
    them with the float32 sources' entries of the kernels line."""
    counts = _kernel_counts()
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts}, expected {want}")
    src = _hold_fwd_sources(torch, cfg, counts, phase)
    return {**counts, "flash_attention_tf32x3": src.get(
        "flash_attention_tf32x3.cu", 0)}


def parity_tp_attention(torch, dev, cfg, gpu, cpu, prompts, phase: str,
                        case: str, shape, option: str):
    """``tp_attention`` under a logical mesh of ``shape`` (qwen3_4b: 32
    heads padded to 33, flash as MHA with 33 kv heads): the card's
    forward logits against the card's forward without the option within
    ``TP_TOL`` (and whether they are bit-equal), and against the CPU's
    forward under the same mesh within ``PARITY_TOL``; flash launched
    once a layer in each card forward."""
    import dataclasses

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import registry
    from repro_torch.models.transformer import tp_attn_weights
    from repro_torch.parallel import ctx as pctx
    t0 = time.perf_counter()
    mesh = make_test_mesh(*shape)
    tp_cfg = dataclasses.replace(cfg, **{option: True})
    tokens = torch.from_numpy(prompts)
    _zero_kernel_counts()
    base = registry.forward(cfg, gpu, tokens.to(dev)).cpu()
    with pctx.use_mesh(mesh):
        h_eff = tp_attn_weights(tp_cfg, {k: v[0] for k, v in
                                         gpu["layers"].items()
                                         if k in ("wq", "wk", "wv",
                                                  "wo")})[-1]
        got = registry.forward(tp_cfg, gpu, tokens.to(dev)).cpu()
        host = registry.forward(tp_cfg, cpu, tokens)
    fwd = expected_launches(cfg, 0)
    counts = _hold_launches(torch, cfg, _added(fwd, fwd), phase)
    scale = float(base.abs().max())
    err_card = float((got - base).abs().max())
    if not err_card <= TP_TOL * max(1.0, scale):
        raise AssertionError(f"{phase}: tp_attention's card logits "
                             f"{err_card} from the card's without it "
                             f"(scale {scale})")
    scale_h = float(host.abs().max())
    err_cpu = float((got - host).abs().max())
    if not err_cpu <= PARITY_TOL * max(1.0, scale_h):
        raise AssertionError(f"{phase}: tp_attention's card logits "
                             f"{err_cpu} from the CPU's (scale {scale_h})")
    emit(phase, arch=cfg.name, case=case, mesh=mesh.shape,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, h_eff=h_eff,
         logits_shape=list(got.shape), card_vs_card_max_abs_err=err_card,
         card_vs_card_tolerance=TP_TOL, card_bit_equal=bool(
             torch.equal(got, base)), card_vs_cpu_max_abs_err=err_cpu,
         tolerance=PARITY_TOL, logit_scale=scale, launches=counts,
         wall_s=time.perf_counter() - t0)
    return counts


def parity_on_mesh(torch, np, dev, cfg, gpu, cpu, prompts, new,
                   phase: str, case: str, shape, option,
                   drops_one_shard=None):
    """:func:`parity_steps` with both sides under a logical mesh of
    ``shape`` (and ``option`` set in the config, if not ``None``):
    ``sp_decode`` (decode attention as flash-decoding over the ``model`` axis's
    sequence shards: the kernel on the card, the sharded formula on the
    CPU) or a MoE's expert parallelism (each shard routed at its own
    capacity; every shard's first-layer kept mask equal on both sides,
    and some slot dropped).  Launches exact."""
    import dataclasses

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import ctx as pctx
    t0 = time.perf_counter()
    mesh = make_test_mesh(*shape)
    run_cfg = (cfg if option is None
               else dataclasses.replace(cfg, **{option: True}))
    _zero_kernel_counts()
    with pctx.use_mesh(mesh):
        errs, gaps, same, sc, first = parity_steps(
            torch, np, dev, run_cfg, gpu, cpu, prompts, None, new, phase)
    counts = _hold_launches(torch, cfg, _added(
        expected_launches(cfg, new - 1),
        expected_launches(cfg, sc.decode_steps)), phase)
    moe = None
    if cfg.n_experts:
        (cap, keep_c), (_, keep_h) = first
        dropped = [int((~k).sum()) for k in keep_h]
        if not torch.equal(keep_c, keep_h) or not sum(dropped):
            raise AssertionError(f"{phase}: first layer's dropped slots by "
                                 f"shard {[int((~k).sum()) for k in keep_c]}"
                                 f" on the card, {dropped} on the CPU (must "
                                 f"be equal, some)")
        moe = {"shards": int(keep_h.shape[0]), "capacity": cap,
               "slots_per_shard": int(keep_h.shape[1]),
               "first_layer_prefill_dropped": sum(dropped),
               "dropped_by_shard": dropped,
               "one_shard_first_layer_prefill_dropped": drops_one_shard}
    emit(phase, arch=cfg.name, case=case, mesh=mesh.shape, dtype="float32", batch=int(prompts.shape[0]),
         prompt_len=int(prompts.shape[1]), new_tokens=new,
         tolerance=PARITY_TOL, logits_max_abs_err=errs,
         token_gaps_where_differ=gaps, tokens_equal=same,
         decode_steps=sc.decode_steps, tokens_out=sc.tokens_out, moe=moe,
         launches=counts, wall_s=time.perf_counter() - t0)
    return counts


def phase_serve_parity(torch, np, dev, arch: str = SERVE[0],
                       spec=PARITY, phase: str = "serve_parity",
                       mesh_cases=()) -> dict:
    """Full width, cut depth, float32: the card (kernels) against the
    CPU (plain versions) on the same parameters and frontend embeddings
    (:func:`parity_steps`).  ``spec`` is (layers, batch, prompt length,
    new tokens, config overrides).  A MoE's first layer must drop the
    same slots on both sides in prefill, and some.  Then each of
    ``mesh_cases`` on the same parameters and prompts, a path of its own
    (``{phase}_{case}``): "tp_attention" (:func:`parity_tp_attention`),
    "sp_decode" and "expert_parallel" (:func:`parity_on_mesh`).  Returns
    the launches by path."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    _zero_kernel_counts()
    errs, gaps, same, sc, first = parity_steps(
        torch, np, dev, cfg, gpu, cpu, prompts, fe, new, phase)
    drops = None
    if first:
        (_, first_c), (_, first_h) = first
        drops = int((~first_h).sum())
        if not torch.equal(first_c, first_h) or drops == 0:
            raise AssertionError(f"{phase}: first layer's dropped slots "
                                 f"{int((~first_c).sum())} on the card, "
                                 f"{drops} on the CPU (must be equal, "
                                 f"non-empty)")
    # the mLSTM forward once a layer in each of the two prefills (decode
    # steps it in plain tensor ops), every float32 call on its split-TF32
    # kernel
    counts = _kernel_counts()
    n_mlstm = 2 * expected_launches(cfg, 0)["mlstm_chunkwise"]
    fwd_sources = _by_source("mlstm_chunkwise")
    want_src = expected_mlstm_sources(cfg, n_mlstm, bwd=False)
    if counts["mlstm_chunkwise"] != n_mlstm or fwd_sources != want_src:
        raise AssertionError(f"{phase}: mLSTM forward launches "
                             f"{counts['mlstm_chunkwise']} by source "
                             f"{fwd_sources}, expected {n_mlstm}, "
                             f"{want_src}")
    attn_sources = _hold_fwd_sources(torch, cfg, counts, phase)
    emit(phase, arch=cfg.name, n_layers=n_layers, overrides=overrides,
         dtype="float32",
         batch=batch, prompt_len=prompt_len, new_tokens=new,
         tolerance=PARITY_TOL,
         logits_max_abs_err=errs, token_gaps_where_differ=gaps,
         tokens_equal=same, decode_steps=sc.decode_steps,
         tokens_out=sc.tokens_out, first_layer_prefill_dropped=drops,
         frontend_embeds=None if fe is None else list(fe.shape),
         launches=counts, mlstm_fwd_by_source=fwd_sources,
         attention_fwd_by_source=attn_sources)
    paths = {phase: {**counts, "mlstm_chunkwise_tf32x3": fwd_sources.get(
        "mlstm_kernel_tf32x3.cu", 0),
        "flash_attention_tf32x3": attn_sources.get(
            "flash_attention_tf32x3.cu", 0)}}
    for case in mesh_cases:
        name = f"{phase}_{case}"
        if case == "tp_attention":
            paths[name] = parity_tp_attention(
                torch, dev, cfg, gpu, cpu, prompts, name, case,
                *PARITY_MESH_CASES[case])
        else:
            paths[name] = parity_on_mesh(
                torch, np, dev, cfg, gpu, cpu, prompts, new, name, case,
                *PARITY_MESH_CASES[case], drops_one_shard=drops)
    del gpu, cpu
    torch.cuda.empty_cache()
    return paths


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
    """(max abs error, largest |plain gradient|) over the gradients."""
    err = scale = 0.0
    for a, w in zip(got, want):
        if w.numel():
            err = max(err, _err(a, w))
            scale = max(scale, float(w.float().abs().max()))
    return err, scale


def rel_norm(torch, got, want) -> float:
    """||got - want|| / ||want|| in float32 (||got - want|| where want is
    0; NaN where got has one)."""
    diff = float(torch.linalg.vector_norm(got.float() - want.float()))
    norm = float(torch.linalg.vector_norm(want.float()))
    return diff / norm if norm > 0 else diff


def _hold_rel_norm(torch, name: str, got, want, dtype: str, where) -> float:
    """``rel_norm`` within ``ATTN_BWD_REL_NORM`` of the dtype; returns
    it."""
    rel = rel_norm(torch, got, want)
    if not rel <= ATTN_BWD_REL_NORM[dtype]:
        raise AssertionError(f"{name} kernel != plain at {where} ({dtype}): "
                             f"||got - want|| / ||want|| {rel}")
    return rel


def _hold_bwd(torch, got, want, dtype: str, where) -> tuple:
    """Holds dq, dk and dv each to its own plain gradient (max abs error
    within ``ATTN_TOL`` x max(1, its largest |plain value|), and
    ||got - want|| / ||want|| within ``ATTN_BWD_REL_NORM``), and the max
    abs error over the three within ``ATTN_TOL`` x max(1, their largest
    |plain value|).  Returns (max abs error, scale) over the three and
    each gradient's max abs error, scale and relative norm."""
    each = {}
    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
        if not w.numel():
            continue
        e, sc = _bwd_err([a], [w])
        _hold(f"flash_attention_bwd {gname}", e, dtype, where, sc)
        rel = _hold_rel_norm(torch, f"flash_attention_bwd {gname}", a, w,
                             dtype, where)
        each[gname] = {"max_abs_err": e, "scale": sc, "rel_norm_err": rel}
    err, scale = _bwd_err(got, want)
    _hold("flash_attention_bwd", err, dtype, where, scale)
    return err, scale, each


def _bwd_route(torch, dt, hd) -> str:
    """The source the backward's route table must pick: bf16 on
    ``wgmma``, float32 as split TF32 ``mma.sync``."""
    from repro_torch.kernels.flash_attention import bwd_source
    return bwd_source(dt, hd)


def phase_flash_attention_bwd(torch, np, dev):
    """The attention backward kernels (``csrc/flash_attention_bwd_sm90.cu``
    for bf16, ``csrc/flash_attention_bwd_tf32x3.cu`` for float32)
    against their plain version (``attention_flat_bwd_plain``) on the
    card, each gradient on its own (``_hold_bwd``), each case on the
    source and head parts its dtype and shape pick; timed at the
    trainer's shape beside SDPA's backward (its forward done before the
    timed window); two calls bit-equal; and through ``ops.flash_attention``
    under autograd on non-contiguous (B, S, H, hd) views.  Returns the
    first timed row of each dtype (bf16, float32)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (bwd_head_parts,
                                                     flash_attention_bshd,
                                                     flash_attention_bwd)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
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
            # the blocks a group's query heads were split over
            parts = flash_attention_bwd.head_parts
            if parts != bwd_head_parts(b, h, hkv, sk, hd, n_sm):
                raise AssertionError(f"flash_attention_bwd: {name} "
                                     f"({dname}) ran {parts} head parts")
            again = flash_attention_bwd(q, k, v, o, do, causal=causal,
                                        window=window)
            want = _bwd_plain(q, k, v, o, do, causal, window)
            torch.cuda.synchronize()
            err, scale, each = _hold_bwd(torch, got, want, dname, name)
            bit_equal = all(torch.equal(a, c) for a, c in zip(got, again))
            if not bit_equal:
                raise AssertionError(f"flash_attention_bwd: two calls "
                                     f"differ at {name} ({dname})")
            del got, again, want
            if not timed:
                edge.append({"case": name, "dtype": dname, "source": source,
                             "head_parts": parts, "max_abs_err": err,
                             "scale": scale, "by_gradient": each})
                continue
            kern = lambda: flash_attention_bwd(q, k, v, o, do, causal=causal,
                                               window=window)
            plain = lambda: _bwd_plain(q, k, v, o, do, causal, window)
            q4, k4, v4 = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            if window > 0:                  # a boolean band mask
                qpos = torch.arange(sq, device=dev)[:, None]
                kpos = torch.arange(sk, device=dev)[None, :]
                band = (kpos > qpos - window) & (
                    kpos <= qpos if causal else True)
                out = F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=band, enable_gqa=True)
            else:
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
            # float32: three TF32 products for each float32 one
            bound, by = (attn_bound_ms(n_bytes, 3 * flops, "tf32")
                         if dt == torch.float32 else
                         attn_bound_ms(n_bytes, flops, dname))
            main.append({
                "case": name, "dtype": dname, "source": source, "B": b,
                "H": h, "Hkv": hkv, "S": sq, "hd": hd, "head_parts": parts,
                "max_abs_err": err,
                "scale": scale, "by_gradient": each, "bit_equal": bit_equal,
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
        got = (gx[:, :, :h], gx[:, :, h:h + hkv], gx[:, :, h + hkv:])
        err, scale, _ = _hold_bwd(torch, got, want, _dname(torch, dt),
                                  "strided")
        strided.append({"view": "fused", "dtype": _dname(torch, dt),
                        "source": source, "contiguous": q.is_contiguous(),
                        "max_abs_err": err})
    emit("flash_attention_bwd", tolerance=ATTN_TOL,
         tolerance_relative_to="max(1, largest |plain value|), of each "
                               "gradient and of the three",
         rel_norm_limit=ATTN_BWD_REL_NORM,
         shapes=main, edge=edge, strided=strided)
    return tuple(next(r for r in main if r["dtype"] == d)
                 for d in ("bfloat16", "float32"))


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
        want_src = expected_mlstm_sources(cfg, want["mlstm_chunkwise_bwd"])
        want_fwd_src = expected_mlstm_sources(cfg, want["mlstm_chunkwise"],
                                              bwd=False)
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
            sources = _by_source("mlstm_chunkwise_bwd")
            fwd_sources = _by_source("mlstm_chunkwise")
            if sources != want_src or fwd_sources != want_fwd_src:
                raise AssertionError(f"{phase} step {step}: mLSTM backward "
                                     f"by source {sources}, forward "
                                     f"{fwd_sources}, expected {want_src}, "
                                     f"{want_fwd_src}")
            by_source = _by_source()
            if by_source != expected_bwd_sources(
                    torch, cfg, want["flash_attention_bwd"]):
                raise AssertionError(f"{phase} step {step}: attention "
                                     f"backward by source {by_source}")
            _hold_fwd_sources(torch, cfg, counts, f"{phase} step {step}")
            gnorm = float(metrics["grad_norm"])
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"{phase} step {step}: loss {loss}, "
                                     f"grad_norm {gnorm}")
            steps.append({"step": step, "wall_s": wall, "loss": loss,
                          "grad_norm": gnorm, "lr": float(metrics["lr"]),
                          "launches": counts})
            step_sources = _launches_by_source()
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
        records = device_records(prof)
        by_kernel, seen = _device_kernels(records, launched)
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
         mlstm_bwd_by_source_per_step=want_src,
         mlstm_fwd_by_source_per_step=want_fwd_src,
         moe_slots=None if drops is None else
         batch * seq_len * cfg.top_k,
         moe_dropped_slots_by_layer=drops,
         profiled_step_wall_s=prof_wall, profiled_step_device_busy_s=busy_s,
         profiled_step_device_idle_share=1 - busy_s / prof_wall,
         profiled_step_device_ops=sum(n for n, _ in records.values()),
         profiled_step_kernel_launches=launched,
         profiled_step_kernel_records_seen=seen,
         profiled_step_device_ms_by_op={k[:80]: us / 1e3 for k, us in top},
         profiled_step_device_ms_by_class=by_class,
         finite_gradient_leaves=n_leaves)
    TRAIN_RUNS[phase] = {"arch": arch, "n_layers": cfg.n_layers,
                         "peak_memory_bytes": peak, "step_s_median": med,
                         "launches_by_source": step_sources}
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
    host_free = host_bytes_available()
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
    # every float32 attention backward and mLSTM forward and backward on
    # its split-TF32 kernel
    by_source = _by_source()
    if by_source != expected_bwd_sources(torch, cfg,
                                         want["flash_attention_bwd"]):
        raise AssertionError(f"{phase}: attention backward by source "
                             f"{by_source}")
    mlstm_by_source = _by_source("mlstm_chunkwise_bwd")
    if mlstm_by_source != expected_mlstm_sources(
            cfg, want["mlstm_chunkwise_bwd"]):
        raise AssertionError(f"{phase}: mLSTM backward by source "
                             f"{mlstm_by_source}")
    mlstm_fwd_by_source = _by_source("mlstm_chunkwise")
    if mlstm_fwd_by_source != expected_mlstm_sources(
            cfg, want["mlstm_chunkwise"], bwd=False):
        raise AssertionError(f"{phase}: mLSTM forward by source "
                             f"{mlstm_fwd_by_source}")
    attn_fwd_by_source = _hold_fwd_sources(torch, cfg, counts, phase)
    (pc, oc), (ph, oh) = states["card"], states["cpu"]
    worst = {}
    for part, a_tree, c_tree in (("params", pc, ph), ("m", oc["m"], oh["m"]),
                                 ("v", oc["v"], oh["v"])):
        errs = []
        for a, c in zip(tree_leaves(a_tree), tree_leaves(c_tree)):
            # on the card, leaf by leaf: the same float32 differences and
            # maxima as on the host, without its passes over every leaf
            c = c.to(a.device)
            scale = max(1.0, float(c.abs().max()))
            errs.append(float((a - c).abs().max()) / scale)
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
         launches=counts, attention_fwd_by_source=attn_fwd_by_source,
         attention_bwd_by_source=by_source,
         mlstm_bwd_by_source=mlstm_by_source,
         mlstm_fwd_by_source=mlstm_fwd_by_source,
         seconds=seconds, host_bytes_available_before=host_free)
    return {**counts, "flash_attention_bwd_tf32x3": by_source.get(
        "flash_attention_bwd_tf32x3.cu", 0),
        "mlstm_chunkwise_bwd_tf32x3": mlstm_by_source.get(
            "mlstm_kernel_bwd_tf32x3.cu", 0),
        "mlstm_chunkwise_tf32x3": mlstm_fwd_by_source.get(
            "mlstm_kernel_tf32x3.cu", 0),
        "flash_attention_tf32x3": attn_fwd_by_source.get(
            "flash_attention_tf32x3.cu", 0)}


def host_bytes_available() -> int:
    """``MemAvailable`` of ``/proc/meminfo``, in bytes."""
    for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


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


#: the kernel phases that ``--phases`` runs alone, after device and build
#: each train phase's record, by phase (``phase_train`` fills it): the
#: arch, its layers, the peak of ``torch.cuda.max_memory_allocated``, the
#: median step time and one step's launches by source
TRAIN_RUNS: dict = {}
#: the dry run's predicted peak against the measured one, relative
DRY_RUN_PEAK_TOL = 0.10
#: the dry_run phase's most seconds (its counts are made by a process of
#: their own at the lowest priority, started after the kernel phases,
#: whose host-timed work it would share the cores with, while the serve
#: and train phases run)
DRY_RUN_PHASE_S = 30.0
#: the production cell whose record the dry_run phase prints
DRY_RUN_CELL = ("qwen3_4b", "train_4k", False)


def train_phases() -> list:
    """(phase, spec) of every train phase, in the order ``main`` runs
    them; spec as ``TRAIN``."""
    return [("train", TRAIN)] + [(f"train_{fam}", spec) for fam, spec
                                 in TRAIN_FAMILIES + TRAIN_RECURRENT]


def dry_run_counts(out_path: str) -> None:
    """The dry run's counts for the dry_run phase, written to
    ``out_path`` as JSON: each train phase's step (its arch at its cut
    depth, its batch and sequence, bf16, remat, one microbatch) traced on
    meta tensors on a (1, 1) mesh by ``repro_torch.launch.dryrun``, and
    the record of ``DRY_RUN_CELL``.  Needs no card; runs at the lowest
    priority on one thread."""
    import dataclasses

    import torch
    os.nice(19)
    torch.set_num_threads(1)

    from repro_torch import configs
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.mesh import make_test_mesh
    t0 = time.perf_counter()
    out = {"train": {}}
    for phase, (arch, batch, seq, _warm, _timed, n_layers) in train_phases():
        cfg = configs.get(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        t1 = time.perf_counter()
        rec = dryrun.count_cell(
            cfg, shapes.ShapeSpec(f"train_{seq}", "train", seq, batch),
            make_test_mesh(1, 1), arch=arch, n_microbatch=1)
        out["train"][phase] = dict(rec, count_s=time.perf_counter() - t1)
    t1 = time.perf_counter()
    out["cell"] = dict(dryrun.lower_cell(*DRY_RUN_CELL),
                       count_s=time.perf_counter() - t1)
    out["seconds"] = time.perf_counter() - t0
    out["cpu_s"] = time.process_time()
    pathlib.Path(out_path).write_text(json.dumps(out))


def start_dry_run_counts():
    """Starts :func:`dry_run_counts` in a process of its own with no card
    visible; returns (the process, its output path).  The process is
    killed at exit if it still runs."""
    import atexit
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json", prefix="dry_run_")
    os.close(fd)
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dry-run-counts",
         path], env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.DEVNULL)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path


def phase_dry_run(smi: str, worker, path: str) -> None:
    """The dry run (``repro_torch.launch.dryrun``) against the train
    phases: each phase's predicted peak within ``DRY_RUN_PEAK_TOL`` of its
    measured ``max_memory_allocated``, its kernel launches per step by
    source equal to the phase's, its counted FLOPs per step over the
    phase's median step; then the record of ``DRY_RUN_CELL``.  Waits for
    the counts' process; at most ``DRY_RUN_PHASE_S`` seconds."""
    t0 = time.perf_counter()
    rc = worker.wait(timeout=DRY_RUN_PHASE_S)
    if rc != 0:
        raise AssertionError(f"dry_run: the counts' process exited {rc}")
    counts = json.loads(pathlib.Path(path).read_text())
    os.unlink(path)
    rows = []
    for phase, run in TRAIN_RUNS.items():
        rec = counts["train"][phase]
        pred, meas = rec["peak_bytes"], run["peak_memory_bytes"]
        launches = {src: r["launches"] for src, r in rec["kernels"].items()}
        if abs(pred / meas - 1) > DRY_RUN_PEAK_TOL:
            raise AssertionError(f"dry_run {phase}: predicted peak {pred}, "
                                 f"measured {meas}")
        if launches != run["launches_by_source"]:
            raise AssertionError(f"dry_run {phase}: launches per step "
                                 f"{launches}, the phase's "
                                 f"{run['launches_by_source']}")
        rows.append({
            "phase": phase, "arch": run["arch"], "n_layers": run["n_layers"],
            "predicted_peak_bytes": pred, "measured_peak_bytes": meas,
            "peak_rel_err": pred / meas - 1,
            "argument_bytes": rec["memory"]["argument_bytes"],
            "launches_per_step": launches,
            "flops_per_step": rec["flops_per_chip"],
            "products_per_step": rec["products_per_chip"],
            "step_s_median": run["step_s_median"],
            "counted_flops_per_s": rec["flops_per_chip"]
            / run["step_s_median"],
            "count_s": rec["count_s"]})
    wall = time.perf_counter() - t0
    emit("dry_run", card=smi, peak_tolerance=DRY_RUN_PEAK_TOL, phases=rows,
         counts_process_s=counts["seconds"],
         counts_process_cpu_s=counts["cpu_s"], phase_s=wall)
    emit("dry_run_cell", card=smi, **counts["cell"])
    if wall > DRY_RUN_PHASE_S:
        raise AssertionError(f"dry_run: {wall:.1f} s, over "
                             f"{DRY_RUN_PHASE_S} s")


KERNEL_PHASES = {"flash_attention": phase_flash_attention,
                 "flash_attention_bwd": phase_flash_attention_bwd,
                 "decode_attention": phase_decode_attention,
                 "rglru_scan": phase_rglru_scan,
                 "rglru_scan_bwd": phase_rglru_scan_bwd,
                 "mlstm_chunkwise": phase_mlstm_chunkwise,
                 "mlstm_chunkwise_bwd": phase_mlstm_chunkwise_bwd}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", type=lambda v: v.split(","), default=[],
                    help="run only these kernel phases (of "
                         f"{', '.join(KERNEL_PHASES)}) after device and "
                         "build, each held to its plain version and "
                         "timed; prints no kernels line and no ok line")
    ap.add_argument("--dry-run-counts", metavar="PATH", default=None,
                    help="write the dry_run phase's counts to PATH and "
                         "exit (no card needed; main starts this itself)")
    args = ap.parse_args(argv)
    if args.dry_run_counts:
        dry_run_counts(args.dry_run_counts)
        return 0
    unknown = [p for p in args.phases if p not in KERNEL_PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown}")
    card = use_one_card()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.sim  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    _, smi = phase_device(torch, card)
    if args.phases:
        phase_build()
        for name in args.phases:
            KERNEL_PHASES[name](torch, np, dev)
        return 0
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
    fa, fa32 = phase_flash_attention(torch, np, dev)
    fb = phase_flash_attention_bwd(torch, np, dev)
    da = phase_decode_attention(torch, np, dev)
    rg = phase_rglru_scan(torch, np, dev)
    rgb = phase_rglru_scan_bwd(torch, np, dev)
    ml = phase_mlstm_chunkwise(torch, np, dev)
    mlb = phase_mlstm_chunkwise_bwd(torch, np, dev)
    dry_worker, dry_path = start_dry_run_counts()
    by_path = {"serve": phase_serve(torch, np, dev)}
    by_path.update(phase_serve_parity(
        torch, np, dev, mesh_cases=("tp_attention", "sp_decode")))
    by_path["serve_rglru"] = phase_serve(torch, np, dev, SERVE_RGLRU,
                                         "serve_rglru", seed=8)
    by_path.update(phase_serve_parity(
        torch, np, dev, SERVE_RGLRU[0], PARITY_RGLRU, "serve_parity_rglru"))
    by_path["serve_xlstm"] = phase_serve(torch, np, dev, SERVE_XLSTM,
                                         "serve_xlstm", seed=9)
    by_path.update(phase_serve_parity(
        torch, np, dev, SERVE_XLSTM[0], PARITY_XLSTM, "serve_parity_xlstm"))
    phase_live_serve(torch, dev)
    for spec, parity, fam, seed, cases in (
            (SERVE_MOE, PARITY_MOE, "moe", 10, ("expert_parallel",)),
            (SERVE_VLM, PARITY_VLM, "vlm", 11, ()),
            (SERVE_ENCDEC, PARITY_ENCDEC, "encdec", 12, ())):
        by_path[f"serve_{fam}"] = phase_serve(torch, np, dev, spec,
                                              f"serve_{fam}", seed=seed)
        by_path.update(phase_serve_parity(
            torch, np, dev, spec[0], parity, f"serve_parity_{fam}", cases))
    by_path["train"] = phase_train(torch, np, dev)
    by_path["train_parity"] = phase_train_parity(torch, np, dev)
    parity = {fam: rest for fam, *rest in TRAIN_PARITY_FAMILIES}
    for fam, spec in TRAIN_FAMILIES + TRAIN_RECURRENT:
        by_path[f"train_{fam}"] = phase_train(torch, np, dev, spec,
                                              f"train_{fam}")
        arch, pspec, overrides = parity[fam]
        by_path[f"train_parity_{fam}"] = phase_train_parity(
            torch, np, dev, pspec, arch, overrides, f"train_parity_{fam}")
    phase_dry_run(smi, dry_worker, dry_path)
    phase_live_recovery(torch, dev)
    phase_live_colocated(torch, dev)
    paths = {k: {"main_path": launches[k], "sweep": sweep_launches[k],
                 "campaign_main": campaign_main_launches[k],
                 "campaign": campaign_launches[k]}
             for k in ("minskew", "hub_route")}
    for kname in ("flash_attention", "flash_attention_bwd",
                  "decode_attention", "rglru_scan", "rglru_scan_bwd",
                  "mlstm_chunkwise", "mlstm_chunkwise_bwd"):
        paths[kname] = {p: c[kname] for p, c in by_path.items() if c[kname]}
    # the attention and mLSTM kernels by source: the float32 source's
    # launches (the parity phases, each holding every one to that source)
    # and the bf16 source's, the rest (each phase holds those too)
    for kname, key in BY_SOURCE.items():
        f32 = {p: c[key] for p, c in by_path.items() if c.get(key)}
        paths[kname] = {p: n - f32.get(p, 0)
                        for p, n in paths[kname].items() if n > f32.get(p, 0)}
        paths[key] = f32
    kernels = []
    for kname, row, src, tpu in (
            ("minskew", ms, "src/repro_torch/kernels/csrc/minskew.cu",
             "src/repro/kernels/minskew.py:67"),
            ("hub_route", hr, "src/repro_torch/kernels/csrc/hub_route.cu",
             "src/repro/kernels/hub_route.py:78"),
            ("flash_attention", fa,
             "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:91"),
            ("flash_attention_tf32x3", fa32,
             "src/repro_torch/kernels/csrc/flash_attention_tf32x3.cu",
             "src/repro/kernels/flash_attention.py:91 in float32"),
            ("flash_attention_bwd", fb[0],
             "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
             "gradient of src/repro/kernels/flash_attention.py:91 (the JAX "
             "package differentiates its jnp attention; no Pallas kernel)"),
            ("flash_attention_bwd_tf32x3", fb[1],
             "src/repro_torch/kernels/csrc/flash_attention_bwd_tf32x3.cu",
             "gradient of src/repro/kernels/flash_attention.py:91 in "
             "float32 (the JAX package differentiates its jnp attention; "
             "no Pallas kernel)"),
            ("decode_attention", da,
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:74"),
            ("rglru_scan", rg, "src/repro_torch/kernels/csrc/rglru_scan.cu",
             "src/repro/kernels/rglru_scan.py:60"),
            ("mlstm_chunkwise", ml[0],
             f"src/repro_torch/kernels/csrc/{ml[0]['kernel']}",
             "src/repro/kernels/mlstm_kernel.py:79"),
            ("mlstm_chunkwise_tf32x3", ml[1],
             f"src/repro_torch/kernels/csrc/{ml[1]['kernel']}",
             "src/repro/kernels/mlstm_kernel.py:79 in float32"),
            ("rglru_scan_bwd", rgb,
             "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
             "gradient of src/repro/kernels/rglru_scan.py:60 (the JAX "
             "package differentiates its jnp version; no Pallas kernel)"),
            ("mlstm_chunkwise_bwd", mlb[0],
             f"src/repro_torch/kernels/csrc/{mlb[0]['kernel']}",
             "gradient of src/repro/kernels/mlstm_kernel.py:79 (the JAX "
             "package differentiates its jnp version; no Pallas kernel)"),
            ("mlstm_chunkwise_bwd_tf32x3", mlb[1],
             f"src/repro_torch/kernels/csrc/{mlb[1]['kernel']}",
             "gradient of src/repro/kernels/mlstm_kernel.py:79 in float32 "
             "(the JAX package differentiates its jnp version; no Pallas "
             "kernel)")):
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
