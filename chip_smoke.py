#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold it to its plain
versions.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and ``nvcc``,
imports only ``repro_torch``, ``torch``, numpy and the standard library,
and catches nothing: any mismatch raises and the exit code is non-zero.
One JSON line per phase:

1. device — the card, ``nvidia-smi``'s name and power limit, versions;
2. build — both CUDA kernels compiled from ``src/repro_torch/kernels/csrc``;
3. minskew — kernel vs plain version on the card, bit-equal, timed;
4. hub_route — the same;
5. main path — a 16,384-vtask ``ChipRingTraining`` (16 pods x 1,024
   chips on 16 hosts) through ``Simulation.run(engine="vectorized")``
   on the card, with every kernel launch counter set to 0 just before
   and read just after, and its report equal to the same run on the CPU;
   then the same path stage by stage (compile, round loop, decompile)
   with the card's busy time in the loop from ``torch.profiler``;
6. sweep — the 64-variant ``RackRing`` straggler sweep on the card, each
   lane equal to the same sweep on the CPU (plain versions, ``links``
   included), to its solo run, and four lanes to the ``async`` engine;
7. check_interval — the round loop of the main path and of the sweep
   timed with the stop condition read back every 1, 4 and 16 rounds;
8. kernels — one object per kernel: launches on the main path, max
   error against the plain version, times and the card's bound.

It uses one card: the first visible one (``CUDA_VISIBLE_DEVICES`` is
narrowed to it before CUDA starts).

The last line is ``{"ok": true, "device": {...}}``.  ``*_ms`` times are
CUDA-event medians over single calls after warm-up (what a caller waits,
launch overhead included); ``*_device_ms`` are the kernels' own device
time per call from ``torch.profiler``; ``bound_ms`` is the bytes the
function must move over the card's 3.35 TB/s.  All on the card named in
phase 1.
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
#: timed calls per measurement, after warm-up
ITERS = 30
WARMUP = 5
#: fields every engine must agree on (tests/engine_harness.py CORE_FIELDS)
CORE_FIELDS = ("status", "n_hosts", "vtime_ns", "messages", "bytes",
               "tasks", "progress", "cells", "live")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def device_ms(torch, fn, names=None, iters: int = 20):
    """Device time per call of ``fn()`` in ms from ``torch.profiler``:
    the summed duration of the CUDA kernels it ran (only those whose
    name contains one of ``names``, when given).  None when the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and (names is None or any(n in e.key for n in names)))
    return us / iters / 1e3 if us > 0 else None


MINSKEW_KERNELS = ("minima_kernel", "elig_kernel")
HUB_KERNELS = ("tile_aggregate", "scan_aggregates", "tile_output")


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


def hub_inputs(np, rng, m: int, n_links: int, one_per_link: bool = False):
    """Messages sorted by (link, send); ~20% of durations are 163."""
    if one_per_link:
        link = np.arange(m, dtype=np.int32)
    else:
        link = np.sort(rng.integers(0, n_links, m)).astype(np.int32)
    send = rng.integers(0, 1_000_000, m).astype(np.int32)
    order = np.lexsort((send, link))
    send, link = send[order], link[order]
    ser = rng.integers(0, 10_000, m).astype(np.int32)
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


def phase_minskew(torch, np, dev):
    from repro_torch.kernels.minskew import minskew
    from repro_torch.kernels.ref import minskew_plain
    rng = np.random.default_rng(0)
    shapes = []
    for v, n, s in ((1, 16_384, 1), (1, 16_384, 256), (8, 4_096, 64)):
        err, t = check_minskew(torch, np, dev,
                               *minskew_inputs(np, rng, v, n, s))
        shapes.append({
            "V": v, "N": n, "S": s, "max_abs_err": err,
            "kernel_ms": timed_ms(torch, lambda: minskew(*t)),
            "plain_ms": timed_ms(torch, lambda: minskew_plain(*t)),
            "kernel_device_ms": device_ms(torch, lambda: minskew(*t),
                                          MINSKEW_KERNELS),
            "plain_device_ms": device_ms(torch, lambda: minskew_plain(*t)),
            "bound_ms": bound_ms(minskew_bytes(v, n, s))})
    for name, *arrs in minskew_edge_cases(np, rng):
        check_minskew(torch, np, dev, *arrs)
    emit("minskew", shapes=shapes, edge_cases="bit_equal")
    return shapes[0]


def hub_bytes(m: int, n_links: int) -> int:
    # in: send, ser, link (4 B each per message), lat (4 B per link);
    # out: 4 B per message
    return 16 * m + 4 * n_links


def phase_hub_route(torch, np, dev):
    from repro_torch.kernels.hub_route import hub_route
    from repro_torch.kernels.ref import hub_route_plain
    rng = np.random.default_rng(1)
    cases = [("main", 65_600, 16_416, False), ("large", 1 << 20, 4_096, False),
             ("m1", 1, 1, False), ("m7", 7, 1, False), ("m129", 129, 1, False),
             ("per_link", 4_099, 4_099, True)]
    shapes = []
    for name, m, n_links, one in cases:
        send, ser, link, lat = (
            torch.from_numpy(x).to(dev)
            for x in hub_inputs(np, rng, m, n_links, one))
        ones = torch.ones(n_links, dtype=torch.float32, device=dev)
        got = hub_route(send, ser, link, ones, lat, ser_ns=ser)
        want = hub_route_plain(send, ser, link, lat)
        err = max_abs_err(torch, got, want)
        if err != 0:
            raise AssertionError(f"hub_route kernel != plain on {name}: "
                                 f"max abs err {err}")
        if name in ("main", "large"):
            shapes.append({
                "case": name, "M": m, "links": n_links, "max_abs_err": err,
                "kernel_ms": timed_ms(torch, lambda: hub_route(
                    send, ser, link, ones, lat, ser_ns=ser)),
                "plain_ms": timed_ms(torch, lambda: hub_route_plain(
                    send, ser, link, lat)),
                "kernel_device_ms": device_ms(torch, lambda: hub_route(
                    send, ser, link, ones, lat, ser_ns=ser), HUB_KERNELS),
                "plain_device_ms": device_ms(torch, lambda: hub_route_plain(
                    send, ser, link, lat)),
                "bound_ms": bound_ms(hub_bytes(m, n_links))})
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
         pin_f32=f32, pin_ser_ns=exact)
    return shapes[0]


def main_path_sim():
    from repro_torch.core.cluster import ClusterSpec, StepCost
    from repro_torch.sim import ChipRingTraining, Simulation, Topology
    wl = ChipRingTraining(
        ClusterSpec(n_pods=16, chips_per_pod=1024),
        StepCost(compute_ns=5_000_000, ici_bytes=50_000_000,
                 dcn_bytes=6_000_000), n_steps=4)
    return Simulation(
        Topology.full_mesh(16, link=Topology().default_host_link), wl,
        placement={f"chip{i}": i // 1024 for i in range(16_384)})


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine_torch as et
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        et.run_vec_tape(tape, st0, comp.max_rounds, kernel=True)
        torch.cuda.synchronize()
        loop_prof_s = time.perf_counter() - tp
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    kernels_us = {k: sum(e.self_device_time_total
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and k in e.key)
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
    return axis, res.tick_ns


def loop_s(torch, run) -> tuple:
    """Host-clock seconds of one round loop ``run()``, synchronised at
    both ends, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, st


def phase_check_interval(torch, np, dev, axis, tick: int,
                         intervals=(1, 4, 16), repeats: int = 15):
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


def main() -> int:
    card = use_one_card()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.sim  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    name, _ = phase_device(torch, card)
    phase_build()
    ms = phase_minskew(torch, np, dev)
    hr = phase_hub_route(torch, np, dev)
    launches = phase_main_path(torch, dev)
    phase_main_path_breakdown(torch, dev)
    phase_check_interval(torch, np, dev, *phase_sweep(torch, dev))
    kernels = []
    for kname, row, src, tpu in (
            ("minskew", ms, "src/repro_torch/kernels/csrc/minskew.cu",
             "src/repro/kernels/minskew.py:67"),
            ("hub_route", hr, "src/repro_torch/kernels/csrc/hub_route.cu",
             "src/repro/kernels/hub_route.py:78")):
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[kname], "max_abs_err": row["max_abs_err"],
            "bit_equal": row["max_abs_err"] == 0, "ms": row["kernel_ms"],
            "kernel_ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "device_ms": row["kernel_device_ms"],
            "plain_device_ms": row["plain_device_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": {k: row[k] for k in row
                      if k in ("V", "N", "S", "M", "links")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
