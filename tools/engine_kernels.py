#!/usr/bin/env python3
"""Hold the engine's two kernels (``minskew``, ``hub_route``) to their
plain versions and take their times apart, on one CUDA card.

    python3 tools/engine_kernels.py [--first-design DIR] [--out PATH]

Run from the root of a checkout.  ``--first-design`` names a directory
holding the sources of the designs these kernels replaced (two launches
and a fill for ``minskew``, three launches for ``hub_route``), for
example extracted with

    C=src/repro_torch/kernels/csrc
    git show 61a9461:$C/minskew.cu > DIR/minskew.cu
    git show 61a9461:$C/hub_route.cu > DIR/hub_route.cu

which are built with the same flags and called through a copy of their
old wrappers' host path, in turns with the new ones.  The script:

1. checks every kernel against its plain version, bit for bit, at the
   shapes chip_smoke.py times and, for ``minskew``, at every cluster
   size R from 1 to 16;
2. times ``minskew`` at each R (profiler device time per call, the
   mean of the records it kept) to show what ``plan`` picks against;
3. takes each wrapper's host path apart with ``time.perf_counter_ns``
   (the input checks, the allocations, the device and stream queries,
   the ctypes call that launches) over many calls, new and old;
4. times an empty kernel launched the same way (``launch_floor``);
5. with ``--first-design``, runs the main path's round loop and its
   decompile in this process with the engine's wrappers swapped in
   turns, first designs against these (``engine_ab``).

One JSON line per measurement after ``nvidia-smi``'s name and power
limit; with ``--out`` the lines are also written to that file.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MINSKEW_SHAPES = ((1, 16_384, 1), (1, 16_384, 256), (8, 4_096, 64))
HUB_SHAPES = ((65_600, 16_416), (1 << 20, 4_096))
REPS = 2000
LINES = []


def emit(**fields) -> None:
    LINES.append(fields)
    print(json.dumps(fields), flush=True)


def profile_ms(torch, fn, names, iters: int = 50):
    """(device ms per call: the mean duration of the records whose name
    holds one of ``names``, summed over the names; {record name: count}
    over ``iters`` calls, every device record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms, seen = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        seen[e.key] = seen.get(e.key, 0) + e.count
        if e.self_device_time_total > 0 and any(n in e.key for n in names):
            ms += e.self_device_time_total / e.count / 1e3
    return ms or None, seen


def call_ms(torch, fn, iters: int = 30) -> float:
    """Median CUDA-event time of one call after warm-up."""
    for _ in range(5):
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


def host_us(torch, fn, reps: int = REPS) -> float:
    """Median host microseconds of ``fn()`` over ``reps`` calls, the
    stream drained every 64 calls outside the timed spans."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    ts = []
    for i in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        ts.append(time.perf_counter_ns() - t0)
        if i % 64 == 63:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(ts) / 1e3


def build_first(torch, src_dir: pathlib.Path):
    """The first designs' launchers, built from ``src_dir`` into build/,
    behind copies of their old wrappers' host path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import INF
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    procs = []
    for name in ("minskew", "hub_route"):
        so = _build.BUILD_DIR / f"lib{name}_first.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        procs.append((name, so, subprocess.Popen(
            [_build.find_nvcc(), *_build.FLAGS, "-o", str(so),
             str(src_dir / f"{name}.cu")])))
    for name, so, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"first design {name}: nvcc failed")
        libs[name] = ctypes.CDLL(str(so))
    ms_fn = libs["minskew"].minskew_launch
    ms_fn.argtypes = [P, P, P, P, P, P, I, I, I, P]
    ms_fn.restype = I
    hub_fn = libs["hub_route"].hub_route_launch
    hub_fn.argtypes = [P, P, P, P, P, P, I, I, P]
    hub_fn.restype = I
    libs["hub_route"].hub_route_tile.restype = I
    tile = libs["hub_route"].hub_route_tile()

    def check(name, t, dtype, shape, device):  # the old wrapper's _check
        if t.device != device:
            raise ValueError(name)
        if t.dtype != dtype:
            raise TypeError(name)
        if tuple(t.shape) != shape:
            raise ValueError(name)
        if not t.is_contiguous():
            raise ValueError(name)

    def minskew_old(vtime, runnable, membership, skew):
        v, n, s = membership.shape
        dev = vtime.device
        check("vtime", vtime, torch.int32, (v, n), dev)
        check("runnable", runnable, torch.int8, (v, n), dev)
        check("membership", membership, torch.int8, (v, n, s), dev)
        check("skew", skew, torch.int32, (v, s), dev)
        minima = torch.full((v, s), INF, dtype=torch.int32, device=dev)
        elig = torch.zeros((v, n), dtype=torch.int8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = ms_fn(vtime.data_ptr(), runnable.data_ptr(),
                        membership.data_ptr(), skew.data_ptr(),
                        minima.data_ptr(), elig.data_ptr(), v, n, s, stream)
        if err:
            raise RuntimeError(f"first minskew: CUDA error {err}")
        return minima, elig

    def hub_old(send, ser, link, lat):  # the old wrapper's _launch
        from repro_torch.kernels.hub_route import _check as hub_check
        dev = send.device
        m = send.shape[0]
        hub_check("send_vtime", send, None, dev)
        hub_check("ser", ser, m, dev)
        hub_check("link_id", link, m, dev)
        hub_check("link_lat_ns", lat, None, dev)
        out = torch.empty(m, dtype=torch.int32, device=dev)
        tiles = -(-m // tile)
        scratch = torch.empty(6 * tiles, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = hub_fn(send.data_ptr(), ser.data_ptr(), link.data_ptr(),
                         lat.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                         m, lat.shape[0], stream)
        if err:
            raise RuntimeError(f"first hub_route: CUDA error {err}")
        return out
    return minskew_old, hub_old


def hub_items_variants(torch, items=(8, 16)):
    """``csrc/hub_route.cu`` built with other ITEMS (messages a thread);
    {items: run(send, ser, link, lat) -> out}, each with its own
    zero-filled scratch."""
    from repro_torch.kernels import _build
    P, I = ctypes.c_void_p, ctypes.c_int
    procs = []
    for k in items:
        so = _build.BUILD_DIR / f"libhub_route_items{k}.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        procs.append((k, so, subprocess.Popen(
            [_build.find_nvcc(), *_build.FLAGS, f"-DITEMS={k}", "-o",
             str(so), str(_build.CSRC / "hub_route.cu")])))
    runs = {}
    for k, so, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"hub_route ITEMS={k}: nvcc failed")
        lib = ctypes.CDLL(str(so))
        fn = lib.hub_route_launch
        fn.argtypes = [P, P, P, P, P, P, I, I, I, P]
        fn.restype = I
        lib.hub_route_tile.restype = I
        lib.hub_route_scratch_bytes.argtypes = [I]
        lib.hub_route_scratch_bytes.restype = ctypes.c_longlong
        tile, cap = lib.hub_route_tile(), 4096
        buf = torch.zeros(lib.hub_route_scratch_bytes(cap), dtype=torch.uint8,
                          device="cuda")

        def run(send, ser, link, lat, fn=fn, buf=buf, cap=cap, tile=tile):
            m = send.shape[0]
            assert -(-m // tile) <= cap
            out = torch.empty(m, dtype=torch.int32, device=send.device)
            err = fn(send.data_ptr(), ser.data_ptr(), link.data_ptr(),
                     lat.data_ptr(), out.data_ptr(), buf.data_ptr(), m,
                     lat.shape[0], cap, _build.stream_ptr(torch, send.device))
            if err:
                raise RuntimeError(f"hub_route ITEMS: CUDA error {err}")
            return out
        runs[k] = run
    return runs


def minskew_variants(torch, configs=((512, 4), (512, 8), (1024, 4))):
    """``csrc/minskew.cu`` built with other (THREADS, BATCH): threads a
    block and rows a thread in flight; {(threads, batch): launcher with
    the module's launcher's arguments}."""
    from repro_torch.kernels import _build
    P, I = ctypes.c_void_p, ctypes.c_int
    procs = []
    for th, b in configs:
        so = _build.BUILD_DIR / f"libminskew_t{th}_b{b}.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        procs.append(((th, b), so, subprocess.Popen(
            [_build.find_nvcc(), *_build.FLAGS, f"-DTHREADS={th}",
             f"-DBATCH={b}", "-o", str(so),
             str(_build.CSRC / "minskew.cu")])))
    fns = {}
    for key, so, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"minskew {key}: nvcc failed")
        fn = ctypes.CDLL(str(so)).minskew_launch
        fn.argtypes = [P] * 6 + [I] * 6 + [P]
        fn.restype = I
        fns[key] = fn
    return fns


def launch_floor(torch, dev):
    from repro_torch.kernels import _build
    fn = _build.load("launch_floor").launch_floor_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call():
        err = fn(torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch_floor: CUDA error {err}")
    return call


def one_buffer(torch, dev, v, n, s):
    """Both outputs as views of one allocation (an alternative the
    wrapper does not take; timed for comparison)."""
    buf = torch.empty(4 * v * s + v * n, dtype=torch.uint8, device=dev)
    return (buf[:4 * v * s].view(torch.int32).view(v, s),
            buf[4 * v * s:].view(torch.int8).view(v, n))


def device_context(torch, dev) -> None:
    with torch.cuda.device(dev):
        pass


def minskew_split(torch, dev, t, old):
    """Host microseconds of each part of the wrapper's call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import minskew as km
    vt, run, mem, skew = t
    dev = vt.device
    v, n, s = mem.shape
    fn = km._lib()
    p = km.plan(v, n, s)
    minima = torch.empty((v, s), dtype=torch.int32, device=dev)
    elig = torch.empty((v, n), dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def checks():
        km._check("vtime", vt, torch.int32, (v, n), dev)
        km._check("runnable", run, torch.int8, (v, n), dev)
        km._check("membership", mem, torch.int8, (v, n, s), dev)
        km._check("skew", skew, torch.int32, (v, s), dev)

    def launch():
        fn(vt.data_ptr(), run.data_ptr(), mem.data_ptr(), skew.data_ptr(),
           minima.data_ptr(), elig.data_ptr(), v, n, s, p.cluster,
           p.kept_rows, p.vec, stream)
    parts = {
        "wrapper": lambda: km.minskew(vt, run, mem, skew),
        "checks": checks,
        "alloc_empty_x2": lambda: (
            torch.empty((v, s), dtype=torch.int32, device=dev),
            torch.empty((v, n), dtype=torch.int8, device=dev)),
        "alloc_one_and_views": lambda: one_buffer(torch, dev, v, n, s),
        "plan": lambda: km.plan(v, n, s, mem.data_ptr() % 16 == 0),
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream_ptr": lambda: _build.stream_ptr(torch, dev),
        "ctypes_launch": launch,
        "old_fill_x2": lambda: (
            torch.full((v, s), 1 << 30, dtype=torch.int32, device=dev),
            torch.zeros((v, n), dtype=torch.int8, device=dev)),
        "old_device_context": lambda: device_context(torch, dev),
    }
    if old is not None:
        parts["old_wrapper"] = lambda: old(vt, run, mem, skew)
    return {k: host_us(torch, f) for k, f in parts.items()}


def hub_split(torch, dev, t, old):
    from repro_torch.kernels import _build
    from repro_torch.kernels import hub_route as kh
    send, ser, link, lat = t
    dev = send.device
    m = send.shape[0]
    fn = kh._lib()[0]
    out = torch.empty(m, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    buf, cap = kh._scratch(dev, stream, -(-m // kh.TILE))
    ones = torch.ones(lat.shape[0], dtype=torch.float32, device=dev)

    def checks():
        kh._check("send_vtime", send, None, dev)
        kh._check("ser", ser, m, dev)
        kh._check("link_id", link, m, dev)
        kh._check("link_lat_ns", lat, None, dev)

    def launch():
        fn(send.data_ptr(), ser.data_ptr(), link.data_ptr(), lat.data_ptr(),
           out.data_ptr(), buf.data_ptr(), m, lat.shape[0], cap, stream)
    parts = {
        "wrapper": lambda: kh.hub_route(send, ser, link, ones, lat,
                                        ser_ns=ser),
        "checks": checks,
        "alloc_empty": lambda: torch.empty(m, dtype=torch.int32, device=dev),
        "scratch_lookup": lambda: kh._scratch(dev, stream, -(-m // kh.TILE)),
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream_ptr": lambda: _build.stream_ptr(torch, dev),
        "ctypes_launch": launch,
        "old_scratch_alloc": lambda: torch.empty(
            6 * -(-m // kh.TILE), dtype=torch.int32, device=dev),
    }
    if old is not None:
        parts["old_wrapper"] = lambda: old(send, ser, link, lat)
    return {k: host_us(torch, f) for k, f in parts.items()}


def engine_ab(torch, old_ms, old_hub, turns: int = 12) -> dict:
    """The main path's round loop and decompile in this process, with
    the engine's two wrappers swapped in turns: the first designs' (old)
    and this tree's (new), new first in every other pair.  Host clock
    between synchronisations; the same compiled tape each time."""
    import chip_smoke as cs
    from repro_torch.core import engine_torch as et
    from repro_torch.kernels import hub_route as kh
    from repro_torch.kernels import minskew as km
    from repro_torch.sim import vectorized as vz
    dev = torch.device("cuda")
    sim = cs.main_path_sim()
    comp = vz.compile_simulation(sim)
    tape = et.tape_from_numpy(comp.tape, dev)
    st0 = et.init_vec_sim_state(tape, comp.n_channels)

    def hub_old_fan(send, size, link, bw, lat, ser_ns=None):
        return old_hub(send, ser_ns, link, lat)
    wrappers = {"new": (km.minskew, kh.hub_route),
                "old": (old_ms, hub_old_fan)}
    out = {f"{w}_{k}": [] for w in wrappers for k in ("loop_s", "decompile_s")}
    reports = {}
    try:
        for i in range(turns):
            for w in (("new", "old") if i % 2 else ("old", "new")):
                et.minskew_kernel, vz.hub_route = wrappers[w]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = et.run_vec_tape(tape, st0, comp.max_rounds, kernel=True)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                rep = vz._decompile(sim, comp, st, 0.0, device=dev,
                                    kernel=True, verify=False)
                t2 = time.perf_counter()
                if i:                                   # the first: warm-up
                    out[f"{w}_loop_s"].append(t1 - t0)
                    out[f"{w}_decompile_s"].append(t2 - t1)
                reports[w] = rep.to_dict()
    finally:
        et.minskew_kernel, vz.hub_route = km.minskew, kh.hub_route
    if reports["new"] != reports["old"]:
        raise AssertionError("engine A/B: reports differ")
    summary = {k: statistics.median(v) for k, v in out.items()}
    summary.update({f"{k}_all": v for k, v in out.items()})
    # one profiled loop each: the card's time by kernel (us; the port's
    # ctypes kernels as mean record x launches, their records being
    # partial)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for w in ("old", "new", "old", "new"):
        calls = []

        def counted(*a, fn=wrappers[w][0]):
            calls.append(1)
            return fn(*a)
        et.minskew_kernel = counted
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            et.run_vec_tape(tape, st0, comp.max_rounds, kernel=True)
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total:
                per = e.self_device_time_total / e.count
                ctypes_kernel = ("minskew_cluster" in e.key
                                 or "minima_kernel" in e.key
                                 or "elig_kernel" in e.key)
                name = e.key[:60]
                by[name] = by.get(name, 0.0) + (
                    per * len(calls) if ctypes_kernel
                    else e.self_device_time_total)
        summary[f"{w}_busy_us"] = sum(by.values())
        summary[f"{w}_by_kernel_us"] = dict(
            sorted(by.items(), key=lambda kv: -kv[1])[:8])
    et.minskew_kernel = km.minskew
    return summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--first-design", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("engine_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import minskew as km
    from repro_torch.kernels.hub_route import hub_route
    from repro_torch.kernels.ref import hub_route_plain, minskew_plain
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    _build.build_all()
    old_ms = old_hub = None
    if args.first_design:
        old_ms, old_hub = build_first(torch, args.first_design)

    floor = launch_floor(torch, dev)
    emit(kernel="launch_floor", call_ms=call_ms(torch, floor),
         batch_ms=cs.batch_ms(torch, floor),
         device_ms=profile_ms(torch, floor, ("launch_floor_kernel",))[0],
         host_us=host_us(torch, floor))

    ms_variants = minskew_variants(torch)
    rng = np.random.default_rng(0)
    for v, n, s in MINSKEW_SHAPES:
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in cs.minskew_inputs(np, rng, v, n, s)]
        want = minskew_plain(*t)
        row = {"kernel": "minskew", "V": v, "N": n, "S": s,
               "plan": km.plan(v, n, s)._asdict(), "bound_ms": cs.bound_ms(
                   cs.minskew_bytes(v, n, s))}
        for r in (1, 2, 3, 4, 8, 16):
            got = km._launch(*t, cluster=r)
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"minskew R={r} at {(v, n, s)}")
            if r != 3:
                row[f"R{r}_device_ms"] = profile_ms(
                    torch, lambda r=r: km._launch(*t, cluster=r),
                    ("minskew_cluster_kernel",))[0]
        p = km.plan(v, n, s)
        for (th, b), fn in ms_variants.items():
            mi = torch.empty((v, s), dtype=torch.int32, device=dev)
            el = torch.empty((v, n), dtype=torch.int8, device=dev)

            def var(fn=fn, mi=mi, el=el):
                err = fn(*(x.data_ptr() for x in t), mi.data_ptr(),
                         el.data_ptr(), v, n, s, p.cluster,
                         p.kept_rows, p.vec,
                         _build.stream_ptr(torch, dev))
                if err:
                    raise RuntimeError(f"minskew variant: CUDA error {err}")
            var()
            if not (torch.equal(mi, want[0]) and torch.equal(el, want[1])):
                raise AssertionError(f"minskew THREADS={th} BATCH={b}")
            row[f"threads{th}_batch{b}_device_ms"] = profile_ms(
                torch, var, ("minskew_cluster_kernel",))[0]
        dms, seen = profile_ms(torch, lambda: km.minskew(*t),
                               ("minskew_cluster_kernel",))
        row.update(device_ms=dms, records=seen,
                   call_ms=call_ms(torch, lambda: km.minskew(*t)))
        if old_ms is not None:
            got = old_ms(*t)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"first minskew at {(v, n, s)}")
            row["first_device_ms"] = profile_ms(
                torch, lambda: old_ms(*t),
                ("minima_kernel", "elig_kernel"))[0]
            row["first_call_ms"] = call_ms(torch, lambda: old_ms(*t))
            row["call_ms_again"] = call_ms(torch, lambda: km.minskew(*t))
            row["batch_ms"] = cs.batch_ms(torch, lambda: km.minskew(*t))
            row["first_batch_ms"] = cs.batch_ms(torch, lambda: old_ms(*t))
        row["host_us"] = minskew_split(torch, dev, t, old_ms)
        emit(**row)
    for name, *arrs in cs.minskew_edge_cases(np, rng):
        cs.check_minskew(torch, np, dev, *arrs)

    variants = hub_items_variants(torch)
    rng = np.random.default_rng(1)
    for m, links in HUB_SHAPES:
        send, ser, link, lat = t = [
            torch.from_numpy(x).to(dev)
            for x in cs.hub_inputs(np, rng, m, links)]
        ones = torch.ones(links, dtype=torch.float32, device=dev)
        want = hub_route_plain(send, ser, link, lat)

        def new():
            return hub_route(send, ser, link, ones, lat, ser_ns=ser)
        for _ in range(3):
            if not torch.equal(new(), want):
                raise AssertionError(f"hub_route at M={m}")
        dms, seen = profile_ms(torch, new, ("hub_lookback_kernel",))
        row = {"kernel": "hub_route", "M": m, "links": links,
               "bound_ms": cs.bound_ms(cs.hub_bytes(m, links)),
               "device_ms": dms, "records": seen,
               "call_ms": call_ms(torch, new)}
        for k, run in variants.items():
            if not torch.equal(run(*t), want):
                raise AssertionError(f"hub_route ITEMS={k} at M={m}")
            row[f"items{k}_device_ms"] = profile_ms(
                torch, lambda run=run: run(*t), ("hub_lookback_kernel",))[0]
        if old_hub is not None:
            if not torch.equal(old_hub(*t), want):
                raise AssertionError(f"first hub_route at M={m}")
            row["first_device_ms"] = profile_ms(
                torch, lambda: old_hub(*t),
                ("tile_aggregate", "scan_aggregates", "tile_output"))[0]
            row["first_call_ms"] = call_ms(torch, lambda: old_hub(*t))
            row["call_ms_again"] = call_ms(torch, new)
            row["batch_ms"] = cs.batch_ms(torch, new)
            row["first_batch_ms"] = cs.batch_ms(torch, lambda: old_hub(*t))
        row["host_us"] = hub_split(torch, dev, t, old_hub)
        emit(**row)
    if old_ms is not None:
        emit(kernel="engine_ab", **engine_ab(torch, old_ms, old_hub))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in LINES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
