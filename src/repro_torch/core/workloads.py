"""Table-2 workload suite: the same *unmodified* workload functions run
three ways —

  physical  : real threads + real wire delays (the "hardware switch"
              testbed; ground truth wall-clock),
  livestack : the identical functions as live vtasks under virtual time
              (accuracy = predicted vtime vs physical wall-clock),
  DES       : fine-grained event simulation of the same spans (the
              gem5-style baseline; wall-time comparison).

Workloads mirror the paper's categories:
  arith    — CoreMark analogue (1 instance, pure compute)
  oltp     — TPC-C analogue (2 instances: client+server, request/response)
  kvstore  — YCSB analogue (3 instances: 2 clients + 1 server)
  shuffle  — TPC-DS analogue (3 instances: map -> all-to-all -> reduce)

The compute bodies are numpy (releases the GIL, so the physical runs get
real parallelism) and are bit-identical between modes — the paper's
"compatibility" requirement, in-process.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import os

from repro_torch.core.des import DESEngine, extrapolate_wall_s, \
    fine_grained_compute
from repro_torch.core.ipc import Endpoint, Hub, LinkSpec
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.scope import Scope
from repro_torch.core.vtask import Compute, LiveCall, Recv, Send, VTask
from repro_torch.core.vtime import SEC, US


# ---------------------------------------------------------------------------
# The "production" compute functions (identical in every mode)
# ---------------------------------------------------------------------------


def arith_kernel(n: int = 64) -> float:
    a = np.random.default_rng(0).random((n, n))
    x = a
    for _ in range(4):
        x = np.tanh(x @ a)
    return float(x.sum())


def txn_kernel(store: dict, key: int, payload: np.ndarray) -> float:
    """An OLTP transaction: read-modify-write + a little math."""
    cur = store.get(key, 0.0)
    val = float(np.dot(payload, payload) * 1e-6 + cur * 0.5)
    store[key] = val
    return val


def kv_read(store: dict, key: int) -> float:
    v = store.get(key, 0.0)
    return float(np.sqrt(abs(v) + 1.0))


def map_kernel(shard: np.ndarray, n_parts: int) -> List[np.ndarray]:
    """Map phase: transform + partition by hash."""
    y = np.sin(shard) * shard
    parts = [y[i::n_parts].copy() for i in range(n_parts)]
    return parts


def reduce_kernel(parts: List[np.ndarray]) -> float:
    return float(sum(p.sum() for p in parts))


# ---------------------------------------------------------------------------
# Physical testbed: threads + a wire with real (slept) latency
# ---------------------------------------------------------------------------


class Wire:
    """Point-to-point link with bandwidth/latency enforced in wall time,
    matching Hub/LinkSpec semantics (serialization + propagation).

    Delivery uses sleep for the bulk + a short spin for the tail, so the
    enforced latency is close to nominal; the residual OS overhead
    (queue wake-ups, GIL hops) is measured by ``calibrate_wire`` and
    folded into the hub's link parameters — the paper's methodology
    ("prototype hub parameters set to match" the physical switch)."""

    SPIN_S = 2e-4

    def __init__(self, bandwidth_bps: float, latency_s: float):
        self.q: "queue.Queue" = queue.Queue()
        self.bw = bandwidth_bps
        self.lat = latency_s
        self._busy_until = 0.0
        self._lock = threading.Lock()

    def send(self, payload, size_bytes: int) -> None:
        now = time.perf_counter()
        with self._lock:
            start = max(now, self._busy_until)
            end = start + size_bytes * 8 / self.bw
            self._busy_until = end
        self.q.put((end + self.lat, payload))

    def recv(self):
        deliver_at, payload = self.q.get()
        while True:
            now = time.perf_counter()
            if now >= deliver_at:
                return payload
            if deliver_at - now > self.SPIN_S:
                time.sleep(deliver_at - now - self.SPIN_S)


_CALIBRATED: dict = {}


def calibrate_wire(n_pings: int = 400) -> "LinkSpec":
    """Measure the physical testbed's *effective* link characteristics
    (nominal latency + OS residuals) and return the matched LinkSpec for
    the LiveStack hub — exactly how the paper matches its hub to the
    hardware switch."""
    if "link" in _CALIBRATED:
        return _CALIBRATED["link"]
    size = 64
    up = Wire(LINK_BW, LINK_LAT_S)
    down = Wire(LINK_BW, LINK_LAT_S)

    def echo():
        for _ in range(n_pings):
            down.send(up.recv(), size)

    th = threading.Thread(target=echo)
    th.start()
    t0 = time.perf_counter()
    for i in range(n_pings):
        up.send(i, size)
        down.recv()
    rtt = (time.perf_counter() - t0) / n_pings
    th.join()
    ser = 2 * size * 8 / LINK_BW
    eff_lat_ns = max(int((rtt - ser) / 2 * 1e9), 1000)
    link = LinkSpec(bandwidth_bps=LINK_BW, latency_ns=eff_lat_ns)
    _CALIBRATED["link"] = link
    _CALIBRATED["overhead_ns"] = max(eff_lat_ns - int(LINK_LAT_S * 1e9),
                                     0)
    return link


@dataclasses.dataclass
class WorkloadResult:
    name: str
    mode: str                       # physical | livestack | des
    sim_s: float                    # simulated/predicted duration
    wall_s: float                   # wall-clock of the run itself
    metrics: Dict[str, float]


LINK = LinkSpec(bandwidth_bps=10e9, latency_ns=50_000)     # 50 us switch
LINK_BW = 10e9
LINK_LAT_S = 50e-6


# ------------------------------- arith ---------------------------------------


def _host_cpus() -> int:
    return os.cpu_count() or 1


def arith_physical(iters: int = 300) -> WorkloadResult:
    arith_kernel()                                  # warm-up (cold numpy)
    t0 = time.perf_counter()
    for _ in range(iters):
        arith_kernel()
    wall = time.perf_counter() - t0
    return WorkloadResult("arith", "physical", wall, wall,
                          {"iters_per_s": iters / wall})


def arith_livestack(iters: int = 300) -> WorkloadResult:
    arith_kernel()                                  # warm-up (cold numpy)
    sched = Scheduler(n_cpus=1)

    def body():
        for _ in range(iters):
            yield LiveCall(arith_kernel)

    t = sched.spawn(VTask("arith", body(), kind="live"))
    t0 = time.perf_counter()
    sched.run()
    wall = time.perf_counter() - t0
    sim_s = t.vtime / SEC
    return WorkloadResult("arith", "livestack", sim_s, wall,
                          {"iters_per_s": iters / sim_s})


def arith_des(iters: int = 300, grain_ns: int = 1000) -> WorkloadResult:
    """DES baseline: each kernel invocation modeled at grain_ns events,
    executing the same functional work."""
    # calibrate per-iteration duration once (a DES would know it from its
    # microarchitectural model; we grant it the oracle duration)
    t0 = time.perf_counter()
    arith_kernel()
    per_iter_ns = int((time.perf_counter() - t0) * SEC)
    eng = DESEngine()
    state = {"left": iters, "t": 0}

    def launch():
        if state["left"] == 0:
            return
        state["left"] -= 1
        fine_grained_compute(eng, eng.now, per_iter_ns, grain_ns, launch,
                             work_fn=arith_kernel)

    launch()
    stats = eng.run(wall_budget_s=10.0)
    total_events = iters * max(1, per_iter_ns // grain_ns)
    wall = (stats["wall_s"] if stats["exhausted"]
            else extrapolate_wall_s(stats, total_events))
    return WorkloadResult("arith", "des", iters * per_iter_ns / SEC, wall,
                          {"events": total_events,
                           "extrapolated": 0.0 if stats["exhausted"]
                           else 1.0})


# ------------------------------- oltp ----------------------------------------


def _oltp_payloads(n: int, size: int = 2048):
    rng = np.random.default_rng(7)
    return rng.random((n, size))


def oltp_physical(n_req: int = 800) -> WorkloadResult:
    payloads = _oltp_payloads(n_req)
    txn_kernel({}, 0, payloads[0])                  # warm-up
    up = Wire(LINK_BW, LINK_LAT_S)
    down = Wire(LINK_BW, LINK_LAT_S)
    store: dict = {}
    lat: List[float] = []

    def server():
        for _ in range(n_req):
            i = up.recv()
            txn_kernel(store, int(i) % 97, payloads[i])
            down.send(i, 256)

    def client():
        for i in range(n_req):
            t0 = time.perf_counter()
            up.send(i, 16_384)
            _ = down.recv()
            lat.append(time.perf_counter() - t0)

    ts = threading.Thread(target=server)
    tc = threading.Thread(target=client)
    t0 = time.perf_counter()
    ts.start()
    tc.start()
    tc.join()
    ts.join()
    wall = time.perf_counter() - t0
    return WorkloadResult("oltp", "physical", wall, wall, {
        "avg_latency_us": float(np.mean(lat) * 1e6),
        "throughput_ops": n_req / wall,
    })


def oltp_livestack(n_req: int = 800) -> WorkloadResult:
    payloads = _oltp_payloads(n_req)
    hub = Hub("oltp", calibrate_wire())
    txn_kernel({}, 0, payloads[0])                  # warm-up
    sched = Scheduler(n_cpus=_host_cpus(), send_overhead_ns=2_000,
                      cpu_resource=True)
    cl = hub.attach(Endpoint("client"))
    sv = hub.attach(Endpoint("server"))
    store: dict = {}
    lat_v: List[int] = []

    def server():
        for _ in range(n_req):
            msg = yield Recv(sv)
            i = msg.payload
            yield LiveCall(txn_kernel, (store, int(i) % 97, payloads[i]))
            yield Send(sv, "client", 256, payload=i)

    def client():
        for i in range(n_req):
            t0 = yield Send(cl, "server", 16_384, payload=i)
            yield Recv(cl)

    c = sched.spawn(VTask("client", client(), kind="live"))
    s = sched.spawn(VTask("server", server(), kind="live"))
    scope = Scope("oltp", 200 * US)
    c.join(scope)
    s.join(scope)
    t0 = time.perf_counter()
    sched.run()
    wall = time.perf_counter() - t0
    sim_s = max(c.vtime, s.vtime) / SEC
    # per-request latency from the hub stats: sim duration / n
    return WorkloadResult("oltp", "livestack", sim_s, wall, {
        "avg_latency_us": sim_s / n_req * 1e6,
        "throughput_ops": n_req / sim_s,
    })


def oltp_des(n_req: int = 800, grain_ns: int = 1000) -> WorkloadResult:
    payloads = _oltp_payloads(4)
    store: dict = {}
    t0 = time.perf_counter()
    for i in range(4):
        txn_kernel(store, i, payloads[i])
    txn_ns = int((time.perf_counter() - t0) / 4 * SEC)
    wire_ns = int(LINK_LAT_S * SEC + 16_384 * 8 / LINK_BW * SEC)
    eng = DESEngine()
    state = {"left": n_req}

    def request():
        if state["left"] == 0:
            return
        state["left"] -= 1

        def arrive():
            fine_grained_compute(eng, eng.now, txn_ns, grain_ns, reply)

        def reply():
            eng.schedule(eng.now + wire_ns, request)

        eng.schedule(eng.now + wire_ns, arrive)

    request()
    stats = eng.run(wall_budget_s=10.0)
    per_req_events = max(1, txn_ns // grain_ns) + 2
    total_events = n_req * per_req_events
    wall = (stats["wall_s"] if stats["exhausted"]
            else extrapolate_wall_s(stats, total_events))
    sim_s = n_req * (txn_ns + 2 * wire_ns) / SEC
    return WorkloadResult("oltp", "des", sim_s, wall,
                          {"events": total_events})


# ------------------------------- kvstore -------------------------------------


def kv_physical(n_ops: int = 600, n_clients: int = 2) -> WorkloadResult:
    rng = np.random.default_rng(3)
    keys = rng.zipf(1.5, size=(n_clients, n_ops)) % 1024
    ups = [Wire(LINK_BW, LINK_LAT_S) for _ in range(n_clients)]
    downs = [Wire(LINK_BW, LINK_LAT_S) for _ in range(n_clients)]
    req = Wire(LINK_BW, LINK_LAT_S)   # client -> server mux
    store: dict = {i: float(i) for i in range(1024)}
    payload = np.random.default_rng(5).random(512)

    def server():
        for _ in range(n_clients * n_ops):
            ci, op, key = req.recv()
            if op == 0:
                kv_read(store, int(key))
            else:
                txn_kernel(store, int(key), payload)
            downs[ci].send(key, 128)

    def client(ci):
        for j in range(n_ops):
            req.send((ci, j % 10 == 0, keys[ci, j]), 1024)
            downs[ci].recv()

    th = [threading.Thread(target=server)] + [
        threading.Thread(target=client, args=(ci,))
        for ci in range(n_clients)]
    t0 = time.perf_counter()
    for t in th:
        t.start()
    for t in th:
        t.join()
    wall = time.perf_counter() - t0
    return WorkloadResult("kvstore", "physical", wall, wall,
                          {"runtime_s": wall})


def kv_livestack(n_ops: int = 600, n_clients: int = 2) -> WorkloadResult:
    rng = np.random.default_rng(3)
    keys = rng.zipf(1.5, size=(n_clients, n_ops)) % 1024
    hub = Hub("kv", calibrate_wire())
    sched = Scheduler(n_cpus=_host_cpus(), send_overhead_ns=2_000,
                      cpu_resource=True)
    sv = hub.attach(Endpoint("server"))
    ceps = [hub.attach(Endpoint(f"client{i}")) for i in range(n_clients)]
    store: dict = {i: float(i) for i in range(1024)}
    payload = np.random.default_rng(5).random(512)

    def server():
        for _ in range(n_clients * n_ops):
            msg = yield Recv(sv)
            ci, write, key = msg.payload
            if write:
                yield LiveCall(txn_kernel, (store, int(key), payload))
            else:
                yield LiveCall(kv_read, (store, int(key)))
            yield Send(sv, f"client{ci}", 128, payload=key)

    def client(ci):
        def body():
            for j in range(n_ops):
                yield Send(ceps[ci], "server", 1024,
                           payload=(ci, j % 10 == 0, keys[ci, j]))
                yield Recv(ceps[ci])
        return body

    s = sched.spawn(VTask("server", server(), kind="live"))
    cs = [sched.spawn(VTask(f"client{i}", client(i)(), kind="live"))
          for i in range(n_clients)]
    scope = Scope("kv", 200 * US)
    for t in [s] + cs:
        t.join(scope)
    t0 = time.perf_counter()
    sched.run()
    wall = time.perf_counter() - t0
    sim_s = max(t.vtime for t in [s] + cs) / SEC
    return WorkloadResult("kvstore", "livestack", sim_s, wall,
                          {"runtime_s": sim_s})


# ------------------------------- shuffle -------------------------------------


def _shards(n_workers: int, size: int = 400_000):
    rng = np.random.default_rng(11)
    return [rng.random(size) for _ in range(n_workers)]


def shuffle_physical(n_workers: int = 3, rounds: int = 6) -> WorkloadResult:
    shards = _shards(n_workers)
    for sh in shards:
        map_kernel(sh, n_workers)                   # warm-up
    wires = {(i, j): Wire(LINK_BW, LINK_LAT_S)
             for i in range(n_workers) for j in range(n_workers) if i != j}
    results = [0.0] * n_workers

    def worker(i):
        for _ in range(rounds):
            parts = map_kernel(shards[i], n_workers)
            for j in range(n_workers):
                if j != i:
                    wires[(i, j)].send(parts[j], parts[j].nbytes)
            mine = [parts[i]]
            for j in range(n_workers):
                if j != i:
                    mine.append(wires[(j, i)].recv())
            results[i] = reduce_kernel(mine)

    th = [threading.Thread(target=worker, args=(i,))
          for i in range(n_workers)]
    t0 = time.perf_counter()
    for t in th:
        t.start()
    for t in th:
        t.join()
    wall = time.perf_counter() - t0
    return WorkloadResult("shuffle", "physical", wall, wall,
                          {"runtime_s": wall})


def shuffle_livestack(n_workers: int = 3, rounds: int = 6
                      ) -> WorkloadResult:
    shards = _shards(n_workers)
    hub = Hub("shuffle", calibrate_wire())
    for sh in shards:
        map_kernel(sh, n_workers)                   # warm-up
    sched = Scheduler(n_cpus=_host_cpus(), send_overhead_ns=2_000,
                      cpu_resource=True)
    eps = [hub.attach(Endpoint(f"w{i}")) for i in range(n_workers)]

    def worker(i):
        def body():
            for _ in range(rounds):
                parts = yield LiveCall(map_kernel, (shards[i], n_workers))
                for j in range(n_workers):
                    if j != i:
                        yield Send(eps[i], f"w{j}", parts[j].nbytes,
                                   payload=parts[j])
                mine = [parts[i]]
                for j in range(n_workers):
                    if j != i:
                        msg = yield Recv(eps[i])
                        mine.append(msg.payload)
                yield LiveCall(reduce_kernel, (mine,))
        return body

    ts = [sched.spawn(VTask(f"w{i}", worker(i)(), kind="live"))
          for i in range(n_workers)]
    scope = Scope("shuffle", 500 * US)
    for t in ts:
        t.join(scope)
    t0 = time.perf_counter()
    sched.run()
    wall = time.perf_counter() - t0
    sim_s = max(t.vtime for t in ts) / SEC
    return WorkloadResult("shuffle", "livestack", sim_s, wall,
                          {"runtime_s": sim_s})


# ------------------------------- registry ------------------------------------


WORKLOADS = {
    "arith": {"physical": arith_physical, "livestack": arith_livestack,
              "des": arith_des, "instances": 1,
              "paper_row": "CoreMark", "metric": "iters_per_s"},
    "oltp": {"physical": oltp_physical, "livestack": oltp_livestack,
             "des": oltp_des, "instances": 2,
             "paper_row": "TPC-C (MySQL)", "metric": "throughput_ops"},
    "kvstore": {"physical": kv_physical, "livestack": kv_livestack,
                "instances": 3,
                "paper_row": "YCSB (HBase)", "metric": "runtime_s"},
    "shuffle": {"physical": shuffle_physical,
                "livestack": shuffle_livestack, "instances": 3,
                "paper_row": "TPC-DS 99 (Spark)", "metric": "runtime_s"},
}


def accuracy(pred: float, actual: float) -> float:
    """Paper-style accuracy: 1 - |pred - actual| / actual."""
    return max(0.0, 1.0 - abs(pred - actual) / max(actual, 1e-12))
