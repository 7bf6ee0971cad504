"""The port's multi-process dist engine (``repro_torch.dist``) on the
CPU, against the port's in-process engines and the JAX package's dist.

Mirrors ``tests/test_dist.py``: partitioning, the merged report, API
guards, crashed and hung workers, the binary frames, payloads and an
in-flight message across partitions; then dist:1 and dist:K reports
equal to the port's async and to the JAX package's dist on the same
scenarios (``CORE_FIELDS`` and per-link stats), the three live replays
of ``tests/golden/`` on dist:2, ``diurnal_autoscale@v1`` async equal to
dist:4, and ``python -m repro_torch.dist``'s smoke line equal to the
JAX package's apart from its wall times.  Reports are integer: the
tolerance is bit-equality.
"""
import os
import re
import subprocess
import sys
import time

import pytest

import repro.sim as J
import repro_torch.sim as T
from engine_harness import CORE_FIELDS, assert_engines_agree
from repro_torch.core.ipc import LinkSpec
from repro_torch.core.vtask import Compute, Send
from repro_torch.dist import DistWorkerError, frames, partition_hosts
from repro_torch.sim.topology import FabricSpec
from repro_torch.sim.workload import EndpointSpec, Program

pytestmark = pytest.mark.skipif(not hasattr(os, "fork"),
                                reason="dist engine needs fork")

TIMEOUT = 60.0


def rack_sim(M, n_iters=30):
    wl = M.RackRing(n_racks=2, hosts_per_rack=2, n_iters=n_iters,
                    skew_bound_ns=2_000_000)
    return M.Simulation(M.Topology.racks(2, 2), wl,
                        M.Scenario("imb", wl.stragglers((1.0, 3.0))),
                        placement=wl.default_placement())


def chip_sim(M):
    from repro.core.cluster import ClusterSpec as JS, StepCost as JC
    from repro_torch.core.cluster import ClusterSpec as TS, StepCost as TC
    spec, cost = (JS, JC) if M is J else (TS, TC)
    wl = M.ChipRingTraining(
        spec(n_pods=3, chips_per_pod=4),
        cost(compute_ns=50_000, ici_bytes=8192, dcn_bytes=65536),
        n_steps=4, skew_bound_ns=1_000_000)
    return M.Simulation(
        M.Topology.full_mesh(3, link=M.Topology().default_host_link), wl,
        M.Scenario("slow chip", (M.Straggler("chip5", 2.0),)),
        placement={f"chip{i}": i // 4 for i in range(12)})


def dead_host_sim(M):
    wl = M.RackRing(n_racks=2, hosts_per_rack=2, n_iters=12,
                    compute_ns=5_000, cross_every=2)
    return M.Simulation(M.Topology.racks(2, 2), wl,
                        M.Scenario("host death",
                                   (M.FailHost(2, at_vtime=40_000),)),
                        placement=wl.default_placement())


def run(sim, engine):
    if engine.startswith("dist"):
        return sim.run(engine="dist", n_workers=int(engine[5:]),
                       worker_timeout=TIMEOUT)
    return sim.run(engine=engine)


# -- partitioning -------------------------------------------------------------


def test_partition_hosts_contiguous_and_balanced():
    assert partition_hosts(4, 2) == [[0, 1], [2, 3]]
    assert partition_hosts(5, 2) == [[0, 1, 2], [3, 4]]
    assert partition_hosts(3, 3) == [[0], [1], [2]]
    assert partition_hosts(1, 1) == [[0]]
    parts = partition_hosts(7, 3)
    assert sorted(h for p in parts for h in p) == list(range(7))


def test_n_workers_clamped_to_hosts():
    rep = rack_sim(T, n_iters=10).run(engine="dist", n_workers=16,
                                      worker_timeout=TIMEOUT)
    assert rep.n_workers == 4 and rep.status == "ok"


# -- merged report ------------------------------------------------------------


def test_dist_report_shape():
    rep = rack_sim(T).run(engine="dist", n_workers=2,
                          worker_timeout=TIMEOUT, on_deadlock="raise")
    assert rep.mode == "dist" and rep.n_workers == 2
    assert rep.sync_rounds > 0 and rep.cross_host_msgs > 0
    assert [h.host for h in rep.hosts] == [0, 1, 2, 3]
    assert all(t["state"] == "done" for t in rep.tasks.values())
    assert rep.progress["rack"]["iters_done"] == [30] * 4
    assert rep.links and all(st["min_slack_ns"] >= 0
                             for st in rep.links.values())
    assert rep.to_dict()["n_workers"] == 2


def test_dist_progress_written_back_to_workloads():
    wl = T.RackRing(n_racks=2, hosts_per_rack=2, n_iters=10,
                    skew_bound_ns=2_000_000)
    sim = T.Simulation(T.Topology.racks(2, 2), wl,
                       placement=wl.default_placement())
    sim.run(engine="dist", n_workers=2, worker_timeout=TIMEOUT,
            on_deadlock="raise")
    assert wl.iters_done.tolist() == [10] * 4


# -- API guards ---------------------------------------------------------------


def test_dist_api_guards():
    sim = rack_sim(T)
    sim.build()
    with pytest.raises(ValueError, match="unbuilt"):
        sim.run(engine="dist", n_workers=2)
    with pytest.raises(ValueError, match="n_workers"):
        rack_sim(T).run(engine="dist", n_workers=0)
    with pytest.raises(ValueError, match="unknown engine"):
        rack_sim(T).run(engine="warp")


def test_deadlock_reported_and_raised_as_async_does():
    from repro_torch.core.scheduler import DeadlockError
    rep = run(dead_host_sim(T), "dist:2")
    assert rep.status == "deadlock" == run(dead_host_sim(T), "async").status
    with pytest.raises(DeadlockError):
        dead_host_sim(T).run(engine="dist", n_workers=2,
                             worker_timeout=TIMEOUT, on_deadlock="raise")


# -- fault containment --------------------------------------------------------


class _ExplodingWorkload(T.Workload):
    name = "boom"

    def programs(self):
        def make_body(eps):
            raise RuntimeError("kaboom at build")
        return [Program(name="boom0", make_body=make_body)]


def test_crashed_worker_fails_fast_with_traceback():
    sim = T.Simulation(T.Topology.single_host(), _ExplodingWorkload())
    with pytest.raises(DistWorkerError, match="kaboom at build") as err:
        sim.run(engine="dist", n_workers=1, worker_timeout=30.0)
    assert "kaboom at build" in err.value.worker_traceback


class _SleepyWorkload(T.Workload):
    name = "sleepy"

    def programs(self):
        time.sleep(5.0)
        return []


def test_hung_worker_times_out_instead_of_wedging():
    sim = T.Simulation(T.Topology.single_host(), _SleepyWorkload())
    t0 = time.monotonic()
    with pytest.raises(DistWorkerError, match="hung"):
        sim.run(engine="dist", n_workers=1, worker_timeout=0.5)
    assert time.monotonic() - t0 < 4.0


# -- binary wire format -------------------------------------------------------


def test_envelope_frame_roundtrip_equals_jax():
    from repro.dist import frames as jframes
    cases = [
        dict(src_hub=3, dst_hub=65535, src_ep=7, dst_ep=123456,
             size_bytes=5038080, send_vtime=2**45, seq=991,
             sent_at=12345, hops=2, payload=None),
        dict(src_hub=0, dst_hub=1, src_ep=0, dst_ep=0, size_bytes=0,
             send_vtime=0, seq=0, sent_at=0, hops=0,
             payload={"client": 3, "xs": [1, 2, 3]}),
    ]
    buf = b"".join(frames.pack_envelope(**c) for c in cases)
    assert buf == b"".join(jframes.pack_envelope(**c) for c in cases)
    off = 0
    for c in cases:
        dst_hub, send_vt, end = frames.scan_envelope(buf, off)
        assert dst_hub == c["dst_hub"] and send_vt == c["send_vtime"]
        fields, payload, end2 = frames.unpack_envelope(buf, off)
        assert end2 == end
        assert fields == (c["src_hub"], c["dst_hub"], c["src_ep"],
                          c["dst_ep"], c["size_bytes"], c["send_vtime"],
                          c["seq"], c["sent_at"], c["hops"])
        assert payload == c["payload"]
        off = end
    assert off == len(buf)


def test_step_and_reply_frame_roundtrip():
    env = [frames.pack_envelope(src_hub=1, dst_hub=2, src_ep=3,
                                dst_ep=4, size_bytes=10,
                                send_vtime=1000, seq=5, sent_at=900,
                                hops=1, payload=None)]
    step = frames.pack_step({0: 5000, 1: None}, {7: (123, 1)}, env)
    bounds, updates, buf, off, n_env = frames.unpack_step(step)
    assert (bounds, updates, n_env) == ({0: 5000, 1: None},
                                        {7: (123, 1)}, 1)
    fields, payload, _ = frames.unpack_envelope(buf, off)
    assert fields[1] == 2 and payload is None
    reply = frames.pack_reply(
        unfinished=True, applied=False, lazy_changed=True,
        dispatches=42, wakes=3, next_times={2: None, 3: 777},
        task_states={9: (55, 2)}, envelopes=env)
    r = frames.Reply(reply)
    assert (r.unfinished, r.applied, r.lazy_changed) == (True, False, True)
    assert (r.dispatches, r.wakes) == (42, 3)
    assert r.next_times == {2: None, 3: 777}
    assert r.task_states == {9: (55, 2)}
    assert r.envelopes == [(2, 1000, env[0])]


def test_dist_payloads_cross_partitions():
    def make():
        wl = T.ModeledServe(n_clients=3, n_requests=5)
        return T.Simulation(
            T.Topology.full_mesh(2, LinkSpec(bandwidth_bps=25e9 * 8,
                                             latency_ns=10_000)), wl,
            placement={"serve.server": 0, "serve.client0": 1,
                       "serve.client1": 0, "serve.client2": 1})
    inproc = make().run(engine="async", on_deadlock="raise")
    dist = make().run(engine="dist", n_workers=2, worker_timeout=TIMEOUT,
                      on_deadlock="raise")
    assert dist.tasks == inproc.tasks
    assert dist.progress == inproc.progress


class _FireAndForget(T.Workload):
    """The sender's last action is a send the receiver never takes."""

    name = "faf"

    def fabrics(self):
        return [FabricSpec("hub", LinkSpec(bandwidth_bps=80e9 * 8,
                                           latency_ns=500))]

    def programs(self):
        def sender(eps):
            ep = eps["faf.w0"]

            def body():
                yield Compute(10_000)
                yield Send(ep, "faf.w1", 4096)
            return body()

        def receiver(eps):
            def body():
                yield Compute(100)
            return body()

        return [Program(name="faf.w0", make_body=sender,
                        endpoints=(EndpointSpec("faf.w0", "hub"),)),
                Program(name="faf.w1", make_body=receiver,
                        endpoints=(EndpointSpec("faf.w1", "hub"),))]


def test_in_flight_message_delivered_after_all_tasks_finish():
    def make():
        return T.Simulation(T.Topology.racks(1, 2), _FireAndForget(),
                            placement={"faf.w0": 0, "faf.w1": 1})
    reports = assert_engines_agree(make, label="fire-and-forget",
                                   worker_timeout=TIMEOUT)
    assert "dist:2" in reports
    assert all(r.messages == 1 for r in reports.values())


def test_sole_worker_heartbeats_keep_long_runs_alive(monkeypatch):
    from repro_torch.dist.worker import DistWorker
    monkeypatch.setattr(DistWorker, "RUN_ALL_CHUNK", 1)
    ref = rack_sim(T).run(engine="async", on_deadlock="raise")
    rep = rack_sim(T).run(engine="dist", n_workers=1,
                          worker_timeout=10.0, on_deadlock="raise")
    assert rep.status == "ok" and rep.tasks == ref.tasks
    assert rep.sync_rounds == ref.sync_rounds


# -- against async and the JAX package's dist ---------------------------------


@pytest.mark.parametrize("make", [rack_sim, chip_sim, dead_host_sim],
                         ids=["rack", "chip_ring", "dead_host"])
@pytest.mark.parametrize("engine", ["dist:1", "dist:2", "dist:3"])
def test_dist_equals_async_and_jax_dist(make, engine):
    got = run(make(T), engine)
    same = [run(make(T), "async"), run(make(J), engine)]
    for want in same:
        for f in CORE_FIELDS:
            assert getattr(got, f) == getattr(want, f), (engine, f)
        assert got.links == want.links
    assert got.n_workers == same[1].n_workers
    assert got.sync_rounds == same[1].sync_rounds


@pytest.mark.parametrize("ref", ["live_recovery@v1", "live_serve@v1",
                                 "live_colocated@v1"])
def test_live_replays_on_dist_2(ref):
    got = T.registry.load(ref).run(engine="dist", n_workers=2,
                                   worker_timeout=TIMEOUT)
    want = T.registry.load(ref).run(engine="async")
    jax = J.registry.load(ref).run(engine="dist", n_workers=2,
                                   worker_timeout=TIMEOUT)
    for f in CORE_FIELDS:
        assert getattr(got, f) == getattr(want, f) == getattr(jax, f), f


def test_diurnal_autoscale_async_equals_dist_4():
    got = T.registry.load("diurnal_autoscale@v1").run(
        engine="dist", n_workers=4, worker_timeout=TIMEOUT)
    want = T.registry.load("diurnal_autoscale@v1").run(engine="async")
    assert got.n_workers == 4
    for f in CORE_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.control == want.control
    assert got.links == want.links


def test_module_smoke_line_equals_jax():
    def line(pkg):
        out = subprocess.run(
            [sys.executable, "-m", f"{pkg}.dist"], capture_output=True,
            text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)})
        assert out.returncode == 0, out.stderr
        return re.sub(r"wall=\d+ ms", "wall=_ ms", out.stdout.strip())
    got = line("repro_torch")
    assert got.startswith("dist smoke ok: 4 hosts / 2 workers")
    assert got == line("repro")
