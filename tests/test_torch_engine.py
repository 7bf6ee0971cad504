"""The port's round loop (``repro_torch.core.engine_torch``) against
``repro.core.engine_jax`` on the CPU.

Tapes come from the JAX package's compiler and cross to the port
through numpy (``tape_from_numpy``); both round loops then run to their
fixpoint and the final states must agree field by field, bit for bit,
with every port tensor int32 (bool where JAX uses bool).  The synthetic
compute-only engine is held to JAX the same way.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine_jax as ej
from repro.core.cluster import ClusterSpec, StepCost
from repro.sim import (ChipRingTraining, DegradeLink, FailHost, RackRing,
                       Scenario, Simulation, Straggler, Topology)
from repro.sim.vectorized import compile_simulation
from repro_torch.core import engine_torch as et

BOOL_FIELDS = {"done", "sent", "progressed", "runnable", "membership",
               "msg_two_stage"}


def rack_sim(sc=None):
    wl = RackRing(n_racks=2, hosts_per_rack=2, n_iters=12,
                  compute_ns=5_000, msg_bytes=4096, cross_every=4,
                  skew_bound_ns=100_000)
    return Simulation(Topology.racks(2, 2), wl, sc)


def chip_sim(sc=None):
    wl = ChipRingTraining(
        ClusterSpec(n_pods=2, chips_per_pod=4),
        StepCost(compute_ns=50_000, ici_bytes=8192, dcn_bytes=65536),
        n_steps=5, skew_bound_ns=1_000_000)
    return Simulation(
        Topology.full_mesh(2, link=Topology().default_host_link), wl, sc,
        placement={f"chip{i}": i // 4 for i in range(8)})


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_state_equal(port, ref):
    for name, want in _np_fields(ref).items():
        got = getattr(port, name)
        assert got.dtype == (torch.bool if name in BOOL_FIELDS
                             else torch.int32), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


CASES = {
    "rack": lambda: rack_sim(),
    "chip": lambda: chip_sim(),
    "rack_straggler": lambda: rack_sim(
        Scenario("s", (Straggler("w1", 2.5), Straggler("w1", 1.5)))),
    "rack_failhost": lambda: rack_sim(
        Scenario("f", (FailHost(1, at_vtime=160_000),))),
    "rack_degrade": lambda: rack_sim(
        Scenario("d", (DegradeLink(hosts=(0, 2), extra_ns=7_000,
                                   from_vtime=50_000),))),
    "chip_straggler_degrade": lambda: chip_sim(
        Scenario("sd", (Straggler("chip5", 2.0),
                        DegradeLink(fabric="dcn", extra_ns=3_000)))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_loop_final_state_matches_jax(case):
    comp = compile_simulation(CASES[case]())
    st_j = ej.run_vec_tape(comp.tape,
                           ej.init_vec_sim_state(comp.tape, comp.n_channels),
                           comp.max_rounds)
    tape = et.tape_from_numpy(_np_fields(comp.tape), "cpu")
    for name in et.TAPE_FIELDS:
        assert getattr(tape, name).dtype == (
            torch.bool if name in BOOL_FIELDS else torch.int32), name
    st0 = et.init_vec_sim_state(tape, comp.n_channels)
    _assert_state_equal(st0, ej.init_vec_sim_state(comp.tape,
                                                   comp.n_channels))
    st_t = et.run_vec_tape(tape, st0, comp.max_rounds)
    _assert_state_equal(st_t, st_j)
    if case == "rack_failhost":
        assert not st_t.done.all()


def test_rounds_past_the_fixpoint_change_nothing(monkeypatch):
    """The host loop overshoots by up to CHECK_EVERY - 1 guarded
    rounds; reading the condition every round, every 64 rounds or every
    CHECK_EVERY rounds gives the same state, ``rounds`` included."""
    comp = compile_simulation(rack_sim())
    tape = et.tape_from_numpy(_np_fields(comp.tape), "cpu")
    out = []
    for every in (1, 64, et.CHECK_EVERY):
        monkeypatch.setattr(et, "CHECK_EVERY", every)
        out.append(et.run_vec_tape(
            tape, et.init_vec_sim_state(tape, comp.n_channels),
            comp.max_rounds))
    for other in out[1:]:
        for name in et.STATE_FIELDS:
            assert torch.equal(getattr(out[0], name),
                               getattr(other, name)), name


@pytest.mark.parametrize("needed,run", [(0, 0), (1, 4), (4, 4), (20, 20),
                                        (21, 24), (100, 100), (410, 412)])
def test_drive_overshoot_is_bounded(needed, run):
    """Rounds run for a loop whose condition holds for ``needed``
    rounds: a read every CHECK_EVERY rounds, so the overshoot stays
    under CHECK_EVERY."""
    steps = [0]

    def step():
        steps[0] += 1

    et._drive(step, lambda: torch.tensor(steps[0] < needed))
    assert steps[0] == run
    assert steps[0] - needed < et.CHECK_EVERY


def test_state_from_numpy_resumes_a_jax_run():
    """A state carried across mid-run continues to the same fixpoint:
    JAX runs 7 rounds, the port finishes."""
    comp = compile_simulation(chip_sim())
    st0 = ej.init_vec_sim_state(comp.tape, comp.n_channels)
    mid = ej.run_vec_tape(comp.tape, st0, 7)
    assert int(mid.rounds) == 7
    end = ej.run_vec_tape(comp.tape, st0, comp.max_rounds)
    st = et.state_from_numpy(_np_fields(mid), "cpu")
    tape = et.tape_from_numpy(_np_fields(comp.tape), "cpu")
    _assert_state_equal(et.run_vec_tape(tape, st, comp.max_rounds), end)


def test_batched_tapes_equal_solo_runs():
    """The leading variant axis (the port's vmap) gives each variant
    its solo result, including a variant that deadlocks early."""
    comps = [compile_simulation(rack_sim(sc), tick_ns=1) for sc in (
        None, Scenario("f", (FailHost(1, at_vtime=160_000),)),
        Scenario("s", (Straggler("w3", 3.0),)))]
    fields = [_np_fields(c.tape) for c in comps]
    tapes = et.tape_from_numpy(
        {k: np.stack([f[k] for f in fields]) for k in fields[0]}, "cpu")
    states = et.init_vec_sim_state(tapes, comps[0].n_channels)
    cap = max(c.max_rounds for c in comps)
    out = et.run_vec_tape_batch(tapes, states, cap)
    for v, comp in enumerate(comps):
        solo = ej.run_vec_tape(
            comp.tape, ej.init_vec_sim_state(comp.tape, comp.n_channels),
            cap)
        _assert_state_equal(
            et.VecSimState(**{k: getattr(out, k)[v]
                              for k in et.STATE_FIELDS}), solo)


def test_hub_visibility_matches_jax():
    rng = np.random.default_rng(11)
    m, n_links = 300, 6
    link = np.sort(rng.integers(0, n_links, m)).astype(np.int32)
    send = np.zeros(m, np.int32)
    for ln in range(n_links):
        idx = np.where(link == ln)[0]
        send[idx] = np.sort(rng.integers(0, 60_000, len(idx)))
    size = rng.integers(64, 65_536, m).astype(np.int32)
    bw = rng.uniform(1e9, 50e9, n_links).astype(np.float32)
    lat = rng.integers(0, 5_000, n_links).astype(np.int32)
    ser = rng.integers(0, 5_000, m).astype(np.int32)
    for kw_j, kw_t in (({}, {}), ({"ser_ns": jnp.asarray(ser)},
                                  {"ser_ns": torch.from_numpy(ser)})):
        want = ej.hub_visibility(jnp.asarray(send), jnp.asarray(size),
                                 jnp.asarray(link), jnp.asarray(bw),
                                 jnp.asarray(lat), **kw_j)
        got = et.hub_visibility(torch.from_numpy(send),
                                torch.from_numpy(size),
                                torch.from_numpy(link), torch.from_numpy(bw),
                                torch.from_numpy(lat), **kw_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- synthetic


def _synthetic(mod, device_kw, n=256, s=4, seed=0):
    rng = np.random.default_rng(seed)
    membership = np.zeros((n, s), bool)
    idx = np.arange(n)
    membership[idx, idx % s] = True
    membership[idx[idx % 7 == 0], (idx[idx % 7 == 0] + 1) % s] = True
    return mod.VecState.create(
        n, s, durations=rng.integers(5, 50, n) * 10,
        steps=rng.integers(1, 12, n), membership=membership,
        skews=rng.integers(20, 400, s), **device_kw)


def test_run_vectorized_matches_jax():
    st_j, rounds_j = ej.run_vectorized(_synthetic(ej, {}))
    st_t, rounds_t = et.run_vectorized(_synthetic(et, {"device": "cpu"}))
    assert rounds_t == rounds_j
    for name in ("vtime", "runnable", "steps_left", "membership", "skew",
                 "duration"):
        got = getattr(st_t, name)
        assert got.dtype == (torch.bool if name in BOOL_FIELDS
                             else torch.int32), name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(st_j, name)))


def test_run_vectorized_sweep_matches_jax():
    rng = np.random.default_rng(3)
    axis = rng.integers(5, 80, (6, 256)) * 10
    vt_j, r_j = ej.run_vectorized_sweep(_synthetic(ej, {}), axis)
    vt_t, r_t = et.run_vectorized_sweep(_synthetic(et, {"device": "cpu"}),
                                        axis)
    assert vt_t.dtype == torch.int32 and r_t.dtype == torch.int32
    np.testing.assert_array_equal(vt_t.numpy(), np.asarray(vt_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))


def test_synthetic_scope_helpers_match_jax():
    rng = np.random.default_rng(4)
    n, s = 120, 5
    vt = rng.integers(0, 1_000, n).astype(np.int32)
    run = rng.random(n) < 0.6
    mem = rng.random((n, s)) < 0.3
    skew = rng.integers(0, 200, s).astype(np.int32)
    mj = ej.scope_minima(jnp.asarray(vt), jnp.asarray(run), jnp.asarray(mem))
    ejl = ej.eligibility(jnp.asarray(vt), jnp.asarray(run),
                         jnp.asarray(mem), jnp.asarray(skew))
    tv, tr, tm, ts = (torch.from_numpy(x) for x in (vt, run, mem, skew))
    np.testing.assert_array_equal(et.scope_minima(tv, tr, tm).numpy(),
                                  np.asarray(mj))
    np.testing.assert_array_equal(et.eligibility(tv, tr, tm, ts).numpy(),
                                  np.asarray(ejl))


def test_vecstate_create_tick_range():
    n = 4
    member = np.ones((n, 1), bool)
    skews = np.array([1000])
    ok = et.VecState.create(n, 1, np.full(n, 2**20), np.full(n, 2**9),
                            member, skews, device="cpu")
    assert ok.vtime.shape == (n,) and ok.vtime.dtype == torch.int32
    with pytest.raises(et.TickRangeError, match="task"):
        et.VecState.create(n, 1, np.full(n, 2**21), np.full(n, 2**9),
                           member, skews, device="cpu")
    with pytest.raises(ej.TickRangeError, match="task"):
        ej.VecState.create(n, 1, np.full(n, 2**21), np.full(n, 2**9),
                           member, skews)
    with pytest.raises(ValueError):
        et.VecState.create(2, 1, np.array([-1, 5]), np.array([3, 3]),
                           np.ones((2, 1), bool), np.array([10]),
                           device="cpu")


def test_vecstate_create_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _synthetic(et, {})
