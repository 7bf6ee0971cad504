"""The port's kernel modules against the JAX package, on the CPU.

On CPU tensors the port's ``minskew`` and ``hub_route`` wrappers
compute their plain PyTorch versions (the CUDA kernels are held against
those same plain versions on the card by ``chip_smoke.py``).  Here the
plain versions meet the JAX kernels (Pallas in interpret mode) and the
numpy oracles on the same inputs, made with numpy from a seed.  Every
result is integer, so every comparison is bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine_jax import hub_visibility_ref
from repro.kernels import ref as jref
from repro.kernels.hub_route import hub_route as jax_hub_route
from repro.kernels.minskew import minskew as jax_minskew
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.hub_route import hub_route
from repro_torch.kernels.minskew import minskew

INF = 2**30


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype)))


def _port_minskew(vtime, runnable, membership, skew):
    minima, elig = minskew(_t(vtime, np.int32), _t(runnable, np.int8),
                           _t(membership, np.int8), _t(skew, np.int32))
    assert minima.dtype == torch.int32 and elig.dtype == torch.int8
    return minima.numpy(), elig.numpy() != 0


def _check_minskew(vtime, runnable, membership, skew):
    """Port plain == JAX Pallas (interpret) == numpy oracle."""
    vtime = np.asarray(vtime, np.int32)
    runnable = np.asarray(runnable, bool)
    membership = np.asarray(membership, bool)
    skew = np.asarray(skew, np.int32)
    p_min, p_elig = _port_minskew(vtime, runnable, membership, skew)
    j_min, j_elig = jax_minskew(jnp.asarray(vtime),
                                jnp.asarray(runnable, jnp.int8),
                                jnp.asarray(membership, jnp.int8),
                                jnp.asarray(skew), interpret=True)
    r_min, r_elig = jref.minskew_ref(vtime, runnable, membership, skew)
    np.testing.assert_array_equal(p_min, np.asarray(j_min))
    np.testing.assert_array_equal(p_elig, np.asarray(j_elig) != 0)
    np.testing.assert_array_equal(p_min, r_min)
    np.testing.assert_array_equal(p_elig, r_elig)
    return p_min, p_elig


@pytest.mark.parametrize("n,s", [(64, 16), (200, 40), (512, 128),
                                 (1000, 3)])
def test_minskew_plain_vs_jax(n, s):
    rng = np.random.default_rng(n * 1000 + s)
    _check_minskew(rng.integers(0, 10_000, n), rng.random(n) < 0.7,
                   rng.random((n, s)) < 0.3, rng.integers(1, 500, s))


def test_minskew_all_masked():
    rng = np.random.default_rng(1)
    n, s = 40, 6
    minima, elig = _check_minskew(
        rng.integers(0, 10_000, n), np.zeros(n, bool),
        rng.random((n, s)) < 0.4, rng.integers(1, 500, s))
    assert (minima == INF).all() and not elig.any()


def test_minskew_empty_scope():
    rng = np.random.default_rng(2)
    n, s = 24, 4
    membership = rng.random((n, s)) < 0.5
    membership[:, 2] = False
    minima, elig = _check_minskew(rng.integers(0, 10_000, n),
                                  np.ones(n, bool), membership,
                                  np.zeros(s, np.int32))
    assert minima[2] == INF and elig.any()


def test_minskew_sentinel_vtimes():
    rng = np.random.default_rng(3)
    n, s = 16, 3
    vtime = rng.integers(0, 10_000, n)
    vtime[::2] = INF
    runnable = np.ones(n, bool)
    runnable[::2] = False
    minima, elig = _check_minskew(vtime, runnable, np.ones((n, s), bool),
                                  rng.integers(1, 100, s))
    assert (minima < INF).all() and not elig[::2].any()


def test_minskew_int32_boundary():
    rng = np.random.default_rng(4)
    n, s = 12, 2
    minima, elig = _check_minskew(INF - 1 - rng.integers(0, 2_000, n),
                                  np.ones(n, bool), np.ones((n, s), bool),
                                  np.full(s, 5_000, np.int32))
    assert (minima >= INF - 2_001).all() and elig.all()


def test_minskew_tiny_shapes():
    rng = np.random.default_rng(5)
    minima, elig = _check_minskew([7], [True], [[True]], [0])
    assert minima[0] == 7 and elig[0]
    _check_minskew(rng.integers(0, 100, 3), [True, False, True],
                   rng.random((3, 2)) < 0.5, [10, 20])


def test_minskew_variant_axis_matches_per_variant_loop():
    """V > 1 in one call == each variant alone == the numpy oracle."""
    rng = np.random.default_rng(6)
    v, n, s = 5, 96, 7
    vt = rng.integers(0, 5_000, (v, n)).astype(np.int32)
    run = (rng.random((v, n)) < 0.6).astype(np.int8)
    mem = (rng.random((v, n, s)) < 0.3).astype(np.int8)
    skew = rng.integers(0, 300, (v, s)).astype(np.int32)
    minima, elig = minskew(_t(vt, np.int32), _t(run, np.int8),
                           _t(mem, np.int8), _t(skew, np.int32))
    assert minima.shape == (v, s) and elig.shape == (v, n)
    for k in range(v):
        m1, e1 = _port_minskew(vt[k], run[k], mem[k], skew[k])
        np.testing.assert_array_equal(minima[k].numpy(), m1)
        np.testing.assert_array_equal(elig[k].numpy() != 0, e1)
        r_min, r_elig = jref.minskew_ref(vt[k], run[k] != 0, mem[k] != 0,
                                         skew[k])
        np.testing.assert_array_equal(m1, r_min)
        np.testing.assert_array_equal(e1, r_elig)


def test_minskew_empty_axes():
    minima, elig = minskew(torch.zeros(0, dtype=torch.int32),
                           torch.zeros(0, dtype=torch.int8),
                           torch.zeros((0, 3), dtype=torch.int8),
                           torch.ones(3, dtype=torch.int32))
    assert minima.tolist() == [INF] * 3 and elig.numel() == 0
    _, elig = minskew(torch.tensor([4], dtype=torch.int32),
                      torch.tensor([1], dtype=torch.int8),
                      torch.zeros((1, 0), dtype=torch.int8),
                      torch.zeros(0, dtype=torch.int32))
    assert elig.tolist() == [1]


# ---------------------------------------------------------------- hub_route


def _sorted_msgs(rng, m, n_links, hi=50_000):
    link = np.sort(rng.integers(0, n_links, m)).astype(np.int32)
    send = np.zeros(m, np.int32)
    for ln in range(n_links):
        idx = np.where(link == ln)[0]
        send[idx] = np.sort(rng.integers(0, hi, len(idx)))
    return send, link


@pytest.mark.parametrize("m,block", [(1, 64), (7, 64), (129, 64),
                                     (500, 128)])
def test_hub_route_ser_ns_vs_jax(m, block):
    rng = np.random.default_rng(m)
    n_links = 5
    send, link = _sorted_msgs(rng, m, n_links)
    ser = rng.integers(0, 10_000, m).astype(np.int32)
    ser[rng.random(m) < 0.2] = 163
    size = np.ones(m, np.int32)          # decoys: must be ignored
    bw = np.ones(n_links, np.float32)
    lat = rng.integers(0, 5_000, n_links).astype(np.int32)
    got = hub_route(_t(send, np.int32), _t(size, np.int32),
                    _t(link, np.int32), _t(bw, np.float32),
                    _t(lat, np.int32), ser_ns=_t(ser, np.int32))
    assert got.dtype == torch.int32
    want = jax_hub_route(jnp.asarray(send), jnp.asarray(size),
                         jnp.asarray(link), jnp.asarray(bw),
                         jnp.asarray(lat), ser_ns=jnp.asarray(ser),
                         block=block, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), hub_visibility_ref(send, size, link, bw, lat,
                                        ser_ns=ser))
    np.testing.assert_array_equal(
        got.numpy(), tref.hub_visibility_ref(send, size, link, bw, lat,
                                             ser_ns=ser))


@pytest.mark.parametrize("m,n_links", [(64, 4), (500, 7), (2048, 1),
                                       (33, 33)])
def test_hub_route_float32_path_vs_jax(m, n_links):
    """The f32 size*1e9/bw path is torch ops in the wrapper, exactly
    as in the JAX wrapper: equal results, not just close ones."""
    rng = np.random.default_rng(m + n_links)
    send, link = _sorted_msgs(rng, m, n_links, hi=100_000)
    size = rng.integers(64, 65_536, m).astype(np.int32)
    bw = rng.uniform(1e9, 100e9, n_links).astype(np.float32)
    lat = rng.integers(100, 10_000, n_links).astype(np.int32)
    got = hub_route(_t(send, np.int32), _t(size, np.int32),
                    _t(link, np.int32), _t(bw, np.float32),
                    _t(lat, np.int32))
    want = jax_hub_route(jnp.asarray(send), jnp.asarray(size),
                         jnp.asarray(link), jnp.asarray(bw),
                         jnp.asarray(lat), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hub_route_float32_mantissa_pin():
    """163 B at 1e9 B/s truncates to 162 on the float32 path in torch,
    as in JAX and numpy float32, and stays 163 with ser_ns."""
    z = torch.zeros(1, dtype=torch.int32)
    size = torch.tensor([163], dtype=torch.int32)
    bw = torch.tensor([1e9], dtype=torch.float32)
    assert int(hub_route(z, size, z, bw, z)[0]) == 162
    assert int(hub_route(z, size, z, bw, z, ser_ns=size)[0]) == 163
    assert int(np.float32(163) * np.float32(1e9) / np.float32(1e9)) == 162


def test_hub_route_empty():
    e = torch.zeros(0, dtype=torch.int32)
    out = hub_route(e, e, e, torch.ones(1), torch.zeros(1, dtype=torch.int32),
                    ser_ns=e)
    assert out.shape == (0,) and out.dtype == torch.int32


# ---------------------------------------------------------------- dispatch


def test_ops_take_plain_versions_for_cpu_tensors():
    """CPU tensors never reach a kernel: results equal the plain
    versions and no launch is counted."""
    rng = np.random.default_rng(9)
    before = (minskew.launches, hub_route.launches)
    vt = _t(rng.integers(0, 1_000, 50), np.int32)
    run = _t(rng.random(50) < 0.5, np.int8)
    mem = _t(rng.random((50, 4)) < 0.5, np.int8)
    skew = _t(rng.integers(0, 100, 4), np.int32)
    got = ops.minskew(vt, run, mem, skew)
    want = tref.minskew_plain(vt[None], run[None], mem[None], skew[None])
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1],
                                                           want[1][0])
    send, link = _sorted_msgs(rng, 40, 3)
    ser = _t(rng.integers(0, 100, 40), np.int32)
    lat = _t(rng.integers(0, 100, 3), np.int32)
    out = ops.hub_route(_t(send, np.int32), ser, _t(link, np.int32),
                        torch.ones(3), lat, ser_ns=ser)
    assert torch.equal(out, tref.hub_route_plain(
        _t(send, np.int32), ser, _t(link, np.int32), lat))
    assert (minskew.launches, hub_route.launches) == before


def test_wrappers_check_cuda_inputs_before_launch():
    """The kernel path validates its inputs (no CUDA needed: a meta
    tensor is not a CPU tensor, so it takes the kernel path and is
    refused for its device)."""
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        minskew(meta, meta.to(torch.int8),
                torch.empty((4, 2), dtype=torch.int8, device="meta"),
                torch.empty(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        hub_route(meta, meta, meta, torch.empty(1, device="meta"), meta,
                  ser_ns=meta)


@pytest.mark.parametrize("pallas,match", [("on", "CUDA"),
                                          ("interpret", "interpreter"),
                                          ("bogus", "auto/on/off")])
def test_pallas_knob_on_cpu(pallas, match):
    from repro_torch.sim import RackRing, Simulation, Topology
    sim = Simulation(Topology.single_host(),
                     RackRing(n_racks=1, hosts_per_rack=1, n_iters=2))
    with pytest.raises(ValueError, match=match):
        sim.run(engine="vectorized", device="cpu", pallas=pallas)
