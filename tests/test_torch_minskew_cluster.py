"""The cluster ``minskew`` kernel's arithmetic, rebuilt on the CPU.

``csrc/minskew.cu`` runs only on the card.  Its order of operations is
rebuilt here in plain PyTorch (in this file only) and held, bit for bit,
against the port's plain version (``minskew_plain``), the JAX package's
Pallas kernel in interpret mode and its numpy oracle (``minskew_ref``):

- each variant's rows are split into R slabs of ceil(N / R) rows, one a
  block of the cluster (R > N leaves blocks with no rows);
- scopes go in chunks of ``chunk_s`` (``minskew.CHUNK_S`` on the card; 2
  and 3 here as well, so that small S takes several chunks);
- pass 1: each slab's partial minima over its runnable members, INF where
  it has none;
- combine: the partials folded rank by rank, in rank order;
  thr = minima + skew (int32, wrapping as the kernel's unsigned sum
  does), or INT_MAX where the minimum is INF;
- pass 2: each slab's rows, ok = no member scope with vtime > thr, and
  elig = runnable AND ok for the first chunk, elig AND ok after it.

Inputs come from a numpy seed; the edge cases are those of
``tests/test_torch_kernels.py`` (all masked, an empty scope, sentinel
vtimes, the int32 boundary, 1 x 1, 3 x 2) and the variant axis.  Every
result is integer, so every comparison is bit-equal.  ``plan`` is held
at chip_smoke's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.minskew import minskew as jax_minskew
from repro_torch.kernels import minskew as kmod
from repro_torch.kernels.ref import minskew_plain

INF = 2**30
INT_MAX = 2**31 - 1


def cluster_minskew(vt, run, mem, skew, cluster, chunk_s=kmod.CHUNK_S):
    """The kernel's arithmetic: (V, N), (V, N), (V, N, S), (V, S) ->
    minima (V, S) int32, elig (V, N) int8."""
    v, n, s = mem.shape
    slab = -(-n // cluster)
    minima = torch.empty((v, s), dtype=torch.int32)
    elig = torch.empty((v, n), dtype=torch.int8)
    for b in range(v):
        live = run[b] != 0
        for c0 in range(0, s, chunk_s):
            sc = min(chunk_s, s - c0)
            m = mem[b, :, c0:c0 + sc] != 0
            parts = []
            for rank in range(cluster):                    # pass 1
                r0, r1 = min(n, rank * slab), min(n, rank * slab + slab)
                held = m[r0:r1] & live[r0:r1, None]
                vals = torch.where(held, vt[b, r0:r1, None], INF)
                parts.append(vals.amin(dim=0) if r1 > r0
                             else torch.full((sc,), INF, dtype=torch.int32))
            mins = parts[0]
            for p in parts[1:]:                            # rank by rank
                mins = torch.minimum(mins, p)
            mins = mins.to(torch.int32)
            minima[b, c0:c0 + sc] = mins
            wrapped = (mins.long() + skew[b, c0:c0 + sc].long()
                       + 2**31) % 2**32 - 2**31
            thr = torch.where(mins == INF, INT_MAX, wrapped)
            for rank in range(cluster):                    # pass 2
                r0, r1 = min(n, rank * slab), min(n, rank * slab + slab)
                bad = m[r0:r1] & (vt[b, r0:r1, None].long() > thr[None, :])
                ok = ~bad.any(dim=1)
                prev = live[r0:r1] if c0 == 0 else elig[b, r0:r1] != 0
                elig[b, r0:r1] = (prev & ok).to(torch.int8)
    return minima, elig


def _case(name, seed):
    """(vt, run, mem, skew) numpy arrays with a leading variant axis."""
    rng = np.random.default_rng(seed)
    if name == "random":
        n, s = 200, 40
        c = (rng.integers(0, 10_000, n), rng.random(n) < 0.7,
             rng.random((n, s)) < 0.3, rng.integers(1, 500, s))
    elif name == "sched":        # chip_smoke's pattern: i % S, every 7th +1
        n, s = 300, 16
        idx = np.arange(n)
        mem = np.zeros((n, s), bool)
        mem[idx, idx % s] = True
        mem[idx[::7], (idx[::7] + 1) % s] = True
        vt = rng.integers(0, 1_000_000, n)
        vt[rng.random(n) < 0.1] = INF
        c = (vt, rng.random(n) < 0.7, mem, rng.integers(0, 50_000, s))
    elif name == "all_masked":
        n, s = 40, 6
        c = (rng.integers(0, 10_000, n), np.zeros(n, bool),
             rng.random((n, s)) < 0.4, rng.integers(1, 500, s))
    elif name == "empty_scope":
        n, s = 24, 4
        mem = rng.random((n, s)) < 0.5
        mem[:, 2] = False
        c = (rng.integers(0, 10_000, n), np.ones(n, bool), mem,
             np.zeros(s))
    elif name == "sentinel":
        n, s = 16, 3
        vt = rng.integers(0, 10_000, n)
        vt[::2] = INF
        run = np.ones(n, bool)
        run[::2] = False
        c = (vt, run, np.ones((n, s), bool), rng.integers(1, 100, s))
    elif name == "int32_boundary":
        n, s = 12, 2
        c = (INF - 1 - rng.integers(0, 2_000, n), np.ones(n, bool),
             np.ones((n, s), bool), np.full(s, 5_000))
    elif name == "tiny_1x1":
        c = ([7], [True], [[True]], [0])
    elif name == "tiny_3x2":
        c = (rng.integers(0, 100, 3), [True, False, True],
             rng.random((3, 2)) < 0.5, [10, 20])
    elif name == "variants":
        v, n, s = 5, 96, 7
        return (rng.integers(0, 5_000, (v, n)).astype(np.int32),
                (rng.random((v, n)) < 0.6).astype(np.int8),
                (rng.random((v, n, s)) < 0.3).astype(np.int8),
                rng.integers(0, 300, (v, s)).astype(np.int32))
    vt, run, mem, skew = c
    return (np.asarray(vt, np.int32)[None], np.asarray(run, np.int8)[None],
            np.asarray(mem, np.int8)[None], np.asarray(skew, np.int32)[None])


CASES = ["random", "sched", "all_masked", "empty_scope", "sentinel",
         "int32_boundary", "tiny_1x1", "tiny_3x2", "variants"]
_REFS = {}


def _references(name):
    """(inputs as tensors, the plain version's result), held once per
    case against the Pallas kernel (interpret) and the numpy oracle,
    variant by variant."""
    if name not in _REFS:
        arrs = _case(name, seed=CASES.index(name))
        t = [torch.from_numpy(np.ascontiguousarray(x)) for x in arrs]
        plain = minskew_plain(*t)
        vt, run, mem, skew = arrs
        for b in range(vt.shape[0]):
            j_min, j_elig = jax_minskew(
                jnp.asarray(vt[b]), jnp.asarray(run[b]),
                jnp.asarray(mem[b]), jnp.asarray(skew[b]), interpret=True)
            r_min, r_elig = jref.minskew_ref(vt[b], run[b] != 0,
                                             mem[b] != 0, skew[b])
            for want in (np.asarray(j_min), r_min):
                np.testing.assert_array_equal(plain[0][b].numpy(), want)
            for want in (np.asarray(j_elig) != 0, r_elig):
                np.testing.assert_array_equal(plain[1][b].numpy() != 0,
                                              want)
        _REFS[name] = (t, plain)
    return _REFS[name]


@pytest.mark.parametrize("chunk_s", [kmod.CHUNK_S, 2, 3])
@pytest.mark.parametrize("cluster", [1, 3, 16])
@pytest.mark.parametrize("name", CASES)
def test_cluster_vs_plain_pallas_and_oracle(name, cluster, chunk_s):
    t, (p_min, p_elig) = _references(name)
    minima, elig = cluster_minskew(*t, cluster, chunk_s)
    assert torch.equal(minima, p_min) and torch.equal(elig, p_elig)


def test_plan_at_chip_smoke_shapes():
    """One cluster of 16 per variant at the main path's (1, 16,384, 1),
    every slab kept in shared memory; at (1, 16,384, 256) 16-byte loads
    and 768 of a slab's 1,024 rows kept; several variants take clusters
    of at most 8; the sweep's small variants one block each."""
    p = kmod.plan(1, 16_384, 1)
    assert (p.cluster, p.slab_rows, p.kept_rows, p.vec) == \
        (16, 1_024, 1_024, False)
    p = kmod.plan(1, 16_384, 256)
    assert (p.cluster, p.kept_rows, p.vec) == (16, 768, True)
    assert 768 * 256 <= kmod.SLAB_MAX < 1_024 * 256
    p = kmod.plan(8, 4_096, 64)
    assert (p.cluster, p.slab_rows, p.kept_rows) == (8, 512, 512)
    assert kmod.plan(64, 16, 3).cluster == 1
    assert kmod.plan(1, 16_384, 256, aligned=False).vec is False
    assert kmod.plan(1, 100, 4_100).chunks == 3
    assert kmod.plan(1, 100, 7, cluster=3).slab_rows == 34
