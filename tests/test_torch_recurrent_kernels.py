"""The port's recurrent kernels against the JAX package on the CPU.

On CPU tensors ``repro_torch.kernels.rglru_scan.rglru_scan``,
``mlstm_kernel.mlstm_chunkwise`` and ``ops.rglru``/``ops.mlstm`` compute
their plain versions (the CUDA kernels are held against those same plain
versions on the card by ``chip_smoke.py``).  The same numpy inputs go
through the JAX Pallas kernels in interpret mode, the JAX oracles
(``repro.kernels.ref.rglru_ref``, ``mlstm_seq_ref``) and the JAX model's
``mlstm_chunkwise``, at the shapes of ``tests/test_kernels.py``'s rglru
and mlstm sections.  Tolerances are those of ``tests/test_kernels.py``:
2e-4 in float32 (the recurrences reassociate: the JAX scans run a
log-depth doubling or an associative scan where the port loops over S,
and the chunk sizes differ), 5e-2 for bfloat16 inputs (q, k, v and h
rounded to bfloat16).  Where both sides run the same chunkwise
arithmetic (the port's plain version against the JAX model's
``mlstm_chunkwise``) the bound is 1e-5: the same operations, with the
sums inside each einsum taken by two libraries' matmul kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.mlstm_kernel import mlstm_chunkwise as pallas_mlstm
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mlstm_kernel import (CHUNK, PAD_GATE,
                                              mlstm_chunkwise, pad_tail)
from repro_torch.kernels.rglru_scan import rglru_scan

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
SAME = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(x: np.ndarray, dtype: str = "float32"):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


# ---------------------------------------------------------------- rglru

RGLRU_CASES = [(2, 128, 64, 64, False), (2, 128, 64, 64, True),
               (1, 300, 32, 128, True),          # padded seq
               (3, 64, 128, 64, False), (2, 16, 8, 16, True)]


def _rglru_inputs(b, s, w, with_h0):
    rng = np.random.default_rng(b * 1000 + s + w)
    log_a = -np.abs(rng.standard_normal((b, s, w)).astype(np.float32)) * 0.3
    bv = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    return log_a, bv, h0


@pytest.mark.parametrize("b,s,w,bt,with_h0", RGLRU_CASES)
def test_rglru_plain_vs_jax(b, s, w, bt, with_h0):
    log_a, bv, h0 = _rglru_inputs(b, s, w, with_h0)
    (la_j, la_t), (b_j, b_t) = _pair(log_a), _pair(bv)
    h0_j, h0_t = _pair(h0) if with_h0 else (None, None)
    before = rglru_scan.launches
    got = rglru_scan(la_t, b_t, h0_t)
    assert rglru_scan.launches == before                 # plain version
    assert got.dtype == torch.float32 and got.shape == (b, s, w)
    pallas = pallas_rglru(la_j, b_j, h0_j, block_t=bt, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL)
    np.testing.assert_allclose(_np(got), _np(kref.rglru_ref(la_j, b_j, h0_j)),
                               **TOL)
    # the JAX model's scan folds h0 into b[:, 0]; the same function
    model = jrglru.rglru_scan(la_j, b_j, h0_j)
    np.testing.assert_allclose(_np(ops.rglru(la_t, b_t, h0_t)), _np(model),
                               **TOL)


def test_rglru_plain_is_the_loop():
    """``rglru_plain`` steps h = exp(log_a) h + b from h0, exactly."""
    log_a, bv, h0 = _rglru_inputs(2, 9, 5, True)
    got = tref.rglru_plain(torch.from_numpy(log_a), torch.from_numpy(bv),
                           torch.from_numpy(h0)).numpy()
    h = torch.from_numpy(h0)
    for t in range(9):
        h = torch.exp(torch.from_numpy(log_a[:, t])) * h \
            + torch.from_numpy(bv[:, t])
        np.testing.assert_array_equal(got[:, t], h.numpy())


# ---------------------------------------------------------------- mlstm

MLSTM_CASES = [(2, 128, 32, 64), (4, 256, 64, 128), (1, 64, 128, 64),
               (2, 128, 32, 128)]                  # single chunk


def _mlstm_inputs(bh, s, hd, seed=0, carry=False):
    rng = np.random.default_rng(seed + bh * 1000 + s + hd)
    q, k, v = (rng.standard_normal((bh, s, hd)).astype(np.float32) * 0.3
               for _ in range(3))
    ig = rng.standard_normal((bh, s)).astype(np.float32)
    fg = rng.standard_normal((bh, s)).astype(np.float32) + 2.0
    c0 = (rng.standard_normal((bh, hd, hd)).astype(np.float32) * 0.1
          if carry else np.zeros((bh, hd, hd), np.float32))
    n0 = (rng.standard_normal((bh, hd)).astype(np.float32) * 0.1
          if carry else np.zeros((bh, hd), np.float32))
    return q, k, v, ig, fg, c0, n0


def _heads(*xs):
    """(BH, S, ...) -> (B=BH, S, H=1, ...), the model layout."""
    return [x[:, :, None] for x in xs]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bh,s,hd,chunk", MLSTM_CASES)
def test_mlstm_plain_vs_jax(bh, s, hd, chunk, dtype):
    q, k, v, ig, fg, c0, n0 = _mlstm_inputs(bh, s, hd)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, k, v))
    (igj, igt), (fgj, fgt) = _pair(ig), _pair(fg)
    got, _ = tref.mlstm_chunkwise_plain(*_heads(qt, kt, vt, igt, fgt),
                                        chunk=chunk)
    assert got.dtype == qt.dtype and got.shape == (bh, s, 1, hd)
    pallas = pallas_mlstm(qj, kj, vj, igj, fgj, chunk=chunk, interpret=True)
    ref, _ = kref.mlstm_seq_ref(*_heads(qj, kj, vj, igj, fgj),
                                jnp.asarray(c0[:, None]),
                                jnp.asarray(n0[:, None]))
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(_np(got[:, :, 0]), _np(pallas), **tol)
    np.testing.assert_allclose(_np(got[:, :, 0]), _np(ref[:, :, 0]), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_seq_plain_vs_jax(dtype):
    q, k, v, ig, fg, c0, n0 = _mlstm_inputs(2, 40, 16, carry=True)
    j = [_pair(x, dtype) for x in (q, k, v)] + [_pair(ig), _pair(fg)]
    got, (gc, gn) = tref.mlstm_seq_plain(
        *_heads(*(t for _, t in j)), torch.from_numpy(c0[:, None]),
        torch.from_numpy(n0[:, None]))
    want, (wc, wn) = kref.mlstm_seq_ref(
        *_heads(*(a for a, _ in j)), jnp.asarray(c0[:, None]),
        jnp.asarray(n0[:, None]))
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(gc), _np(wc), **TOL)
    np.testing.assert_allclose(_np(gn), _np(wn), **TOL)


@pytest.mark.parametrize("b,s,h,hd,chunk,carry", [
    (2, 256, 2, 16, 128, False),
    (2, 256, 2, 16, 128, True),
    (1, 1024, 2, 8, 512, True),                    # the model's chunk
    (2, 200, 2, 16, 512, True),                    # single-chunk fallback
])
def test_mlstm_plain_is_the_model_chunkwise(b, s, h, hd, chunk, carry):
    """``mlstm_chunkwise_plain`` is the JAX model's ``mlstm_chunkwise``
    operation for operation, its final (C, n) included.  The gates sit
    around the model's biases (input -2, forget 3): both forms compute
    exp(-A_j) inside a chunk, which overflows float32 once the chunk's
    summed log forget gate passes -88 (at 512 steps of the test
    kernels' N(2, 1) forget gate it does, in both packages)."""
    rng = np.random.default_rng(s + hd)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32) * 0.3
               for _ in range(3))
    ig = rng.standard_normal((b, s, h)).astype(np.float32) - 2.0
    fg = rng.standard_normal((b, s, h)).astype(np.float32) + 3.0
    c0 = rng.standard_normal((b, h, hd, hd)).astype(np.float32) * 0.1 * carry
    n0 = rng.standard_normal((b, h, hd)).astype(np.float32) * 0.1 * carry
    want, (wc, wn) = jxlstm.mlstm_chunkwise(
        *(jnp.asarray(x) for x in (q, k, v, ig, fg, c0, n0)), chunk=chunk)
    t = [torch.from_numpy(x) for x in (q, k, v, ig, fg, c0, n0)]
    got, (gc, gn) = tref.mlstm_chunkwise_plain(*t, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **SAME)
    np.testing.assert_allclose(_np(gc), _np(wc), **SAME)
    np.testing.assert_allclose(_np(gn), _np(wn), **SAME)
    # ops.mlstm takes the plain version on the CPU (the JAX ops.mlstm
    # has no such branch), at the model's chunk by default
    oh, (oc, on) = ops.mlstm(*t, chunk=chunk)
    assert torch.equal(oh, got) and torch.equal(oc, gc) and torch.equal(on, gn)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bh,s,hd,carry", [(2, 200, 32, False),
                                           (3, 64, 16, True),
                                           (1, 130, 24, True),
                                           (2, 5, 8, False)])
def test_mlstm_wrapper_pads_the_tail(bh, s, hd, carry, dtype):
    """The kernel's wrapper, through its plain path: S padded to its
    chunk with steps that carry the state unchanged, h trimmed, and
    (h, C, n) equal to the step-recurrent oracle of the JAX package."""
    q, k, v, ig, fg, c0, n0 = _mlstm_inputs(bh, s, hd, seed=7, carry=carry)
    jdt, tdt = DTYPES[dtype]
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tig, tfg = torch.from_numpy(ig), torch.from_numpy(fg)
    before = mlstm_chunkwise.launches
    h, (c, n) = mlstm_chunkwise(
        tq, tk, tv, tig, tfg,
        torch.from_numpy(c0) if carry else None,
        torch.from_numpy(n0) if carry else None)
    assert mlstm_chunkwise.launches == before          # plain version
    assert h.shape == (bh, s, hd) and h.dtype == tdt
    assert c.shape == (bh, hd, hd) and n.shape == (bh, hd)
    want, (wc, wn) = kref.mlstm_seq_ref(
        *_heads(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                jnp.asarray(ig), jnp.asarray(fg)),
        jnp.asarray(c0[:, None]), jnp.asarray(n0[:, None]))
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(_np(h), _np(want[:, :, 0]), **tol)
    np.testing.assert_allclose(_np(c), _np(wc[:, 0]), **TOL)
    np.testing.assert_allclose(_np(n), _np(wn[:, 0]), **TOL)


def test_pad_tail_steps_leave_the_state_unchanged():
    q, k, v, ig, fg, _, _ = _mlstm_inputs(2, 70, 8)
    t = [torch.from_numpy(x) for x in (q, k, v, ig, fg)]
    qp, kp, vp, ip, fp = pad_tail(*t)
    assert qp.shape[1] == ip.shape[1] == 2 * CHUNK
    for a, b in zip((qp, kp, vp, ip, fp), t):
        assert torch.equal(a[:, :70], b)
    assert not qp[:, 70:].any() and not vp[:, 70:].any()
    assert bool((ip[:, 70:] == -PAD_GATE).all())
    assert bool((fp[:, 70:] == PAD_GATE).all())
    # the padded gates: input gate 0, forget gate 1, both finite
    li = torch.clamp(ip[:, 70:], max=8.0)
    assert bool(torch.isfinite(li).all()) and not torch.exp(li).any()
    assert bool((torch.nn.functional.logsigmoid(fp[:, 70:]) == 0).all())
    # a multiple of the chunk is passed through untouched
    t128 = [x[:, :0] for x in t]
    assert all(a is b for a, b in zip(pad_tail(*t128), t128))


def test_recurrent_wrappers_check_inputs():
    """Both paths validate first; a tensor that is not on the CPU takes
    the kernel path: on the meta device (no card needed) the meta route,
    which allocates the kernel's outputs and tallies one call of its
    source, with no plain version and no launch."""
    from repro_torch.kernels import mlstm_kernel, rglru_scan as rmod, work
    meta = dict(device="meta")
    la = torch.empty((2, 4, 8), **meta)
    launched = (rmod.rglru_scan.launches,
                mlstm_kernel.mlstm_chunkwise.launches)
    with work.KernelTally() as tally:
        assert rglru_scan(la, la).shape == la.shape
    assert tally.launches() == {rmod.SOURCE: 1}
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(torch.zeros(2, 4, 8, dtype=torch.float64),
                   torch.zeros(2, 4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="disagree"):
        rglru_scan(torch.zeros(2, 4, 8), torch.zeros(2, 4, 8),
                   torch.zeros(3, 8))
    q = torch.empty((2, 64, 16), **meta)
    g = torch.empty((2, 64), **meta)
    with work.KernelTally() as tally:
        h, (c, n) = mlstm_chunkwise(q, q, q, g, g)
    assert (h.shape, c.shape, n.shape) == (q.shape, (2, 16, 16), (2, 16))
    assert tally.launches() == {
        mlstm_kernel.fwd_source(torch.float32, 16): 1}
    assert (rmod.rglru_scan.launches,
            mlstm_kernel.mlstm_chunkwise.launches) == launched
    z = torch.zeros(2, 64, 16)
    with pytest.raises(TypeError, match="i_raw"):
        mlstm_chunkwise(z, z, z, torch.zeros(2, 64, dtype=torch.float64),
                        torch.zeros(2, 64))
    with pytest.raises(ValueError, match="c0 has shape"):
        mlstm_chunkwise(z, z, z, torch.zeros(2, 64), torch.zeros(2, 64),
                        torch.zeros(2, 16, 8))
    with pytest.raises(ValueError, match="not contiguous"):
        mlstm_chunkwise(z.transpose(1, 2).contiguous().transpose(1, 2), z, z,
                        torch.zeros(2, 64), torch.zeros(2, 64))
