"""The chained ``rglru_scan`` kernel's arithmetic, rebuilt on the CPU.

``csrc/rglru_scan.cu`` runs only on the card.  Its order of operations is
rebuilt here in plain PyTorch (in this file only) and held against the
port's plain version (``rglru_plain``, the sequential loop), the JAX
package's oracle ``repro.kernels.ref.rglru_ref`` and, at one small shape,
the Pallas kernel in interpret mode:

- local pass: each chunk of T_c steps runs h from 0, keeping its end value
  B_c and LA_c, the float32 sum of its log_a in order;
- carry: strictly in chunk order, P_c = fma(exp(LA_c), P_{c-1}, B_c) from
  P_{-1} = h0 (zeros without one);
- output pass: h = fma(exp(log_a), h, b) over the chunk from P_{c-1}.

The kernel's ``fmaf`` rounds a * h + b once; it is rebuilt as the float64
product (exact for float32 factors) plus b, rounded to float32.  Chunks of
``rglru_scan.CHUNK``, 1 and at least S.  Tolerance 1e-4 x max(1, largest
|value|), the bound the card holds the kernel to against its plain version
(``chip_smoke.py`` ``ATTN_TOL["float32"]``, ``tests/test_torch_cuda.py``).
Inputs follow chip_smoke's recipe (log_a = -0.3 u, b and h0 normal); the
strong-decay cases take log_a down to -8, where a chunk's exp(LA_c)
underflows to 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
from repro_torch.kernels import rglru_scan as kmod
from repro_torch.kernels.ref import rglru_plain

TOL = 1e-4


def _fma(a, h, b):
    return (a.double() * h.double() + b.double()).float()


def chained(log_a, b, h0, chunk):
    """The kernel's arithmetic: (B, S, W) float32 -> (B, S, W), and the
    exp(LA_c) of every chunk but the last."""
    bsz, s, w = log_a.shape
    p = torch.zeros(bsz, w) if h0 is None else h0.clone()
    out = torch.empty(bsz, s, w)
    decays = []
    for t0 in range(0, s, chunk):
        a = torch.exp(log_a[:, t0:t0 + chunk])
        bb = b[:, t0:t0 + chunk]
        rows = a.shape[1]
        hl = torch.zeros(bsz, w)
        la_sum = torch.zeros(bsz, w)
        for r in range(rows):                       # local pass
            la_sum = la_sum + log_a[:, t0 + r]
            hl = _fma(a[:, r], hl, bb[:, r])
        h = p
        for r in range(rows):                       # output pass
            h = _fma(a[:, r], h, bb[:, r])
            out[:, t0 + r] = h
        if t0 + chunk < s:                          # the carry
            decay = torch.exp(la_sum)
            decays.append(decay)
            p = _fma(decay, p, hl)
    return out, decays


def _inputs(b, s, w, with_h0, strong):
    rng = np.random.default_rng(b * 10_000 + s * 10 + w)
    log_a = (-rng.random((b, s, w)) * (8.0 if strong else 0.3)) \
        .astype(np.float32)
    bv = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    return log_a, bv, h0


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= TOL * scale, (err, scale)


#: (B, S, W, with h0, strong decay): S not a multiple of the chunk, S
#: below one chunk, S = 1, W not a multiple of 4, strong decay
CASES = [(2, 300, 37, True, False), (2, 300, 64, False, False),
         (1, 100, 16, True, False), (3, 1, 8, True, False),
         (2, 600, 24, True, True), (1, 513, 12, False, True)]


@pytest.mark.parametrize("chunk", ["kernel", 1, "whole"])
@pytest.mark.parametrize("b,s,w,with_h0,strong", CASES)
def test_chained_vs_plain_and_jax(b, s, w, with_h0, strong, chunk):
    chunk = {"kernel": kmod.CHUNK, "whole": s + 5}.get(chunk, chunk)
    log_a, bv, h0 = _inputs(b, s, w, with_h0, strong)
    t = [None if x is None else torch.from_numpy(x) for x in (log_a, bv, h0)]
    got, _ = chained(*t, chunk)
    _close(got, rglru_plain(*t))
    ref = kref.rglru_ref(jnp.asarray(log_a), jnp.asarray(bv),
                         None if h0 is None else jnp.asarray(h0))
    _close(got, ref)


def test_strong_decay_underflows_the_carry():
    """The strong-decay inputs reach the case the design must survive:
    exp(LA_c) is exactly 0, so the carry is the chunk's own B_c."""
    log_a, bv, h0 = _inputs(2, 600, 24, True, True)
    _, decays = chained(torch.from_numpy(log_a), torch.from_numpy(bv),
                        torch.from_numpy(h0), kmod.CHUNK)
    assert decays and all(bool((d == 0).all()) for d in decays)


@pytest.mark.parametrize("chunk", ["kernel", 64])
def test_chained_vs_pallas_interpret(chunk):
    chunk = kmod.CHUNK if chunk == "kernel" else chunk
    log_a, bv, h0 = _inputs(1, 300, 32, True, False)
    got, _ = chained(torch.from_numpy(log_a), torch.from_numpy(bv),
                     torch.from_numpy(h0), chunk)
    pallas = pallas_rglru(jnp.asarray(log_a), jnp.asarray(bv),
                          jnp.asarray(h0), block_t=128, interpret=True)
    _close(got, pallas)


def test_plan_at_the_serving_shape():
    """recurrentgemma's prefill (B=4, S=3,072, W=4,096): 12 hops of the
    carry chain and 12 x 4 x 128 blocks of one warp."""
    p = kmod.plan(4, 3072, 4096)
    assert (p["chunk"], p["tile_w"]) == (kmod.CHUNK, kmod.TILE_W) == (256, 32)
    assert p["n_chunks"] == 12 and p["grid"] == 12 * 4 * 128
    assert kmod.plan(2, 515, 4099) == {"chunk": 256, "tile_w": 32,
                                       "n_chunks": 3, "grid": 3 * 2 * 129}
