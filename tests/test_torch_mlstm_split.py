"""The bf16 ``mlstm_chunkwise`` kernel's arithmetic, rebuilt in plain torch.

``csrc/mlstm_kernel_sm90.cu`` runs the chunkwise mLSTM on the tensor
cores (bf16 operands, float32 sums) at the wrapper's chunk of 64.  It
rounds at four places, which this file repeats on the CPU:

- the gated, masked scores S are rounded to bf16 for ``S v`` (their
  row sums, the intra-chunk part of ``den``, stay float32);
- the carry C is rounded to bf16 for ``q C``; q stays bf16 as given,
  and the row factor ``scale exp(a_i)`` multiplies the float32 product;
- the update ``kw^T v`` with ``kw = k wc``, ``wc_j = exp(a_L - a_j +
  li_j)``: the gated factor is formed in float32 and split into a hi and
  a lo bf16 part, two products added to ``exp(a_L) C``.  The kernel puts
  the gate on v (``(v wc)_hi``, ``(v wc)_lo``, whose fragments it keeps
  in registers for the whole chunk, so the split is made once a chunk);
  splitting ``k wc`` instead is the same arithmetic up to the order of
  the product, and both are held here;
- n, ``den`` and ``h = out / max(|den|, 1)`` stay float32.

The emulation is held to the plain version (``mlstm_flat_plain``) on
bf16 inputs made as chip_smoke.py makes them, within the bounds the card
checks use: h within 2e-2, C and n within 1e-4, each times max(1, the
largest |plain value|).  A single bf16 rounding of the gated factor
misses the C bound: that is why the kernel splits it.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.mlstm_kernel import (BWD_CUDA_CORES, BWD_SM90,
                                              BWD_TF32X3, CHUNK,
                                              FWD_CUDA_CORES, FWD_SM90,
                                              FWD_TF32X3, SM90_BWD_MAX_HD,
                                              SM90_MAX_HD, TF32X3_MAX_HD,
                                              bwd_source, fwd_source,
                                              mlstm_flat_plain, pad_tail,
                                              uses_sm90)

TOL_H, TOL_CARRY = 2e-2, 1e-4


def _bf(x):
    return x.to(torch.bfloat16).float()


def emulate(q, k, v, i_raw, f_raw, c0=None, n0=None, split=True,
            gate_on="v"):
    """The kernel's rounding at chunk ``CHUNK`` over flat (BH, S, hd) heads:
    h in q's dtype and the final (C, n) float32.  ``gate_on`` names the
    factor of the update that takes wc before the split ("v", as the
    kernel does, or "k"); ``split=False`` rounds it to bf16 once."""
    s = q.shape[1]
    q, k, v, i_raw, f_raw = pad_tail(q, k, v, i_raw, f_raw)
    bh, sp, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    c = torch.zeros(bh, hd, hd) if c0 is None else c0.clone()
    n = torch.zeros(bh, hd) if n0 is None else n0.clone()
    mask = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))
    hs = []
    for c_at in range(0, sp, CHUNK):
        sl = slice(c_at, c_at + CHUNK)
        qi, ki, vi = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        li = torch.clamp(i_raw[:, sl], max=8.0)
        a = torch.cumsum(torch.nn.functional.logsigmoid(f_raw[:, sl]), 1)
        a_l = a[:, -1:]
        gate = torch.exp(a[:, :, None] - a[:, None, :] + li[:, None, :])
        sc = torch.where(mask, (qi @ ki.transpose(1, 2)) * scale * gate, 0.0)
        rowfac = (scale * torch.exp(a))[..., None]           # (BH, L, 1)
        out = _bf(sc) @ vi + rowfac * (qi @ _bf(c))
        den = sc.sum(-1) + rowfac[..., 0] * (qi @ n[..., None])[..., 0]
        hs.append(out / torch.clamp(den.abs(), min=1.0)[..., None])
        wc = torch.exp(a_l - a + li)[..., None]               # (BH, L, 1)
        kw = ki * wc
        gated, other = (vi * wc, ki) if gate_on == "v" else (kw, vi)
        hi = _bf(gated)
        parts = (hi, _bf(gated - hi)) if split else (hi,)
        if gate_on == "v":
            upd = sum(other.transpose(1, 2) @ x for x in parts)
        else:
            upd = sum(x.transpose(1, 2) @ other for x in parts)
        decay = torch.exp(a_l)[..., None]                    # (BH, 1, 1)
        c = decay * c + upd
        n = decay[..., 0] * n + kw.sum(1)
    return torch.cat(hs, 1)[:, :s].to(q.dtype), (c, n)


def _inputs(bh, s, hd, carry, seed):
    """chip_smoke.py's recipe, from numpy: q, k, v = 0.3 N(0, 1) in bf16,
    i_raw N(0, 1), f_raw N(2, 1), c0 and n0 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32))
    q, k, v = ((randn(bh, s, hd) * 0.3).to(torch.bfloat16)
               for _ in range(3))
    ig, fg = randn(bh, s), randn(bh, s) + 2.0
    c0 = randn(bh, hd, hd) * 0.1 if carry else None
    n0 = randn(bh, hd) * 0.1 if carry else None
    return q, k, v, ig, fg, c0, n0


def _rel(got, want):
    """max |got - want| over max(1, max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err / max(1.0, float(want.float().abs().max()))


#: xlstm_1_3b's head dim at a short S, a small shape, and one with a
#: carry in and S not a multiple of the chunk
CASES = [(2, 256, 1024, False), (2, 128, 32, False), (3, 130, 96, True)]


@pytest.mark.parametrize("gate_on", ["v", "k"])
@pytest.mark.parametrize("bh,s,hd,carry", CASES)
def test_split_emulation_meets_card_bounds(bh, s, hd, carry, gate_on):
    args = _inputs(bh, s, hd, carry, seed=bh * 1000 + hd)
    h, (c, n) = emulate(*args, gate_on=gate_on)
    hw, (cw, nw) = mlstm_flat_plain(*args)
    assert h.shape == hw.shape and h.dtype == torch.bfloat16
    assert _rel(h, hw) <= TOL_H
    assert _rel(c, cw) <= TOL_CARRY
    assert _rel(n, nw) <= TOL_CARRY


@pytest.mark.parametrize("gate_on", ["v", "k"])
def test_single_rounding_of_kw_misses_the_carry_bound(gate_on):
    args = _inputs(2, 256, 1024, False, seed=3024)
    _, (cw, _) = mlstm_flat_plain(*args)
    _, (c1, _) = emulate(*args, split=False, gate_on=gate_on)
    _, (c2, _) = emulate(*args, split=True, gate_on=gate_on)
    assert _rel(c1, cw) > TOL_CARRY
    assert _rel(c2, cw) <= TOL_CARRY


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 1024, True), (torch.bfloat16, SM90_MAX_HD, True),
    (torch.bfloat16, 8, True), (torch.bfloat16, SM90_MAX_HD + 64, False),
    (torch.bfloat16, 100, False), (torch.float32, 1024, False)])
def test_kernel_chosen_by_dtype_and_head_dim(dtype, hd, want):
    """bf16 with hd a multiple of 8 up to the limit runs the bf16
    tensor-core kernel; float32 another source (:func:`fwd_source`), and
    every other bf16 head dim the first design."""
    assert uses_sm90(dtype, hd) is want


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 1024, FWD_SM90), (torch.bfloat16, 8, FWD_SM90),
    (torch.bfloat16, SM90_MAX_HD + 8, FWD_CUDA_CORES),
    (torch.bfloat16, 100, FWD_CUDA_CORES), (torch.float32, 1024, FWD_TF32X3),
    (torch.float32, 8, FWD_TF32X3), (torch.float32, TF32X3_MAX_HD, FWD_TF32X3),
    (torch.float32, TF32X3_MAX_HD + 8, FWD_CUDA_CORES),
    (torch.float32, 100, FWD_CUDA_CORES)])
def test_forward_source_by_dtype_and_head_dim(dtype, hd, want):
    """bf16 at hd a multiple of 8 up to its limit runs the bf16
    tensor-core forward, float32 at hd a multiple of 8 up to its limit
    (xlstm's 1,024 among them) the split-TF32 one, every other head dim
    the first design; ``uses_sm90`` names the first of the three."""
    assert fwd_source(dtype, hd) == want
    assert uses_sm90(dtype, hd) is (want == FWD_SM90)
    assert TF32X3_MAX_HD >= 1024


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 1024, True), (torch.bfloat16, SM90_BWD_MAX_HD, True),
    (torch.bfloat16, 8, True), (torch.bfloat16, SM90_BWD_MAX_HD + 8, False),
    (torch.bfloat16, 100, False), (torch.bfloat16, SM90_MAX_HD, False),
    (torch.float32, 1024, False), (torch.float32, 64, False)])
def test_backward_kernel_chosen_by_dtype_and_head_dim(dtype, hd, want):
    """bf16 with hd a multiple of 8 up to its limit runs the bf16
    tensor-core backward (``want``); float32 at hd a multiple of 8 up to
    its limit, the split-TF32 one; every other bf16 head dim, the first
    design.  The bf16 backward's limit lies below the forward's."""
    source = bwd_source(dtype, hd)
    assert (source == BWD_SM90) is want
    if dtype == torch.float32:
        assert source == BWD_TF32X3
    elif not want:
        assert source == BWD_CUDA_CORES
    assert SM90_BWD_MAX_HD < SM90_MAX_HD and uses_sm90(dtype, hd) >= want
