"""The gradient of the port's attention on the CPU.

``ref.attention_flat_bwd_plain`` (the explicit formulas that the
backward kernel ``csrc/flash_attention_bwd.cu`` computes) against torch
autograd of ``ref.attention_flat_plain`` and against ``jax.grad`` of the
JAX package's attention (``repro.models.attention.multi_head_attention``,
which the JAX models differentiate), at the edge shapes of chip_smoke's
``flash_attention_bwd`` phase: GQA, a padded tail, windows (one narrower
than a key tile), fewer queries than keys under the causal mask, head
dims that are not multiples of 16, and Sk = 0.  Then
``flash_attention.FlashAttention`` end to end on CPU tensors: the
(B, S, H, hd) entry point under grad goes through it and its backward
calls ``flash_attention_bwd``, whose CPU path is the plain version.

Inputs from numpy with a seed, float32.  Tolerance: 1e-5 x max(1,
largest |gradient|): the same float32 functions with sums in another
order (the plain backward uses the forward's output in D = dO . o,
autograd and JAX differentiate through the softmax).

The bfloat16 tensor-core backward (``csrc/flash_attention_bwd_sm90.cu``)
runs only on the card; here the backward's route table (``bwd_source``:
dtype and head dim alone; float32 takes
``csrc/flash_attention_bwd_tf32x3.cu``, whose arithmetic
``tests/test_torch_flash_bwd_tf32x3.py`` rebuilds), the rule that splits
a group's query heads above hd 128 (``bwd_head_parts``) and its
arithmetic: :func:`_sm90_emulation`
rebuilds the kernel's roundings in plain torch (bf16 inputs, float32
sums, lse by the online max and sum over 64-key tiles in base 2, P and dS
rounded to bf16 before the three accumulating products; above hd 128,
lse from the even and the odd key tiles combined, and dk and dv summed
per part of the heads and then over the parts in float32 before the bf16
rounding) and is held to the plain version and to ``jax.grad`` within
the card's bf16 tolerance, 2e-2 x max(1, largest |gradient|)
(``chip_smoke.py``'s ``ATTN_TOL``).
"""
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import multi_head_attention as jattention
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import (BWD_SM90, BWD_SM90_ROWS,
                                                 BWD_TF32X3,
                                                 SM90_BWD_WIDE_HD,
                                                 SM90_BWD_WIDE_KEYS,
                                                 FlashAttention,
                                                 bwd_head_parts,
                                                 bwd_source,
                                                 flash_attention_bwd)
from repro_torch.kernels.ref import (attention_flat_bwd_plain,
                                     attention_flat_plain)

TOL = 1e-5
#: (B, H, Hkv, Sq, Sk, hd, causal, window)
SHAPES = [(2, 4, 2, 37, 37, 16, True, 0),          # GQA, odd length
          (1, 8, 2, 96, 96, 32, True, 0),          # padded tail
          (1, 2, 1, 80, 80, 64, True, 64),         # window
          (1, 4, 2, 70, 70, 40, True, 5),          # window < a key tile
          (1, 4, 2, 50, 120, 24, True, 0),         # Sq < Sk, causal
          (1, 2, 2, 30, 60, 8, False, 0),          # cross attention
          (2, 6, 3, 33, 33, 128, True, 0)]         # hd 128
EMPTY = [(1, 4, 2, 20, 0, 16, True, 0), (2, 2, 1, 0, 12, 8, True, 0)]


def _inputs(b, h, hkv, sq, sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, hd), f(b, sk, hkv, hd), f(b, sk, hkv, hd), \
        f(b, sq, h, hd)


def _flat(t: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = t.shape
    return t.transpose(1, 2).reshape(b * h, s, hd)


def _bshd(t: torch.Tensor, b: int) -> torch.Tensor:
    bh, s, hd = t.shape
    return t.reshape(b, bh // b, s, hd).transpose(1, 2)


def _plain_grads(q, k, v, do, causal, window):
    """attention_flat_bwd_plain on (B, S, H, hd) numpy inputs."""
    b = q.shape[0]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = attention_flat_plain(_flat(tq), _flat(tk), _flat(tv), causal=causal,
                             window=window)
    grads = attention_flat_bwd_plain(_flat(tq), _flat(tk), _flat(tv), o,
                                     _flat(tdo), causal=causal,
                                     window=window)
    return [_bshd(g, b).numpy() for g in grads]


def _close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert float(np.abs(got - want).max(initial=0.0)) <= TOL * scale


@pytest.mark.parametrize("shape", SHAPES + EMPTY)
def test_plain_backward_equals_autograd(shape):
    b, h, hkv, sq, sk, hd, causal, window = shape
    q, k, v, do = _inputs(b, h, hkv, sq, sk, hd)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = _bshd(attention_flat_plain(_flat(tq), _flat(tk), _flat(tv),
                                   causal=causal, window=window), b)
    want = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(_plain_grads(q, k, v, do, causal, window), want):
        _close(g, w.numpy())


@pytest.mark.parametrize("shape", SHAPES + EMPTY[:1])
def test_plain_backward_equals_jax_grad(shape):
    b, h, hkv, sq, sk, hd, causal, window = shape
    q, k, v, do = _inputs(b, h, hkv, sq, sk, hd, seed=1)

    def loss(q, k, v):
        o = jattention(q, k, v, causal=causal, window=window)
        return jnp.sum(o * do)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w in zip(_plain_grads(q, k, v, do, causal, window), want):
        _close(g, np.asarray(w))


def test_sk_zero_gives_zero_gradients():
    q, k, v, do = _inputs(1, 4, 2, 20, 0, 16)
    dq, dk, dv = _plain_grads(q, k, v, do, True, 0)
    assert dq.shape == q.shape and not np.any(dq) and not np.isnan(dq).any()
    assert dk.shape == k.shape == dv.shape


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[4],
                                   EMPTY[0]])
def test_function_on_cpu_tensors_end_to_end(shape):
    """``ops.flash_attention`` under grad: a ``FlashAttention`` node whose
    backward is ``flash_attention_bwd`` (the plain version on the CPU),
    equal to autograd of the plain forward; without grad, no node."""
    b, h, hkv, sq, sk, hd, causal, window = shape
    q, k, v, do = _inputs(b, h, hkv, sq, sk, hd, seed=2)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    calls = []
    real = flash_attention_bwd

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    import repro_torch.kernels.flash_attention as fa
    fa.flash_attention_bwd = spy
    try:
        got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    finally:
        fa.flash_attention_bwd = real
    assert calls == [tq.shape]
    want = _plain_grads(q, k, v, do, causal, window)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    with torch.no_grad():
        assert ops.flash_attention(tq, tk, tv, causal=causal,
                                   window=window).grad_fn is None
    with torch.inference_mode():
        assert ops.flash_attention(tq.detach(), tk.detach(), tv.detach(),
                                   causal=causal,
                                   window=window).grad_fn is None


def test_function_in_a_loss_matches_jax():
    """A scalar loss through ``FlashAttention.apply`` on non-contiguous
    (B, S, H, hd) views (sliced from one fused projection), against
    ``jax.grad`` of the JAX attention on the same values."""
    b, s, h, hkv, hd = 2, 40, 4, 2, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, h + 2 * hkv, hd)).astype(np.float32)
    w = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    q, k, v = tx[:, :, :h], tx[:, :, h:h + hkv], tx[:, :, h + hkv:]
    assert not q.is_contiguous()
    loss = (FlashAttention.apply(q, k, v, True, 0)
            * torch.from_numpy(w)).sum()
    (got,) = torch.autograd.grad(loss, (tx,))

    def jloss(x):
        o = jattention(x[:, :, :h], x[:, :, h:h + hkv], x[:, :, h + hkv:],
                       causal=True)
        return jnp.sum(o * w)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    _close(got.numpy(), want)
    assert math.isfinite(float(loss))


# -- the bf16 tensor-core backward: route and arithmetic ---------------------

BF16_TOL = 2e-2


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 8, BWD_SM90), (torch.bfloat16, 24, BWD_SM90),
    (torch.bfloat16, 40, BWD_SM90), (torch.bfloat16, 64, BWD_SM90),
    (torch.bfloat16, 96, BWD_SM90), (torch.bfloat16, 128, BWD_SM90),
    (torch.bfloat16, 136, BWD_SM90), (torch.bfloat16, 192, BWD_SM90),
    (torch.bfloat16, 256, BWD_SM90), (torch.bfloat16, 12, None),
    (torch.float32, 64, BWD_TF32X3), (torch.float32, 128, BWD_TF32X3),
    (torch.float32, 256, BWD_TF32X3)])
def test_sm90_backward_route_table(dtype, hd, want):
    """bf16 at hd a multiple of 8 up to 256 takes the ``wgmma`` kernel;
    float32 (the parity runs) the split-TF32 one, ``mma.sync`` on the
    tensor cores; a head dim the forward refuses, none."""
    assert bwd_source(dtype, hd) == want


def test_sm90_backward_is_built_and_sized():
    """The source is in the build list; the unit of the lse and D scratch
    is the wrapper's and a multiple of every head-dim variant's block of
    query rows (two 64-row tiles up to hd 128; one above, its two
    consumers splitting the columns); the wrapper's split rule counts
    the wide variant's blocks of keys; the head split's reduction kernel
    is in the same source."""
    assert "flash_attention_bwd_sm90" in _build.SOURCES
    src = (_build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    defs = dict(line.split()[1:3] for line in src.splitlines()
                if line.startswith("#define ") and len(line.split()) >= 3)
    nc, bt, rows = int(defs["NC"]), int(defs["BT"]), int(defs["ROWS"])
    assert rows == BWD_SM90_ROWS == nc * bt
    assert int(defs["WIDE_HD"]) == SM90_BWD_WIDE_HD
    for hdp in (64, 128, 256):
        block_rows = nc * bt // (2 if hdp > SM90_BWD_WIDE_HD else 1)
        assert rows % block_rows == 0, hdp
    assert nc * bt // 2 == SM90_BWD_WIDE_KEYS
    assert "wgmma" in src and "tma_load4" in src
    assert "flash_bwd_sm90_reduce" in src
    assert not any(op in src for op in ("atomicAdd", "atom.", "red."))


@pytest.mark.parametrize("shape,n_sm,want", [
    ((4, 16, 1, 1024, 256), 132, 4),   # recurrentgemma's train step
    ((1, 16, 1, 3072, 256), 132, 6),   # its window shape
    ((2, 12, 2, 1024, 256), 132, 4),   # 6 heads a group in 4 parts
    ((1, 16, 1, 200, 256), 132, 16),   # few keys: one head a block
    ((4, 16, 1, 1024, 136), 132, 4),   # any hd above 128
    ((64, 16, 16, 4096, 256), 132, 1),  # the grid fills the card
    ((4, 32, 8, 1024, 128), 132, 1),   # up to hd 128: no split
    ((1, 16, 1, 0, 256), 132, 1)])     # Sk = 0
def test_sm90_backward_head_parts(shape, n_sm, want):
    """The head split's rule: about two blocks an SM, clamped to the
    group's heads, 1 up to hd 128 and at Sk = 0; parts of an uneven
    group differ by one head."""
    b, h, hkv, sk, hd = shape
    parts = bwd_head_parts(b, h, hkv, sk, hd, n_sm)
    assert parts == want
    qpk = h // hkv
    sizes = [(i + 1) * qpk // parts - i * qpk // parts
             for i in range(parts)]
    assert sum(sizes) == qpk and max(sizes) - min(sizes) <= 1
    assert min(sizes) >= 1


def _online_max_sum(x, mask, tiles):
    """The kernel's pass 1 over the key tiles ``tiles`` (of 64) of the
    scaled scores x: each row's running max and sum in base 2."""
    bh, sq, _ = x.shape
    m = torch.full((bh, sq), -1e30)
    l = torch.zeros((bh, sq))
    for k0 in tiles:
        xt, mt = x[:, :, k0:k0 + 64], mask[None, :, k0:k0 + 64]
        mn = torch.maximum(m, xt.max(dim=-1).values)
        pt = torch.where(mt, torch.exp2(xt - mn[..., None]), 0.0)
        l = l * torch.exp2(m - mn) + pt.sum(dim=-1)
        m = mn
    return m, l


def _sm90_emulation(q, k, v, o, do, causal, window, parts=1,
                    lse_split=False):
    """``flash_attention_bwd_sm90.cu``'s arithmetic on flat (BH, S, hd)
    bf16 tensors, in float32: S and dP from the bf16 inputs; lse (base 2,
    of S scale log2 e) by the online max and sum over 64-key tiles in
    order, NO_LSE where a row sees no key (``lse_split``, the kernel above
    hd 128: over the even tiles and over the odd ones, combined as m =
    max(m0, m1), l = l0 2^(m0 - m) + l1 2^(m1 - m)); P = 2^(S scale
    log2 e - lse); D from bf16 o and dO; P and dS rounded to bf16 before dV, dQ
    and dK; dK and dV summed over the heads of each of ``parts`` parts
    of a group (part i: heads i qpk / parts ..), then over the parts in
    order, dK scaled after the sum; outputs rounded to bf16."""
    bh, sq, hd = q.shape
    bhkv, sk, _ = k.shape
    qpk = bh // bhkv
    scale = 1.0 / math.sqrt(hd)
    sl2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(qpk, dim=0)
    vf = v.float().repeat_interleave(qpk, dim=0)
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.einsum("bqd,bkd->bqk", qf, kf)
    x = torch.where(mask[None], s * sl2, torch.tensor(-1e30))
    if lse_split:
        m0, l0 = _online_max_sum(x, mask, range(0, sk, 128))
        m1, l1 = _online_max_sum(x, mask, range(64, sk, 128))
        m = torch.maximum(m0, m1)
        l = l0 * torch.exp2(m0 - m) + l1 * torch.exp2(m1 - m)
    else:
        m, l = _online_max_sum(x, mask, range(0, sk, 64))
    lse = torch.where(l > 0, m + torch.log2(l), torch.tensor(1e30))
    p = torch.where(mask[None], torch.exp2(s * sl2 - lse[..., None]), 0.0)
    dsum = (dof * of).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = (p * (dp - dsum)).bfloat16().float()
    pb = p.bfloat16().float()
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk_h = torch.einsum("bqk,bqd->bkd", ds, qf).view(bhkv, qpk, sk, hd)
    dv_h = torch.einsum("bqk,bqd->bkd", pb, dof).view(bhkv, qpk, sk, hd)
    dk = torch.zeros((bhkv, sk, hd))
    dv = torch.zeros((bhkv, sk, hd))
    for i in range(parts):
        lo, hi = i * qpk // parts, (i + 1) * qpk // parts
        dk = dk + dk_h[:, lo:hi].sum(dim=1)
        dv = dv + dv_h[:, lo:hi].sum(dim=1)
    return dq.bfloat16(), (dk * scale).bfloat16(), dv.bfloat16()


#: (B, H, Hkv, Sq, Sk, hd, causal, window): a small-S version of the
#: trainer's shape (8/2 heads, hd 128), MQA at hd 64 with Sq not a
#: multiple of a tile, GQA ratio 8, head dims 24, 40, 96 and 8, windows
#: 5 and 40, fewer queries than keys under the causal mask, cross
#: attention; above hd 128 (columns split, heads split over
#: ``bwd_head_parts`` blocks): recurrentgemma's MQA at hd 256 with a
#: window narrower than a tile, GQA at hd 192, and hd 136 with Sq < Sk
#: under the causal mask
EMULATED = [(1, 8, 2, 256, 256, 128, True, 0),
            (1, 4, 1, 200, 200, 64, True, 0),
            (1, 8, 1, 130, 130, 96, True, 40),
            (2, 4, 4, 96, 96, 24, True, 5),
            (1, 8, 2, 50, 130, 40, True, 0),
            (1, 2, 2, 64, 100, 8, False, 0),
            (1, 16, 1, 200, 200, 256, True, 40),
            (1, 12, 2, 150, 150, 192, True, 0),
            (1, 4, 2, 70, 160, 136, True, 0)]
#: the H100's streaming multiprocessors, for the head split's rule
H100_SMS = 132


def _emulate(args, shape):
    """:func:`_sm90_emulation` as the card runs ``shape``: above hd 128
    the head split for an H100 and pass 1 split by key tiles."""
    b, h, hkv, sq, sk, hd, causal, window = shape
    return _sm90_emulation(*args, causal, window,
                           parts=bwd_head_parts(b, h, hkv, sk, hd,
                                                H100_SMS),
                           lse_split=hd > SM90_BWD_WIDE_HD)


def _bf16_inputs(b, h, hkv, sq, sk, hd, seed):
    """Numpy inputs rounded to bf16, and the forward's bf16 output."""
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(b, h, hkv, sq, sk, hd, seed))
    o = _bshd(attention_flat_plain(_flat(q), _flat(k), _flat(v),
                                   causal=True, window=0), b)
    return q, k, v, o, do


def _close_bf16(got, want):
    got, want = got.float().numpy(), want.float().numpy()
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert float(np.abs(got - want).max(initial=0.0)) <= BF16_TOL * scale


@pytest.mark.parametrize("shape", EMULATED)
def test_sm90_roundings_within_tolerance_of_plain(shape):
    """The kernel's bf16 P and dS against ``attention_flat_bwd_plain`` on
    the same bf16 inputs (the comparison chip_smoke makes on the card)."""
    b, h, hkv, sq, sk, hd, causal, window = shape
    q, k, v, _, do = _bf16_inputs(b, h, hkv, sq, sk, hd, seed=7)
    o = _bshd(attention_flat_plain(_flat(q), _flat(k), _flat(v),
                                   causal=causal, window=window), b)
    args = [_flat(t) for t in (q, k, v, o, do)]
    got = _emulate(args, shape)
    want = attention_flat_bwd_plain(*args, causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_bf16(g, w)


@pytest.mark.parametrize("shape", EMULATED)
def test_sm90_roundings_within_tolerance_of_jax(shape):
    """The same emulation against ``jax.grad`` of the JAX package's
    attention in float32 on the bf16 inputs' values."""
    b, h, hkv, sq, sk, hd, causal, window = shape
    q, k, v, _, do = _bf16_inputs(b, h, hkv, sq, sk, hd, seed=8)
    o = _bshd(attention_flat_plain(_flat(q), _flat(k), _flat(v),
                                   causal=causal, window=window), b)
    got = _emulate([_flat(t) for t in (q, k, v, o, do)], shape)
    qn, kn, vn, don = (t.float().numpy() for t in (q, k, v, do))

    def loss(q, k, v):
        out = jattention(q, k, v, causal=causal, window=window)
        return jnp.sum(out * don)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (qn, kn, vn)))
    for g, w in zip(got, want):
        _close_bf16(_bshd(g, b), torch.from_numpy(np.asarray(w)))


def test_sm90_emulation_sk_zero_and_empty_rows():
    """Sk = 0 gives dq = 0; under a window wider than the rows, a query
    row past every key of a causal Sq > Sk call still sees keys, and the
    NO_LSE trap keeps a masked row's P at 0 (no NaN)."""
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(1, 4, 2, 20, 0, 16))
    o = torch.zeros_like(q)
    dq, dk, dv = _sm90_emulation(*(_flat(t) for t in (q, k, v, o, do)),
                                 True, 0)
    assert not dq.float().abs().max() and dk.numel() == dv.numel() == 0
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(1, 2, 1, 40, 40, 16, seed=4))
    o = _bshd(attention_flat_plain(_flat(q), _flat(k), _flat(v),
                                   causal=True, window=3), 1)
    args = [_flat(t) for t in (q, k, v, o, do)]
    got = _sm90_emulation(*args, True, 3)
    want = attention_flat_bwd_plain(*args, causal=True, window=3)
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        _close_bf16(g, w)


def test_chip_smoke_holds_each_backward_gradient():
    """chip_smoke's attention-backward check holds dq, dk and dv each to
    its own plain gradient.  At MQA, dk and dv sum over the group's 16
    query heads and dwarf dq, so a dq whose last 64 rows are halved
    passes a max abs error scaled by the largest of the three; it must
    fail here, and the exact gradients must pass."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    b, h, hkv, s, hd = 1, 16, 1, 512, 256
    q, k, v, o, do = _bf16_inputs(b, h, hkv, s, s, hd, seed=11)
    want = chip_smoke._bwd_plain(q, k, v, o, do, True, 0)
    err, scale, each = chip_smoke._hold_bwd(torch, want, want, "bfloat16",
                                            "exact")
    assert err == 0 and all(e["rel_norm_err"] == 0 for e in each.values())
    got = [w.clone() for w in want]
    got[0][:, s - 64:] *= 0.5
    err, scale = chip_smoke._bwd_err(got, want)
    chip_smoke._hold("flash_attention_bwd", err, "bfloat16", "late", scale)
    with pytest.raises(AssertionError, match="flash_attention_bwd dq"):
        chip_smoke._hold_bwd(torch, got, want, "bfloat16", "late")
