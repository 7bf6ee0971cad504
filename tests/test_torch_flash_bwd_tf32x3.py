"""The float32 attention gradient kernel's arithmetic, rebuilt in plain
torch.

``csrc/flash_attention_bwd_tf32x3.cu`` computes the gradient of the
attention in float32 on the tensor cores.  Each of its five products (S =
Q K^T and dP = dO V^T in both kernels, dQ += dS K, dV += P^T dO and
dK += dS^T Q) is three TF32 ``mma.sync`` per k-step of 8 contracted
elements, into the same float32 accumulator, in this order: lo(A) hi(B),
hi(A) lo(B), hi(A) hi(B), with hi = tf32(x) and lo = tf32(x - hi), where
tf32 is ``cvt.rna.tf32.f32``: round to nearest, ties away from zero, at 10
mantissa bits.  The k-steps go in the kernel's order: over the head dim
for S and dP; over the keys of each key tile, tiles in order, for dQ;
over the queries of each query tile, tiles in order, head after head of a
part of the group, for dK and dV; the parts' float32 sums are added in
order and dK is scaled after.  The dq kernel walks the key tiles (T =
64 keys, 32 above hd 128) once, with the forward's online softmax in base
2 of the scores times scale log2 e: each row's running max m and sum l,
P~ = 2^(x - m) and dS~ = P~ (dP - D) against the running max, the dQ
accumulator rescaled by 2^(m_old - m_new) as each tile's products join
it, and at the end dq = dQ (scale / l) and lse = m + log2 l, which the
dk/dv kernel's P = 2^(x - lse) uses.  D, P and dS stay float32.  The
products of one tile (of keys for dQ, of queries for dK and dV) are summed
from zero and join the accumulator by one rounded fmaf: the tensor cores'
own float32 accumulation does not round to nearest, and its error grows
with the products that feed one accumulator (on the card, 5.0e-5 of dk's
norm at chip_smoke's rglru_window case when every product of the row fed
one).
:func:`emulate` repeats that on the CPU, with the rounding done on the
bits (:func:`tf32`).

The emulation is held to the plain version
(``ref.attention_flat_bwd_plain``) and, at three shapes, to ``jax.grad`` of
the JAX package's attention, within the bounds the card checks use
(chip_smoke's ``ATTN_TOL`` and ``ATTN_BWD_REL_NORM`` for float32): each
gradient's max abs error within 1e-4 x max(1, its largest |plain value|),
and ``||got - want|| / ||want||`` within 1e-4.  One case records what a
single TF32 pass (hi hi alone) gives at the same shape, and holds only
that its error is larger than the split's: the split is what keeps the
float32 parity runs where they were.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import multi_head_attention as jattention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (BWD_TF32X3,
                                                 SM90_BWD_WIDE_KEYS,
                                                 bwd_head_parts, bwd_source)
from repro_torch.kernels.ref import (attention_flat_bwd_plain,
                                     attention_flat_plain)

TOL_ABS, TOL_REL_NORM = 1e-4, 1e-4
H100_SMS = 132
NO_LSE = 1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the bits of float32 ``x``: add half of the
    13 dropped bits' weight to the magnitude and clear them (ties go away
    from zero; the sign bit is apart from the magnitude)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma_acc(acc, a, b, three=True):
    """acc + a @ b over the contracted axis in k-steps of 8, in order, each
    the kernel's three products (``three=False``: hi hi alone), each k-step
    rounded to float32."""
    for k0 in range(0, a.shape[-1], 8):
        ah, al = split(a[..., k0:k0 + 8])
        bh, bl = split(b[..., k0:k0 + 8, :])
        if three:
            acc = acc + al @ bh
            acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


def fresh(acc, mul, a, b, three=True):
    """acc mul + a @ b as the kernel's product_nn adds a tile: the tile's
    products summed from zero (:func:`mma_acc`), then joined to acc by one
    rounded fmaf."""
    part = mma_acc(torch.zeros(acc.shape), a, b, three)
    return (acc.double() * mul.double() + part.double()).float()


def _mask(sq, sk, causal, window):
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def emulate(q, k, v, o, do, causal, window, parts=1, three=True):
    """The kernel's arithmetic on flat (BH, S, hd) float32 tensors, query
    head row b reading kv row b // (BH / BHkv); ``parts``: the blocks a
    group's query heads are split over for dK and dV."""
    bh, sq, hd = q.shape
    bhkv, sk, _ = k.shape
    qpk = bh // bhkv
    scale = 1.0 / math.sqrt(hd)
    sl2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    kf = k.repeat_interleave(qpk, dim=0)
    vf = v.repeat_interleave(qpk, dim=0)
    mask = _mask(sq, sk, causal, window)[None]
    zeros = torch.zeros((bh, sq, sk))
    s = mma_acc(zeros, q, kf.transpose(1, 2), three)
    dp = mma_acc(zeros, do, vf.transpose(1, 2), three)
    dsum = (do * o).sum(dim=-1, keepdim=True)
    x = torch.where(mask, s * sl2, torch.tensor(-1e30))
    tile = 32 if hd > 128 else 64
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, hd))
    for k0 in range(0, sk, tile):
        xt = x[:, :, k0:k0 + tile]
        m_new = torch.maximum(m, xt.max(dim=-1, keepdim=True).values)
        pt = torch.where(xt > -5e29, torch.exp2(xt - m_new), 0.0)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + pt.sum(dim=-1, keepdim=True)
        dst = pt * (dp[:, :, k0:k0 + tile] - dsum)
        acc = fresh(acc, alpha, dst, kf[:, k0:k0 + tile], three)
        m = m_new
    scale32 = torch.tensor(scale, dtype=torch.float32)
    dq = acc * torch.where(l > 0, scale32 / l, torch.tensor(0.0))
    lse = torch.where(l > 0, m + torch.log2(l), torch.tensor(NO_LSE))
    p = torch.where(mask, torch.exp2(s * sl2 - lse), 0.0)
    ds = p * (dp - dsum)
    dk = torch.zeros((bhkv, sk, hd))
    dv = torch.zeros((bhkv, sk, hd))
    dst = ds.transpose(1, 2).reshape(bhkv, qpk, sk, sq)
    pt = p.transpose(1, 2).reshape(bhkv, qpk, sk, sq)
    qg = q.reshape(bhkv, qpk, sq, hd)
    dog = do.reshape(bhkv, qpk, sq, hd)
    one = torch.ones(())
    for i in range(parts):
        ak = torch.zeros((bhkv, sk, hd))
        av = torch.zeros((bhkv, sk, hd))
        for hh in range(i * qpk // parts, (i + 1) * qpk // parts):
            for q0 in range(0, sq, tile):
                qt = slice(q0, q0 + tile)
                ak = fresh(ak, one, dst[:, hh, :, qt], qg[:, hh, qt], three)
                av = fresh(av, one, pt[:, hh, :, qt], dog[:, hh, qt], three)
        dk = dk + ak
        dv = dv + av
    return dq, dk * scale, dv


def _inputs(b, h, hkv, sq, sk, hd, seed):
    """(B, S, H, hd) float32 inputs from numpy, and the forward's output."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, h, hd))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, sk, hkv, hd))
                             .astype(np.float32)) for _ in range(2))
    return q, k, v, do


def _flat(t):
    b, s, h, hd = t.shape
    return t.transpose(1, 2).reshape(b * h, s, hd)


def _bshd(t, b):
    bh, s, hd = t.shape
    return t.reshape(b, bh // b, s, hd).transpose(1, 2)


def _case(shape, seed, three=True):
    """(emulated, plain) flat gradients at ``shape``, the head parts the
    wrapper's rule picks on an H100."""
    b, h, hkv, sq, sk, hd, causal, window = shape
    q, k, v, do = (_flat(t) for t in _inputs(b, h, hkv, sq, sk, hd, seed))
    o = attention_flat_plain(q, k, v, causal=causal, window=window)
    parts = bwd_head_parts(b, h, hkv, sk, hd, H100_SMS)
    got = emulate(q, k, v, o, do, causal, window, parts, three)
    want = attention_flat_bwd_plain(q, k, v, o, do, causal=causal,
                                    window=window)
    return got, want, (q, k, v, do)


def _errors(got, want):
    """Each gradient's (max abs error / max(1, scale), relative norm)."""
    out = []
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if not w.numel():
            out.append((0.0, 0.0))
            continue
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max()) / scale
        norm = float(torch.linalg.vector_norm(w))
        diff = float(torch.linalg.vector_norm(g - w))
        out.append((err, diff / norm if norm > 0 else diff))
    return out


def _hold(got, want):
    for name, (err, rel) in zip(("dq", "dk", "dv"), _errors(got, want)):
        assert err <= TOL_ABS, (name, err)
        assert rel <= TOL_REL_NORM, (name, rel)


#: (B, H, Hkv, Sq, Sk, hd, causal, window): GQA 4 at hd 128 with a padded
#: tail; MQA at hd 64; hd 8 under a window of 5 (GQA 4, B = 2); non-causal
#: cross attention, Sq != Sk; fewer queries than keys under the causal
#: mask at hd 128; hd 256 (16/1 heads, MQA, split over head parts) with a
#: window of 5; hd 256 with GQA 4 and Sq < Sk
SHAPES = [(1, 8, 2, 130, 130, 128, True, 0),
          (1, 4, 1, 100, 100, 64, True, 0),
          (2, 4, 1, 70, 70, 8, True, 5),
          (1, 4, 2, 60, 150, 64, False, 0),
          (1, 4, 1, 40, 100, 128, True, 0),
          (1, 16, 1, 72, 72, 256, True, 5),
          (1, 8, 2, 50, 90, 256, True, 0)]


@pytest.mark.parametrize("shape", SHAPES)
def test_split_within_tolerance_of_plain(shape):
    """The kernel's split products against the plain version, each
    gradient on its own (the comparison chip_smoke makes on the card)."""
    got, want, _ = _case(shape, seed=21)
    _hold(got, want)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2], SHAPES[5]])
def test_split_within_tolerance_of_jax(shape):
    """The same emulation against ``jax.grad`` of the JAX package's
    attention, in float32 on the same values."""
    b, h, hkv, sq, sk, hd, causal, window = shape
    got, _, (q, k, v, do) = _case(shape, seed=22)
    qn, kn, vn, don = (_bshd(t, b).numpy() for t in (q, k, v, do))

    def loss(q, k, v):
        return jnp.sum(jattention(q, k, v, causal=causal, window=window)
                       * don)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (qn, kn, vn)))
    _hold([_bshd(g, b) for g in got],
          [torch.from_numpy(np.asarray(w)) for w in want])


def test_single_tf32_pass_is_worse_than_the_split():
    """hi hi alone (one TF32 product, what mma.sync gives a float32
    operand rounded once) against the three-product split at the trainer's
    head dim: its error is the larger, for every gradient."""
    shape = SHAPES[0]
    split3, want, _ = _case(shape, seed=23)
    single, _, _ = _case(shape, seed=23, three=False)
    for (e3, r3), (e1, r1) in zip(_errors(split3, want),
                                  _errors(single, want)):
        assert e1 > e3 and r1 > r3, (e1, e3, r1, r3)


def test_sk_zero_and_rows_that_see_no_key():
    """Sk = 0 gives dq = 0 and empty dk, dv; under a window of 3 with more
    queries than keys, the rows past every key's window see none: NO_LSE
    keeps their P at 0, and nothing is NaN."""
    got, want, _ = _case((1, 4, 2, 20, 0, 16, True, 0), seed=24)
    assert not got[0].abs().max() and got[1].numel() == got[2].numel() == 0
    got, want, _ = _case((1, 2, 1, 40, 16, 16, True, 3), seed=25)
    assert all(torch.isfinite(g).all() for g in got)
    assert not got[0][:, 18:].abs().max()
    _hold(got, want)


def test_tf32_rounds_to_nearest_ties_away():
    """tf32 at 1 + 2^-11, half a tf32 step: away from zero on both signs;
    just below half: down; hi + lo within 2^-22 of x."""
    step = 2.0 ** -10
    x = torch.tensor([1 + step / 2, -(1 + step / 2), 1 + step / 2 - 2 ** -23,
                      1 + 3 * step / 2, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + step, -(1 + step), 1.0, 1 + 2 * step, 0.0])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(26).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = split(y)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21


def test_source_is_built_and_uses_the_split():
    """The source is in the build list and on the float32 route at every
    head dim the forward takes; it issues split TF32 ``mma.sync`` with
    explicit ``cvt.rna`` rounding (sm90.cuh), has the head split's 64-key
    blocks and a reduction of the parts, and no atomics."""
    assert "flash_attention_bwd_tf32x3" in _build.SOURCES
    assert all(bwd_source(torch.float32, hd) == BWD_TF32X3
               for hd in range(8, 257, 8))
    src = (_build.CSRC / "flash_attention_bwd_tf32x3.cu").read_text()
    hdr = (_build.CSRC / "sm90.cuh").read_text()
    assert "cvt.rna.tf32.f32" in hdr
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in hdr
    assert "split_tf32" in src and "mma_tf32_1688" in src
    defs = dict(line.split()[1:3] for line in src.splitlines()
                if line.startswith("#define ") and len(line.split()) >= 3)
    assert int(defs["BR"]) == SM90_BWD_WIDE_KEYS
    for name in ("flash_bwd_tf32x3_dq", "flash_bwd_tf32x3_dkdv",
                 "flash_bwd_tf32x3_reduce"):
        assert f"{name}(" in src
    assert not any(op in src for op in ("atomicAdd", "atom.", "red."))
