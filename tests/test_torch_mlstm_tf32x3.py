"""The float32 ``mlstm_chunkwise`` kernel's arithmetic, rebuilt in plain
torch.

``csrc/mlstm_kernel_tf32x3.cu`` computes the chunkwise mLSTM in float32 on
the tensor cores, in the three passes of the bf16 design
(``csrc/mlstm_kernel_sm90.cu``): each chunk's scores S, gates and sum_j
wc_j k_j; the n that enters each chunk and ``den``; and a walk over the
chunks in order that holds a slab of C in shared memory and gives ``out =
r (q C) + S v``, h and the carry update.  Every product (S = q k^T, q C,
S v, the update (v wc)^T k) is three TF32 ``mma.sync`` per k-step of 8
contracted elements, in this order: lo(A) hi(B), hi(A) lo(B), hi(A) hi(B),
with hi = tf32(x), tf32 being ``cvt.rna.tf32.f32`` (round to nearest, ties
away from zero, at 10 mantissa bits), which the kernel does in two integer
instructions, and lo = x - hi, which ``mma.sync`` reads with its low 13
bits dropped (``trunc``; sm90.cuh's ``split_tf32_fast``).  The k-steps go
in the kernel's order: for S, each 64-column tile of the padded
head dim from zero, the tiles added in order; for q C, which a walk
block's four column warps share, each warp over its 16 columns of every
64-row step from zero, then the four parts added in order; for S v over
the chunk's 64 rows from zero; for the carry update, the even and the odd
k-steps over the chunk's rows in two sums, then added.  C never
accumulates through the tensor cores: each chunk's update is summed from
zero and joins C by one rounded fmaf with exp(a_L).  Nothing else is
rounded below float32: C, S, the gated factor ``v wc``, n, den and every
row sum; h = fmaf(r, q C, S v) / max(|den|, 1).  :func:`emulate` repeats
that on the CPU, the rounding done on the bits (``tf32``, ``trunc``).

The emulation is held to the plain version (``mlstm_flat_plain``) at
chip_smoke.py's float32 ``MLSTM_CASES`` shapes that run on the CPU in
seconds, and at two shapes to the JAX package (the Pallas kernel's h in
interpret mode, as its own tests run it, and the JAX model's
``mlstm_chunkwise`` for h and the final C and n), within the bounds the
card checks use for float32 (chip_smoke's ``ATTN_TOL`` and
``ATTN_BWD_REL_NORM``): each output's max abs error within 1e-4 x max(1,
its largest |value|), and ``||got - want|| / ||want||`` within 1e-4.  One
case holds that a single TF32 pass (hi hi alone) misses that bound: the
split is what keeps the float32 parity runs where they were.  One keeps
ROADMAP C2: at forget gates whose chunk sum passes -88 the kernel's form
(exponents summed before exp) stays finite and right, where the plain
chunkwise form overflows.
"""
import math
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_kernel import mlstm_chunkwise as pallas_mlstm
from repro.models.xlstm import mlstm_chunkwise as jmlstm_chunkwise
from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_kernel import (CHUNK, FWD_TF32X3,
                                              TF32X3_MAX_HD, fwd_source,
                                              mlstm_flat_plain, pad_tail)
from repro_torch.kernels.ref import I_CAP, mlstm_seq_plain
from test_torch_flash_bwd_tf32x3 import tf32
from test_torch_mlstm_bwd_tf32x3 import DT, PART, _defines, _fma

TOL_ABS, TOL_REL_NORM = 1e-4, 1e-4
OUTS = ("h", "C", "n")


def trunc(x: torch.Tensor) -> torch.Tensor:
    """A float32 operand as ``mma.sync`` reads it as tf32: its low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _product(a, b, groups, three):
    """a @ b (a (BH, R, K), b (BH, K, C)) summed as the kernel sums it: each
    group of contracted indices from zero, in k-steps of 8 in the group's
    order, each k-step the split's three products (``three=False``: hi hi
    alone), each rounded to float32; the groups' sums added in order."""
    out = None
    for cols in groups:
        acc = torch.zeros(a.shape[0], a.shape[1], b.shape[2])
        for k0 in range(0, len(cols), 8):
            ks = cols[k0:k0 + 8]
            x, y = a[..., ks], b[..., ks, :]
            xh, yh = tf32(x), tf32(y)
            if three:
                acc = acc + trunc(x - xh) @ yh
                acc = acc + xh @ trunc(y - yh)
            acc = acc + xh @ yh
        out = acc if out is None else out + acc
    return out


def _tiles(k: int):
    """The scores' groups: each 64-column tile of the padded head dim."""
    return [torch.arange(t0, t0 + DT) for t0 in range(0, k, DT)]


def _warps(k: int):
    """q C's groups: each column warp's 16 rows d of every 64-row step."""
    return [torch.tensor([st * DT + PART * part + c for st in range(k // DT)
                          for c in range(PART)])
            for part in range(DT // PART)]


#: the carry update's groups: its even and its odd k-steps of 8; S v's one
UPDATE = [torch.arange(CHUNK).reshape(-1, 8)[p::2].reshape(-1)
          for p in (0, 1)]
WHOLE = [torch.arange(CHUNK)]


def emulate(q, k, v, i_raw, f_raw, c0=None, n0=None, three=True):
    """The kernel's arithmetic at chunk ``CHUNK`` over flat (BH, S, hd)
    float32 heads: h and the final (C, n), all float32.  The head dim is
    zero-padded to a multiple of 64, as the kernels stage it;
    ``three=False`` takes hi hi alone in every product."""
    s, hd = q.shape[1], q.shape[2]
    hdp = -(-hd // DT) * DT
    qp, kp, vp, ip, fp = pad_tail(q, k, v, i_raw, f_raw)
    bh, sp, _ = qp.shape

    def widen(x):                # last axis zero-padded to hdp
        out = torch.zeros(*x.shape[:-1], hdp)
        out[..., :hd] = x
        return out
    qf, kf, vf = widen(qp), widen(kp), widen(vp)
    c = torch.zeros(bh, hdp, hdp)       # C: rows d, columns e
    if c0 is not None:
        c[:, :hd, :hd] = c0
    n = torch.zeros(bh, hdp) if n0 is None else widen(n0)
    scale = 1.0 / math.sqrt(hd)
    mask = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))
    hs = []
    for c_at in range(0, sp, CHUNK):
        sl = slice(c_at, c_at + CHUNK)
        # mlstm_tf32x3_scores: gates, S, sum_j wc_j k_j
        li = torch.clamp(ip[:, sl], max=I_CAP)
        a = torch.cumsum(torch.nn.functional.logsigmoid(fp[:, sl]), 1)
        expo = torch.where(mask, a[:, :, None] - a[:, None, :]
                           + li[:, None, :], 0.0)
        sc = torch.where(mask, _product(qf[:, sl], kf[:, sl].transpose(1, 2),
                                        _tiles(hdp), three)
                         * scale * torch.exp(expo), 0.0)
        r = scale * torch.exp(a)
        wc = torch.exp(a[:, -1:] - a + li)
        decay = torch.exp(a[:, -1])
        # mlstm_tf32x3_den: den with the n that enters the chunk
        den = _fma(r, (qf[:, sl] @ n[..., None])[..., 0], sc.sum(-1))
        # mlstm_tf32x3_carry: out^T = C^T q^T over the walk's steps, (S v)^T
        # from zero, then h; the update (v wc)^T k from zero, one fmaf
        out = _product(c.transpose(1, 2), qf[:, sl].transpose(1, 2),
                       _warps(hdp), three)
        sv = _product(vf[:, sl].transpose(1, 2), sc.transpose(1, 2), WHOLE,
                      three)
        inv = 1.0 / torch.clamp(den.abs(), min=1.0)
        hs.append((_fma(r[:, None, :], out, sv) * inv[:, None, :])
                  .transpose(1, 2))
        fresh = _product((vf[:, sl] * wc[..., None]).transpose(1, 2),
                         kf[:, sl], UPDATE, three)
        c = _fma(decay[:, None, None], c, fresh.transpose(1, 2))
        n = _fma(decay[:, None], n, (kf[:, sl] * wc[..., None]).sum(1))
    h = torch.cat(hs, 1)[:, :s, :hd]
    return h, (c[:, :hd, :hd], n[:, :hd])


def _inputs(bh, s, hd, carry, seed, f_mean=2.0):
    """chip_smoke.py's recipe, from numpy: q, k, v = 0.3 N(0, 1), i_raw
    N(0, 1) with one entry above the cap, f_raw N(f_mean, 1), the carries
    0.1 N(0, 1); all float32."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32))
    q, k, v = (randn(bh, s, hd) * 0.3 for _ in range(3))
    ig, fg = randn(bh, s), randn(bh, s) + f_mean
    ig[0, s // 2] = I_CAP + 1.5
    c0, n0 = ((randn(bh, hd, hd) * 0.1, randn(bh, hd) * 0.1) if carry
              else (None, None))
    return q, k, v, ig, fg, c0, n0


def _errs(got, want):
    """Per output (h, C, n): (max abs error / max(1, largest |plain
    value|), ||got - want|| / ||want||)."""
    h, (c, n) = got
    hw, (cw, nw) = want
    out = {}
    for name, a, w in zip(OUTS, (h, c, n), (hw, cw, nw)):
        err = float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
        norm = float(torch.linalg.vector_norm(w))
        diff = float(torch.linalg.vector_norm(a - w))
        out[name] = (err, diff / norm if norm > 0 else diff)
    return out


def _hold(got, want):
    for name, (err, rel) in _errs(got, want).items():
        assert err <= TOL_ABS, (name, err)
        assert rel <= TOL_REL_NORM, (name, rel)


#: (BH, S, hd, initial carry): chip_smoke.py's float32 MLSTM_CASES that
#: run here in seconds (S off the chunk with a carry, hd 96 half a step
#: past 64, hd 8), and xlstm's head dim 1,024 at train_parity_xlstm's
#: S = 200 with a carry
CASES = [(2, 128, 32, False), (4, 256, 64, False), (1, 64, 128, False),
         (2, 200, 64, True), (3, 130, 96, True), (2, 64, 8, True),
         (2, 200, 1024, True)]


@pytest.mark.parametrize("bh,s,hd,carry", CASES)
def test_split_within_tolerance_of_plain(bh, s, hd, carry):
    """The kernel's split products against the plain version, h, C and n
    each on its own (the comparison chip_smoke makes on the card)."""
    args = _inputs(bh, s, hd, carry, seed=bh * 1000 + s + hd)
    got = emulate(*args)
    assert got[0].shape == (bh, s, hd)
    assert all(t.dtype == torch.float32 for t in (got[0], *got[1]))
    _hold(got, mlstm_flat_plain(*args))


@pytest.mark.parametrize("b,h,s,hd", [(1, 2, 256, 64), (2, 1, 128, 32)])
def test_split_within_tolerance_of_jax(b, h, s, hd):
    """The same emulation against the JAX package: h against the Pallas
    kernel (interpret mode, chunk 64, zero carry, as its own tests run
    it), and h, C and n against the JAX model's ``mlstm_chunkwise`` (one
    chunk of S there, as it takes S off its chunk of 512) with a carry."""
    q, k, v, ig, fg, _, _ = _inputs(b * h, s, hd, False, seed=31 + s)
    want = pallas_mlstm(*(jnp.asarray(x.numpy()) for x in (q, k, v, ig, fg)),
                        chunk=CHUNK, interpret=True)
    got = emulate(q, k, v, ig, fg)
    zero = (torch.zeros(b * h, hd, hd), torch.zeros(b * h, hd))
    _hold((got[0], zero), (torch.from_numpy(np.array(want)), zero))

    q, k, v, ig, fg, c0, n0 = _inputs(b * h, s, hd, True, seed=37 + s)
    got = emulate(q, k, v, ig, fg, c0, n0)

    def heads(t):                # (B*H, S, ...) -> (B, S, H, ...)
        return jnp.asarray(t.reshape(b, h, *t.shape[1:]).transpose(1, 2)
                           .numpy())

    def states(t):               # (B*H, ...) -> (B, H, ...)
        return jnp.asarray(t.reshape(b, h, *t.shape[1:]).numpy())
    hj, (cj, nj) = jmlstm_chunkwise(*(heads(x) for x in (q, k, v, ig, fg)),
                                    states(c0), states(n0))
    hw = torch.from_numpy(np.asarray(hj)).transpose(1, 2).reshape(b * h, s,
                                                                  hd)
    cw = torch.from_numpy(np.asarray(cj)).reshape(b * h, hd, hd)
    nw = torch.from_numpy(np.asarray(nj)).reshape(b * h, hd)
    _hold(got, (hw, (cw, nw)))


def test_single_tf32_pass_misses_the_bound():
    """hi hi alone (one TF32 product, what mma.sync gives a float32 operand
    rounded once) against the three-product split, at xlstm's head dim
    with a carry: its error is the larger for h and C (n takes no
    product), and above both parts of the float32 bound, the max abs
    error and the relative norm; the split's is within both.  The check
    chip_smoke makes on the card (``_hold_mlstm_fwd``) refuses the single
    pass and takes the split."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    args = _inputs(2, 200, 1024, True, seed=41)
    want = mlstm_flat_plain(*args)
    got, got_single = emulate(*args), emulate(*args, three=False)
    split, single = _errs(got, want), _errs(got_single, want)
    for name in ("h", "C"):
        assert single[name][1] > split[name][1], (name, single, split)
    assert max(err for err, _ in single.values()) > TOL_ABS
    assert max(rel for _, rel in single.values()) > TOL_REL_NORM
    assert max(err for err, _ in split.values()) <= TOL_ABS
    assert max(rel for _, rel in split.values()) <= TOL_REL_NORM

    def flat(out):
        return out[0], *out[1]
    chip_smoke._hold_mlstm_fwd(torch, flat(got), flat(want), "float32",
                               "split")
    with pytest.raises(AssertionError, match="mlstm_chunkwise h"):
        chip_smoke._hold_mlstm_fwd(torch, flat(got_single), flat(want),
                                   "float32", "single pass")


def test_gates_past_minus_88_stay_finite():
    """ROADMAP C2: forget gates of about sigmoid(-4) a step sum to about
    -257 over a chunk of 64, past float32's exp range.  The plain chunkwise
    form (the JAX model's, exp(li_j - a_j) before the product) overflows;
    the kernel's (exponents summed before exp) stays finite and within the
    float32 bound of the step-by-step recurrence, which never forms
    exp(-a_j)."""
    bh, s, hd = 2, 200, 32
    args = _inputs(bh, s, hd, True, seed=43, f_mean=-4.0)
    q, k, v, ig, fg, c0, n0 = args
    assert float(torch.nn.functional.logsigmoid(fg[:, :CHUNK]).sum(1).max()
                 ) < -88.0
    got = emulate(*args)
    assert all(bool(torch.isfinite(t).all()) for t in (got[0], *got[1]))
    plain = mlstm_flat_plain(*args)
    assert not bool(torch.isfinite(plain[0]).all())
    hs, (cs, ns) = mlstm_seq_plain(q[:, :, None], k[:, :, None],
                                   v[:, :, None], ig[:, :, None],
                                   fg[:, :, None], c0[:, None], n0[:, None])
    _hold(got, (hs[:, :, 0], (cs[:, 0], ns[:, 0])))


def test_source_is_built_routed_and_uses_the_split():
    """The source is in the build list; the route table sends float32 at
    hd a multiple of 8 up to its limit (which includes xlstm's 1,024) to
    it; the limit the wrapper expects is the one the carry kernel's shared
    memory gives; it issues split TF32 ``mma.sync`` (sm90.cuh) in three
    kernels and has no atomics."""
    assert "mlstm_kernel_tf32x3" in _build.SOURCES
    assert all(fwd_source(torch.float32, hd) == FWD_TF32X3
               for hd in range(8, TF32X3_MAX_HD + 1, 8))
    assert TF32X3_MAX_HD >= 1024
    src = (_build.CSRC / FWD_TF32X3).read_text()
    hdr = (_build.CSRC / "sm90.cuh").read_text()
    assert "cvt.rna.tf32.f32" in hdr and "split_tf32_fast" in hdr
    assert "split4_tf32<SplitFast>" in src and "mma_tf32x3f<SplitFast>" in src
    for name in ("scores", "den", "carry"):
        assert f"mlstm_tf32x3_{name}(" in src
    assert not any(op in src for op in ("atomicAdd", "atom.", "red."))
    d = {k: int(v) for k, v in _defines(src).items() if v.isdigit()}
    assert d["L"] == CHUNK

    def smem(hd):                # the carry kernel's bytes
        return 4 * (d["BE"] * (-(-hd // d["DT"]) * d["DT"] + 8)
                    + 2 * 2 * d["L"] * d["LDT"])
    assert smem(TF32X3_MAX_HD) <= d["SMEM_MAX"]
    assert smem(TF32X3_MAX_HD + d["DT"]) > d["SMEM_MAX"]
