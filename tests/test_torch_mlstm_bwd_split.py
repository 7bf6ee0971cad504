"""The bf16 ``mlstm_chunkwise`` gradient kernel's arithmetic, rebuilt in
plain torch.

``csrc/mlstm_kernel_bwd_sm90.cu`` computes the gradient of the chunkwise
mLSTM on the tensor cores (bf16 operands, float32 sums) at the wrapper's
chunk of 64, in the order its six kernels take: the scores and ``dh v^T``
of each chunk; the chunk-start n, ``den`` and ``m``; the reverse walk
over dC (which stores each chunk's dC' and gives dv whole and dc0); the
forward walk over C (which gives ``u = C dh``, ``y = dC' v`` and the
parts of ``qd . u``, ``k . y`` and ``<dC', C>``); the chunk's dS, dq and
the chunk-internal dk; and the gates, dk whole and dn0.  It rounds at
these places, which :func:`emulate` repeats on the CPU:

- ``S / m`` to bf16 for ``dv = (S / m)^T dh``, and ``dS~`` to bf16 for
  ``dq = dS~ k`` and ``dk = dS~^T q`` (S, ``dh v^T``, their row and
  column sums, dS and G stay float32);
- the states C to bf16 for ``u = C dh``, and each chunk's dC' to bf16,
  as stored, for ``z = k dC'``, ``y = dC' v`` and ``<dC', C>`` (with C in
  float32 there);
- the carry updates' gated factors, formed in float32 and split into a hi
  and a lo bf16 part, two products each: ``k wc`` for ``C <- exp(a_L) C
  + (k wc)^T v``, and ``dh r / m`` (``r_i = exp(a_i) / sqrt(hd)``) for
  ``dC <- exp(a_L) dC' + q^T (dh r / m)``, with q, k, v exact;
- n, dn, ``den``, ``m``, ``dden``, the gates and every row sum stay
  float32.

The emulation is held to the plain version
(``ref.mlstm_chunkwise_bwd_plain``) on bf16 inputs made as chip_smoke.py
makes them, within the bounds the card checks use: each gradient's max
abs error within 2e-2 x max(1, its largest |plain value|), and
``||got - want|| / ||want||`` within 1e-2.  With no rounding at all it
agrees with the plain version to float32 rounding (the order of the
kernels' sums is right).  A single bf16 rounding of either gated factor
(``split=``) does not miss these bounds: rounding dC's once moves dc0 by
about 1.6e-3 of its norm, against about 2e-6 with the split, and rounding
C's once moves no gradient measurably (C reaches them only as a bf16
operand and through ``<dC', C>``).  The kernel splits both all the same,
so that the carried states keep float32 accuracy as the forward's C
does.
"""
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.mlstm_kernel import CHUNK, pad_tail
from repro_torch.kernels.ref import I_CAP, mlstm_chunkwise_bwd_plain

TOL_ABS, TOL_REL_NORM = 2e-2, 1e-2
GRADS = ("dq", "dk", "dv", "di_raw", "df_raw", "dc0", "dn0")


def _bf(x):
    return x.to(torch.bfloat16).float()


def _split(x, split):
    """The bf16 parts of a float32 factor: (hi, lo), or (hi,) alone."""
    hi = _bf(x)
    return (hi, _bf(x - hi)) if split else (hi,)


def emulate(q, k, v, i_raw, f_raw, c0, n0, dh, dc=None, dn=None,
            split=(True, True), rounded=True, chunks=None):
    """The kernel's arithmetic at chunk ``CHUNK`` over flat (BH, S, hd)
    heads: ((dq, dk, dv) in q's dtype, (di_raw, df_raw), (dc0, dn0)).
    ``split`` says, for C's update and dC's, whether the gated factor is
    split in two bf16 parts or rounded once; ``rounded=False`` rounds
    nothing (every operand float32).  ``chunks``, a list, receives each
    chunk's intermediate values by name."""
    bf = _bf if rounded else (lambda x: x)
    s = q.shape[1]
    qp, kp, vp, ip, fp = pad_tail(q, k, v, i_raw, f_raw)
    bh, sp, hd = qp.shape
    nc = sp // CHUNK
    dhp = torch.zeros(bh, sp, hd)
    dhp[:, :s] = dh.float()
    qf, kf, vf = qp.float(), kp.float(), vp.float()
    scale = 1.0 / math.sqrt(hd)
    mask = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))

    def parts(x, on):
        return _split(x, on) if rounded else (x,)

    # mlstm_bwd_sm90_scores: gates, S, dh v^T, sum_j wc_j k_j
    ch = []
    for c in range(nc):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        li = torch.clamp(ip[:, sl], max=I_CAP)
        a = torch.cumsum(torch.nn.functional.logsigmoid(fp[:, sl]), 1)
        expo = torch.where(mask, a[:, :, None] - a[:, None, :]
                           + li[:, None, :], 0.0)
        gate = torch.where(mask, scale * torch.exp(expo), 0.0)
        sc = (qf[:, sl] @ kf[:, sl].transpose(1, 2)) * gate
        wc = torch.exp(a[:, -1:] - a + li)
        ch.append(dict(sl=sl, li=li, a=a, gate=gate, s=sc, wc=wc,
                       r=scale * torch.exp(a), decay=torch.exp(a[:, -1]),
                       vd=dhp[:, sl] @ vf[:, sl].transpose(1, 2),
                       ksum=(kf[:, sl] * wc[..., None]).sum(1)))
    # mlstm_bwd_sm90_den: the chunk-start n, den, m
    n = torch.zeros(bh, hd) if n0 is None else n0.clone()
    for x in ch:
        x["n"] = n
        x["den_inter"] = x["r"] * (qf[:, x["sl"]] @ n[..., None])[..., 0]
        x["den"] = x["den_inter"] + x["s"].sum(-1)
        x["inv_m"] = 1.0 / torch.clamp(x["den"].abs(), min=1.0)
        n = x["decay"][:, None] * n + x["ksum"]
    # mlstm_bwd_sm90_dwalk: dC in reverse; dC' stored in bf16; dv whole
    dcc = torch.zeros(bh, hd, hd) if dc is None else dc.clone()
    dv = torch.zeros(bh, sp, hd)
    for x in reversed(ch):
        sl = x["sl"]
        x["dcb"] = bf(dcc)
        z = kf[:, sl] @ x["dcb"]
        p = bf(x["s"] * x["inv_m"][..., None])
        dv[:, sl] = p.transpose(1, 2) @ dhp[:, sl] + x["wc"][..., None] * z
        gated = dhp[:, sl] * (x["r"] * x["inv_m"])[..., None]
        upd = sum(qf[:, sl].transpose(1, 2) @ y for y in parts(gated,
                                                                split[1]))
        dcc = x["decay"][:, None, None] * dcc + upd
    dc0 = dcc
    # mlstm_bwd_sm90_cwalk: C in order; u, y and the three parts
    c = torch.zeros(bh, hd, hd) if c0 is None else c0.clone()
    for x in ch:
        sl = x["sl"]
        x["u"] = dhp[:, sl] @ bf(c).transpose(1, 2)
        x["x"] = x["r"] * (qf[:, sl] * x["u"]).sum(-1)
        x["y"] = vf[:, sl] @ x["dcb"].transpose(1, 2)
        x["ky"] = (kf[:, sl] * x["y"]).sum(-1)
        x["dd"] = (c * x["dcb"]).sum((1, 2))
        gated = kf[:, sl] * x["wc"][..., None]
        upd = sum(y.transpose(1, 2) @ vf[:, sl] for y in parts(gated,
                                                               split[0]))
        c = x["decay"][:, None, None] * c + upd
    # mlstm_bwd_sm90_intra: dden, dS, G, dq, the chunk-internal dk
    dq = torch.zeros(bh, sp, hd)
    for x in ch:
        sl = x["sl"]
        intra = (x["s"] * x["vd"]).sum(-1)
        m2 = x["inv_m"] * x["inv_m"]
        dden = torch.where(x["den"].abs() >= 1.0, -(x["x"] + intra) * m2
                           * torch.sign(x["den"]), 0.0)
        ds = torch.where(mask, x["vd"] * x["inv_m"][..., None]
                         + dden[..., None], 0.0)
        g = ds * x["s"]
        dst = bf(ds * x["gate"])
        dq[:, sl] = x["r"][..., None] * (x["u"] * x["inv_m"][..., None]
                                         + x["n"][:, None] * dden[..., None]) \
            + dst @ kf[:, sl]
        x["dq_inter"] = x["r"][..., None] * (
            x["u"] * x["inv_m"][..., None] + x["n"][:, None] * dden[..., None])
        x["dki"] = dst.transpose(1, 2) @ qf[:, sl]
        x["dns"] = ((x["r"] * dden)[..., None] * qf[:, sl]).sum(1)
        x["da"] = g.sum(2) - g.sum(1) + x["x"] * x["inv_m"] \
            + x["den_inter"] * dden
        x["dli"] = g.sum(1)
    # mlstm_bwd_sm90_gates: dn' by a scan from the last chunk, dk, E, dd
    dk = torch.zeros(bh, sp, hd)
    da = torch.zeros(bh, nc, CHUNK)
    dli = torch.zeros(bh, nc, CHUNK)
    dnc = torch.zeros(bh, hd) if dn is None else dn.clone()
    for ci in range(nc - 1, -1, -1):
        x = ch[ci]
        sl = x["sl"]
        dk[:, sl] = x["dki"] + x["wc"][..., None] * (x["y"] + dnc[:, None])
        e = x["wc"] * (x["ky"] + (kf[:, sl] * dnc[:, None]).sum(-1))
        dd = x["decay"] * (x["dd"] + (dnc * x["n"]).sum(-1))
        da[:, ci] = x["da"] - e
        da[:, ci, -1] += e.sum(-1) + dd
        dli[:, ci] = x["dli"] + e
        dnc = x["decay"][:, None] * dnc + x["dns"]
    if chunks is not None:
        chunks.extend(ch)
    dlf = torch.flip(torch.cumsum(torch.flip(da, [2]), 2), [2])
    df = (dlf.reshape(bh, sp) * torch.sigmoid(-fp))[:, :s]
    di = torch.where(ip <= I_CAP, dli.reshape(bh, sp), 0.0)[:, :s]
    return ((dq[:, :s].to(q.dtype), dk[:, :s].to(q.dtype),
             dv[:, :s].to(q.dtype)), (di, df), (dc0, dnc))


def _inputs(bh, s, hd, carry, final, dtype, seed):
    """chip_smoke.py's recipe, from numpy: q, k, v, dh = 0.3 N(0, 1) in
    ``dtype``, i_raw N(0, 1) with one entry above the cap, f_raw N(2, 1),
    the carries 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32))
    q, k, v, dh = ((randn(bh, s, hd) * 0.3).to(dtype) for _ in range(4))
    ig, fg = randn(bh, s), randn(bh, s) + 2.0
    ig[0, s // 2] = I_CAP + 1.5
    c0, n0 = ((randn(bh, hd, hd) * 0.1, randn(bh, hd) * 0.1) if carry
              else (None, None))
    dc, dn = ((randn(bh, hd, hd) * 0.1, randn(bh, hd) * 0.1) if final
              else (None, None))
    return q, k, v, ig, fg, c0, n0, dh, dc, dn


def _flat(out):
    return [x for part in out for x in part]


def _errs(got, want):
    """Per gradient: (max abs error / max(1, largest |plain value|),
    ||got - want|| / ||want||)."""
    out = {}
    for name, a, w in zip(GRADS, _flat(got), _flat(want)):
        a, w = a.float(), w.float()
        err = float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
        norm = float(torch.linalg.vector_norm(w))
        diff = float(torch.linalg.vector_norm(a - w))
        out[name] = (err, diff / norm if norm > 0 else diff)
    return out


#: (BH, S, hd, initial carry, final-state gradients): S off the chunk with
#: both carries, hd 64 and 128, an initial carry alone, a final gradient
#: alone, none (the model's train call)
CASES = [(2, 200, 64, True, True), (2, 128, 128, False, False),
         (1, 130, 128, True, False), (2, 64, 64, False, True),
         (1, 256, 64, False, False)]


@pytest.mark.parametrize("bh,s,hd,carry,final", CASES)
def test_emulation_meets_card_bounds(bh, s, hd, carry, final):
    args = _inputs(bh, s, hd, carry, final, torch.bfloat16,
                   seed=bh * 1000 + s + hd)
    got = emulate(*args)
    want = mlstm_chunkwise_bwd_plain(*args)
    assert got[0][0].dtype == torch.bfloat16
    assert bool((got[1][0][args[3] > I_CAP] == 0).all())
    for name, (err, rel) in _errs(got, want).items():
        assert err <= TOL_ABS, (name, err)
        assert rel <= TOL_REL_NORM, (name, rel)


@pytest.mark.parametrize("bh,s,hd,carry,final", CASES[:3])
def test_unrounded_order_of_sums_is_the_plain_versions(bh, s, hd, carry,
                                                       final):
    """The six kernels' decomposition, with no rounding, is the plain
    gradient up to float32 rounding."""
    args = _inputs(bh, s, hd, carry, final, torch.float32, seed=7 + hd)
    got = emulate(*args, rounded=False)
    want = mlstm_chunkwise_bwd_plain(*args)
    for name, (err, rel) in _errs(got, want).items():
        assert err <= 1e-5 and rel <= 1e-5, (name, err, rel)


@pytest.mark.parametrize("which", ["C", "dC"])
def test_single_rounding_of_a_gated_factor_meets_the_bounds(which):
    """One bf16 rounding of C's or of dC's gated factor, in place of the
    split, still meets the card's bounds at this shape.  Rounding dC's
    moves dc0 to about 1.6e-3 of its norm from the plain value, against
    about 2e-6 with the split: the carry loses float32 accuracy.  C enters
    every gradient as a bf16 operand (``u = bf16(C) dh``) or through
    ``<dC', C>``, so rounding its factor once moves no gradient by more
    than 1e-5 of its norm (the same as the split within a few 1e-5)."""
    args = _inputs(2, 256, 128, True, True, torch.bfloat16, seed=27)
    want = mlstm_chunkwise_bwd_plain(*args)
    split = _errs(emulate(*args), want)
    single = _errs(emulate(*args, split=(which == "dC", which == "C")),
                   want)
    for name, (err, rel) in single.items():
        assert err <= TOL_ABS and rel <= TOL_REL_NORM, (name, err, rel)
    if which == "dC":
        assert split["dc0"][1] < 1e-5 < 1e-3 < single["dc0"][1]
    else:
        assert all(abs(single[n][1] - split[n][1]) < 5e-5 for n in GRADS)


def test_chip_smoke_holds_each_mlstm_gradient_by_its_norm():
    """chip_smoke's mLSTM-backward check holds each gradient by its max
    abs error and by its relative norm.  With forget gates near 1 (f_raw
    about N(6, 1)) the carry reaches every row of a chunk, so dropping
    one chunk's inter-chunk term of dq (``r (u / m + n dden)``, chunk 3 of
    8) moves dq by 0.6% of its largest |value| and 2.5% of its norm: it
    passes the max abs error, and must fail here; the exact gradients
    must pass."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    args = list(_inputs(1, 512, 64, False, False, torch.bfloat16, seed=0))
    args[4] = args[4] + 4.0
    want = _flat(mlstm_chunkwise_bwd_plain(*args))
    errs, rels = chip_smoke._hold_mlstm_bwd(torch, want, want, "bfloat16",
                                            "exact")
    assert not any(errs.values()) and not any(rels.values())
    chunks = []
    emulate(*args, rounded=False, chunks=chunks)
    got = [w.clone() for w in want]
    sl = chunks[3]["sl"]
    got[0][:, sl] = (got[0][:, sl].float()
                     - chunks[3]["dq_inter"]).to(torch.bfloat16)
    err, scale = chip_smoke._err(got[0], want[0]), float(
        want[0].float().abs().max())
    chip_smoke._hold("mlstm_chunkwise_bwd", err, "bfloat16", "dropped",
                     scale)
    with pytest.raises(AssertionError, match="mlstm_chunkwise_bwd dq"):
        chip_smoke._hold_mlstm_bwd(torch, got, want, "bfloat16", "dropped")
