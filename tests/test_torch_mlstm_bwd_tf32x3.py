"""The float32 ``mlstm_chunkwise`` gradient kernel's arithmetic, rebuilt in
plain torch.

``csrc/mlstm_kernel_bwd_tf32x3.cu`` computes the gradient of the chunkwise
mLSTM in float32 on the tensor cores, in the six kernels of the bf16 design
(``csrc/mlstm_kernel_bwd_sm90.cu``): the scores and ``dh v^T`` of each
chunk; the chunk-start n, ``den`` and ``m``; the reverse walk over dC
(each chunk's dC' stored in float32, ``z = k dC'`` and ``dv = wc z``, dc0);
the forward walk over C (``u = C dh``, ``y = dC' v``, the parts of ``qd .
u``, ``k . y`` and ``<dC', C>``); the chunk's dS, dq, the chunk-internal dk
and ``dv += (S / m)^T dh``; and the gates, dk whole and dn0.  Every
product is three TF32 ``mma.sync`` per k-step of 8 contracted elements,
in this order: lo(A) hi(B), hi(A) lo(B), hi(A) hi(B), with hi = tf32(x)
and lo = tf32(x - hi), tf32 being ``cvt.rna.tf32.f32`` (round to nearest,
ties away from zero, at 10 mantissa bits).  The k-steps go in the kernels'
order: for S and ``dh v^T``, each 64-column tile of the padded head dim
from zero, the tiles added in order; over the chunk's 64 rows for dq, dk
and dv; for the carry updates, the even and the odd k-steps over the
chunk's rows in two sums, then added; for ``z``, ``u`` and ``y``, which a
walk block's four column warps share, each warp over its 16 columns of
every 64-column step, then the four parts added in order.  The carries
never accumulate through the tensor cores: each chunk's update is summed
from zero and joins the carry by one rounded fmaf with exp(a_L).
Nothing else is rounded below float32: C, each dC', the gated factors
``k wc`` and ``dh r / m``, n, dn and every row sum.  :func:`emulate`
repeats that on the CPU, the rounding done on the bits (``tf32``).

The emulation is held to the plain version
(``ref.mlstm_chunkwise_bwd_plain``) and, at two shapes, to ``jax.vjp`` of
the JAX package's ``mlstm_chunkwise`` in float32, within the bounds the
card checks use (chip_smoke's ``ATTN_TOL`` and ``ATTN_BWD_REL_NORM`` for
float32): each gradient's max abs error within 1e-4 x max(1, its largest
|value|), and ``||got - want|| / ||want||`` within 1e-4.  One case holds
that a single TF32 pass (hi hi alone) has the larger error: the split is
what keeps the float32 parity runs where they were.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.xlstm import mlstm_chunkwise as jmlstm_chunkwise
from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_kernel import (BWD_CUDA_CORES, BWD_SM90,
                                              BWD_TF32X3, CHUNK,
                                              SM90_BWD_MAX_HD,
                                              TF32X3_BWD_MAX_HD, bwd_source,
                                              pad_tail)
from repro_torch.kernels.ref import I_CAP, mlstm_chunkwise_bwd_plain
from test_torch_flash_bwd_tf32x3 import mma_acc
from test_torch_mlstm_bwd_split import GRADS, _errs, _flat, _inputs

TOL_ABS, TOL_REL_NORM = 1e-4, 1e-4
DT = 64          # columns of a staged tile and of a walk's step
PART = 16        # columns of a step that one walk warp takes


def _fma(a, b, c):
    """fmaf: a b + c rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _warp_columns(hdp: int, part: int) -> torch.Tensor:
    """The padded head dim's columns that column warp ``part`` of a walk
    block takes, in its order: 16 of every 64-column step."""
    return torch.tensor([st * DT + PART * part + c
                         for st in range(hdp // DT) for c in range(PART)])


def _walk_product(a, b, three):
    """a @ b^T over the padded head dim (a (BH, R, hdp), b (BH, L, hdp)) as
    a walk block sums it: each column warp's part from zero over its
    columns, in k-steps of 8, then the four parts added in order."""
    hdp = a.shape[-1]
    out = None
    for part in range(DT // PART):
        cols = _warp_columns(hdp, part)
        p = mma_acc(torch.zeros(a.shape[0], a.shape[1], b.shape[1]),
                    a[..., cols], b[..., cols].transpose(1, 2), three)
        out = p if out is None else out + p
    return out


def _tile_product(a, b, three):
    """a @ b^T over the padded head dim as the scores kernel sums it: each
    64-column tile's products from zero, in k-steps of 8, the tiles' sums
    added in order."""
    out = None
    for t0 in range(0, a.shape[-1], DT):
        p = mma_acc(torch.zeros(a.shape[0], a.shape[1], b.shape[1]),
                    a[..., t0:t0 + DT], b[..., t0:t0 + DT].transpose(1, 2),
                    three)
        out = p if out is None else out + p
    return out


def _update_product(a, b, three):
    """a @ b over a chunk's 64 rows as the walks sum a carry update: the
    even and the odd k-steps of 8 in two sums from zero, then added."""
    steps = torch.arange(CHUNK).reshape(-1, 8)
    out = None
    for cols in (steps[0::2].reshape(-1), steps[1::2].reshape(-1)):
        p = mma_acc(torch.zeros(a.shape[0], a.shape[1], b.shape[2]),
                    a[..., cols], b[..., cols, :], three)
        out = p if out is None else out + p
    return out


def emulate(q, k, v, i_raw, f_raw, c0, n0, dh, dc=None, dn=None, three=True):
    """The kernel's arithmetic at chunk ``CHUNK`` over flat (BH, S, hd)
    float32 heads: ((dq, dk, dv), (di_raw, df_raw), (dc0, dn0)), all
    float32.  The head dim is zero-padded to a multiple of 64, as the
    kernels stage it; ``three=False`` takes hi hi alone in every product."""
    s, hd = q.shape[1], q.shape[2]
    hdp = -(-hd // DT) * DT
    qp, kp, vp, ip, fp = pad_tail(q, k, v, i_raw, f_raw)
    bh, sp, _ = qp.shape
    nc = sp // CHUNK

    def widen(x):                # last axis zero-padded to hdp
        out = torch.zeros(*x.shape[:-1], hdp)
        out[..., :hd] = x
        return out

    def square(x):               # an (hd, hd) state zero-padded
        out = torch.zeros(bh, hdp, hdp)
        out[:, :hd, :hd] = x
        return out
    qf, kf, vf = widen(qp), widen(kp), widen(vp)
    dhp = torch.zeros(bh, sp, hdp)
    dhp[:, :s, :hd] = dh
    scale = 1.0 / math.sqrt(hd)
    mask = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))

    def mm(a, b):
        return mma_acc(torch.zeros(a.shape[0], a.shape[1], b.shape[2]), a, b,
                       three)

    # mlstm_bwd_tf32x3_scores: gates, S, dh v^T, sum_j wc_j k_j
    ch = []
    for c in range(nc):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        li = torch.clamp(ip[:, sl], max=I_CAP)
        a = torch.cumsum(torch.nn.functional.logsigmoid(fp[:, sl]), 1)
        expo = torch.where(mask, a[:, :, None] - a[:, None, :]
                           + li[:, None, :], 0.0)
        s_raw = _tile_product(qf[:, sl], kf[:, sl], three)
        sc = torch.where(mask, s_raw * scale * torch.exp(expo), 0.0)
        wc = torch.exp(a[:, -1:] - a + li)
        ch.append(dict(sl=sl, a=a, expo=expo, s=sc, wc=wc,
                       r=scale * torch.exp(a), decay=torch.exp(a[:, -1]),
                       vd=_tile_product(dhp[:, sl], vf[:, sl], three),
                       ksum=(kf[:, sl] * wc[..., None]).sum(1)))
    # mlstm_bwd_tf32x3_den: the chunk-start n, den, m, r / m
    n = torch.zeros(bh, hdp) if n0 is None else widen(n0)
    for x in ch:
        x["n"] = n
        x["den_inter"] = x["r"] * (qf[:, x["sl"]] @ n[..., None])[..., 0]
        x["den"] = x["s"].sum(-1) + x["den_inter"]
        x["inv_m"] = 1.0 / torch.clamp(x["den"].abs(), min=1.0)
        n = _fma(x["decay"][:, None], n, x["ksum"])
    # mlstm_bwd_tf32x3_dwalk: dC in reverse, each chunk's dC' kept; dv = wc z
    dcc = torch.zeros(bh, hdp, hdp) if dc is None else square(dc)
    dv = torch.zeros(bh, sp, hdp)
    for x in reversed(ch):
        sl = x["sl"]
        x["dcp"] = dcc
        z = _walk_product(dcc.transpose(1, 2), kf[:, sl], three)  # z^T
        dv[:, sl] = x["wc"][..., None] * z.transpose(1, 2)
        gated = dhp[:, sl] * (x["r"] * x["inv_m"])[..., None]
        fresh = _update_product(qf[:, sl].transpose(1, 2), gated, three)
        dcc = _fma(x["decay"][:, None, None], dcc, fresh)
    dc0 = dcc
    # mlstm_bwd_tf32x3_cwalk: C in order; u, y and the three parts
    c = torch.zeros(bh, hdp, hdp) if c0 is None else square(c0)
    for x in ch:
        sl = x["sl"]
        x["u"] = _walk_product(c, dhp[:, sl], three).transpose(1, 2)
        x["x"] = x["r"] * (qf[:, sl] * x["u"]).sum(-1)
        x["y"] = _walk_product(x["dcp"], vf[:, sl], three).transpose(1, 2)
        x["ky"] = (kf[:, sl] * x["y"]).sum(-1)
        x["dd"] = (c * x["dcp"]).sum((1, 2))
        kw = kf[:, sl] * x["wc"][..., None]
        c = _fma(x["decay"][:, None, None], c,
                 _update_product(kw.transpose(1, 2), vf[:, sl], three))
    # mlstm_bwd_tf32x3_intra: dden, dS, G, dq, the internal dk, dv's rest
    dq = torch.zeros(bh, sp, hdp)
    for x in ch:
        sl = x["sl"]
        intra = (x["s"] * x["vd"]).sum(-1)
        im = x["inv_m"]
        dden = torch.where(x["den"].abs() >= 1.0, -(x["x"] + intra) * im * im
                           * torch.sign(x["den"]), 0.0)
        ds = torch.where(mask, x["vd"] * im[..., None] + dden[..., None],
                         0.0)
        g = ds * x["s"]
        dst = torch.where(mask, ds * scale * torch.exp(x["expo"]), 0.0)
        pm = x["s"] * im[..., None]
        inter = _fma(x["u"], im[..., None], x["n"][:, None] * dden[..., None])
        dq[:, sl] = x["r"][..., None] * inter + mm(dst, kf[:, sl])
        x["dki"] = mm(dst.transpose(1, 2), qf[:, sl])
        dv[:, sl] = dv[:, sl] + mm(pm.transpose(1, 2), dhp[:, sl])
        x["dns"] = ((x["r"] * dden)[..., None] * qf[:, sl]).sum(1)
        x["da"] = g.sum(2) - g.sum(1) + _fma(x["x"], im, x["den_inter"]
                                             * dden)
        x["dli"] = g.sum(1)
    # mlstm_bwd_tf32x3_gates: dn' by a scan from the last chunk, dk, E, dd
    dk = torch.zeros(bh, sp, hdp)
    da = torch.zeros(bh, nc, CHUNK)
    dli = torch.zeros(bh, nc, CHUNK)
    dnc = torch.zeros(bh, hdp) if dn is None else widen(dn)
    for ci in range(nc - 1, -1, -1):
        x = ch[ci]
        sl = x["sl"]
        dk[:, sl] = _fma(x["wc"][..., None], x["y"] + dnc[:, None], x["dki"])
        e = x["wc"] * (x["ky"] + (kf[:, sl] * dnc[:, None]).sum(-1))
        dd = x["decay"] * (x["dd"] + (dnc * x["n"]).sum(-1))
        da[:, ci] = x["da"] - e
        da[:, ci, -1] += e.sum(-1) + dd
        dli[:, ci] = x["dli"] + e
        dnc = _fma(x["decay"][:, None], dnc, x["dns"])
    dlf = torch.flip(torch.cumsum(torch.flip(da, [2]), 2), [2])
    df = (dlf.reshape(bh, sp) * torch.sigmoid(-fp))[:, :s]
    di = torch.where(ip <= I_CAP, dli.reshape(bh, sp), 0.0)[:, :s]
    return ((dq[:, :s, :hd], dk[:, :s, :hd], dv[:, :s, :hd]), (di, df),
            (dc0[:, :hd, :hd], dnc[:, :hd]))


def _hold(got, want):
    for name, (err, rel) in _errs(got, want).items():
        assert err <= TOL_ABS, (name, err)
        assert rel <= TOL_REL_NORM, (name, rel)


#: (BH, S, hd, initial carry, final-state gradients): S off the chunk with
#: both carries; hd 96, half a step past 64, with an initial carry; an
#: empty final gradient at hd 32; hd 8 with the final gradients alone
CASES = [(2, 200, 64, True, True), (1, 130, 96, True, False),
         (3, 128, 32, False, False), (2, 64, 8, False, True)]


@pytest.mark.parametrize("bh,s,hd,carry,final", CASES)
def test_split_within_tolerance_of_plain(bh, s, hd, carry, final):
    """The kernel's split products against the plain version, each
    gradient on its own (the comparison chip_smoke makes on the card); the
    capped input gate passes nothing."""
    args = _inputs(bh, s, hd, carry, final, torch.float32,
                   seed=bh * 1000 + s + hd)
    got = emulate(*args)
    assert all(t.dtype == torch.float32 for t in _flat(got))
    assert bool((got[1][0][args[3] > I_CAP] == 0).all())
    _hold(got, mlstm_chunkwise_bwd_plain(*args))


@pytest.mark.parametrize("b,h,s,hd", [(1, 2, 200, 64), (2, 1, 130, 32)])
def test_split_within_tolerance_of_jax(b, h, s, hd):
    """The same emulation against ``jax.vjp`` of the JAX package's
    ``mlstm_chunkwise`` (one chunk of S there, as it takes S off its chunk
    of 512), float32, with both carries and their gradients."""
    q, k, v, ig, fg, c0, n0, dh, dc, dn = _inputs(
        b * h, s, hd, True, True, torch.float32, seed=31 + s)
    got = emulate(q, k, v, ig, fg, c0, n0, dh, dc, dn)

    def heads(t):                # (B*H, S, ...) -> (B, S, H, ...)
        return t.reshape(b, h, *t.shape[1:]).transpose(1, 2).numpy()

    def states(t):               # (B*H, ...) -> (B, H, ...)
        return t.reshape(b, h, *t.shape[1:]).numpy()
    _, vjp = jax.vjp(jmlstm_chunkwise,
                     *(jnp.asarray(heads(x)) for x in (q, k, v, ig, fg)),
                     *(jnp.asarray(states(x)) for x in (c0, n0)))
    want = vjp((jnp.asarray(heads(dh)), (jnp.asarray(states(dc)),
                                         jnp.asarray(states(dn)))))
    flat = []
    for w in want[:5]:           # (B, S, H, ...) -> (B*H, S, ...)
        w = torch.from_numpy(np.asarray(w)).transpose(1, 2)
        flat.append(w.reshape(b * h, *w.shape[2:]))
    flat += [torch.from_numpy(np.asarray(w)).reshape(b * h, *w.shape[2:])
             for w in want[5:]]
    _hold(got, (flat[:3], flat[3:5], flat[5:]))


def test_single_tf32_pass_is_worse_than_the_split():
    """hi hi alone (one TF32 product, what mma.sync gives a float32 operand
    rounded once) against the three-product split, at a shape with both
    carries: its error is the larger for every gradient, and above the
    float32 bound for some."""
    args = _inputs(2, 200, 64, True, True, torch.float32, seed=41)
    want = mlstm_chunkwise_bwd_plain(*args)
    split = _errs(emulate(*args), want)
    single = _errs(emulate(*args, three=False), want)
    for name in GRADS:
        assert single[name][1] > split[name][1], (name, single, split)
    assert max(rel for _, rel in single.values()) > TOL_REL_NORM


def _defines(text: str) -> dict:
    return {line.split()[1]: line.split()[2] for line in text.splitlines()
            if line.startswith("#define ") and len(line.split()) >= 3}


def test_source_is_built_routed_and_uses_the_split():
    """The source is in the build list; the route table sends float32 at
    hd a multiple of 8 up to its limit (which includes xlstm's 1,024) to
    it, bf16 to the bf16 tensor-core source, the rest to the first design;
    the limit the wrapper expects is the one the source's shared memory
    gives; it issues split TF32 ``mma.sync`` (sm90.cuh) in six kernels
    and has no atomics."""
    assert "mlstm_kernel_bwd_tf32x3" in _build.SOURCES
    f32, bf16 = torch.float32, torch.bfloat16
    assert all(bwd_source(f32, hd) == BWD_TF32X3
               for hd in range(8, TF32X3_BWD_MAX_HD + 1, 8))
    assert TF32X3_BWD_MAX_HD >= 1024
    assert bwd_source(f32, TF32X3_BWD_MAX_HD + 8) == BWD_CUDA_CORES
    assert bwd_source(f32, 100) == BWD_CUDA_CORES
    assert all(bwd_source(bf16, hd) == BWD_SM90
               for hd in range(8, SM90_BWD_MAX_HD + 1, 8))
    assert bwd_source(bf16, 100) == BWD_CUDA_CORES
    src = (_build.CSRC / f"{BWD_TF32X3}").read_text()
    hdr = (_build.CSRC / "sm90.cuh").read_text()
    assert "cvt.rna.tf32.f32" in hdr and "mma_tf32_1688" in hdr
    assert "split4_tf32" in src and "mma_tf32x3f" in src
    for name in ("scores", "den", "dwalk", "cwalk", "intra", "gates"):
        assert f"mlstm_bwd_tf32x3_{name}(" in src
    assert not any(op in src for op in ("atomicAdd", "atom.", "red."))
    d = {k: int(v) for k, v in _defines(src).items() if v.isdigit()}
    assert d["L"] == CHUNK

    def smem(hd):                # dwalk's and cwalk's bytes
        slab = d["BE"] * (-(-hd // d["DT"]) * d["DT"] + 8)
        tile = d["L"] * d["LDT"]
        return (4 * (slab + 2 * 2 * tile),
                4 * (slab + 2 * (2 * tile + d["L"] * d["LDC"])
                     + 4 * d["L"] + d["THREADS"]))
    assert max(smem(TF32X3_BWD_MAX_HD)) <= d["SMEM_MAX"]
    assert max(smem(TF32X3_BWD_MAX_HD + d["DT"])) > d["SMEM_MAX"]
