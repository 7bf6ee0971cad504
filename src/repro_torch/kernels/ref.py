"""Plain PyTorch versions of the port's kernels, plus the numpy oracles.

``minskew_plain``, ``hub_route_plain``, ``attention_flat_plain`` (and
its gradient ``attention_flat_bwd_plain``), ``decode_attention_plain``,
``rglru_plain`` and ``mlstm_chunkwise_plain`` (and their gradients
``rglru_bwd_plain`` and ``mlstm_chunkwise_bwd_plain``) compute what the
CUDA kernels compute, with ordinary tensor ops: the CPU path of every
wrapper, and what ``chip_smoke.py`` holds each kernel against on the
card.  ``minskew_ref``, ``hub_visibility_ref`` and
``mlstm_seq_plain`` are the sequential oracles of the JAX package.  The
scheduler results are integer, so those agree bit for bit; attention and
the recurrences agree within a floating-point tolerance (sums taken in
another order).
"""
from __future__ import annotations

import math

import numpy as np
import torch

INF = 2**30          # int32 "no runnable member" / never sentinel
I_CAP = 8.0          # mLSTM input gate: i = exp(min(i_raw, I_CAP))
MLSTM_CHUNK = 512    # the JAX model's chunk (models/xlstm.py CHUNK)
MLSTM_KERNEL_CHUNK = 64  # the CUDA kernels' chunk (kernels/mlstm_kernel.py)
PAD_GATE = 1e30      # padded mLSTM steps: i_raw = -PAD_GATE, f_raw = +PAD_GATE
NEG = -(2**30)       # identity start of the max-plus scan
NEG_INF = -1e30      # masked attention score (not -inf: see below)


# -- flash attention -------------------------------------------------------------


def attention_flat_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q (BH, Sq, hd); k/v (BHkv, Sk, hd) -> (BH, Sq, hd) in q's dtype.

    Exact softmax attention in float32; query row ``b`` reads kv row
    ``b // q_per_kv``.  Causal is aligned top-left (key j is visible to
    query i when j <= i, also when Sq != Sk); a window keeps keys with
    j > i - window.  Masked scores are ``NEG_INF`` and their
    probabilities are zeroed after the softmax, so a row with no
    visible key gives 0, as the kernels do (``repro.kernels.ref``'s
    oracle would give the mean of v there; no test shape has such a
    row)."""
    bh, sq, hd = q.shape
    bhkv, sk, _ = k.shape
    qpk = bh // bhkv
    k = k.repeat_interleave(qpk, dim=0)
    v = v.repeat_interleave(qpk, dim=0)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.where(mask[None], torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def attention_flat_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0):
    """The gradient of :func:`attention_flat_plain`: q, o, do (BH, Sq,
    hd); k/v (BHkv, Sk, hd) -> (dq, dk, dv) in the inputs' dtype.

    The explicit formulas in float32, from the forward's output ``o``
    (what ``csrc/flash_attention_bwd.cu`` computes): p is the forward's
    masked softmax, ``D_i = do_i . o_i``, ``ds = p (do v^T - D)``,
    ``dq = scale ds k``, ``dk = scale ds^T q`` and ``dv = p^T do``; dk
    and dv sum over the query rows of their kv row's group.  Sk = 0
    gives dq = 0."""
    bh, sq, hd = q.shape
    bhkv, sk, _ = k.shape
    qpk = bh // bhkv
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(qpk, dim=0)
    vf = v.float().repeat_interleave(qpk, dim=0)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.where(mask[None], torch.softmax(s, dim=-1), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dk = dk.view(bhkv, qpk, sk, hd).sum(dim=1)
    dv = dv.view(bhkv, qpk, sk, hd).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- decode attention -------------------------------------------------------------


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); caches (B, S, Hkv, hd); lengths (B,) int32 valid
    prefixes -> (B, H, hd) in q's dtype.  Query head h reads kv head
    h // q_per_kv; a row with length <= 0 gives 0, as the kernels do."""
    b, h, hd = q.shape
    _, s, hkv, _ = k_cache.shape
    qpk = h // hkv
    k = k_cache.repeat_interleave(qpk, dim=2)           # (B, S, H, hd)
    v = v_cache.repeat_interleave(qpk, dim=2)
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    valid = (torch.arange(s, device=q.device)[None, None, :]
             < lengths.to(q.device)[:, None, None])
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.where(valid, torch.softmax(sc, dim=-1), 0.0)
    return torch.einsum("bhs,bshd->bhd", p, v.float()).to(q.dtype)


def decode_attention_sp_plain(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, lengths: torch.Tensor,
                              shards: int) -> torch.Tensor:
    """Flash-decoding over ``shards`` contiguous sequence shards, the JAX
    package's ``decode_attention_sp`` ``local_fn`` with its collectives
    done over the shard axis: q (B, H, hd); caches (B, S, Hkv, hd) with
    ``S % shards == 0`` (the caller checks); lengths (B,) -> (B, H, hd)
    in q's dtype.  Each shard scores float32 ``q * scale`` against its
    keys and masks past the length; the shards' maxima give a global
    max; each shard sums its ``exp`` weights ``l`` and weighted values
    ``o``, the shards' ``l`` and ``o`` are summed, and the result is
    ``o / max(l, 1e-30)``."""
    b, h, hd = q.shape
    _, s, hkv, _ = k_cache.shape
    s_loc = s // shards
    qpk = h // hkv
    k = k_cache.repeat_interleave(qpk, dim=2).float()   # (B, S, H, hd)
    v = v_cache.repeat_interleave(qpk, dim=2).float()
    k = k.view(b, shards, s_loc, h, hd)
    v = v.view(b, shards, s_loc, h, hd)
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32,
                                          device=q.device))
    sc = torch.einsum("bhd,bmkhd->bmhk", q.float() * scale, k)
    pos = torch.arange(s, device=q.device).view(shards, 1, s_loc)
    valid = pos[None] < lengths.to(q.device)[:, None, None, None]
    sc = torch.where(valid, sc, NEG_INF)
    m_g = sc.amax(dim=-1).amax(dim=1)                     # (B, H)
    p = torch.where(valid, torch.exp(sc - m_g[:, None, :, None]), 0.0)
    l_g = p.sum(dim=-1).sum(dim=1)                        # (B, H)
    o_g = torch.einsum("bmhk,bmkhd->bmhd", p, v).sum(dim=1)
    return (o_g / torch.clamp(l_g, min=1e-30)[..., None]).to(q.dtype)


# -- RG-LRU linear recurrence ---------------------------------------------------


def rglru_plain(log_a: torch.Tensor, b: torch.Tensor,
                h0=None) -> torch.Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + b_t over axis 1, from h0 (zeros
    when None).  log_a, b (B, S, W) float32, h0 (B, W) -> (B, S, W).
    A sequential loop over S, as the JAX package's ``rglru_ref``."""
    bsz, s, w = log_a.shape
    h = (torch.zeros((bsz, w), dtype=torch.float32, device=log_a.device)
         if h0 is None else h0.float())
    a = torch.exp(log_a.float())
    out = torch.empty((bsz, s, w), dtype=torch.float32, device=log_a.device)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_bwd_plain(log_a: torch.Tensor, h: torch.Tensor, h0,
                    dh: torch.Tensor):
    """The gradient of :func:`rglru_plain` from its output ``h``: log_a,
    h, dh (B, S, W) float32, h0 (B, W) or None -> (dlog_a, db, dh0), dh0
    None where h0 is.  A float32 loop over S in reverse: ``g_t = dh_t +
    a_{t+1} g_{t+1}``, ``db = g``, ``dlog_a_t = g_t a_t h_{t-1}`` (h_{-1}
    = h0, or 0), ``dh0 = a_0 g_0``."""
    bsz, s, w = log_a.shape
    a = torch.exp(log_a.float())
    hf, dhf = h.float(), dh.float()
    prev = (torch.zeros((bsz, w), dtype=torch.float32, device=log_a.device)
            if h0 is None else h0.float())
    db = torch.empty((bsz, s, w), dtype=torch.float32, device=log_a.device)
    dla = torch.empty_like(db)
    carry = torch.zeros((bsz, w), dtype=torch.float32, device=log_a.device)
    for t in range(s - 1, -1, -1):
        g = carry + dhf[:, t]
        db[:, t] = g
        dla[:, t] = g * a[:, t] * (hf[:, t - 1] if t > 0 else prev)
        carry = a[:, t] * g
    return dla, db, None if h0 is None else carry


# -- mLSTM chunkwise ------------------------------------------------------------


def mlstm_chunkwise_plain(q, k, v, i_raw, f_raw, c0=None, n0=None,
                          chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel mLSTM: the JAX model's ``mlstm_chunkwise``
    (``repro.models.xlstm``), operation for operation.

    q, k, v (B, S, H, hd) in the model dtype; i_raw, f_raw (B, S, H)
    float32; c0 (B, H, hd, hd) and n0 (B, H, hd) float32, zeros when
    None.  Returns h (B, S, H, hd) in q's dtype and the final (C, n).
    Where S is not a multiple of ``chunk`` the whole sequence is one
    chunk, as in the JAX model."""
    b, s, h, hd = q.shape
    if s % chunk != 0:
        chunk = s                     # single chunk fallback
    nc = s // chunk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    c = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=dev)
         if c0 is None else c0.float())
    n = (torch.zeros((b, h, hd), dtype=torch.float32, device=dev)
         if n0 is None else n0.float())
    li = torch.clamp(i_raw.float(), max=I_CAP)            # log input gate
    lf = torch.nn.functional.logsigmoid(f_raw.float())    # log forget gate
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dev))
    hs = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        qi = q[:, sl].float() * scale
        ki = k[:, sl].float()
        vi = v[:, sl].float()
        lii, lfi = li[:, sl], lf[:, sl]                   # (B,L,H)
        a = torch.cumsum(lfi, dim=1)
        a_l = a[:, -1:, :]                                # (B,1,H)
        dec_q = torch.exp(a)
        qd = qi * dec_q[..., None]
        out = torch.einsum("blhd,bhde->blhe", qd, c)
        den = torch.einsum("blhd,bhd->blh", qd, n)
        w_kj = torch.exp(lii - a)                         # i_j exp(-A_j)
        sc = torch.einsum("blhd,bmhd->bhlm", qd, ki * w_kj[..., None])
        sc = torch.where(mask[None, None], sc, 0.0)
        out = out + torch.einsum("bhlm,bmhd->blhd", sc, vi)
        den = den + sc.sum(dim=-1).transpose(1, 2)        # (B,L,H)
        hs.append(out / torch.clamp(den.abs(), min=1.0)[..., None])
        w_c = torch.exp(a_l - a + lii)                    # (B,L,H)
        decay = torch.exp(a_l).transpose(1, 2)            # (B,H,1)
        kw = ki * w_c[..., None]
        c = c * decay[..., None] + torch.einsum("blhd,blhe->bhde", kw, vi)
        n = n * decay + kw.sum(dim=1)
    out = torch.cat(hs, dim=1) if hs else q.new_zeros(q.shape,
                                                      dtype=torch.float32)
    return out.to(q.dtype), (c, n)


def pad_tail(q, k, v, i_raw, f_raw, chunk: int = MLSTM_KERNEL_CHUNK):
    """Pad axis 1 (S) of flat (BH, S, ...) mLSTM inputs up to a multiple
    of ``chunk`` with steps that leave the carry unchanged: q = k = v = 0,
    i_raw = -1e30 (input gate 0), f_raw = +1e30 (forget gate 1).
    Returns the five tensors (the inputs themselves where S already is a
    multiple)."""
    s = q.shape[1]
    pad = -s % chunk
    if pad == 0:
        return q, k, v, i_raw, f_raw

    def ext(t, fill):
        tail = torch.full((t.shape[0], pad, *t.shape[2:]), fill,
                          dtype=t.dtype, device=t.device)
        return torch.cat([t, tail], dim=1)
    return (ext(q, 0.0), ext(k, 0.0), ext(v, 0.0), ext(i_raw, -PAD_GATE),
            ext(f_raw, PAD_GATE))


def mlstm_chunkwise_bwd_plain(q, k, v, i_raw, f_raw, c0, n0, dh, dc=None,
                              dn=None, chunk: int = MLSTM_KERNEL_CHUNK):
    """The gradient of the chunkwise mLSTM (:func:`mlstm_chunkwise_plain`
    over flat heads, tail-padded by :func:`pad_tail`) at ``chunk``, as
    explicit formulas in float32: what ``csrc/mlstm_kernel_bwd.cu``
    computes.

    q, k, v, dh (BH, S, hd); i_raw, f_raw (BH, S) float32; c0 (BH, hd,
    hd) and n0 (BH, hd) float32 or None (zeros); dc, dn the gradients of
    the final (C, n) or None (zeros).  Returns (dq, dk, dv) in q's dtype,
    (di_raw, df_raw) float32 and (dc0, dn0) float32.

    Per chunk, with the chunk-start state (C, n) recomputed by a forward
    walk, ``m = max(|den|, 1)`` and the chunk-end gradient (dC', dn'):
    ``dh.out = qd.(C dh) + sum_j S_ij (v_j.dh_i)``; ``dden = -dh.out /
    m^2 sign(den)`` where ``|den| >= 1``, else 0; ``dS_ij = v_j.dh_i / m_i
    + dden_i``; ``dq = scale e^a (C dh / m + n dden) + dS~ k``, ``dk =
    dS~^T q + w (dC' v + dn')``, ``dv = (S / m)^T dh + w dC'^T k`` (dS~ =
    dS scale e^{a_i - a_j + li_j}, w_j = e^{a_L - a_j + li_j}); the carry
    ``dC = e^{a_L} dC' + qd^T (dh / m)``, ``dn = e^{a_L} dn' + qd^T
    dden``.  The gates through their exponents: ``G = dS S`` gives a_i
    its row sums less its column sums, li_j its column sums; ``r_i =
    qd.(C dh) / m + (qd.n) dden`` goes to a_i; ``E_j = w_j k_j.(dC' v_j +
    dn')`` to a_L and li_j, less to a_j; ``e^{a_L} (<dC', C> + dn'.n)`` to
    a_L; then a reverse cumsum within the chunk gives log f, ``df_raw =
    dlog f sigmoid(-f_raw)`` and ``di_raw = dli`` where ``i_raw <=
    I_CAP`` (0 above it).  Padded rows are dropped."""
    bh, s, hd = q.shape
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    qp, kp, vp, ip, fp = pad_tail(q, k, v, i_raw, f_raw, chunk)
    sp = qp.shape[1]
    nc = sp // chunk
    dhp = torch.zeros((bh, sp, hd), **f32)
    dhp[:, :s] = dh.float()
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = qp.float(), kp.float(), vp.float()
    li = torch.clamp(ip.float(), max=I_CAP).view(bh, nc, chunk)
    lf = torch.nn.functional.logsigmoid(fp.float()).view(bh, nc, chunk)
    a = torch.cumsum(lf, dim=2)                           # (BH, nc, L)
    a_l = a[:, :, -1:]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dev))
    # the chunk-start states, by a forward walk
    c = torch.zeros((bh, hd, hd), **f32) if c0 is None else c0.float()
    n = torch.zeros((bh, hd), **f32) if n0 is None else n0.float()
    cs, ns = [], []
    for ci in range(nc):
        cs.append(c)
        ns.append(n)
        sl = slice(ci * chunk, (ci + 1) * chunk)
        wc = torch.exp(a_l[:, ci] - a[:, ci] + li[:, ci])  # (BH, L)
        kw = kf[:, sl] * wc[..., None]
        decay = torch.exp(a_l[:, ci])                      # (BH, 1)
        c = c * decay[..., None] + torch.einsum("bld,ble->bde", kw, vf[:, sl])
        n = n * decay + kw.sum(dim=1)
    dq = torch.zeros((bh, sp, hd), **f32)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    da = torch.zeros((bh, nc, chunk), **f32)
    dli = torch.zeros_like(da)
    dcc = torch.zeros((bh, hd, hd), **f32) if dc is None else dc.float()
    dnc = torch.zeros((bh, hd), **f32) if dn is None else dn.float()
    for ci in range(nc - 1, -1, -1):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        qi, ki, vi, dhi = qf[:, sl], kf[:, sl], vf[:, sl], dhp[:, sl]
        ai, lii, al = a[:, ci], li[:, ci], a_l[:, ci]      # (BH, L), (BH, 1)
        c, n = cs[ci], ns[ci]
        qd = qi * (scale * torch.exp(ai))[..., None]
        expo = ai[:, :, None] - ai[:, None, :] + lii[:, None, :]
        sc = torch.where(mask, torch.einsum("bid,bjd->bij", qi, ki) * scale
                         * torch.exp(torch.where(mask, expo, 0.0)), 0.0)
        den_inter = torch.einsum("bid,bd->bi", qd, n)
        den = den_inter + sc.sum(dim=-1)
        m = torch.clamp(den.abs(), min=1.0)
        u = torch.einsum("bde,bie->bid", c, dhi)           # C dh_i
        x = (qd * u).sum(dim=-1)
        vdh = torch.einsum("bie,bje->bij", dhi, vi)        # dh_i . v_j
        dho = x + (sc * vdh).sum(dim=-1)                   # dh_i . out_i
        dden = torch.where(den.abs() >= 1.0,
                           -dho / m.square() * torch.sign(den), 0.0)
        ds = torch.where(mask, vdh / m[..., None] + dden[..., None], 0.0)
        g = ds * sc
        dst = torch.where(mask, ds * scale * torch.exp(
            torch.where(mask, expo, 0.0)), 0.0)
        wc = torch.exp(al - ai + lii)                      # (BH, L)
        y = torch.einsum("bde,bje->bjd", dcc, vi) + dnc[:, None]
        z = torch.einsum("bde,bjd->bje", dcc, ki)
        e = wc * (ki * y).sum(dim=-1)                      # (BH, L)
        decay = torch.exp(al)                              # (BH, 1)
        dd = decay[:, 0] * ((dcc * c).sum(dim=(1, 2)) + (dnc * n).sum(-1))
        dq[:, sl] = (scale * torch.exp(ai))[..., None] * (
            u / m[..., None] + n[:, None] * dden[..., None]) \
            + torch.einsum("bij,bjd->bid", dst, ki)
        dk[:, sl] = torch.einsum("bij,bid->bjd", dst, qi) + wc[..., None] * y
        dv[:, sl] = torch.einsum("bij,bie->bje", sc / m[..., None], dhi) \
            + wc[..., None] * z
        r = x / m + den_inter * dden
        da[:, ci] = g.sum(dim=2) - g.sum(dim=1) + r - e
        da[:, ci, -1] += e.sum(dim=-1) + dd
        dli[:, ci] = g.sum(dim=1) + e
        dcc = dcc * decay[..., None] + torch.einsum(
            "bid,bie->bde", qd, dhi / m[..., None])
        dnc = dnc * decay + (qd * dden[..., None]).sum(dim=1)
    dlf = torch.flip(torch.cumsum(torch.flip(da, [2]), dim=2), [2])
    df_raw = (dlf.reshape(bh, sp) * torch.sigmoid(-fp.float()))[:, :s]
    di_raw = torch.where(ip.float() <= I_CAP, dli.reshape(bh, sp), 0.0)
    return ((dq[:, :s].to(q.dtype), dk[:, :s].to(k.dtype),
             dv[:, :s].to(v.dtype)), (di_raw[:, :s], df_raw), (dcc, dnc))


def mlstm_step_plain(q, k, v, i_raw, f_raw, c, n):
    """One recurrent mLSTM step (the JAX model's ``mlstm_step``).
    q, k, v (B, H, hd); gates (B, H); c (B, H, hd, hd), n (B, H, hd)
    float32 -> (h (B, H, hd) in q's dtype, (c, n))."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    q32 = q.float() * scale
    k32 = k.float()
    v32 = v.float()
    i_g = torch.exp(torch.clamp(i_raw.float(), max=I_CAP))[..., None]
    f_g = torch.sigmoid(f_raw.float())[..., None]         # (B,H,1)
    c = c * f_g[..., None] + i_g[..., None] * (k32[..., :, None]
                                               * v32[..., None, :])
    n = n * f_g + i_g * k32
    out = torch.einsum("bhd,bhde->bhe", q32, c)
    den = torch.einsum("bhd,bhd->bh", q32, n)
    h = out / torch.clamp(den.abs(), min=1.0)[..., None]
    return h.to(q.dtype), (c, n)


def mlstm_seq_plain(q, k, v, i_raw, f_raw, c0, n0):
    """The step-recurrent oracle (the JAX package's ``mlstm_seq_ref``):
    q, k, v (B, S, H, hd), gates (B, S, H) -> (h (B, S, H, hd), (C, n))."""
    c, n = c0, n0
    hs = []
    for t in range(q.shape[1]):
        h, (c, n) = mlstm_step_plain(q[:, t], k[:, t], v[:, t],
                                     i_raw[:, t], f_raw[:, t], c, n)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n)


# -- minskew (scheduler hot spot) -----------------------------------------------


def scope_minima_plain(vtime: torch.Tensor, runnable: torch.Tensor,
                       membership: torch.Tensor) -> torch.Tensor:
    """(V, S) int32: min vtime over the runnable members of each scope,
    INF where there are none.  vtime (V, N) int32; runnable (V, N) and
    membership (V, N, S) int8 or bool."""
    r = runnable != 0
    m = membership != 0
    if vtime.shape[1] == 0:
        return torch.full((vtime.shape[0], m.shape[2]), INF,
                          dtype=torch.int32, device=vtime.device)
    masked = torch.where(r[:, :, None] & m, vtime[:, :, None], INF)
    return masked.amin(dim=1).to(torch.int32)


def eligibility_plain(vtime: torch.Tensor, runnable: torch.Tensor,
                      membership: torch.Tensor, skew: torch.Tensor,
                      minima: torch.Tensor) -> torch.Tensor:
    """(V, N) bool: runnable, and for every scope j holding the vtask
    with a finite minimum, vtime <= minima[j] + skew[j] (the sum stays
    within int32: at most 2^30 + 2^30 - 1)."""
    m = membership != 0
    ok = ((vtime[:, :, None] <= (minima + skew)[:, None, :])
          | ~m | (minima == INF)[:, None, :])
    return ok.all(dim=2) & (runnable != 0)


def minskew_plain(vtime: torch.Tensor, runnable: torch.Tensor,
                  membership: torch.Tensor, skew: torch.Tensor):
    """Scope minima + bounded-skew eligibility over a variant axis:
    vtime (V, N) int32, runnable (V, N) int8, membership (V, N, S) int8,
    skew (V, S) int32 -> minima (V, S) int32, elig (V, N) int8.  A
    masked min, then a conjunction over the scope axis."""
    minima = scope_minima_plain(vtime, runnable, membership)
    elig = eligibility_plain(vtime, runnable, membership, skew, minima)
    return minima, elig.to(torch.int8)


def minskew_ref(vtime, runnable, membership, skew):
    """Scope minima + eligibility mask — numpy oracle (one variant)."""
    vtime = np.asarray(vtime)
    runnable = np.asarray(runnable)
    membership = np.asarray(membership)
    skew = np.asarray(skew)
    n, s = membership.shape
    INF_ = np.int32(INF)
    minima = np.full(s, INF_, np.int32)
    for j in range(s):
        members = runnable & membership[:, j]
        if members.any():
            minima[j] = vtime[members].min()
    elig = runnable.copy()
    for i in range(n):
        for j in range(s):
            if membership[i, j] and minima[j] != INF_:
                if vtime[i] > minima[j] + skew[j]:
                    elig[i] = False
    return minima, elig


# -- hub_route (batched IPC visibility) -----------------------------------------


def _shift(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    out = torch.full_like(x, fill)
    out[d:] = x[:-d]
    return out


def hub_route_plain(send: torch.Tensor, ser: torch.Tensor,
                    link: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """Per-link FIFO visibility for messages sorted by (link, send).

    send, ser, link (M,) int32; lat (L,) int32 per-link latency.  Each
    message is f_i(x) = max(x, send_i) + ser_i held as (S, A) =
    (send_i, ser_i); composing f2 after f1 gives
    (max(S1, S2 - A1), A1 + A2), and a segment start (a new link)
    resets the composition.  A log-depth (Hillis-Steele) doubling scan
    over (S, A, G) with identity fills (NEG, 0, False); the result is
    end_i + lat[link_i] = S + A + lat[link_i], int32."""
    m = send.shape[0]
    if m == 0:
        return torch.empty(0, dtype=torch.int32, device=send.device)
    s = send.to(torch.int32)
    a = ser.to(torch.int32)
    g = torch.ones(m, dtype=torch.bool, device=send.device)
    g[1:] = link[1:] != link[:-1]
    d = 1
    while d < m:
        s_sh, a_sh, g_sh = _shift(s, d, NEG), _shift(a, d, 0), \
            _shift(g, d, False)
        s, a = (torch.where(g, s, torch.maximum(s_sh, s - a_sh)),
                torch.where(g, a, a_sh + a))
        g = g | g_sh
        d *= 2
    return s + a + lat.to(torch.int32)[link.long()]


def hub_visibility_ref(send_vtime, size_bytes, link_id, link_bw_Bps,
                       link_lat_ns, ser_ns=None):
    """Sequential oracle for hub visibility (numpy)."""
    send_vtime = np.asarray(send_vtime)
    size_bytes = np.asarray(size_bytes)
    link_id = np.asarray(link_id)
    busy: dict = {}
    out = np.zeros_like(send_vtime)
    for i in range(len(send_vtime)):
        l = int(link_id[i])
        ser = (int(ser_ns[i]) if ser_ns is not None
               else int(size_bytes[i] * 1e9 / float(link_bw_Bps[l])))
        start = max(int(send_vtime[i]), busy.get(l, 0))
        end = start + ser
        busy[l] = end
        out[i] = end + int(link_lat_ns[l])
    return out
