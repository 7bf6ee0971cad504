"""Plain PyTorch versions of the port's kernels, plus the numpy oracles.

``minskew_plain``, ``hub_route_plain``, ``attention_flat_plain`` (and
its gradient ``attention_flat_bwd_plain``), ``decode_attention_plain``,
``rglru_plain`` and ``mlstm_chunkwise_plain`` compute what the CUDA
kernels compute, with ordinary tensor ops: the CPU path of every
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
