"""Plain PyTorch versions of the port's kernels, plus the numpy oracles.

``minskew_plain``, ``hub_route_plain``, ``attention_flat_plain`` and
``decode_attention_plain`` compute what the CUDA kernels compute, with
ordinary tensor ops: the CPU path of every wrapper, and what
``chip_smoke.py`` holds each kernel against on the card.
``minskew_ref`` and ``hub_visibility_ref`` are the sequential numpy
oracles, copied from the JAX package.  The scheduler results are
integer, so those agree bit for bit; attention agrees within a
floating-point tolerance (sums taken in another order).
"""
from __future__ import annotations

import math

import numpy as np
import torch

INF = 2**30          # int32 "no runnable member" / never sentinel
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
