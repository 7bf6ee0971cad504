"""xLSTM (arXiv:2405.04517), PyTorch port of ``repro.models.xlstm``:
sLSTM + mLSTM blocks (xlstm-1.3b).

Block layout (48 blocks, d_model 2048, 4 heads, d_ff=0):
  * mLSTM blocks (matrix memory, parallelizable): pre-LN -> up-proj to
    2*d_inner -> [u, z]; u -> causal depthwise conv(4) -> silu -> q, k
    heads and scalar i/f gates, v from u; the chunkwise gated linear
    recurrence C_t = f_t C_{t-1} + i_t k_t v_t^T through the
    ``mlstm_chunkwise`` kernel (:func:`repro_torch.kernels.ops.mlstm`);
    h = (q C) / max(|q n|, 1); output gated by silu(z); down-proj.
  * sLSTM blocks (scalar memory, strictly sequential): exponential
    gating with the max-stabilizer, per-head recurrent matrices, then a
    GeGLU FF (factor 4/3).  One sLSTM block every ``slstm_every``.

Numerics as in the JAX package: gates and accumulators in float32, the
input gate ``i = exp(min(i_raw, 8))``; the gate weights (``w_gates``,
``b_gates``, sLSTM ``r`` and ``b``) are float32 parameters in a model of
any dtype (``common.F32``).  ``jax.nn.gelu`` is the tanh approximation,
so the port's GeLU is too.

``slstm_seq`` has no kernel (a ``lax.scan`` in JAX): it stays a Python
loop over S.  Layers run in index order, which is the order of the JAX
package's grouped scans.  ``decode_step`` writes the recurrent state
**in place** into the cache tensors (the JAX version builds new arrays)
and returns a dict that shares them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.engine_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MLSTM_CHUNK, mlstm_step_plain
from repro_torch.models import common as cm
from repro_torch.models.common import F32, ModelConfig

CHUNK = MLSTM_CHUNK


def d_inner(cfg: ModelConfig) -> int:
    return int(cfg.d_model * cfg.mlstm_proj_factor)


def slstm_ff(cfg: ModelConfig) -> int:
    d = int(cfg.d_model * cfg.slstm_ff_factor)
    return ((d + 127) // 128) * 128


def is_slstm(cfg: ModelConfig, layer_idx: int) -> bool:
    se = cfg.slstm_every
    return se > 0 and (layer_idx % se) == (se - 1)


def _block_ids(cfg: ModelConfig):
    m_ids = [i for i in range(cfg.n_layers) if not is_slstm(cfg, i)]
    s_ids = [i for i in range(cfg.n_layers) if is_slstm(cfg, i)]
    return m_ids, s_ids


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _mlstm_specs(cfg: ModelConfig) -> dict:
    d, din, h = cfg.d_model, d_inner(cfg), cfg.n_heads
    return {
        "ln": (d,),
        "w_up": (d, 2 * din),
        "conv": (4, din),
        "wq": (din, din),
        "wk": (din, din),
        "wv": (din, din),
        "w_gates": F32((din, 2 * h)),
        "b_gates": F32((2 * h,)),
        "w_down": (din, d),
    }


def _slstm_specs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    hd, ff = d // h, slstm_ff(cfg)
    return {
        "ln": (d,),
        "w_in": (d, 4 * d),
        "r": F32((4, h, hd, hd)),
        "b": F32((4 * d,)),
        "w_out": (d, d),
        "ln2": (d,),
        "ff1": (d, 2 * ff),
        "ff2": (ff, d),
    }


_MLSTM_AXES = {
    "ln": (None,),
    "w_up": ("embed", "mlp"),
    "conv": (None, "mlp"),
    "wq": ("mlp", None),
    "wk": ("mlp", None),
    "wv": ("mlp", None),
    "w_gates": ("mlp", None),
    "b_gates": (None,),
    "w_down": ("mlp", "embed"),
}

_SLSTM_AXES = {
    "ln": (None,),
    "w_in": ("embed", "mlp"),
    "r": (None, "heads", None, None),
    "b": (None,),
    "w_out": (None, "embed"),
    "ln2": (None,),
    "ff1": ("embed", "mlp"),
    "ff2": ("mlp", "embed"),
}


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree with a shape at every leaf (no alloc); float32
    leaves are ``common.F32`` shapes."""
    m_ids, s_ids = _block_ids(cfg)
    return {
        "embed": (cfg.vocab, cfg.d_model),
        "mlstm": cm.stacked(len(m_ids), _mlstm_specs(cfg)),
        "slstm": cm.stacked(len(s_ids), _slstm_specs(cfg)),
        "final_norm": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab),
    }


def logical_axes(cfg: ModelConfig) -> dict:
    return {
        "embed": ("vocab", "embed"),
        "mlstm": cm.stacked_axes(_MLSTM_AXES),
        "slstm": cm.stacked_axes(_SLSTM_AXES),
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def init(cfg: ModelConfig, generator: torch.Generator, *,
         device=None) -> dict:
    """Random parameters with the JAX package's scales: norms 0,
    embeddings N(0, 0.02), projections N(0, 1/fan_in), gate biases -2
    (input) and 3 (forget).  ``generator`` must live on ``device``
    (``None`` means CUDA and raises without it)."""
    dev = resolve_device(device, "the model")
    dt, f32 = cfg.dtype, torch.float32
    m_ids, s_ids = _block_ids(cfg)
    nm, ns = len(m_ids), len(s_ids)
    d, din, h = cfg.d_model, d_inner(cfg), cfg.n_heads
    hd_s, ff = d // h, slstm_ff(cfg)

    def dense(n, shape, dtype=dt, in_axis=1):
        return cm.dense_init(generator, (n,) + shape, dtype, in_axis,
                             device=dev)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    b_gates = torch.cat([torch.full((h,), -2.0, dtype=f32, device=dev),
                         torch.full((h,), 3.0, dtype=f32, device=dev)])
    mlstm = {
        "ln": zeros((nm, d)),
        "w_up": dense(nm, (d, 2 * din)),
        "conv": dense(nm, (4, din)),
        "wq": dense(nm, (din, din)),
        "wk": dense(nm, (din, din)),
        "wv": dense(nm, (din, din)),
        "w_gates": dense(nm, (din, 2 * h), f32),
        "b_gates": b_gates.expand(nm, 2 * h).contiguous(),
        "w_down": dense(nm, (din, d)),
    }
    slstm = {
        "ln": zeros((ns, d)),
        "w_in": dense(ns, (d, 4 * d)),
        "r": dense(ns, (4, h, hd_s, hd_s), f32, in_axis=3),
        "b": zeros((ns, 4 * d), f32),
        "w_out": dense(ns, (d, d)),
        "ln2": zeros((ns, d)),
        "ff1": dense(ns, (d, 2 * ff)),
        "ff2": dense(ns, (ff, d)),
    }
    return {
        "embed": cm.embed_init(generator, (cfg.vocab, d), dt, device=dev),
        "mlstm": mlstm,
        "slstm": slstm,
        "final_norm": zeros((d,)),
        "lm_head": cm.dense_init(generator, (d, cfg.vocab), dt, device=dev),
    }


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise (prefill) and step (decode)
# ---------------------------------------------------------------------------


def causal_conv(u: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, kernel 4.  u (B,S,C), w (4,C).

    Returns (out (B,S,C), new_state (B,3,C)); the sum runs in u's dtype
    in the JAX order."""
    b, s, c = u.shape
    if state is None:
        state = torch.zeros((b, 3, c), dtype=u.dtype, device=u.device)
    xpad = torch.cat([state, u], dim=1)                  # (B, S+3, C)
    out = xpad[:, 0:s] * w[0]
    for i in range(1, 4):
        out = out + xpad[:, i:i + s] * w[i]
    return out, xpad[:, -3:]


def mlstm_chunkwise(q, k, v, i_raw, f_raw, c0=None, n0=None,
                    chunk: int = CHUNK):
    """Chunkwise-parallel mLSTM.

    q,k,v: (B,S,H,hd); i_raw,f_raw: (B,S,H) float32; c0 (B,H,hd,hd) and
    n0 (B,H,hd) float32, zeros when None.  Returns h (B,S,H,hd), (C, n).
    On CUDA the ``mlstm_chunkwise`` kernel (its own chunk); on the CPU
    the plain version at ``chunk``, the JAX model's arithmetic."""
    return ops.mlstm(q, k, v, i_raw, f_raw, c0, n0, chunk=chunk)


def mlstm_step(q, k, v, i_raw, f_raw, c, n):
    """Single-token recurrent step.  q,k,v (B,H,hd); gates (B,H)."""
    return mlstm_step_plain(q, k, v, i_raw, f_raw, c, n)


def _mlstm_qkvg(cfg: ModelConfig, p: dict, x: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None):
    """Shared projection pipeline.  x (B,S,D) -> q,k,v,(i,f),z,
    conv_state."""
    b, s, _ = x.shape
    h = cfg.n_heads
    din = d_inner(cfg)
    hd = din // h
    xin = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    u, z = (xin @ p["w_up"]).chunk(2, dim=-1)
    uc, conv_state = causal_conv(u, p["conv"], conv_state)
    uc = F.silu(uc.float()).to(x.dtype)
    q = (uc @ p["wq"]).view(b, s, h, hd)
    k = (uc @ p["wk"]).view(b, s, h, hd)
    v = (u @ p["wv"]).view(b, s, h, hd)
    gates = uc.float() @ p["w_gates"] + p["b_gates"]
    i_raw, f_raw = gates.chunk(2, dim=-1)                # (B,S,H)
    return q, k, v, i_raw, f_raw, z, conv_state


def _mlstm_out(cfg: ModelConfig, p: dict, x, hs, z):
    b, s, _ = x.shape
    hs = hs.reshape(b, s, d_inner(cfg)) * F.silu(z.float()).to(x.dtype)
    return x + hs @ p["w_down"]


def mlstm_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    q, k, v, i_raw, f_raw, z, _ = _mlstm_qkvg(cfg, p, x)
    hs, _ = mlstm_chunkwise(q, k, v, i_raw, f_raw)
    return _mlstm_out(cfg, p, x, hs, z)


# ---------------------------------------------------------------------------
# sLSTM cell
# ---------------------------------------------------------------------------


def slstm_seq(p: dict, x_proj: torch.Tensor, h0, c0, n0, m0):
    """x_proj (B,S,4,H,hd) pre-computed input projections (z,i,f,o order).

    Sequential loop with max-stabilized exponential gating; returns
    (hs (B,S,H,hd), (h, c, n, m))."""
    r = p["r"]                                            # (4,H,hd,hd)
    hp, cp, np_, mp = h0, c0, n0, m0                      # (B,H,hd) fp32
    xs = x_proj.float()
    hs = []
    for t in range(x_proj.shape[1]):
        pre = xs[:, t].transpose(0, 1) + torch.einsum(
            "bhd,ghde->gbhe", hp, r)                      # (4,B,H,hd)
        z_t = torch.tanh(pre[0])
        i_t, f_t, o_t = pre[1], pre[2], pre[3]
        m_t = torch.maximum(f_t + mp, i_t)
        i_p = torch.exp(i_t - m_t)
        f_p = torch.exp(f_t + mp - m_t)
        cp = f_p * cp + i_p * z_t
        np_ = f_p * np_ + i_p
        hp = torch.sigmoid(o_t) * cp / torch.clamp(np_, min=1.0)
        mp = m_t
        hs.append(hp)
    return torch.stack(hs, dim=1), (hp, cp, np_, mp)


def _slstm(cfg: ModelConfig, p: dict, x: torch.Tensor, state):
    """sLSTM block + GeGLU FF from ``state`` (h, c, n, m) -> (x_out,
    final state stacked (4,B,H,hd))."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xin = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    xp = ((xin @ p["w_in"]).float() + p["b"]).view(b, s, 4, h, hd)
    hs, st = slstm_seq(p, xp, *state)
    x = x + hs.reshape(b, s, d).to(x.dtype) @ p["w_out"]
    return cm.geglu_block(cfg, p, x), torch.stack(st)


def _slstm_zero_state(cfg: ModelConfig, b: int, device):
    hd = cfg.d_model // cfg.n_heads
    zero = torch.zeros((b, cfg.n_heads, hd), dtype=torch.float32,
                       device=device)
    return zero, zero, zero, zero - 1e30


def slstm_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return _slstm(cfg, p, x, _slstm_zero_state(cfg, x.shape[0], x.device))[0]


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend_embeds=None, return_aux: bool = False):
    """tokens (B, S) -> logits (B, S, V) float32 [+ aux loss 0].

    Trainable: under grad, ``cfg.remat`` recomputes each layer in the
    backward (:func:`common.maybe_remat`; the JAX package remats each
    group of mLSTM blocks and its sLSTM block, which changes no number),
    and the per-layer parameters are taken by one ``unbind`` of each
    stacked leaf (:func:`common.unstack`).  On the card the mLSTM's
    gradient is ``mlstm_chunkwise``'s backward kernel; the sLSTM loop has
    no kernel (ROADMAP B8) and autograd runs through it."""
    x = params["embed"][tokens]
    m_ids, s_ids = _block_ids(cfg)
    mlstm = iter(cm.unstack(params["mlstm"], len(m_ids)))
    slstm = iter(cm.unstack(params["slstm"], len(s_ids)))
    m_layer = cm.maybe_remat(cfg, mlstm_block)
    s_layer = cm.maybe_remat(cfg, slstm_block)
    for li in range(cfg.n_layers):
        if is_slstm(cfg, li):
            x = s_layer(cfg, next(slstm), x)
        else:
            x = m_layer(cfg, next(mlstm), x)
    logits = cm.final_logits(cfg, params, x)
    if return_aux:
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)
    return logits


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Shapes of the recurrent state; every leaf is float32 except
    ``m_conv`` (the model dtype)."""
    m_ids, s_ids = _block_ids(cfg)
    din, h = d_inner(cfg), cfg.n_heads
    hd_m, hd_s = din // h, cfg.d_model // h
    return {
        "m_c": F32((len(m_ids), batch, h, hd_m, hd_m)),
        "m_n": F32((len(m_ids), batch, h, hd_m)),
        "m_conv": (len(m_ids), batch, 3, din),
        "s_h": F32((len(s_ids), 4, batch, h, hd_s)),
        "len": (),
    }


def cache_axes(cfg: ModelConfig) -> dict:
    return {
        "m_c": ("layer", "batch", None, None, "state_v"),
        "m_n": ("layer", "batch", None, None),
        "m_conv": ("layer", "batch", None, "mlp"),
        "s_h": ("layer", None, "batch", None, None),
        "len": (),
    }


def init_cache(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    """A zero recurrent state (``len`` 0) on ``device``."""
    return cm.zeros_from_specs(cache_specs(cfg, batch, 0), cfg.dtype,
                               resolve_device(device, "the model"))


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend_embeds=None, max_len=None):
    """Run the full sequence, returning last logits (B,V) float32 and the
    recurrent state (``max_len`` is ignored: the state is O(1) in
    context length).  Each layer's final C goes straight into the
    preallocated cache."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    cache = init_cache(cfg, b, device=x.device)
    mi = si = 0
    for li in range(cfg.n_layers):
        if is_slstm(cfg, li):
            x, cache["s_h"][si] = _slstm(
                cfg, cm.pick(params["slstm"], si), x,
                _slstm_zero_state(cfg, b, x.device))
            si += 1
        else:
            lp = cm.pick(params["mlstm"], mi)
            q, k, v, ir, fr, z, conv_st = _mlstm_qkvg(cfg, lp, x)
            hs, (cf, nf) = mlstm_chunkwise(q, k, v, ir, fr)
            cache["m_c"][mi] = cf
            cache["m_n"][mi] = nf
            cache["m_conv"][mi] = conv_st
            del cf, nf
            x = _mlstm_out(cfg, lp, x, hs, z)
            mi += 1
    logits = cm.final_logits(cfg, params, x[:, -1])
    cache["len"] = s
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent step: token (B,) -> (logits (B,V) float32,
    cache).  The state is written in place into the cache's tensors."""
    x = params["embed"][token[:, None]]                  # (B,1,D)
    mi = si = 0
    for li in range(cfg.n_layers):
        if is_slstm(cfg, li):
            st = cache["s_h"][si]
            x, cache["s_h"][si] = _slstm(cfg, cm.pick(params["slstm"], si), x,
                                         (st[0], st[1], st[2], st[3]))
            si += 1
        else:
            lp = cm.pick(params["mlstm"], mi)
            q, k, v, ir, fr, z, conv_st = _mlstm_qkvg(
                cfg, lp, x, cache["m_conv"][mi])
            hs, (cf, nf) = mlstm_step(q[:, 0], k[:, 0], v[:, 0], ir[:, 0],
                                      fr[:, 0], cache["m_c"][mi],
                                      cache["m_n"][mi])
            cache["m_c"][mi] = cf
            cache["m_n"][mi] = nf
            cache["m_conv"][mi] = conv_st
            x = _mlstm_out(cfg, lp, x, hs[:, None], z)
            mi += 1
    logits = cm.final_logits(cfg, params, x[:, 0])
    cache["len"] = int(cache["len"]) + 1
    return logits, cache
